"""The port's offload engine (``runtime/engine_seq2seq.py``) on the tiny
NLLB of tests/test_torch_seq2seq_offload.py (split from it, whose spec,
stores and engine helpers it shares): direct-tier layers (a layer-aligned
pinned tier, every layer it stages whole served from the tier) and stream
decode (the decoder's routed experts gathered from a tier in the step),
against the JAX ``Seq2SeqOffloadEngine`` and the resident path: greedy
tokens exactly, the counters with prefetch off and one worker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JEngine
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore
from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

from test_torch_seq2seq_offload import (  # noqa: F401
    E,
    N_ENC,
    N_MOE,
    SPEC,
    SPEC_GEN,
    SPEC_IDS,
    _fresh_models,
    _port_engine,
    _resident,
    setup,
)
from torch_port_helpers import one_intra_op_thread, port_attention, to_port, write_nllb_store  # noqa: F401


# ---- direct-tier layers and stream decode ----------------------------------
# JAX tests/test_seq2seq_offload.py:317-540 on the tiny NLLB: a layer-aligned
# tier (align_rows = E) makes every layer it stages whole a direct layer;
# stream decode gathers the decoder's routed experts from a tier in the step.
# The stream cases sharpen the weights (``sharpen_seq2seq``): at init_random's
# scale every row routes the decoder to the same two experts, so U = 2 would
# never overflow.


@pytest.fixture(scope="module")
def sharp(tmp_path_factory):
    """``setup`` with the embedding and attention scaled up, and its stores."""
    from torch_port_helpers import sharpen_seq2seq

    jmodel = JNllbModel(JNllbSpec(**SPEC), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(5))
    sharpen_seq2seq(jparams)
    root = tmp_path_factory.mktemp("torch_s2s_stream")
    stores = {q: write_nllb_store(root / q, jtree["layers"], q, N_ENC, seed=3)
              for q in ("float32", "int4")}
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, to_port(jparams), stores


def _tiered(setup, slots, tier_kw, **kw):
    """(JAX engine, port engine, resident generator) over the f32 store with
    a pinned tier of ``tier_kw`` in each package, prefetch off and one worker:
    the same order of events, so the counters compare."""
    from moe_infinity_tpu.store.pinned import PinnedExpertTier as JTier

    _, jparams, _, params, stores = setup
    jmodel, model = _fresh_models(setup)
    path = stores["float32"]
    jstore, store = JStore(path), ExpertStore(path)
    jarena = JArena(jstore, slots, compute_dtype=jnp.float32, num_threads=1,
                    pinned_tier=JTier(jstore, shared_record=False, **tier_kw))
    jeng = JEngine(jmodel, jparams, jarena, prefetch=False, **kw)
    arena = ExpertArena(store, slots, compute_dtype=torch.float32, device="cpu", num_threads=1,
                        pinned_tier=PinnedExpertTier(store, device="cpu", shared_record=False,
                                                     **tier_kw))
    eng = Seq2SeqOffloadEngine(model, params, arena, prefetch=False, **kw)
    res, _ = _resident(model, params, path)
    return jeng, eng, res


def _tokens_equal(jeng, eng, res, ids=SPEC_IDS, gen=SPEC_GEN):
    want = jeng.generate(ids, **gen)
    with port_attention("naive"):
        got = eng.generate(ids, **gen)
        base = res.generate(ids, **gen)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.sequences, base.sequences)
    return got


def test_direct_tier_all_layers(setup):
    """Every layer staged whole: all direct, per layer. Tokens equal the JAX
    engine's and the resident path's, and the arena sees no visit."""
    jeng, eng, res = _tiered(setup, E, dict(align_rows=E))
    try:
        assert eng._direct_mlis == jeng._direct_mlis == set(range(N_MOE))
        _tokens_equal(jeng, eng, res)
        assert eng.stats()["visits"] == 0 == jeng.stats()["visits"]
        assert eng.arena.fetch_stats()["fetches_tier"] == 0
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


def test_direct_tier_partial_staging_mixes_paths(setup):
    """A byte budget of 6 records stages one layer whole (decoder layers
    first): that layer runs direct, the rest through the arena; tokens and
    counters equal the JAX engine's."""
    rec = sum(f.nbytes for f in ExpertStore(setup[4]["float32"]).fields)
    jeng, eng, res = _tiered(setup, E, dict(align_rows=E, max_bytes=6 * rec))
    try:
        assert eng._direct_mlis == jeng._direct_mlis and 0 < len(eng._direct_mlis) < N_MOE
        _tokens_equal(jeng, eng, res)
        assert eng.stats() == jeng.stats() and eng.stats()["visits"] > 0
        assert eng.decode_window_stats() == jeng.decode_window_stats()
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("k,mode", [(1, "whole"), (4, "whole"), (4, "prefix")])
def test_direct_tier_speculative_blocks_no_replays(setup, monkeypatch, k, mode):
    """Speculative steps and blocks over an all-direct tier: every execution
    is accepted at its first dispatch, exactly, as in the JAX engine."""
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    jeng, eng, res = _tiered(setup, E, dict(align_rows=E), speculative=True, spec_block=k)
    try:
        _tokens_equal(jeng, eng, res)
        assert eng.replay_counts and all(e == 1 for e in eng.replay_counts)
        assert eng.replay_counts == jeng.replay_counts
        assert eng.stats() == jeng.stats()
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


def test_direct_tier_deepest_layers_under_a_count(setup):
    """max_direct_layers=2 takes the two deepest MoE layers; the other
    two go through a 2E-slot arena, speculatively. Tokens, executions and
    counters equal the JAX engine's."""
    jeng, eng, res = _tiered(setup, 2 * E, dict(align_rows=E), speculative=True, spec_block=4,
                             max_direct_layers=2)
    try:
        assert eng._direct_mlis == jeng._direct_mlis == {N_MOE - 2, N_MOE - 1}
        _tokens_equal(jeng, eng, res)
        assert eng.replay_counts == jeng.replay_counts
        assert eng.stats() == jeng.stats()
        assert eng.spec_log == jeng.spec_log
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("k,U", [(4, 4), (1, 4), (4, 2), (2, 2)])
def test_stream_decode_equals_jax_and_resident(sharp, k, U):
    """Stream decode over a tier of every record: greedy tokens equal the
    JAX engine's and the resident path's. At U = E no block runs twice; from
    U = 2 the overflow doubles U the same way in both engines (the same
    executions of every block, the same final U). k = 1 takes the block path
    too: one stream dispatch per token, only the k = 1 block made."""
    jeng, eng, res = _tiered(sharp, E, {}, speculative=True, spec_block=k,
                             stream_decode=True, stream_unique=U)
    try:
        got = _tokens_equal(jeng, eng, res)
        assert got.stats["decode_steps"] == 8
        assert eng.replay_counts == jeng.replay_counts
        assert eng._stream_U == jeng._stream_U
        assert eng.model.route_margin == 0
        # the gathers read routed records only: at least one a layer, at most U
        n_dec = len(eng.dec_mlis)
        assert n_dec <= eng.stream_records <= eng.executed_steps * n_dec * eng._stream_U
        if U == E:
            assert all(e == 1 for e in eng.replay_counts)
        else:
            assert max(eng.replay_counts) > 1 and eng._stream_U > U
        if k == 1:
            assert len(eng.replay_counts) == 8 and set(eng._stream_block_cache) == {1}
        assert eng.stats() == jeng.stats()  # the encoder's visits alone
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


def test_stream_decode_kernel_path_equals_resident_exactly(sharp):
    """impl="pallas" (K3's plain version, the gather's plain version) over
    the int4 store: stream blocks of 4 from U = 2 equal the resident path's
    tokens, and the first step's logits bit for bit."""
    _, _, _, params, stores = sharp
    _, model = _fresh_models(sharp)
    path = stores["int4"]
    store = ExpertStore(path)
    eng = _port_engine(model, params, path, E, False, 1, impl="pallas", speculative=True,
                       spec_block=4, stream_decode=True, stream_unique=2,
                       tier=PinnedExpertTier(store, device="cpu", shared_record=False))
    res, provider = _resident(model, params, path, impl="pallas")
    try:
        np.testing.assert_array_equal(eng.generate(SPEC_IDS, **SPEC_GEN).sequences,
                                      res.generate(SPEC_IDS, **SPEC_GEN).sequences)
        assert eng._stream_U > 2
        tok = torch.as_tensor(SPEC_IDS, dtype=torch.int32)
        m = torch.as_tensor(SPEC_GEN["attention_mask"])
        with torch.inference_mode():
            _, cross = eng.run_encoder(tok, m)
            start = torch.full((3, 1), 2, dtype=torch.int32)
            pos = torch.zeros(3, 1, dtype=torch.int32)
            sources = eng._stream_sources(eng._stream_U)
            got, _, _ = model.decode_step(
                params, None, start, pos, eng.init_cache(3, 16), 0, m, cross,
                lambda _e, mli: (sources[mli], eng._identity, None), "pallas")
            enc = model.encode(params, provider.pytree(), tok, m, ResidentProvider.for_layer,
                               "pallas")
            want, _, _ = model.decode_step(
                params, provider.pytree(), start, pos, model.init_cache(3, 16), 0, m,
                model.cross_kv(params, enc), ResidentProvider.for_layer, "pallas")
        assert torch.equal(got, want)
    finally:
        eng.arena.shutdown()


def test_stream_decode_failure_raises_and_never_serves_through_the_arena(setup):
    """A stream dispatch that fails raises to the caller; the engine does not
    turn stream decode off and serve the decoder through the arena, as the
    JAX engine does after a compile failure."""
    _, _, _, params, stores = setup
    _, model = _fresh_models(setup)
    path = stores["float32"]
    eng = _port_engine(model, params, path, 2 * E, False, 1, speculative=True, spec_block=2,
                       stream_decode=True, stream_unique=4,
                       tier=PinnedExpertTier(ExpertStore(path), device="cpu",
                                             shared_record=False))

    def boom(k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    try:
        eng._stream_block_fn = boom
        with pytest.raises(RuntimeError, match="illegal memory access"):
            eng.generate(SPEC_IDS, **SPEC_GEN)
        assert eng._stream and not eng.replay_counts and eng.executed_steps == 0
        assert eng.decode_window_stats()["visits"] == 0  # no decoder layer touched the arena
    finally:
        eng.arena.shutdown()


def test_stream_decode_unstaged_expert_at_u_equals_e_raises(setup):
    """A tier without the decoder's records: U climbs to E, then the
    unstaged expert raises, with the JAX message."""
    _, _, _, params, stores = setup
    _, model = _fresh_models(setup)
    path = stores["float32"]
    store = ExpertStore(path)
    enc_only = [(layer, e) for layer in range(N_ENC) for e in range(E)]
    eng = _port_engine(model, params, path, 2 * E, False, 1, speculative=True, spec_block=1,
                       stream_decode=True, stream_unique=2,
                       tier=PinnedExpertTier(store, device="cpu", shared_record=False,
                                             order=enc_only))
    try:
        with pytest.raises(RuntimeError, match="unstaged expert was routed"):
            eng.generate(SPEC_IDS, **SPEC_GEN)
        assert eng._stream_U == E
    finally:
        eng.arena.shutdown()
