"""The port's offload engine (``runtime/engine_seq2seq.py``) on a tiny NLLB
(4+4 blocks, every 2nd sparse, 4 experts, d_model 32, f32) on the CPU,
against the JAX ``Seq2SeqOffloadEngine`` and the port's resident
``Seq2SeqGenerator``: the per-layer path (``speculative=False``) with arenas
of E and 2E slots, and the speculative path (whole steps at k=1, blocks of
k=4 in both ``MOE_SPEC_BLOCK_MODE`` modes) with arenas of 2E slots, where
the encoder's keys push the decoder's out and replays must occur. The
experts live in stores written from the JAX NllbModel.init_random weights
with the JAX ExpertStoreWriter (f32, and packed int4 with per-channel
scales); both packages read the same files.

Greedy tokens are compared exactly. With prefetch off and one fetch worker
the arena's order of events is fixed, so the hit, miss and eviction
counters, and the speculative executions, must equal the JAX engine's too.
Direct-tier layers and stream decode are in tests/test_torch_seq2seq_stream.py,
so that the two files run on two workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.memory import ExpertPredictor as JPredictor
from moe_infinity_tpu.memory import ExpertTracer as JTracer
from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JEngine
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore
from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

from torch_port_helpers import (
    mesh_apply_ff,
    one_intra_op_thread,
    port_attention,
    to_port,
    write_nllb_store,
)

SPEC = dict(
    vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, pad_token_id=1, decoder_start_token_id=2, max_positions=64,
    scale_embedding=True,
)
E, N_MOE, N_ENC = 4, 4, 2
IDS = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 1, 1]])
MASK = (IDS != 1).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = JNllbModel(JNllbSpec(**SPEC), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(5))
    root = tmp_path_factory.mktemp("torch_s2s_offload")
    stores = {q: write_nllb_store(root / q, jtree["layers"], q, N_ENC, seed=3)
              for q in ("float32", "int4")}
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, to_port(jparams), stores


def _jax_engine(jmodel, jparams, path, slots, prefetch, threads, speculative=False, **kw):
    arena = JArena(JStore(path), slots, compute_dtype=jnp.float32, num_threads=threads)
    tracer = JTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    return JEngine(jmodel, jparams, arena, tracer=tracer, predictor=JPredictor(tracer),
                   prefetch=prefetch, speculative=speculative, **kw)


def _port_engine(model, params, path, slots, prefetch, threads, impl="ragged", tier=None,
                 **kw):
    arena = ExpertArena(ExpertStore(path), slots, compute_dtype=torch.float32, device="cpu",
                        num_threads=threads, pinned_tier=tier)
    tracer = ExpertTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    return Seq2SeqOffloadEngine(model, params, arena, tracer=tracer,
                                predictor=ExpertPredictor(tracer), prefetch=prefetch, impl=impl,
                                **kw)


def _resident(model, params, path, impl="ragged"):
    provider = ResidentProvider.from_store(ExpertStore(path), dtype=torch.float32, device="cpu")
    return Seq2SeqGenerator(model, params, provider.pytree(), ResidentProvider.for_layer,
                            impl=impl), provider


GEN = dict(max_new_tokens=8, attention_mask=MASK, eos_token_id=None)


@pytest.mark.parametrize("quant", ["float32", "int4"])
@pytest.mark.parametrize("slots", [E, 2 * E])
@pytest.mark.parametrize("prefetch", [False, True])
def test_greedy_tokens_equal_jax_and_resident(setup, quant, slots, prefetch):
    jmodel, jparams, model, params, stores = setup
    threads = 2 if prefetch else 1
    jeng = _jax_engine(jmodel, jparams, stores[quant], slots, prefetch, threads)
    eng = _port_engine(model, params, stores[quant], slots, prefetch, threads)
    res, _ = _resident(model, params, stores[quant])
    try:
        want = jeng.generate(IDS, **GEN)
        with port_attention("naive"):
            got = eng.generate(IDS, **GEN)
            base = res.generate(IDS, **GEN)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.sequences, base.sequences)
        np.testing.assert_array_equal(got.num_generated, want.num_generated)
        assert got.stats["decode_steps"] == 8
        s = eng.stats()
        assert s["visits"] > 0 and (slots > E or s["evictions"] > 0)
        assert not eng.tracer.trace  # every sequence finished into the collection
        assert eng.tracer.trace_collection.sum() > 0
        if not prefetch:
            # one worker, no prefetch: the same order of events as the JAX arena
            assert s == jeng.stats()
            assert eng.decode_window_stats() == jeng.decode_window_stats()
            got_ns, want_ns = eng.node_stats(), jeng.node_stats()
            for k in want_ns:
                np.testing.assert_array_equal(got_ns[k], want_ns[k], err_msg=k)
            assert eng.hit_rate() == jeng.hit_rate()
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


def test_eos_stops_rows_like_jax(setup):
    jmodel, jparams, model, params, stores = setup
    jeng = _jax_engine(jmodel, jparams, stores["float32"], E, True, 2)
    eng = _port_engine(model, params, stores["float32"], E, True, 2)
    try:
        # the token that the first row emits first, as its EOS
        first = jeng.generate(IDS, max_new_tokens=1, attention_mask=MASK, eos_token_id=None)
        eos = int(first.sequences[0, 1])
        want = jeng.generate(IDS, max_new_tokens=8, attention_mask=MASK, eos_token_id=eos)
        with port_attention("naive"):
            got = eng.generate(IDS, max_new_tokens=8, attention_mask=MASK, eos_token_id=eos)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.num_generated, want.num_generated)
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("staged", [0, 6, 16])
def test_kernel_path_offload_equals_resident_exactly(setup, staged):
    """impl="pallas" (K3's plain version on the CPU) with the encoder on the
    same path, through an arena of E slots fed by the store, a partial tier
    or a full one: first-step logits and tokens equal the resident path's
    exactly (the same bytes through the same arithmetic; only the slot
    numbering differs)."""
    _, _, model, params, stores = setup
    path = stores["int4"]
    tier = None
    if staged:
        store = ExpertStore(path)
        tier = PinnedExpertTier(store, device="cpu",
                                max_bytes=staged * sum(f.nbytes for f in store.fields))
        assert tier.num_staged == staged
    eng = _port_engine(model, params, path, E, True, 2, impl="pallas", tier=tier)
    res, provider = _resident(model, params, path, impl="pallas")
    try:
        tok, m = torch.as_tensor(IDS, dtype=torch.int32), torch.as_tensor(MASK)
        with torch.inference_mode():
            _, cross = eng.run_encoder(tok, m)
            got = eng.decode_step(torch.full((2, 1), 2, dtype=torch.int32), 0,
                                  eng.init_cache(2, 16), m, cross)
            enc = model.encode(params, provider.pytree(), tok, m, ResidentProvider.for_layer,
                               "pallas")
            want, _, _ = model.decode_step(
                params, provider.pytree(), torch.full((2, 1), 2, dtype=torch.int32),
                torch.zeros(2, 1, dtype=torch.int32), model.init_cache(2, 16), 0, m,
                model.cross_kv(params, enc), ResidentProvider.for_layer, "pallas")
        assert torch.equal(got, want)
        np.testing.assert_array_equal(eng.generate(IDS, **GEN).sequences,
                                      res.generate(IDS, **GEN).sequences)
        fs = eng.arena.fetch_stats()
        assert fs["fetches_tier"] > 0 if staged else fs["fetches_tier"] == 0
        assert fs["fetches_store"] > 0 if staged < N_MOE * E else fs["fetches_store"] == 0
    finally:
        eng.arena.shutdown()


def test_stage_protocol_matches_jax(setup):
    """One encoder block and one decoder block through the stage functions
    of both models: routing and outputs agree."""
    jmodel, jparams, model, params, _ = setup
    tok = jnp.asarray(IDS, jnp.int32)
    jx, jbias, jq = jmodel.enc_prelude(jparams, tok, jnp.asarray(MASK))
    x, bias, q = model.enc_prelude(params, torch.as_tensor(IDS, dtype=torch.int32),
                                   torch.as_tensor(MASK))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    with port_attention("naive"):
        out = model.enc_block_sparse_pre(params["enc_blocks"][1], x, bias, q)
        dense = model.enc_block_dense(params["enc_blocks"][0], x, bias, q)
    jout = jmodel.enc_block_sparse_pre(jparams["enc_blocks"][1], jx, jbias, jq)
    jdense = jmodel.enc_block_dense(jparams["enc_blocks"][0], jx, jbias, jq)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))  # expert ids
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(model.enc_final(params, dense).numpy(),
                               np.asarray(jmodel.enc_final(jparams, jdense)), rtol=1e-4,
                               atol=1e-4)
    assert model.dec_prelude(params, None, 16, torch.as_tensor(MASK))[0] is None


def test_init_random_without_experts():
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
    params, tree = model.init_random(torch.Generator().manual_seed(0), with_experts=False)
    assert tree is None
    assert "router" in params["enc_blocks"][1] and "fc1" in params["enc_blocks"][0]


def test_unported_options_raise(setup):
    jmodel, _, model, params, stores = setup
    path = stores["int4"]
    arena = ExpertArena(ExpertStore(path), E, compute_dtype=torch.float32, device="cpu")
    try:
        # dense paging and the host fallback are served; a speculative engine
        # over paged blocks, and the fallback without a zero slot, are refused
        for kw, what in ((dict(dense_arena=object(), speculative=True), "speculative decode"),
                         (dict(host_fallback=True), "reserve_zero_slot")):
            with pytest.raises(ValueError, match=what):
                Seq2SeqOffloadEngine(model, params, arena, **kw)
        # stream decode is served, with a tier and on the speculative path
        with pytest.raises(ValueError, match="requires a pinned tier"):
            Seq2SeqOffloadEngine(model, params, arena, speculative=True, stream_decode=True)
        eng = Seq2SeqOffloadEngine(model, params, arena)
        # sampling is served, one token a step; the seed fixes the draws
        sampled = dict(max_new_tokens=2, temperature=0.7, do_sample=True, seed=1,
                       eos_token_id=None)
        np.testing.assert_array_equal(eng.generate(IDS, **sampled).sequences,
                                      eng.generate(IDS, **sampled).sequences)
        with pytest.raises(ValueError, match="one full MoE layer"):
            Seq2SeqOffloadEngine(model, params, ExpertArena(ExpertStore(path), E - 1,
                                                            device="cpu"))
        # a mesh is served: ranks as threads (``ThreadMesh``), each on its
        # slice of a layer's experts and biases, give the unsharded output
        # (down_bias added once over the model axis)
        g = torch.Generator().manual_seed(2)
        h = torch.randn(2, 3, SPEC["d_model"], generator=g)
        ids = torch.randint(0, E, (2, 3, 2), generator=g, dtype=torch.int32)
        cw = torch.rand(2, 3, 2, generator=g)
        layer = ResidentProvider.for_layer(to_port(jmodel.init_random(
            jax.random.PRNGKey(5))[1]), 0)
        want = model.apply_ff(torch.zeros_like(h), h, cw, ids, *layer, "ragged")
        for sizes in (dict(expert=2), dict(model=2)):
            for got in mesh_apply_ff(lambda mesh: NllbModel(NllbSpec(**SPEC), torch.float32,
                                                            "cpu", mesh=mesh),
                                     layer, h, cw, ids, sizes):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    finally:
        arena.shutdown()
    # a tier that stages whole layers in layer-aligned segments serves them
    # direct: all at the default (None), the deepest under a count, none at 0
    store = ExpertStore(path)
    tier = PinnedExpertTier(store, device="cpu", align_rows=E)
    arena = ExpertArena(store, E, compute_dtype=torch.float32, device="cpu", pinned_tier=tier)
    try:
        assert Seq2SeqOffloadEngine(model, params, arena)._direct_mlis == set(range(N_MOE))
        assert Seq2SeqOffloadEngine(model, params, arena,
                                    max_direct_layers=1)._direct_mlis == {N_MOE - 1}
        assert not Seq2SeqOffloadEngine(model, params, arena, max_direct_layers=0)._direct_mlis
        with pytest.raises(ValueError, match="speculative=True"):
            Seq2SeqOffloadEngine(model, params, arena, stream_decode=True)
    finally:
        arena.shutdown()


# ---- speculative decode ------------------------------------------------------


def _fresh_models(setup):
    """New model objects over the shared params: a speculative engine sets
    ``route_margin`` on its model."""
    return (JNllbModel(JNllbSpec(**SPEC), compute_dtype=jnp.float32),
            NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu"))


SPEC_IDS = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 1, 1], [60, 7, 2, 1, 1, 1]])
SPEC_GEN = dict(max_new_tokens=8, attention_mask=(SPEC_IDS != 1).astype(np.float32),
                eos_token_id=None)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("k,mode", [(1, "whole"), (4, "whole"), (4, "prefix")])
def test_speculative_tokens_equal_jax_and_resident(setup, monkeypatch, k, mode, prefetch):
    """Greedy tokens of the speculative engine equal the JAX speculative
    engine's and the resident path's, on an arena of 2E slots. With prefetch
    off and one worker, the executions of every step or block and the
    arena's counters equal the JAX engine's, and replays occur."""
    _, jparams, _, params, stores = setup
    jmodel, model = _fresh_models(setup)
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    threads = 2 if prefetch else 1
    path = stores["float32"]
    jeng = _jax_engine(jmodel, jparams, path, 2 * E, prefetch, threads, speculative=True,
                       spec_block=k)
    eng = _port_engine(model, params, path, 2 * E, prefetch, threads, speculative=True,
                       spec_block=k)
    res, _ = _resident(model, params, path)
    try:
        want = jeng.generate(SPEC_IDS, **SPEC_GEN)
        with port_attention("naive"):
            got = eng.generate(SPEC_IDS, **SPEC_GEN)
            base = res.generate(SPEC_IDS, **SPEC_GEN)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.sequences, base.sequences)
        assert got.stats["decode_steps"] == 8
        assert model.route_margin == 2 and eng.speculative
        assert len(eng.replay_counts) == (8 if k == 1 else 2)
        assert sum(n for n, _ in eng.step_times) == 8
        if not prefetch:
            assert eng.replay_counts == jeng.replay_counts
            assert max(eng.replay_counts) > 1
            assert eng.stats() == jeng.stats()
            assert eng.decode_window_stats() == jeng.decode_window_stats()
            if mode == "whole" and k > 1:
                assert eng.spec_log == jeng.spec_log
        assert eng.executed_steps >= 8
        assert not eng.arena.policy.protected_ondemand
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("mode", ["whole", "prefix"])
def test_speculative_eos_mid_block(setup, monkeypatch, mode):
    """A row's EOS inside a block stops it at the step the per-step path
    would, and the batch ends in the middle of the block."""
    _, jparams, _, params, stores = setup
    jmodel, model = _fresh_models(setup)
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    path = stores["float32"]
    res, _ = _resident(model, params, path)
    ids, mask = IDS[:1], MASK[:1]
    with port_attention("naive"):
        first = res.generate(ids, max_new_tokens=3, attention_mask=mask, eos_token_id=None)
    eos = int(first.sequences[0, 3])  # the third token: inside the first block
    gen = dict(max_new_tokens=8, attention_mask=mask, eos_token_id=eos)
    jeng = _jax_engine(jmodel, jparams, path, 2 * E, False, 1, speculative=True, spec_block=4)
    eng = _port_engine(model, params, path, 2 * E, False, 1, speculative=True, spec_block=4)
    try:
        want = jeng.generate(ids, **gen)
        with port_attention("naive"):
            got = eng.generate(ids, **gen)
            base = res.generate(ids, **gen)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.sequences, base.sequences)
        np.testing.assert_array_equal(got.num_generated, base.num_generated)
        assert got.num_generated[0] <= 3 and got.stats["decode_steps"] == got.num_generated[0]
        assert len(eng.replay_counts) == 1  # one block, ended by EOS
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


def test_speculative_capacity_degrades_then_falls_back(setup):
    """An arena of E slots cannot hold a step's union across the two decoder
    MoE layers: capacity errors halve the block (4 -> 2 -> 1), then the
    whole step fails too and the engine falls back to the per-layer path
    for good. Tokens stay equal to the resident path's, and each engine
    takes the same way down as the JAX engine."""
    _, jparams, _, params, stores = setup
    jmodel, model = _fresh_models(setup)
    path = stores["float32"]
    jeng = _jax_engine(jmodel, jparams, path, E, False, 1, speculative=True, spec_block=4)
    eng = _port_engine(model, params, path, E, False, 1, speculative=True, spec_block=4)
    res, _ = _resident(model, params, path)
    try:
        want = jeng.generate(SPEC_IDS, **SPEC_GEN)
        with port_attention("naive"):
            got = eng.generate(SPEC_IDS, **SPEC_GEN)
            base = res.generate(SPEC_IDS, **SPEC_GEN)
        np.testing.assert_array_equal(got.sequences, base.sequences)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        assert eng._k_cap < 4 and eng.spec_block < 4
        assert (eng._k_cap, eng.spec_block, eng.speculative) == (
            jeng._k_cap, jeng.spec_block, jeng.speculative)
        assert eng.replay_counts == jeng.replay_counts
        assert eng.stats() == jeng.stats()
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("mode", ["whole", "prefix"])
def test_speculative_kernel_path_equals_resident(setup, monkeypatch, mode):
    """impl="pallas" (K3's plain version on the CPU) over int4 slots, blocks
    of 4 with prefetch on: executions that are not accepted route to
    experts whose slot row reads -1, which K3's path masks to zero; the
    accepted ones equal the resident path's tokens exactly."""
    _, _, _, params, stores = setup
    _, model = _fresh_models(setup)
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    path = stores["int4"]
    eng = _port_engine(model, params, path, 2 * E, True, 2, impl="pallas", speculative=True,
                       spec_block=4)
    res, _ = _resident(model, params, path, impl="pallas")
    try:
        got = eng.generate(SPEC_IDS, **SPEC_GEN)
        want = res.generate(SPEC_IDS, **SPEC_GEN)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        assert max(eng.replay_counts) > 1
    finally:
        eng.arena.shutdown()


def test_speculative_raises_what_is_not_a_capacity_error(setup, monkeypatch):
    """Only capacity errors change the path: any other error of a dispatch
    reaches the caller."""
    _, _, _, params, stores = setup
    _, model = _fresh_models(setup)
    eng = _port_engine(model, params, stores["float32"], 2 * E, False, 1, speculative=True,
                       spec_block=4)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    try:
        monkeypatch.setattr(model, "decode_step", broken)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            eng.generate(SPEC_IDS, **SPEC_GEN)
        assert eng.speculative and eng._k_cap == 4
    finally:
        eng.arena.shutdown()


def test_route_margin_trace_equals_jax(setup):
    """decode_step's trace with route_margin 2 on the resident path: the
    top-2 and the next two runner-ups of every decoder MoE layer, equal to
    the JAX model's, over several steps."""
    from moe_infinity_tpu.runtime.providers import ResidentProvider as JResident

    _, jparams, _, params, stores = setup
    jmodel, model = _fresh_models(setup)
    jmodel.route_margin = model.route_margin = 2
    path = stores["float32"]
    jres = JResident(JStore(path), dtype=jnp.float32)
    res = ResidentProvider.from_store(ExpertStore(path), dtype=torch.float32, device="cpu")
    tok, m = jnp.asarray(IDS, jnp.int32), jnp.asarray(MASK)
    jcross = jmodel.cross_kv(jparams, jmodel.encode(jparams, jres.pytree(), tok, m,
                                                    JResident.for_layer))
    jkv = jmodel.init_cache(2, 16)
    with port_attention("naive"), torch.inference_mode():
        pm = torch.as_tensor(MASK)
        cross = model.cross_kv(params, model.encode(
            params, res.pytree(), torch.as_tensor(IDS, dtype=torch.int32), pm,
            ResidentProvider.for_layer))
        kv = model.init_cache(2, 16)
        cur = np.full((2, 1), 2, np.int32)
        for step in range(4):
            pos = np.full((2, 1), step, np.int32)
            jlog, jkv, jtr = jmodel.decode_step(
                jparams, jres.pytree(), jnp.asarray(cur), jnp.asarray(pos), jkv,
                jnp.int32(step), m, jcross, JResident.for_layer)
            _, kv, tr = model.decode_step(
                params, res.pytree(), torch.as_tensor(cur), torch.as_tensor(pos), kv, step, pm,
                cross, ResidentProvider.for_layer)
            assert tr.shape == (2, 2, 1, 4) and tr.dtype == torch.int32
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            cur = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
