"""Switch through the port's offload engine (``runtime/engine_seq2seq.py``)
on the CPU, against the JAX ``Seq2SeqOffloadEngine`` and the port's
resident ``Seq2SeqGenerator``: a tiny Switch (4+4 blocks, every second
sparse, 4 experts, d_model 32, d_kv 8, f32) at expert capacity 2, so that
the encoder drops tokens, on a padded batch. The experts live in stores
written from the JAX ``SwitchModel.init_random`` weights with the JAX
``ExpertStoreWriter`` (``torch_port_helpers.write_switch_store``: f32, and
packed int4 with per-channel scales; the encoder's two MoE layers first,
as ``num_encoder_moe_layers`` says); both packages read the same files.

Greedy tokens are compared exactly, through the per-layer path and the
speculative whole-step (k = 1) and k-step block (k = 3, both
``MOE_SPEC_BLOCK_MODE``s) paths. With prefetch off and one fetch worker the
arena's order of events is fixed, so the executions and the hit, miss and
eviction counters must equal the JAX engine's too. The decode step as
graphs and stream decode are in tests/test_torch_switch_offload_graphs.py,
so that the two files run on two workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.memory import ExpertPredictor as JPredictor
from moe_infinity_tpu.memory import ExpertTracer as JTracer
from moe_infinity_tpu.models.switch import SwitchModel as JSwitchModel
from moe_infinity_tpu.models.switch import SwitchSpec as JSwitchSpec
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JEngine
from moe_infinity_tpu.runtime.generate import Seq2SeqGenerator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JResident
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine, stack_depths
from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore
from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

from torch_port_helpers import to_port, write_switch_store, one_intra_op_thread

SPEC = dict(
    vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_heads=4,
    num_encoder_layers=4, num_decoder_layers=4,
    encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, expert_capacity=2, rel_buckets=8, rel_max_distance=16,
    rms_eps=1e-6, tie_embeddings=True, is_gated=False, dense_act_gelu=False,
    decoder_start_token_id=0,
)
E, N_MOE, N_ENC = 4, 4, 2
IDS = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 0, 0], [60, 7, 2, 0, 0, 0]])
MASK = (np.arange(6)[None] < np.array([[6], [4], [3]])).astype(np.float32)
GEN = dict(max_new_tokens=8, attention_mask=MASK, eos_token_id=None)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = JSwitchModel(JSwitchSpec(**SPEC), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(9))
    root = tmp_path_factory.mktemp("torch_switch_offload")
    stores = {q: write_switch_store(root / q, jtree["layers"], q, N_ENC)
              for q in ("float32", "int4")}
    return jparams, jtree, to_port(jparams), stores


def _models():
    """New model objects over the shared params: a speculative engine sets
    ``route_margin`` on its model."""
    return (JSwitchModel(JSwitchSpec(**SPEC), compute_dtype=jnp.float32),
            SwitchModel(SwitchSpec(**SPEC), compute_dtype=torch.float32, device="cpu"))


def _jax_engine(jmodel, jparams, path, slots, prefetch, threads, **kw):
    arena = JArena(JStore(path), slots, compute_dtype=jnp.float32, num_threads=threads)
    tracer = JTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    return JEngine(jmodel, jparams, arena, tracer=tracer, predictor=JPredictor(tracer),
                   prefetch=prefetch, **kw)


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


def test_store_layout_and_resident_tokens_equal_jax(setup):
    """The store's metadata drives both packages alike: the encoder's MoE
    layers first, the ``switch`` roles; the resident path over its records
    gives the JAX resident generator's tokens on a padded batch at capacity
    2 (tokens dropped), and the JAX init tree's."""
    jparams, jtree, params, stores = setup
    jmodel, model = _models()
    store = ExpertStore(stores["float32"])
    assert store.meta == {"arch": "switch", "num_encoder_moe_layers": N_ENC}
    assert store.num_layers == N_MOE and stack_depths(model.spec) == (4, 4)
    assert [model.spec.moe_layer_id(i, d) for d, i in ((False, 1), (False, 3), (True, 1),
                                                       (True, 3))] == [0, 1, 2, 3]
    res, provider = _resident(model, params, stores["float32"])
    np.testing.assert_array_equal(provider.pytree()["layers"][2]["gate"].numpy(),
                                  np.asarray(jtree["layers"][2]["gate"]))
    jres = JResident(JStore(stores["float32"]), dtype=jnp.float32)
    want = JGenerator(jmodel, jparams, jres.pytree(), JResident.for_layer).generate(IDS, **GEN)
    got = res.generate(IDS, **GEN)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    init = JGenerator(jmodel, jparams, jtree, JResident.for_layer).generate(IDS, **GEN)
    np.testing.assert_array_equal(got.sequences, init.sequences)


@pytest.mark.parametrize("quant", ["float32", "int4"])
@pytest.mark.parametrize("slots", [E, 2 * E])
@pytest.mark.parametrize("prefetch", [False, True])
def test_per_layer_tokens_equal_jax_and_resident(setup, quant, slots, prefetch):
    jparams, _, params, stores = setup
    jmodel, model = _models()
    threads = 2 if prefetch else 1
    jeng = _jax_engine(jmodel, jparams, stores[quant], slots, prefetch, threads)
    eng = _port_engine(model, params, stores[quant], slots, prefetch, threads)
    res, _ = _resident(model, params, stores[quant])
    try:
        want = jeng.generate(IDS, **GEN)
        got = eng.generate(IDS, **GEN)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.sequences, res.generate(IDS, **GEN).sequences)
        assert got.stats["decode_steps"] == 8
        s = eng.stats()
        assert s["visits"] > 0 and (slots > E or s["evictions"] > 0)
        assert not eng.tracer.trace and eng.tracer.trace_collection.sum() > 0
        if not prefetch:
            assert s == jeng.stats()
            assert eng.decode_window_stats() == jeng.decode_window_stats()
            assert eng.hit_rate() == jeng.hit_rate()
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("k,mode", [(1, "whole"), (3, "whole"), (3, "prefix")])
def test_speculative_tokens_equal_jax_and_resident(setup, monkeypatch, k, mode, prefetch):
    """The speculative engine (route margin 2) on an arena of 2E slots: the
    whole step at k = 1 and blocks of 3 (8 tokens: blocks of 3, 3, 1, 1).
    Tokens equal the JAX engine's and the resident path's; with prefetch
    off and one worker the executions of every step or block and the
    arena's counters equal the JAX engine's, and some dispatch runs again."""
    jparams, _, params, stores = setup
    jmodel, model = _models()
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    threads = 2 if prefetch else 1
    path = stores["float32"]
    jeng = _jax_engine(jmodel, jparams, path, 2 * E, prefetch, threads, speculative=True,
                       spec_block=k)
    eng = _port_engine(model, params, path, 2 * E, prefetch, threads, speculative=True,
                       spec_block=k)
    res, _ = _resident(model, params, path)
    try:
        want = jeng.generate(IDS, **GEN)
        got = eng.generate(IDS, **GEN)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.sequences, res.generate(IDS, **GEN).sequences)
        assert model.route_margin == 2 and eng.speculative
        assert sum(n for n, _ in eng.step_times) == 8
        if not prefetch:
            assert eng.replay_counts == jeng.replay_counts
            assert max(eng.replay_counts) > 1
            assert eng.stats() == jeng.stats()
            assert eng.decode_window_stats() == jeng.decode_window_stats()
            assert (eng._k_cap, eng.spec_block) == (jeng._k_cap, jeng.spec_block)
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("speculative", [False, True])
def test_kernel_path_offload_equals_resident_exactly(setup, speculative):
    """impl="pallas" (K3's plain version on the CPU) over int4 slots fed by a
    tier of 6 records and the store: first-step logits of the per-layer
    path equal the resident path's exactly, and greedy tokens, per-layer or
    speculative (blocks of 3), equal the resident path's."""
    _, _, params, stores = setup
    _, model = _models()
    path = stores["int4"]
    store = ExpertStore(path)
    tier = PinnedExpertTier(store, device="cpu", max_bytes=6 * sum(f.nbytes for f in store.fields))
    eng = _port_engine(model, params, path, 2 * E, True, 2, impl="pallas", tier=tier,
                       speculative=speculative, spec_block=3)
    res, provider = _resident(model, params, path, impl="pallas")
    try:
        tok, m = torch.as_tensor(IDS, dtype=torch.int32), torch.as_tensor(MASK)
        with torch.inference_mode():
            _, cross = eng.run_encoder(tok, m)
            start = torch.zeros(3, 1, dtype=torch.int32)
            got = eng.decode_step(start, 0, eng.init_cache(3, 16), m, cross)
            enc = model.encode(params, provider.pytree(), tok, m, ResidentProvider.for_layer,
                               "pallas")
            want, _, _ = model.decode_step(
                params, provider.pytree(), start, torch.zeros(3, 1, dtype=torch.int32),
                model.init_cache(3, 16), 0, m, model.cross_kv(params, enc),
                ResidentProvider.for_layer, "pallas")
        assert torch.equal(got, want)
        np.testing.assert_array_equal(eng.generate(IDS, **GEN).sequences,
                                      res.generate(IDS, **GEN).sequences)
        assert eng.arena.fetch_stats()["fetches_tier"] > 0
    finally:
        eng.arena.shutdown()


def test_gated_store_roles(setup, tmp_path):
    """A store written with ``gated`` carries ``wi_0``/``wi_1``/``wo``
    (``switch_gated``): the resident provider stacks them as gate, up and
    down, and the per-layer engine over it gives the resident path's and
    the JAX engine's tokens."""
    jparams, jtree, params, _ = setup
    rng = np.random.default_rng(2)
    layers = [dict(lay, up=jnp.asarray(rng.standard_normal(lay["gate"].shape) * 0.02,
                                       jnp.float32)) for lay in jtree["layers"]]
    path = write_switch_store(tmp_path / "gated", layers, "float32", N_ENC, gated=True)
    jmodel, model = _models()
    res, provider = _resident(model, params, path)
    assert sorted(provider.pytree()["layers"][0]) == ["down", "gate", "up"]
    jeng = _jax_engine(jmodel, jparams, path, E, False, 1)
    eng = _port_engine(model, params, path, E, False, 1)
    try:
        want = jeng.generate(IDS, **GEN)
        got = eng.generate(IDS, **GEN)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.sequences, res.generate(IDS, **GEN).sequences)
        assert eng.stats() == jeng.stats()
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


def test_memory_policy_topology_from_store_meta(setup):
    """The tracer and the arena's cache policy read the encoder's MoE depth
    from the store (``num_encoder_moe_layers`` 2 of 4 layers), as the JAX
    arena does."""
    _, _, _, stores = setup
    arena = ExpertArena(ExpertStore(stores["float32"]), E, compute_dtype=torch.float32,
                        device="cpu")
    jarena = JArena(JStore(stores["float32"]), E, compute_dtype=jnp.float32)
    try:
        assert arena.policy.num_encoder_layers == jarena.policy.num_encoder_layers == N_ENC
        assert arena.policy.num_layers == jarena.policy.num_layers == N_MOE
    finally:
        arena.shutdown()
        jarena.shutdown()
