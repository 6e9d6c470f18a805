"""The port's decoder-only ``OffloadEngine`` (``runtime/engine.py``) under
``Generator`` on the CPU, against the JAX ``OffloadEngine`` and the port's
resident ``Generator``, mirroring the engine half of
tests/test_arena_engine.py (:209-440), tests/test_prefill_impl.py:145 and
tests/test_arena_chunked.py:170.

A tiny Mixtral (3 layers, 8 experts top-2, f32) and a tiny DeepSeek-V2 (a
dense first layer, 2 MoE layers, a shared expert) take their weights from
the JAX models' init_random; the experts live in stores written from those
trees with the JAX ExpertStoreWriter (``write_decoder_store``: f32, and
int8 with per-channel scales), which both packages read. The per-layer
path, the speculative whole step and the k-step block in both
``MOE_SPEC_BLOCK_MODE`` modes run on arenas small enough that replays and
evictions occur. Greedy tokens are compared exactly; with prefetch off and
one fetch worker the arena's order of events is fixed, so executions, the
hit, miss and eviction counters and the per-expert counters must equal the
JAX engine's too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.memory import ExpertPredictor as JPredictor
from moe_infinity_tpu.memory import ExpertTracer as JTracer
from moe_infinity_tpu.models import deepseek_v2 as jds
from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.engine import OffloadEngine as JEngine
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu.store.pinned import PinnedExpertTier as JTier
from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine import OffloadEngine
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore
from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

from torch_port_helpers import one_intra_op_thread, to_port, write_decoder_store

L, E = 3, 8
MIXTRAL = dict(
    vocab_size=160, hidden_size=48, intermediate_size=96, num_layers=L, num_heads=6,
    num_kv_heads=2, head_dim=8, num_experts=E, top_k=2, rms_eps=1e-5, rope_theta=1e6,
    tie_embeddings=False,
)
# tests/test_arena_engine.py:421-428
DEEPSEEK = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=48,
    num_layers=3, num_heads=4, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=32, num_experts=8, top_k=2, n_shared_experts=1, first_k_dense_replace=1,
    topk_method="greedy", n_group=None, topk_group=None, routed_scaling_factor=1.0,
    rms_eps=1e-6, rope_theta=10000.0, tie_embeddings=False, q_lora_rank=None,
)
ONE = np.array([[5, 17, 31, 7]])
TWO = np.array([[5, 17, 31, 7], [9, 4, 2, 61]])


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    jmodel = JMixtralModel(JMixtralSpec(**MIXTRAL), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(3), expert_dtype=jnp.float32)
    root = tmp_path_factory.mktemp("torch_offload_engine")
    stores = {q: write_decoder_store(root / q, jtree["layers"], "mixtral", q)
              for q in ("float32", "int8")}
    model = MixtralModel(MixtralSpec(**MIXTRAL), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, to_port(jparams), stores


@pytest.fixture(scope="module")
def deepseek(tmp_path_factory):
    jmodel = jds.DeepseekV2ModelJax(jds.DeepseekV2Spec(**DEEPSEEK), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(8))
    path = write_decoder_store(tmp_path_factory.mktemp("torch_offload_ds") / "store",
                               jtree["layers"], "deepseek")
    model = DeepseekV2Model(DeepseekV2Spec(**DEEPSEEK), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, to_port(jparams), path


def _jax_engine(jmodel, jparams, path, slots, *, prefetch=False, threads=1, tracer=True,
                policy="priority", tier=None, **kw):
    arena = JArena(JStore(path), slots, compute_dtype=jnp.float32, num_threads=threads,
                   policy=policy, pinned_tier=tier)
    n = JStore(path).num_layers
    tr = JTracer(16, n, E) if tracer else None
    return JEngine(jmodel, jparams, arena, tracer=tr, predictor=JPredictor(tr) if tr else None,
                   prefetch=prefetch, **kw)


def _port_engine(model, params, path, slots, *, prefetch=False, threads=1, tracer=True,
                 policy="priority", tier=None, **kw):
    arena = ExpertArena(ExpertStore(path), slots, compute_dtype=torch.float32, device="cpu",
                        num_threads=threads, policy=policy, pinned_tier=tier)
    n = ExpertStore(path).num_layers
    tr = ExpertTracer(16, n, E) if tracer else None
    return OffloadEngine(model, params, arena, tracer=tr,
                         predictor=ExpertPredictor(tr) if tr else None, prefetch=prefetch, **kw)


def _resident(model, params, path, impl="ragged"):
    provider = ResidentProvider.from_store(ExpertStore(path), dtype=torch.float32, device="cpu")
    return Generator(model, params, provider.pytree(), ResidentProvider.for_layer, impl=impl,
                     max_seq_len=64)


def _run_both(jeng, eng, prompt, n, **kw):
    """(port tokens, JAX tokens) of one greedy request through each engine's
    Generator; both arenas are shut down afterwards."""
    try:
        want = JGenerator(stepper=jeng, max_seq_len=64).generate(prompt, max_new_tokens=n, **kw)
        got = Generator(stepper=eng, max_seq_len=64).generate(prompt, max_new_tokens=n, **kw)
        return got.sequences, want.sequences
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


def _same_counters(eng, jeng):
    assert eng.replay_counts == jeng.replay_counts
    assert eng.stats() == jeng.stats()
    assert eng.hit_rate() == jeng.hit_rate()
    got_ns, want_ns = eng.node_stats(), jeng.node_stats()
    for k in want_ns:
        np.testing.assert_array_equal(got_ns[k], want_ns[k], err_msg=k)


# ---- the per-layer path -----------------------------------------------------------

@pytest.mark.parametrize("quant", ["float32", "int8"])
@pytest.mark.parametrize("slots", [E, 2 * E])
@pytest.mark.parametrize("prefetch", [False, True])
def test_offload_matches_resident_and_jax(mixtral, quant, slots, prefetch):
    jmodel, jparams, model, params, stores = mixtral
    threads = 2 if prefetch else 1
    jeng = _jax_engine(jmodel, jparams, stores[quant], slots, prefetch=prefetch, threads=threads)
    eng = _port_engine(model, params, stores[quant], slots, prefetch=prefetch, threads=threads)
    base = _resident(model, params, stores[quant]).generate(ONE, max_new_tokens=8)
    got, want = _run_both(jeng, eng, ONE, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.executed_steps == 7  # one-token steps after the prefill
    s = eng.stats()
    assert s["visits"] > 0 and (slots > E or s["evictions"] > 0)
    if not prefetch:
        _same_counters(eng, jeng)


def test_constrained_arena_still_correct_and_counts(mixtral):
    """One layer's worth of slots for 24 experts: heavy eviction."""
    jmodel, jparams, model, params, stores = mixtral
    jeng = _jax_engine(jmodel, jparams, stores["float32"], E, prefetch=True, threads=2)
    eng = _port_engine(model, params, stores["float32"], E, prefetch=True, threads=2)
    got, want = _run_both(jeng, eng, np.array([[9, 3, 42]]), 6)
    np.testing.assert_array_equal(got, want)
    s = eng.stats()
    assert s["visits"] > 0 and s["misses"] > 0 and s["evictions"] > 0


def test_tracer_records_and_finishes(mixtral):
    jmodel, jparams, model, params, stores = mixtral
    jeng = _jax_engine(jmodel, jparams, stores["float32"], E * L, prefetch=True, threads=2)
    eng = _port_engine(model, params, stores["float32"], E * L, prefetch=True, threads=2)
    got, want = _run_both(jeng, eng, np.array([[1, 2, 3]]), 4)
    np.testing.assert_array_equal(got, want)
    for e in (eng, jeng):
        assert not e.tracer.trace  # finished
        assert e.tracer.trace_collection.sum() > 0
    np.testing.assert_array_equal(eng.tracer.trace_collection, jeng.tracer.trace_collection)


def test_prefetch_improves_hits(mixtral):
    """A repeated workload on a small arena: with lookahead prefetch the hit
    rate stays decent, and every request's tokens equal the JAX engine's."""
    jmodel, jparams, model, params, stores = mixtral
    jeng = _jax_engine(jmodel, jparams, stores["float32"], 12, prefetch=True, threads=2)
    eng = _port_engine(model, params, stores["float32"], 12, prefetch=True, threads=2)
    try:
        gens = (Generator(stepper=eng, max_seq_len=64), JGenerator(stepper=jeng, max_seq_len=64))
        for _ in range(3):
            got, want = (g.generate(np.array([[7, 7, 7]]), max_new_tokens=6).sequences
                         for g in gens)
            np.testing.assert_array_equal(got, want)
        assert eng.hit_rate() > 0.2 and eng.stats()["prefetches"] > 0
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("impl,prefill_impl", [("gather", "ragged"), ("pallas", "ragged"),
                                               ("ragged", "pallas")])
def test_mixed_impl_matches_uniform(mixtral, impl, prefill_impl):
    """tests/test_prefill_impl.py:145: a step of T = 1 takes ``impl``, a
    longer one ``prefill_impl``; the tokens do not depend on the choice."""
    jmodel, jparams, model, params, stores = mixtral
    prompt = np.array([[7, 31, 4, 90, 12]])
    seqs = []
    for kw in (dict(impl="ragged"), dict(impl=impl, prefill_impl=prefill_impl)):
        eng = _port_engine(model, params, stores["float32"], E, threads=2, **kw)
        try:
            seqs.append(Generator(stepper=eng, max_seq_len=64).generate(
                prompt, max_new_tokens=6).sequences)
            assert eng._impl == kw["impl"] and eng._pimpl == kw.get("prefill_impl", kw["impl"])
        finally:
            eng.arena.shutdown()
    jeng = _jax_engine(jmodel, jparams, stores["float32"], E, threads=2, impl="ragged")
    try:
        want = JGenerator(stepper=jeng, max_seq_len=64).generate(prompt, max_new_tokens=6)
    finally:
        jeng.arena.shutdown()
    np.testing.assert_array_equal(seqs[1], seqs[0])
    np.testing.assert_array_equal(seqs[0], want.sequences)


def test_engine_budget_shrinks_with_measured_rates(mixtral):
    """tests/test_arena_chunked.py:170: the measured layer period and fetch
    time set the prefetch budget, as in the JAX engine."""
    jmodel, jparams, model, params, stores = mixtral
    jeng = _jax_engine(jmodel, jparams, stores["float32"], E, threads=2, tracer=False,
                       prefetch_budget=16)
    eng = _port_engine(model, params, stores["float32"], E, threads=2, tracer=False,
                       prefetch_budget=16)
    try:
        for e in (eng, jeng):
            assert e._current_budget() == 16  # nothing measured yet
            e._layer_seconds = 0.010
            e.arena.fetch_seconds_ewma = 0.020
        # 2 workers, lookahead 3: 3 * 0.01 * 2 / 0.02 = 3
        assert eng._current_budget() == jeng._current_budget() == 3
        eng.adaptive_budget = jeng.adaptive_budget = False
        assert eng._current_budget() == jeng._current_budget() == 16
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


# ---- the pinned tier over a decoder-only store -----------------------------------

def _budget(path, records):
    """The tier's byte budget for ``records`` records (None: all)."""
    if records is None:
        return None
    return records * sum(int(np.prod(f.shape)) * np.dtype(f.dtype).itemsize
                         for f in ExpertStore(path).fields)


@pytest.mark.parametrize("records", [None, 10])
def test_tier_generate_matches_jax_and_resident(mixtral, records):
    """tests/test_pinned_tier.py:108 on an int8 Mixtral store: the engine's
    fetches land from the tier (all records, or 10 with the rest from the
    store), and the tokens equal the JAX engine's over a tier of the
    same budget and the resident path's."""
    jmodel, jparams, model, params, stores = mixtral
    path = stores["int8"]
    jtier = JTier(JStore(path), shared_record=False, max_bytes=_budget(path, records))
    tier = PinnedExpertTier(ExpertStore(path), device="cpu", shared_record=False,
                            max_bytes=_budget(path, records))
    assert tier.num_staged == jtier.num_staged == (records or L * E)
    jeng = _jax_engine(jmodel, jparams, path, E, tracer=False, tier=jtier)
    eng = _port_engine(model, params, path, E, tracer=False, tier=tier)
    base = _resident(model, params, path).generate(ONE, max_new_tokens=6)
    got, want = _run_both(jeng, eng, ONE, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    fetches = eng.arena.fetch_stats()
    assert fetches["fetches_tier"] > 0 and (records is None) == (fetches["fetches_store"] == 0)
    _same_counters(eng, jeng)


def test_tier_staging_order_decoder_store(mixtral):
    """tests/test_pinned_tier.py:206 on a decoder-only store (no encoder
    layers): under a budget of 5 records the port stages the same records,
    in the same rows, as the JAX tier."""
    path = mixtral[4]["float32"]
    jtier = JTier(JStore(path), shared_record=False, max_bytes=_budget(path, 5))
    tier = PinnedExpertTier(ExpertStore(path), device="cpu", shared_record=False,
                            max_bytes=_budget(path, 5))
    assert tier.num_staged == jtier.num_staged == 5
    for layer in range(L):
        for e in range(E):
            assert tier.record_index(layer, e) == jtier.record_index(layer, e), (layer, e)


# ---- the speculative path ------------------------------------------------------------

@pytest.mark.parametrize("quant", ["float32", "int8"])
def test_speculative_step_matches_resident_and_jax(mixtral, quant):
    """12 slots hold one step's union (3 layers x <= 4 routed at B = 2) but
    not the hot set across steps, so steps run again."""
    jmodel, jparams, model, params, stores = mixtral
    jeng = _jax_engine(jmodel, jparams, stores[quant], 12, speculative=True)
    eng = _port_engine(model, params, stores[quant], 12, speculative=True, graphs=False)
    base = _resident(model, params, stores[quant]).generate(TWO, max_new_tokens=8)
    got, want = _run_both(jeng, eng, TWO, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.speculative and eng.replay_counts and max(eng.replay_counts) > 1
    assert eng.executed_steps == sum(eng.replay_counts)
    _same_counters(eng, jeng)


@pytest.mark.parametrize("mode", ["whole", "prefix"])
@pytest.mark.parametrize("k", [2, 3])
def test_speculative_block_matches_resident_and_jax(mixtral, monkeypatch, mode, k):
    """k greedy steps per block through the Generator, with the ragged tail
    (8 tokens: the prefill's, then blocks of k and a single step where no
    block of 2 fits), in both block modes."""
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    jmodel, jparams, model, params, stores = mixtral
    jeng = _jax_engine(jmodel, jparams, stores["float32"], 20, speculative=True, spec_block=k)
    eng = _port_engine(model, params, stores["float32"], 20, speculative=True, spec_block=k,
                       graphs=False)
    base = _resident(model, params, stores["float32"]).generate(TWO, max_new_tokens=8)
    got, want = _run_both(jeng, eng, TWO, 8, eos_token_id=None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.spec_block == k  # never halved
    assert eng.replay_counts and max(eng.replay_counts) > 1
    _same_counters(eng, jeng)


def test_speculative_with_prefetch_matches(mixtral):
    """Next-step warming runs while the host verifies; the residency the
    dispatch saw keeps the result exact."""
    jmodel, jparams, model, params, stores = mixtral
    jeng = _jax_engine(jmodel, jparams, stores["float32"], 12, prefetch=True, threads=2,
                       speculative=True)
    eng = _port_engine(model, params, stores["float32"], 12, prefetch=True, threads=2,
                       speculative=True, graphs=False)
    got, want = _run_both(jeng, eng, TWO, 10)
    np.testing.assert_array_equal(got, want)
    assert eng.replay_counts and eng.stats()["prefetches"] > 0


@pytest.mark.parametrize("spec_block", [1, 2])
def test_speculative_falls_back_when_union_exceeds_arena(mixtral, spec_block):
    """E slots cannot hold one step's union (3 layers x 4 routed at B = 2):
    a block halves down to 1, then the step turns speculation off for good
    and the request ends exactly on the per-layer path."""
    jmodel, jparams, model, params, stores = mixtral
    jeng = _jax_engine(jmodel, jparams, stores["float32"], E, tracer=False, speculative=True,
                       spec_block=spec_block)
    eng = _port_engine(model, params, stores["float32"], E, tracer=False, speculative=True,
                       spec_block=spec_block, graphs=False)
    got, want = _run_both(jeng, eng, TWO, 6)
    np.testing.assert_array_equal(got, want)
    assert eng.speculative is False and jeng.speculative is False
    assert eng.spec_block == jeng.spec_block == 1


def test_other_errors_are_raised_not_hidden(mixtral):
    """Only capacity errors change the path: a failure inside a dispatch
    propagates (the JAX engine runs the per-layer path for that step)."""
    _, _, model, params, stores = mixtral
    eng = _port_engine(model, params, stores["float32"], 12, speculative=True, spec_block=2,
                       graphs=False)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    eng._spec_step = broken
    eng._spec_block_fn = lambda k: broken
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            Generator(stepper=eng, max_seq_len=64).generate(TWO, max_new_tokens=4)
        eng.spec_block = 1
        with pytest.raises(RuntimeError, match="illegal memory access"):
            Generator(stepper=eng, max_seq_len=64).generate(TWO, max_new_tokens=4)
        assert eng.speculative
    finally:
        eng.arena.shutdown()


# ---- DeepSeek-V2 --------------------------------------------------------------------

@pytest.mark.parametrize("path", ["per_layer", "step", "whole", "prefix"])
def test_deepseek_matches_resident_and_jax(deepseek, monkeypatch, path):
    """The dense first layer and the shared expert run beside the routed
    experts; only the routed trace drives verification (tests/
    test_arena_engine.py:406). 8 slots: evictions on the per-layer path,
    replays on the speculative ones; blocks of 2."""
    jmodel, jparams, model, params, path_ = deepseek
    k = 1 if path in ("per_layer", "step") else 2
    if k > 1:
        monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", path)
    kw = dict(speculative=path != "per_layer", spec_block=k)
    slots = E if path == "per_layer" else 12
    jeng = _jax_engine(jmodel, jparams, path_, slots, **kw)
    eng = _port_engine(model, params, path_, slots, graphs=False, **kw)
    base = _resident(model, params, path_).generate(ONE, max_new_tokens=8)
    got, want = _run_both(jeng, eng, ONE, 8, eos_token_id=None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.speculative == (path != "per_layer")
    _same_counters(eng, jeng)
    if path == "per_layer":
        assert eng.stats()["evictions"] > 0
    else:
        assert eng.replay_counts


# ---- what is not ported ---------------------------------------------------------------

def test_unported_options_raise(mixtral, deepseek):
    _, _, model, params, stores = mixtral
    arena = ExpertArena(ExpertStore(stores["float32"]), E, compute_dtype=torch.float32,
                        device="cpu", num_threads=1)
    try:
        # dense paging and the host fallback are served
        # (tests/test_torch_dense_paging.py, test_torch_host_fallback.py); what
        # stays refused: a speculative engine over paged layers, and the
        # fallback over an arena without its zero slot
        with pytest.raises(ValueError, match="speculative decode requires"):
            OffloadEngine(model, params, arena, dense_arena=object(), speculative=True)
        with pytest.raises(ValueError, match="reserve_zero_slot"):
            OffloadEngine(model, params, arena, host_fallback=True)
        with pytest.raises(ValueError, match="one\\s+full MoE layer"):
            OffloadEngine(model, params, ExpertArena(
                ExpertStore(stores["float32"]), E - 1, compute_dtype=torch.float32,
                device="cpu", num_threads=1))
    finally:
        arena.shutdown()
    _, _, ds_model, ds_params, ds_path = deepseek
    arena = ExpertArena(ExpertStore(ds_path), E, compute_dtype=torch.float32, device="cpu",
                        num_threads=1)

    class Backend:
        def capture(self, fn):
            raise AssertionError("no capture expected")

    try:
        with pytest.raises(NotImplementedError, match="10a part 2"):
            OffloadEngine(ds_model, ds_params, arena, speculative=True, graph_backend=Backend())
        eager = OffloadEngine(ds_model, ds_params, arena, speculative=True, graphs=False)
        assert eager.graphs is None and eager.graph_stats() == {}
    finally:
        arena.shutdown()
