"""The port's seq2seq continuous batcher (``runtime/continuous_s2s.py``) and
what it rests on, on the CPU against the JAX package, f32:

* ``KVCache.update_rows`` and ``decode_step(row_offsets=...)`` of NLLB and
  Switch against the JAX models' (1e-5; ``update_rows`` exactly);
* the resident batcher's step as a graph (``StandIn``, the CPU's capture
  backend): one capture for the batcher's life, a replay per step, and the
  caches, cross buffers and mask at unchanged addresses after a failed
  step, the same graph serving on;
* Switch at capacity 2, where the encoder drops tokens: a join's padded
  encode drops what the isolated one drops;
* offload mode over a ``Seq2SeqOffloadEngine`` (mirroring
  tests/test_seq2seq_offload.py::test_continuous_offload_batcher_matches_resident):
  tokens equal to the JAX batcher's and to the resident generator's, and,
  with prefetch off and one fetch worker, the executions per step and the
  arena's counters equal to the JAX batcher's; with the engine's graphs;
  a failed step; an arena smaller than one layer's experts;
* the card's capture refuses the "ragged" grouped FFN (it reads group sizes
  on the host): the batcher's defaults, the generator's and the offload
  engine's raise a ``ValueError`` naming the way out instead of failing
  their first step.

Requests that must be admitted together go through ``queue_together``, so
both packages' batchers see the same order of joins. Every future waits at
most ``TIMEOUT`` s and every batcher and arena is shut down in a
``finally``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.memory import ExpertPredictor as JPredictor
from moe_infinity_tpu.memory import ExpertTracer as JTracer
from moe_infinity_tpu.models import layers as jlayers
from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.models.switch import SwitchModel as JSwitchModel
from moe_infinity_tpu.models.switch import SwitchSpec as JSwitchSpec
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.continuous_s2s import Seq2SeqContinuousBatcher as JBatcher
from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JEngine
from moe_infinity_tpu.runtime.generate import Seq2SeqGenerator as JSeq2SeqGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
from moe_infinity_tpu_torch.models.layers import KVCache
from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher
from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.graphs import CudaGraphBackend, graph_cache
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore

from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import (
    StandIn,
    port_attention,
    queue_together,
    sharpen_seq2seq,
    to_port,
    write_nllb_store,
)

TIMEOUT = 60
NLLB = dict(  # tests/test_seq2seq_offload.py's tiny NLLB: 4+4 blocks, 4 MoE layers
    vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, pad_token_id=1, decoder_start_token_id=2, max_positions=64,
    scale_embedding=True,
)
E, N_MOE, N_ENC = 4, 4, 2
SWITCH = dict(
    vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
    num_decoder_layers=2, encoder_sparse_step=2, decoder_sparse_step=2, num_experts=4,
    expert_capacity=8, rel_buckets=8, rel_max_distance=16, rms_eps=1e-6,
    tie_embeddings=True, is_gated=False, dense_act_gelu=False, decoder_start_token_id=0,
)
PROMPTS = [np.array([5, 31, 8, 77, 2, 9]), np.array([9, 4, 61]), np.array([12, 3, 44, 7, 2]),
           np.array([44, 7, 90, 15, 2])]
NEWS = [6, 9, 4, 5]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _pair(jmodel_cls, jspec_cls, model_cls, spec_cls, spec, seed):
    jmodel = jmodel_cls(jspec_cls(**spec), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(seed))
    sharpen_seq2seq(jparams)
    model = model_cls(spec_cls(**spec), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, jtree, model, to_port(jparams), to_port(jtree)


@pytest.fixture(scope="module")
def nllb():
    return _pair(JNllbModel, JNllbSpec, NllbModel, NllbSpec, NLLB, 5)


@pytest.fixture(scope="module")
def switch():
    return _pair(JSwitchModel, JSwitchSpec, SwitchModel, SwitchSpec, SWITCH, 3)


def _isolated(jmodel, jparams, jtree):
    gen = JSeq2SeqGenerator(jmodel, jparams, jtree, JProvider.for_layer)
    return lambda p, n: gen.generate(p[None], max_new_tokens=n, eos_token_id=None).sequences[0]


# ---- the per-row step ------------------------------------------------------------

def test_update_rows_equals_jax():
    rng = np.random.default_rng(0)
    k0, v0 = (rng.standard_normal((3, 8, 2, 4)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((3, 1, 2, 4)).astype(np.float32) for _ in range(2))
    offs = np.array([5, 0, 7], np.int32)
    want = jlayers.KVCache(jnp.asarray(k0), jnp.asarray(v0)).update_rows(
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(offs))
    got = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())).update_rows(
        torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(offs))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


@pytest.mark.parametrize("family", ["nllb", "switch"])
def test_decode_step_row_offsets_equals_jax(request, family):
    """Three rows at columns 5, 0 and 9 of caches holding random values
    (stale columns past each row's own included) over padded cross K/V."""
    jmodel, jparams, jtree, model, params, tree = request.getfixturevalue(family)
    rng = np.random.default_rng(1)
    B, S, Se = 3, 16, 8
    offs = np.array([5, 0, 9], np.int32)
    tok = rng.integers(3, 96, (B, 1)).astype(np.int32)
    src = rng.integers(3, 96, (B, Se)).astype(np.int32)
    mask = np.ones((B, Se), np.float32)
    mask[1, 5:] = 0.0
    jcaches = jmodel.init_cache(B, S)
    fills = [tuple(rng.standard_normal(c.k.shape).astype(np.float32) for _ in range(2))
             for c in jcaches]
    jcaches = [jlayers.KVCache(jnp.asarray(k), jnp.asarray(v)) for k, v in fills]
    caches = [KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in fills]
    jenc = jmodel.encode(jparams, jtree, jnp.asarray(src), jnp.asarray(mask), JProvider.for_layer)
    jlogits, jkvs, _ = jmodel.decode_step(
        jparams, jtree, jnp.asarray(tok), jnp.asarray(offs)[:, None], jcaches, jnp.int32(0),
        jnp.asarray(mask), jmodel.cross_kv(jparams, jenc), JProvider.for_layer,
        row_offsets=jnp.asarray(offs))
    with torch.inference_mode():
        t_mask, t_offs = torch.from_numpy(mask), torch.from_numpy(offs)
        enc = model.encode(params, tree, torch.from_numpy(src), t_mask, ResidentProvider.for_layer)
        logits, kvs, _ = model.decode_step(
            params, tree, torch.from_numpy(tok), t_offs[:, None], caches, 0, t_mask,
            model.cross_kv(params, enc), ResidentProvider.for_layer, row_offsets=t_offs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    for c, jc in zip(kvs, jkvs):
        np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v), rtol=1e-5, atol=1e-5)


# ---- resident mode -----------------------------------------------------------------

def test_graph_replays_and_failure_keep_addresses(nllb):
    """With a capture backend the step is one graph for the batcher's life:
    one capture, a replay per step. A failed step leaves every tensor the
    graph reads where it was, and the same graph serves on, exactly."""
    jmodel, jparams, jtree, model, params, tree = nllb
    want = _isolated(jmodel, jparams, jtree)
    b = Seq2SeqContinuousBatcher(model, params, tree, ResidentProvider.for_layer,
                                 max_batch_size=2, max_src_len=16, max_decode_len=16,
                                 graph_backend=StandIn())
    try:
        futs = queue_together(b, [(p, dict(max_new_tokens=n, eos_token_id=None))
                                  for p, n in zip(PROMPTS[:3], NEWS[:3])])
        for p, n, f in zip(PROMPTS, NEWS, futs):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), want(p, n))
        st = b.graph_stats()
        assert st["captures"] == 1 and st["recaptures"] == 0
        assert st["replays"] == b.step_stats()["steps"]
        ptrs = [t.data_ptr() for t in (b._ck, b._cv, b._mask)] + [
            t.data_ptr() for kv in b._kvs for t in (kv.k, kv.v)]
        orig = b._step
        state = {"armed": True}

        def poisoned(*a, **k):
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("injected step failure")
            return orig(*a, **k)

        b._step = poisoned
        f = b.submit(PROMPTS[3], max_new_tokens=4, eos_token_id=None)
        with pytest.raises(RuntimeError, match="injected"):
            f.result(timeout=TIMEOUT)
        b._step = orig
        assert all(float(kv.k.abs().sum()) == 0.0 for kv in b._kvs)  # zeroed in place
        np.testing.assert_array_equal(
            b.submit(PROMPTS[3], max_new_tokens=5, eos_token_id=None).result(timeout=TIMEOUT),
            want(PROMPTS[3], 5))
        assert [t.data_ptr() for t in (b._ck, b._cv, b._mask)] + [
            t.data_ptr() for kv in b._kvs for t in (kv.k, kv.v)] == ptrs
        st = b.graph_stats()
        assert st["captures"] == 1 and st["recaptures"] == 0
    finally:
        b.shutdown()


def test_switch_capacity_drops_per_row():
    """Switch at expert capacity 2: the encoder drops tokens. Capacity is a
    per-row prefix count, so a join's right-padded encode drops what the
    isolated unpadded one drops, and idle slots displace nothing."""
    spec = dict(SWITCH, expert_capacity=2)
    jmodel, jparams, jtree, model, params, tree = _pair(
        JSwitchModel, JSwitchSpec, SwitchModel, SwitchSpec, spec, 7)
    want = _isolated(jmodel, jparams, jtree)
    b = Seq2SeqContinuousBatcher(model, params, tree, ResidentProvider.for_layer,
                                 max_batch_size=3, max_src_len=16, max_decode_len=16)
    try:
        futs = [b.submit(p, max_new_tokens=n, eos_token_id=None) for p, n in zip(PROMPTS, NEWS)]
        for p, n, f in zip(PROMPTS, NEWS, futs):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), want(p, n))
    finally:
        b.shutdown()


# ---- offload mode ------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(nllb, tmp_path_factory):
    return write_nllb_store(tmp_path_factory.mktemp("s2s_batch") / "f32", nllb[2]["layers"],
                            "float32", N_ENC, seed=3)


def _jax_batcher(nllb, path, slots, prefetch, threads):
    jmodel, jparams = nllb[:2]
    arena = JArena(JStore(path), slots, compute_dtype=jnp.float32, num_threads=threads)
    tracer = JTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    eng = JEngine(jmodel, jparams, arena, tracer=tracer, predictor=JPredictor(tracer),
                  prefetch=prefetch, speculative=True)
    return JBatcher(jmodel, jparams, None, None, engine=eng, max_batch_size=2, max_src_len=16,
                    max_decode_len=16, idle_sleep_s=0.05)


def _port_batcher(nllb, path, slots, prefetch, threads, backend=None):
    model, params = nllb[3:5]
    arena = ExpertArena(ExpertStore(path), slots, compute_dtype=torch.float32, device="cpu",
                        num_threads=threads)
    tracer = ExpertTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    eng = Seq2SeqOffloadEngine(model, params, arena, tracer=tracer,
                               predictor=ExpertPredictor(tracer), prefetch=prefetch,
                               speculative=True, graph_backend=backend)
    return Seq2SeqContinuousBatcher(model, params, None, None, engine=eng, max_batch_size=2,
                                    max_src_len=16, max_decode_len=16, idle_sleep_s=0.05)


def _resident_want(nllb, path):
    model, params = nllb[3:5]
    provider = ResidentProvider.from_store(ExpertStore(path), dtype=torch.float32, device="cpu")
    gen = Seq2SeqGenerator(model, params, provider.pytree(), ResidentProvider.for_layer)
    return lambda p, n: gen.generate(p[None], max_new_tokens=n,
                                     eos_token_id=None).sequences[0]


@pytest.mark.parametrize("prefetch", [False, True])
def test_offload_batcher_matches_jax_and_resident(nllb, store, prefetch):
    """6 of the 16 experts in slots: a step's union fits, residency churns.
    Four requests into two slots, queued together: two join mid-flight."""
    threads = 2 if prefetch else 1
    reqs = [(p, dict(max_new_tokens=n, eos_token_id=None)) for p, n in zip(PROMPTS, NEWS)]
    jb = _jax_batcher(nllb, store, 6, prefetch, threads)
    b = _port_batcher(nllb, store, 6, prefetch, threads)
    resident = _resident_want(nllb, store)
    try:
        jgot = [f.result(timeout=TIMEOUT) for f in queue_together(jb, reqs)]
        with port_attention("naive"):
            got = [f.result(timeout=TIMEOUT) for f in queue_together(b, reqs)]
            for (p, kw), g, jg in zip(reqs, got, jgot):
                np.testing.assert_array_equal(g, jg)
                np.testing.assert_array_equal(g, resident(p, kw["max_new_tokens"]))
        assert b.replay_counts and b.step_stats()["joins"] == 4
        s = b.stats()
        assert s["speculative_steps"] == len(b.replay_counts) and s["visits"] > 0
        assert not b.engine.tracer.trace  # every entry finished into the collection
        if not prefetch:
            # one worker, no prefetch: the same order of events as the JAX batcher
            assert b.replay_counts == jb.replay_counts
            assert s == jb.stats()
    finally:
        jb.shutdown()
        b.shutdown()
        jb.engine.arena.shutdown()
        b.engine.arena.shutdown()


def test_offload_batcher_graphs(nllb, store):
    """With the engine's graphs every execution of the shared step is a
    replay of one graph in the engine's cache, the tokens unchanged."""
    reqs = [(p, dict(max_new_tokens=n, eos_token_id=None)) for p, n in zip(PROMPTS, NEWS)]
    resident = _resident_want(nllb, store)
    b = _port_batcher(nllb, store, 6, False, 1, backend=StandIn())
    try:
        with port_attention("naive"):
            got = [f.result(timeout=TIMEOUT) for f in queue_together(b, reqs)]
            for (p, kw), g in zip(reqs, got):
                np.testing.assert_array_equal(g, resident(p, kw["max_new_tokens"]))
        st = b.graph_stats()
        assert st["captures"] == 1 and st["recaptures"] == 0
        assert st["replays"] == sum(b.replay_counts)
    finally:
        b.shutdown()
        b.engine.arena.shutdown()


def test_offload_batcher_survives_step_failure(nllb, store):
    """A failed step fails the active futures and finishes their tracer
    entries; the next request is served exactly."""
    resident = _resident_want(nllb, store)
    b = _port_batcher(nllb, store, 6, True, 2)
    orig = b._step
    state = {"armed": True}

    def poisoned(*a, **k):
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected step failure")
        return orig(*a, **k)

    b._step = poisoned
    try:
        f = b.submit(PROMPTS[0], max_new_tokens=4, eos_token_id=None)
        with pytest.raises(RuntimeError, match="injected"):
            f.result(timeout=TIMEOUT)
        assert not b.engine.tracer.trace
        b._step = orig
        with port_attention("naive"):
            got = b.submit(PROMPTS[1], max_new_tokens=5, eos_token_id=None).result(TIMEOUT)
        np.testing.assert_array_equal(got, resident(PROMPTS[1], 5))
    finally:
        b.shutdown()
        b.engine.arena.shutdown()


def test_offload_batcher_survives_join_failure(nllb, store):
    """A join whose encode raises fails only its request, and its tracer
    entry is finished before the future raises: a done-callback, which runs
    where the exception is set, finds the trace empty. The next request is
    served exactly."""
    resident = _resident_want(nllb, store)
    b = _port_batcher(nllb, store, 6, False, 1)
    orig = b.engine.run_encoder
    seen = []

    def poisoned(*a, **k):
        b.engine.run_encoder = orig
        raise RuntimeError("injected encode failure")

    b.engine.run_encoder = poisoned
    try:
        f = b.submit(PROMPTS[0], max_new_tokens=4, eos_token_id=None)
        f.add_done_callback(lambda _f: seen.append(len(b.engine.tracer.trace)))
        with pytest.raises(RuntimeError, match="injected encode"):
            f.result(timeout=TIMEOUT)
        assert seen == [0] and b.joins == 0
        with port_attention("naive"):
            got = b.submit(PROMPTS[1], max_new_tokens=5, eos_token_id=None).result(TIMEOUT)
        np.testing.assert_array_equal(got, resident(PROMPTS[1], 5))
    finally:
        b.shutdown()
        b.engine.arena.shutdown()


def test_offload_batcher_needs_a_layer_of_slots(nllb, store):
    model, params = nllb[3:5]
    arena = ExpertArena(ExpertStore(store), E, compute_dtype=torch.float32, device="cpu",
                        num_threads=1)
    try:
        eng = Seq2SeqOffloadEngine(model, params, arena, speculative=True)
        arena.num_slots = E - 1  # a smaller arena than the engine was built on
        with pytest.raises(ValueError, match="full MoE layer"):
            Seq2SeqContinuousBatcher(model, params, None, None, engine=eng)
    finally:
        arena.shutdown()


# ---- which grouped FFN a graph on the card can capture ------------------------------

class _CardBackend(CudaGraphBackend):
    """The card's capture backend as the graph users see it, without the
    stream and pool (no card here): the refusal must come before either."""

    def __init__(self):
        pass


def test_graph_cache_refuses_ragged_on_the_card():
    for impl in ("ragged", "pallas", "gather", "dense"):
        assert graph_cache(False, None, "cuda", impl) is None
        assert graph_cache(True, None, "cpu", impl) is None  # the CPU runs eagerly
        assert graph_cache(True, StandIn(), "cpu", impl) is not None  # a stand-in takes any
    with pytest.raises(ValueError, match="cannot run inside a CUDA graph"):
        graph_cache(True, None, "cuda", "ragged")
    with pytest.raises(ValueError, match="graphs=False"):
        graph_cache(True, _CardBackend(), "cpu", "ragged")


@pytest.mark.parametrize("user", ["batcher", "generator", "offload engine"])
def test_graph_users_refuse_ragged_on_the_card(nllb, store, user):
    """Built at their defaults ("ragged", graphs on) over the card's capture
    backend, the graph users refuse at construction; ``graphs=False`` or a
    capturable impl builds."""
    model, params, tree = nllb[3], nllb[4], nllb[5]
    arena = ExpertArena(ExpertStore(store), 6, compute_dtype=torch.float32, device="cpu",
                        num_threads=1)

    def build(**kw):
        if user == "batcher":
            return Seq2SeqContinuousBatcher(model, params, tree, ResidentProvider.for_layer,
                                            max_batch_size=2, max_src_len=16,
                                            max_decode_len=16, **kw)
        if user == "generator":
            return Seq2SeqGenerator(model, params, tree, ResidentProvider.for_layer, **kw)
        return Seq2SeqOffloadEngine(model, params, arena, speculative=True, **kw)

    try:
        with pytest.raises(ValueError, match="'ragged'.*cannot run inside a CUDA graph"):
            build(graph_backend=_CardBackend())
        eager = build(graph_backend=_CardBackend(), graphs=False)
        assert eager.graphs is None
        if user == "batcher":
            eager.shutdown()
    finally:
        arena.shutdown()
