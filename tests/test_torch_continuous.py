"""The port's ContinuousBatcher and Generator against the JAX package's
Generator: a tiny Mixtral (the spec of tests/test_continuous.py) at f32 on
the CPU, weights made once by the JAX model's init_random and carried over
by the bridge. Greedy tokens must be equal, token for token. Requests join
mid-decode deterministically: the second is submitted from the first's
on_token callback, so it is seated while the first decodes. The query and
key projections are scaled up (x40, in both packages) so that attention is
sharp: with init_random's std-0.02 weights it is near uniform, and RoPE
fed the shared columns instead of each row's positions would go unseen.
The last section serves a tiny DeepSeek-V2 (MLA caches, K5's plain version)
through the same batcher, held to the JAX Generator in the same way."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.runtime.continuous import ContinuousBatcher, RequestSampling
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore

from torch_port_helpers import to_port, one_intra_op_thread  # noqa: F401
from torch_port_helpers import queue_together, write_decoder_store
from torch_decoder_family import Family

TINY = dict(
    vocab_size=128, hidden_size=48, intermediate_size=96, num_layers=2,
    num_heads=6, num_kv_heads=2, head_dim=8, num_experts=4, top_k=2,
    rms_eps=1e-6, rope_theta=1e4, tie_embeddings=False,
)
TIMEOUT = 60


@pytest.fixture(scope="module")
def models():
    jmodel = JMixtralModel(JMixtralSpec(**TINY), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(4))
    for layer in jparams["layers"]:
        layer["q"], layer["k"] = layer["q"] * 40.0, layer["k"] * 40.0
    jgen = JGenerator(jmodel, jparams, jtree, JProvider.for_layer, max_seq_len=64)
    model = MixtralModel(MixtralSpec(**TINY), compute_dtype=torch.float32, device="cpu")
    cache = {}

    def want(prompt, n):
        """The JAX Generator's isolated greedy run (memoised)."""
        key = (tuple(int(t) for t in prompt), n)
        if key not in cache:
            cache[key] = jgen.generate(np.asarray(prompt)[None], max_new_tokens=n).sequences[0]
        return cache[key]

    return model, to_port(jparams), to_port(jtree), want, jgen


def _batcher(models, **kw):
    model, params, tree = models[:3]
    cfg = dict(max_batch_size=3, page_size=8, num_pages=48, max_cols=96)
    cfg.update(kw)
    return ContinuousBatcher(model, params, tree, ResidentProvider.for_layer, **cfg)


@pytest.fixture(scope="module", params=[1, 4], ids=["chunk1", "chunk4"])
def batcher(request, models):
    b = _batcher(models, prefill_chunk=request.param,
                 **({"num_pages": 64, "max_cols": 128} if request.param > 1 else {}))
    yield b
    b.shutdown()


def _join_after(batcher, n_tokens, prompt, **kw):
    """on_token callback that submits `prompt` once the first request has
    generated n_tokens; returns (callback, holder of the second future)."""
    holder, seen = {}, []
    ready = threading.Event()

    def on_token(tok):
        seen.append(tok)
        if len(seen) == n_tokens:
            holder["f"] = batcher.submit(prompt, **kw)
            ready.set()

    return on_token, holder, ready


def test_staggered_requests_match_isolated(batcher, models):
    want = models[3]
    p1, p2 = np.array([5, 31, 8]), np.array([9, 3, 44, 6, 21, 2, 17, 8, 4, 11])
    cb, holder, ready = _join_after(batcher, 2, p2, max_new_tokens=6)
    f1 = batcher.submit(p1, max_new_tokens=10, on_token=cb)
    np.testing.assert_array_equal(f1.result(timeout=TIMEOUT), want(p1, 10))
    assert ready.wait(TIMEOUT)
    np.testing.assert_array_equal(holder["f"].result(timeout=TIMEOUT), want(p2, 6))


def test_three_way_staggered(batcher, models):
    want = models[3]
    prompts = [np.array([7, 11, 13, 17, 19, 23]), np.array([29, 31, 37]),
               np.array([41, 43, 47, 53, 59, 61, 67, 71])]
    cb2, h2, r2 = _join_after(batcher, 1, prompts[2], max_new_tokens=5)
    cb1, h1, r1 = _join_after(batcher, 1, prompts[1], max_new_tokens=5, on_token=cb2)
    f0 = batcher.submit(prompts[0], max_new_tokens=5, on_token=cb1)
    np.testing.assert_array_equal(f0.result(timeout=TIMEOUT), want(prompts[0], 5))
    assert r1.wait(TIMEOUT) and r2.wait(TIMEOUT)
    np.testing.assert_array_equal(h1["f"].result(timeout=TIMEOUT), want(prompts[1], 5))
    np.testing.assert_array_equal(h2["f"].result(timeout=TIMEOUT), want(prompts[2], 5))


def test_slot_reuse_after_completion(batcher, models):
    """Five requests through three slots: two wait and take freed slots."""
    want = models[3]
    prompts = [np.array([7, 11]), np.array([13, 17, 19]), np.array([23]),
               np.array([29, 31]), np.array([37])]
    futures = [batcher.submit(p, max_new_tokens=5) for p in prompts]
    for p, f in zip(prompts, futures):
        np.testing.assert_array_equal(f.result(timeout=TIMEOUT), want(p, 5))


def test_eos_frees_slot_early(batcher, models):
    want = models[3]
    p = np.array([5, 31, 8])
    ref = want(p, 8)
    eos = int(ref[5])  # stop at the 3rd generated token
    got = batcher.submit(p, max_new_tokens=8, eos_token_id=eos).result(TIMEOUT)
    np.testing.assert_array_equal(got, ref[:np.where(ref[3:] == eos)[0][0] + 4])


def test_step_stats_count_widths(models):
    b = _batcher(models, prefill_chunk=4, num_pages=64, max_cols=128)
    try:
        b.submit(np.array([5, 31, 8, 77, 12, 9, 3]), max_new_tokens=3).result(TIMEOUT)
        st = b.step_stats()
    finally:
        b.shutdown()
    # 7 prompt tokens: chunks of 4 and 3 (the second yields token 1), then 2 steps
    assert st[4]["steps"] == 2 and st[1]["steps"] == 2
    assert all(v["ms_per_step"] > 0 for v in st.values())


def test_failing_step_fails_futures_and_serving_continues(models):
    """A step that raises lands in every active future; the scheduler
    thread rebuilds the pools and serves the next request exactly
    (mirrors tests/test_continuous.py:405)."""
    want = models[3]
    b = _batcher(models)
    orig = b._forward
    state = {"armed": True}

    def poisoned(*a, **k):
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected step failure")
        return orig(*a, **k)

    b._forward = poisoned
    try:
        f = b.submit(np.array([5, 31, 8]), max_new_tokens=4)
        with pytest.raises(RuntimeError, match="injected"):
            f.result(timeout=TIMEOUT)
        p = np.array([7, 11, 13])
        np.testing.assert_array_equal(
            b.submit(p, max_new_tokens=5).result(timeout=TIMEOUT), want(p, 5))
        assert b._thread.is_alive()
    finally:
        b.shutdown()
    assert not b._thread.is_alive()


def test_generator_matches_jax(models):
    model, params, tree, _, jgen = models
    prompt = np.array([[5, 31, 8, 77], [9, 3, 44, 6]])
    want = jgen.generate(
        prompt, max_new_tokens=6, eos_token_id=int(prompt[0, 0]), collect_trace=True)
    got = Generator(model, params, tree, ResidentProvider.for_layer, max_seq_len=64).generate(
        prompt, max_new_tokens=6, eos_token_id=int(prompt[0, 0]), collect_trace=True)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    assert len(got.router_trace) == len(want.router_trace)
    for (ids, _), (jids, _) in zip(got.router_trace, want.router_trace):
        np.testing.assert_array_equal(ids, jids)


def test_unported_options_raise(models, tmp_path):
    model, params, tree = models[:3]
    # offload mode needs one MoE layer's experts in slots (the arena mode
    # itself is held to the JAX batcher in TestOffloadSpeculativeBatcher)
    store = write_decoder_store(tmp_path / "store", [
        {r: tree["layers"][0][r].numpy() for r in ("gate", "up", "down")}], "mixtral")
    arena = ExpertArena(ExpertStore(store), TINY["num_experts"] - 1,
                        compute_dtype=torch.float32, device="cpu", num_threads=1)
    try:
        with pytest.raises(ValueError, match="full MoE layer"):
            ContinuousBatcher(model, params, None, None, arena=arena)
    finally:
        arena.shutdown()
    with pytest.raises(ValueError, match="multiple"):
        ContinuousBatcher(model, params, tree, ResidentProvider.for_layer,
                          page_size=8, max_cols=90)
    b = _batcher(models)
    try:
        # sampled, penalised and biased requests are served
        # (tests/test_torch_sampling.py holds them to the JAX package)
        for kw in (dict(temperature=0.7), dict(sampling=RequestSampling(repetition_penalty=1.2)),
                   dict(logit_bias={3: 100.0})):
            out = b.submit(np.array([1, 2]), max_new_tokens=2, **kw).result(TIMEOUT)
            assert out.shape == (4,)
        assert (out[2:] == 3).all()
        # greedy settings pass (temperature 0 with top_k is still argmax)
        b.submit(np.array([1, 2]), max_new_tokens=1, top_k=5, do_sample=False).result(TIMEOUT)
    finally:
        b.shutdown()
    gen = Generator(model, params, tree, ResidentProvider.for_layer)
    assert gen.generate(np.array([[1, 2]]), max_new_tokens=2,
                        temperature=0.5).sequences.shape == (1, 4)
    # decode_scan is served (tests/test_torch_decode_scan.py holds it to the
    # JAX package): after a prefill, its greedy tokens are generate's
    greedy = gen.generate(np.array([[1, 2]]), max_new_tokens=3).sequences
    st = gen.stepper
    kv = st.init_cache(1, 8)
    logits, kv, _ = st.forward(torch.tensor([[1, 2]], dtype=torch.int32),
                               torch.arange(2, dtype=torch.int32)[None], kv, 0)
    tok0 = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks, _ = st.decode_scan(tok0, torch.tensor([2], dtype=torch.int32), kv, 2)
    np.testing.assert_array_equal(toks.numpy(), greedy[:, 3:])


# ---- DeepSeek-V2 (MLA) through the same batcher -----------------------------------
# The pools take the model's asymmetric cache slots (latent R wide, rope key
# P wide); a one-token step hands the gathered view to K5's plain version.
# The q and kv_a projections are scaled x40 in both packages: kv_a's rope-key
# rows then give sharp position-dependent scores (its latent rows are
# RMS-normed, so their scale drops out).

DS_TINY = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=48, num_layers=2, num_heads=4,
    q_lora_rank=None, kv_lora_rank=128, qk_nope_head_dim=32,
    qk_rope_head_dim=16, v_head_dim=32, num_experts=8, top_k=2,
    n_shared_experts=1, first_k_dense_replace=1, topk_method="greedy",
    n_group=None, topk_group=None, routed_scaling_factor=1.0,
    rms_eps=1e-6, rope_theta=10000.0, tie_embeddings=False,
)  # the spec of tests/test_continuous.py:75-83 with a latent of 128: at its 32 the
# port's model, as JAX's, takes the einsum (K5 takes R % 128 == 0)


@pytest.fixture(scope="module")
def ds_models():
    from moe_infinity_tpu.models.deepseek_v2 import DeepseekV2ModelJax
    from moe_infinity_tpu.models.deepseek_v2 import DeepseekV2Spec as JSpec
    from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec

    jmodel = DeepseekV2ModelJax(JSpec(**DS_TINY), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(6))
    for layer in jparams["layers"]:
        layer["q"], layer["kv_a"] = layer["q"] * 40.0, layer["kv_a"] * 40.0
    jgen = JGenerator(jmodel, jparams, jtree, JProvider.for_layer, max_seq_len=64)
    model = DeepseekV2Model(DeepseekV2Spec(**DS_TINY), compute_dtype=torch.float32, device="cpu")
    cache = {}

    def want(prompt, n):
        key = (tuple(int(t) for t in prompt), n)
        if key not in cache:
            cache[key] = jgen.generate(np.asarray(prompt)[None], max_new_tokens=n).sequences[0]
        return cache[key]

    return model, to_port(jparams), to_port(jtree), want, jgen


@pytest.fixture(scope="module", params=[1, 4], ids=["chunk1", "chunk4"])
def ds_batcher(request, ds_models):
    model, params, tree = ds_models[:3]
    b = ContinuousBatcher(model, params, tree, ResidentProvider.for_layer, max_batch_size=3,
                          page_size=8, num_pages=64, max_cols=128, prefill_chunk=request.param)
    yield b
    b.shutdown()


def test_deepseek_pools_take_the_asymmetric_cache(ds_batcher):
    for pk, pv in ds_batcher._pools:
        assert tuple(pk.shape) == (64, 8, 1, DS_TINY["kv_lora_rank"])
        assert tuple(pv.shape) == (64, 8, 1, 16)


def test_deepseek_staggered_requests_match_jax(ds_batcher, ds_models):
    want = ds_models[3]
    p1, p2 = np.array([5, 31, 8]), np.array([9, 3, 44, 6, 21, 2, 17, 8, 4, 11])
    cb, holder, ready = _join_after(ds_batcher, 2, p2, max_new_tokens=6)
    f1 = ds_batcher.submit(p1, max_new_tokens=10, on_token=cb)
    np.testing.assert_array_equal(f1.result(timeout=TIMEOUT), want(p1, 10))
    assert ready.wait(TIMEOUT)
    np.testing.assert_array_equal(holder["f"].result(timeout=TIMEOUT), want(p2, 6))


def test_deepseek_three_way_staggered_match_jax(ds_batcher, ds_models):
    want = ds_models[3]
    prompts = [np.array([7, 11, 13, 17, 19, 23]), np.array([29, 31, 37]),
               np.array([41, 43, 47, 53, 59, 61, 67, 71])]
    cb2, h2, r2 = _join_after(ds_batcher, 1, prompts[2], max_new_tokens=5)
    cb1, h1, r1 = _join_after(ds_batcher, 1, prompts[1], max_new_tokens=5, on_token=cb2)
    f0 = ds_batcher.submit(prompts[0], max_new_tokens=5, on_token=cb1)
    np.testing.assert_array_equal(f0.result(timeout=TIMEOUT), want(prompts[0], 5))
    assert r1.wait(TIMEOUT) and r2.wait(TIMEOUT)
    np.testing.assert_array_equal(h1["f"].result(timeout=TIMEOUT), want(prompts[1], 5))
    np.testing.assert_array_equal(h2["f"].result(timeout=TIMEOUT), want(prompts[2], 5))


def test_deepseek_slot_reuse_match_jax(ds_batcher, ds_models):
    want = ds_models[3]
    prompts = [np.array([7, 11]), np.array([13, 17, 19]), np.array([23]),
               np.array([29, 31]), np.array([37])]
    futures = [ds_batcher.submit(p, max_new_tokens=5) for p in prompts]
    for p, f in zip(prompts, futures):
        np.testing.assert_array_equal(f.result(timeout=TIMEOUT), want(p, 5))


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_deepseek_generator_matches_jax(ds_models, attn):
    from torch_port_helpers import port_attention

    model, params, tree, _, jgen = ds_models
    prompt = np.array([[5, 31, 8, 77], [9, 3, 44, 6]])
    want = jgen.generate(prompt, max_new_tokens=6, collect_trace=True)
    with port_attention(attn):
        got = Generator(model, params, tree, ResidentProvider.for_layer, max_seq_len=64).generate(
            prompt, max_new_tokens=6, collect_trace=True)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    for (ids, _), (jids, _) in zip(got.router_trace, want.router_trace):
        np.testing.assert_array_equal(ids, jids)


# ---- offload mode: the batcher over an ExpertArena ----------------------------
# Mirrors tests/test_continuous.py::TestOffloadSpeculativeBatcher: every shared
# step is one speculative execution over the arena's slots, verified on the
# live columns and run again after loading the misses. A Mixtral of 8 experts
# (stores from the JAX init_random weights, attention sharpened x40 in both
# packages) in 13 slots of 16: a step's union (at most 3 rows x 2 x 2 layers)
# fits, residency churns between steps. Tokens are held to the JAX
# Generator's isolated runs; with prefetch off and one fetch worker, the
# executions and the arena's counters to the JAX batcher's on the same
# requests, queued together.

TINY8 = dict(TINY, num_experts=8)
OFF_SLOTS = 13


def _arena_batcher(family, *, prefetch=True, threads=2, jax=False, slots=OFF_SLOTS, **kw):
    """The port's (or with ``jax`` the JAX package's) batcher in offload mode
    over ``family``'s f32 store."""
    cfg = dict(max_batch_size=3, page_size=8, num_pages=48, max_cols=96)
    cfg.update(kw)
    path = family.stores["float32"]
    n = ExpertStore(path).num_layers
    if jax:
        from moe_infinity_tpu.memory import ExpertPredictor as JPredictor
        from moe_infinity_tpu.memory import ExpertTracer as JTracer
        from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
        from moe_infinity_tpu.runtime.continuous import ContinuousBatcher as JBatcher
        from moe_infinity_tpu.store.blob import ExpertStore as JStore

        arena = JArena(JStore(path), slots, compute_dtype=jnp.float32, num_threads=threads)
        tracer = JTracer(64, n, family.E)
        return JBatcher(family.jmodel, family.jparams, None, None, arena=arena, tracer=tracer,
                        predictor=JPredictor(tracer), prefetch=prefetch, **cfg)
    from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer

    arena = ExpertArena(ExpertStore(path), slots, compute_dtype=torch.float32, device="cpu",
                        num_threads=threads)
    tracer = ExpertTracer(64, n, family.E)
    return ContinuousBatcher(family.model, family.params, None, None, arena=arena,
                             tracer=tracer, predictor=ExpertPredictor(tracer), prefetch=prefetch,
                             **cfg)


def _stop(batcher):
    batcher.shutdown()
    batcher.arena.shutdown()


class TestOffloadSpeculativeBatcher:
    @pytest.fixture(scope="class")
    def family(self, tmp_path_factory):
        fam = Family("mixtral", JMixtralModel(JMixtralSpec(**TINY8), compute_dtype=jnp.float32),
                     MixtralModel(MixtralSpec(**TINY8), compute_dtype=torch.float32,
                                  device="cpu"),
                     11, tmp_path_factory.mktemp("cbo"))
        jgen = JGenerator(fam.jmodel, fam.jparams, fam.jtree, JProvider.for_layer, max_seq_len=64)
        cache = {}

        def want(prompt, n):
            key = (tuple(int(t) for t in prompt), n)
            if key not in cache:
                cache[key] = jgen.generate(np.asarray(prompt)[None],
                                           max_new_tokens=n).sequences[0]
            return cache[key]

        fam.want = want
        return fam

    @pytest.fixture(scope="class")
    def batcher(self, family):
        b = _arena_batcher(family)
        yield b
        _stop(b)

    def test_staggered_offload_matches_resident(self, family, batcher):
        p1, p2 = np.array([5, 31, 8]), np.array([9, 3, 44, 6])
        cb, holder, ready = _join_after(batcher, 2, p2, max_new_tokens=6)
        f1 = batcher.submit(p1, max_new_tokens=8, on_token=cb)
        np.testing.assert_array_equal(f1.result(timeout=TIMEOUT), family.want(p1, 8))
        assert ready.wait(TIMEOUT)
        np.testing.assert_array_equal(holder["f"].result(timeout=TIMEOUT), family.want(p2, 6))
        assert batcher.replay_counts, "speculative path not exercised"
        assert batcher.stats()["speculative_steps"] == len(batcher.replay_counts)

    def test_offload_batcher_slot_reuse(self, family, batcher):
        prompts = [np.array([7, 11]), np.array([13, 17, 19]), np.array([23]),
                   np.array([29, 31]), np.array([37])]
        futures = [batcher.submit(p, max_new_tokens=5) for p in prompts]
        for p, f in zip(prompts, futures):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), family.want(p, 5))

    def test_offload_batcher_survives_step_failure(self, family, batcher):
        """A failed step fails the active futures and finishes their tracer
        entries; the thread rebuilds the pools and serves on exactly."""
        orig = batcher._forward
        state = {"armed": True}

        def poisoned(*a, **k):
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("injected step failure")
            return orig(*a, **k)

        batcher._forward = poisoned
        try:
            f = batcher.submit(np.array([5, 31]), max_new_tokens=4)
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=TIMEOUT)
        finally:
            batcher._forward = orig
        assert not batcher.tracer.trace
        p = np.array([9, 3, 44])
        np.testing.assert_array_equal(batcher.submit(p, max_new_tokens=5).result(timeout=TIMEOUT),
                                      family.want(p, 5))

    @pytest.mark.parametrize("chunk,slots", [(1, OFF_SLOTS), (4, 16)])
    def test_counters_equal_jax_batcher(self, family, chunk, slots):
        """Four requests into three slots, queued together; prefetch off and
        one worker: tokens, executions per step and counters equal the JAX
        batcher's. A 4-wide chunk step can route every expert of both
        layers, so it takes an arena of all 16 (filled from empty)."""
        reqs = [(np.array([5, 31, 8, 77, 12]), dict(max_new_tokens=6)),
                (np.array([9, 3]), dict(max_new_tokens=7)),
                (np.array([41, 43, 47, 53, 59, 61]), dict(max_new_tokens=4)),
                (np.array([7, 11, 13]), dict(max_new_tokens=5))]
        kw = dict(prefetch=False, threads=1, prefill_chunk=chunk, idle_sleep_s=0.05, slots=slots)
        jb = _arena_batcher(family, jax=True, **kw)
        b = _arena_batcher(family, **kw)
        try:
            jgot = [f.result(timeout=TIMEOUT) for f in queue_together(jb, reqs)]
            got = [f.result(timeout=TIMEOUT) for f in queue_together(b, reqs)]
            for (p, r), g, jg in zip(reqs, got, jgot):
                np.testing.assert_array_equal(g, jg)
                np.testing.assert_array_equal(g, family.want(p, r["max_new_tokens"]))
            assert b.replay_counts == jb.replay_counts
            assert b.stats() == jb.stats()
            assert max(b.replay_counts) > 1  # some step ran again after its misses
        finally:
            _stop(jb)
            _stop(b)


def test_deepseek_offload_batcher_matches_jax(ds_models, tmp_path):
    """DeepSeek-V2 (a dense first layer, MLA caches through K5's plain
    version) in offload mode: only the MoE layer's routing is verified."""
    from moe_infinity_tpu.models.deepseek_v2 import DeepseekV2ModelJax
    from moe_infinity_tpu.models.deepseek_v2 import DeepseekV2Spec as JSpec
    from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer

    model, params, _, want, _ = ds_models
    _, jtree = DeepseekV2ModelJax(JSpec(**DS_TINY), compute_dtype=jnp.float32).init_random(
        jax.random.PRNGKey(6))
    path = write_decoder_store(tmp_path / "ds", jtree["layers"], "deepseek")
    arena = ExpertArena(ExpertStore(path), 8, compute_dtype=torch.float32, device="cpu",
                        num_threads=2)
    tracer = ExpertTracer(16, ExpertStore(path).num_layers, DS_TINY["num_experts"])
    b = ContinuousBatcher(model, params, None, None, arena=arena, tracer=tracer,
                          predictor=ExpertPredictor(tracer), max_batch_size=3, page_size=8,
                          num_pages=64, max_cols=128)
    try:
        prompts = [np.array([7, 11, 13]), np.array([29, 31, 37, 41]), np.array([23]),
                   np.array([5, 9])]
        futures = [b.submit(p, max_new_tokens=5) for p in prompts]
        for p, f in zip(prompts, futures):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), want(p, 5))
        assert b.replay_counts and b.stats()["visits"] > 0
    finally:
        _stop(b)
