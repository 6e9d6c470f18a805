"""The port's DeepSeek-V2 slice against the JAX package on the same numpy
inputs: interleaved RoPE, the three routers (with constructed ties), the
whole model's logits over contiguous, left-padded and paged caches (einsum
attention and K5's plain version), MLA weight folding, the shared experts in
the pool, the stacked pool and the fused runner. Weights come from the JAX
model's init_random through the bridge, f32 on the CPU, TF32 off.
Tolerances: 1e-6 on router weights, 1e-5 on folded leaves, 2e-4 (rtol =
atol) on logits, as tests/test_fused.py and tests/test_fold_fuse.py hold the
JAX paths to each other; greedy tokens are equal."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models import deepseek_v2 as jds
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.paged_kv import PagedKVCache as JPagedKVCache
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch import bridge
from moe_infinity_tpu_torch.models import deepseek_v2 as ds
from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
from moe_infinity_tpu_torch.ops import flash_attention as fa
from moe_infinity_tpu_torch.runtime.fused import FusedRunner
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.paged_kv import PagedKVCache
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from moe_infinity_tpu_torch.parallel import mesh as pm
from torch_port_helpers import (
    ThreadMesh,
    jax_to_numpy,
    np32,
    one_intra_op_thread,
    port_attention,
    run_ranks,
    to_port,
)

# the tiny spec of tests/test_fused.py:14-22
TINY = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=128, num_layers=3, num_heads=4,
    q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=32,
    qk_rope_head_dim=16, v_head_dim=32, num_experts=8, top_k=2,
    n_shared_experts=1, first_k_dense_replace=1, topk_method="greedy",
    n_group=None, topk_group=None, routed_scaling_factor=1.0,
    rms_eps=1e-6, rope_theta=10000.0, tie_embeddings=False,
)
TOL = 2e-4
PROMPT = np.array([[5, 31, 8, 77, 12], [9, 3, 44, 6, 21]])


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _pair(seed=5, **over):
    """(JAX model, its params and expert tree, the port's model, the same
    params and tree carried over the bridge), f32."""
    kw = dict(TINY, **over)
    jmodel = jds.DeepseekV2ModelJax(jds.DeepseekV2Spec(**kw), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(seed))
    model = DeepseekV2Model(DeepseekV2Spec(**kw), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, jtree, model, to_port(jparams), to_port(jtree)


@pytest.fixture(scope="module", params=[None, 24], ids=["q_full", "q_lora24"])
def models(request):
    return _pair(q_lora_rank=request.param)


@pytest.fixture(scope="module")
def base():
    return _pair()


# ---- RoPE ------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_interleaved_matches_jax(rng, theta):
    B, T, H, P = 2, 7, 3, 16
    jmodel = jds.DeepseekV2ModelJax(jds.DeepseekV2Spec(**dict(TINY, rope_theta=theta)), jnp.float32)
    model = DeepseekV2Model(DeepseekV2Spec(**dict(TINY, rope_theta=theta)), torch.float32, "cpu")
    pos = rng.integers(0, 500, size=(B, T)).astype(np.int32)
    jcos, jsin = jmodel._rope_tables(jnp.asarray(pos))
    cos, sin = model._rope_tables(torch.tensor(pos))
    assert tuple(cos.shape) == (B, T, P // 2)
    # the f32 rounding of an angle near 500 rad (ulp 3e-5) dominates
    np.testing.assert_allclose(np32(cos), np.asarray(jcos), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(sin), np.asarray(jsin), rtol=1e-4, atol=1e-4)
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    want = jds.rope_interleaved(jnp.asarray(x), jcos, jsin)
    got = ds.rope_interleaved(torch.tensor(x), torch.tensor(np.asarray(jcos)),
                              torch.tensor(np.asarray(jsin)))
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    bf = ds.rope_interleaved(torch.tensor(x).bfloat16(), cos, sin)
    assert bf.dtype == torch.bfloat16


# ---- routing ---------------------------------------------------------------------

ROUTERS = {
    "greedy": dict(),
    "greedy_scaled": dict(routed_scaling_factor=2.5, top_k=3),
    "group_limited": dict(topk_method="group_limited_greedy", n_group=4, topk_group=2),
    # one group of two experts kept, three picked: the third comes from the
    # masked scores, all exactly 0.0, and must be the lowest index
    "group_limited_zero_tie": dict(topk_method="group_limited_greedy", n_group=4,
                                   topk_group=1, top_k=3),
    "v3": dict(router_variant="v3", n_group=4, topk_group=2, routed_scaling_factor=2.5),
    "v3_norm": dict(router_variant="v3", n_group=4, topk_group=2, norm_topk_prob=True, top_k=3),
    # a negative bias makes every choice negative, so the masked zeros win
    "v3_zero_tie": dict(router_variant="v3", n_group=4, topk_group=1, top_k=3),
}


@pytest.mark.parametrize("name", list(ROUTERS))
@pytest.mark.parametrize("tie", [False, True], ids=["random", "tied_rows"])
def test_route_matches_jax(rng, name, tie):
    """ids exact, weights to 1e-6. tied_rows: router rows 2 and 5 (and 0 and
    1, one group) are equal, so their scores tie exactly in every token and
    the pick among them must be the lowest index, as jax.lax.top_k gives."""
    kw = dict(TINY, **ROUTERS[name])
    jmodel = jds.DeepseekV2ModelJax(jds.DeepseekV2Spec(**kw), jnp.float32)
    model = DeepseekV2Model(DeepseekV2Spec(**kw), torch.float32, "cpu")
    E, D = kw["num_experts"], kw["hidden_size"]
    router = rng.normal(size=(E, D)).astype(np.float32) * 0.3
    if tie:
        router[5] = router[2]
        router[1] = router[0]
    bias = rng.normal(size=(E,)).astype(np.float32) * 0.1
    if name == "v3_zero_tie":
        bias -= 3.0
    h = rng.normal(size=(2, 9, D)).astype(np.float32)
    jcw, jids = jmodel.route({"router": jnp.asarray(router), "router_bias": jnp.asarray(bias)},
                             jnp.asarray(h))
    cw, ids = model.route({"router": torch.tensor(router), "router_bias": torch.tensor(bias)},
                          torch.tensor(h))
    assert ids.dtype == torch.int32 and cw.dtype == torch.float32
    assert tuple(ids.shape) == (2, 9, kw["top_k"])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(cw.numpy(), np.asarray(jcw), rtol=1e-6, atol=1e-6)
    if name.endswith("zero_tie"):
        assert np.any(cw.numpy() == 0.0) or name.startswith("v3")


def test_top_k_lowest_first_on_constructed_ties():
    x = np.array([[0.0, 1.0, 1.0, 0.0, 1.0, -2.0], [0.0] * 6, [3.0, 3.0, -1.0, 3.0, 0.0, 0.0]],
                 np.float32)
    for k in (1, 2, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        v, i = ds.top_k_lowest_first(torch.tensor(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ---- the model -------------------------------------------------------------------

def _tj(a):
    a = np.asarray(a)
    return jnp.asarray(a if a.dtype == bool else a.astype(np.int32))


def _tt(a):
    a = np.asarray(a)
    return torch.tensor(a if a.dtype == bool else a.astype(np.int32))


def _run(model, params, tree, caches, steps, **kw):
    """Prefill PROMPT then `steps` one-token steps; every step's logits and
    the last router trace. The JAX forward runs under jit."""
    B, T = PROMPT.shape
    is_jax = isinstance(model, jds.DeepseekV2ModelJax)
    asarray = _tj if is_jax else _tt
    fwd = functools.partial(model.forward, impl="gather",
                            for_layer=(JProvider if is_jax else ResidentProvider).for_layer)
    if is_jax:
        fwd = jax.jit(fwd)
    out = []
    tok, pos, col = asarray(PROMPT), asarray(np.broadcast_to(np.arange(T), (B, T))), 0
    for _ in range(steps + 1):
        extra = {k: asarray(v[:, col:col + tok.shape[1]]) if k == "rope_positions" else asarray(v)
                 for k, v in kw.items()}
        logits, caches, trace = fwd(params, tree, tok, pos, caches, col, **extra)
        out.append(np.array(np32(logits) if isinstance(logits, torch.Tensor) else logits))
        col += tok.shape[1]
        tok = asarray(out[-1][:, -1].argmax(-1)[:, None])
        pos = asarray(np.full((B, 1), col))
    return out, trace


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX side of the three forward cases, run once per parameter set
    (on the CPU its attention is the einsum path)."""
    jmodel, jparams, jtree = models[:3]
    B, P, NP = 2, 4, 12
    S = P * 4
    rs = np.random.default_rng(11)
    table = np.stack([rs.permutation(np.arange(1, NP))[:P] for _ in range(B)]).astype(np.int32)
    rope = np.stack([np.arange(S), np.maximum(np.arange(S) - 2, 0)]).astype(np.int32)
    valid = np.ones((B, S), bool)
    valid[1, 5:7] = False  # hole columns of row 1
    spec = jmodel.spec
    shapes = ((NP, 4, 1, spec.kv_lora_rank), (NP, 4, 1, spec.qk_rope_head_dim))
    jk = [JPagedKVCache(jnp.zeros(shapes[0]), jnp.zeros(shapes[1]), jnp.asarray(table))
          for _ in range(spec.num_layers)]
    paged_kw = dict(rope_positions=rope, key_valid=valid)
    off = np.array([0, 2], np.int32)
    return dict(
        contiguous=_run(jmodel, jparams, jtree, jmodel.init_cache(2, 16), 3),
        pad=_run(jmodel, jparams, jtree, jmodel.init_cache(2, 16), 2, pad_offsets=off),
        paged=_run(jmodel, jparams, jtree, jk, 4, **paged_kw),
        table=table, shapes=shapes, paged_kw=paged_kw, off=off,
    )


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_forward_contiguous_matches_jax(models, jax_runs, attn):
    _, _, _, model, params, tree = models
    want, jtrace = jax_runs["contiguous"]
    with port_attention(attn):
        got, trace = _run(model, params, tree, model.init_cache(2, 16), 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert tuple(trace[0].shape) == (2, 2, 1, 2)  # [Lm, B, T, K]
    np.testing.assert_array_equal(trace[0].numpy(), np.asarray(jtrace[0]))
    np.testing.assert_allclose(trace[1].numpy(), np.asarray(jtrace[1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_forward_pad_offsets_matches_jax(models, jax_runs, attn):
    """Left padding: row 1's first two columns are pads. Pad queries occur
    only in the prefill, which is the einsum path in both packages, so every
    logit row is compared."""
    _, _, _, model, params, tree = models
    with port_attention(attn):
        got, _ = _run(model, params, tree, model.init_cache(2, 16), 2,
                      pad_offsets=jax_runs["off"])
    for g, w in zip(got, jax_runs["pad"][0]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_forward_paged_with_timeline_matches_jax(models, jax_runs, attn):
    """Paged pools of asymmetric width (latent R, rope key P) behind shuffled
    page tables, per-row rope_positions that lag the shared columns and a
    key_valid hole mask: the continuous batcher's step shapes. Under "flash"
    the one-token steps hand the gathered view to K5's plain version."""
    _, _, _, model, params, tree = models
    ks, vs = jax_runs["shapes"]
    tk = [PagedKVCache(torch.zeros(ks), torch.zeros(vs), torch.tensor(jax_runs["table"]))
          for _ in range(TINY["num_layers"])]
    with port_attention(attn):
        got, _ = _run(model, params, tree, tk, 4, **jax_runs["paged_kw"])
    for g, w in zip(got, jax_runs["paged"][0]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_flash_routes_one_token_steps_to_k5(base, monkeypatch):
    """Under "flash", at a latent width that is a multiple of 128, every
    layer of a one-token step calls mla_flash_decode once (3 layers: 1 dense
    + 2 MoE) and a T > 1 step never does; under "naive" no step does. At the
    tiny spec's latent width 32 no step does either: the JAX kernel declines
    such R and its model takes the einsum, and so does the port's."""
    _, _, _, model, params, tree = base
    wide = DeepseekV2Model(DeepseekV2Spec(**dict(TINY, kv_lora_rank=128)), torch.float32, "cpu")
    wparams, wtree = wide.init_random(torch.Generator().manual_seed(0))
    calls = []
    real = fa.mla_flash_decode

    def spy(q_lat, *a, **k):
        calls.append((tuple(q_lat.shape), k["scale"]))
        return real(q_lat, *a, **k)

    monkeypatch.setattr(fa, "mla_flash_decode", spy)
    with port_attention("flash"):
        _run(wide, wparams, wtree, wide.init_cache(2, 16), 0)
        assert calls == []
        _run(wide, wparams, wtree, wide.init_cache(2, 16), 1)
        assert calls == [((2, 4, 128), 48 ** -0.5)] * 3
        calls.clear()
        _run(model, params, tree, model.init_cache(2, 16), 1)
        assert calls == []
    with port_attention("naive"):
        _run(wide, wparams, wtree, wide.init_cache(2, 16), 1)
    assert calls == []


# ---- folding ----------------------------------------------------------------------

def test_fold_mla_params_matches_jax(models):
    jmodel, jparams, jtree, model, params, tree = models
    jfolded = jax_to_numpy(jmodel.fold_mla_params(jparams))
    folded = model.fold_mla_params(params)
    qkey = "q_fold" if model.spec.q_lora_rank is None else "q_b_fold"
    for pl, jpl in zip(folded["layers"], jfolded["layers"]):
        assert sorted(pl) == sorted(jpl) and "w_uk" not in pl and "o" not in pl
        for k in (qkey, "o_fold"):
            assert tuple(pl[k].shape) == jpl[k].shape
            np.testing.assert_allclose(np32(pl[k]), jpl[k], rtol=1e-5, atol=1e-5)
    assert "w_uk" in params["layers"][0]  # the input tree is left as it was


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_folded_forward_matches_unfolded_and_jax(models, jax_runs, attn):
    """Folded and unfolded agree to f32 re-association (2e-4, the JAX test's
    tolerance), one-token steps through K5 with scale 1.0 included."""
    _, _, _, model, params, tree = models
    folded = model.fold_mla_params(params)
    with port_attention(attn):
        got, _ = _run(model, folded, tree, model.init_cache(2, 16), 3)
    for g, w in zip(got, jax_runs["contiguous"][0]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_folded_bf16_stores_compute_dtype():
    model = DeepseekV2Model(DeepseekV2Spec(**TINY), torch.bfloat16, "cpu")
    params, _ = model.init_random(torch.Generator().manual_seed(0), with_experts=False)
    pl = model.fold_mla_params(params)["layers"][1]
    assert pl["q_fold"].dtype == pl["o_fold"].dtype == torch.bfloat16
    assert tuple(pl["q_fold"].shape) == (4 * (32 + 16), 64)
    assert tuple(pl["o_fold"].shape) == (64, 4, 32)


# ---- generation, the shared experts in the pool, the fused runner --------------------

@pytest.fixture(scope="module")
def jax_tokens(base):
    jmodel, jparams, jtree = base[:3]
    gen = JGenerator(jmodel, jparams, jtree, JProvider.for_layer, max_seq_len=32)
    return gen.generate(np.array([[5, 31, 8, 77]]), max_new_tokens=6, collect_trace=True)


@pytest.mark.parametrize("impl", ["ragged", "pallas", "gather", "dense"])
@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_generator_tokens_match_jax(base, jax_tokens, impl, attn):
    _, _, _, model, params, tree = base
    with port_attention(attn):
        got = Generator(model, params, tree, ResidentProvider.for_layer, impl=impl,
                        max_seq_len=32).generate(np.array([[5, 31, 8, 77]]), max_new_tokens=6,
                                                 collect_trace=True)
    np.testing.assert_array_equal(got.sequences, jax_tokens.sequences)
    for (ids, _), (jids, _) in zip(got.router_trace, jax_tokens.router_trace):
        np.testing.assert_array_equal(ids, jids)


def test_shared_in_pool_matches_default(base, jax_tokens):
    """Mirrors tests/test_fused.py:69: the pooled tree equals the JAX one leaf
    for leaf, and generation over it (impl="gather") gives the same tokens."""
    jmodel, jparams, jtree, model, params, tree = base
    jpooled_model = jds.DeepseekV2ModelJax(jmodel.spec, jnp.float32, shared_in_pool=True)
    want = jax_to_numpy(jpooled_model.pool_shared_experts(jtree["layers"], jparams))
    pooled_model = DeepseekV2Model(model.spec, torch.float32, "cpu", shared_in_pool=True)
    pooled = pooled_model.pool_shared_experts(tree["layers"], params)
    assert pooled["slot_map"].tolist() == list(range(9))
    for lt, jlt in zip(pooled["layers"], want["layers"]):
        assert sorted(lt) == sorted(jlt)
        for k in lt:
            np.testing.assert_array_equal(np32(lt[k]), jlt[k])
    for impl in ("gather", "pallas"):
        got = Generator(pooled_model, params, pooled, ResidentProvider.for_layer, impl=impl,
                        max_seq_len=32).generate(np.array([[5, 31, 8, 77]]), max_new_tokens=6)
        np.testing.assert_array_equal(got.sequences, jax_tokens.sequences)


def test_stacks_match_jax(base):
    jmodel, jparams, jtree, model, params, tree = base
    want = jax_to_numpy(jmodel.stack_moe_layers(jparams))
    got = model.stack_moe_layers(params)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np32(got[k]), want[k])
    jpool = jax_to_numpy(jmodel.stack_experts(jtree["layers"], layout="flat"))
    pool = model.stack_experts(tree["layers"], layout="flat")
    assert sorted(pool) == sorted(jpool)
    for k in pool:
        assert tuple(pool[k].shape)[0] == 2 * 8
        np.testing.assert_array_equal(np32(pool[k]), jpool[k])


@pytest.mark.parametrize("moe_impl", ["gmm", "gather"])
def test_fused_runner_matches_generator_and_jax(base, jax_tokens, moe_impl):
    """Prefill logits equal to the layer path's (2e-4), and prefill + decode
    tokens equal to the port's Generator and to the JAX Generator. With
    "gmm" the MoE layers run K3's plain version at group_offset 0 and 8."""
    _, _, _, model, params, tree = base
    # "gmm" over the default (tiled) pool, "gather" over flat rows
    pool = model.stack_experts(tree["layers"], layout="flat" if moe_impl == "gather" else "tiled")
    runner = FusedRunner(model, params, pool, moe_impl=moe_impl)
    prompt = np.array([[5, 31, 8, 77]])
    B, T, N = 1, 4, 6
    tok = torch.tensor(prompt, dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32)[None]
    want, _, _ = model.forward(params, tree, tok, pos, model.init_cache(B, 16), 0,
                               for_layer=ResidentProvider.for_layer)
    kv = runner.init_cache(B, 16)
    assert len(kv[0]) == 1 and tuple(kv[1].k.shape) == (2, B, 16, 1, 32)
    assert tuple(kv[1].v.shape) == (2, B, 16, 1, 16)
    logits, kv = runner.prefill(tok, pos, kv, 0)
    torch.testing.assert_close(logits, want, rtol=TOL, atol=TOL)
    tok0 = logits[:, -1:].argmax(-1).to(torch.int32)
    toks, kv = runner.decode(tok0, torch.full((B,), T, dtype=torch.int32), kv, N - 1)
    assert tuple(toks.shape) == (B, N - 1) and toks.dtype == torch.int32
    got = np.concatenate([prompt, tok0.numpy(), toks.numpy()], axis=1)
    np.testing.assert_array_equal(got, jax_tokens.sequences)
    ref = Generator(model, params, tree, ResidentProvider.for_layer, max_seq_len=16).generate(
        prompt, max_new_tokens=N).sequences
    np.testing.assert_array_equal(got, ref)


def test_fused_gmm_passes_layer_offsets(base, monkeypatch):
    from moe_infinity_tpu_torch.ops import gmm as gm

    _, _, _, model, params, tree = base
    seen = []
    real = gm.gmm

    def spy(x, w, sizes, scale=None, group_offset=0, group_ids=None, **k):
        seen.append((group_offset, tuple(w.shape), int(sizes.shape[0]), int(sizes.sum())))
        return real(x, w, sizes, scale, group_offset, group_ids, **k)

    monkeypatch.setattr(gm, "gmm", spy)
    runner = FusedRunner(model, params, model.stack_experts(tree["layers"]))
    runner.prefill(torch.tensor([[5, 31, 8]], dtype=torch.int32),
                   torch.arange(3, dtype=torch.int32)[None], runner.init_cache(1, 8), 0)
    # gate, up, down of MoE layer 0 at offset 0 and of layer 1 at offset E = 8,
    # all 8 groups passed, 3 tokens x top-2 rows routed
    assert [s[0] for s in seen] == [0, 0, 0, 8, 8, 8]
    assert all(s[1][0] == 16 and s[2] == 8 and s[3] == 6 for s in seen)


# ---- structure, the bridge and what raises ------------------------------------------

def test_spec_from_hf_reads_attributes():
    cfg = types.SimpleNamespace(
        vocab_size=100, hidden_size=64, intermediate_size=96, moe_intermediate_size=48,
        num_hidden_layers=3, num_attention_heads=4, q_lora_rank=None, kv_lora_rank=32,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, n_routed_experts=8,
        num_experts_per_tok=2, n_shared_experts=None, first_k_dense_replace=1,
        rms_norm_eps=1e-6, model_type="deepseek_v3", norm_topk_prob=True,
    )
    spec = DeepseekV2Spec.from_hf(cfg)
    assert spec == DeepseekV2Spec(**dict(jds.DeepseekV2Spec.from_hf(cfg).__dict__))
    assert spec.qk_head_dim == 48 and spec.router_variant == "v3" and spec.n_shared_experts == 0


@pytest.mark.parametrize("expert_dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("q_lora,pooled", [(None, False), (24, False), (None, True)])
def test_init_random_structure_matches_jax(expert_dtype, q_lora, pooled):
    kw = dict(TINY, q_lora_rank=q_lora)
    jmodel = jds.DeepseekV2ModelJax(jds.DeepseekV2Spec(**kw), jnp.bfloat16, shared_in_pool=pooled)
    jparams, _ = jmodel.init_random(jax.random.PRNGKey(0))
    model = DeepseekV2Model(DeepseekV2Spec(**kw), torch.bfloat16, "cpu", shared_in_pool=pooled)
    params, tree = model.init_random(torch.Generator().manual_seed(0), expert_dtype=expert_dtype)
    jflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert sorted(flat) == sorted(jflat)
    for k, v in jflat.items():
        assert tuple(flat[k].shape) == v.shape
        assert str(flat[k].dtype).split(".")[-1] == str(v.dtype)
    E, D, Fm = 8 + (1 if pooled else 0), TINY["hidden_size"], TINY["moe_intermediate_size"]
    assert len(tree["layers"]) == 2  # the first layer is dense
    for layer in tree["layers"]:
        for role, (d_in, d_out) in (("gate", (D, Fm)), ("up", (D, Fm)), ("down", (Fm, D))):
            key = role + ("4" if expert_dtype == "int4" else "")
            width = d_out // 2 if expert_dtype == "int4" else d_out
            assert tuple(layer[key].shape) == (E, d_in, width)
            assert layer[key].dtype == (torch.bfloat16 if expert_dtype == "bf16" else torch.int8)
            if expert_dtype != "bf16":
                assert tuple(layer[role + "_scale"].shape) == (E, d_out)
    assert tree["slot_map"].tolist() == list(range(E))
    assert model.init_random(torch.Generator(), with_experts=False)[1] is None


def test_init_cache_is_asymmetric(base):
    model = base[3]
    kvs = model.init_cache(3, 10)
    assert len(kvs) == 3
    assert tuple(kvs[0].k.shape) == (3, 10, 1, 32) and tuple(kvs[0].v.shape) == (3, 10, 1, 16)
    jk = base[0].init_cache(3, 10)
    assert tuple(kvs[0].k.shape) == jk[0].k.shape and tuple(kvs[0].v.shape) == jk[0].v.shape


def test_bridge_carries_deepseek_trees(base):
    """params, the expert tree, folded params and the stacked pool cross the
    bridge unchanged in structure and value, and come back."""
    jmodel, jparams, jtree = base[:3]
    trees = dict(
        params=jparams, experts=jtree, folded=jmodel.fold_mla_params(jparams),
        pool=jmodel.stack_experts(jtree["layers"], layout="flat"),
        stacked=jmodel.stack_moe_layers(jparams),
    )
    for name, tree in trees.items():
        want = jax_to_numpy(tree)
        got = bridge.to_numpy(bridge.to_torch(want, "cpu"))
        wflat = jax.tree_util.tree_flatten_with_path(want)[0]
        gflat = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [jax.tree_util.keystr(p) for p, _ in gflat] == [
            jax.tree_util.keystr(p) for p, _ in wflat], name
        for (_, g), (_, w) in zip(gflat, wflat):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_unported_parts_raise(base):
    model, params, tree = base[3:]
    # a mesh is served: its ranks (threads, ``ThreadMesh``), each on its slice
    # of the routed experts (slots over the expert axis, d_ff over the model
    # axis; the dense weights and shared experts replicated), give the
    # unsharded logits
    tok = torch.tensor(PROMPT, dtype=torch.int32)
    pos = torch.arange(5, dtype=torch.int32).expand(2, 5)
    want = model.forward(params, tree, tok, pos, model.init_cache(2, 8), 0,
                         for_layer=ResidentProvider.for_layer)[0]

    def rank(mesh):
        m = DeepseekV2Model(DeepseekV2Spec(**TINY), torch.float32, "cpu", mesh=mesh)
        t = pm.shard_params(tree, pm.expert_shardings(mesh, tree))
        return m.forward(params, t, tok, pos, m.init_cache(2, 8), 0,
                         for_layer=ResidentProvider.for_layer)[0]

    for sizes in (dict(expert=2), dict(model=2)):
        for got in run_ranks(rank, ThreadMesh.grid(**sizes)):
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # the tiled pool builds (the default), and the gather path refuses it
    gather = FusedRunner(model, params, model.stack_experts(tree["layers"]), moe_impl="gather")
    with pytest.raises(ValueError, match="layout='flat'"):
        gather.prefill(tok, pos, gather.init_cache(2, 8), 0)
    with pytest.raises(ValueError):
        model.init_random(torch.Generator(), expert_dtype="fp8")
    with pytest.raises(ValueError, match="moe_impl"):
        FusedRunner(model, params, {}, moe_impl="pallas")
    q8 = DeepseekV2Model(DeepseekV2Spec(**TINY), torch.float32, "cpu")
    _, tree8 = q8.init_random(torch.Generator().manual_seed(0), expert_dtype="int8")
    with pytest.raises(NotImplementedError, match="unquantized"):
        q8.pool_shared_experts(tree8["layers"], params)


def test_cuda_entry_points_without_card_raise(monkeypatch):
    """The model, and so Generator, the batcher and FusedRunner over it, runs
    on "cuda" unless the caller passes the CPU: without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeepseekV2Model(DeepseekV2Spec(**TINY), compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.to_torch({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedRunner(DeepseekV2Model(DeepseekV2Spec(**TINY)), {}, {})
