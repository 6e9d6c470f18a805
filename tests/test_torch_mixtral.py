"""The port's Mixtral slice against the JAX package on the same numpy
inputs: RMSNorm, RoPE, the top-k router, the gated grouped FFN (ragged, and
pallas through gmm_plain against JAX gffn_pallas in interpret mode) and the
whole model's logits over contiguous and paged caches. Weights come from
the JAX model's init_random through the bridge. Tolerances: 1e-5 at f32
unless a case says otherwise; 2e-2 (3e-2 where the JAX suite uses it for
the same FFN) with bf16 operands, tests/test_gmm.py:49."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models import layers as jlayers
from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.ops import gmm as jgmm
from moe_infinity_tpu.ops import moe as jmoe
from moe_infinity_tpu.runtime.paged_kv import PagedKVCache as JPagedKVCache
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models import layers
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.ops import gmm as gm
from moe_infinity_tpu_torch.ops import moe
from moe_infinity_tpu_torch.runtime.paged_kv import PagedKVCache
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from moe_infinity_tpu_torch.parallel import mesh as pm
from torch_port_helpers import ThreadMesh, np32, one_intra_op_thread, port_attention, run_ranks, to_port

# the tiny spec of tests/test_continuous.py:19-23
TINY = dict(
    vocab_size=128, hidden_size=48, intermediate_size=96, num_layers=2,
    num_heads=6, num_kv_heads=2, head_dim=8, num_experts=4, top_k=2,
    rms_eps=1e-6, rope_theta=1e4, tie_embeddings=False,
)
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


# ---- layers --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_jax(rng, dtype):
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    w = rng.normal(size=(48,)).astype(np.float32)
    jdt, tdt, tol = ((jnp.float32, torch.float32, F32_TOL) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    want = jlayers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w), 1e-6)
    got = layers.rms_norm(torch.tensor(x).to(tdt), torch.tensor(w), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("theta,scaling", [(1e4, 1.0), (1e6, 1.0), (1e4, 4.0)])
def test_rope_matches_jax(rng, theta, scaling):
    B, T, H, Hkv, Dh = 2, 7, 6, 2, 16
    pos = rng.integers(0, 500, size=(B, T)).astype(np.int32)
    q = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, Dh)).astype(np.float32)
    jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(pos), Dh, theta, scaling_factor=scaling)
    cos, sin = layers.rope_cos_sin(torch.tensor(pos), Dh, theta, scaling_factor=scaling)
    # cos/sin of positions up to 500 rad: f32 rounding of the angle (ulp
    # 3e-5 at 500) dominates, so the tables agree to 1e-4
    np.testing.assert_allclose(np32(cos), np.asarray(jcos), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(sin), np.asarray(jsin), rtol=1e-4, atol=1e-4)
    jq, jk = jlayers.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    tq, tk = layers.apply_rope(torch.tensor(q), torch.tensor(k),
                               torch.tensor(np.asarray(jcos)), torch.tensor(np.asarray(jsin)))
    np.testing.assert_allclose(np32(tq), np.asarray(jq), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(np32(tk), np.asarray(jk), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kw", [
    dict(normalize=True), dict(), dict(pre_softmax=False), dict(normalize=True, scaling=2.5),
])
def test_topk_router_matches_jax(rng, kw):
    """Random f32 logits have no ties, so torch.topk and lax.top_k pick
    and order the same experts."""
    logits = rng.normal(size=(11, 8)).astype(np.float32)
    jw, jids, jprobs = jmoe.topk_router(jnp.asarray(logits), 2, **kw)
    w, ids, probs = moe.topk_router(torch.tensor(logits), 2, **kw)
    assert ids.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=F32_TOL, atol=F32_TOL)


# ---- gated grouped FFN ----------------------------------------------------------

T_, D_, F_, S_, K_ = 16, 128, 256, 4, 2


def _routing(rng):
    ids = np.stack([rng.permutation(S_)[:K_] for _ in range(T_)]).astype(np.int32)
    cw = rng.uniform(0, 1, (T_, K_)).astype(np.float32)
    return ids, cw, np.arange(S_, dtype=np.int32)


def _gated_weights(rng, kind):
    """gate/up/down as numpy, in the layout of `kind`."""
    if kind == "f32":
        return {r: (rng.standard_normal(s) * 0.1).astype(np.float32)
                for r, s in (("gate", (S_, D_, F_)), ("up", (S_, D_, F_)), ("down", (S_, F_, D_)))}
    lo, hi = (-8, 8) if kind == "int4" else (-127, 127)
    w = {}
    for r, s in (("gate", (S_, D_, F_)), ("up", (S_, D_, F_)), ("down", (S_, F_, D_))):
        v = rng.integers(lo, hi, s).astype(np.int8)
        w[r + "4" if kind == "int4" else r] = (
            np.asarray(jmoe.pack_int4(jnp.asarray(v))) if kind == "int4" else v)
        hi_scale = 0.05 if kind == "int4" else 0.004
        w[r + "_scale"] = rng.uniform(hi_scale / 5, hi_scale, (S_, s[2])).astype(np.float32)
    return w


# (weight kind, fuse gate+up, impl)
FFN_CASES = [
    ("f32", False, "ragged"), ("f32", True, "ragged"), ("int8", False, "ragged"),
    ("int8", True, "ragged"), ("int4", True, "ragged"),
    ("f32", False, "pallas"), ("f32", True, "pallas"), ("int8", False, "pallas"),
    ("int8", True, "pallas"), ("int4", False, "pallas"), ("int4", True, "pallas"),
]


@pytest.mark.parametrize("kind,fused,impl", FFN_CASES)
def test_gated_grouped_ffn_matches_jax(rng, kind, fused, impl):
    """'up', fused 'gateup' and packed 'gateup4' roles. ragged: against
    JAX's ragged impl; pallas: the port's gmm_plain against JAX gffn_pallas
    in interpret mode (mirrors tests/test_gmm.py:112, :191)."""
    w_np = _gated_weights(rng, kind)
    ids, cw, slot = _routing(rng)
    xdt_j, xdt_t = (jnp.float32, torch.float32) if impl == "ragged" else (jnp.bfloat16, torch.bfloat16)
    x = rng.standard_normal((T_, D_)).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w_np.items()}
    tw = {k: torch.tensor(v) for k, v in w_np.items()}
    if fused:
        jw, tw = jmoe.fuse_gateup(jw), moe.fuse_gateup(tw)
        assert ("gateup4" if kind == "int4" else "gateup") in tw
    jx = jnp.asarray(x, xdt_j)
    tx = torch.tensor(np.asarray(jx, np.float32)).to(xdt_t)
    if impl == "ragged":
        want = jmoe.grouped_ffn(jx, jnp.asarray(ids), jnp.asarray(cw), jnp.asarray(slot),
                                jw, "silu", impl="ragged")
        tol = 1e-4  # f32 sums over D=128, F=256 of O(1) products
    else:
        want = jgmm.gffn_pallas(jx, jnp.asarray(ids), jnp.asarray(cw), jnp.asarray(slot),
                                jw, "silu", interpret=True)
        tol = 3e-2
    got = moe.grouped_ffn(tx, torch.tensor(ids), torch.tensor(cw), torch.tensor(slot),
                          tw, "silu", impl=impl)
    assert got.dtype == xdt_t
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_pallas_gated_runs_one_gmm_per_role(monkeypatch, rng):
    """gate + up: two gmm calls on the same sorted rows; fused gateup4: one
    call whose output halves are [gate | up]; then down."""
    calls = []
    real = gm.gmm

    def spy(x, w, *a, **k):
        calls.append(tuple(w.shape))
        return real(x, w, *a, **k)

    monkeypatch.setattr(gm, "gmm", spy)
    ids, cw, slot = _routing(rng)
    x = torch.tensor(rng.standard_normal((T_, D_)).astype(np.float32)).to(torch.bfloat16)
    split = {k: torch.tensor(v) for k, v in _gated_weights(rng, "int4").items()}
    args = (x, torch.tensor(ids), torch.tensor(cw), torch.tensor(slot))
    moe.grouped_ffn(*args, split, "silu", impl="pallas")
    assert calls == [(S_, D_, F_ // 2), (S_, D_, F_ // 2), (S_, F_, D_ // 2)]
    calls.clear()
    moe.grouped_ffn(*args, moe.fuse_gateup(split), "silu", impl="pallas")
    assert calls == [(S_, D_, F_), (S_, F_, D_ // 2)]


@pytest.mark.parametrize("packed", [False, True])
def test_fuse_and_split_gateup_match_jax(rng, packed):
    w_np = _gated_weights(rng, "int4" if packed else "int8")
    want = jmoe.fuse_gateup({k: jnp.asarray(v) for k, v in w_np.items()})
    got = moe.fuse_gateup({k: torch.tensor(v) for k, v in w_np.items()})
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if not packed:
        back = moe._split_gateup(got)
        jback = jmoe._split_gateup(want)
        assert sorted(back) == sorted(jback) == sorted(w_np)
        for k in back:
            np.testing.assert_array_equal(back[k].numpy(), w_np[k])


# ---- the model -------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_models():
    jmodel = JMixtralModel(JMixtralSpec(**TINY), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(4))
    model = MixtralModel(MixtralSpec(**TINY), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, jtree, model, to_port(jparams), to_port(jtree)


PROMPT = np.array([[5, 31, 8, 77, 12], [9, 3, 44, 6, 21]])


def _run(model, params, tree, caches, steps, for_layer, asarray, **kw):
    """Prefill PROMPT then `steps` one-token steps; returns every step's
    logits and the last router trace. The JAX model's forward runs under
    jit (one compile per step width)."""
    B, T = PROMPT.shape
    out = []
    if isinstance(model, JMixtralModel):
        fwd = jax.jit(functools.partial(model.forward, for_layer=for_layer, impl="ragged"))
    else:
        fwd = functools.partial(model.forward, for_layer=for_layer, impl="ragged")
    tok = asarray(PROMPT)
    pos = asarray(np.broadcast_to(np.arange(T), (B, T)))
    col = 0
    for _ in range(steps + 1):
        extra = {k: asarray(v[:, col:col + tok.shape[1]]) if k == "rope_positions"
                 else (asarray(v) if v is not None else None) for k, v in kw.items()}
        logits, caches, trace = fwd(params, tree, tok, pos, caches, col, **extra)
        out.append(np.array(np32(logits) if isinstance(logits, torch.Tensor) else logits))
        col += tok.shape[1]
        nxt = out[-1][:, -1].argmax(-1)
        tok = asarray(nxt[:, None])
        pos = asarray(np.full((B, 1), col))
    return out, trace


def _tj(a):
    return jnp.asarray(np.asarray(a, np.int32)) if np.asarray(a).dtype != bool else jnp.asarray(a)


def _tt(a):
    a = np.asarray(a)
    return torch.tensor(a if a.dtype == bool else a.astype(np.int32))


def test_forward_contiguous_matches_jax(f32_models):
    jmodel, jparams, jtree, model, params, tree = f32_models
    want, jtrace = _run(jmodel, jparams, jtree, jmodel.init_cache(2, 16), 3,
                        JProvider.for_layer, _tj)
    got, trace = _run(model, params, tree, model.init_cache(2, 16), 3,
                      ResidentProvider.for_layer, _tt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(trace[0].numpy(), np.asarray(jtrace[0]))
    np.testing.assert_allclose(trace[1].numpy(), np.asarray(jtrace[1]), rtol=F32_TOL, atol=F32_TOL)


def test_forward_paged_with_timeline_matches_jax(f32_models, rng):
    """Paged caches with shuffled page tables, per-row rope_positions that
    lag the shared columns and a key_valid hole mask: the continuous
    batcher's step shapes. The port's one-token steps read the pool through
    K4's plain version; JAX's run its oracle over the gathered view."""
    jmodel, jparams, jtree, model, params, tree = f32_models
    B, P, NP = 2, 4, 12
    S = P * 4
    table = np.stack([rng.permutation(np.arange(1, NP))[:P] for _ in range(B)]).astype(np.int32)
    rope = np.stack([np.arange(S), np.maximum(np.arange(S) - 2, 0)]).astype(np.int32)
    valid = np.ones((B, S), bool)
    valid[1, 5:7] = False  # hole columns of row 1

    def caches(make, pools):
        return [make(*pools, table) for _ in range(TINY["num_layers"])]

    shape = (NP, 4, TINY["num_kv_heads"], TINY["head_dim"])
    jk = caches(lambda a, b, t: JPagedKVCache(jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(t)),
                (None, None))
    tk = caches(lambda a, b, t: PagedKVCache(torch.zeros(shape), torch.zeros(shape), torch.tensor(t)),
                (None, None))
    kw = dict(rope_positions=rope, key_valid=valid)
    want, _ = _run(jmodel, jparams, jtree, jk, 4, JProvider.for_layer, _tj, **kw)
    with port_attention("flash"):
        got, _ = _run(model, params, tree, tk, 4, ResidentProvider.for_layer, _tt, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_forward_pad_offsets_matches_jax(f32_models):
    """Left padding: row 1's first two columns are pads. A pad query has no
    valid key; the port's kernels give it 0 and the JAX oracle the mean of
    V, so those two logits rows are left out (no later query reads them)."""
    jmodel, jparams, jtree, model, params, tree = f32_models
    off = np.array([0, 2], np.int32)
    want, _ = _run(jmodel, jparams, jtree, jmodel.init_cache(2, 16), 1,
                   JProvider.for_layer, _tj, pad_offsets=off)
    got, _ = _run(model, params, tree, model.init_cache(2, 16), 1,
                  ResidentProvider.for_layer, _tt, pad_offsets=off)
    got[0][1, :2] = want[0][1, :2] = 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_spec_from_hf_reads_attributes():
    cfg = types.SimpleNamespace(
        vocab_size=100, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=8,
        num_experts_per_tok=2, rms_norm_eps=1e-5,
    )
    spec = MixtralSpec.from_hf(cfg)
    assert spec == MixtralSpec(**dict(JMixtralSpec.from_hf(cfg).__dict__))
    assert spec.head_dim == 16 and spec.rope_theta == 1e6 and not spec.tie_embeddings


@pytest.mark.parametrize("expert_dtype", ["bf16", "int8", "int4"])
def test_init_random_structure_matches_jax(expert_dtype):
    jmodel = JMixtralModel(JMixtralSpec(**TINY), compute_dtype=jnp.bfloat16)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(0))
    model = MixtralModel(MixtralSpec(**TINY), compute_dtype=torch.bfloat16, device="cpu")
    params, tree = model.init_random(torch.Generator().manual_seed(0), expert_dtype=expert_dtype)
    jflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert sorted(flat) == sorted(jflat)
    for k, v in jflat.items():
        assert tuple(flat[k].shape) == v.shape
        assert str(flat[k].dtype).split(".")[-1] == str(v.dtype)
    E, D, F = TINY["num_experts"], TINY["hidden_size"], TINY["intermediate_size"]
    for layer in tree["layers"]:
        for role, (d_in, d_out) in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D))):
            if expert_dtype == "bf16":
                assert layer[role].dtype == torch.bfloat16
                assert tuple(layer[role].shape) == (E, d_in, d_out)
                continue
            key = role + ("4" if expert_dtype == "int4" else "")
            width = d_out // 2 if expert_dtype == "int4" else d_out
            assert layer[key].dtype == torch.int8
            assert tuple(layer[key].shape) == (E, d_in, width)
            assert tuple(layer[role + "_scale"].shape) == (E, d_out)
    assert tree["slot_map"].tolist() == list(range(E))
    assert model.init_random(torch.Generator(), with_experts=False)[1] is None


def test_int8_model_kernel_impls_agree():
    """With int8 experts, impl="pallas" (gmm_plain: operands rounded to
    bf16) and impl="ragged" (f32 dequant) give logits within 2e-2."""
    model = MixtralModel(MixtralSpec(**TINY), compute_dtype=torch.float32, device="cpu")
    params, tree = model.init_random(torch.Generator().manual_seed(3), expert_dtype="int8")
    tok = torch.tensor(PROMPT, dtype=torch.int32)
    pos = torch.arange(5, dtype=torch.int32).expand(2, 5)
    out = {}
    for impl in ("ragged", "pallas"):
        out[impl], _, _ = model.forward(params, tree, tok, pos, model.init_cache(2, 8), 0,
                                        for_layer=ResidentProvider.for_layer, impl=impl)
    torch.testing.assert_close(out["pallas"], out["ragged"], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("sizes", [dict(expert=2), dict(model=2), dict(model=2, expert=2)],
                         ids=["ep2", "tp2", "tp2-ep2"])
def test_unported_parts_raise(sizes):
    """A mesh is served (tests/test_torch_parallel.py holds it to JAX on
    gloo ranks): here its ranks run as threads (``ThreadMesh``), each on
    its slice of the experts (and, under a model axis, of the heads, the
    vocabulary and the experts' d_ff), and every rank's logits equal the
    unsharded model's within 1e-5. A model axis that does not divide the KV
    heads raises; so does an fp8 ``init_random``."""
    spec = MixtralSpec(**TINY)
    single = MixtralModel(spec, compute_dtype=torch.float32, device="cpu")
    params, tree = single.init_random(torch.Generator().manual_seed(4))
    tok = torch.tensor(PROMPT, dtype=torch.int32)
    pos = torch.arange(5, dtype=torch.int32).expand(2, 5)
    want, _, _ = single.forward(params, tree, tok, pos, single.init_cache(2, 8), 0,
                                for_layer=ResidentProvider.for_layer)

    def rank(mesh):
        model = MixtralModel(spec, compute_dtype=torch.float32, device="cpu", mesh=mesh)
        p = (pm.shard_params(params, pm.mixtral_param_shardings(mesh, params))
             if mesh.shape["model"] > 1 else params)
        t = pm.shard_params(tree, pm.expert_shardings(mesh, tree))
        kv = model.init_cache(2, 8)
        assert kv[0].k.shape[2] == TINY["num_kv_heads"] // mesh.shape["model"]
        return model.forward(p, t, tok, pos, kv, 0, for_layer=ResidentProvider.for_layer)[0]

    for got in run_ranks(rank, ThreadMesh.grid(**sizes)):
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="KV heads"):
        MixtralModel(spec, device="cpu", mesh=ThreadMesh.grid(model=4)[0])
    model = MixtralModel(MixtralSpec(**TINY), device="cpu")
    with pytest.raises(ValueError):
        model.init_random(torch.Generator(), expert_dtype="fp8")


def test_cuda_entry_point_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MixtralModel(MixtralSpec(**TINY), compute_dtype=torch.float32)
