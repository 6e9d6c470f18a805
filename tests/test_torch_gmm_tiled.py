"""K3 over the pre-tiled weight layout [S, F/tf, D, tf] (the JAX package's
``ops/gmm.py::pack_tiled``, its ``stack_experts`` default): the port's
``pack_tiled`` byte-equal to JAX's, ``gmm_plain`` and ``gffn_pallas`` on
tiled weights against the JAX kernel in interpret mode, the DeepSeek pool
and ``FusedRunner`` over it against JAX's, and, as far as the CPU sees the
kernel, its launch arguments (the kernel replaced by a recorder) and an
emulation of its algorithm reading weights through the tiled addressing.
Tolerances: 2e-2 on gmm and 3e-2 on the FFN (bf16 operands, as
test_torch_gmm.py), 2e-4 on logits (as test_torch_deepseek.py), 1e-5 on
the emulation (as test_torch_gmm_plan.py); tiled and flat calls of the
plain version are bit-equal, as the kernel's are."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models import deepseek_v2 as jds
from moe_infinity_tpu.ops.gmm import gffn_pallas as j_gffn_pallas
from moe_infinity_tpu.ops.gmm import gmm as j_gmm
from moe_infinity_tpu.ops.gmm import pack_tiled as j_pack_tiled
from moe_infinity_tpu.runtime.fused import FusedRunner as JFusedRunner
from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
from moe_infinity_tpu_torch.ops import gmm as gm
from moe_infinity_tpu_torch.runtime.fused import FusedRunner

from test_torch_gmm_plan import EDGE_SIZES, _emulate, _weights, fake_kernel  # noqa: F401
from torch_port_helpers import jax_to_numpy, np32, one_intra_op_thread, to_port


def _bits(a):
    """A tensor's or array's bytes as integers of its width."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.element_size() == 2 else torch.int8).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int8)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("F,tf", [(1408, 0), (2048, 0), (640, 0), (704, 0), (200, 0), (96, 0),
                                  (384, 128), (1408, 352)])
def test_pack_tiled_is_byte_equal_to_jax(rng, kind, F, tf):
    """JAX's slab rule (the largest divisor of F up to 512 that is a
    multiple of 128, else the largest divisor up to 512: 1408 -> 128,
    2048 -> 512, 640 -> 128, 704 -> 352, 200 -> 200) and an explicit tf."""
    S, D = 3, 16
    if kind == "bf16":
        w = (rng.standard_normal((S, D, F)) * 0.1).astype(np.float32)
        jw, tw = jnp.asarray(w, jnp.bfloat16), torch.tensor(w).bfloat16()
    else:
        w = rng.integers(-128, 128, (S, D, F)).astype(np.int8)
        jw, tw = jnp.asarray(w), torch.tensor(w)
    want = j_pack_tiled(jw, tf)
    got = gm.pack_tiled(tw, tf)
    assert tuple(got.shape) == want.shape and got.is_contiguous()
    np.testing.assert_array_equal(_bits(got), _bits(want))


# tests/test_gmm.py:76-107 on the tiled layout, plus compacted ids
TILED_CASES = {
    "bf16": dict(kind="bf16", T=16, D=128, F=384, sizes=[4, 0, 6, 3, 3]),
    "int8_offset_scale": dict(kind="int8", T=8, D=128, F=256, sizes=[2, 2, 2, 2], S=12,
                              offset=8),
    "int8_compacted_ids": dict(kind="int8", T=10, D=256, F=384, sizes=[6, 4, 0],
                               ids=[9, 2, 0], S=16),
    "bf16_ids_offset": dict(kind="bf16", T=8, D=128, F=256, sizes=[3, 1, 4, 0],
                            ids=[1, 5, 6, 0], S=12, offset=4),
}


@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_gmm_plain_on_tiled_weights_matches_jax(rng, case):
    c = TILED_CASES[case]
    S = c.get("S", len(c["sizes"]))
    x = rng.standard_normal((c["T"], c["D"])).astype(np.float32)
    if c["kind"] == "bf16":
        w = (rng.standard_normal((S, c["D"], c["F"])) * 0.1).astype(np.float32)
        jw, tw, scale = jnp.asarray(w, jnp.bfloat16), torch.tensor(w).bfloat16(), None
    else:
        w = rng.integers(-127, 127, (S, c["D"], c["F"])).astype(np.int8)
        jw, tw = jnp.asarray(w), torch.tensor(w)
        scale = rng.uniform(0.001, 0.02, (S, c["F"])).astype(np.float32)
    sizes = np.asarray(c["sizes"], np.int32)
    ids = None if "ids" not in c else np.asarray(c["ids"], np.int32)
    off = c.get("offset", 0)
    want = j_gmm(
        jnp.asarray(x, jnp.bfloat16), j_pack_tiled(jw, 128), jnp.asarray(sizes),
        None if scale is None else jnp.asarray(scale), jnp.int32(off),
        None if ids is None else jnp.asarray(ids), num_groups=len(sizes), interpret=True)
    args = (torch.tensor(sizes), None if scale is None else torch.tensor(scale), off,
            None if ids is None else torch.tensor(ids))
    got = gm.gmm(torch.tensor(x), gm.pack_tiled(tw, 128), *args)
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=2e-2, atol=2e-2)
    assert torch.equal(got, gm.gmm(torch.tensor(x), tw, *args))  # tiled == flat, bit for bit


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_gffn_pallas_with_tiled_roles_matches_jax(rng, kind):
    """Gated gate/up/down (Mixtral's roles), 6 experts, top-2 over 9 tokens,
    D 128, F 256 in slabs of 128; bf16 weights, or int8 with scales."""
    T, K, E, D, F = 9, 2, 6, 128, 256
    x = rng.standard_normal((T, D)).astype(np.float32)
    ids = np.stack([rng.choice(E, K, replace=False) for _ in range(T)]).astype(np.int32)
    cw = rng.uniform(0.1, 1.0, (T, K)).astype(np.float32)
    slot = np.arange(E, dtype=np.int32)
    w_np = {}
    for role, (din, dout) in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D))):
        if kind == "bf16":
            w_np[role] = (rng.standard_normal((E, din, dout)) * 0.1).astype(np.float32)
        else:
            w_np[role] = rng.integers(-127, 127, (E, din, dout)).astype(np.int8)
            w_np[role + "_scale"] = rng.uniform(0.001, 0.02, (E, dout)).astype(np.float32)

    def jw(k, v):
        if k.endswith("_scale"):
            return jnp.asarray(v)
        return j_pack_tiled(jnp.asarray(v, jnp.bfloat16 if kind == "bf16" else jnp.int8), 128)

    def tw(k, v):
        t = torch.tensor(v)
        if k.endswith("_scale"):
            return t
        return gm.pack_tiled(t.bfloat16() if kind == "bf16" else t, 128)

    want = j_gffn_pallas(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(cw), jnp.asarray(slot),
                         {k: jw(k, v) for k, v in w_np.items()}, "silu", interpret=True)
    tiled = {k: tw(k, v) for k, v in w_np.items()}
    assert tiled["gate"].dim() == 4 and tiled["gate"].shape[1] == 2
    targs = (torch.tensor(x), torch.tensor(ids), torch.tensor(cw), torch.tensor(slot))
    got = gm.gffn_pallas(*targs, tiled, "silu")
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=3e-2, atol=3e-2)
    flat = {k: torch.tensor(v).bfloat16() if kind == "bf16" and not k.endswith("_scale")
            else torch.tensor(v) for k, v in w_np.items()}
    assert torch.equal(got, gm.gffn_pallas(*targs, flat, "silu"))


# tests/test_fused.py's tiny spec with a routed F of 1024: gate and up pack
# into two slabs of 512, down (F = hidden 64) into one
SPEC = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=1024,
    num_layers=3, num_heads=4, q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=32,
    qk_rope_head_dim=16, v_head_dim=32, num_experts=8, top_k=2, n_shared_experts=1,
    first_k_dense_replace=1, topk_method="greedy", n_group=None, topk_group=None,
    routed_scaling_factor=1.0, rms_eps=1e-6, rope_theta=10000.0, tie_embeddings=False,
)


@pytest.fixture(scope="module")
def pair():
    jmodel = jds.DeepseekV2ModelJax(jds.DeepseekV2Spec(**SPEC), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(7))
    model = DeepseekV2Model(DeepseekV2Spec(**SPEC), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, jtree, model, to_port(jparams), to_port(jtree)


def test_stack_experts_default_matches_jax(pair):
    jmodel, _, jtree, model, _, tree = pair
    want = jax_to_numpy(jmodel.stack_experts(jtree["layers"]))
    got = model.stack_experts(tree["layers"])
    assert sorted(got) == sorted(want)
    assert tuple(got["gate"].shape) == (16, 2, 64, 512)
    assert tuple(got["down"].shape) == (16, 1, 1024, 64)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(np32(got[k]), want[k])


def test_fused_runner_over_the_tiled_pool_matches_jax(pair):
    """The port's FusedRunner over the default (tiled) pool against JAX's
    FusedRunner over its default pool (the Pallas gmm in interpret mode):
    prefill logits within 2e-4, prefill and 3 decode tokens equal; and the
    same logits, bit for bit, over the flat pool."""
    jmodel, jparams, jtree, model, params, tree = pair
    B, T, CAP, N = 1, 4, 16, 4
    prompt = np.array([[5, 31, 8, 77]], np.int32)
    jrun = JFusedRunner(jmodel, jparams, jmodel.stack_experts(jtree["layers"]), interpret=True)
    jpos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    jlogits, jkv = jrun.prefill(jnp.asarray(prompt), jpos, jrun.init_cache(B, CAP), jnp.int32(0))
    jtok0 = jnp.argmax(jlogits[:, -1:, :], axis=-1).astype(jnp.int32)
    jtoks, _ = jrun.decode(jtok0, jnp.full((B,), T, jnp.int32), jkv, N - 1)
    want = np.concatenate([prompt, np.asarray(jtok0), np.asarray(jtoks)], axis=1)

    tok, pos = torch.tensor(prompt), torch.arange(T, dtype=torch.int32)[None]
    run = FusedRunner(model, params, model.stack_experts(tree["layers"]))
    logits, kv = run.prefill(tok, pos, run.init_cache(B, CAP), 0)
    np.testing.assert_allclose(np32(logits), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
    tok0 = logits[:, -1:].argmax(-1).to(torch.int32)
    toks, _ = run.decode(tok0, torch.full((B,), T, dtype=torch.int32), kv, N - 1)
    np.testing.assert_array_equal(np.concatenate([prompt, tok0.numpy(), toks.numpy()], 1), want)
    flat = FusedRunner(model, params, model.stack_experts(tree["layers"], layout="flat"))
    assert torch.equal(flat.prefill(tok, pos, flat.init_cache(B, CAP), 0)[0], logits)


# ---- the kernel's launch and its algorithm ------------------------------------------

@pytest.mark.parametrize("kind,D,F,tf,splits", [
    ("bf16", 2048, 1408, 128, 1),  # V2-Lite gate and up in pack_tiled's default slabs
    ("bf16", 2048, 1408, 352, 1),  # ... in slabs of 352: a column tile straddles two slabs
    ("bf16", 1408, 2048, 512, 1),  # V2-Lite down
    ("int8", 2048, 1408, 352, 1),
    ("fp8", 2048, 1408, 352, 1),
])
def test_a_tiled_call_is_one_launch_without_a_host_read(fake_kernel, kind, D, F, tf, splits):
    """24 rows in 24 groups (V2-Lite's decode step, groups compacted): the
    flat call's plan and arguments, with tf the slab width, counted under
    gmm_tiled whatever the kind."""
    dt = {"bf16": torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[kind]
    T = G = 24
    w = torch.zeros(2, F // tf, D, tf, dtype=dt)
    scale = None if kind == "bf16" else torch.ones(2, F)
    before = dict(gm.LAUNCHES)
    out = gm._gmm_cuda(torch.zeros(T, D), w, torch.zeros(G, dtype=torch.int32), scale, 0,
                       torch.zeros(G, dtype=torch.int32), packed=False)
    assert gm.LAUNCHES["gmm_tiled"] == before["gmm_tiled"] + 1
    assert all(gm.LAUNCHES[k] == before[k] for k in ("gmm", "gmm_fp8"))
    gm.LAUNCHES.update(before)  # nothing was launched
    assert out.shape == (T, F)
    (call,) = fake_kernel
    assert call["tf"] == tf and call["Fw"] == call["F"] == F and call["D"] == D
    assert call["splits"] == splits == gm._gmm_plan(T, G, D, F).splits
    assert call["kind"] == {"bf16": 0, "int8": 1, "fp8": 3}[kind]


@pytest.mark.parametrize("dt,nf,tf", [(torch.bfloat16, 8, 4), (torch.int8, 4, 8),
                                      (torch.int8, 2, 24)])
def test_a_slab_row_of_partial_16_byte_pieces_raises(dt, nf, tf):
    """Before any launch: a 16-byte piece must lie in one slab (the whole
    row, nf * tf, is whole pieces in each case)."""
    w = torch.zeros(2, nf, 16, tf, dtype=dt)
    with pytest.raises(ValueError, match="slab row must be a multiple of 16 bytes"):
        gm._gmm_cuda(torch.zeros(2, 16), w, torch.ones(2, dtype=torch.int32), None, 0, None,
                     packed=False)


def test_packed_int4_takes_no_tiled_weights():
    """In the JAX kernel's words, on the CPU and the card route alike."""
    w = torch.zeros(2, 2, 16, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match=r"packed int4 gmm takes 3D \[S, D, F//2\] weights"):
        gm.gmm(torch.zeros(2, 16), w, torch.ones(2, dtype=torch.int32), torch.ones(2, 256),
               packed=True)


@pytest.mark.parametrize("kind,tf", [("bf16", 64), ("bf16", 96), ("int8", 48), ("fp8", 32)])
def test_emulation_over_tiled_addressing_matches_gmm_plain(rng, kind, tf):
    """The edge-size groups of test_torch_gmm_plan with F 192 in slabs of tf
    (a 128-column tile takes columns of two or three slabs), at the plan's
    split and at 4: the emulation reads each slot through the kernel's tiled
    addressing, equal to plain within 1e-5; plain on tiled equals plain on
    flat bit for bit."""
    D, F = 200, 192
    T = sum(EDGE_SIZES) + 3
    w, scale, _ = _weights(rng, kind, len(EDGE_SIZES), D, F)
    tw = gm.pack_tiled(w, tf)
    x = torch.tensor(rng.standard_normal((T, D)), dtype=torch.float32)
    sizes = torch.tensor(EDGE_SIZES, dtype=torch.int32)
    want = gm.gmm_plain(x, w, sizes, scale)
    assert torch.equal(gm.gmm_plain(x, tw, sizes, scale), want)
    for splits in (None, 4):
        got = _emulate(x, tw, EDGE_SIZES, scale, splits=splits)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
