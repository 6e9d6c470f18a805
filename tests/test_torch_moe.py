"""The port's MoE ops against the JAX package: int4 packing bit for bit,
the ragged, gather and dense grouped FFN (with -1 slot masking) at f32, and
the pallas impl's dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.ops import moe as jmoe
from moe_infinity_tpu_torch.ops import moe

from torch_port_helpers import np32, one_intra_op_thread


def test_pack_unpack_int4_bit_exact_with_jax(rng):
    v = rng.integers(-8, 8, (3, 5, 64)).astype(np.int8)
    want = np.asarray(jmoe.pack_int4(jnp.asarray(v)))
    got = moe.pack_int4(torch.tensor(v))
    np.testing.assert_array_equal(got.numpy(), want)
    raw = rng.integers(-128, 128, (4, 32)).astype(np.int8)  # every byte value
    np.testing.assert_array_equal(
        moe.unpack_int4(torch.tensor(raw)).numpy(),
        np.asarray(jmoe.unpack_int4(jnp.asarray(raw))),
    )
    np.testing.assert_array_equal(moe.unpack_int4(got).numpy(), v)


def _weights(rng, S, D, F, quant):
    if quant == "f32":
        return {
            "gate": (rng.standard_normal((S, D, F)) * 0.1).astype(np.float32),
            "down": (rng.standard_normal((S, F, D)) * 0.1).astype(np.float32),
        }
    vg = rng.integers(-8, 8, (S, D, F)).astype(np.int8)
    vd = rng.integers(-8, 8, (S, F, D)).astype(np.int8)
    w = {"gate_scale": rng.uniform(0.01, 0.05, (S, F)).astype(np.float32),
         "down_scale": rng.uniform(0.01, 0.05, (S, D)).astype(np.float32)}
    if quant == "int4":
        w["gate4"] = np.asarray(jmoe.pack_int4(jnp.asarray(vg)))
        w["down4"] = np.asarray(jmoe.pack_int4(jnp.asarray(vd)))
    else:
        w["gate"], w["down"] = vg, vd
    return w


@pytest.mark.parametrize("quant", ["f32", "int8", "int4"])
@pytest.mark.parametrize("missing_slot", [False, True])
def test_grouped_ffn_ragged_matches_jax(rng, quant, missing_slot):
    T, D, F, S, K = 10, 32, 48, 6, 2
    x = rng.standard_normal((T, D)).astype(np.float32)
    ids = np.stack([rng.permutation(S)[:K] for _ in range(T)]).astype(np.int32)
    cw = rng.uniform(0, 1, (T, K)).astype(np.float32)
    slot = rng.permutation(S).astype(np.int32)
    if missing_slot:
        slot[ids[0, 0]] = -1  # non-resident: its routes contribute zero
    w = _weights(rng, S, D, F, quant)
    b = {"gate_bias": (rng.standard_normal((S, F)) * 0.1).astype(np.float32),
         "down_bias": (rng.standard_normal((S, D)) * 0.1).astype(np.float32)}
    want = jmoe.grouped_ffn(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(cw), jnp.asarray(slot),
        {k: jnp.asarray(v) for k, v in w.items()}, "relu",
        biases={k: jnp.asarray(v) for k, v in b.items()}, impl="ragged",
    )
    got = moe.grouped_ffn(
        torch.tensor(x), torch.tensor(ids), torch.tensor(cw), torch.tensor(slot),
        {k: torch.tensor(v) for k, v in w.items()}, "relu",
        biases={k: torch.tensor(v) for k, v in b.items()}, impl="ragged",
    )
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["relu", "gelu", "gelu_tanh", "silu"])
def test_activate_matches_jax(rng, activation):
    h = rng.standard_normal((4, 16)).astype(np.float32)
    up = rng.standard_normal((4, 16)).astype(np.float32)
    want = jmoe._activate(jnp.asarray(h), jnp.asarray(up), activation)
    got = moe._activate(torch.tensor(h), torch.tensor(up), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_grouped_ffn_pallas_impl_masks_missing_slots(rng):
    """impl="pallas" runs gffn_pallas with the -1 routes masked to zero: a
    token whose both experts are missing gets a zero row."""
    T, D, F, S, K = 6, 128, 256, 4, 2
    x = torch.tensor(rng.standard_normal((T, D)).astype(np.float32))
    ids = torch.tensor([[0, 1]] + [[2, 3]] * (T - 1), dtype=torch.int32)
    cw = torch.full((T, K), 0.5)
    w = {k: torch.tensor(v) for k, v in _weights(rng, S, D, F, "int4").items()}
    slot = torch.tensor([-1, -1, 2, 3], dtype=torch.int32)
    out = moe.grouped_ffn(x, ids, cw, slot, w, "relu", impl="pallas")
    assert bool((out[0] == 0).all()) and bool((out[1:] != 0).any())
    with pytest.raises(ValueError, match="unknown grouped_ffn impl"):
        moe.grouped_ffn(x, ids, cw, slot, w, "relu", impl="stream")


def _gated(rng, S, D, F, quant, fused):
    """gate/up/down as numpy in the layout of `quant`, optionally fused."""
    shapes = (("gate", (S, D, F)), ("up", (S, D, F)), ("down", (S, F, D)))
    if quant == "f32":
        w = {r: (rng.standard_normal(s) * 0.1).astype(np.float32) for r, s in shapes}
    else:
        lo, hi = (-8, 8) if quant == "int4" else (-127, 127)
        w = {}
        for r, s in shapes:
            v = rng.integers(lo, hi, s).astype(np.int8)
            w[r + "4" if quant == "int4" else r] = (
                np.asarray(jmoe.pack_int4(jnp.asarray(v))) if quant == "int4" else v)
            # int8 scales as tests/test_fold_fuse.py:83: outputs stay O(1)
            sc = (0.01, 0.05) if quant == "int4" else (1e-3, 2e-3)
            w[r + "_scale"] = rng.uniform(*sc, (S, s[2])).astype(np.float32)
    if fused:
        w = {k: np.asarray(v) for k, v in
             jmoe.fuse_gateup({k: jnp.asarray(v) for k, v in w.items()}).items()}
    return w


# (impl, weight kind, fuse gate+up, one slot missing); the JAX dense impl does
# not take a fused packed tree, so that one combination is left out
GATHER_DENSE_CASES = [
    (impl, quant, fused, missing)
    for impl in ("gather", "dense") for quant in ("f32", "int8", "int4")
    for fused, missing in ((False, False), (True, False), (False, True))
    if not (impl == "dense" and quant == "int4" and fused)
]


@pytest.mark.parametrize("impl,quant,fused,missing_slot", GATHER_DENSE_CASES)
def test_grouped_ffn_gather_dense_match_jax(rng, impl, quant, fused, missing_slot):
    """The SiLU-gated FFN (DeepSeek's) through the two plain impls, for plain,
    int8 and packed int4 trees, split and fused gate+up, at 1e-5 (f32)."""
    T, D, F, S, K = 9, 32, 48, 6, 2
    x = rng.standard_normal((T, D)).astype(np.float32)
    ids = np.stack([rng.permutation(S)[:K] for _ in range(T)]).astype(np.int32)
    cw = rng.uniform(0, 1, (T, K)).astype(np.float32)
    slot = rng.permutation(S).astype(np.int32)
    if missing_slot:
        slot[ids[0, 0]] = -1
    w = _gated(rng, S, D, F, quant, fused)
    want = jmoe.grouped_ffn(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(cw), jnp.asarray(slot),
        {k: jnp.asarray(v) for k, v in w.items()}, "silu", impl=impl)
    got = moe.grouped_ffn(
        torch.tensor(x), torch.tensor(ids), torch.tensor(cw), torch.tensor(slot),
        {k: torch.tensor(v) for k, v in w.items()}, "silu", impl=impl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_grouped_ffn_gather_dense_with_biases_match_jax(rng, impl):
    """The ungated relu FFN with expert biases (NLLB's roles)."""
    T, D, F, S, K = 7, 32, 48, 5, 2
    x = rng.standard_normal((T, D)).astype(np.float32)
    ids = np.stack([rng.permutation(S)[:K] for _ in range(T)]).astype(np.int32)
    cw = rng.uniform(0, 1, (T, K)).astype(np.float32)
    slot = np.arange(S, dtype=np.int32)
    w = _weights(rng, S, D, F, "int8")
    b = {"gate_bias": (rng.standard_normal((S, F)) * 0.1).astype(np.float32),
         "down_bias": (rng.standard_normal((S, D)) * 0.1).astype(np.float32)}
    want = jmoe.grouped_ffn(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(cw), jnp.asarray(slot),
        {k: jnp.asarray(v) for k, v in w.items()}, "relu",
        biases={k: jnp.asarray(v) for k, v in b.items()}, impl=impl)
    got = moe.grouped_ffn(
        torch.tensor(x), torch.tensor(ids), torch.tensor(cw), torch.tensor(slot),
        {k: torch.tensor(v) for k, v in w.items()}, "relu",
        biases={k: torch.tensor(v) for k, v in b.items()}, impl=impl)
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gather_rounds_x_to_the_slab_type(rng):
    """With int8 slabs the gather impl multiplies bf16(x) with the exact bf16
    weights, f32 sums, as the JAX package does: bf16 inputs agree to 1e-2
    with the f32-dequantizing ragged impl."""
    T, D, F, S, K = 6, 32, 48, 4, 2
    x = torch.tensor(rng.standard_normal((T, D)).astype(np.float32)).bfloat16()
    ids = torch.tensor(np.stack([rng.permutation(S)[:K] for _ in range(T)]).astype(np.int32))
    cw = torch.tensor(rng.uniform(0, 1, (T, K)).astype(np.float32))
    slot = torch.arange(S, dtype=torch.int32)
    w = {k: torch.tensor(v) for k, v in _gated(rng, S, D, F, "int8", False).items()}
    got = moe.grouped_ffn(x, ids, cw, slot, w, "silu", impl="gather")
    want = moe.grouped_ffn(x, ids, cw, slot, w, "silu", impl="ragged")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-2, atol=2e-2)
