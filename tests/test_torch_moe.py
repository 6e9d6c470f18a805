"""The port's MoE ops against the JAX package: int4 packing bit for bit,
the ragged grouped FFN (with -1 slot masking) at f32, and the pallas impl's
dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.ops import moe as jmoe
from moe_infinity_tpu_torch.ops import moe

from torch_port_helpers import np32


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
    with pytest.raises(ValueError, match="not ported"):
        moe.grouped_ffn(x, ids, cw, slot, w, "relu", impl="gather")
