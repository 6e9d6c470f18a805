"""The port's grouped matmul (K3, its plain version on the CPU) and the
grouped FFN built on it, against the JAX package's Pallas gmm in interpret
mode. Tolerance 2e-2 (gmm) and 3e-2 (FFN), as the JAX suite's test_gmm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.ops.gmm import gffn_pallas as j_gffn_pallas
from moe_infinity_tpu.ops.gmm import gmm as j_gmm
from moe_infinity_tpu.ops.moe import pack_int4 as j_pack_int4
from moe_infinity_tpu_torch.ops import gmm as gm

from torch_port_helpers import np32, one_intra_op_thread


def _x(rng, T, D):
    return rng.standard_normal((T, D)).astype(np.float32)


def _case(rng, kind, S, D, F):
    """(numpy weights as JAX takes them, port tensor, scale, packed)."""
    if kind == "bf16":
        w = (rng.standard_normal((S, D, F)) * 0.1).astype(np.float32)
        return jnp.asarray(w, jnp.bfloat16), torch.tensor(w).bfloat16(), None, False
    scale = rng.uniform(0.001, 0.02, (S, F)).astype(np.float32)
    if kind == "int8":
        w = rng.integers(-127, 127, (S, D, F)).astype(np.int8)
        return jnp.asarray(w), torch.tensor(w), scale, False
    v = rng.integers(-8, 8, (S, D, F)).astype(np.int8)
    wp = np.asarray(j_pack_int4(jnp.asarray(v)))
    return jnp.asarray(wp), torch.tensor(wp), scale, True


GMM_CASES = {
    "bf16": dict(kind="bf16", T=33, D=128, F=384, sizes=[7, 9, 6, 4, 7]),
    "bf16_empty_groups": dict(kind="bf16", T=16, D=128, F=256, sizes=[0, 10, 0, 0, 6, 0]),
    "int8_scale": dict(kind="int8", T=16, D=128, F=256, sizes=[4, 4, 4, 4]),
    "int4_scale": dict(kind="int4", T=16, D=128, F=256, sizes=[4, 4, 4, 4]),
    "int4_empty_groups": dict(kind="int4", T=16, D=128, F=256, sizes=[0, 9, 0, 7, 0]),
    "int4_compacted_ids_offset": dict(kind="int4", T=8, D=128, F=256, sizes=[3, 1, 4, 0],
                                      ids=[1, 5, 6, 0], S=12, offset=4),
    "int8_compacted_ids": dict(kind="int8", T=10, D=256, F=128, sizes=[6, 4, 0],
                               ids=[9, 2, 0], S=16),
}


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_plain_matches_jax_kernel(rng, case):
    c = GMM_CASES[case]
    S = c.get("S", len(c["sizes"]))
    jw, w, scale, packed = _case(rng, c["kind"], S, c["D"], c["F"])
    x = _x(rng, c["T"], c["D"])
    sizes = np.asarray(c["sizes"], np.int32)
    ids = None if "ids" not in c else np.asarray(c["ids"], np.int32)
    off = c.get("offset", 0)
    want = j_gmm(
        jnp.asarray(x, jnp.bfloat16), jw, jnp.asarray(sizes),
        None if scale is None else jnp.asarray(scale),
        None if "offset" not in c else jnp.int32(off),
        None if ids is None else jnp.asarray(ids),
        num_groups=len(sizes), interpret=True, packed=packed,
    )
    got = gm.gmm(
        torch.tensor(x), w, torch.tensor(sizes),
        None if scale is None else torch.tensor(scale), off,
        None if ids is None else torch.tensor(ids), packed=packed,
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=2e-2, atol=2e-2)


def test_compact_groups_matches_unique_with_size(rng):
    S, N = 64, 16
    flat = rng.integers(0, S, N).astype(np.int32)
    flat[0] = 0  # slot 0 active beside the padding groups
    sorted_slots = np.sort(flat)
    want_ids, want_sizes = jnp.unique(
        jnp.asarray(flat), size=N, fill_value=0, return_counts=True
    )
    ids, sizes = gm.compact_groups(torch.tensor(sorted_slots).long(), N)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))


@pytest.mark.parametrize("T", [1, 16])
def test_an_arena_launches_the_resident_layers_grid(rng, monkeypatch, T):
    """gffn_pallas sizes K3's group grid from the layer's E experts as well
    as from the rows: the same routed experts in an arena of 3E slots
    (mapped to other slots) and in the resident layer (the identity) give
    every K3 call the same G, so the same split plan and the same sums.
    Mixtral's prefill down projection (T = 16, K = 2, D = 14336 in, 4096
    out) splits its reduction at G = 8 but not at G = min(3E, T * K) = 24."""
    E, K, D, F = 8, 2, 64, 32
    calls = {}

    def recorder(tag):
        def gmm(x, w, sizes, scale=None, group_offset=0, group_ids=None, *, packed=False):
            calls.setdefault(tag, []).append(sizes.shape[0])
            return torch.zeros(x.shape[0], w.shape[2], dtype=torch.float32)
        return gmm

    x = torch.tensor(_x(rng, T, D))
    ids = torch.tensor(rng.integers(0, E, (T, K)).astype(np.int32))
    cw = torch.ones(T, K)
    for tag, S, slots in (("resident", E, torch.arange(E, dtype=torch.int32)),
                          ("arena", 3 * E, torch.tensor(rng.permutation(3 * E)[:E],
                                                        dtype=torch.int32))):
        w = {r: torch.zeros(S, *shape, dtype=torch.bfloat16)
             for r, shape in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D)))}
        monkeypatch.setattr(gm, "gmm", recorder(tag))
        gm.gffn_pallas(x, ids, cw, slots, w, "silu")
    assert calls["arena"] == calls["resident"] == [min(E, T * K)] * 3
    assert gm._gmm_plan(16, 8, 14336, 4096).splits > 1
    assert gm._gmm_plan(16, 24, 14336, 4096).splits == 1


@pytest.mark.parametrize("K", [2, 6])
def test_an_arena_combines_as_the_resident_layer(rng, K):
    """The same experts at other slots of a larger arena (DeepSeek routes 6
    of 64) give the resident layer's output bit for bit: the K outputs of a
    token are summed in routing order, not in the order of their slots."""
    T, E, D, F = 5, 16, 32, 48
    x = torch.tensor(_x(rng, T, D))
    ids = torch.tensor(np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32))
    cw = torch.tensor(rng.uniform(0, 1, (T, K)).astype(np.float32))
    w = {r: torch.tensor(rng.standard_normal((E,) + shape).astype(np.float32) * 0.1).bfloat16()
         for r, shape in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D)))}
    want = gm.gffn_pallas(x, ids, cw, torch.arange(E, dtype=torch.int32), w, "silu")
    slots = torch.tensor(rng.permutation(3 * E)[:E], dtype=torch.int32)
    arena = {r: torch.zeros((3 * E,) + t.shape[1:], dtype=t.dtype) for r, t in w.items()}
    for r, t in w.items():
        arena[r][slots.long()] = t
    got = gm.gffn_pallas(x, ids, cw, slots, arena, "silu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("S,dtype", [(4, "bf16"), (64, "bf16"), (4, "f32")])
def test_gffn_pallas_nllb_packed_matches_jax(rng, S, dtype):
    """The NLLB case (relu, fc biases, packed int4 gate/down) of
    tests/test_gmm.py:223, and with S >> T*K the compacted grid."""
    T, D, F, K = 12, 128, 256, 2
    x = _x(rng, T, D)
    ids = rng.integers(0, S, (T, K)).astype(np.int32)
    cw = rng.uniform(0, 1, (T, K)).astype(np.float32)
    vg = rng.integers(-8, 8, (S, D, F)).astype(np.int8)
    vd = rng.integers(-8, 8, (S, F, D)).astype(np.int8)
    w_np = {
        "gate4": np.asarray(j_pack_int4(jnp.asarray(vg))),
        "down4": np.asarray(j_pack_int4(jnp.asarray(vd))),
        "gate_scale": rng.uniform(0.01, 0.05, (S, F)).astype(np.float32),
        "down_scale": rng.uniform(0.01, 0.05, (S, D)).astype(np.float32),
    }
    b_np = {
        "gate_bias": (rng.standard_normal((S, F)) * 0.1).astype(np.float32),
        "down_bias": (rng.standard_normal((S, D)) * 0.1).astype(np.float32),
    }
    slot = np.arange(S, dtype=np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    want = j_gffn_pallas(
        jnp.asarray(x, jdt), jnp.asarray(ids), jnp.asarray(cw), jnp.asarray(slot),
        {k: jnp.asarray(v) for k, v in w_np.items()}, "relu",
        biases={k: jnp.asarray(v) for k, v in b_np.items()}, interpret=True,
    )
    got = gm.gffn_pallas(
        torch.tensor(x).to(tdt), torch.tensor(ids), torch.tensor(cw), torch.tensor(slot),
        {k: torch.tensor(v) for k, v in w_np.items()}, "relu",
        biases={k: torch.tensor(v) for k, v in b_np.items()},
    )
    assert got.dtype == tdt
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)


def test_gffn_pallas_rejects_unported_roles():
    """Pre-tiled [S, F/tf, D, tf] weights are taken (test_torch_gmm_tiled);
    packed int4 in a 4-D layout is not, in the JAX kernel's words, on the
    CPU as on the card."""
    w = {"gate4": torch.zeros(2, 1, 8, 8, dtype=torch.int8),
         "down": torch.zeros(2, 16, 8, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match=r"packed int4 gmm takes 3D \[S, D, F//2\] weights"):
        gm.gffn_pallas(torch.zeros(2, 8), torch.zeros(2, 2, dtype=torch.int32),
                       torch.ones(2, 2), torch.arange(2), w, "silu")


@pytest.mark.parametrize("what", ["float32_weights", "odd_width", "scale_shape",
                                  "short_x_rows", "int8_row_bytes"])
def test_gmm_cuda_path_rejects_what_the_kernel_does_not_take(what):
    """Checked before any launch, so CPU tensors show it. The kernel copies
    16-byte pieces: D % 8 == 0 for x, a multiple of 16 bytes per weight row."""
    D = 12 if what == "short_x_rows" else 8
    x = torch.zeros(4, D)
    sizes = torch.tensor([4], dtype=torch.int32)
    ids = torch.zeros(1, dtype=torch.int32)
    w = {"float32_weights": torch.zeros(1, 8, 8),
         "odd_width": torch.zeros(1, 8, 6, dtype=torch.bfloat16),
         "scale_shape": torch.zeros(1, 8, 8, dtype=torch.bfloat16),
         "short_x_rows": torch.zeros(1, 12, 8, dtype=torch.bfloat16),
         "int8_row_bytes": torch.zeros(1, 8, 8, dtype=torch.int8)}[what]
    scale = torch.zeros(1, 4) if what == "scale_shape" else None
    with pytest.raises(ValueError):
        gm._gmm_cuda(x, w, sizes, scale, 0, ids, packed=False)
