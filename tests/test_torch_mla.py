"""K5's plain PyTorch version (``mla_flash_decode_plain``, what the wrapper
runs for CPU tensors) against the JAX package on the same numpy inputs: the
Pallas ``mla_flash_decode`` in interpret mode at the JAX test's shape, and
the model's einsum form where the TPU wrapper declines the shape. Tolerance
atol 2e-3, as tests/test_flash_attention.py:26 (f32 summation order; the bf16
caches hold the same rounded values on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.ops import flash_attention as jfa
from moe_infinity_tpu_torch.ops import flash_attention as fa

from torch_port_helpers import np32, one_intra_op_thread

ATOL = 2e-3


def _inputs(rng, B, H, R, P, S):
    return dict(
        q_lat=rng.normal(size=(B, H, R)).astype(np.float32),
        q_pe=rng.normal(size=(B, H, P)).astype(np.float32),
        c=rng.normal(size=(B, S, R)).astype(np.float32),
        kpe=rng.normal(size=(B, S, P)).astype(np.float32),
    )


def _oracle(a, pos, kv_len, scale, holes=None):
    """The JAX model's einsum form (deepseek_v2.py attention core, T = 1)."""
    c, kpe = jnp.asarray(a["c"]), jnp.asarray(a["kpe"])
    logits = (jnp.einsum("bhr,bsr->bhs", jnp.asarray(a["q_lat"]), c)
              + jnp.einsum("bhp,bsp->bhs", jnp.asarray(a["q_pe"]), kpe)) * scale
    key_pos = jnp.arange(c.shape[1])[None, None, :]
    valid = (key_pos <= jnp.asarray(pos)[:, None, None]) & (key_pos < kv_len)
    if holes is not None:
        valid = valid & jnp.asarray(holes)[:, None, :]
    logits = jnp.where(valid, logits, jnp.finfo(jnp.float32).min)
    return np.asarray(jnp.einsum("bhs,bsr->bhr", jax.nn.softmax(logits, axis=-1), c))


def _port(a, pos, kv_len, scale, holes=None, cache_dtype=torch.float32):
    return np32(fa.mla_flash_decode(
        torch.tensor(a["q_lat"]), torch.tensor(a["q_pe"]),
        torch.tensor(a["c"]).to(cache_dtype), torch.tensor(a["kpe"]).to(cache_dtype),
        torch.tensor(pos), kv_len, scale=scale,
        pad_mask=None if holes is None else torch.tensor(holes),
    ))


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("with_holes", [True, False])
def test_plain_matches_pallas_interpret(rng, cache, with_holes):
    """The JAX test's shape (tests/test_flash_attention.py:258): B 2, H 4,
    R 128, P 32, S 64, queries at positions 40 and 63."""
    B, H, R, P, S = 2, 4, 128, 32, 64
    a = _inputs(rng, B, H, R, P, S)
    pos = np.array([40, 63], np.int32)
    holes = rng.random((B, S)) > 0.2 if with_holes else None
    scale = (R + P) ** -0.5
    jdt, tdt = (jnp.float32, torch.float32) if cache == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jfa.mla_flash_decode(
        jnp.asarray(a["q_lat"]), jnp.asarray(a["q_pe"]), jnp.asarray(a["c"], jdt),
        jnp.asarray(a["kpe"], jdt), jnp.asarray(pos), jnp.int32(S), scale=scale,
        pad_mask=None if holes is None else jnp.asarray(holes), interpret=True,
    )
    assert want is not None  # the TPU wrapper took the shape
    got = _port(a, pos, S, scale, holes, tdt)
    assert got.shape == (B, H, R) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("B,H,R,P,S,kv_len,pos", [
    (2, 4, 128, 32, 64, 64, (40, 63)),  # the JAX test's shape
    (3, 2, 16, 8, 50, 50, (0, 23, 49)),  # S no power of two divides; R 16
    (2, 16, 64, 16, 37, 20, (36, 5)),  # kv_len below a query's position
    (1, 3, 32, 64, 7, 9, (6,)),  # kv_len past S
])
def test_plain_matches_einsum_oracle(rng, B, H, R, P, S, kv_len, pos):
    """Any S, R and P on the CPU; where no power-of-two tile divides S the
    TPU wrapper returns None and the JAX model takes exactly this einsum."""
    a = _inputs(rng, B, H, R, P, S)
    pos = np.array(pos, np.int32)
    holes = rng.random((B, S)) > 0.2
    holes[:, 0] = True  # every row keeps a valid key
    got = _port(a, pos, kv_len, 0.37, holes)
    np.testing.assert_allclose(got, _oracle(a, pos, kv_len, 0.37, holes), atol=ATOL)
    if S == 50:
        assert jfa.mla_flash_decode(
            *(jnp.asarray(a[k]) for k in ("q_lat", "q_pe", "c", "kpe")),
            jnp.asarray(pos), jnp.int32(kv_len), scale=0.37, interpret=True) is None


def test_row_without_valid_key_returns_zero(rng):
    """Row 0's mask is empty: K5 gives 0 there (the einsum form averages the
    latent), and NaN in keys that are not valid never reaches the result."""
    B, H, R, P, S = 2, 4, 32, 8, 24
    a = _inputs(rng, B, H, R, P, S)
    pos = np.array([10, 15], np.int32)
    holes = np.ones((B, S), bool)
    holes[0] = False
    holes[1, 3] = False
    a["c"][1, 3] = np.nan  # a masked key
    a["c"][1, 16:] = np.nan  # past the row's live length
    a["kpe"][1, 16:] = np.inf
    got = _port(a, pos, S, 1.0, holes)
    assert np.all(got[0] == 0.0) and np.all(np.isfinite(got))
    a["c"] = np.nan_to_num(a["c"])
    a["kpe"] = np.nan_to_num(a["kpe"], posinf=0.0)
    np.testing.assert_allclose(got[1], _oracle(a, pos, S, 1.0, holes)[1], atol=ATOL)


def test_zero_live_keys_returns_zero(rng):
    a = _inputs(rng, 2, 2, 16, 8, 12)
    got = _port(a, np.array([3, 4], np.int32), 0, 1.0)
    assert got.shape == (2, 2, 16) and np.all(got == 0.0)


def test_p_stays_f32_with_bf16_caches(rng):
    """K5 multiplies f32 p with the f32-cast latent (K2 rounds p to V's type):
    with bf16 caches the result equals the oracle on the rounded caches to
    f32 accuracy, far below a bf16 step of p."""
    B, H, R, P, S = 2, 4, 64, 16, 40
    a = _inputs(rng, B, H, R, P, S)
    pos = np.array([39, 20], np.int32)
    got = _port(a, pos, S, 0.2, cache_dtype=torch.bfloat16)
    rounded = dict(a, c=np32(torch.tensor(a["c"]).bfloat16()),
                   kpe=np32(torch.tensor(a["kpe"]).bfloat16()))
    np.testing.assert_allclose(got, _oracle(rounded, pos, S, 0.2), atol=2e-5)


@pytest.mark.parametrize("bad", ["q_pe", "c", "kpe", "dtype", "pos", "mask"])
def test_wrapper_rejects_malformed_inputs(bad):
    B, H, R, P, S = 2, 2, 16, 8, 12
    t = dict(q_lat=torch.zeros(B, H, R), q_pe=torch.zeros(B, H, P),
             c=torch.zeros(B, S, R), kpe=torch.zeros(B, S, P),
             pos=torch.zeros(B, dtype=torch.int32), mask=None)
    if bad == "q_pe":
        t["q_pe"] = torch.zeros(B, H + 1, P)
    elif bad == "c":
        t["c"] = torch.zeros(B, S, R + 1)
    elif bad == "kpe":
        t["kpe"] = torch.zeros(B, S + 1, P)
    elif bad == "dtype":
        t["kpe"] = t["kpe"].bfloat16()
    elif bad == "pos":
        t["pos"] = torch.zeros(B + 1, dtype=torch.int32)
    else:
        t["mask"] = torch.ones(B, S + 1, dtype=torch.bool)
    with pytest.raises((ValueError, RuntimeError)):
        fa.mla_flash_decode(t["q_lat"], t["q_pe"], t["c"], t["kpe"], t["pos"], S,
                            scale=1.0, pad_mask=t["mask"])


@pytest.mark.parametrize("R,P", [(640, 64), (1024, 64), (512, 128)])
def test_kernel_route_raises_on_a_width_it_does_not_take(R, P):
    """The CUDA route takes R a multiple of 128 up to 512 with P up to 64
    (test_torch_mla_widths) and raises for wider ones, before it builds or
    launches anything: there is no einsum to fall back on."""
    z = torch.zeros
    with pytest.raises(ValueError, match="queue 2 part 4's remainder"):
        fa._mla_cuda(z(1, 2, R), z(1, 2, P), z(1, 4, R), z(1, 4, P),
                     z(1, dtype=torch.int32), 4, scale=1.0, pad_mask=None)


@pytest.mark.parametrize("B,H,live,kc,ns", [
    (4, 16, 512, 64, 8),  # the batcher's decode step at V2-Lite: one cluster of 8
    (1, 16, 40, 64, 1),  # one request, short cache: one split
    (4, 128, 512, 128, 4),  # V2/V3 heads: 8 head groups, so longer splits
    (4, 16, 8192, 256, 32),  # long rows: four clusters of 8 a row
    (2, 16, 0, 32, 1),
])
def test_split_choice(B, H, live, kc, ns):
    got = fa._mla_splits(B, H, live)
    assert got == (kc, ns)
    assert got[0] % fa._MLA_TILE == 0 and got[0] * got[1] >= live


def test_counts_only_kernel_launches(rng):
    """A plain (CPU) run leaves the launch count alone, and launch_counts()
    lists K5."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    reset_launches()
    _port(_inputs(rng, 1, 2, 16, 8, 8), np.array([7], np.int32), 8, 1.0)
    assert launch_counts()["mla_flash_decode"] == 0
