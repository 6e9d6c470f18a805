"""The port's attention (K1 flash_decode, K2 flash_attend, the einsum
oracle) against the JAX package. On the CPU the port's wrappers run their
plain versions; the JAX kernels run in interpret mode, as its own tests run
them. Tolerance 2e-3 at f32, the JAX suite's own for these kernels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.layers import attend_reference as j_attend_reference
from moe_infinity_tpu.ops import flash_attention as jfa
from moe_infinity_tpu_torch.models import layers
from moe_infinity_tpu_torch.ops import flash_attention as fa

from torch_port_helpers import np32, port_attention, one_intra_op_thread


@pytest.fixture(autouse=True)
def _interpret():
    prev = jfa._INTERPRET
    jfa.set_flash_interpret(True)
    yield
    jfa.set_flash_interpret(prev)


def _qkv(rng, B, T, H, Hkv, Dh, S):
    return (rng.normal(size=(B, T, H, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32))


DECODE_CASES = {
    "gqa_rep2": dict(B=3, H=8, Hkv=4, S=64, pos=[5, 31, 63], kv_len=64),
    "kv_len_below_S": dict(B=2, H=4, Hkv=2, S=32, pos=[20, 30], kv_len=17),
    "pad_mask": dict(B=2, H=4, Hkv=4, S=96, pos=[99, 70], kv_len=96, pad=True),
    "softcap": dict(B=1, H=2, Hkv=1, S=32, pos=[20], kv_len=32, softcap=50.0),
    "non_causal": dict(B=2, H=4, Hkv=2, S=32, pos=[0, 3], kv_len=24, causal=False),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_flash_decode_plain_matches_jax_kernel(rng, case):
    c = DECODE_CASES[case]
    B, H, Hkv, S, Dh = c["B"], c["H"], c["Hkv"], c["S"], 128
    q, k, v = _qkv(rng, B, 1, H, Hkv, Dh, S)
    pos = np.asarray(c["pos"], np.int32)[:, None]
    pad = (rng.random((B, S)) > 0.25) if c.get("pad") else None
    kw = dict(causal=c.get("causal", True), logit_softcap=c.get("softcap"))
    want = jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.int32(c["kv_len"]), pad_mask=None if pad is None else jnp.asarray(pad), **kw,
    )
    got = fa.flash_decode(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(pos),
        c["kv_len"], pad_mask=None if pad is None else torch.tensor(pad), **kw,
    )
    assert got.shape == (B, 1, H, Dh)
    np.testing.assert_allclose(np32(got), np.asarray(want), atol=2e-3)


def test_flash_decode_fully_masked_row_is_zero(rng):
    B, H, Hkv, S, Dh = 2, 4, 2, 32, 128
    q, k, v = _qkv(rng, B, 1, H, Hkv, Dh, S)
    pos = np.asarray([[10], [12]], np.int32)
    pad = np.ones((B, S), bool)
    pad[1] = False  # row 1 has no valid key
    want = np.asarray(jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.int32(S), pad_mask=jnp.asarray(pad),
    ))
    got = np32(fa.flash_decode(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(pos), S,
        pad_mask=torch.tensor(pad),
    ))
    assert np.all(want[1] == 0) and np.all(got[1] == 0)
    np.testing.assert_allclose(got, want, atol=2e-3)


ATTEND_CASES = {
    "causal_gqa": dict(B=2, T=20, H=8, Hkv=2, S=48, kv_len=20, causal=True),
    "pad_bias_B11S": dict(B=2, T=12, H=4, Hkv=4, S=12, kv_len=12, causal=False, bias="pad"),
    "bias_1HTS_and_mask": dict(B=2, T=12, H=4, Hkv=4, S=16, kv_len=14, causal=False,
                               bias="1HTS", pad=True),
    "causal_offset_kv_len": dict(B=1, T=40, H=4, Hkv=4, S=160, kv_len=140,
                                 causal=True, offset=100),
    "cross_T1_pad_bias": dict(B=4, T=1, H=4, Hkv=4, S=24, kv_len=24, causal=False,
                              bias="pad"),
    "softcap_causal_bias": dict(B=1, T=8, H=2, Hkv=2, S=8, kv_len=8, causal=True,
                                bias="1HTS", softcap=30.0),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_flash_attend_plain_matches_jax_kernel(rng, case):
    c = ATTEND_CASES[case]
    B, T, H, Hkv, S, Dh = c["B"], c["T"], c["H"], c["Hkv"], c["S"], 128
    q, k, v = _qkv(rng, B, T, H, Hkv, Dh, S)
    pos = (c.get("offset", 0) + np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))).copy()
    bias = None
    if c.get("bias") == "pad":
        bias = np.where(rng.random((B, 1, 1, S)) > 0.3, 0.0,
                        np.finfo(np.float32).min).astype(np.float32)
        bias[:, :, :, 0] = 0.0  # every row keeps a key
    elif c.get("bias") == "1HTS":
        bias = rng.normal(size=(1, H, T, S)).astype(np.float32)
    pad = (rng.random((B, S)) > 0.3) if c.get("pad") else None
    kw = dict(causal=c["causal"], logit_softcap=c.get("softcap"))
    want = jfa.flash_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.int32(c["kv_len"]),
        bias=None if bias is None else jnp.asarray(bias),
        pad_mask=None if pad is None else jnp.asarray(pad), **kw,
    )
    got = fa.flash_attend(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(pos),
        c["kv_len"], bias=None if bias is None else torch.tensor(bias),
        pad_mask=None if pad is None else torch.tensor(pad), **kw,
    )
    np.testing.assert_allclose(np32(got), np.asarray(want), atol=2e-3)


def test_flash_attend_plain_bf16_rounds_p_like_the_kernel(rng):
    B, T, H, Hkv, S, Dh = 2, 16, 4, 2, 32, 128
    q, k, v = _qkv(rng, B, T, H, Hkv, Dh, S)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    want = jfa.flash_attend(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos), jnp.int32(T),
    )
    got = fa.flash_attend(
        torch.tensor(q).bfloat16(), torch.tensor(k).bfloat16(),
        torch.tensor(v).bfloat16(), torch.tensor(pos), T,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("bias", [False, True])
def test_attend_reference_matches_jax_oracle(rng, bias):
    B, T, H, Hkv, Dh, S = 2, 6, 4, 2, 32, 16
    q, k, v = _qkv(rng, B, T, H, Hkv, Dh, S)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    b = rng.normal(size=(1, H, T, S)).astype(np.float32) if bias else None
    pad = rng.random((B, S)) > 0.2
    want = j_attend_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.int32(10),
        bias=None if b is None else jnp.asarray(b), pad_mask=jnp.asarray(pad),
    )
    got = layers.attend_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(pos), 10,
        bias=None if b is None else torch.tensor(b), pad_mask=torch.tensor(pad),
    )
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attend_routes_to_k1_and_k2(rng, monkeypatch):
    """attend: T == 1 without a bias goes to flash_decode, everything else to
    flash_attend; "naive" goes to the oracle."""
    calls = []
    monkeypatch.setattr(fa, "flash_decode",
                        lambda *a, **k: calls.append("decode") or a[0])
    monkeypatch.setattr(fa, "flash_attend",
                        lambda *a, **k: calls.append("attend") or a[0])
    q, k, v = (torch.tensor(a) for a in _qkv(rng, 1, 1, 2, 2, 128, 8))
    pos = torch.zeros(1, 1, dtype=torch.int32)
    layers.attend(q, k, v, pos, 1)
    layers.attend(q, k, v, pos, 1, bias=torch.zeros(1, 1, 1, 8), causal=False)
    layers.attend(q.expand(1, 3, 2, 128), k, v, pos.expand(1, 3), 3)
    assert calls == ["decode", "attend", "attend"]
    with port_attention("naive"):
        out = layers.attend(q, k, v, pos, 1)
    assert calls == ["decode", "attend", "attend"] and out.shape == q.shape


@pytest.mark.parametrize("what", ["head_dim_64", "head_dim_96", "rep_16", "dtype_mismatch",
                                  "head_dim_320", "h_not_multiple"])
def test_kernel_wrappers_reject_shapes_they_do_not_take(what, monkeypatch):
    """The CUDA path raises on a shape the kernel does not take (it never
    hands back None for an oracle to cover): a head dim above 256, H not a
    multiple of Hkv, q/k/v of two dtypes; the checks run before any launch,
    so CPU tensors show them. Every head dim up to 256 (64 on its own
    instance, 96 on the padded one) and every rep (16 here) pass the checks
    and reach the launch, which is replaced here."""
    B, S = 1, 8
    H, Hkv, Dh = {"head_dim_64": (2, 2, 64), "head_dim_96": (2, 2, 96), "rep_16": (16, 1, 128),
                  "dtype_mismatch": (2, 2, 128), "head_dim_320": (2, 2, 320),
                  "h_not_multiple": (6, 4, 128)}[what]
    q = torch.zeros(B, H, Dh)
    k = torch.zeros(B, S, Hkv, Dh, dtype=torch.bfloat16 if what == "dtype_mismatch" else torch.float32)

    class Launched(Exception):
        pass

    def launch(*a):
        raise Launched

    monkeypatch.setattr(fa._build, "function", lambda stem, name, argtypes: launch)
    monkeypatch.setattr(fa._build, "stream_ptr", lambda dev: None)
    raises = Launched if what in ("head_dim_64", "head_dim_96", "rep_16") else ValueError
    with pytest.raises(raises):
        fa._decode_cuda(q, k, k, torch.zeros(B, dtype=torch.int32), S, scale=1.0,
                        causal=True, logit_softcap=None, pad_mask=None)
    with pytest.raises(raises):
        fa._attend_cuda(q[:, None], k, k, torch.zeros(B, 1, dtype=torch.int32), S,
                        scale=1.0, causal=True, logit_softcap=None, bias=None,
                        pad_mask=None)
