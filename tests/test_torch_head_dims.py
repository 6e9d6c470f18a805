"""K1, K2 and K4 of the port at head dims other than 64 and 128 and at
rep = H / Hkv above 8, on the CPU.

* The plain versions against the JAX package on the same numpy inputs, where
  JAX's dispatch sends each shape: ``flash_attend`` (its decode kernel at a
  head dim that is a multiple of 128, its grid kernel at any other) for K1
  and K2, and ``attend_cache`` over a paged cache for K4 (its paged kernel
  at a multiple of 128, else ``attend`` on the gathered view), the JAX
  kernels in interpret mode as its own tests run them. Head dims 80
  (OPT-2.7B), 33 (odd), 200 and 256, rep 1 and 16. Tolerance 1e-5 at f32
  (summation order only) and 2e-2 at bf16 (the JAX suite's,
  tests/test_gmm.py:49).
* The wrappers' routing on CPU tensors with the launch replaced: which
  library and C function each head dim takes, the padded width of the
  split scratch, the row groups of the decode body's grid and the name its
  launch is counted under.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models import layers as jlayers
from moe_infinity_tpu.ops import flash_attention as jfa
from moe_infinity_tpu.runtime.paged_kv import PagedKVCache as JPagedKVCache
from moe_infinity_tpu_torch.models import layers
from moe_infinity_tpu_torch.ops import flash_attention as fa
from moe_infinity_tpu_torch.runtime.paged_kv import PagedKVCache

from torch_port_helpers import np32, one_intra_op_thread, port_attention  # noqa: F401

TOLS = {"f32": 1e-5, "bf16": 2e-2}
PAGE = 8


@pytest.fixture(autouse=True)
def _interpret():
    prev_interp, prev_impl = jfa._INTERPRET, jlayers.get_attention_impl()
    jfa.set_flash_interpret(True)
    jlayers.set_attention_impl("flash")
    yield
    jfa.set_flash_interpret(prev_interp)
    jlayers.set_attention_impl(prev_impl)


def _both(a, dtype):
    """The same values as a JAX array and a port tensor, in ``dtype``."""
    if dtype == "bf16":
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.tensor(a)


GEOMETRIES = {  # Dh, H, Hkv
    "dh80": (80, 4, 4),  # OPT-2.7B's head dim
    "dh33_odd": (33, 4, 2),
    "dh200": (200, 2, 2),
    "dh256_rep16": (256, 16, 1),
    "dh80_rep16": (80, 32, 2),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_k1_plain_matches_jax_dispatch(rng, geo, dtype):
    Dh, H, Hkv = GEOMETRIES[geo]
    B, S, kv_len = 3, 40, 36
    jq, q = _both(rng.normal(size=(B, 1, H, Dh)).astype(np.float32), dtype)
    jk, k = _both(rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32), dtype)
    jv, v = _both(rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32), dtype)
    pos = np.asarray([[35], [9], [20]], np.int32)
    pad = rng.random((B, S)) > 0.25
    want = jfa.flash_attend(jq, jk, jv, jnp.asarray(pos), jnp.int32(kv_len),
                            pad_mask=jnp.asarray(pad))
    got = fa.flash_decode(q, k, v, torch.tensor(pos), kv_len, pad_mask=torch.tensor(pad))
    assert got.dtype == q.dtype and tuple(got.shape) == (B, 1, H, Dh)
    tol = TOLS[dtype]
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_k2_plain_matches_jax_kernel(rng, geo, dtype):
    """T = 12 queries, causal, a per-head bias, softcap and a pad mask."""
    Dh, H, Hkv = GEOMETRIES[geo]
    B, T, S, kv_len = 2, 12, 32, 30
    jq, q = _both(rng.normal(size=(B, T, H, Dh)).astype(np.float32), dtype)
    jk, k = _both(rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32), dtype)
    jv, v = _both(rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32), dtype)
    pos = (15 + np.arange(T, dtype=np.int32))[None].repeat(B, 0)
    bias = rng.normal(size=(1, H, T, S)).astype(np.float32)
    pad = rng.random((B, S)) > 0.2
    kw = dict(causal=True, logit_softcap=20.0)
    want = jfa.flash_attend(jq, jk, jv, jnp.asarray(pos), jnp.int32(kv_len),
                            bias=jnp.asarray(bias), pad_mask=jnp.asarray(pad), **kw)
    got = fa.flash_attend(q, k, v, torch.tensor(pos), kv_len, bias=torch.tensor(bias),
                          pad_mask=torch.tensor(pad), **kw)
    tol = TOLS[dtype]
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_k4_plain_matches_jax_attend_cache(rng, geo, dtype):
    """A one-token causal step over a paged cache with holes: the port's
    attend_cache (K4's plain version) against JAX's, a row of no live key
    among them."""
    Dh, H, Hkv = GEOMETRIES[geo]
    B, P, NP = 3, 4, 16
    S = P * PAGE
    jpk, pk = _both(rng.normal(size=(NP, PAGE, Hkv, Dh)).astype(np.float32), dtype)
    jpv, pv = _both(rng.normal(size=(NP, PAGE, Hkv, Dh)).astype(np.float32), dtype)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    jq, q = _both(rng.normal(size=(B, 1, H, Dh)).astype(np.float32), dtype)
    pos = np.asarray([[S - 1], [-1], [13]], np.int32)
    mask = rng.random((B, S)) > 0.25
    want = jlayers.attend_cache(jq, JPagedKVCache(jpk, jpv, jnp.asarray(table)),
                                jnp.asarray(pos), jnp.int32(S - 3), pad_mask=jnp.asarray(mask))
    with port_attention("flash"):
        got = layers.attend_cache(q, PagedKVCache(pk, pv, torch.tensor(table)),
                                  torch.tensor(pos), S - 3, pad_mask=torch.tensor(mask))
    tol = TOLS[dtype]
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)
    assert not bool(got[1].any())


# ---- routing on CPU tensors, the launch replaced ------------------------------

ROUTES = [
    # kind, Dh, rep, T: library, C function, launch count, padded width, row groups
    ("decode", 80, 1, 1, "flash_attention_pad128", "mit_decode_rows_pad", "flash_decode_pad128",
     128, 1),
    ("decode", 33, 16, 1, "flash_attention_pad128", "mit_decode_rows_pad", "flash_decode_pad128",
     128, 2),
    ("decode", 128, 16, 1, "flash_attention", "mit_decode_rows", "flash_decode", 128, 2),
    ("decode", 1, 1, 1, "flash_attention_pad128", "mit_decode_rows_pad", "flash_decode_pad128",
     128, 1),
    ("paged", 200, 1, 1, "flash_attention_pad256", "mit_decode_rows_pad",
     "paged_flash_decode_pad256", 256, 1),
    ("paged", 64, 12, 1, "flash_attention", "mit_decode_rows", "paged_flash_decode_dh64", 64, 2),
    ("paged", 256, 24, 1, "flash_attention_pad256", "mit_decode_rows_pad",
     "paged_flash_decode_pad256", 256, 3),
    ("attend", 256, 4, 2, "flash_attention_pad256", "mit_decode_rows_pad", "flash_attend_pad256",
     256, 1),
    ("attend", 80, 1, 32, "flash_attention_pad128", "mit_flash_attend_pad", "flash_attend_pad128",
     None, None),
    ("attend", 80, 16, 1, "flash_attention_pad128", "mit_flash_attend_pad", "flash_attend_pad128",
     None, None),
    ("attend", 129, 2, 16, "flash_attention_pad256", "mit_flash_attend_pad", "flash_attend_pad256",
     None, None),
    ("attend", 128, 16, 1, "flash_attention", "mit_flash_attend", "flash_attend", None, None),
]


@pytest.mark.parametrize("kind,Dh,rep,T,stem,cname,count,width,G", ROUTES,
                         ids=[f"{r[0]}-dh{r[1]}-rep{r[2]}-T{r[3]}" for r in ROUTES])
def test_routing_by_head_dim_and_rep(monkeypatch, kind, Dh, rep, T, stem, cname, count,
                                     width, G):
    """Each shape's instance: the library and C function it launches, the
    width of the split scratch's rows (the pointer gap between the partial
    sums and the (m, l) pairs), the row groups of the decode body's grid
    (blocks of 8 query rows along y) and the tickets they take, and the
    launch count it adds to. Long rows (2,048 keys) plan several splits."""
    seen = {}

    def function(s, name, argtypes):
        seen["fn"] = (s, name)
        return name

    def launch(fn, dev, *args):
        seen["args"] = args
        return 0

    monkeypatch.setattr(fa._build, "function", function)
    monkeypatch.setattr(fa._build, "launch", launch)
    monkeypatch.setattr(fa._build, "tickets",
                        lambda dev, n: seen.setdefault("tickets", n) and torch.zeros(n))
    monkeypatch.setitem(fa.LAUNCHES, count, 0)
    B, Hkv, S = 2, 2, 2048
    H = Hkv * rep
    q = torch.zeros(B, T, H, Dh)
    k = torch.zeros(B, S, Hkv, Dh)
    if kind == "decode":
        fa._decode_cuda(q[:, 0], k, k, torch.full((B,), S - 1, dtype=torch.int32), S,
                        scale=1.0, causal=True, logit_softcap=None, pad_mask=None)
    elif kind == "paged":
        pool = torch.zeros(B * S // 16, 16, Hkv, Dh)
        table = torch.arange(B * S // 16, dtype=torch.int32).reshape(B, -1)
        fa._paged_cuda(q[:, 0], pool, pool, table, torch.full((B,), S, dtype=torch.int32),
                       scale=1.0, logit_softcap=None, pad_mask=None)
    else:
        fa._attend_cuda(q, k, k, torch.zeros(B, T, dtype=torch.int32), S, scale=1.0,
                        causal=False, logit_softcap=None, bias=None, pad_mask=None)
    assert seen["fn"] == (stem, cname)
    assert fa.LAUNCHES[count] == 1
    args = seen["args"]
    assert args[-1] == Dh  # the true head dim, the last argument
    if width is None:  # the tiled kernels: their grid is any rep's
        assert len(args) == len(fa._ATTEND_ARGS) - 1 and "tickets" not in seen
        return
    assert len(args) == len(fa._ROWS_ARGS) - 1  # all but the stream
    kc, NS, g_arg = args[26], args[27], args[28]
    assert g_arg == G == fa._row_groups(T * rep)
    assert (kc, NS) == fa._decode_splits(B * Hkv * G, S) and NS > 1
    part_acc, part_ml = args[13].value, args[14].value
    rows = B * Hkv * NS * T * rep
    assert (part_ml - part_acc) == rows * width * 4
    assert seen["tickets"] == B * Hkv * G
