"""The port's paged KV cache (allocator, pools, K4 paged_flash_decode and
the attend_cache paged route) against the JAX package on the same numpy
inputs. On the CPU the port's K4 wrapper runs its plain version; the JAX
kernel runs in interpret mode, as its own tests run it. Tolerance 1e-5 at
f32 (summation order only) and 2e-2 at bf16 (the JAX suite's gmm
tolerance, tests/test_gmm.py:49)."""

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
from moe_infinity_tpu_torch.runtime.paged_kv import (
    PageAllocator,
    PagedKVCache,
    init_paged_caches,
)

from torch_port_helpers import np32, port_attention, one_intra_op_thread

PAGE = 8
F32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _interpret():
    prev_interp, prev_impl = jfa._INTERPRET, jlayers.get_attention_impl()
    jfa.set_flash_interpret(True)
    jlayers.set_attention_impl("flash")
    yield
    jfa.set_flash_interpret(prev_interp)
    jlayers.set_attention_impl(prev_impl)


# ---- allocator (mirrors tests/test_paged_kv.py::TestAllocator) -------------

def test_allocate_extend_release():
    a = PageAllocator(num_pages=10, page_size=PAGE)
    p1 = a.allocate("s1", 20)  # 3 pages
    assert len(p1) == 3 and a.free_pages == 7
    p1b = a.allocate("s1", 30)  # extend to 4
    assert len(p1b) == 4
    assert all(p1b[i] == p1[i] for i in p1)
    a.release("s1")
    assert a.free_pages == 10


def test_range_offset_allocation():
    """A request admitted at a late column holds pages only for its own
    column range."""
    a = PageAllocator(num_pages=5, page_size=PAGE)
    a.allocate("__null__", 1)  # reserve page 0 (batcher convention)
    pages = a.allocate("late", 40, start_token=24)  # cols 24..39: idx 3, 4
    assert sorted(pages) == [3, 4]
    assert a.free_pages == 2
    t = a.table(["late"], max_pages=5)
    assert (t[0, :3] == 0).all() and t[0, 3] != 0 and t[0, 4] != 0


def test_exhaustion():
    a = PageAllocator(num_pages=2, page_size=PAGE)
    a.allocate("s1", 16)
    with pytest.raises(RuntimeError, match="exhausted"):
        a.allocate("s2", 8)


def test_table():
    a = PageAllocator(num_pages=8, page_size=PAGE)
    a.allocate("x", 12)
    a.allocate("y", 4)
    t = a.table(["x", "y"], max_pages=4)
    assert t.shape == (2, 4) and t.dtype == np.int32
    assert len(set(t[0, :2]) | set(t[1, :1])) == 3  # distinct pages


# ---- pools -------------------------------------------------------------------

def _pools(rng, NP, Hkv, Dh, dtype=np.float32):
    return (rng.normal(size=(NP, PAGE, Hkv, Dh)).astype(dtype),
            rng.normal(size=(NP, PAGE, Hkv, Dh)).astype(dtype))


def _table(rng, B, P, NP):
    return np.stack([rng.permutation(NP)[:P] for _ in range(B)]).astype(np.int32)


@pytest.mark.parametrize("offset,T", [(0, 5), (13, 1), (6, 11)])
def test_update_and_views_match_jax(rng, offset, T):
    B, Hkv, Dh, NP, P = 2, 2, 16, 12, 4
    pk, pv = _pools(rng, NP, Hkv, Dh)
    table = _table(rng, B, P, NP)
    k_new = rng.normal(size=(B, T, Hkv, Dh)).astype(np.float32)
    v_new = rng.normal(size=(B, T, Hkv, Dh)).astype(np.float32)
    jkv = JPagedKVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table))
    jkv = jkv.update(jnp.asarray(k_new), jnp.asarray(v_new), offset)
    kv = PagedKVCache(torch.tensor(pk), torch.tensor(pv), torch.tensor(table))
    assert kv.update(torch.tensor(k_new), torch.tensor(v_new), offset) is kv
    assert kv.max_len == P * PAGE and kv.page_size == PAGE
    np.testing.assert_array_equal(np32(kv.pool_k), np.asarray(jkv.pool_k))
    np.testing.assert_array_equal(np32(kv.pool_v), np.asarray(jkv.pool_v))
    np.testing.assert_array_equal(np32(kv.k), np.asarray(jkv.k))
    np.testing.assert_array_equal(np32(kv.v), np.asarray(jkv.v))


def test_init_paged_caches():
    kvs = init_paged_caches(3, 10, PAGE, 2, 16, torch.bfloat16, 4, 5, device="cpu")
    assert len(kvs) == 3
    for kv in kvs:
        assert tuple(kv.pool_k.shape) == (10, PAGE, 2, 16)
        assert kv.pool_v.dtype == torch.bfloat16 and not bool(kv.pool_k.any())
        assert tuple(kv.page_table.shape) == (4, 5)
        assert kv.page_table.dtype == torch.int32
    assert kvs[0].pool_k.data_ptr() != kvs[1].pool_k.data_ptr()


# ---- K4 ----------------------------------------------------------------------

PAGED_CASES = {
    # B, H, Hkv, P, NP, lengths (a 0 row gives 0), holes
    "gqa_rep2": dict(B=2, H=4, Hkv=2, P=6, NP=32, lengths=[45, 17], holes=False),
    "rep4_holes": dict(B=3, H=8, Hkv=2, P=4, NP=16, lengths=[32, 20, 9], holes=True),
    "rep1_empty_row": dict(B=2, H=2, Hkv=2, P=3, NP=8, lengths=[0, 24], holes=True),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_flash_decode_plain_matches_jax_kernel(rng, case, dtype):
    c = PAGED_CASES[case]
    B, H, Hkv, P, NP, Dh = c["B"], c["H"], c["Hkv"], c["P"], c["NP"], 128
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    pk, pv = _pools(rng, NP, Hkv, Dh)
    table = _table(rng, B, P, NP)
    lengths = np.asarray(c["lengths"], np.int32)
    holes = rng.random((B, P * PAGE)) > 0.25 if c["holes"] else None
    jdt, tdt, tol = ((jnp.float32, torch.float32, F32_TOL) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    want = jfa.paged_flash_decode(
        jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
        jnp.asarray(table), jnp.asarray(lengths),
        pad_mask=None if holes is None else jnp.asarray(holes),
    )

    def t(a):
        return torch.tensor(a.astype(ml_dtypes.bfloat16).astype(np.float32)
                            if dtype == "bf16" else a).to(tdt)

    got = fa.paged_flash_decode(
        t(q), t(pk), t(pv), torch.tensor(table), torch.tensor(lengths),
        pad_mask=None if holes is None else torch.tensor(holes),
    )
    assert got.dtype == tdt and tuple(got.shape) == (B, H, Dh)
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)
    if 0 in c["lengths"]:
        assert not bool(got[c["lengths"].index(0)].any())


@pytest.mark.parametrize("holes", [False, True])
def test_attend_cache_paged_route_matches_jax(rng, holes):
    """The port's attend_cache sends a one-token causal step over a paged
    cache to K4 with min(kv_len, q_pos + 1) live keys; JAX's does the same
    through its kernel (mirrors tests/test_flash_attention.py:230)."""
    B, H, Hkv, Dh, P, NP = 2, 4, 2, 128, 4, 16
    S = P * PAGE
    pk, pv = _pools(rng, NP, Hkv, Dh)
    table = _table(rng, B, P, NP)
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    pos = np.asarray([[S - 1], [13]], np.int32)
    mask = rng.random((B, S)) > 0.25 if holes else None
    want = jlayers.attend_cache(
        jnp.asarray(q), JPagedKVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table)),
        jnp.asarray(pos), jnp.int32(S - 4),
        pad_mask=None if mask is None else jnp.asarray(mask),
    )
    kv = PagedKVCache(torch.tensor(pk), torch.tensor(pv), torch.tensor(table))
    fa.LAUNCHES["paged_flash_decode"] = 0
    with port_attention("flash"):
        got = layers.attend_cache(
            torch.tensor(q), kv, torch.tensor(pos), S - 4,
            pad_mask=None if mask is None else torch.tensor(mask),
        )
    assert fa.LAUNCHES["paged_flash_decode"] == 0  # plain runs never count
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_attend_cache_chunk_step_uses_gathered_view(rng):
    """A T > 1 step over a paged cache is attend() on the gathered view."""
    B, H, Hkv, Dh, P, NP, T = 2, 4, 2, 128, 4, 16, 5
    S = P * PAGE
    pk, pv = _pools(rng, NP, Hkv, Dh)
    kv = PagedKVCache(torch.tensor(pk), torch.tensor(pv),
                      torch.tensor(_table(rng, B, P, NP)))
    q = torch.tensor(rng.normal(size=(B, T, H, Dh)).astype(np.float32))
    pos = (10 + torch.arange(T, dtype=torch.int32)).expand(B, T)
    with port_attention("flash"):
        got = layers.attend_cache(q, kv, pos, 10 + T)
        want = layers.attend(q, kv.k, kv.v, pos, 10 + T)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("what", ["head_dim_64", "head_dim_96", "h_not_multiple", "rep_16",
                                  "mask_width", "head_dim_320"])
def test_paged_cuda_path_rejects_what_the_kernel_does_not_take(what, monkeypatch):
    """Checked before any launch, so CPU tensors show it; the wrapper never
    hands back None for a slower path to cover. Every head dim up to 256
    (64 on its own instance, 96 on the padded one) and every rep (16 here)
    reach the launch, which is replaced here; a head dim above 256 raises."""
    B, P, Dh, H, Hkv = 2, 3, 128, 8, 2
    if what.startswith("head_dim"):
        Dh = int(what[9:])
    elif what == "h_not_multiple":
        H = 6
        Hkv = 4
    elif what == "rep_16":
        H, Hkv = 32, 2
    q = torch.zeros(B, H, Dh)
    pool = torch.zeros(6, PAGE, Hkv, Dh)
    table = torch.zeros(B, P, dtype=torch.int32)
    lengths = torch.ones(B, dtype=torch.int32)
    width = P * PAGE - (1 if what == "mask_width" else 0)
    mask = torch.ones(B, width, dtype=torch.bool)

    class Launched(Exception):
        pass

    def launch(*a):
        raise Launched

    monkeypatch.setattr(fa._build, "function", lambda stem, name, argtypes: launch)
    monkeypatch.setattr(fa._build, "stream_ptr", lambda dev: None)
    with pytest.raises(Launched if what in ("head_dim_64", "head_dim_96", "rep_16")
                       else ValueError):
        fa._paged_cuda(q, pool, pool, table, lengths, scale=1.0,
                       logit_softcap=None, pad_mask=mask)
