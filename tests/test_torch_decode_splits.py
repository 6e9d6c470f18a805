"""The decode body that K1 (flash_decode), K4 (paged_flash_decode) and K2's
few-row route share on the card, as far as the CPU can see it: the split
planner, and a plain-PyTorch emulation of the kernel's algorithm (per split
and per 32-key slot an online softmax over 64-key tiles, the two slots merged,
then the splits merged) held against the plain versions that the parity
tests hold against the JAX kernels. Tolerance 1e-5 at f32: the emulation and
the plain version differ in summation order only."""

import numpy as np
import pytest
import torch

from moe_infinity_tpu_torch.models import layers
from moe_infinity_tpu_torch.ops import flash_attention as fa
from moe_infinity_tpu_torch.runtime.paged_kv import PagedKVCache

from torch_port_helpers import port_attention, one_intra_op_thread

TOL = 1e-5
TILE, SLOT = fa._DEC_TILE, 32


# ---- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("pairs,live,kc,ns", [
    (32, 512, 64, 8),  # Mixtral's decode step planned from the table's columns
    (32, 266, 64, 5),  # the same from the batcher's column bound
    (64, 17, 64, 1),  # NLLB's decode step: one split, no merge
    (64, 64, 64, 1),  # NLLB's cross-attention
    (32, 8192, 384, 22),  # long rows: larger splits
    (1, 100000, 128, 782),  # one pair: every block a split
    (6, 0, 64, 1),
    (0, 40, 64, 1),  # an empty batch plans like one pair
])
def test_split_choice(pairs, live, kc, ns):
    got = fa._decode_splits(pairs, live)
    assert got == (kc, ns)
    assert got[0] % TILE == 0 and got[0] * got[1] >= live  # whole tiles, all keys
    assert got[0] * (got[1] - 1) < max(live, 1)  # no split past the last live key
    if live > TILE * fa._DEC_BLOCKS // max(pairs, 1):  # enough keys to fill the card
        assert fa._DEC_BLOCKS // 2 < max(pairs, 1) * got[1] <= fa._DEC_BLOCKS


@pytest.mark.parametrize("live", [1, 63, 64, 65, 700, 5000])
def test_splits_cover_every_live_key_once(live):
    kc, ns = fa._decode_splits(6, live)
    covered = np.zeros(live, int)
    for s in range(ns):
        covered[s * kc:min((s + 1) * kc, live)] += 1
    assert (covered == 1).all()


# ---- the kernel's algorithm in plain PyTorch -----------------------------------

def _emulate(q, k, v, row_len, *, scale, mask=None, bias=None, pos=None,
             round_p=False, softcap=None, plan=None):
    """q [B, Tq, H, Dh], k/v [B, S, Hkv, Dh] f32, row_len [B] live keys,
    mask [B, S] bool, bias broadcastable to [B, H, Tq, S], pos [B, Tq] per-row
    causal positions (None: no causal mask). Returns [B, Tq, H, Dh] and the
    number of splits that found no valid key."""
    B, Tq, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kc, NS = plan or fa._decode_splits(B * Hkv, int(max(row_len)))
    out = torch.zeros_like(q)
    empty_splits = 0
    if bias is not None:
        bias = bias.float().expand(B, H, Tq, S)
    for b in range(B):
        n = int(row_len[b])
        live = min(NS, max(1, -(-n // kc)))
        for hk in range(Hkv):
            for t in range(Tq):
                for r in range(rep):
                    h = hk * rep + r
                    parts = []
                    for split in range(live):
                        lo = split * kc
                        hi = n if split == NS - 1 else min(lo + kc, n)
                        state = [(-1e30, 0.0, torch.zeros(Dh)) for _ in range(TILE // SLOT)]
                        for t0 in range(lo, hi, TILE):
                            for slot in range(TILE // SLOT):
                                if t0 + slot * SLOT >= hi:
                                    continue
                                keys = torch.arange(t0 + slot * SLOT,
                                                    min(t0 + (slot + 1) * SLOT, hi))
                                ok = torch.ones(len(keys), dtype=torch.bool)
                                if mask is not None:
                                    ok &= mask[b, keys]
                                if not ok.any():
                                    continue  # the slot holds no valid key
                                kk = torch.where(ok[:, None], k[b, keys, hk], 0.0)  # zero-filled
                                vv = torch.where(ok[:, None], v[b, keys, hk], 0.0)
                                x = (kk @ q[b, t, h]) * scale
                                if softcap is not None:
                                    x = torch.tanh(x / softcap) * softcap
                                valid = ok.clone()
                                if pos is not None:
                                    valid &= keys <= int(pos[b, t])
                                if bias is not None:
                                    x = torch.where(valid, x + bias[b, h, t, keys], x)
                                x = torch.where(valid, x, -1e30)
                                m, l, acc = state[slot]
                                mn = max(m, float(x.max()))
                                alpha = float(np.exp(np.float32(m - mn)))
                                p = torch.where(valid, torch.exp(x - mn), 0.0)
                                pb = p.to(torch.bfloat16).float() if round_p else p
                                state[slot] = (mn, l * alpha + float(p.sum()),
                                               acc * alpha + pb @ vv)
                        (m0, l0, a0), (m1, l1, a1) = state
                        M = max(m0, m1)
                        c0, c1 = np.exp(np.float32(m0 - M)), np.exp(np.float32(m1 - M))
                        parts.append((M, l0 * c0 + l1 * c1, a0 * float(c0) + a1 * float(c1)))
                        empty_splits += int(l0 == 0.0 and l1 == 0.0)
                    M = max(p[0] for p in parts)
                    L = sum(p[1] * float(np.exp(np.float32(p[0] - M))) for p in parts)
                    A = sum(p[2] * float(np.exp(np.float32(p[0] - M))) for p in parts)
                    out[b, t, h] = A / L if L > 0 else 0.0
    return out, empty_splits


def _qkv(rng, B, T, H, Hkv, S, Dh=128):
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return f(B, T, H, Dh), f(B, S, Hkv, Dh), f(B, S, Hkv, Dh)


@pytest.mark.parametrize("rep", [1, 2, 4, 6, 7, 8])  # 6: Grok-1, 7: Arctic
def test_emulation_matches_flash_decode_plain(rng, rep):
    """K1: a row of 0 live keys beside long ones, a live length that is no
    multiple of the tile, a split that lies wholly in holes, a softcap."""
    B, Hkv, S = 3, 2, 400
    q, k, v = _qkv(rng, B, 1, Hkv * rep, Hkv, S)
    pos = torch.tensor([[-1], [332], [399]], dtype=torch.int32)  # 0, 333, 390 live keys
    kv_len = 390
    mask = torch.tensor(rng.random((B, S)) > 0.2)
    mask[2, 128:256] = False  # splits 2 and 3 of row 2 hold holes only
    plan = fa._decode_splits(B * Hkv, kv_len)
    assert plan == (64, 7)
    want = fa.flash_decode_plain(q[:, 0], k, v, pos[:, 0], kv_len, scale=0.09,
                                 logit_softcap=20.0, pad_mask=mask)
    row_len = torch.clamp(pos[:, 0] + 1, max=kv_len)
    got, empty = _emulate(q, k, v, row_len, scale=0.09, mask=mask, softcap=20.0, plan=plan)
    assert empty >= 2 * Hkv * rep + Hkv * rep  # row 2's two splits, row 0's one
    assert bool((got[0] == 0).all()) and bool((want[0] == 0).all())
    torch.testing.assert_close(got[:, 0], want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("holes", [False, True])
def test_emulation_matches_paged_flash_decode_plain(rng, holes):
    """K4: the same algorithm over the rows' pages, lengths in place of
    positions; NaN in a hole or past a row's length never reaches the sum."""
    B, H, Hkv, Dh, page, P, NP = 3, 8, 2, 128, 8, 40, 130
    S = P * page
    q = torch.tensor(rng.normal(size=(B, H, Dh)).astype(np.float32))
    pk = torch.tensor(rng.normal(size=(NP, page, Hkv, Dh)).astype(np.float32))
    pv = torch.tensor(rng.normal(size=(NP, page, Hkv, Dh)).astype(np.float32))
    table = torch.tensor(rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32))
    lengths = torch.tensor([0, 320, 203], dtype=torch.int32)
    mask = torch.tensor(rng.random((B, S)) > 0.25) if holes else None
    k = pk[table.long()].reshape(B, S, Hkv, Dh).clone()
    v = pv[table.long()].reshape(B, S, Hkv, Dh).clone()
    for b in range(B):  # what no kernel may read
        k[b, int(lengths[b]):] = float("nan")
        v[b, int(lengths[b]):] = float("nan")
    if holes:
        k[~mask] = float("nan")
        v[~mask] = float("nan")
    want = fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=mask)
    got, _ = _emulate(q[:, None], k, v, lengths, scale=Dh ** -0.5, mask=mask)
    assert bool(torch.isfinite(got).all()) and bool((got[0] == 0).all())
    torch.testing.assert_close(got[:, 0], want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,bias_shape,causal", [
    (1, "B11S", False),  # NLLB's cross-attention
    (1, "1H1S", False),
    (2, "BHTS", True),  # 8 query rows per kv head, per-row causal positions
    (2, "11TS", False),
    (1, None, True),
])
def test_emulation_matches_flash_attend_plain(rng, T, bias_shape, causal):
    """K2's few-row route: the decode body with a bias added for valid keys
    after the softcap, per-row positions and p rounded to V's type (bf16
    values in f32 tensors, so that the rounding is the only bf16 step)."""
    B, H, Hkv, S, kv_len = 2, 8, 2, 300, 280
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(rng, B, T, H, Hkv, S))
    pos = (200 + torch.arange(T, dtype=torch.int32)).expand(B, T).contiguous()
    shape = {"B11S": (B, 1, 1, S), "1H1S": (1, H, 1, S), "BHTS": (B, H, T, S),
             "11TS": (1, 1, T, S), None: None}[bias_shape]
    bias = torch.tensor(rng.normal(size=shape).astype(np.float32)) if shape else None
    mask = torch.tensor(rng.random((B, S)) > 0.2)
    mask[1] = False  # a row with no valid key
    want = fa.flash_attend_plain(q, k, v, pos, kv_len, scale=0.09, causal=causal,
                                 logit_softcap=25.0, bias=bias, pad_mask=mask).float()
    row_len = torch.full((B,), kv_len)
    if causal:
        row_len = torch.clamp(pos.max(1).values + 1, max=kv_len)
    got, _ = _emulate(q.float(), k.float(), v.float(), row_len, scale=0.09, mask=mask,
                      bias=bias, pos=pos if causal else None, round_p=True, softcap=25.0)
    assert bool((got[1] == 0).all()) and bool((want[1] == 0).all())
    # the plain version rounds its result to bf16; the emulation is held to
    # half a bf16 step of the largest output (2^-9 of about 1)
    torch.testing.assert_close(got, want, rtol=4e-3, atol=4e-3)
    got32, _ = _emulate(q.float(), k.float(), v.float(), row_len, scale=0.09, mask=mask,
                        bias=bias, pos=pos if causal else None, round_p=False, softcap=25.0)
    want32 = fa.flash_attend_plain(q.float(), k.float(), v.float(), pos, kv_len, scale=0.09,
                                   causal=causal, logit_softcap=25.0, bias=bias, pad_mask=mask)
    torch.testing.assert_close(got32, want32, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rep,softcap,scale", [(6, 30.0, 0.08838834764831845), (7, None, None)])
def test_emulation_at_grok_and_arctic_rep(rng, rep, softcap, scale):
    """K4 over pages and K2's few-row route at T = 1 with Grok-1's rep 6
    (its softcap 30 and score scale 0.0884) and Arctic's rep 7: 6 and 7
    query rows of a kv head share one pass."""
    B, Hkv, Dh, page, P, NP = 3, 2, 128, 8, 40, 130
    H, S = Hkv * rep, P * page
    scale = scale or Dh ** -0.5
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))  # noqa: E731
    q, pk, pv = f(B, H, Dh) * 2, f(NP, page, Hkv, Dh) * 2, f(NP, page, Hkv, Dh)
    table = torch.tensor(rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32))
    lengths = torch.tensor([1, 320, 203], dtype=torch.int32)
    mask = torch.tensor(rng.random((B, S)) > 0.1)
    want = fa.paged_flash_decode(q, pk, pv, table, lengths, scale=scale,
                                 logit_softcap=softcap, pad_mask=mask)
    k = pk[table.long()].reshape(B, S, Hkv, Dh)
    v = pv[table.long()].reshape(B, S, Hkv, Dh)
    got, _ = _emulate(q[:, None], k, v, lengths, scale=scale, mask=mask, softcap=softcap)
    torch.testing.assert_close(got[:, 0], want, rtol=TOL, atol=TOL)
    qb, kb, vb = q[:, None].bfloat16(), k.bfloat16(), v.bfloat16()
    pos = (lengths - 1).reshape(B, 1)
    want2 = fa.flash_attend_plain(qb, kb, vb, pos, S, scale=scale, causal=True,
                                  logit_softcap=softcap, bias=torch.zeros(B, 1, 1, S),
                                  pad_mask=mask).float()
    got2, _ = _emulate(qb.float(), kb.float(), vb.float(), lengths, scale=scale, mask=mask,
                       bias=torch.zeros(B, 1, 1, S), pos=pos, round_p=True, softcap=softcap)
    torch.testing.assert_close(got2, want2, rtol=4e-3, atol=4e-3)  # as the few-row test


def test_a_plan_that_is_too_small_still_covers_every_key(rng):
    """The last split takes whatever a bound below a row's length left over."""
    B, H, Hkv, S = 1, 2, 2, 300
    q, k, v = _qkv(rng, B, 1, H, Hkv, S)
    want = fa.flash_decode_plain(q[:, 0], k, v, torch.tensor([299]), S, scale=0.09)
    got, _ = _emulate(q, k, v, torch.tensor([300]), scale=0.09, plan=(64, 2))
    torch.testing.assert_close(got[:, 0], want, rtol=TOL, atol=TOL)


# ---- the wrappers ------------------------------------------------------------------

def test_attend_cache_hands_k4_its_column_bound(rng, monkeypatch):
    """attend_cache passes kv_len, an int it holds, as K4's max_len: the
    kernel's splits are planned without reading lengths on the host."""
    seen = {}

    def fake(q, pk, pv, table, lengths, **kw):
        seen.update(kw, lengths=lengths)
        return q

    monkeypatch.setattr(fa, "paged_flash_decode", fake)
    pool = torch.zeros(6, 8, 2, 128)
    kv = PagedKVCache(pool, pool.clone(), torch.zeros(2, 3, dtype=torch.int32))
    q = torch.zeros(2, 1, 4, 128)
    with port_attention("flash"):
        layers.attend_cache(q, kv, torch.tensor([[5], [20]], dtype=torch.int32), 17)
    assert seen["max_len"] == 17 and isinstance(seen["max_len"], int)
    assert seen["lengths"].tolist() == [6, 17]


def test_paged_flash_decode_takes_max_len_on_the_cpu(rng):
    B, H, Hkv, Dh, page, P, NP = 2, 4, 2, 128, 8, 4, 10
    q = torch.tensor(rng.normal(size=(B, H, Dh)).astype(np.float32))
    pk = torch.tensor(rng.normal(size=(NP, page, Hkv, Dh)).astype(np.float32))
    table = torch.tensor(rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32))
    lengths = torch.tensor([9, 30], dtype=torch.int32)
    a = fa.paged_flash_decode(q, pk, pk, table, lengths)
    b = fa.paged_flash_decode(q, pk, pk, table, lengths, max_len=30)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("T,rep,route", [(1, 1, "rows"), (1, 8, "rows"), (2, 4, "rows"),
                                         (3, 4, "tiles"), (16, 4, "tiles"), (9, 1, "tiles"),
                                         (1, 6, "rows"), (1, 7, "rows"), (2, 6, "tiles"),
                                         (2, 7, "tiles")])
def test_flash_attend_route_by_query_rows(monkeypatch, T, rep, route):
    """T * rep <= 8 query rows per kv head go to the decode body (with p
    rounded and the queries' own positions), more to the tiled kernels;
    either way the call is flash_attend's one launch. The launch itself is
    replaced: the routing runs on CPU tensors."""
    seen = []

    def rows(kind, name, q, k, v, **kw):
        seen.append(("rows", kind, name, kw["round_p"], kw["Tq"], kw["live_max"]))
        fa.LAUNCHES[name] += 1
        return q

    def tiles(stem, name, argtypes):
        seen.append(("tiles", name))
        return lambda *a: 0

    monkeypatch.setattr(fa, "_launch_rows", rows)
    monkeypatch.setattr(fa._build, "function", tiles)
    monkeypatch.setattr(fa._build, "stream_ptr", lambda dev: None)
    monkeypatch.setitem(fa.LAUNCHES, "flash_attend", 0)
    B, Hkv, S = 2, 2, 40
    q = torch.zeros(B, T, Hkv * rep, 128)
    k = torch.zeros(B, S, Hkv, 128)
    fa._attend_cuda(q, k, k, torch.zeros(B, T, dtype=torch.int32), 30, scale=1.0,
                    causal=True, logit_softcap=None, bias=None, pad_mask=None)
    assert fa.LAUNCHES["flash_attend"] == 1
    if route == "rows":
        assert seen == [("rows", fa._DEC_ATTEND, "flash_attend", True, T, 30)]
    else:
        assert seen == [("tiles", "mit_flash_attend")]


def test_bias_strides():
    B, H, T, S = 2, 4, 3, 10
    z = torch.zeros
    assert fa._bias_strides(None, B, H, T, S, "x") == (None, (0, 0, 0))
    assert fa._bias_strides(z(B, 1, 1, S), B, H, T, S, "x")[1] == (S, 0, 0)
    assert fa._bias_strides(z(1, H, 1, S), B, H, T, S, "x")[1] == (0, S, 0)
    assert fa._bias_strides(z(1, 1, T, S), B, H, T, S, "x")[1] == (0, 0, S)
    assert fa._bias_strides(z(B, H, T, S), B, H, T, S, "x")[1] == (H * T * S, T * S, S)
    got, _ = fa._bias_strides(z(B, 1, 1, S, dtype=torch.bfloat16), B, H, T, S, "x")
    assert got.dtype == torch.float32 and got.is_contiguous()
    for bad in (z(B, H, T, 1), z(3, 1, 1, S), z(B, H, S)):
        with pytest.raises(ValueError):
            fa._bias_strides(bad, B, H, T, S, "x")
