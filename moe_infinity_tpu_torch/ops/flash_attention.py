"""Flash attention for the port: hand-written CUDA kernels and their plain
PyTorch versions.

* ``flash_decode`` (K1) replaces ``moe_infinity_tpu/ops/flash_attention.py``
  ``_decode_kernel``/``flash_decode``: one query token per row; all
  ``rep = H / Hkv`` query heads of a kv head share one pass over the live
  cache rows ``row_len = min(kv_len, q_pos + 1 if causal, S)``.
* ``flash_attend`` (K2) replaces ``_attend_kernel``/``flash_attend``: T >= 1
  queries, causal masking from absolute positions, keys >= kv_len masked,
  an additive f32 bias broadcasting over ``[B|1, H|1, T|1, S]``, softcap
  before the bias, an optional ``[B, S]`` key pad mask.
* ``paged_flash_decode`` (K4) replaces ``_paged_decode_kernel``/
  ``paged_flash_decode``: K1 over a page pool ``[NP, page, Hkv, Dh]`` read
  in place through a ``[B, P]`` page table, the first ``lengths[b]`` logical
  keys of each row live, an optional logical hole mask ``[B, P * page]``.
* ``mla_flash_decode`` (K5) replaces ``_mla_decode_kernel``/
  ``mla_flash_decode``: one query token of DeepSeek's absorbed MLA. Scores
  are ``(q_lat . c + q_pe . k_pe) * scale`` over the shared latent cache
  ``c [B, S, R]`` and rope-key cache ``k_pe [B, S, P]``, the values are the
  latent itself, and one key stream serves all H heads; q and the result
  are f32 whatever the cache type.

What bounds the kernels (``csrc/flash_attention.cuh``, ``.cu``) on the H100,
and what their design does about it: a decode step moves the live K/V rows once and
does 4 operations per byte, so bytes bound it, and at the serving paths'
sizes those bytes take under a microsecond: what is left is a launch and
every dependent trip to device memory. K1, K4 and K2 with at most 8 query
rows per kv head (NLLB's cross-attention) share one decode body: the keys of
a (batch row, kv head) are split over blocks (``_decode_splits`` plans whole
64-key tiles for about six blocks per SM from an integer the caller holds,
never from ``lengths``, which would be a host read per layer), a block
starts a whole tile's loads at once, and the last split of a row to finish
merges them all; a plan of one split writes the result itself. K2 with more
rows runs both products on the tensor cores for bf16 (``mma.sync``) and in
full f32 on the CUDA cores for f32. K5 is one launch of the same shape:
whole 32-key tiles split over blocks (``_mla_splits``) that form clusters
of up to 8 (``_mla_cluster``), both products on the tensor cores for bf16
caches with q and p split into bf16 halves to keep f32 precision; a
cluster merges its splits in shared memory in split order, and a row of
several clusters merges theirs in order through scratch and tickets from
``_build.workspace``/``_build.tickets``. One call counts one launch
whatever it runs.

The wrappers launch the kernel for CUDA tensors (raising on a shape it does
not take) and run the plain version for CPU tensors. K1, K2 and K4 take any
head dim from 1 to 256 and any ``rep = H / Hkv``: head dims 64 and 128 have
instances of their own (``csrc/flash_attention.cu``), every other dim runs a
zero-padded instance of width 128 (below 128) or 256
(``csrc/flash_attention_pad128.cu``, ``pad256.cu``) that reads only the true dh columns of a
row, so bytes bound it as they bound the others; never a padded copy of the
cache. A kv head with more than 8 query rows is split over
``ceil(rows / 8)`` blocks of the decode body. K5 takes R 512 with P 64 on
its own instance (``csrc/flash_attention.cu``, the templates in ``mla.cuh``)
and every other R that is a multiple of 128 up to 512 with every P from 1 to
64 on a zero-padded instance of the same layout (``csrc/mla_pad.cu``, a
library of its own) that reads only the live columns, at any S and H. R not
a multiple of 128 is not taken, as the JAX kernel declines it: the model
decides that from the shape and takes its einsum (``models/deepseek_v2.py``);
nothing here falls back. The plain
versions repeat the kernels' arithmetic, including what differs from the
einsum oracle ``models.layers.attend_reference``: a row with no valid key
returns 0, and ``flash_attend`` rounds p to V's dtype before the P.V product
(the decode kernels, K5 among them, keep p in f32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from moe_infinity_tpu_torch.ops import _build

_NEG = -1e30  # finite -inf stand-in, as in the kernels

# launches of each kernel since the last reset (plain runs never count); K1,
# K2 and K4 count their head-dim-64 and padded instances under their own
# names (``_instance``)
LAUNCHES = {"flash_decode": 0, "flash_attend": 0, "paged_flash_decode": 0,
            "mla_flash_decode": 0, "flash_decode_dh64": 0, "flash_attend_dh64": 0,
            "paged_flash_decode_dh64": 0, "flash_decode_pad128": 0,
            "flash_attend_pad128": 0, "paged_flash_decode_pad128": 0,
            "flash_decode_pad256": 0, "flash_attend_pad256": 0,
            "paged_flash_decode_pad256": 0, "mla_flash_decode_pad": 0}

_DTYPES = (torch.bfloat16, torch.float32)
_c = ctypes.c_void_p
_ROWS_ARGS = [ctypes.c_int] + [_c] * 9 + [ctypes.c_longlong] * 3 + [_c] * 3 + [
    ctypes.c_int
] * 13 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_int, _c]
_ATTEND_ARGS = [_c] * 5 + [ctypes.c_longlong] * 3 + [_c] * 2 + [
    ctypes.c_int
] * 7 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_int, _c]
_MAX_HEAD_DIM = 256  # kMaxHeadDim: the widest instance of K1, K2 and K4
_DEC_CONTIG, _DEC_PAGED, _DEC_ATTEND = 0, 1, 2  # DecKind in csrc/flash_attention.cuh
_DEC_TILE = 64  # kDecTile: keys per tile of the decode body
_DEC_ROWS = 8  # kDecMaxRows: query rows of one kv head a block of the decode body takes
_DEC_BLOCKS = 792  # blocks aimed at: six per SM of an H100, three resident at a time
_MLA_ARGS = [_c] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, _c]
_MLA_R, _MLA_P = 512, 64  # kMlaR, kMlaP in csrc/mla.cuh: the widest instance
_MLA_TILE, _MLA_HEADS = 32, 16  # kMlaTile, kMlaHeads
_MLA_BLOCKS = 132  # blocks aimed at: one per SM of an H100 (its shared memory holds one)
_MLA_MIN_TILES = 2  # 32-key tiles a split reads at least: one 64-key tile of the kernel
_MLA_CLUSTER = 8  # kMlaMaxCluster: blocks of a cluster that merge in shared memory


def _instance(head_dim: int):
    """(library stem, C-name suffix, launch-count suffix, width) of the
    instance of K1, K2 and K4 that takes ``head_dim``: its own at 64 and
    128, else the zero-padded one of width 128 (below 128) or 256."""
    if head_dim in (64, 128):
        return "flash_attention", "", "" if head_dim == 128 else "_dh64", head_dim
    width = 128 if head_dim < 128 else _MAX_HEAD_DIM
    return f"flash_attention_pad{width}", "_pad", f"_pad{width}", width


def _row_groups(nrows: int) -> int:
    """Blocks of the decode body along a kv head's ``nrows`` query rows."""
    return max(1, -(-nrows // _DEC_ROWS))


def _check_qkv(q, k, v, name):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"{name}: q/k/v must share dtype bf16 or f32")
    Dh = q.shape[-1]
    if not 1 <= Dh <= _MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: the kernels take head_dim 1 to {_MAX_HEAD_DIM}, got {Dh} (head dims "
            "above 256 are ROADMAP queue 2 part 3's remainder)")
    H, Hkv = q.shape[-2], k.shape[2]
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"{name}: H={H} is not a multiple of Hkv={Hkv}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        _build.check_aligned(f"{name} {n}", t)


def _mask_u8(pad_mask, B, S, name):
    if pad_mask is None:
        return None
    if tuple(pad_mask.shape) != (B, S):
        raise ValueError(f"{name}: pad_mask must be [B, S] = [{B}, {S}]")
    return pad_mask.to(torch.bool).contiguous()  # bool is one byte, 0 or 1


def _decode_splits(pairs: int, live_max: int):
    """(keys per split, splits) of the decode body for ``pairs`` (batch row,
    kv head) pairs whose rows hold at most ``live_max`` live keys: whole
    tiles, as many splits as bring all pairs to about ``_DEC_BLOCKS`` blocks,
    one split for a row of at most one tile per wanted block."""
    want = max(1, _DEC_BLOCKS // max(1, pairs))
    kc = max(1, -(-live_max // (want * _DEC_TILE))) * _DEC_TILE
    return kc, max(1, -(-live_max // kc))


def _bias_strides(bias, B, H, T, S, name):
    """(f32 contiguous bias, its B, H and T strides with 0 for a broadcast
    axis) for a bias [B|1, H|1, T|1, S]."""
    if bias is None:
        return None, (0, 0, 0)
    if bias.dim() != 4 or bias.shape[3] != S:
        raise ValueError(
            f"{name}: bias must be [B|1, H|1, T|1, S] (an S-broadcast "
            "bias is not taken)"
        )
    Bb, Hb, Tb, _ = bias.shape
    if Bb not in (1, B) or Hb not in (1, H) or Tb not in (1, T):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not broadcast")
    strides = (
        Hb * Tb * S if Bb > 1 else 0,
        Tb * S if Hb > 1 else 0,
        S if Tb > 1 else 0,
    )
    return bias.to(torch.float32).contiguous(), strides


def _launch_rows(kind, name, q, k, v, *, Tq, S, live_max, kv_len=0, causal=False,
                 qpos=None, lengths=None, table=None, P=0, page=0, mask=None,
                 bias=None, strides=(0, 0, 0), round_p=False, scale,
                 logit_softcap):
    """Launch the decode body on q [B, Tq, H, Dh] (or [B, H, Dh], Tq = 1)
    and return the result in q's shape. ``live_max`` bounds every row's live
    keys; the split plan comes from it alone."""
    B, H, Hkv, Dh = q.shape[0], q.shape[-2], k.shape[2], q.shape[-1]
    dev = _build.same_device(q, k, v, qpos, lengths, table, mask, bias)
    out = torch.empty_like(q)
    if B == 0:
        return out
    stem, sfx, count_sfx, width = _instance(Dh)
    G = _row_groups(Tq * (H // Hkv))
    kc, NS = _decode_splits(B * Hkv * G, max(0, live_max))
    part_acc = part_ml = tickets = None
    if NS > 1:  # each split's unnormalised sum and (m, l), for the merge
        n_rows = B * Hkv * NS * Tq * (H // Hkv)
        scratch = torch.empty(n_rows * (width + 2), dtype=torch.float32, device=dev)
        part_acc, part_ml = scratch[:n_rows * width], scratch[n_rows * width:]
        tickets = _build.tickets(dev, B * Hkv * G)
    fn = _build.function(stem, "mit_decode_rows" + sfx, _ROWS_ARGS)
    err = _build.launch(fn, dev,
        kind, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(qpos), _build.ptr(lengths), _build.ptr(table), _build.ptr(mask),
        _build.ptr(bias), *strides, _build.ptr(part_acc), _build.ptr(part_ml),
        _build.ptr(tickets),
        B, Tq, H, Hkv, S, P, page, kv_len, int(causal), int(round_p), kc, NS, G,
        scale, float(logit_softcap or 0.0), int(q.dtype == torch.bfloat16), Dh
    )
    _build.check(err, name)
    LAUNCHES[name + count_sfx] += 1
    return out


# ---------------------------------------------------------------------------
# K1: decode
# ---------------------------------------------------------------------------

def flash_decode(
    q: torch.Tensor,  # [B, 1, H, Dh]
    k_cache: torch.Tensor,  # [B, S, Hkv, Dh]
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,  # [B, 1] int
    kv_len: int,
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    logit_softcap: Optional[float] = None,
    pad_mask: Optional[torch.Tensor] = None,  # [B, S] True = valid key
) -> torch.Tensor:
    """One query token per row: returns [B, 1, H, Dh] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    fn = _decode_cuda if q.is_cuda else flash_decode_plain
    out = fn(
        q[:, 0], k_cache, v_cache, q_positions.reshape(-1), int(kv_len),
        scale=float(scale), causal=causal, logit_softcap=logit_softcap,
        pad_mask=pad_mask,
    )
    return out[:, None]


def _decode_cuda(q, k, v, q_positions, kv_len, *, scale, causal,
                 logit_softcap, pad_mask):
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError("flash_decode: k/v must be [B, S, Hkv, Dh]")
    _check_qkv(q, k, v, "flash_decode")
    qpos = q_positions.to(torch.int32).contiguous()
    if tuple(qpos.shape) != (B,):
        raise ValueError("flash_decode: q_positions must be [B, 1]")
    return _launch_rows(
        _DEC_CONTIG, "flash_decode", q, k, v, Tq=1, S=S,
        live_max=min(kv_len, S), kv_len=kv_len, causal=causal, qpos=qpos,
        mask=_mask_u8(pad_mask, B, S, "flash_decode"), scale=scale,
        logit_softcap=logit_softcap,
    )


def flash_decode_plain(q, k, v, q_positions, kv_len, *, scale, causal=True,
                       logit_softcap=None, pad_mask=None):
    """K1's arithmetic in PyTorch: f32 scores and p, zero for a row with no
    valid key. Like the kernel, which never loads a key past a row's live
    ones or under a hole, it lets nothing of such a key reach the sum, not
    even a NaN."""
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.float().reshape(B, Hkv, rep, Dh)
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k.float()) * scale
    if logit_softcap is not None:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    row_len = torch.full((B,), min(kv_len, S), dtype=torch.int64, device=q.device)
    if causal:
        row_len = torch.minimum(row_len, q_positions.reshape(B).long() + 1)
    valid = torch.arange(S, device=q.device)[None, :] < row_len[:, None]
    if pad_mask is not None:
        valid = valid & pad_mask.to(torch.bool)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, _NEG)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    vf = torch.where(valid[:, 0, 0, :, None, None], v.float(), 0.0)
    o = torch.einsum("bgrs,bsgd->bgrd", p, vf)
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return o.reshape(B, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# K2: general attention
# ---------------------------------------------------------------------------

def flash_attend(
    q: torch.Tensor,  # [B, T, H, Dh]
    k_cache: torch.Tensor,  # [B, S, Hkv, Dh]
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,  # [B, T] int
    kv_len: int,
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    logit_softcap: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,  # [B|1, H|1, T|1, S] additive
    pad_mask: Optional[torch.Tensor] = None,  # [B, S] True = valid key
) -> torch.Tensor:
    """Same contract as ``models.layers.attend``. Always K2 (the T == 1,
    bias-free case goes to ``flash_decode`` through ``attend``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    fn = _attend_cuda if q.is_cuda else flash_attend_plain
    return fn(
        q, k_cache, v_cache, q_positions, int(kv_len), scale=float(scale),
        causal=causal, logit_softcap=logit_softcap, bias=bias,
        pad_mask=pad_mask,
    )


def _attend_cuda(q, k, v, q_positions, kv_len, *, scale, causal,
                 logit_softcap, bias, pad_mask):
    B, T, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError("flash_attend: k/v must be [B, S, Hkv, Dh]")
    _check_qkv(q, k, v, "flash_attend")
    if T > 65535 * 16 or B > 65535:
        raise ValueError("flash_attend: grid too large")
    qpos = q_positions.to(torch.int32).contiguous()
    if tuple(qpos.shape) != (B, T):
        raise ValueError("flash_attend: q_positions must be [B, T]")
    bias, strides = _bias_strides(bias, B, H, T, S, "flash_attend")
    mask = _mask_u8(pad_mask, B, S, "flash_attend")
    if T * (H // Hkv) <= _DEC_ROWS:  # few query rows per kv head: the decode body
        return _launch_rows(
            _DEC_ATTEND, "flash_attend", q, k, v, Tq=T, S=S,
            live_max=min(kv_len, S), kv_len=kv_len, causal=causal, qpos=qpos,
            mask=mask, bias=bias, strides=strides, round_p=True, scale=scale,
            logit_softcap=logit_softcap,
        )
    dev = _build.same_device(q, k, v, qpos, bias, mask)
    out = torch.empty_like(q)
    if B == 0:
        return out
    stem, sfx, count_sfx, _ = _instance(Dh)
    fn = _build.function(stem, "mit_flash_attend" + sfx, _ATTEND_ARGS)
    err = _build.launch(fn, dev,
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(qpos),
        _build.ptr(bias), *strides, _build.ptr(mask), _build.ptr(out),
        B, T, H, Hkv, S, kv_len, int(causal), scale,
        float(logit_softcap or 0.0), int(q.dtype == torch.bfloat16), Dh
    )
    _build.check(err, "flash_attend")
    LAUNCHES["flash_attend" + count_sfx] += 1
    return out


def flash_attend_plain(q, k, v, q_positions, kv_len, *, scale, causal=True,
                       logit_softcap=None, bias=None, pad_mask=None):
    """K2's arithmetic in PyTorch: f32 scores, softcap then bias, zero for a
    row with no valid key, p rounded to V's dtype for the P.V product, V rows
    past kv_len zeroed."""
    B, T, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.float().reshape(B, T, Hkv, rep, Dh)
    s = torch.einsum("btgrd,bsgd->bgrts", qf, k.float()) * scale
    if logit_softcap is not None:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    if bias is not None:
        Bb, Hb, Tb, Sb = bias.shape
        b32 = bias.float()
        if Hb == 1:
            s = s + b32[:, :, None]
        else:
            s = s + b32.reshape(Bb, Hkv, rep, Tb, Sb)
    key = torch.arange(S, device=q.device)
    live = key < min(kv_len, S)  # [S]
    valid = live[None, None, :].expand(B, T, S)
    if causal:
        valid = valid & (key[None, None, :] <= q_positions.long()[:, :, None])
    if pad_mask is not None:
        valid = valid & pad_mask.to(torch.bool)[:, None, :]
    valid = valid[:, None, None]  # [B, 1, 1, T, S]
    s = torch.where(valid, s, _NEG)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    vf = torch.where(live[None, :, None, None], v.float(), 0.0)
    o = torch.einsum("bgrts,bsgd->bgrtd", p.to(v.dtype).float(), vf)
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# K4: decode over a paged pool
# ---------------------------------------------------------------------------

def paged_flash_decode(
    q: torch.Tensor,  # [B, H, Dh]
    pool_k: torch.Tensor,  # [NP, page, Hkv, Dh]
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] int physical page ids
    lengths: torch.Tensor,  # [B] int live keys per row (causality folded in)
    *,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    pad_mask: Optional[torch.Tensor] = None,  # [B, P * page] True = valid
    max_len: Optional[int] = None,  # a bound on lengths the caller holds
) -> torch.Tensor:
    """One query token per row over the pool's pages: returns [B, H, Dh] in
    q's dtype. Row b attends to its logical keys ``[0, lengths[b])`` (at
    most ``P * page``), key j read from page ``page_table[b, j // page]``,
    slot ``j % page``. ``max_len`` (default ``P * page``) sizes the kernel's
    key splits without reading ``lengths`` on the host; a bound that is too
    small costs time, not keys (the last split takes the rest)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return paged_flash_decode_plain(
            q, pool_k, pool_v, page_table, lengths, scale=float(scale),
            logit_softcap=logit_softcap, pad_mask=pad_mask)
    return _paged_cuda(q, pool_k, pool_v, page_table, lengths, scale=float(scale),
                       logit_softcap=logit_softcap, pad_mask=pad_mask,
                       max_len=max_len)


def _paged_cuda(q, pool_k, pool_v, page_table, lengths, *, scale,
                logit_softcap, pad_mask, max_len=None):
    B, H, Dh = q.shape
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape or pool_k.shape[3] != Dh:
        raise ValueError("paged_flash_decode: pools must be [NP, page, Hkv, Dh]")
    page = pool_k.shape[1]
    if page_table.dim() != 2 or page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_flash_decode: page_table must be [B, P], lengths [B]")
    P = page_table.shape[1]
    S = P * page
    _check_qkv(q, pool_k, pool_v, "paged_flash_decode")
    return _launch_rows(
        _DEC_PAGED, "paged_flash_decode", q, pool_k, pool_v, Tq=1, S=S,
        live_max=S if max_len is None else min(int(max_len), S),
        lengths=lengths.to(torch.int32).contiguous(),
        table=page_table.to(torch.int32).contiguous(), P=P, page=page,
        mask=_mask_u8(pad_mask, B, S, "paged_flash_decode"), scale=scale,
        logit_softcap=logit_softcap,
    )


def paged_flash_decode_plain(q, pool_k, pool_v, page_table, lengths, *, scale,
                             logit_softcap=None, pad_mask=None):
    """K4's arithmetic in PyTorch: gather the rows' pages into a contiguous
    view, then K1's plain arithmetic with ``lengths[b]`` live keys."""
    B = q.shape[0]
    P, page = page_table.shape[1], pool_k.shape[1]
    idx = page_table.long()
    k = pool_k[idx].reshape(B, P * page, *pool_k.shape[2:])
    v = pool_v[idx].reshape(B, P * page, *pool_v.shape[2:])
    # causal with q position lengths - 1 keeps exactly the first lengths keys
    return flash_decode_plain(
        q, k, v, lengths.long() - 1, P * page, scale=scale, causal=True,
        logit_softcap=logit_softcap, pad_mask=pad_mask,
    )


# ---------------------------------------------------------------------------
# K5: absorbed-MLA decode
# ---------------------------------------------------------------------------

def mla_flash_decode(
    q_lat: torch.Tensor,  # [B, H, R] absorbed latent query
    q_pe: torch.Tensor,  # [B, H, P] roped query
    c_cache: torch.Tensor,  # [B, S, R] compressed latent cache
    kpe_cache: torch.Tensor,  # [B, S, P] roped shared key cache
    q_positions: torch.Tensor,  # [B] int cache column of the query
    kv_len,  # valid cache entries: an int, or a 0-d device tensor
    *,
    scale: float,
    pad_mask: Optional[torch.Tensor] = None,  # [B, S] True = valid key
) -> torch.Tensor:
    """One query token per row of absorbed MLA: returns out_lat [B, H, R] f32
    (the caller applies w_uv or o_fold). Row b attends to the keys
    ``s < min(kv_len, q_positions[b] + 1, S)`` whose mask entry is set.

    A ``kv_len`` that is a 0-d tensor (the step of a CUDA graph or of
    ``decode_scan``, which changes on the device) is never read on the
    host: the split plan then comes from the cache's capacity S, and each
    row's live keys from ``q_positions`` alone (``min(q_pos + 1, S)``), as
    K1 takes them (``models.layers.attend_cache``). The splits wholly past a
    row's live keys read nothing and add nothing to its merge."""
    if isinstance(kv_len, torch.Tensor):
        kv_len = c_cache.shape[1]
    fn = _mla_cuda if q_lat.is_cuda else mla_flash_decode_plain
    return fn(q_lat, q_pe, c_cache, kpe_cache, q_positions.reshape(-1),
              int(kv_len), scale=float(scale), pad_mask=pad_mask)


def _mla_check(q_lat, q_pe, c, kpe, q_positions):
    B, H, R = q_lat.shape
    P = q_pe.shape[-1]
    if tuple(q_pe.shape) != (B, H, P):
        raise ValueError("mla_flash_decode: q_pe must be [B, H, P]")
    S = c.shape[1]
    if tuple(c.shape) != (B, S, R) or tuple(kpe.shape) != (B, S, P):
        raise ValueError("mla_flash_decode: caches must be [B, S, R] and [B, S, P]")
    if c.dtype != kpe.dtype or c.dtype not in _DTYPES:
        raise ValueError("mla_flash_decode: the caches must share dtype bf16 or f32")
    if q_positions.shape != (B,):
        raise ValueError("mla_flash_decode: q_positions must be [B]")
    return B, H, R, P, S


def _mla_splits(B: int, H: int, live_max: int):
    """(keys per split, splits) for rows of at most ``live_max`` live keys:
    whole 32-key tiles, at least ``_MLA_MIN_TILES`` a split (fewer only where
    the row has fewer), as many splits as bring all rows and 16-head groups
    to about ``_MLA_BLOCKS`` blocks."""
    tiles = -(-live_max // _MLA_TILE)
    want = max(1, _MLA_BLOCKS // (B * -(-H // _MLA_HEADS)))
    per = max(1, min(tiles, max(_MLA_MIN_TILES, -(-tiles // want))))
    return per * _MLA_TILE, max(1, -(-tiles // per))


def _mla_instance(R: int, P: int):
    """(library stem, C name, launch-count key) of K5's instance for latent
    width R and rope width P: its own at 512/64, else the padded one. Raises
    for widths no instance takes."""
    if R % 128 or R < 128 or P < 1:
        raise ValueError(
            f"mla_flash_decode: the kernel takes R a multiple of 128 and P >= 1, got R={R} "
            f"P={P} (the JAX kernel declines such R; the model takes its einsum)")
    if R > _MLA_R or P > _MLA_P:
        raise ValueError(
            f"mla_flash_decode: the kernel takes R up to {_MLA_R} and P up to {_MLA_P}, got "
            f"R={R} P={P} (wider instances are ROADMAP queue 2 part 4's remainder)")
    if (R, P) == (_MLA_R, _MLA_P):
        return "flash_attention", "mit_mla_flash_decode", "mla_flash_decode"
    return "mla_pad", "mit_mla_flash_decode_pad", "mla_flash_decode_pad"


def _mla_cluster(splits: int) -> int:
    """Blocks of a cluster for a plan of ``splits``: the power of two that
    holds them all, at most ``_MLA_CLUSTER``; the splits are padded to a
    multiple of it (a padded split owns no key)."""
    return min(_MLA_CLUSTER, 1 << (splits - 1).bit_length())


def _mla_cuda(q_lat, q_pe, c, kpe, q_positions, kv_len, *, scale, pad_mask):
    B, H, R, P, S = _mla_check(q_lat, q_pe, c, kpe, q_positions)
    stem, cname, count = _mla_instance(R, P)
    ql = q_lat.to(torch.float32).contiguous()
    qp = q_pe.to(torch.float32).contiguous()
    for n, t in (("q_lat", ql), ("q_pe", qp), ("c_cache", c), ("kpe_cache", kpe)):
        _build.check_aligned(f"mla_flash_decode {n}", t)
    qpos = q_positions.to(torch.int32).contiguous()
    mask = _mask_u8(pad_mask, B, S, "mla_flash_decode")
    dev = _build.same_device(ql, qp, c, kpe, qpos, mask)
    out = torch.empty(B, H, R, dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return out
    kc, NS = _mla_splits(B, H, max(0, min(kv_len, S)))
    CL = _mla_cluster(NS)
    NS = -(-NS // CL) * CL
    part_acc = part_ml = tickets = None
    if NS > CL:  # each cluster's combined state, for the merge across clusters
        n_acc, n_ml = B * (NS // CL) * H * R, B * NS * H * 2
        scratch = _build.workspace(dev, n_acc + n_ml)
        part_acc, part_ml = scratch[:n_acc], scratch[n_acc:n_acc + n_ml]
        tickets = _build.tickets(dev, B * -(-H // _MLA_HEADS) * CL)
    fn = _build.function(stem, cname, _MLA_ARGS)
    err = _build.launch(fn, dev,
        _build.ptr(ql), _build.ptr(qp), _build.ptr(c), _build.ptr(kpe),
        _build.ptr(qpos), _build.ptr(mask), _build.ptr(part_acc),
        _build.ptr(part_ml), _build.ptr(tickets), _build.ptr(out), B, H, S, R, P,
        kv_len, kc, NS, CL, scale, int(c.dtype == torch.bfloat16)
    )
    _build.check(err, "mla_flash_decode")
    LAUNCHES[count] += 1
    return out


def mla_flash_decode_plain(q_lat, q_pe, c, kpe, q_positions, kv_len, *, scale,
                           pad_mask=None):
    """K5's arithmetic in PyTorch at any R and P: f32 scores, p and sums (p
    is not rounded to the cache type), zero for a row with no valid key, and
    no use of a key that is not valid."""
    B, H, R, P, S = _mla_check(q_lat, q_pe, c, kpe, q_positions)
    cf = c.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), cf)
         + torch.einsum("bhp,bsp->bhs", q_pe.float(), kpe.float())) * scale
    row_len = torch.clamp(q_positions.long() + 1, max=min(kv_len, S))
    valid = torch.arange(S, device=c.device)[None, :] < row_len[:, None]
    if pad_mask is not None:
        valid = valid & pad_mask.to(torch.bool)
    vh = valid[:, None, :]
    s = torch.where(vh, s, _NEG)
    p = torch.where(vh, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhs,bsr->bhr", p, torch.where(valid[:, :, None], cf, 0.0))
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
