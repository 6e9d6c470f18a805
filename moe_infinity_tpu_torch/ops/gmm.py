"""Grouped matmul (K3) with fused weight dequantization, and the grouped
expert FFN built on it.

``gmm`` replaces ``moe_infinity_tpu/ops/gmm.py`` ``_gmm_kernel``/``gmm``:
``out[T, F] = bf16(x[T, D]) @ bf16(w[group_ids[g] + group_offset])`` over
rows sorted by group, f32 accumulation, the per-output-channel ``scale``
after the sum. Weights are bf16, int8, float8_e4m3fn (every e4m3 value is a
bf16 value, so the products are the JAX kernel's ``bf16(x) x bf16(w)``) or
split-nibble packed int4 (``[S, D, F/2]`` int8; low nibbles are columns
``[0, F/2)``, high nibbles ``[F/2, F)``). ``w`` is flat ``[S, D, F]`` or
the JAX kernel's pre-tiled ``[S, F/tf, D, tf]`` (``pack_tiled``: slab ``fi``
holds columns ``[fi·tf, (fi+1)·tf)``), which the kernel reads in place with
the same products in the same order, so a tiled call is bit-equal to the
flat one; packed int4 is flat only, as in the JAX package. The kernel
(``csrc/gmm.cu``) should be bound by the routed experts' weight bytes: a block owns 128
stored columns of a chunk of up to
64 rows of one group, so a group of up to 64 rows reads its slab once;
64-deep k-tiles arrive by ``cp.async`` several stages ahead, int8, int4 and
e4m3 are converted to bf16 in shared memory, and the products run on the
tensor cores (``mma.sync``). bf16 calls are bound by their loads; int8, int4
and e4m3 calls by that conversion and the products (``PERF.md``).
Where the column tiles times the chunks leave the card short of blocks,
``_gmm_plan`` cuts the reduction into k-splits that the kernel merges in
split order in the same launch. For CUDA tensors the wrapper
launches it, for CPU tensors it runs ``gmm_plain``, which repeats its
arithmetic (x and w rounded to bf16, exact products, f32 sums).

``gffn_pallas`` replaces ``gffn_pallas`` of the JAX package: sort the
(token, k) rows by slot, compact the groups to the routed slots on the
device, gate gmm (and up gmm, or one fused gateup gmm whose output halves
are ``[gate | up]``), gate bias, activation, down gmm, down bias, and the
combine-weighted ``index_add_``. No host sync: the groups are compacted to
``min(E, T*K)`` (E: the layer's experts) and an empty one owns no work in
the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from moe_infinity_tpu_torch.ops import _build

# launches of the kernel since the last reset (plain runs never count); the
# e4m3 instance and calls on pre-tiled weights count under their own names.
# ``gmm_tiled`` counts every call on a 4-D weight, whatever its kind: the one
# tiled pool on a served path (DeepSeek's FusedRunner) is bf16, so its record
# and bound are bf16's; key it by kind too once a tiled e4m3 or int8 pool
# reaches a path
LAUNCHES = {"gmm": 0, "gmm_fp8": 0, "gmm_tiled": 0}

_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 3}  # WKind in csrc/gmm.cu
_INT4 = 2
_c = ctypes.c_void_p
_GMM_ARGS = [_c] * 7 + [ctypes.c_int] * 11 + [_c, _c]
# kBM, kBN and kBK in csrc/gmm.cu: a block owns one chunk of up to 64 rows of
# a group and 128 stored columns, and walks the reduction in 64-deep k-tiles
_ROWS_PER_CHUNK = 64
_TILE_COLS = 128
_K_TILE = 64
_GMM_BLOCKS = 264  # blocks a call should bring: two per SM of the H100's 132
_GMM_MIN_KTILES = 4  # k-tiles of a split at the least
_TILED_TF_CAP = 512  # pack_tiled's widest slab


def _largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap and a multiple of 128, else any
    divisor <= cap: the JAX package's slab-width rule (ops/gmm.py)."""
    for c in range(min(n, cap) // 128 * 128, 0, -128):
        if n % c == 0:
            return c
    for c in range(min(n, cap), 0, -1):
        if n % c == 0:
            return c
    return n


def tiled_view(w: torch.Tensor, tf: int = 0) -> torch.Tensor:
    """[S, D, F] viewed as the pre-tiled [S, F/tf, D, tf] (slab fi holds
    columns [fi·tf, (fi+1)·tf)), not copied; tf defaults to the JAX
    package's rule, the largest divisor of F up to 512."""
    S, D, F = w.shape
    if tf == 0:
        tf = _largest_divisor_leq(F, _TILED_TF_CAP)
    return w.reshape(S, D, F // tf, tf).permute(0, 2, 1, 3)


def pack_tiled(w: torch.Tensor, tf: int = 0) -> torch.Tensor:
    """[S, D, F] -> the pre-tiled [S, F/tf, D, tf], contiguous: the JAX
    package's ``pack_tiled``."""
    return tiled_view(w, tf).contiguous()


def _flat_slab(wg: torch.Tensor) -> torch.Tensor:
    """One slot's weights as [D, F]: a tiled slot [F/tf, D, tf] viewed flat."""
    return wg.permute(1, 0, 2).reshape(wg.shape[1], -1) if wg.dim() == 3 else wg


class GmmPlan(NamedTuple):
    tiles: int  # column tiles of 128 stored columns: the grid's x
    chunks: int  # bound of the 64-row chunks, ceil(T / 64) + G: the grid's z
    splits: int  # whole-k-tile splits of the reduction: the grid's y
    ktiles: int  # k-tiles of each split but the last, ceil(ceil(D / 64) / splits)


def _gmm_plan(T: int, G: int, D: int, Fw: int) -> GmmPlan:
    """K3's launch for T rows in G groups, from these integers alone (the
    group sizes stay on the device). Busy blocks are taken to be the column
    tiles times min(G, T) chunks, which is exact when every group fits one
    chunk, as at decode. Where they fall short of ``_GMM_BLOCKS``, the
    reduction is cut into the fewest whole-k-tile splits that reach it, none
    shallower than ``_GMM_MIN_KTILES`` and none empty."""
    tiles = -(-Fw // _TILE_COLS)
    nk = -(-D // _K_TILE)
    busy = tiles * max(1, min(G, T))
    splits = max(1, min(-(-_GMM_BLOCKS // busy), nk // _GMM_MIN_KTILES))
    kps = -(-nk // splits)
    return GmmPlan(tiles, -(-T // _ROWS_PER_CHUNK) + G, -(-nk // kps), kps)


def gmm(
    x: torch.Tensor,  # [T, D] rows sorted by group
    w: torch.Tensor,  # [S_total, D, F], [S_total, F/tf, D, tf] or int4 [S_total, D, F // 2]
    group_sizes: torch.Tensor,  # [G] int
    scale: Optional[torch.Tensor] = None,  # [S_total, F] f32
    group_offset: int = 0,  # base row into w and scale
    group_ids: Optional[torch.Tensor] = None,  # [G] rows into w (identity)
    *,
    packed: bool = False,
) -> torch.Tensor:
    """Grouped matmul; returns f32 [T, F]. Rows past sum(group_sizes) are
    zero."""
    if w.dim() == 4 and packed:
        raise ValueError("packed int4 gmm takes 3D [S, D, F//2] weights")
    fn = _gmm_cuda if x.is_cuda else gmm_plain
    return fn(x, w, group_sizes, scale, int(group_offset), group_ids, packed=packed)


def _gmm_cuda(x, w, group_sizes, scale, group_offset, group_ids, *, packed):
    T, D = x.shape
    tiled = w.dim() == 4
    if tiled:
        S_total, nf, Dw, tf = w.shape
        Fw = nf * tf
    else:
        S_total, Dw, Fw = w.shape
        tf = Fw
    F = 2 * Fw if packed else Fw
    G = group_sizes.shape[0]
    if Dw != D:
        raise ValueError(f"gmm: x has D={D}, w has D={Dw}")
    if packed and w.dtype != torch.int8:
        raise ValueError("gmm: packed int4 weights are int8 [S, D, F/2]")
    kind = _INT4 if packed else _KIND.get(w.dtype)
    if kind is None:
        raise ValueError(f"gmm: weight dtype {w.dtype} is not taken")
    if D % 8 or (Fw * w.element_size()) % 16:
        raise ValueError(
            f"gmm: the kernel copies rows in 16-byte pieces, so D must be a multiple "
            f"of 8 (got {D}) and a stored weight row a multiple of 16 bytes (got "
            f"{Fw} x {w.element_size()})")
    if (tf * w.element_size()) % 16:
        raise ValueError(
            f"gmm: a tiled weight's slab row must be a multiple of 16 bytes, so that "
            f"no 16-byte piece straddles two slabs (got tf {tf} x {w.element_size()})")
    plan = _gmm_plan(T, G, D, Fw)
    if (group_ids is not None and G != group_ids.shape[0]) or plan.chunks > 65535:
        raise ValueError("gmm: group_ids must match group_sizes; rows/64 + G <= 65535")
    _build.check_aligned("gmm w", w)
    if scale is not None:
        if scale.dtype != torch.float32 or tuple(scale.shape) != (S_total, F):
            raise ValueError("gmm: scale must be f32 [S, F]")
        _build.check_aligned("gmm scale", scale, 4)
    out = torch.zeros(T, F, dtype=torch.float32, device=x.device)
    if T == 0 or G == 0:
        return out
    xb = x.to(torch.bfloat16).contiguous()  # the kernel's operand rounding
    if xb.data_ptr() % 16:  # rows arrive in 16-byte copies
        xb = xb.clone()
    sizes = group_sizes.to(torch.int32).contiguous()
    gids = None if group_ids is None else group_ids.to(torch.int32).contiguous()
    dev = _build.same_device(xb, w, scale, sizes, gids)
    part = tickets = None
    if plan.splits > 1:
        part = _build.workspace(dev, plan.splits * T * F)
        tickets = _build.tickets(dev, plan.chunks * plan.tiles)
    fn = _build.function("gmm", "mit_gmm", _GMM_ARGS)
    err = _build.launch(fn, dev,
        _build.ptr(xb), _build.ptr(w), _build.ptr(scale), _build.ptr(sizes), _build.ptr(gids),
        _build.ptr(part), _build.ptr(tickets), group_offset, G, plan.chunks,
        _ROWS_PER_CHUNK, T, D, Fw, F, kind, plan.splits, tf, _build.ptr(out)
    )
    _build.check(err, "gmm")
    LAUNCHES["gmm_tiled" if tiled else
             "gmm_fp8" if w.dtype == torch.float8_e4m3fn else "gmm"] += 1
    return out


def gmm_plain(x, w, group_sizes, scale=None, group_offset=0, group_ids=None,
              *, packed=False):
    """K3's arithmetic in PyTorch, one f32 matmul per non-empty group (reads
    the group sizes on the host). A tiled slot is viewed flat."""
    from moe_infinity_tpu_torch.ops.moe import unpack_int4

    T, D = x.shape
    F = w.shape[1] * w.shape[3] if w.dim() == 4 else 2 * w.shape[2] if packed else w.shape[2]
    G = group_sizes.shape[0]
    if group_ids is None:
        group_ids = torch.arange(G)
    xb = x.to(torch.bfloat16).float()
    out = torch.zeros(T, F, dtype=torch.float32, device=x.device)
    start = 0
    for n, gid in zip(group_sizes.tolist(), group_ids.tolist()):
        if n:
            wg = _flat_slab(w[gid + group_offset])
            wf = unpack_int4(wg).float() if packed else wg.to(torch.bfloat16).float()
            seg = xb[start:start + n] @ wf
            if scale is not None:
                seg = seg * scale[gid + group_offset].float()
            out[start:start + n] = seg
        start += n
    return out


# --------------------------------------------------------------------------
# Grouped FFN on gmm (impl="pallas" of ops.moe.grouped_ffn)
# --------------------------------------------------------------------------

def compact_groups(sorted_slots: torch.Tensor, num_groups: int):
    """(group_ids, group_sizes) of the distinct slots in ``sorted_slots``,
    in ascending order, padded to ``num_groups`` with slot 0 and count 0 -
    ``unique(size=G, fill_value=0, return_counts=True)`` without the
    host sync a data-dependent size would cost."""
    n = sorted_slots.shape[0]
    new = torch.ones(n, dtype=torch.bool, device=sorted_slots.device)
    new[1:] = sorted_slots[1:] != sorted_slots[:-1]
    gidx = torch.cumsum(new, 0) - 1  # group index of each sorted row
    ids = torch.zeros(num_groups, dtype=torch.int32, device=sorted_slots.device)
    ids.scatter_(0, gidx, sorted_slots.to(torch.int32))
    sizes = torch.zeros(num_groups, dtype=torch.int32, device=sorted_slots.device)
    sizes.index_add_(0, gidx, torch.ones_like(gidx, dtype=torch.int32))
    return ids, sizes


def gffn_pallas(x, expert_ids, combine_weights, expert_to_slot,
                weights: Dict[str, torch.Tensor], activation, biases=None):
    """Grouped FFN on the gmm kernel; signature of ops.moe._gffn_ragged.
    Takes 'gate'/'down' (NLLB), gated 'gate'/'up'/'down' (Mixtral) and fused
    'gateup', each bf16, int8 or float8_e4m3fn with '<role>_scale', flat or
    pre-tiled (``pack_tiled``), or packed int4 under '<role>4'. A packed
    'gateup4' needs no split: its low nibbles are the gate columns and its
    high nibbles the up columns, so one gmm emits [gate | up]."""
    from moe_infinity_tpu_torch.ops.moe import _activate

    T, D = x.shape
    K = expert_ids.shape[1]
    compute_dtype = x.dtype

    flat_slots = expert_to_slot[expert_ids.long()].reshape(-1)
    order = torch.argsort(flat_slots, stable=True)
    sorted_slots = flat_slots[order].long()
    inv_token = order // K
    xs = x[inv_token]
    # compact the grid to the routed slots: at most T*K are active, and no
    # more than the layer's E experts (expert_to_slot's length), so that a
    # slot arena of any size, or a stream's scratch of U records, launches
    # the grid (and the split plan) of the resident layer; groups past the
    # routed slots are empty
    E = expert_to_slot.shape[0]
    group_ids, group_sizes = compact_groups(sorted_slots, min(E, flat_slots.shape[0]))

    def run(role, xin):
        p = role + "4" in weights
        return gmm(
            xin, weights[role + "4"] if p else weights[role], group_sizes,
            weights.get(role + "_scale"), group_ids=group_ids, packed=p,
        )

    def has(role):
        return role in weights or role + "4" in weights

    if has("gateup"):
        hcat = run("gateup", xs)
        F = hcat.shape[-1] // 2
        h, h_up = hcat[:, :F], hcat[:, F:]
    else:
        h = run("gate", xs)
        h_up = run("up", xs) if has("up") else None
    if biases is not None and "gate_bias" in biases:
        h = h + biases["gate_bias"][sorted_slots]
    h = _activate(h, h_up, activation)
    out = run("down", h.to(compute_dtype))
    if biases is not None and "down_bias" in biases:
        out = out + biases["down_bias"][sorted_slots]
    out = out * combine_weights.reshape(-1)[order].float()[:, None]
    # back to (token, k) order and summed over k there: the order of the sum
    # depends neither on the slots the experts sit in nor on atomics, so an
    # offloaded layer sums as the resident one does, bit for bit (two terms
    # add exactly in either order; three or more do not)
    per_k = torch.empty_like(out)
    per_k[order] = out
    return per_k.reshape(T, K, -1).sum(dim=1).to(compute_dtype)
