"""Stream-gather grouped FFN, from ``moe_infinity_tpu/ops/stream.py``: the
decode step fetches its routed experts itself, from the pinned tier.

The offload paths keep a slot arena that a host controller fills (fetch
threads, eviction, speculative verification and replay), because a miss
found in the middle of a step stalls it. Here a miss cannot happen: each
MoE layer gathers exactly its routed experts' records from the tier's
segments into scratch on the device and runs the grouped FFN over that
scratch. The weights used are the routed ones by construction, and the bytes
moved follow the step's unique routed experts.

Static shapes, so that the step can be one CUDA graph: the gather is sized
by ``max_unique`` (U). The unique routed ids come from a sort, a first-of-run
mask, a cumulative sum and a scatter into U + 1 entries whose last catches
every unique past the U-th (``torch.unique`` has a size that depends on the
data and reads it on the host). Routing that touches more than U experts in
one layer has the rest of its contributions masked to zero, and so has an
expert the tier did not stage (row -1); the caller detects both exactly on
the host from the routed ids (``stream_overflow``) and runs again at a
larger U.

On the card the gather is ``stream_gather``, a hand-written kernel
(``csrc/stream.cu``): one launch per MoE layer reads the U records of every
role at their device addresses (mapped page-locked memory, or a segment
``PinnedExpertTier.layer_stack`` promoted to the card); a slot of row -1
(padding past the step's distinct experts, or an unstaged expert) reads
nothing and is zeros, so the bytes over the host link follow the routed
experts (``stream_records`` counts them). For CPU tensors it
runs ``stream_gather_plain`` (``index_select`` per segment). The grouped FFN
over the scratch is ``ops.moe.grouped_ffn`` (K3 under ``impl="pallas"``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from moe_infinity_tpu_torch.ops import _build

# launches of the gather kernel since the last reset (plain runs never count)
LAUNCHES = {"stream_gather": 0}

_MAX_ROLES = 8  # kMaxRoles in csrc/stream.cu
_HOST, _DEVICE = 1, 2  # cudaMemoryTypeHost, cudaMemoryTypeDevice
_c = ctypes.c_void_p
_GATHER_ARGS = [_c, _c, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _c, _c, _c]
_POINTER_ARGS = [_c, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int)]


@dataclass
class StreamSource:
    """One MoE layer's view of the pinned tier for in-step gathering.

    fields: arena role key -> the tier's segments ``[seg_rows, *shape]`` in
    record-row order (the last may be shorter); the source keeps them alive.
    rec_row: ``[E]`` int32 tier row of each expert of this layer, -1 where
    unstaged (a tensor on the compute device, or numpy for the CPU).
    max_unique / impl: the gather's width and the grouped FFN's impl when
    the source comes through ``grouped_ffn``'s hook."""

    fields: Dict[str, List[torch.Tensor]]
    rec_row: object
    seg_rows: int
    max_unique: int = 32
    impl: str = "ragged"
    # the card's table of segment addresses [roles, segments] (int64), made
    # once by ``device_table``; sources of one tier may share it
    table: Optional[torch.Tensor] = field(default=None, repr=False)

    def device_table(self, device) -> torch.Tensor:
        """The segments' device addresses, role by role in ``fields``'
        order, as an int64 tensor on ``device``. Each segment must be
        readable by the card at its own address: device memory, or
        page-locked host memory mapped at the same address (checked with
        ``cudaPointerGetAttributes``; raises otherwise). Made once, outside
        any graph capture (it copies from the host)."""
        if self.table is None:
            _check_fields(self.fields)
            fn = _build.function("stream", "mit_stream_device_pointer", _POINTER_ARGS)
            rows = []
            for role, segs in self.fields.items():
                ptrs = []
                for s, a in enumerate(segs):
                    dev_ptr, kind = ctypes.c_ulonglong(0), ctypes.c_int(-1)
                    _build.check(fn(_build.ptr(a), ctypes.byref(dev_ptr), ctypes.byref(kind)),
                                 "cudaPointerGetAttributes")
                    if kind.value not in (_HOST, _DEVICE) or dev_ptr.value != a.data_ptr():
                        raise ValueError(
                            f"stream_gather: segment {s} of {role!r} is not readable by the "
                            f"card at its own address (memory type {kind.value}); the tier "
                            "must be page-locked (pin_memory) or on the card")
                    ptrs.append(a.data_ptr())
                rows.append(ptrs)
            if len({len(p) for p in rows}) != 1:
                raise ValueError("stream_gather: every role needs the same segments")
            self.table = torch.tensor(np.asarray(rows, dtype=np.uint64).view(np.int64),
                                      device=device)
        return self.table


def _check_fields(fields) -> None:
    if not 1 <= len(fields) <= _MAX_ROLES:
        raise ValueError(f"stream_gather: 1 to {_MAX_ROLES} roles, got {len(fields)}")
    for role, segs in fields.items():
        for a in segs:
            if not a.is_contiguous() or a.data_ptr() % 16 or (a[0].numel() * a.element_size()) % 16:
                raise ValueError(
                    f"stream_gather: the kernel copies 16-byte pieces, so each segment of "
                    f"{role!r} must be contiguous and 16-byte aligned with a record a "
                    "multiple of 16 bytes")


def stream_gather(source: StreamSource, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{role: ``[U, *shape]``}: the record of tier row ``rows[u]`` of every
    role, zeros where ``rows[u]`` is -1 (nothing is read for it), ``rows``
    ``[U]`` int32. CUDA ``rows``: one launch of the kernel, into scratch on
    that device; CPU ``rows``: the plain version."""
    if not rows.is_cuda:
        return stream_gather_plain(source.fields, source.seg_rows, rows)
    dev = rows.device
    table = source.device_table(dev)
    U = rows.shape[0]
    rows = rows.to(torch.int32).contiguous()
    out = {role: torch.empty((U,) + tuple(segs[0].shape[1:]), dtype=segs[0].dtype, device=dev)
           for role, segs in source.fields.items()}
    n = len(out)
    rec_bytes = (ctypes.c_longlong * n)(
        *(segs[0][0].numel() * segs[0].element_size() for segs in source.fields.values()))
    dst = (ctypes.c_void_p * n)(*(o.data_ptr() for o in out.values()))
    fn = _build.function("stream", "mit_stream_gather", _GATHER_ARGS)
    err = _build.launch(fn, dev, _build.ptr(table), _build.ptr(rows), U, n, table.shape[1],
                        int(source.seg_rows), ctypes.cast(rec_bytes, ctypes.c_void_p),
                        ctypes.cast(dst, ctypes.c_void_p))
    _build.check(err, "stream_gather")
    LAUNCHES["stream_gather"] += 1
    return out


def stream_gather_plain(fields: Dict[str, List[torch.Tensor]], seg_rows: int,
                        rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The gather in PyTorch: ``index_select`` of each segment's rows (the
    segment number and the local row from the row), into tensors on
    ``rows``' device, zeros for a row of -1. It reads the rows on the host."""
    r = rows.to(torch.int64).cpu()
    seg, local = torch.where(r >= 0, r // seg_rows, -1), r.clamp(min=0) % seg_rows
    out = {}
    for role, segs in fields.items():
        o = torch.zeros((r.shape[0],) + tuple(segs[0].shape[1:]), dtype=segs[0].dtype,
                        device=rows.device)
        for s, a in enumerate(segs):
            idx = torch.nonzero(seg == s).flatten()
            if idx.numel():
                got = a.index_select(0, local[idx].to(a.device))
                o.index_copy_(0, idx.to(o.device), got.to(o.device))
        out[role] = o
    return out


def static_unique(flat: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The first ``size`` distinct values of ``flat`` in ascending order,
    padded with ``fill`` (which must exceed every value), with no host read:
    sort, a first-of-run mask, its cumulative sum, and a scatter into
    ``size + 1`` entries whose last takes every distinct value past the
    ``size``-th (JAX's ``.at[pos].set(mode="drop")``)."""
    s, _ = torch.sort(flat.to(torch.int64))
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = (torch.cumsum(first, 0) - 1).clamp(max=size)
    uniq = torch.full((size + 1,), fill, dtype=torch.int64, device=flat.device)
    uniq.scatter_(0, pos, s)  # repeats of a value write the same position and value
    return uniq[:size]


def gffn_stream(x, expert_ids, combine_weights, source: StreamSource, activation: str, *,
                max_unique: int, impl: str = "ragged",
                bias_keys: tuple = ("gate_bias", "down_bias")) -> torch.Tensor:
    """Grouped FFN with in-step expert gathering. Returns ``[T, D]``.

    The contributions of experts past the first ``max_unique`` distinct ids
    (ascending) and of experts the tier did not stage are ZERO: the caller
    checks the routed ids (``stream_overflow``) and runs again at a larger
    U when either occurred."""
    from moe_infinity_tpu_torch.ops.moe import grouped_ffn

    T, _ = x.shape
    K = expert_ids.shape[-1]
    U = int(max_unique)
    rec_row = torch.as_tensor(source.rec_row, dtype=torch.int32, device=x.device)
    E = rec_row.shape[0]
    flat = expert_ids.reshape(-1).to(torch.int64)
    uniq = static_unique(flat, U, E)
    rows = torch.where(uniq < E, rec_row[uniq.clamp(max=E - 1)], -1).to(torch.int32)
    scratch = stream_gather(source, rows)
    # token -> scratch slot; an overflowed or unstaged expert misses
    slots = torch.searchsorted(uniq, flat).clamp(0, U - 1)
    hit = uniq[slots] == flat
    staged = rows[slots] >= 0
    cw = (combine_weights.reshape(-1).float() * (hit & staged).float()).reshape(T, K)
    biases = {k: scratch.pop(k) for k in list(scratch) if k in bias_keys}
    # the identity on the scratch's U slots, as long as the layer's E ids:
    # K3 sizes its group grid by that length, so it plans (and sums) as over
    # the resident layer
    ident = torch.arange(E, dtype=torch.int32, device=x.device).clamp_(max=U - 1)
    return grouped_ffn(x, slots.reshape(T, K), cw, ident, scratch, activation,
                       biases=biases or None, impl=impl)


def stream_overflow(ids_np, max_unique: int, rec_row: np.ndarray) -> bool:
    """The host's exactness check of one layer's routed ids: True when
    ``gffn_stream`` masked a real contribution (more than ``max_unique``
    distinct experts, or an unstaged one routed)."""
    uniq = np.unique(np.asarray(ids_np).reshape(-1))
    if uniq.size > max_unique:
        return True
    return bool((rec_row[uniq] < 0).any())


def stream_records(ids_np, max_unique: int, rec_row: np.ndarray) -> int:
    """The records ``gffn_stream`` read from the tier for one layer's routed
    ids: the staged ones among the first ``max_unique`` distinct experts
    (the other slots are rows of -1, which read nothing)."""
    uniq = np.unique(np.asarray(ids_np).reshape(-1))[:max_unique]
    return int((rec_row[uniq] >= 0).sum())
