"""Pinned-host expert tier, from ``moe_infinity_tpu/store/pinned.py``: the
host-memory layer the card copies expert records from.

The tier stages the store's records into per-field segments of
page-locked host tensors (``torch.empty(..., pin_memory=True)``), so a
fetch is one ``copy_(non_blocking=True)`` from pinned memory into an arena
slot on a side stream (``runtime/arena.py``): no host read, no pageable
bounce. With ``device="cpu"`` the segments are plain host tensors (the
CPU tests).

The tier is BYTE-BOUNDED: ``max_bytes`` (and a ``MemAvailable`` headroom
cap) limit staging to the hottest prefix of a staging order - decoder-phase
records first by default, since decode is the steady-state phase - and
every record that does NOT fit stays on the store path: the arena reads it
from the store and copies it through a pinned staging buffer.

Staging moves each record once at construction. For a ``SyntheticStore``
``synth_on_device`` makes the segments' bytes on the card from an explicit
``torch.Generator`` and copies them device to pinned: a synthetic tier's
values are arbitrary, its size and copy behaviour are what must be real.
Those bytes differ from the store's for the same key; a key is either
staged or not, so each key has one value.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.utils.dtypes import host_copy, np_dtype, torch_dtype
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("pinned_tier")

Key = Tuple[int, int]


def _host_available_bytes() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):  # non-Linux / parse drift
        return None
    return None


class PinnedExpertTier:
    """Per-field ``[num_staged, *shape]`` host tensors, page-locked on CUDA.

    ``record_index(layer, expert)`` returns the staged row for a record, or
    None when the record did not fit the byte budget - the arena then uses
    its store fetch path for that key. ``shared_record=True`` stages a
    single record that every (layer, expert) maps to (the default for a
    ``SyntheticStore``, whose records then alias one buffer); pass
    ``shared_record=False`` with a ``SyntheticStore`` to stage an
    honestly sized tier.

    max_bytes: staging byte budget (None = bounded only by host memory
    headroom). order: optional sequence of (layer, expert) keys in
    staging-priority order; the default stages decoder-phase records first
    (``store.meta["num_encoder_moe_layers"]`` marks the phase boundary).
    host_headroom: fraction of ``MemAvailable`` the tier may claim.
    seg_bytes: rows per segment are set so the largest field's segment
    holds at most this many bytes; align_rows sets them to a layer's
    expert count instead.
    """

    def __init__(
        self,
        store,
        *,
        device="cuda",
        shared_record: Optional[bool] = None,
        max_bytes: Optional[int] = None,
        order: Optional[Sequence[Key]] = None,
        host_headroom: float = 0.5,
        seg_bytes: int = 256 << 20,
        synth_on_device: Optional[bool] = None,
        align_rows: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        synthetic = store.__class__.__name__ == "SyntheticStore"
        if shared_record is None:
            shared_record = synthetic
        self.shared = shared_record
        self.num_experts = store.num_experts
        self.num_layers = store.num_layers
        rec_bytes = sum(
            int(np.prod(f.shape)) * np_dtype(f.dtype).itemsize for f in store.fields
        )
        self.record_bytes = rec_bytes
        n_total = store.num_layers * store.num_experts

        if shared_record:
            staged_keys = [(0, 0)]
        else:
            if order is None:
                # decoder-phase records first: decode is the steady-state
                # phase, so under a budget the decoder tier is the hot set
                n_enc = int(store.meta.get("num_encoder_moe_layers", 0))
                order = sorted(
                    ((layer, e)
                     for layer in range(store.num_layers)
                     for e in range(store.num_experts)),
                    key=lambda k: (0 if k[0] >= n_enc else 1, k[0], k[1]),
                )
            budget = max_bytes if max_bytes is not None else float("inf")
            avail = _host_available_bytes()
            if avail is not None:
                budget = min(budget, int(avail * host_headroom))
            if budget == float("inf"):  # no max_bytes AND no /proc/meminfo
                n_budget = n_total
            else:
                n_budget = int(budget // rec_bytes) if rec_bytes else n_total
            staged_keys = list(order)[: max(0, min(n_total, n_budget))]
            if len(staged_keys) < n_total:
                logger.warning(
                    "pinned tier: staging %d/%d records (%.2f/%.2f GB; budget %s, "
                    "host headroom %.0f%%) - unstaged records use the store fetch path",
                    len(staged_keys), n_total,
                    len(staged_keys) * rec_bytes / 2**30, n_total * rec_bytes / 2**30,
                    f"{max_bytes / 2**30:.2f} GB" if max_bytes else "none",
                    host_headroom * 100,
                )

        n_rec = len(staged_keys)
        self.num_staged = n_rec
        self.total_records = 1 if shared_record else n_total
        self._rec_row = np.full(n_total, -1, np.int32)
        for row, (layer, e) in enumerate(staged_keys):
            self._rec_row[layer * store.num_experts + e] = row

        max_field_rec = max(
            (int(np.prod(f.shape)) * np_dtype(f.dtype).itemsize for f in store.fields),
            default=1,
        )
        self._seg_rows = int(align_rows) if align_rows else max(1, seg_bytes // max(1, max_field_rec))
        if synth_on_device is None:
            synth_on_device = synthetic and not shared_record and n_rec > 8
        self.fields: Dict[str, list] = {}  # name -> [segment tensors]
        self._pin = self.device.type == "cuda"
        t0 = time.perf_counter()
        total = 0
        n_seg = -(-n_rec // self._seg_rows)
        gen = None
        if synth_on_device and n_rec:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
        for f in store.fields:
            self.fields[f.name] = []
        for s in range(n_seg):
            lo, hi = s * self._seg_rows, min(n_rec, (s + 1) * self._seg_rows)
            segs = {
                f.name: torch.empty((hi - lo,) + tuple(f.shape), dtype=torch_dtype(f.dtype),
                                    pin_memory=self._pin)
                for f in store.fields
            }
            if gen is not None:
                for f in store.fields:
                    segs[f.name].copy_(self._synth(gen, segs[f.name]))
            else:
                for row in range(lo, hi):
                    rec = store.get_expert(*staged_keys[row])
                    for f in store.fields:
                        host_copy(segs[f.name][row - lo], rec[f.name], f.dtype)
            for f in store.fields:
                self.fields[f.name].append(segs[f.name])
                total += segs[f.name].numel() * segs[f.name].element_size()
        self.staged_bytes = total
        logger.info(
            "pinned tier staged: %d records x %d fields, %.2f GB in %.1f s (%s%s)",
            n_rec, len(self.fields), total / 2**30, time.perf_counter() - t0,
            "page-locked" if self._pin else "pageable", ", synthesized on the device"
            if gen is not None else "",
        )

    def _synth(self, gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
        """Random segment on the tier's device: uniform bytes for integer
        (int8, packed int4) fields, and values in [1.6e-2, 3.2e-2] for float
        fields, so dequantized weights stay finite."""
        if like.dtype == torch.int8:
            return torch.randint(-128, 128, like.shape, dtype=torch.int8, device=self.device,
                                 generator=gen)
        out = torch.empty(like.shape, dtype=torch.float32, device=self.device)
        return out.uniform_(1.6e-2, 3.2e-2, generator=gen).to(like.dtype)

    def segment_for(self, row: int):
        """(per-field segment tensors, local row) for a staged record."""
        s, local = divmod(row, self._seg_rows)
        return {n: segs[s] for n, segs in self.fields.items()}, local

    def direct_segment(self, layer: int) -> Optional[int]:
        """Segment that holds ``layer``'s FULL expert set contiguously, one
        layer per segment (a tier built with ``align_rows=num_experts``),
        else None: the layers ``layer_stack`` would serve."""
        E = self.num_experts
        if self.shared or self._seg_rows != E:
            return None
        rows = self._rec_row[layer * E:(layer + 1) * E]
        if rows[0] < 0 or rows[0] % E != 0:
            return None
        if not np.array_equal(rows, np.arange(rows[0], rows[0] + E)):
            return None
        return int(rows[0] // E)

    def layer_stack(self, layer: int, promote: bool = True):
        """Per-field ``[E, *shape]`` tensors of ``layer`` when its FULL expert
        set is staged in one segment (``direct_segment``), else None: the
        direct-dispatch view, from which an engine computes the layer's
        grouped FFN with an identity slot row (no slot, no fetch, no
        replay). promote: copy the segment to the card once (E records,
        2.16 GB for an NLLB-MoE-54B int4 layer) and put the device tensor in
        the tier's place, so the arena's tier path and the direct dispatch
        read one copy; a no-op on a CPU tier."""
        s = self.direct_segment(layer)
        if s is None:
            return None
        out = {}
        for name, segs in self.fields.items():
            a = segs[s]
            if promote and a.device.type != "cuda" and self.device.type == "cuda":
                a = a.to(self.device)
                segs[s] = a  # one resident copy, not two
            out[name] = a
        return out

    def record_index(self, layer: int, expert: int) -> Optional[int]:
        """Staged row for (layer, expert), or None if it must come from the
        store path (it did not fit the byte budget)."""
        if self.shared:
            return 0
        row = self._rec_row[layer * self.num_experts + expert]
        return None if row < 0 else int(row)

    def stats(self) -> dict:
        return {
            "pinned_tier_staged_records": self.num_staged,
            "pinned_tier_total_records": self.total_records,
            "pinned_tier_gb": round(self.staged_bytes / 2**30, 3),
        }
