"""Tensor-parallel column views over an expert store, from
``moe_infinity_tpu/store/column.py``.

TP x EP on the pod path: with a ``model`` mesh axis of size tp above 1, the
rank at model coordinate m holds column m of every expert it serves, the 1/tp
slice of its FFN weights along the hidden (d_ff) dim. ``ColumnShardStore`` is
the store-protocol view that makes this transparent to the arena: field
shapes, record reads and meta all describe column ``col`` of ``tp``, so an
``ExpertArena`` built on the view allocates and lands sliced slots.

Slicing plan (records hold gate/up as [d_model, d_ff], down as
[d_ff, d_model]):

  gate_or_in / up tails - dim 1 (d_ff columns)
  down tail             - dim 0 (d_ff rows)
  fc1.bias              - dim 0 ([d_ff])
  fc2.bias              - whole ([d_model]); replicated over the columns and
                          added once (``ops.moe.grouped_ffn_ep`` zeroes it
                          off model coordinate 0 before the sum)

The partial products sum exactly: act(x @ W1[:, col]) is elementwise over
the sliced d_ff, and each column's act_col @ W2[col, :] is a partial
[T, d_model] that the sum over the model axis completes.

Row-wise quantized stores (``store/quant.py``: int8, int4, e4m3) slice too:
a per-output-channel scale follows its weight (gate/up's [d_ff] scales with
the d_ff columns; down's [d_model] scale is replicated). int4 is packed
split-wise along the output axis, so a d_ff column slice of gate/up is not a
byte slice: the view unpacks, slices the channels and repacks per column
(d_ff/tp must stay even). Block-scaled records (``store/fp8_block.py``'s
128x128 scales) are refused.

``_BaseRecordCache`` shares one base read among the column views of one
process (``column_views``). The port puts each column on a rank of its own,
so each process holds one view; across ranks on one host the page cache
plays that part for a store on disk.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from moe_infinity_tpu_torch.runtime.providers import role_map_for
from moe_infinity_tpu_torch.store.quant import pack_int4_np, unpack_int4_np


def _slice_dims_for(store) -> Dict[str, Optional[int]]:
    """tail name -> record dim sliced over the model axis (None: whole)."""
    roles = role_map_for(store.meta)
    dims: Dict[str, Optional[int]] = {}
    names = set(store.field_names)
    for role, tail in roles.items():
        if tail is None:
            continue
        dims[tail] = 0 if role == "down" else 1
        if tail + ".scale" in names:
            # a per-output-channel scale slices with gate/up's d_ff columns;
            # down's [d_model] scale is replicated (it scales the output
            # channels, the same for every column's partial)
            dims[tail + ".scale"] = None if role == "down" else 0
    if "fc1.bias" in names:
        dims["fc1.bias"] = 0
    if "fc2.bias" in names:
        dims["fc2.bias"] = None
    return dims


class _BaseRecordCache:
    """One base-store read shared by the tp column views of a record in one
    process: the first ``get`` reads, the next tp-1 slice the cached record,
    after which the entry is dropped (refcount)."""

    def __init__(self, store, tp: int):
        self.store = store
        self.tp = tp
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[int, int], Tuple[dict, int]] = {}

    def get(self, layer: int, expert: int, prio: int, gen: int) -> dict:
        key = (layer, expert)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                rec, refs = hit
                if refs + 1 >= self.tp:
                    del self._cache[key]
                else:
                    self._cache[key] = (rec, refs + 1)
                return rec
        rec = self.store.get_expert(layer, expert, prio=prio, gen=gen)
        if self.tp > 1:
            with self._lock:
                self._cache[key] = (rec, 1)
        return rec


class ColumnShardStore:
    """ExpertStore-protocol view presenting column ``col`` of ``tp``."""

    def __init__(self, store, col: int, tp: int, shared: Optional[_BaseRecordCache] = None):
        if not 0 <= col < tp:
            raise ValueError(f"col {col} out of range for tp={tp}")
        self.base = store
        self.col = col
        self.tp = tp
        self.num_layers = store.num_layers
        self.num_experts = store.num_experts
        self.meta = store.meta
        self._dims = _slice_dims_for(store)
        self._shared = shared or _BaseRecordCache(store, 1)
        # int4 tails packed split-wise along a sliced output axis: unpack,
        # slice the channels, repack (not a byte slice)
        self._repack4: set = set()
        fields = []
        for f in store.fields if hasattr(store, "fields") else [
            store._field_by_name[n] for n in store.field_names
        ]:
            if f.name.endswith(".scale") and len(f.shape) != 1:
                raise NotImplementedError(
                    f"column sharding of BLOCK-scaled records is not "
                    f"supported ({f.name} scale shape {f.shape}; needs "
                    f"block-aligned tp splits)"
                )
            dim = self._dims.get(f.name)
            shape = f.shape
            if dim is not None:
                if f.dtype == "int4" and dim == len(shape) - 1:
                    # the packed axis holds out/2 bytes; each column gets
                    # (out/tp)/2, repacked from its own channels
                    if (shape[dim] * 2 // tp) % 2:
                        raise ValueError(
                            f"int4 field {f.name}: d_ff/tp "
                            f"({shape[dim] * 2 // tp}) must stay even "
                            f"for split-wise packing"
                        )
                    self._repack4.add(f.name)
                if shape[dim] % tp:
                    raise ValueError(
                        f"field {f.name} dim {dim} ({shape[dim]}) must "
                        f"divide over the model axis (tp={tp})"
                    )
                shape = tuple(s // tp if i == dim else s for i, s in enumerate(shape))
            fields.append(dataclasses.replace(f, shape=shape))
        self.fields = fields
        self._field_by_name = {f.name: f for f in fields}

    def record_slice_dim(self, tail: str) -> Optional[int]:
        """The record dim sliced for a store tail (None: whole)."""
        return self._dims.get(tail)

    @property
    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def _slice(self, name: str, a: np.ndarray) -> np.ndarray:
        dim = self._dims.get(name)
        if dim is None:
            return a
        if name in self._repack4:
            # split-wise int4 packing pairs channel i with i + out/2 in one
            # byte: a d_ff column is not a byte range
            ch = unpack_int4_np(a)
            n = ch.shape[dim] // self.tp
            idx = [slice(None)] * ch.ndim
            idx[dim] = slice(self.col * n, (self.col + 1) * n)
            return np.ascontiguousarray(pack_int4_np(ch[tuple(idx)]))
        n = a.shape[dim] // self.tp
        idx = [slice(None)] * a.ndim
        idx[dim] = slice(self.col * n, (self.col + 1) * n)
        return np.ascontiguousarray(a[tuple(idx)])

    def get_tensor(self, layer: int, expert: int, name: str) -> np.ndarray:
        return self._slice(name, self.base.get_tensor(layer, expert, name))

    def get_expert(self, layer: int, expert: int, *, prio: int = 0, gen: int = 0
                   ) -> Dict[str, np.ndarray]:
        rec = self._shared.get(layer, expert, prio, gen)
        return {n: self._slice(n, rec[n]) for n in self.field_names}


def column_views(store, tp: int) -> List[ColumnShardStore]:
    """The tp column views of a store, sharing one base-record cache."""
    shared = _BaseRecordCache(store, tp)
    return [ColumnShardStore(store, m, tp, shared) for m in range(tp)]
