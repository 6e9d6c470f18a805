"""Disk-backed expert store, from ``moe_infinity_tpu/store/blob.py``.

``experts.blob`` / ``experts.index.json`` under the store's directory hold
fixed-stride expert records, layer-major then expert-minor, each record
4096-aligned. A record is the concatenation of one expert's tensors (plus
quantization scales) at fixed offsets shared by all experts. The reader
memory-maps the blob (``mmap``), reads it whole into RAM (``ram``), or reads
each record with the native store (``store/native.py``): one O_DIRECT read
(``direct``), or a read ordered by priority in the native scheduler with
prefetches preempted block by block (``sched``).

``SyntheticStore`` has the same protocol with in-RAM pseudo-random records
from numpy, byte-identical to the JAX class for the same seed.

``dense.blob`` / ``dense.index.json`` hold the non-expert (dense) tensors,
each 128-byte aligned (``DenseArchiveWriter``, ``DenseArchive``). Every file
is byte-equal to what the JAX package writes for the same tensors.
"""

from __future__ import annotations

import json
import mmap
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from moe_infinity_tpu_torch.utils.dtypes import (
    bf16_bits,
    dtype_name,
    fp8_bits,
    np_dtype,
    to_tensor,
)

ALIGN = 4096  # page alignment of records
_FP8_PIECE = 1 << 24  # values of one draw of SyntheticStore's fp8 fields
FORMAT_VERSION = 1


def _align(n: int, a: int = ALIGN) -> int:
    return (n + a - 1) // a * a


@dataclass(frozen=True)
class RecordField:
    """One tensor inside an expert record."""

    name: str
    shape: Tuple[int, ...]
    dtype: str  # dtype name from utils.dtypes
    offset: int  # bytes from record start

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np_dtype(self.dtype).itemsize


def build_record_layout(
    fields: Sequence[Tuple[str, Tuple[int, ...], str]],
) -> Tuple[List[RecordField], int]:
    """Pack (name, shape, dtype) tensors into a record; returns fields with
    offsets and the aligned record stride. Each field is 128-byte aligned."""
    out: List[RecordField] = []
    off = 0
    for name, shape, dt in fields:
        off = _align(off, 128)
        f = RecordField(name, tuple(int(x) for x in shape), dt, off)
        out.append(f)
        off += f.nbytes
    return out, _align(off)


class ExpertStoreWriter:
    """Ingest-time writer: fixed-stride records appended in any order."""

    def __init__(
        self,
        path: str,
        num_layers: int,
        num_experts: int,
        fields: Sequence[Tuple[str, Tuple[int, ...], str]],
        meta: Optional[dict] = None,
    ):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.fields, self.stride = build_record_layout(fields)
        self.meta = dict(meta or {})
        self._f = open(os.path.join(path, "experts.blob"), "wb")
        self._f.truncate(self.stride * num_layers * num_experts)
        self._written = np.zeros((num_layers, num_experts), dtype=bool)
        self._field_by_name = {f.name: f for f in self.fields}

    def write_tensor(self, layer: int, expert: int, name: str, array: np.ndarray) -> None:
        """bf16 fields take their raw bits as ``uint16``, int4 fields packed
        nibbles in ``int8``, fp8 fields their codes as ``uint8``."""
        f = self._field_by_name[name]
        a = np.ascontiguousarray(array)
        if tuple(a.shape) != f.shape:
            raise ValueError(
                f"{name} shape {a.shape} != spec {f.shape} (L{layer} E{expert})"
            )
        if a.dtype != np_dtype(f.dtype):
            raise ValueError(f"{name} dtype {a.dtype} != spec {f.dtype}")
        base = (layer * self.num_experts + expert) * self.stride
        self._f.seek(base + f.offset)
        self._f.write(a.tobytes())
        self._written[layer, expert] = True

    def finalize(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        index = {
            "version": FORMAT_VERSION,
            "num_layers": self.num_layers,
            "num_experts": self.num_experts,
            "stride": self.stride,
            "fields": [
                {"name": f.name, "shape": list(f.shape), "dtype": f.dtype, "offset": f.offset}
                for f in self.fields
            ],
            "meta": self.meta,
        }
        with open(os.path.join(self.path, "experts.index.json"), "w") as f:
            json.dump(index, f, indent=1)


class ExpertStore:
    """Read side of the expert store.

    load_mode:
      * 'mmap'   - page-cache backed; the first touch of a record faults it
        in from disk.
      * 'ram'    - the whole blob read into anonymous memory at open.
      * 'direct' - the native O_DIRECT reader: a record streams from disk
        without filling the page cache (records are 4096-strided, so every
        read is aligned).
      * 'sched'  - the native priority scheduler: reads are ordered by
        (prio, FIFO) across the caller's threads, prefetches (prio >= 1)
        preempted block by block by on-demand reads; ``escalate`` boosts an
        in-flight read.
    """

    def __init__(self, path: str, load_mode: str = "mmap"):
        self.path = path
        with open(os.path.join(path, "experts.index.json")) as f:
            index = json.load(f)
        if index["version"] != FORMAT_VERSION:
            raise ValueError(f"store version {index['version']} unsupported")
        self.num_layers: int = index["num_layers"]
        self.num_experts: int = index["num_experts"]
        self.stride: int = index["stride"]
        self.fields: List[RecordField] = [
            RecordField(d["name"], tuple(d["shape"]), d["dtype"], d["offset"])
            for d in index["fields"]
        ]
        self.meta: dict = index.get("meta", {})
        self._field_by_name = {f.name: f for f in self.fields}
        blob_path = os.path.join(path, "experts.blob")
        self.blob_nbytes = os.path.getsize(blob_path)
        expected = self.stride * self.num_layers * self.num_experts
        if self.blob_nbytes != expected:
            raise ValueError(f"blob size {self.blob_nbytes} != expected {expected}")
        self._buf = self._native = self._sched = None
        if load_mode == "mmap":
            with open(blob_path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        elif load_mode == "ram":
            self._buf = np.fromfile(blob_path, dtype=np.uint8)
        elif load_mode == "direct":
            from moe_infinity_tpu_torch.store.native import NativeBlobReader

            self._native = NativeBlobReader(blob_path)
        elif load_mode == "sched":
            from moe_infinity_tpu_torch.store.native import NativeFetchScheduler

            self._sched = NativeFetchScheduler(blob_path)
        else:
            raise ValueError(f"unknown load_mode {load_mode!r}")
        self.load_mode = load_mode

    @property
    def is_direct(self) -> bool:
        """Whether the native reader's open took O_DIRECT (a file system
        that refuses it is read buffered); False for mmap and ram."""
        reader = self._native or self._sched
        return bool(reader is not None and reader.is_direct)

    @property
    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def _record_base(self, layer: int, expert: int) -> int:
        if not (0 <= layer < self.num_layers and 0 <= expert < self.num_experts):
            raise IndexError(f"expert (L{layer}, E{expert}) out of range")
        return (layer * self.num_experts + expert) * self.stride

    def get_record(self, layer: int, expert: int, *, prio: int = 0, gen: int = 0) -> np.ndarray:
        """uint8 array of the whole record (stride bytes): a read-only view
        (mmap) or a view (ram) of the blob, or a buffer of its own filled by
        one aligned read (direct) or by a priority-ordered read (sched: prio
        0 preempts prefetch reads at block granularity)."""
        base = self._record_base(layer, expert)
        if self._sched is not None:
            self._sched.submit(layer, expert, base, self.stride, prio=prio, gen=gen)
            return self._sched.wait(layer, expert)
        if self._native is not None:
            return self._native.read(base, self.stride)
        return self._buf[base: base + self.stride]

    def _fields_from(self, rec: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            f.name: rec[f.offset: f.offset + f.nbytes].view(np_dtype(f.dtype)).reshape(f.shape)
            for f in self.fields
        }

    def get_tensor(self, layer: int, expert: int, name: str) -> np.ndarray:
        if self._buf is None:  # direct/sched: one whole-record read
            return self._fields_from(self.get_record(layer, expert))[name]
        f = self._field_by_name[name]
        base = self._record_base(layer, expert)
        raw = self._buf[base + f.offset: base + f.offset + f.nbytes]
        return raw.view(np_dtype(f.dtype)).reshape(f.shape)

    def get_expert(self, layer: int, expert: int, *, prio: int = 0, gen: int = 0
                   ) -> Dict[str, np.ndarray]:
        if self._buf is None:
            return self._fields_from(self.get_record(layer, expert, prio=prio, gen=gen))
        return {f.name: self.get_tensor(layer, expert, f.name) for f in self.fields}

    def escalate(self, layer: int, expert: int) -> None:
        """Boost an in-flight scheduled read to on-demand priority (nothing
        outside ``sched``)."""
        if self._sched is not None:
            self._sched.escalate(layer, expert)

    def warm(self, layer: int, expert: int) -> None:
        """Touch a record to promote it into the page cache."""
        self.get_record(layer, expert)[:: mmap.PAGESIZE].sum()


class DenseArchiveWriter:
    """Blob + JSON index for the non-expert (dense) parameters."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self._f = open(os.path.join(path, "dense.blob"), "wb")
        self._entries: List[dict] = []
        self._off = 0

    def write(self, name: str, array: np.ndarray) -> None:
        """``array`` in a store dtype (bf16 as its ``uint16`` bits)."""
        a = np.ascontiguousarray(array)
        self._off = _align(self._off, 128)
        self._f.seek(self._off)
        self._f.write(a.tobytes())
        self._entries.append(
            {
                "name": name,
                "shape": list(a.shape),
                "dtype": dtype_name(a.dtype),
                "offset": self._off,
            }
        )
        self._off += a.nbytes

    def finalize(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        with open(os.path.join(self.path, "dense.index.json"), "w") as f:
            json.dump({"version": FORMAT_VERSION, "tensors": self._entries}, f)


class DenseArchive:
    """Reader of a dense archive: ``get`` returns a read-only view of the
    memory-mapped blob (bf16 as ``uint16`` bits), ``tensor`` a CPU tensor
    of the stored dtype (a copy)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "dense.index.json")) as f:
            index = json.load(f)
        self._entries = {e["name"]: e for e in index["tensors"]}
        with open(os.path.join(path, "dense.blob"), "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)

    def names(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def shape(self, name: str) -> List[int]:
        return list(self._entries[name]["shape"])

    def dtype(self, name: str) -> str:
        return self._entries[name]["dtype"]

    def get(self, name: str) -> np.ndarray:
        e = self._entries[name]
        dt = np_dtype(e["dtype"])
        n = int(np.prod(e["shape"], dtype=np.int64)) * dt.itemsize
        raw = self._buf[e["offset"] : e["offset"] + n]
        return raw.view(dt).reshape(e["shape"])

    def tensor(self, name: str) -> torch.Tensor:
        return to_tensor(self.get(name), self.dtype(name))


def param_getter(dense: "DenseArchive", compute_dtype: torch.dtype, device):
    """``get(name, dtype=None)``: the archive's tensor ``name`` on ``device``,
    matrices (2-D and up) in ``compute_dtype`` and the rest in f32 unless
    ``dtype`` is given: the casting rule of the JAX models' ``load_params``."""

    def get(name: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        t = dense.tensor(name)
        if dtype is None:
            dtype = compute_dtype if t.ndim >= 2 else torch.float32
        return t.to(device=device, dtype=dtype)

    return get


class SyntheticStore:
    """ExpertStore-protocol store with in-RAM pseudo-random records.

    For synthetic benchmarks at production geometry: host-to-device
    traffic, arena behaviour and kernel shapes are those of a real store
    without hundreds of GB on disk.

    distinct_records=False (default): every (layer, expert) returns views
    of ONE shared record buffer - cheapest, but all experts compute
    identical outputs, which makes routing degenerate-stable and flatters
    cache hit rates. distinct_records=True generates a deterministic
    per-(layer, expert) record on read (seeded, LRU-cached) so expert
    outputs - and therefore routing dynamics and cache pressure - behave
    like a real model's. The generator is numpy, so the records equal the
    JAX class's byte for byte.
    """

    def __init__(
        self,
        num_layers: int,
        num_experts: int,
        fields: Sequence[Tuple[str, Tuple[int, ...], str]],
        meta: Optional[dict] = None,
        seed: int = 0,
        distinct_records: bool = False,
        cache_records: int = 64,
    ):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.fields, self.stride = build_record_layout(fields)
        self._field_by_name = {f.name: f for f in self.fields}
        self.meta = dict(meta or {})
        self.seed = seed
        self.distinct = bool(distinct_records)
        self._cache_cap = max(1, cache_records)
        self._cache: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        self._cache_lock = threading.Lock()  # arena fetch workers race
        rng = np.random.default_rng(seed)
        self._tensors: Dict[str, np.ndarray] = {}
        for f in self.fields:
            self._tensors[f.name] = self._gen_field(rng, f)

    @staticmethod
    def _gen_field(rng, f) -> np.ndarray:
        if f.dtype in ("int8", "int4"):
            # raw bytes ARE valid int8/packed-int4 content; ~50x faster
            # than rng.integers at multi-MB field sizes
            n = int(np.prod(f.shape))
            return np.frombuffer(rng.bytes(n), dtype=np.int8).reshape(f.shape)
        if f.dtype == "float8_e4m3fn":
            # in pieces: one f64 draw of a Grok-1 expert's 604 M codes
            # would take 4.8 GB; the draws continue one stream, so the
            # codes equal one draw's
            n = int(np.prod(f.shape))
            out = np.empty(n, np.uint8)
            for lo in range(0, n, _FP8_PIECE):
                hi = min(n, lo + _FP8_PIECE)
                out[lo:hi] = fp8_bits(rng.standard_normal(hi - lo) * 0.02)
            return out.reshape(f.shape)
        x = rng.standard_normal(f.shape) * 0.02
        if f.dtype == "bfloat16":
            return bf16_bits(x)
        return x.astype(np_dtype(f.dtype))

    @property
    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def _record(self, layer: int, expert: int) -> Dict[str, np.ndarray]:
        if not self.distinct:
            return self._tensors
        key = (layer, expert)
        with self._cache_lock:
            rec = self._cache.get(key)
        if rec is None:
            rng = np.random.default_rng(self.seed + 1 + layer * self.num_experts + expert)
            rec = {f.name: self._gen_field(rng, f) for f in self.fields}
            with self._cache_lock:
                while len(self._cache) >= self._cache_cap:
                    self._cache.pop(next(iter(self._cache)), None)
                self._cache[key] = rec
        return rec

    def get_tensor(self, layer: int, expert: int, name: str) -> np.ndarray:
        return self._record(layer, expert)[name]

    def get_expert(self, layer: int, expert: int, *, prio: int = 0, gen: int = 0
                   ) -> Dict[str, np.ndarray]:
        return dict(self._record(layer, expert))


def store_exists(path: str) -> bool:
    """A finished store: both index files are written last, by ``finalize``."""
    return os.path.isfile(os.path.join(path, "experts.index.json")) and os.path.isfile(
        os.path.join(path, "dense.index.json")
    )
