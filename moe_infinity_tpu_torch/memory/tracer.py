"""Expert-activation tracing (EAMC - Expert Activation Matrix Collection),
from ``moe_infinity_tpu/memory/tracer.py``.

Per-sequence L x E activation-count matrices, a bounded collection of
finished matrices, and most-similar lookup by per-layer cosine similarity
restricted to layers *after* the current one. The matrices are tiny (L x E
is at most a few thousand floats), so everything is vectorized host numpy;
``update_entry`` takes the router's expert-id array for a whole step (any
shape); persistence is a single .npz with the collection, the access counts
and the inter-layer transition counts.
"""

from __future__ import annotations

import os
import threading
import uuid
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np


@dataclass
class TraceEntry:
    """One live sequence's activation matrix."""

    seq_id: str
    matrix: np.ndarray  # [L, E] float32 counts
    access: int = 0
    num_new_tokens: int = 0
    # last routed layer + its unique expert ids, for transition counting
    last_layer: int = -1
    last_experts: Optional[np.ndarray] = None


class ExpertTracer:
    """Bounded collection of per-sequence expert activation matrices."""

    def __init__(
        self,
        capacity: int,
        num_layers: int,
        num_experts: int,
        num_encoder_layers: int = 0,
    ):
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.capacity = capacity
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.num_encoder_layers = num_encoder_layers
        self.trace: Dict[str, TraceEntry] = {}
        self.trace_collection = np.zeros(
            (capacity, num_layers, num_experts), dtype=np.float32
        )
        self.collection_access = np.zeros(capacity, dtype=np.int64)
        self.persistent_capacity = 0  # loaded traces are never evicted
        # inter-layer expert transition counts ((L-1) x E x E, exported by
        # get_trace and imported by set_trace): transitions[l, i, j]
        # counts steps where expert i was routed at
        # layer l and expert j at layer l+1
        self.transitions = np.zeros(
            (max(0, num_layers - 1), num_experts, num_experts),
            dtype=np.float32,
        )
        self._lock = threading.Lock()

    # ---- live entries ----------------------------------------------------
    def create_entry(self, seq_id: Optional[str] = None) -> str:
        seq_id = seq_id or uuid.uuid4().hex
        with self._lock:
            self.trace[seq_id] = TraceEntry(
                seq_id,
                np.zeros((self.num_layers, self.num_experts), dtype=np.float32),
            )
        return seq_id

    def update_entry(
        self, seq_id: str, expert_ids: np.ndarray, layer_idx: int
    ) -> None:
        """Count router activations for one layer of one step.

        expert_ids: any-shape int array of routed expert ids (e.g. [T, K]).
        """
        entry = self.trace[seq_id]
        ids = np.asarray(expert_ids).reshape(-1)
        np.add.at(entry.matrix[layer_idx], ids, 1.0)
        uniq = np.unique(ids)
        if entry.last_layer == layer_idx - 1 and entry.last_experts is not None:
            with self._lock:
                np.add.at(
                    self.transitions[layer_idx - 1],
                    (entry.last_experts[:, None], uniq[None, :]),
                    1.0,
                )
        entry.last_layer = layer_idx
        entry.last_experts = uniq
        if layer_idx == self.num_layers - 1:
            entry.num_new_tokens += 1

    def finish_entry(self, seq_id: str) -> None:
        """Store a finished sequence matrix into the collection, evicting the
        least-accessed non-persistent slot when full."""
        with self._lock:
            entry = self.trace.pop(seq_id)
            sums = self.trace_collection.sum(axis=(1, 2))
            empty = np.flatnonzero(sums == 0)
            if empty.size:
                idx = int(empty[0])
            else:
                access = self.collection_access.astype(np.float64).copy()
                access[: self.persistent_capacity] = np.inf
                idx = int(np.argmin(access))
            self.trace_collection[idx] = entry.matrix
            self.collection_access[idx] = 1

    def get_entry(self, seq_id: str) -> TraceEntry:
        return self.trace[seq_id]

    def get_entry_decoder(self, seq_id: str) -> TraceEntry:
        """Copy of the entry with encoder-layer rows zeroed (the
        decoder-phase scoring input)."""
        entry = self.trace[seq_id]
        m = entry.matrix.copy()
        m[: self.num_encoder_layers, :] = 0
        return TraceEntry(entry.seq_id, m, entry.access, entry.num_new_tokens)

    # ---- similarity lookup -------------------------------------------------
    def find_most_similar(self, matrix: np.ndarray, layer_idx: int) -> np.ndarray:
        """Return the collection matrix most similar to `matrix`.

        Layers <= layer_idx are neutralized in the collection so the match is
        decided by the *future*-layer activation pattern (which, during
        decode, `matrix` has populated from earlier tokens). Per-layer cosine
        over the expert dim, averaged over layers.
        """
        coll = self.trace_collection.copy()  # [C, L, E]
        coll[:, : layer_idx + 1, :] = 1e-9
        coll_sum = coll.sum(axis=2, keepdims=True)
        coll_n = np.divide(coll, coll_sum, out=np.zeros_like(coll), where=coll_sum > 0)

        m = matrix.astype(np.float32)
        m_sum = m.sum(axis=1, keepdims=True)
        m_n = np.divide(m, m_sum, out=np.zeros_like(m), where=m_sum > 0)

        dot = np.einsum("le,cle->cl", m_n, coll_n)
        norm = np.linalg.norm(m_n, axis=1)[None, :] * np.linalg.norm(coll_n, axis=2)
        cos = np.divide(dot, norm + 1e-6)
        sim = cos.mean(axis=1)  # [C]
        idx = int(np.argmax(sim))
        self.collection_access[idx] += 1
        return self.trace_collection[idx].copy()

    # ---- transition trace ----------------------------------------------------
    def get_trace(self) -> np.ndarray:
        """Copy of the (L-1, E, E) inter-layer transition counts."""
        with self._lock:
            return self.transitions.copy()

    def set_trace(self, transitions: np.ndarray) -> None:
        """Import transition counts; shape-checked."""
        t = np.asarray(transitions, dtype=np.float32)
        if t.shape != self.transitions.shape:
            raise ValueError(
                f"transition trace shape {t.shape} != "
                f"{self.transitions.shape}"
            )
        with self._lock:
            self.transitions = t.copy()

    # ---- persistence ("knowledge checkpoint") -------------------------------
    def save_trace(self, path: Union[str, os.PathLike]) -> None:
        np.savez(
            path,
            collection=self.trace_collection,
            access=self.collection_access,
            transitions=self.transitions,
        )

    def load_trace(self, trace: Union[str, os.PathLike, np.ndarray]) -> None:
        if isinstance(trace, np.ndarray):
            coll = trace.astype(np.float32)
            access = np.ones(coll.shape[0], dtype=np.int64)
        else:
            with np.load(trace, allow_pickle=False) as data:
                if "collection" in data:
                    coll = data["collection"].astype(np.float32)
                    access = data["access"].astype(np.int64)
                else:  # bare .npy-style array saved under the default key
                    coll = data[data.files[0]].astype(np.float32)
                    access = np.ones(coll.shape[0], dtype=np.int64)
                if "transitions" in data:
                    self.set_trace(data["transitions"])
        n = coll.shape[0]
        if n > self.capacity:
            raise ValueError(
                f"loaded trace capacity {n} exceeds configured {self.capacity}"
            )
        if coll.shape[1:] != (self.num_layers, self.num_experts):
            raise ValueError(
                f"trace shape {coll.shape[1:]} != model "
                f"({self.num_layers}, {self.num_experts})"
            )
        self.trace_collection[:n] = coll
        self.collection_access[:n] = access
        self.persistent_capacity = n
