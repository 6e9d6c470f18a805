"""Activation-aware expert cache policy, from
``moe_infinity_tpu/memory/cache_policy.py``: the live eviction policy of
the slot arena (``runtime/arena.py``).

* ``lru``        - evict oldest timestamp
* ``lru_layers`` - LRU, but layers in [current, current+3) are protected
* ``lfu``        - evict lowest visit frequency
* ``priority``   - evict lowest (layer-topology decay) x (per-seq decoder
  activation) x (global frequency), all normalized

For decoder-only models (no encoder layers) the topology decay is the
*cyclic* layer distance ahead of the current layer, since decode revisits
layer 0 right after layer L-1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

Key = Tuple[int, int]  # (layer, expert)

POLICIES = ("lru", "lru_layers", "lfu", "priority")


@dataclass
class ResidentInfo:
    timestamp: int = 0
    visits: int = 0


@dataclass
class CacheStats:
    """Hit-rate accounting."""

    visits: int = 0
    hits: int = 0
    misses: int = 0
    prefetches: int = 0
    prefetch_hits: int = 0  # visit served by a prefetched (not on-demand) copy
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.visits if self.visits else 0.0

    def as_dict(self) -> dict:
        return {
            "visits": self.visits,
            "hits": self.hits,
            "misses": self.misses,
            "prefetches": self.prefetches,
            "prefetch_hits": self.prefetch_hits,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }


class ExpertCachePolicy:
    def __init__(
        self,
        num_layers: int,
        num_experts: int,
        num_encoder_layers: int = 0,
        policy: str = "priority",
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown cache policy {policy!r}; options {POLICIES}")
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.num_encoder_layers = num_encoder_layers
        self.policy = policy
        self.resident: Dict[Key, ResidentInfo] = {}
        # key -> refcount: two executors sharing one arena (e.g. the
        # offload engine and the continuous batcher) may protect the same
        # key; one releasing must not strip the other's protection
        self.protected_ondemand: Dict[Key, int] = {}
        self.candidates: Set[Key] = set()  # prefetch-protected set
        self.frequency = np.zeros((num_layers, num_experts), dtype=np.float64)
        self.stats = CacheStats()
        # per-node counters: one [L, E] plane per metric
        self.node_stats = {
            name: np.zeros((num_layers, num_experts), dtype=np.int64)
            for name in (
                "visits", "hits", "misses",
                "prefetches", "prefetch_hits", "evictions",
            )
        }
        self._clock = 0
        self._was_prefetched: Set[Key] = set()

    # ---- residency bookkeeping (called by the arena) ----------------------
    def on_insert(self, key: Key, prefetched: bool = False) -> None:
        self._clock += 1
        self.resident[key] = ResidentInfo(timestamp=self._clock)
        if prefetched:
            self.stats.prefetches += 1
            self.node_stats["prefetches"][key] += 1
            self._was_prefetched.add(key)

    def on_evict(self, key: Key) -> None:
        self.resident.pop(key, None)
        self._was_prefetched.discard(key)
        self.stats.evictions += 1
        self.node_stats["evictions"][key] += 1

    def record_visit(self, key: Key, hit: bool) -> None:
        self._clock += 1
        self.stats.visits += 1
        self.frequency[key] += 1
        self.node_stats["visits"][key] += 1
        if hit:
            self.stats.hits += 1
            self.node_stats["hits"][key] += 1
            if key in self._was_prefetched:
                self.stats.prefetch_hits += 1
                self.node_stats["prefetch_hits"][key] += 1
        else:
            self.stats.misses += 1
            self.node_stats["misses"][key] += 1
        info = self.resident.get(key)
        if info is not None:
            info.timestamp = self._clock
            info.visits += 1

    def hit_rate_matrix(self) -> np.ndarray:
        """Per-node hit rate [L, E] (visits==0 -> 0)."""
        v = self.node_stats["visits"]
        h = self.node_stats["hits"]
        return np.divide(
            h, v, out=np.zeros(v.shape, dtype=np.float64), where=v > 0
        )

    # ---- protection -------------------------------------------------------
    def protect(self, key: Key) -> None:
        self.protected_ondemand[key] = self.protected_ondemand.get(key, 0) + 1

    def unprotect(self, key: Key) -> None:
        n = self.protected_ondemand.get(key, 0) - 1
        if n > 0:
            self.protected_ondemand[key] = n
        else:
            self.protected_ondemand.pop(key, None)

    def replace_candidates(self, keys: Iterable[Key]) -> None:
        """Swap the prefetch-protected set."""
        self.candidates = set(keys)

    def _protected(self) -> Set[Key]:
        return set(self.protected_ondemand) | self.candidates

    # ---- scoring ----------------------------------------------------------
    def _topo_score(self, current_layer: int) -> np.ndarray:
        L, nenc = self.num_layers, self.num_encoder_layers
        score = np.zeros(L, dtype=np.float64)
        if nenc > 0:
            ndec = L - nenc
            for i in range(L):
                if current_layer < nenc:  # encoder phase
                    if i < nenc:
                        score[i] = 1.0 if i <= current_layer else 1.0 - i / nenc
                    else:
                        score[i] = (i - nenc) / (ndec + 1)
                else:  # decoder phase
                    if i < nenc:
                        # encoder rows CANNOT be routed again until the
                        # next request's prefill - during a decode of
                        # 100s of steps they are the stale tier. Scored
                        # like the live decoder hot set, their large
                        # prefill frequency would protect them and evict
                        # live decoder experts. Keep only a small
                        # tiebreak ordering among encoder rows so the
                        # next request still finds later-staged ones.
                        score[i] = 0.05 * (1.0 - i / nenc)
                    else:
                        score[i] = (
                            1.0
                            if i <= current_layer
                            else (i - nenc) / (ndec + 1)
                        )
        else:
            dist = (np.arange(L) - current_layer) % L  # layers ahead
            score = (L - dist).astype(np.float64) / L
        return score

    def _priority_matrix(
        self,
        current_layer: int,
        decoder_matrix: Optional[np.ndarray],
    ) -> np.ndarray:
        L, E = self.num_layers, self.num_experts
        freq = self.frequency.copy()
        if freq.sum() == 0:
            freq[:] = 1.0
        freq = freq / freq.sum() + 1e-6

        topo = np.repeat(self._topo_score(current_layer)[:, None], E, axis=1)
        topo = topo / topo.sum() + 1e-6

        if decoder_matrix is None or decoder_matrix.sum() == 0:
            dec = np.ones((L, E), dtype=np.float64)
        else:
            dec = decoder_matrix.astype(np.float64).copy()
        row_sums = dec.sum(axis=1, keepdims=True)
        dec = np.divide(dec, row_sums, out=np.full_like(dec, 1.0 / E), where=row_sums > 0)
        dec = dec / dec.sum() + 1e-6
        return topo * dec * freq

    def pick_victims(
        self,
        n: int,
        current_layer: int,
        decoder_matrix: Optional[np.ndarray] = None,
    ) -> List[Key]:
        """Return up to n resident (layer, expert) keys to evict, worst
        first. Protected keys are never returned."""
        protected = self._protected()
        keys = [k for k in self.resident if k not in protected]
        if not keys or n <= 0:
            return []
        if self.policy == "lru":
            scored = [(self.resident[k].timestamp, k) for k in keys]
        elif self.policy == "lru_layers":
            scored = [
                (
                    np.inf
                    if current_layer <= k[0] < current_layer + 3
                    else self.resident[k].timestamp,
                    k,
                )
                for k in keys
            ]
        elif self.policy == "lfu":
            scored = [(self.resident[k].visits, k) for k in keys]
        else:  # priority
            m = self._priority_matrix(current_layer, decoder_matrix)
            scored = [(m[k], k) for k in keys]
        scored.sort(key=lambda t: t[0])
        return [k for _, k in scored[:n]]
