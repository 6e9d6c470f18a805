"""Paged KV cache: a fixed page pool per layer and per-sequence page tables,
from ``moe_infinity_tpu/runtime/paged_kv.py``.

K/V storage is a pool of fixed-size pages (``[num_pages, page_size, Hkv,
Dh]`` per layer); each batch row reads its logical columns through an int32
page table, and a host-side allocator hands out pages as sequences grow and
takes them back when requests finish. Sequences of different lengths share
the pool, so serving capacity is bounded by live tokens rather than by
``max_len x batch``.

``PagedKVCache`` quacks like ``models.layers.KVCache``: ``.k``/``.v``
gather the logical ``[B, P * page, Hkv, Dh]`` views and ``.update()``
writes into the pool, so a decoder-only model runs on it unchanged, and
``models.layers.attend_cache`` reads the pool in place on one-token steps.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

import numpy as np
import torch

from moe_infinity_tpu_torch import resolve_device


class PagedKVCache:
    """One layer's pools ``pool_k``/``pool_v`` ``[NP, page, Hkv, Dh]`` and the
    batch's ``page_table`` ``[B, P]`` int32 physical page ids."""

    def __init__(self, pool_k: torch.Tensor, pool_v: torch.Tensor,
                 page_table: torch.Tensor):
        self.pool_k = pool_k
        self.pool_v = pool_v
        self.page_table = page_table

    @property
    def page_size(self) -> int:
        return self.pool_k.shape[1]

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    def _view(self, pool):
        B = self.page_table.shape[0]
        g = pool[self.page_table.long()]  # [B, P, page, Hkv, Dh]
        return g.reshape(B, self.max_len, *pool.shape[2:])

    @property
    def k(self) -> torch.Tensor:
        """Logical [B, P * page, Hkv, Dh] view (a gathered copy)."""
        return self._view(self.pool_k)

    @property
    def v(self) -> torch.Tensor:
        return self._view(self.pool_v)

    def update(self, k_new, v_new, offset: int) -> "PagedKVCache":
        """Write [B, T, Hkv, Dh] at logical columns [offset, offset + T):
        row t of batch row b lands in page ``page_table[b, col // page]``,
        slot ``col % page``. Writes the pools in place (the JAX version
        returns a new cache) and returns self. Rows whose table points at
        the same page (the batcher's null page 0) overwrite each other in
        no fixed order; attention masks those columns."""
        B, T = k_new.shape[:2]
        cols = offset + torch.arange(T, device=self.page_table.device)
        pages = self.page_table[:, cols // self.page_size].long()  # [B, T]
        slots = (cols % self.page_size).expand(B, T)
        self.pool_k[pages, slots] = k_new.to(self.pool_k.dtype)
        self.pool_v[pages, slots] = v_new.to(self.pool_v.dtype)
        return self


class PageAllocator:
    """Host-side page bookkeeping for one model (all layers share table
    shapes; each layer has its own pool)."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        # seq_id -> {logical page index -> physical page id}
        self._owned: dict = {}
        self._lock = threading.Lock()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, seq_id, num_tokens: int, start_token: int = 0) -> dict:
        """Pages covering token columns [start_token, num_tokens) for a
        sequence (extends an existing allocation). A request admitted at
        column C holds no pages for columns < C, so late joiners share a
        long timeline without tying up the pool. Raises if the pool is
        exhausted."""
        first = start_token // self.page_size
        last = -(-num_tokens // self.page_size)  # exclusive
        with self._lock:
            have = self._owned.setdefault(seq_id, {})
            for idx in range(first, last):
                if idx in have:
                    continue
                if not self._free:
                    raise RuntimeError(
                        f"KV page pool exhausted ({self.num_pages} pages)"
                    )
                have[idx] = self._free.pop()
            return dict(have)

    def release(self, seq_id) -> None:
        with self._lock:
            for p in self._owned.pop(seq_id, {}).values():
                self._free.append(p)

    def table(self, seq_ids: Sequence, max_pages: int) -> np.ndarray:
        """[B, max_pages] int32 table; unused entries point at page 0 (rows
        outside each sequence's owned column range are masked by
        attention)."""
        out = np.zeros((len(seq_ids), max_pages), dtype=np.int32)
        with self._lock:
            for b, sid in enumerate(seq_ids):
                for idx, phys in self._owned.get(sid, {}).items():
                    if idx < max_pages:
                        out[b, idx] = phys
        return out


def init_paged_caches(
    num_layers: int,
    num_pages: int,
    page_size: int,
    n_kv: int,
    head_dim: int,
    dtype,
    batch: int,
    max_pages_per_seq: int,
    device="cuda",
) -> List[PagedKVCache]:
    """Zeroed pools for every layer and one shared all-zero page table."""
    dev = resolve_device(device)
    shape = (num_pages, page_size, n_kv, head_dim)
    table = torch.zeros(batch, max_pages_per_seq, dtype=torch.int32, device=dev)
    return [
        PagedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                     torch.zeros(shape, dtype=dtype, device=dev), table)
        for _ in range(num_layers)
    ]
