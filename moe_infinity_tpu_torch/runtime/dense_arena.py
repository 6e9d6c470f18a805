"""Dense-layer paging: a slot arena for whole transformer blocks, from
``moe_infinity_tpu/runtime/dense_arena.py``.

The same indirection as the expert arena: one fixed-shape device tensor per
leaf of a layer's parameter tree, ``[num_slots, *leaf]``, and a host table
layer -> slot. A layer runs on ``leaf[slot]`` with ``slot`` a Python int,
which is a view: nothing is copied to read a slot (indexing with a device
tensor would copy the whole layer).

Access is sequential (0, 1, ..., L-1 every step), so the policy is a cyclic
ring: evict the resident layer whose next use is furthest away ((li -
current) mod L largest: the block just behind the clock) and prefetch
``ahead`` layers past the clock, wrapping at L as the JAX arena does (over a
seq2seq engine's combined encoder + decoder stack a decode step that ends at
the last decoder block therefore prefetches encoder blocks; the arena counts
such landings that no acquire read before their eviction,
``copy_stats()["unread_landings"]``).

Heterogeneous stacks (NLLB's dense and sparse blocks, DeepSeek's leading
dense layer) are grouped by their (structure, shapes, dtypes) signature;
each group has its own slot tensors, at least 2 slots, split by membership.

On the card the host layers are page-locked once (a tensor that several
layers share is pinned once), and worker threads land a layer with
``copy_(non_blocking=True)`` on their own stream. Stream order takes the
place of the JAX arena's dispatch leases:

* read after write: ``acquire`` makes the current stream wait on the slot's
  landing event before it returns the slot;
* write after read: ``release`` records an event on the current stream
  after the layer's kernels were queued; a landing into that slot waits on
  it (and on the slot's previous landing) on the worker's stream.

``acquire``/``release`` also protect the layer on the host, as in JAX.
On the CPU (``device="cpu"``) copies are synchronous and no event is made.

``PagedDenseEngine`` is the stepper of ``Generator`` for dense-only models
(OPT) whose stack exceeds the budget: embed, then per layer acquire ->
``dense_layer`` on the slot's view -> release, then the head, eagerly.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from typing import Any, Dict, List, Optional, Tuple

import torch

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("dense_arena")

PRIO_ONDEMAND = 0
PRIO_PREFETCH = 1


# ---------------------------------------------------------------------------
# parameter trees: nested dicts, lists and tuples of tensors (None is
# structure), flattened in JAX's order (dict keys sorted)
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            lv, d = tree_flatten(tree[k])
            leaves += lv
            defs.append(d)
        return leaves, ("dict", tuple(keys), tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for item in tree:
            lv, d = tree_flatten(item)
            leaves += lv
            defs.append(d)
        return leaves, (type(tree).__name__, len(tree), tuple(defs))
    if tree is None:
        return [], None
    return [tree], "*"


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d == "*":
            return next(it)
        if d is None:
            return None
        kind, keys, defs = d
        if kind == "dict":
            return {k: build(sd) for k, sd in zip(keys, defs)}
        items = [build(sd) for sd in defs]
        return items if kind == "list" else tuple(items)

    return build(treedef)


def tree_map(fn, tree) -> Any:
    """``tree`` with ``fn`` applied to each leaf."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(t) for t in leaves])


def _signature(leaves, treedef) -> Tuple:
    return (repr(treedef), tuple((tuple(t.shape), str(t.dtype)) for t in leaves))


class DenseLayerArena:
    """Slot arena over host-resident per-layer parameter trees."""

    def __init__(
        self,
        layers_host: List[Any],  # per-layer trees of CPU tensors
        num_slots: int,
        *,
        device="cuda",
        num_threads: int = 2,
        ahead: Optional[int] = None,
    ):
        if num_slots < 2:
            raise ValueError("dense paging needs num_slots >= 2")
        self.L = len(layers_host)
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.ahead = ahead if ahead is not None else max(1, num_slots - 2)

        # ---- group layers by structure signature, pin the host layers ---
        t0 = _time.perf_counter()
        pinned: Dict[int, torch.Tensor] = {}  # id(host tensor) -> its page-locked copy

        def host(t: torch.Tensor) -> torch.Tensor:
            if not self._cuda:
                return t
            p = pinned.get(id(t))
            if p is None:
                p = pinned[id(t)] = t.contiguous().pin_memory()
            return p

        self._group_of: List[int] = []
        self._groups: List[dict] = []
        sig_to_gid: Dict[Tuple, int] = {}
        self._host: List[List[torch.Tensor]] = []
        for li, lt in enumerate(layers_host):
            leaves, treedef = tree_flatten(lt)
            self._host.append([host(t) for t in leaves])
            sig = _signature(leaves, treedef)
            gid = sig_to_gid.get(sig)
            if gid is None:
                gid = sig_to_gid[sig] = len(self._groups)
                self._groups.append({"treedef": treedef, "members": []})
            self._group_of.append(gid)
            self._groups[gid]["members"].append(li)
        self.pin_seconds = _time.perf_counter() - t0
        self.host_bytes = sum(p.numel() * p.element_size() for p in pinned.values())

        # slots are split across groups by membership, at least 2 each (the
        # ring must advance) and at most the group's layer count; what the
        # minimums overshoot comes off the largest groups
        wants = [max(2, min(len(g["members"]), round(num_slots * len(g["members"]) / self.L)))
                 for g in self._groups]
        while sum(wants) > max(num_slots, 2 * len(self._groups)):
            i = max(range(len(wants)), key=lambda j: (wants[j], -j))
            if wants[i] <= 2:
                break
            wants[i] -= 1
        for g, want in zip(self._groups, wants):
            leaves = self._host[g["members"][0]]
            g["arena"] = [torch.zeros((want,) + tuple(t.shape), dtype=t.dtype, device=self.device)
                          for t in leaves]
            g["num_slots"] = want
            g["free"] = list(range(want - 1, -1, -1))
            # per slot: its newest landing event and the event after the
            # last kernels that read it (the card only)
            g["landed"] = [None] * want
            g["read_done"] = [None] * want
        self.num_slots = sum(g["num_slots"] for g in self._groups)
        self.layer_bytes = [sum(t.numel() * t.element_size() for t in lv) for lv in self._host]

        # ---- residency state ---------------------------------------------
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # serializes executors (the contract of ExpertArena.client_lock)
        self.client_lock = threading.RLock()
        self.layer_to_slot: Dict[int, int] = {}
        self._protected: set = set()
        self._queue: List[Tuple[int, int, int]] = []  # (prio, seq, layer)
        self._seq = itertools.count()
        self._in_flight: Dict[int, threading.Event] = {}
        self._fetching: set = set()
        self._errors: Dict[int, Exception] = {}
        self._clock = 0  # the current layer
        self._shutdown = False
        self.hits = 0
        self.misses = 0
        # landings, their bytes, and landings no acquire read before eviction
        self._unread: set = set()
        self._copy = {"landings": 0, "bytes_landed": 0, "unread_landings": 0,
                      "unread_bytes": 0}
        self._landed_by_layer = [0] * self.L
        self._workers = [
            threading.Thread(target=self._worker, daemon=True, name=f"dense-fetch-{i}")
            for i in range(max(1, num_threads))
        ]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------------
    def group_of(self, li: int) -> int:
        return self._group_of[li]

    @property
    def device_bytes(self) -> int:
        """Bytes of every group's slot tensors."""
        return sum(t.numel() * t.element_size() for g in self._groups for t in g["arena"])

    @property
    def group_slots(self) -> List[Tuple[int, int]]:
        """(slots, member layers) of each group."""
        return [(g["num_slots"], len(g["members"])) for g in self._groups]

    def tree(self, gid: int) -> List[torch.Tensor]:
        """The group's slot tensors, one per leaf."""
        return self._groups[gid]["arena"]

    def layer_view(self, li: int, slot: int):
        """Layer ``li``'s parameter tree as views of its slot (``slot`` from
        ``acquire``): ``leaf[slot]`` with a Python int copies nothing."""
        g = self._groups[self._group_of[li]]
        return tree_unflatten(g["treedef"], [a[slot] for a in g["arena"]])

    def acquire(self, li: int) -> int:
        """Block until layer li is resident; returns its slot and protects
        it until release(). On the card the current stream waits on the
        slot's landing. Also advances the prefetch clock."""
        with self._cv:
            self._clock = li
            self._protected.add(li)
            slot = self.layer_to_slot.get(li)
            if slot is not None:
                self.hits += 1
            else:
                self.misses += 1
                self._errors.pop(li, None)
                ev = self._in_flight.get(li)
                if ev is None:
                    ev = self._in_flight[li] = threading.Event()
                heapq.heappush(self._queue, (PRIO_ONDEMAND, next(self._seq), li))
                self._cv.notify_all()
            # schedule the window ahead, wrapping at L
            for d in range(1, self.ahead + 1):
                nxt = (li + d) % self.L
                if nxt not in self.layer_to_slot and nxt not in self._in_flight:
                    self._in_flight[nxt] = threading.Event()
                    heapq.heappush(self._queue, (PRIO_PREFETCH, next(self._seq), nxt))
                    self._cv.notify_all()
            if slot is not None:
                return self._read_after_landing(li, slot)
            ev = self._in_flight.get(li) or threading.Event()
        if not ev.wait(timeout=300.0):
            raise TimeoutError(f"dense layer fetch timed out for {li}")
        with self._lock:
            slot = self.layer_to_slot.get(li)
            if slot is None:
                err = self._errors.pop(li, None)
                raise err or RuntimeError(f"dense layer {li} neither landed nor errored")
            return self._read_after_landing(li, slot)

    def _read_after_landing(self, li: int, slot: int) -> int:
        """(under the lock) The layer is read from here on: the current
        stream waits on its landing."""
        self._unread.discard(li)
        landed = self._groups[self._group_of[li]]["landed"][slot]
        if landed is not None:
            torch.cuda.current_stream(self.device).wait_event(landed)
        return slot

    def release(self, li: int) -> None:
        """Call after the layer's reads were queued on the current stream: a
        landing into its slot waits on an event recorded here."""
        ev = None
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        with self._lock:
            slot = self.layer_to_slot.get(li)
            if ev is not None and slot is not None:
                self._groups[self._group_of[li]]["read_done"][slot] = ev
            self._protected.discard(li)

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout=30.0)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "dense_hits": self.hits,
            "dense_misses": self.misses,
            "dense_hit_rate": self.hits / total if total else 1.0,
        }

    def copy_stats(self) -> dict:
        """Landings and their bytes, and the landings no acquire read before
        their eviction (the wrapped prefetch window's)."""
        with self._lock:
            return dict(self._copy)

    def landings_by_layer(self) -> List[int]:
        """Landings of each layer so far."""
        with self._lock:
            return list(self._landed_by_layer)

    # ------------------------------------------------------------------
    def _next_order_locked(self):
        """Pop the next order and give it a slot: (layer, group, slot,
        fences), or None after shutdown."""
        while True:
            while not self._queue and not self._shutdown:
                self._cv.wait()
            if self._shutdown:
                return None
            prio, _, li = heapq.heappop(self._queue)
            if li in self.layer_to_slot or li in self._fetching or li not in self._in_flight:
                continue
            slot = self._allocate_slot_locked(li)
            if slot is None:
                if prio == PRIO_ONDEMAND:
                    # wait for a landing or a release to free something
                    heapq.heappush(self._queue, (prio, next(self._seq), li))
                    self._cv.wait(timeout=0.02)
                    continue
                del self._in_flight[li]  # a prefetch: drop the order
                continue
            self._fetching.add(li)
            gid = self._group_of[li]
            g = self._groups[gid]
            fences = [e for e in (g["landed"][slot], g["read_done"][slot]) if e is not None]
            return li, gid, slot, fences

    def _worker(self) -> None:
        stream = None
        if self._cuda:
            torch.cuda.set_device(self.device)
            stream = torch.cuda.Stream(device=self.device)
        while True:
            with self._cv:
                order = self._next_order_locked()
            if order is None:
                return
            li, gid, slot, fences = order
            try:
                landed = self._land(li, gid, slot, stream, fences)
            except Exception as e:  # noqa: BLE001 - surfaced in the waiter
                logger.exception("landing of dense layer %d failed", li)
                if stream is not None:
                    stream.synchronize()  # drain copies queued before the failure
                with self._cv:
                    self._errors[li] = e
                    self._fetching.discard(li)
                    self._groups[gid]["free"].append(slot)
                    ev = self._in_flight.pop(li, None)
                    self._cv.notify_all()
                if ev is not None:
                    ev.set()
                continue
            with self._cv:
                self._groups[gid]["landed"][slot] = landed
                self.layer_to_slot[li] = slot
                self._fetching.discard(li)
                self._unread.add(li)
                self._copy["landings"] += 1
                self._copy["bytes_landed"] += self.layer_bytes[li]
                self._landed_by_layer[li] += 1
                ev = self._in_flight.pop(li, None)
                self._cv.notify_all()
            if ev is not None:
                ev.set()

    def _land(self, li: int, gid: int, slot: int, stream, fences):
        """Copy layer li into ``slot`` of its group. On the card: on the
        worker's stream, after ``fences``, returning the landing event."""
        arena = self._groups[gid]["arena"]
        if stream is None:
            for a, h in zip(arena, self._host[li]):
                a[slot].copy_(h)
            return None
        with torch.cuda.stream(stream):
            for ev in fences:
                stream.wait_event(ev)
            for a, h in zip(arena, self._host[li]):
                a[slot].copy_(h, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(stream)
        return landed

    def _allocate_slot_locked(self, li: int) -> Optional[int]:
        gid = self._group_of[li]
        g = self._groups[gid]
        if g["free"]:
            return g["free"].pop()
        # evict the group member whose next use is furthest in the cyclic
        # layer order (the block just behind the clock)
        victim, best = None, -1
        for cand in self.layer_to_slot:
            if self._group_of[cand] != gid or cand in self._protected or cand in self._fetching:
                continue
            dist = (cand - self._clock) % self.L
            if dist > best:
                victim, best = cand, dist
        if victim is None:
            return None
        if victim in self._unread:
            self._unread.discard(victim)
            self._copy["unread_landings"] += 1
            self._copy["unread_bytes"] += self.layer_bytes[victim]
        return self.layer_to_slot.pop(victim)


class PagedDenseEngine:
    """Stepper of ``Generator`` for dense-only models (OPT) whose layer stack
    exceeds the device budget: every layer pages through a
    ``DenseLayerArena`` with prefetch ahead, eagerly (one K/V cache per
    layer, written in place)."""

    speculative = False

    def __init__(self, model, resident_params, arena: DenseLayerArena):
        self.model = model
        self.params = resident_params  # the top-level params; the layers
        self.arena = arena             # live in the arena

    # ---- stepper protocol ------------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        return self.model.init_cache(batch, max_len)

    def begin_sequences(self, batch: int):
        return None

    def end_sequences(self, seq_ids) -> None:
        pass

    def forward(self, tokens, positions, kv_caches, kv_len: int, seq_ids=None):
        """(logits [B, T, V] f32, the caches (written in place), None)."""
        model, arena = self.model, self.arena
        x = model.embed_step(self.params, tokens, positions)
        for li in range(model.spec.num_layers):
            slot = arena.acquire(li)
            try:
                x, kv_caches[li] = model.dense_layer(
                    arena.layer_view(li, slot), x, kv_caches[li], positions, kv_len)
            finally:
                arena.release(li)
        return model.head(self.params, x), kv_caches, None

    def stats(self) -> dict:
        return self.arena.stats()

    def hit_rate(self) -> float:
        return self.arena.stats()["dense_hit_rate"]
