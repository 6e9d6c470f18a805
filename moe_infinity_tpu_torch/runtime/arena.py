"""Device expert slot arena + host-side fetch controller, from
``moe_infinity_tpu/runtime/arena.py``.

* one fixed-shape stacked tensor per FFN role - ``[num_slots, in, out]`` -
  lives on the device for the whole process; residency changes are
  in-place copies into one slot;
* a host-side slot table maps (moe_layer, expert) -> slot; the per-layer
  ``expert_to_slot[E]`` row goes to the grouped FFN (K3) as a small int32
  tensor each step, -1 for an expert that is not resident;
* a priority fetch queue (on-demand = 0 beats prefetch = 1) drained by
  worker threads;
* eviction is delegated to ``memory/cache_policy.py`` (activation-aware),
  with on-demand and prefetch-candidate protection.

Landing, on the card. Each worker owns a ``torch.cuda.Stream``. A record
staged in the pinned tier (``store/pinned.py``) lands by
``slot.copy_(segment[row], non_blocking=True)``; any other record is read
from the store, written into the worker's page-locked staging buffer, and
copied the same way. The worker waits for its copy to finish before it
takes the next order, so its staging buffer is free again and
``fetch_seconds_ewma`` measures whole fetches. Stream order takes the
place of the JAX package's donation and dispatch leases:

* read after write: a key is registered once its copy is queued, so the
  compute stream waits on the landing event of every slot it reads
  (``locked_tree(keys)``);
* write after read: a slot is evicted as soon as its key is released,
  while the K3 launch that read it may still be queued. When a
  ``locked_tree`` or ``dispatch_snapshot`` scope ends it records an event
  on the compute stream; a worker's stream waits on the newest such event,
  and on the slot's previous landing, before it overwrites the slot.

A speculative dispatch (``dispatch_snapshot``) reads the slots of keys it
has not acquired, so a worker may evict one of them and queue the copy of
another record into its slot before the scope ends: that copy is fenced
only by the previous scope's event. The arena does not hold the copy back
(fetches go on overlapping the dispatch); it records every key evicted
while the scope is open and takes it out of the scope's resident set when
the scope ends, so verification counts it as a miss and the execution that
may have read the new record is never accepted.

On the CPU (``device="cpu"``) copies are synchronous and no event is made.

Slots keep the stored bytes: int8, packed int4 and ``float8_e4m3fn`` codes
(as the JAX arena's ``jnp.float8_e4m3fn`` slots), dequantized by K3. With
``dequant_on_write`` they hold the compute dtype instead (int4 unpacked to
its full ``2P`` columns, keyed without the ``4``, and no scale tensors): a
landing copies the stored bytes and dequantizes them into the slot, on the
card on the worker's stream after the copy and before the landing event,
and K3 runs its bf16 kind over them.

``reserve_zero_slot`` gives every slot tensor one more row, ``zero_slot =
num_slots``, all zeros and never allocated, landed into or evicted: the
engines' host fallback (``runtime/host_exec.py``) points a missed expert's
slot row there, so the grouped FFN contributes exactly 0 for it.

Not ported: ``tp_mirrors`` raises ``NotImplementedError`` (item 18b); the JAX
relay's upload knobs (``upload_chunk_bytes``, ``upload_threads``) have no
counterpart.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.memory.cache_policy import ExpertCachePolicy
from moe_infinity_tpu_torch.ops.moe import unpack_int4
from moe_infinity_tpu_torch.runtime.providers import _BIAS_TAILS, _ROLE_KEYS, role_map_for
from moe_infinity_tpu_torch.utils.dtypes import host_copy, torch_dtype
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("arena")

Key = Tuple[int, int]  # (moe_layer, expert)

PRIO_ONDEMAND = 0
PRIO_PREFETCH = 1


class ExpertArena:
    """Fixed-slot device arena over a host expert store."""

    def __init__(
        self,
        store,
        num_slots: int,
        *,
        policy: str = "priority",
        compute_dtype=torch.bfloat16,
        device="cuda",
        num_threads: int = 2,
        dequant_on_write: bool = False,
        reserve_zero_slot: bool = False,
        pinned_tier=None,
        tp_mirrors=None,
    ):
        """compute_dtype: the slot dtype of unquantized roles; int8 and
        packed int4 roles keep their stored bytes (K3 dequantizes), scales
        and biases are f32. dequant_on_write: quantized roles land
        dequantized into compute-dtype slots. reserve_zero_slot: one more
        all-zero row per slot tensor at ``zero_slot`` (the host fallback's).
        pinned_tier: a ``store.pinned.PinnedExpertTier`` over the same store;
        its staged records land from pinned memory, the rest through the
        store path."""
        if tp_mirrors:
            raise NotImplementedError(
                "tp_mirrors (tensor-parallel columns) are not ported (ROADMAP queue-1 item 18b)"
            )
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.store = store
        self.num_slots = num_slots
        # the all-zero row past the allocatable slots (the host fallback's)
        self.zero_slot: Optional[int] = num_slots if reserve_zero_slot else None
        rows = num_slots + (1 if reserve_zero_slot else 0)
        self.dequant_on_write = bool(dequant_on_write)
        self.num_layers = store.num_layers
        self.num_experts = store.num_experts
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.policy = ExpertCachePolicy(
            self.num_layers,
            self.num_experts,
            num_encoder_layers=store.meta.get("num_encoder_moe_layers", 0),
            policy=policy,
        )

        # ---- slot tensors -------------------------------------------------
        roles = role_map_for(store.meta)
        field_names = set(store.field_names)
        self._role_to_tail: Dict[str, str] = {}
        self._field_dtype: Dict[str, str] = {}  # source key -> store dtype name
        # source key -> (shape, dtype) of what a landing copies for it: the
        # slot's for a slot tensor, the stored record's for a role that is
        # dequantized on write (and its scale)
        self._src_spec: Dict[str, tuple] = {}
        self._dequant: Dict[str, str] = {}  # slot key -> its scale's source key
        arena: Dict[str, torch.Tensor] = {}

        def add(key, tail, dtype, slot_shape=None):
            f = store._field_by_name[tail]
            self._role_to_tail[key] = tail
            self._field_dtype[key] = f.dtype
            self._src_spec[key] = (f.shape, dtype)
            if slot_shape is not None:
                arena[key] = torch.zeros((rows,) + slot_shape, dtype=dtype, device=self.device)

        for role, tail in roles.items():
            if tail is None:
                continue
            key = _ROLE_KEYS[role]
            f = store._field_by_name[tail]
            quantized = f.dtype in ("int8", "int4", "float8_e4m3fn")
            if quantized and dequant_on_write:
                # stored bytes travel, the slot holds the compute dtype; an
                # int4 slot holds its unpacked 2P columns under the base key
                self._role_to_tail[key] = tail
                self._field_dtype[key] = f.dtype
                self._src_spec[key] = (f.shape, torch_dtype(f.dtype))
                shape = (f.shape[0], f.shape[1] * 2) if f.dtype == "int4" else f.shape
                arena[key] = torch.zeros((rows,) + shape, dtype=compute_dtype,
                                         device=self.device)
                add(key + "_scale", tail + ".scale", torch.float32)
                self._dequant[key] = key + "_scale"
                continue
            # quantized slots keep the stored bytes (int8, packed int4, fp8
            # codes) and K3 dequantizes; a packed int4 slot keeps the
            # '<role>4' key, its scale the base key
            sdt = torch_dtype(f.dtype) if quantized else compute_dtype
            add(key + "4" if f.dtype == "int4" else key, tail, sdt, f.shape)
            if tail + ".scale" in field_names:
                add(key + "_scale", tail + ".scale", torch.float32,
                    store._field_by_name[tail + ".scale"].shape)
        for tail, key in _BIAS_TAILS.items():
            if tail in field_names:
                add(key, tail, torch.float32, store._field_by_name[tail].shape)
        self._arena = arena
        self._tier = pinned_tier

        # ---- residency state (host) --------------------------------------
        self.slot_to_key: List[Optional[Key]] = [None] * num_slots
        self.key_to_slot: Dict[Key, int] = {}
        self.expert_to_slot = np.full(
            (self.num_layers, self.num_experts), -1, dtype=np.int32
        )  # -1 = not resident; grouped_ffn masks those to a zero contribution
        self._free_slots: List[int] = list(range(num_slots - 1, -1, -1))
        # stream order on the card: each slot's newest landing event, and
        # the newest event recorded on the compute stream as a dispatch's
        # reads were queued (see locked_tree)
        self._landed: List[Optional[torch.cuda.Event]] = [None] * num_slots
        self._read_done: Optional[torch.cuda.Event] = None
        # slots landed since the last dispatch_snapshot made its stream wait
        self._fresh_slots: set = set()
        # one set per open dispatch_snapshot: the keys evicted while it is open
        self._lease_evicted: List[set] = []
        # snapshot-resident keys that verification had to count as misses,
        # in all and in the last dispatch_snapshot scope
        self.lease_evictions = 0
        self.last_lease_lost: set = set()

        # ---- fetch machinery ---------------------------------------------
        self._lock = threading.Lock()  # protects all residency state
        # serializes EXECUTORS: two clients protecting key sets concurrently
        # could together pin more than num_slots and deadlock acquire
        self.client_lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[Tuple[int, int, int, Key]] = []  # (prio, gen, seq, key)
        self._seq = itertools.count()
        self._gen = 0  # prefetch generation; stale orders are dropped
        self._in_flight: Dict[Key, threading.Event] = {}
        self._escalated: set = set()  # keys a caller is blocked on
        self._errors: Dict[Key, Exception] = {}
        self._pending_fetches = 0  # slots allocated but not yet registered
        self._fetching: set = set()  # keys a worker is actively fetching
        self.current_layer = 0
        self._decoder_matrix: Optional[np.ndarray] = None
        self._shutdown = False
        # EWMA of whole per-expert fetch seconds (read or tier lookup, copy
        # and its completion) - the engine's adaptive prefetch budget reads it
        self.fetch_seconds_ewma: Optional[float] = None
        self.fetch_counts = {"tier": 0, "store": 0}
        self._workers = [
            threading.Thread(target=self._worker, daemon=True, name=f"arena-fetch-{i}")
            for i in range(max(1, num_threads))
        ]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def pytree(self) -> Dict[str, torch.Tensor]:
        """The slot tensors. Read them only inside ``locked_tree``."""
        return self._arena

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._arena.values())

    @property
    def num_workers(self) -> int:
        return len(self._workers)

    @contextmanager
    def locked_tree(self, keys: Sequence[Key] = ()):
        """Yield the slot tensors for one dispatch that reads the slots of
        ``keys`` (acquired, so resident and protected until ``release``).
        On the card the current stream first waits on each of those slots'
        landing events; when the scope ends, an event recorded on the
        current stream marks the dispatch's reads, and a worker waits on
        it before it overwrites any slot. Queue every read of the slots
        inside the scope, all on one stream, and release the keys after
        it."""
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            with self._lock:
                for key in keys:
                    ev = self._landed[self.key_to_slot[key]]
                    if ev is not None:
                        stream.wait_event(ev)
        try:
            yield self._arena
        finally:
            if self._cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                with self._lock:
                    self._read_done = ev

    @contextmanager
    def dispatch_snapshot(self, timings: Optional[dict] = None):
        """Yield (slot tensors, slot rows [L, E] int32 on the device, resident
        keys) for one speculative dispatch, taken together under the
        residency lock; the rows are a copy, uploaded once, synchronously,
        before the scope's launches. Queue every read of the slots inside the
        scope, all on the current stream; the stream first waits on every
        landing it has not waited on yet, so each resident slot holds its
        record. A key evicted while the scope is open leaves the resident
        set when the scope ends (its slot may have been overwritten under
        the queued reads): judge the execution on the set after the scope.
        timings: ``lock_wait_s`` accumulates the wait for the lock."""
        t0 = _time.perf_counter()
        with self._lock:
            if timings is not None:
                timings["lock_wait_s"] = (timings.get("lock_wait_s", 0.0)
                                          + _time.perf_counter() - t0)
            rows = self.expert_to_slot.copy()
            resident = set(self.key_to_slot)
            evicted: set = set()
            self._lease_evicted.append(evicted)
            fresh = [self._landed[s] for s in self._fresh_slots]
            self._fresh_slots.clear()
        try:
            # the upload waits for the stream, so it goes before the waits
            slot_rows = torch.from_numpy(rows).to(self.device)
            if self._cuda:
                stream = torch.cuda.current_stream(self.device)
                for ev in fresh:
                    stream.wait_event(ev)
            yield self._arena, slot_rows, resident
        finally:
            ev = None
            if self._cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
            with self._lock:
                if ev is not None:
                    self._read_done = ev
                self._lease_evicted.remove(evicted)
                lost = resident & evicted
                self.lease_evictions += len(lost)
                self.last_lease_lost = lost
                resident -= lost

    def slot_map(self, moe_layer: int) -> np.ndarray:
        """int32 [E] expert->slot row for one layer: a copy taken under the
        lock (workers rewrite the table)."""
        with self._lock:
            return self.expert_to_slot[moe_layer].copy()

    def is_resident(self, key: Key) -> bool:
        return key in self.key_to_slot

    def hit_stats(self) -> dict:
        return self.policy.stats.as_dict()

    def node_stats(self) -> dict:
        """Per-(layer, expert) counter planes + hit-rate matrix."""
        out = {k: v.copy() for k, v in self.policy.node_stats.items()}
        out["hit_rate_matrix"] = self.policy.hit_rate_matrix()
        return out

    def set_context(self, layer: int, decoder_matrix: Optional[np.ndarray] = None):
        """Update the eviction-scoring context (current layer + the active
        sequence's decoder activation matrix)."""
        self.current_layer = layer
        if decoder_matrix is not None:
            self._decoder_matrix = decoder_matrix

    def _enqueue_ondemand_locked(self, keys: Sequence[Key], layer: int):
        """Protect and count every key; queue the misses at top priority.
        Returns [(key, in-flight event)] of the misses."""
        events = []
        self.current_layer = layer
        for key in keys:
            self.policy.protect(key)
            hit = key in self.key_to_slot
            self.policy.record_visit(key, hit=hit)
            if hit:
                continue
            # a fresh fetch supersedes any error a PREVIOUS failed
            # acquire left for this key
            self._errors.pop(key, None)
            ev = self._in_flight.get(key)
            if ev is None:
                ev = threading.Event()
                self._in_flight[key] = ev
            # (re-)enqueue at top priority; a duplicate entry is fine,
            # the worker skips already-resident keys
            self._escalated.add(key)
            if key in self._fetching:
                # a worker already started a (prefetch-priority) read:
                # boost it in the store's native scheduler
                esc = getattr(self.store, "escalate", None)
                if esc is not None:
                    esc(*key)
            heapq.heappush(self._queue, (PRIO_ONDEMAND, self._gen, next(self._seq), key))
            self._cv.notify_all()
            events.append((key, ev))
        return events

    def acquire(self, keys: Sequence[Key], layer: int) -> None:
        """Block until every key is resident. On-demand misses are fetched
        at top priority. Marks keys protected until release(). A failed
        fetch raises here."""
        with self._cv:
            events = self._enqueue_ondemand_locked(keys, layer)
        for key, ev in events:
            if not ev.wait(timeout=300.0):
                raise TimeoutError(f"expert fetch timed out for {key}")
            # resolve under the lock: a concurrent acquire for the same key
            # may have consumed our error and re-enqueued a fresh fetch -
            # follow the new in-flight event instead
            while True:
                with self._lock:
                    if key in self.key_to_slot:
                        break
                    err = self._errors.pop(key, None)
                    nxt = self._in_flight.get(key)
                if err is not None:
                    raise err
                if nxt is None:
                    raise RuntimeError(f"expert fetch for {key} neither landed nor errored")
                if not nxt.wait(timeout=300.0):
                    raise TimeoutError(f"expert fetch timed out for {key}")

    def try_acquire(
        self, keys: Sequence[Key], layer: int, timeout: float
    ) -> Tuple[List[Key], List[Key]]:
        """acquire() with a deadline: returns (resident, missing). Missing
        keys are unprotected and NOT resident - their fetches continue in
        the background. The caller must release() only the resident list.

        Only the deadline makes a key missing: a fetch that failed, in this
        call or in the background after an earlier call's deadline, raises
        here (with every key of the call unprotected)."""
        with self._cv:
            # a background fetch that failed after an earlier deadline left
            # its error; enqueueing would drop it
            err = next((self._errors.pop(k) for k in keys if k in self._errors), None)
            events = [] if err is not None else self._enqueue_ondemand_locked(keys, layer)
        if err is not None:
            raise err
        deadline = _time.perf_counter() + timeout
        missing: List[Key] = []
        for key, ev in events:
            landed = ev.wait(max(0.0, deadline - _time.perf_counter()))
            with self._lock:
                if landed and key in self.key_to_slot:
                    continue
                self.policy.unprotect(key)
                self._escalated.discard(key)
                failed = self._errors.pop(key, None)
                missing.append(key)
            if failed is not None and err is None:
                err = failed
        gone = set(missing)
        resident = [k for k in keys if k not in gone]
        if err is not None:
            self.release(resident)
            raise err
        return resident, missing

    def release(self, keys: Sequence[Key]) -> None:
        with self._lock:
            for key in keys:
                self.policy.unprotect(key)

    def reset_policy(self, policy: str) -> None:
        """Swap the eviction policy in place: fresh stats/counters, same
        residency (resident keys re-registered in the new policy). Call only
        between steps."""
        with self._lock:
            new = ExpertCachePolicy(
                self.num_layers,
                self.num_experts,
                num_encoder_layers=self.store.meta.get("num_encoder_moe_layers", 0),
                policy=policy,
            )
            for key in self.key_to_slot:
                new.on_insert(key, prefetched=False)
            self.policy = new

    def swap_policy(self, new_policy) -> ExpertCachePolicy:
        """Swap in a PREVIOUSLY BUILT policy object, preserving its learned
        state (frequency counters, per-node stats, clock) and reconciling
        its residency picture with the arena's current slots. Returns the
        outgoing policy (equally preserved) so the caller can swap it back:
        interleaved A/B policy windows, each policy keeping its own state.
        Live protections and prefetch candidates carry over."""
        assert isinstance(new_policy, ExpertCachePolicy)
        with self._lock:
            old = self.policy
            resident_now = set(self.key_to_slot)
            known = set(new_policy.resident)
            for key in resident_now - known:
                new_policy.on_insert(key, prefetched=False)
            for key in known - resident_now:
                # silent removal: the OTHER policy evicted it
                new_policy.resident.pop(key, None)
                new_policy._was_prefetched.discard(key)
            new_policy.protected_ondemand = dict(old.protected_ondemand)
            new_policy.candidates = set(old.candidates)
            self.policy = new_policy
            return old

    def prefetch(self, orders: Sequence[Key], protect: Sequence[Key] = ()) -> None:
        """Replace the prefetch plan: new candidate protection set, stale
        queued prefetches dropped. protect: additional keys to
        candidate-protect WITHOUT fetching."""
        with self._cv:
            self._gen += 1
            self.policy.replace_candidates(list(orders) + list(protect))
            for key in orders:
                if key in self.key_to_slot or key in self._in_flight:
                    continue
                self._in_flight[key] = threading.Event()
                heapq.heappush(self._queue, (PRIO_PREFETCH, self._gen, next(self._seq), key))
            self._cv.notify_all()

    def warm(self, keys: Sequence[Key]) -> None:
        """Synchronously load keys (initial placement / tests)."""
        self.prefetch(keys)
        with self._cv:
            events = [self._in_flight[k] for k in keys if k in self._in_flight]
        for ev in events:
            ev.wait(timeout=300.0)

    def fetch_stats(self) -> dict:
        """Landed fetches by path, and the fetch-time EWMA."""
        with self._lock:
            return {"fetches_tier": self.fetch_counts["tier"],
                    "fetches_store": self.fetch_counts["store"],
                    "fetch_seconds_ewma": self.fetch_seconds_ewma,
                    "lease_evictions": self.lease_evictions}

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout=30.0)

    # ------------------------------------------------------------------
    # worker internals
    # ------------------------------------------------------------------
    def _next_order_locked(self):
        """Pop the next order and give it a slot: (prio, gen, key, slot,
        fences), or None after shutdown. fences: events the slot's write
        must follow on the card (its previous landing, the newest lease
        end)."""
        while True:
            while not self._queue and not self._shutdown:
                self._cv.wait()
            if self._shutdown:
                return None
            prio, gen, _, key = heapq.heappop(self._queue)
            if key in self.key_to_slot or key not in self._in_flight or key in self._fetching:
                # resident, stale, or another worker is already fetching it
                # (the waiter shares the same in-flight event)
                continue
            ondemand = prio == PRIO_ONDEMAND or key in self._escalated
            if prio == PRIO_PREFETCH and gen != self._gen and not ondemand:
                # stale prefetch plan and no caller blocked on it - drop
                del self._in_flight[key]
                continue
            slot = self._allocate_slot_locked(key, ondemand)
            if slot is None and self._pending_fetches > 0:
                # other fetches hold allocated-but-unregistered slots; once
                # they land their keys become evictable - retry
                heapq.heappush(self._queue, (prio, gen, next(self._seq), key))
                self._cv.wait(timeout=0.02)
                continue
            if slot is None:
                if ondemand:
                    # surface in the blocked caller, keep the worker alive
                    self._fail_locked(key, RuntimeError(
                        f"arena exhausted: no evictable slot for {key} "
                        f"({self.num_slots} slots, "
                        f"{len(self.policy.protected_ondemand)} protected)"
                    ))
                else:  # prefetch can't find a victim - drop the order
                    del self._in_flight[key]
                continue
            self._pending_fetches += 1
            self._fetching.add(key)
            fences = [e for e in (self._landed[slot], self._read_done) if e is not None]
            return prio, gen, key, slot, fences

    def _fail_locked(self, key: Key, err: Exception) -> None:
        self._errors[key] = err
        self._escalated.discard(key)
        ev = self._in_flight.pop(key, None)
        if ev is not None:
            ev.set()

    def _worker(self) -> None:
        stream = None
        staging: Optional[Dict[str, torch.Tensor]] = None
        if self._cuda:
            torch.cuda.set_device(self.device)
            stream = torch.cuda.Stream(device=self.device)
        while True:
            with self._cv:
                order = self._next_order_locked()
            if order is None:
                return
            prio, gen, key, slot, fences = order
            t_fetch = _time.perf_counter()
            try:
                tier_row = self._tier.record_index(*key) if self._tier is not None else None
                if tier_row is not None:
                    seg, local = self._tier.segment_for(tier_row)
                    srcs = {k: seg[t][local] for k, t in self._role_to_tail.items()}
                    path = "tier"
                else:
                    record = self.store.get_expert(*key, prio=prio, gen=gen)
                    if stream is None and not self._dequant:
                        # the CPU: write the slot in place
                        dsts = {k: a[slot] for k, a in self._arena.items()}
                        srcs = {}
                    else:
                        if staging is None:
                            staging = {k: torch.empty(shape, dtype=dt, pin_memory=self._cuda)
                                       for k, (shape, dt) in self._src_spec.items()}
                        dsts = srcs = staging
                    for akey, tail in self._role_to_tail.items():
                        # quantized bytes as stored, others cast on the host
                        host_copy(dsts[akey], record[tail], self._field_dtype[akey])
                    path = "store"
                landed = self._land(srcs, slot, stream, fences)
            except Exception as e:  # noqa: BLE001 - the worker must survive
                logger.exception("fetch of %s failed", key)
                with self._cv:
                    self._pending_fetches -= 1
                    self._fetching.discard(key)
                    self._fail_locked(key, e)
                if stream is not None:
                    stream.synchronize()  # drain copies queued before the failure
                with self._cv:
                    self._free_slots.append(slot)
                    self._cv.notify_all()
                continue
            self._finish_fetch(key, slot, prio, landed, path)
            if landed is not None:
                landed.synchronize()  # frees the staging buffer for reuse
            dt = _time.perf_counter() - t_fetch
            with self._lock:
                self.fetch_seconds_ewma = (
                    dt if self.fetch_seconds_ewma is None
                    else 0.8 * self.fetch_seconds_ewma + 0.2 * dt
                )

    def _land(self, srcs: Dict[str, torch.Tensor], slot: int, stream, fences):
        """Copy one record into ``slot``. On the card: on the worker's
        stream, after ``fences``, returning the landing event."""
        if stream is None:
            self._write_slot(srcs, slot, False)
            return None
        with torch.cuda.stream(stream):
            for ev in fences:
                stream.wait_event(ev)
            self._write_slot(srcs, slot, True)
            landed = torch.cuda.Event()
            landed.record(stream)
        return landed

    def _write_slot(self, srcs: Dict[str, torch.Tensor], slot: int, non_blocking: bool):
        """Copy each slot tensor's source into ``slot``; a role dequantized
        on write is copied as stored and written as codes times its scale."""
        for akey, src in srcs.items():
            dst = self._arena.get(akey)
            if dst is None:  # a scale that a dequantized role consumes
                continue
            scale_key = self._dequant.get(akey)
            if scale_key is None:
                dst[slot].copy_(src, non_blocking=non_blocking)
                continue
            codes = src.to(self.device, non_blocking=non_blocking)
            scale = srcs[scale_key].to(self.device, non_blocking=non_blocking)
            if codes.dtype == torch.uint8:  # e4m3 codes as a tier holds them
                codes = codes.view(torch.float8_e4m3fn)
            if codes.shape[-1] * 2 == dst.shape[-1]:  # packed int4
                codes = unpack_int4(codes)
            dst[slot].copy_((codes.float() * scale.float()[None, :]).to(dst.dtype))

    def _finish_fetch(self, key: Key, slot: int, prio: int, landed, path: str):
        with self._lock:
            self.slot_to_key[slot] = key
            self.key_to_slot[key] = slot
            self.expert_to_slot[key] = slot
            self._landed[slot] = landed
            if landed is not None:
                self._fresh_slots.add(slot)
            self.fetch_counts[path] += 1
            self.policy.on_insert(key, prefetched=(prio == PRIO_PREFETCH))
            self._escalated.discard(key)
            self._pending_fetches -= 1
            self._fetching.discard(key)
            ev = self._in_flight.pop(key, None)
            self._cv.notify_all()  # wake workers waiting on pending slots
        if ev is not None:
            ev.set()

    def _allocate_slot_locked(self, key: Key, ondemand: bool = True) -> Optional[int]:
        if self._free_slots:
            return self._free_slots.pop()
        victims = self.policy.pick_victims(1, self.current_layer, self._decoder_matrix)
        if not victims:
            if not ondemand:
                # a PREFETCH must never displace candidate-protected keys
                # (the live hot set): drop the order instead
                return None
            # fall back: evict anything not on-demand-protected
            for cand in self.key_to_slot:
                if cand not in self.policy.protected_ondemand:
                    victims = [cand]
                    break
            if not victims:
                return None
        victim = victims[0]
        for evicted in self._lease_evicted:
            evicted.add(victim)
        slot = self.key_to_slot.pop(victim)
        self.slot_to_key[slot] = None
        self.expert_to_slot[victim] = -1  # masked to zero contribution
        self.policy.on_evict(victim)
        return slot
