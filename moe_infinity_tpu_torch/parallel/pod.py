"""Expert-parallel offload across ranks, from ``moe_infinity_tpu/parallel/pod.py``.

With the experts sharded over the ``expert`` mesh axis and offloaded per
rank, an expert missing on one rank would stall the collective of every
rank. The pieces that close the gap:

* **Coordinate-affine placement** (``PodExpertPlan``): expert e belongs to
  expert coordinate ``e // (E / ep)``, and a rank's arena holds only its
  coordinate's experts, so host memory and fetch traffic scale with the
  ranks instead of replicating the store.
* **The slot-row exchange** (``PodOffloadExecutor``): at every MoE layer
  each rank warms its share of the routed experts, then every rank learns
  every rank's (expert -> global slot) fragment from one ``all_reduce`` of
  a [dp, E] table over the host channel (``parallel/mesh.py``), before any
  rank dispatches the grouped FFN. A miss is found on the host, never inside
  the device collective. The exchange is also the step's barrier.
* **Prefetch hints** (``PodPrefetchCoordinator`` over
  ``multihost.PrefetchHints``): a leader publishes a step's expert set and
  every rank warms its share of it.
* **The host fallback** (``runtime/host_exec.py``): an expert that misses
  its deadline reads -1 in every rank's table and every rank adds the same
  host-computed delta, so the replicated activations stay equal.

The port's process model is one process per rank, one device per rank
(``parallel/mesh.py``). Each rank ``(d, c, m)`` runs one ``ExpertArena``:
over the store for ``m = 0`` of a mesh without a model axis, else over
column m of it (``store/column.py``); the JAX package instead lands every
column of a coordinate from one process (``tp_mirrors``). The column ranks of
a coordinate see the same keys in the same order; their residency is
agreed at every exchange (an ``all_reduce(min)`` over the model axis): an
expert counts as resident only where every column holds it, and one held by
some columns only is a miss on all of them (``column_disagreements`` counts
them). The rank hands its own arena's slots to the model, whose grouped FFN
(``ops/moe.py::grouped_ffn_ep``) maps the exchanged global slots to its
local ones; no global view of the slots is assembled.

A failure on one rank reaches every rank as an error: a rank whose acquire
raises still joins the exchange and sets its error flag there, so every
rank raises ``RuntimeError`` naming the step; a rank that falls behind or
dies makes the others' exchange raise within the mesh's timeout.
"""

from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from moe_infinity_tpu_torch.parallel.mesh import MODEL, WORLD
from moe_infinity_tpu_torch.parallel.multihost import PrefetchHints
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("pod")

Key = Tuple[int, int]


def _host(mesh, t: torch.Tensor, op: str, axes, step) -> torch.Tensor:
    """``mesh.host_all_reduce`` whose failure (a peer that fell behind,
    failed or left) raises ``RuntimeError`` naming the step."""
    try:
        return mesh.host_all_reduce(t, op, *axes)
    except Exception as e:  # noqa: BLE001 - re-raised, naming the step
        raise RuntimeError(
            f"pod step {step}: the host exchange did not complete on rank {mesh.rank} "
            f"(a rank fell behind, failed or left): {type(e).__name__}: {e}") from e


class PodExpertPlan:
    """Which experts belong to this rank under an ``expert``-axis mesh:
    experts stack on dim 0 and shard over the ``expert`` axis, so expert e
    lives at expert coordinate ``e // (E / ep)``; a rank owns the coordinate
    it sits at."""

    def __init__(self, mesh, num_experts: int):
        ep = mesh.shape["expert"]
        if num_experts % ep != 0:
            raise ValueError(
                f"num_experts={num_experts} must divide over the expert axis ({ep})")
        self.num_experts = num_experts
        self.block = num_experts // ep
        self.local_coords = frozenset({mesh.axis_index("expert")})

    def owner_coord(self, expert: int) -> int:
        return expert // self.block

    def is_local(self, key: Key) -> bool:
        return self.owner_coord(key[1]) in self.local_coords

    def filter_local(self, keys: Iterable[Key]) -> List[Key]:
        return [k for k in keys if self.is_local(k)]

    def local_experts(self) -> List[int]:
        return [e for e in range(self.num_experts) if self.owner_coord(e) in self.local_coords]


class PodPrefetchCoordinator:
    """Step-synchronised prefetch across ranks: the leader (the rank running
    the tracer and predictor) calls ``lead(step, keys)``; every rank then
    calls ``ensure(step)``, which fetches the published set, warms its share
    in its arena and joins the step barrier. When every rank has returned,
    every routed expert's share is resident on its owner.

    A leader that crashed leaves the others in ``hints.fetch``, bounded by
    its timeout: the ``RuntimeError`` naming the step is the signal, never a
    hang."""

    def __init__(self, arena, plan: PodExpertPlan, *, mesh=None,
                 hints: Optional[PrefetchHints] = None, barrier_timeout_ms: int = 120_000,
                 namespace: str = "moe_pod"):
        self.arena = arena
        self.plan = plan
        self.mesh = mesh
        self.hints = hints or PrefetchHints(namespace=f"{namespace}/hints")
        self.namespace = namespace
        self.barrier_timeout_ms = barrier_timeout_ms

    def lead(self, step: int, keys: Sequence[Key]) -> None:
        self.hints.publish(step, keys)

    def ensure(self, step: int, on_miss=None) -> List[Key]:
        """Warm this rank's share of the step's expert set, then join the
        step barrier; returns the local keys warmed. on_miss: called with
        the keys that could not be made resident (the caller routes them to
        the host fallback instead of failing)."""
        try:
            keys = self.hints.fetch(step)
        except Exception as e:  # noqa: BLE001 - surfaced, not swallowed
            raise RuntimeError(
                f"pod step {step}: no published expert set (leader crashed or fell "
                f"behind): {e}") from e
        mine = self.plan.filter_local(keys)
        if mine:
            try:
                self.arena.warm(mine)
            except Exception as e:  # noqa: BLE001 - residency is checked below
                logger.warning("pod step %d: warm failed for %d keys (%s: %s); falling back "
                               "to miss handling", step, len(mine), type(e).__name__, e)
        failed = [k for k in mine if not self.arena.is_resident(k)]
        if failed:
            logger.warning("pod step %d: %d local keys not resident after warm", step, len(failed))
            if on_miss is not None:
                on_miss(failed)
        self.barrier(step)
        return mine

    def barrier(self, step) -> None:
        if self.mesh is None:
            return
        try:
            self.mesh.barrier(self.barrier_timeout_ms / 1000.0)
        except Exception as e:  # noqa: BLE001 - re-raised, naming the step
            raise RuntimeError(f"pod step {step}: barrier failed: {e}") from e


class PodOffloadExecutor:
    """This rank's share of arena-backed expert-parallel dispatch over an
    ``expert``-axis mesh. Per MoE layer application (``ensure_step``):

      1. the routing is replicated, so every rank derives the same key set;
      2. each rank acquires the keys its coordinate owns in its arena (its
         data row's keys under DP x EP), with a deadline under the host
         fallback;
      3. the ranks agree on residency over the model axis and exchange
         their slot fragments over the whole mesh; the merged [E] row (or
         [dp, E] rows under DP x EP, global slot ``(d*ep + c)*S + s``) is
         the same on every rank, but for a rank's own coordinate under a
         model axis, where it holds that rank's own slots;
      4. the model's grouped FFN runs over the rank's own slots
         (``dispatch_leases``) and the ranks sum it over the mesh.

    DP x EP: each (data, expert) coordinate is an independent cache shard
    serving its own batch slice; the per-row tables keep the fetch traffic
    coordinate-affine. TP x EP: each model column holds the 1/tp d_ff slice
    of every resident expert of its coordinate (``ColumnShardStore``); the
    grouped FFN sums over (expert, model).

    ``arenas`` holds this rank's arena keyed as the JAX executor keys its
    arenas: by the expert coordinate c when the data axis is 1, else by
    (d, c). num_experts must divide over the expert axis, the batch over the
    data axis, and d_ff over the model axis."""

    def __init__(
        self,
        mesh,
        store,
        num_slots_per_coord: int,
        *,
        policy: str = "priority",
        compute_dtype=None,
        device="cuda",
        num_threads: int = 2,
        host_fallback: bool = False,
        host_fallback_timeout: float = 0.25,
    ):
        from moe_infinity_tpu_torch.runtime.arena import ExpertArena

        self.mesh = mesh
        self.store = store
        self.plan = PodExpertPlan(mesh, store.num_experts)
        self.ep = mesh.shape["expert"]
        self.dp = mesh.shape["data"]
        self.tp = mesh.shape["model"]
        self.d, self.c, self.m = (mesh.axis_index(a) for a in ("data", "expert", "model"))
        self.s_local = num_slots_per_coord
        self.num_experts = store.num_experts
        self.host_fallback = host_fallback
        self.host_fallback_timeout = host_fallback_timeout
        self.host_exec_count = 0
        self._host_exec = None
        if host_fallback:
            from moe_infinity_tpu_torch.runtime.host_exec import HostExpertExecutor, activation_for

            # the whole record: every rank computes every missing delta
            self._host_exec = HostExpertExecutor(store, activation_for(store.meta))
        view = store
        if self.tp > 1:
            from moe_infinity_tpu_torch.store.column import ColumnShardStore

            view = ColumnShardStore(store, self.m, self.tp)
        self.arena = ExpertArena(view, num_slots_per_coord, policy=policy,
                                 compute_dtype=compute_dtype or torch.bfloat16, device=device,
                                 num_threads=num_threads)
        self.arenas = {self.c if self.dp == 1 else (self.d, self.c): self.arena}
        self._step = itertools.count()
        self._held: List[Key] = []
        # barrier joins of both protocols (the per-layer exchange and the
        # speculative snapshot); keys one column held that another did not
        self.barrier_joins = 0
        self.column_disagreements = 0
        # every rank must build the same plan: rank 0's sizes, checked here
        sizes = [num_slots_per_coord, store.num_layers, store.num_experts,
                 self.dp, self.tp, self.ep]
        got = mesh.host_broadcast(torch.tensor(sizes, dtype=torch.int64), *WORLD).tolist()
        if got != sizes:
            raise ValueError(f"pod executor on rank {mesh.rank}: slots, layers, experts and mesh "
                             f"{sizes} differ from rank 0's {got}")

    # ------------------------------------------------------------------
    def _owner(self, e: int) -> int:
        return self.plan.owner_coord(e)

    def _row_keys_for(self, d: int, keys, row_keys) -> List[Key]:
        return list(keys) if row_keys is None else list(row_keys[d])

    def _mine(self, keys) -> List[Key]:
        return [k for k in keys if self._owner(k[1]) == self.c]

    def _flat(self) -> int:
        """This rank's flat coordinate along the jointly sharded slot dim."""
        return self.d * self.ep + self.c

    def _exchange(self, own: np.ndarray, step, err: Optional[BaseException] = None):
        """Agree on ``own`` (an int32 table, -1 where this rank holds
        nothing) over the model axis, then merge it over the mesh with one
        ``all_reduce(max)``, which carries an error flag. Returns (merged
        table, this rank's agreed table). Raises this rank's ``err``, or a
        ``RuntimeError`` naming the step when another rank set its flag."""
        flat = own.reshape(-1)
        if self.tp > 1:
            # an entry counts only where every column of the coordinate holds it
            present = torch.from_numpy((flat >= 0).astype(np.int32))
            agreed = _host(self.mesh, present, "min", (MODEL,), step).numpy().astype(bool)
            self.column_disagreements += int(((flat >= 0) & ~agreed).sum())
            flat = np.where(agreed, flat, -1).astype(np.int32)
        mine = flat
        # under a model axis column 0 speaks for its coordinate in the merge;
        # each column keeps its own slots for its own coordinate below
        contrib = flat if self.m == 0 else np.full_like(flat, -1)
        buf = torch.from_numpy(np.append(contrib, np.int32(self.mesh.rank if err is not None
                                                           else -1)).astype(np.int32))
        _host(self.mesh, buf, "max", WORLD, step)
        failed = int(buf[-1])
        merged = buf[:-1].numpy()
        if self.tp > 1:
            merged = np.where(mine >= 0, mine, merged)
        if err is not None:
            raise err
        if failed >= 0:
            raise RuntimeError(f"pod step {step}: rank {failed} failed before the exchange "
                               f"(this is rank {self.mesh.rank})")
        return merged.reshape(own.shape), mine.reshape(own.shape)

    def global_slot_row(self, layer: int, step, keys, row_keys=None, *,
                        held: Optional[Sequence[Key]] = None,
                        err: Optional[BaseException] = None) -> np.ndarray:
        """Exchange the slot fragments; -1 marks an expert not resident on
        its owner (the grouped FFN gives it a zero contribution). Returns [E]
        for pure EP, [dp, E] per-data-row tables for DP x EP (global slot
        ``(d*ep + c)*S + s``). held: the keys this rank acquired (default:
        its share of ``keys``, or of its row's ``row_keys``)."""
        if held is None:
            held = self._mine(self._row_keys_for(self.d, keys, row_keys))
        own = np.full((self.dp, self.num_experts), -1, np.int32)
        base = self._flat() * self.s_local
        for k in held:
            s = self.arena.key_to_slot.get(k)
            if s is not None:
                own[self.d, k[1]] = base + int(s)
        merged, _ = self._exchange(own, step, err)
        return merged[0] if self.dp == 1 else merged

    def ensure_step(self, layer: int, keys, row_keys=None) -> Tuple[np.ndarray, List]:
        """Warm this rank's share of ``keys`` (its data row's ``row_keys``
        under DP x EP), exchange the slot rows, join the step barrier (the
        exchange). Returns (the global slot row [E], or [dp, E] under DP x
        EP, and this rank's keys that missed the host fallback's deadline,
        as (data coord, key) pairs under DP x EP). Every routed expert not -1
        in the row is resident and protected on its owner until
        ``release_step``. The engines take the missing set from the row, the
        same on every rank, not from the local misses."""
        step = next(self._step)
        mine = self._mine(self._row_keys_for(self.d, keys, row_keys))
        held, missing, err = [], [], None
        try:
            if mine:
                if self.host_fallback:
                    held, miss = self.arena.try_acquire(mine, layer, self.host_fallback_timeout)
                    missing = miss if self.dp == 1 else [(self.d, k) for k in miss]
                else:
                    self.arena.acquire(mine, layer)
                    held = mine
        except Exception as e:  # noqa: BLE001 - raised after the exchange
            err = e
        self._held = list(held)
        try:
            row = self.global_slot_row(layer, step, keys, row_keys, held=held, err=err)
        except BaseException:
            self.arena.release(held)
            self._held = []
            raise
        self.barrier_joins += 1
        return row, missing

    def release_step(self, keys=None, row_keys=None) -> None:
        """Release what ``ensure_step`` acquired."""
        self.arena.release(self._held)
        self._held = []

    @contextmanager
    def dispatch_leases(self):
        """Yield this rank's slot tensors for one dispatch over the keys the
        last ``ensure_step`` acquired: on the card the current stream waits
        on their landings, and a worker does not overwrite a slot before
        the dispatch's reads (``ExpertArena.locked_tree``)."""
        with self.arena.locked_tree(self._held) as tree:
            yield tree

    def host_delta(self, layer: int, missing, h, cw, ids_np) -> torch.Tensor:
        """The missing experts' exact contribution, on the host. Every rank
        computes every missing delta, so the replicated activations stay
        equal on every rank."""
        from moe_infinity_tpu_torch.runtime.host_exec import host_moe_delta

        self.host_exec_count += len(missing)
        return host_moe_delta(self._host_exec, layer, missing, h, cw, ids_np)

    def host_delta_rows(self, layer: int, missing, h, cw, ids_np) -> torch.Tensor:
        """DP x EP host fallback: ``missing`` holds (data coord, key) pairs;
        an expert missing in row d adds its delta to row d's batch slice
        only (other rows may hold it). Every rank computes every row's."""
        from moe_infinity_tpu_torch.runtime.host_exec import host_moe_delta

        by_row: dict = {}
        for d, k in missing:
            by_row.setdefault(d, []).append(k)
        b = h.shape[0] // self.dp
        delta = torch.zeros(h.shape, dtype=torch.float32)
        for d, keys_d in by_row.items():
            sl = slice(d * b, (d + 1) * b)
            self.host_exec_count += len(keys_d)
            delta[sl] = host_moe_delta(self._host_exec, layer, keys_d, h[sl], cw[sl], ids_np[sl])
        return delta

    def prefetch(self, orders, protect: Sequence[Key] = ()) -> None:
        mine, guard = self._mine(orders), self._mine(protect)
        if mine or guard:
            self.arena.prefetch(mine, protect=guard)

    def set_context(self, layer: int, decoder_matrix=None) -> None:
        self.arena.set_context(layer, decoder_matrix)

    def is_resident(self, key: Key) -> bool:
        """Resident in this rank's arena; another coordinate's expert counts
        as resident (its owner prefetches it)."""
        return self._owner(key[1]) != self.c or self.arena.is_resident(key)

    def stats(self) -> dict:
        st = self.arena.hit_stats()
        out = {k: st.get(k, 0) for k in ("visits", "hits", "misses", "evictions")}
        out["hit_rate"] = out["hits"] / out["visits"] if out["visits"] else 0.0
        out["pod_coords"] = sorted(self.arenas)
        if self.host_fallback:
            out["host_exec_count"] = self.host_exec_count
        if self.tp > 1:
            out["column_disagreements"] = self.column_disagreements
        return out

    def shutdown(self) -> None:
        self.arena.shutdown()


class PodSpecView:
    """``ExpertArena``-shaped facade over a ``PodOffloadExecutor`` for the
    speculative runners (``runtime/engine.py``: ``run_speculative``), so
    the pod runs whole decode steps and k-step blocks per exchange instead
    of one exchange per MoE layer per token.

    ``dispatch_snapshot`` snapshots this rank's arena, exchanges the
    [L, dp, E] slot tables (agreed over the model axis, merged over the
    mesh: one barrier join), and yields (this rank's slots, the rows on the
    device, the shared resident set): a key counts as resident only where
    every data row holds it (and every column). Every rank therefore takes
    the same accept and replay decisions. A key evicted on any rank while
    the dispatch's scope is open leaves the shared set when the scope ends
    (a second, small exchange), as the arena's own snapshot does for its
    rank. ``acquire`` warms and protects this rank's share and agrees on the
    outcome over the mesh: a capacity failure on one rank raises the same
    capacity error on every rank, so all of them halve the block or leave
    the speculative path together."""

    def __init__(self, executor: PodOffloadExecutor):
        self.ex = executor
        self.num_slots = executor.ep * executor.s_local
        self.num_layers = executor.store.num_layers
        self._spec_step = itertools.count()
        # one client at a time (the facade's generate takes it)
        self.client_lock = threading.RLock()

    @property
    def fetch_seconds_ewma(self):
        return self.ex.arena.fetch_seconds_ewma

    @property
    def num_workers(self) -> int:
        return self.ex.arena.num_workers

    @contextmanager
    def dispatch_snapshot(self, timings: Optional[dict] = None):
        ex = self.ex
        step = f"spec{next(self._spec_step)}"
        L, dp, E = self.num_layers, ex.dp, ex.num_experts
        with ex.arena.dispatch_snapshot(timings, upload=False) as (tree, rows, resident):
            own = np.full((L, dp, E), -1, np.int32)
            base = ex._flat() * ex.s_local
            for (layer, e) in resident:
                own[layer, ex.d, e] = base + int(rows[layer, e])
            merged, mine = ex._exchange(own, step)
            ex.barrier_joins += 1
            held = merged >= 0
            resident_g = {(int(layer), int(e)) for layer, e in zip(*np.nonzero(held.all(axis=1)))}
            reported = {(int(layer), int(e)) for layer, e in zip(*np.nonzero(mine[:, ex.d] >= 0))}
            rows_dev = torch.from_numpy(np.ascontiguousarray(
                merged[:, 0, :] if dp == 1 else merged)).to(ex.arena.device)
            yield tree, rows_dev, resident_g
        # the arena's scope has taken the keys evicted under it out of its
        # set: every rank learns every rank's, so all verify alike
        lost = np.zeros((L, E), np.int32)
        for key in reported - resident:
            lost[key] = 1
        lost_t = _host(ex.mesh, torch.from_numpy(lost), "max", WORLD, step)
        resident_g -= {(int(layer), int(e)) for layer, e in zip(*np.nonzero(lost_t.numpy()))}

    def acquire(self, keys, layer: int) -> None:
        from moe_infinity_tpu_torch.runtime.engine import is_spec_capacity_error

        ex = self.ex
        err, code = None, 0
        try:
            mine = ex._mine(keys)
            if mine:
                ex.arena.acquire(mine, layer)
        except Exception as e:  # noqa: BLE001 - agreed over the mesh below
            err, code = e, (1 if is_spec_capacity_error(e) else 2)
        flag = _host(ex.mesh, torch.tensor([code], dtype=torch.int32), "max", WORLD,
                     f"acquire of layer {layer}")
        worst = int(flag[0])
        if worst == 2:
            raise RuntimeError(f"pod: an acquire failed on a rank of the mesh (this is rank "
                               f"{ex.mesh.rank})") from err
        if err is not None:
            raise err
        if worst == 1:
            raise RuntimeError(f"arena exhausted on another rank of the pod ({ex.s_local} slots "
                               f"a coordinate)")

    def release(self, keys) -> None:
        mine = self.ex._mine(keys)
        if mine:
            self.ex.arena.release(mine)

    def is_resident(self, key: Key) -> bool:
        return self.ex.is_resident(key)

    def set_context(self, layer: int, decoder_matrix=None) -> None:
        self.ex.set_context(layer, decoder_matrix)

    def prefetch(self, orders, protect: Sequence[Key] = ()) -> None:
        self.ex.prefetch(orders, protect)
