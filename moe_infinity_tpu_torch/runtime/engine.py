"""The decoder-only offload engine and the helpers of both offload engines,
from ``moe_infinity_tpu/runtime/engine.py``: ``OffloadEngine``,
``_split_arena_tree`` and the speculative helpers.

Speculative execution runs a whole decode step, or a block of k steps, on
the device against the arena's current slots, with no host read inside:
routing resolves on the device, and a routed expert that is not resident
reads slot -1, which the grouped FFN masks to a zero contribution. The
routed ids come back once per dispatch; the host verifies them against
the residency the dispatch saw (``ExpertArena.dispatch_snapshot``), loads
the misses and runs again. An execution whose routed experts were all
resident is exact, and only such an execution is accepted.

Dispatch functions hand back device tensors; the helpers read the trace
(``.cpu()``) once per dispatch, after its launches are queued, and the
tokens once they are accepted. The speculative path never runs the host
fallback, as in JAX.

``OffloadEngine`` drives a decoder-only model's layer protocol (``embed``,
``pre_moe``, ``dense_layer``, ``apply_moe``, ``head``) against an
``ExpertArena`` and is a stepper of ``runtime/generate.py::Generator``.
Per layer, the routed ids come back to the host at every MoE layer: trace,
predict, plan prefetch, acquire, then K3 over the arena's slots. With
``speculative=True`` a one-token step runs whole on the device against the
arena's current slots (``run_speculative``), and the ``Generator`` asks for
greedy k-step blocks (``decode_block``), replayed whole on a miss
(``MOE_SPEC_BLOCK_MODE=whole``, the default) or accepted by verified prefix
(``prefix``). On the card the whole step and each k-step block run as one
CUDA graph per shape (``runtime/graphs.py``; ``graphs=False`` runs them
eagerly), over the K/V caches the engine owns per (B, capacity). A model
takes part in graphs only if its step reads nothing on the host
(``graph_step``: Mixtral); DeepSeek-V2's speculative path runs eagerly.
"""

from __future__ import annotations

import os
import time as _time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from moe_infinity_tpu_torch.memory.prefetch_plan import adaptive_prefetch_budget, plan_prefetch
from moe_infinity_tpu_torch.runtime.graphs import (
    DecodeBuffers,
    GraphCache,
    flat_tensors,
    graph_cache,
    step_positions,
)
from moe_infinity_tpu_torch.utils.logger import get_logger

_log = get_logger("engine")

_BIAS_KEYS = ("gate_bias", "down_bias")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported (ROADMAP queue-1 item {item})")


def _split_arena_tree(tree: Dict[str, torch.Tensor]):
    """(weights, biases or None) of an arena's slot tensors."""
    weights = {k: v for k, v in tree.items() if k not in _BIAS_KEYS}
    biases = {k: v for k, v in tree.items() if k in _BIAS_KEYS}
    return weights, (biases or None)


def apply_over_slots(engine, keys, mli: int, h, cw, ids_np, apply):
    """Acquire one MoE layer's routed experts and run ``apply(weights, row,
    biases)`` over the arena's slots (both offload engines' per-layer
    path). With ``engine.host_fallback``, an expert that is not resident
    within ``engine.host_fallback_timeout`` reads the arena's zero slot and
    its contribution is computed on the host (``runtime/host_exec.py``) from
    ``h`` and ``cw``, read to the host only then, and added in the output's
    dtype; only the resident keys are released."""
    arena = engine.arena
    if engine.host_fallback:
        resident, missing = arena.try_acquire(keys, mli, engine.host_fallback_timeout)
    else:
        arena.acquire(keys, mli)
        resident, missing = keys, []
    row = arena.slot_map(mli)  # a copy
    if missing:
        row[[e for _, e in missing]] = arena.zero_slot
    # uploaded synchronously: the compute stream holds no queued work here
    # (the routed ids were just read)
    row = torch.from_numpy(row).to(engine.model.device)
    with arena.locked_tree(resident) as tree:
        weights, biases = _split_arena_tree(tree)
        x = apply(weights, row, biases)
    if missing:
        from moe_infinity_tpu_torch.runtime.host_exec import host_moe_delta

        engine.host_exec_count += len(missing)
        delta = host_moe_delta(engine._host_exec, mli, missing, h.cpu(), cw.cpu(), ids_np)
        x = x + delta.to(device=x.device, dtype=x.dtype)
    arena.release(resident)
    return x


def is_spec_capacity_error(e: BaseException) -> bool:
    """True for the speculative runners' own failures (the arena is too
    small, or replays did not converge): the only errors that justify a
    smaller block or the per-layer path. Anything else is raised."""
    s = str(e)
    return "did not converge" in s or "arena exhausted" in s


def speculative_stats(replay_counts: Sequence[int]) -> dict:
    """The counter block every speculative executor reports."""
    if not replay_counts:
        return {}
    return {
        "speculative_steps": len(replay_counts),
        "mean_step_executions": round(sum(replay_counts) / len(replay_counts), 4),
    }


def split_margin_columns(ids_np, margin: int):
    """(top-k trace, margin trace) views of a widened [..., k+m] trace."""
    if margin <= 0:
        return ids_np, None
    k = ids_np.shape[-1] - margin
    return ids_np[..., :k], ids_np[..., k:]


def margin_key_fns(mlis, margin: int):
    """(key_fn, margin_fn) for ``run_speculative`` over a trace widened by
    ``route_margin``: key_fn verifies and acquires the dispatched top-k
    only (exact, bounded by capacity); margin_fn lists the runner-up keys,
    which prefetch takes as soft, candidate-protected orders."""
    if margin <= 0:
        return None, None

    def key_fn(ids_np, j):
        return np.unique(ids_np[j][..., : ids_np.shape[-1] - margin])

    def margin_fn(ids_np):
        k = ids_np.shape[-1] - margin
        return sorted({
            (mlis[j], int(e))
            for j in range(ids_np.shape[0])
            for e in np.unique(ids_np[j][..., k:])
        })

    return key_fn, margin_fn


def _tally_lease(counters, arena, missing):
    """Count the misses that only an eviction inside the dispatch's scope
    made (``ExpertArena.dispatch_snapshot``), and the executions they alone
    rejected: what counting those keys as misses costs."""
    if counters is None or not missing:
        return
    lost = sum(1 for k in missing if k in arena.last_lease_lost)
    counters["lease_misses"] = counters.get("lease_misses", 0) + lost
    if lost == len(missing):
        counters["lease_rejects"] = counters.get("lease_rejects", 0) + 1


def _tick(timings, phase, t0):
    t1 = _time.perf_counter()
    if timings is not None:
        timings[phase] = timings.get(phase, 0.0) + (t1 - t0)
    return t1


def run_speculative(arena, mlis, run, limit: int, key_fn=None, on_replay=None, timings=None,
                    counters=None):
    """Optimistic whole-step (or whole-block) execution against the arena's
    current slots.

    ``run(tree, slot_rows)`` queues one step or block whose MoE routing
    resolves on the device and returns (*outputs, trace [L_moe, ...]),
    device tensors. The host reads the trace, verifies the routed ids
    against the residency the dispatch saw, and runs again after loading
    the misses; the accepted execution had every routed expert resident, so
    it is exact. Layer 0's routing depends only on the (exact) inputs, so
    layer l settles by execution l + 1. The arena must hold one step's
    union of routed experts across the MoE layers.

    key_fn(ids_np, j) -> the expert ids of MoE layer j to verify (default
    ``np.unique`` of the row); with a routing margin it keeps the top-k.
    on_replay(replay, keys, missing, ids_np) runs after each verification.
    timings and counters (optional dicts) accumulate seconds by phase and
    ``_tally_lease``'s counts. Returns (outputs, ids_np, executions)."""
    if key_fn is None:
        key_fn = lambda ids, j: np.unique(ids[j])  # noqa: E731
    held: set = set()
    try:
        for replay in range(limit):
            t0 = _time.perf_counter()
            with arena.dispatch_snapshot(timings) as (tree, slot_rows, resident):
                *outs, trace = run(tree, slot_rows)
            ids_np = trace.cpu().numpy()
            t0 = _tick(timings, "dispatch_s", t0)
            keys = {(mlis[j], int(e)) for j in range(ids_np.shape[0]) for e in key_fn(ids_np, j)}
            missing = [k for k in keys if k not in resident]
            _tally_lease(counters, arena, missing)
            if on_replay is not None:
                on_replay(replay, keys, missing, ids_np)
            t0 = _tick(timings, "replay_hook_s", t0)
            # protect exactly this run's working set (acquire protects every
            # key before it evicts, so releasing first is safe)
            if held:
                arena.release(sorted(held))
            held = keys  # before acquire: a failed fetch still releases them
            arena.acquire(sorted(keys), mlis[-1] if mlis else 0)
            _tick(timings, "acquire_s", t0)
            if not missing:
                return outs, ids_np, replay + 1
        raise RuntimeError(
            f"speculative execution did not converge in {limit} replays; the arena "
            f"({arena.num_slots} slots) likely cannot hold one step's union of routed "
            "experts across MoE layers - raise num_slots or disable speculative decode"
        )
    finally:
        if held:
            arena.release(sorted(held))


def quantize_block(remaining: int, block: int) -> int:
    """Largest size of the halving chain {block, block/2, ..., 1} that fits
    ``remaining``: blocks only ever take log2(block) + 1 sizes."""
    k = max(1, block)
    while k > remaining:
        k //= 2
    return max(1, k)


def run_speculative_block(arena, mlis, dispatch, k: int, limit: int, tok0, kvs,
                          margin: int = 0, skip_mlis=frozenset(), timings=None, counters=None):
    """Speculative k-step decode with partial prefix acceptance.

    dispatch(tree, slot_rows, cur_tok, j0, kk, kvs) queues a kk-step greedy
    block from token ``cur_tok`` [B, 1] at step offset j0 and returns
    (toks [B, kk], kvs, ids [L_moe, B, kk, K']) on the device.

    A step whose routed experts, and its predecessors', were all resident
    at dispatch is exact, so the verified prefix is accepted and only the
    suffix runs again. The suffix's cache columns hold garbage until the
    next dispatch rewrites each of them before any read: a step writes its
    column before it attends, and the causal bound of its position keeps
    it off the columns after its own (the self-attention reads up to the
    cache's capacity, so that no launch depends on the step). The accepted
    tokens are copied out before the next dispatch, whose graph replay may
    overwrite the outputs of this one.

    Returns (tokens [B, k] numpy, kvs, executions, accepted ids
    [L_moe, B, k, K'] numpy)."""
    accepted_toks, accepted_ids = [], []
    cur = tok0
    held: set = set()
    execs = j0 = 0
    try:
        while j0 < k:
            if execs >= limit:
                raise RuntimeError(
                    f"speculative execution did not converge in {limit} replays; the arena "
                    f"({arena.num_slots} slots) likely cannot hold one step's union of "
                    "routed experts - raise num_slots or disable speculative decode"
                )
            # suffix sizes from the halving chain
            kk = quantize_block(k - j0, k)
            t0 = _time.perf_counter()
            with arena.dispatch_snapshot(timings) as (tree, slot_rows, resident):
                toks, kvs, ids = dispatch(tree, slot_rows, cur, j0, kk, kvs)
            execs += 1
            ids_np = ids.cpu().numpy()  # [L, B, kk, K']
            t0 = _tick(timings, "dispatch_s", t0)
            if margin > 0:
                # prefix exactness is judged on the dispatched top-k only
                ids_np = ids_np[..., : ids_np.shape[-1] - margin]
            step_keys = [
                {
                    (mlis[layer], int(e))
                    for layer in range(ids_np.shape[0])
                    if mlis[layer] not in skip_mlis
                    for e in np.unique(ids_np[layer, :, jj])
                }
                for jj in range(kk)
            ]
            good = kk
            for jj in range(kk):
                if any(key not in resident for key in step_keys[jj]):
                    good = jj
                    break
            _tally_lease(counters, arena,
                         {key for keys in step_keys[good:] for key in keys if key not in resident})
            if good > 0:
                # copies: the next dispatch may replay the graph whose
                # outputs these are (on the CPU, .numpy() shares them)
                accepted_toks.append(toks[:, :good].cpu().numpy().copy())
                accepted_ids.append(ids_np[:, :, :good].copy())
                cur = toks[:, good - 1:good].clone()
                j0 += good
            # acquire the observed union either way: on a miss it loads and
            # protects before the next dispatch; on acceptance it records
            # the hits and keeps the hot set protected until the block ends
            union = set().union(*step_keys) if step_keys else set()
            if held:
                arena.release(sorted(held))
            held = union
            arena.acquire(sorted(union), mlis[-1] if mlis else 0)
            _tick(timings, "acquire_s", t0)
        return (np.concatenate(accepted_toks, axis=1), kvs, execs,
                np.concatenate(accepted_ids, axis=2))
    finally:
        if held:
            arena.release(sorted(held))


def plan_drift_prefetch(engine, mlis, keys, budget):
    """Replay-drift prefetch: after a speculative miss, the next dispatch's
    corrected tokens route near, not onto, the observed union. Score each
    MoE layer's experts by global routing frequency blended with the
    tracer's transition affinity from the previous layer's observed experts,
    and order the best non-resident ones, so their fetches overlap the
    re-dispatch."""
    tracer, policy = engine.tracer, engine.arena.policy
    if tracer is None or budget <= 0:
        return []
    obs: Dict[int, set] = {mli: set() for mli in mlis}
    for (mli, e) in keys:
        if mli in obs:
            obs[mli].add(e)
    scored = []
    for j, mli in enumerate(mlis):
        score = policy.frequency[mli].astype(np.float64)
        tot = score.sum()
        if tot > 0:
            score = score / tot
        if (
            j > 0
            and mli - 1 == mlis[j - 1]
            and mli - 1 < tracer.transitions.shape[0]
            and obs[mlis[j - 1]]
        ):
            rows = tracer.transitions[mli - 1][sorted(obs[mlis[j - 1]])]
            aff_tot = rows.sum()
            if aff_tot > 0:
                score = score + rows.sum(axis=0) / aff_tot
        for e in np.flatnonzero(score > 0):
            if int(e) not in obs[mli]:
                scored.append((float(score[e]), (mli, int(e))))
    scored.sort(key=lambda t: -t[0])
    orders = []
    for _, key in scored:
        if engine.arena.is_resident(key):
            continue
        orders.append(key)
        if len(orders) >= budget:
            break
    return orders


def rolling_protect(engine, union):
    """Record ``union`` in the engine's protection ring (the last 4 accepted
    unions) and return the combined rolling hot set to candidate-protect."""
    ring = getattr(engine, "_protect_ring", None)
    if ring is None:
        ring = engine._protect_ring = deque(maxlen=4)
    ring.append(set(union))
    return sorted(set().union(*ring))


def make_block_monitor(engine, mlis, margin_fn=None):
    """(on_replay, log) for a speculative dispatch loop: logs each
    dispatch's union and miss counts into ``log`` and, on a miss, issues the
    drift prefetch so its fetches ride the replay's dispatch. margin_fn
    (ids_np) -> runner-up orders from the trace's margin columns, placed
    ahead of the drift orders."""
    log = {"unions": [], "misses": []}

    def on_replay(replay, keys, missing, ids_np=None):
        log["unions"].append(len(keys))
        log["misses"].append(len(missing))
        if missing and engine.prefetch:
            # small: orders beyond the miss count mostly fetch unlikely
            # experts whose landings cycle the arena
            budget = min(8, max(4, len(missing)))
            orders = plan_drift_prefetch(engine, mlis, keys, budget)
            if margin_fn is not None and ids_np is not None:
                near = [k for k in margin_fn(ids_np)
                        if k not in keys and not engine.arena.is_resident(k)]
                seen = set(near)
                orders = near + [k for k in orders if k not in seen]
            if orders:
                # protect the observed union and the rolling ring: a drift
                # fetch must never evict what this block, or a recent one,
                # is about to dispatch again
                ring = getattr(engine, "_protect_ring", [])
                guard = sorted(set(keys).union(*ring)) if ring else sorted(keys)
                engine.arena.prefetch(orders, protect=guard)

    return on_replay, log


def record_block_log(engine, log):
    """Keep the last 512 blocks' speculative diagnostics (``spec_log``)."""
    if not hasattr(engine, "spec_log"):
        engine.spec_log = []
    engine.spec_log.append(log)
    if len(engine.spec_log) > 512:
        del engine.spec_log[: len(engine.spec_log) - 512]


def spec_block_diag(spec_log) -> dict:
    """Per-dispatch miss structure over the logged blocks: the share of
    blocks accepted at dispatch 1 and 2, the mean final union, and the mean
    misses found at each dispatch index (misses at dispatch 2 and later are
    routing drift; at dispatch 1, a cold start)."""
    if not spec_log:
        return {}
    n = len(spec_log)
    execs = [len(b["misses"]) for b in spec_log]
    max_d = max(execs)
    miss_at = [
        round(float(np.mean([b["misses"][d] for b in spec_log if len(b["misses"]) > d])), 1)
        for d in range(min(max_d, 4))
    ]
    return {
        "blocks": n,
        "accept_at_1": sum(1 for e in execs if e == 1) / n,
        "accept_at_2": sum(1 for e in execs if e == 2) / n,
        "mean_union": round(float(np.mean([b["unions"][-1] for b in spec_log])), 1),
        "mean_miss_at_dispatch": miss_at,
    }


def spec_trace_and_prefetch(engine, ids_np, mlis, seq_ids, plan_floor=-1, n_feed=None,
                            budget_scale=1, extra_orders=()):
    """After an accepted speculative step or block: record the routing in
    the EAMC tracer and, with prefetch on, warm the next block's likely
    experts so their fetches overlap its dispatch. plan_floor: the
    planner's current layer (-1 for all MoE layers; the seq2seq engine
    passes its first decoder layer - 1). n_feed [B]: real tokens per row,
    for batched callers with idle rows (None in seq_ids)."""
    if engine.tracer is None or not seq_ids or not any(seq_ids):
        return
    for j, mli in enumerate(mlis):
        for b, sid in enumerate(seq_ids):
            if sid is None:
                continue
            row = ids_np[j, b]
            if n_feed is not None:
                if n_feed[b] == 0:
                    continue
                row = row[: int(n_feed[b])]
            engine.tracer.update_entry(sid, row.ravel(), mli)
    if not engine.prefetch:
        return
    first_sid = next(s for s in seq_ids if s is not None)
    # score from the first plannable layer: the block's routing sharpens
    # every future layer's row through the transition counts
    score = engine.predictor.predict_block(
        first_sid, {mli: ids_np[j] for j, mli in enumerate(mlis)},
        from_layer=max(plan_floor + 1, 0),
    )
    engine.arena.set_context(mlis[-1], engine.tracer.get_entry_decoder(first_sid).matrix)
    # a k-step block plans once per k tokens, so its plan may warm k steps'
    # worth; the budget goes round the layers, which the block revisits all
    orders = plan_prefetch(
        score, plan_floor, lookahead=None,
        budget=engine._current_budget() * max(1, budget_scale),
        is_resident=getattr(engine, "is_resident", engine.arena.is_resident),
        balance_layers=True,
    )
    if extra_orders:
        # the routing margin's runner-ups lead the plan
        extra = [k for k in extra_orders if not engine.arena.is_resident(k)]
        seen = set(extra)
        orders = extra + [o for o in orders if o not in seen]
    # protect the rolling hot set (the last few blocks' unions): churn
    # victims are the keys routed 1-3 blocks ago. Candidate protection binds
    # prefetch only, so a large ring cannot deadlock a small arena.
    union = [(mli, int(e)) for j, mli in enumerate(mlis) for e in np.unique(ids_np[j])]
    engine.arena.prefetch(orders, protect=rolling_protect(engine, union))


class _LayerClock:
    """The host seconds between two MoE layers (an EWMA) and the prefetch
    budget the arena can land within the lookahead window at that pace."""

    def _tick_layer_clock(self):
        t = _time.perf_counter()
        if self._last_layer_t is not None:
            dt = t - self._last_layer_t
            self._layer_seconds = (
                dt if self._layer_seconds is None else 0.8 * self._layer_seconds + 0.2 * dt
            )
        self._last_layer_t = t

    def _current_budget(self) -> int:
        if not self.adaptive_budget:
            return self.prefetch_budget
        return adaptive_prefetch_budget(
            self._layer_seconds,
            self.arena.fetch_seconds_ewma,
            self.arena.num_workers,
            self.lookahead,
            self.prefetch_budget,
        )


def _decoder_block_steps(model, params, impl: str, k: int):
    """The body of a decoder-only k-step greedy block: ``steps(tree, rows,
    tok0 [B, 1], step0, kvs) -> (toks [B, k], trace [L_moe, B, k, K])``,
    step0 an int or a 0-d tensor on the device. (It holds no reference to
    the engine, so that dropping the engine frees its arena at once.)"""

    def steps(tree, rows, tok0, step0, kvs):
        weights, biases = _split_arena_tree(tree)

        def for_layer(_experts, mli):
            return weights, rows[mli], biases

        B = tok0.shape[0]
        tok, toks, traces = tok0, [], []
        for j in range(k):
            step = step0 + j
            logits, _, (ids, _w) = model.forward(
                params, None, tok, step_positions(step, B, tok.device), kvs, step,
                for_layer=for_layer, impl=impl)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            traces.append(ids)  # [L, B, 1, K]
        return torch.cat(toks, dim=1), torch.cat(traces, dim=2)

    return steps


class OffloadEngine(_LayerClock):
    """Drives a decoder-only model's layer protocol against an
    ``ExpertArena``; the stepper protocol of ``Generator`` (``init_cache``,
    ``begin_sequences``, ``forward``, ``end_sequences``, and with
    ``speculative`` ``decode_block``).

    One difference from the JAX engine: only capacity errors
    (``is_spec_capacity_error``) change the path. A capacity error in a
    speculative step turns ``speculative`` off for good, as in JAX; JAX
    also runs the per-layer path for one step on any other ``RuntimeError``,
    which here is raised (a failed CUDA launch is one)."""

    def __init__(
        self,
        model,
        params,
        arena,
        *,
        tracer=None,
        predictor=None,
        prefetch: bool = True,
        lookahead: int = 3,
        prefetch_budget: Optional[int] = None,
        impl: str = "ragged",
        prefill_impl: Optional[str] = None,
        adaptive_budget: bool = True,
        speculative: bool = False,
        max_replays: Optional[int] = None,
        spec_block: int = 1,
        dense_arena=None,
        host_fallback: bool = False,
        host_fallback_timeout: float = 0.25,
        graphs: bool = True,
        graph_backend=None,
    ):
        """impl: the grouped-FFN implementation of one-token steps
        (``"pallas"`` is K3); prefill_impl: that of longer steps (default
        ``impl``). speculative: one-token steps run whole on the device,
        verified and run again on a miss; spec_block: the greedy block size
        ``Generator`` asks ``decode_block`` for; max_replays bounds the
        executions of one step or block (default: from the MoE depth and
        k). graphs: run the speculative step and blocks as CUDA graphs on
        the card (False runs them eagerly); graph_backend: the capture
        backend (default ``CudaGraphBackend`` on a CUDA model; on the CPU
        the steps run eagerly unless one is given). A model without
        ``graph_step`` (DeepSeek-V2) takes ``graphs=False`` only; on the card
        an ``impl`` that cannot be captured ("ragged") raises ``ValueError``
        unless graphs is False.
        dense_arena: a ``DenseLayerArena`` paging the layer stack
        (``params["layers"]`` is then not read); it forces the per-layer
        path, since a speculative step needs every dense layer resident.
        host_fallback: a routed expert that is not resident within
        ``host_fallback_timeout`` seconds runs on the host from its store
        record (``runtime/host_exec.py``) while the grouped FFN reads the
        arena's zero slot for it (the per-layer path only)."""
        if dense_arena is not None and speculative:
            raise ValueError(
                "speculative decode requires the dense side resident; "
                "disable speculative_decode when dense paging is active")
        self.dense_arena = dense_arena
        self.host_fallback = host_fallback
        self.host_fallback_timeout = host_fallback_timeout
        self.host_exec_count = 0
        self._host_exec = None
        if host_fallback:
            if arena.zero_slot is None:
                raise ValueError("host_fallback requires an arena built with reserve_zero_slot=True")
            from moe_infinity_tpu_torch.runtime.host_exec import HostExpertExecutor, activation_for

            self._host_exec = HostExpertExecutor(arena.store, activation_for(arena.store.meta))
        if arena.num_slots < model.spec.num_experts:
            raise ValueError(
                f"arena num_slots={arena.num_slots} < num_experts={model.spec.num_experts}; "
                "the slot arena must fit one full MoE layer")
        self.model = model
        self.params = params
        self.arena = arena
        self.tracer = tracer
        self.predictor = predictor
        self.prefetch = prefetch and predictor is not None
        self.lookahead = lookahead
        # no more than half the arena per plan; with adaptive_budget the live
        # budget shrinks to what the arena can land inside the lookahead window
        self.prefetch_budget = prefetch_budget or max(1, arena.num_slots // 2)
        self.adaptive_budget = adaptive_budget
        self._layer_seconds: Optional[float] = None
        self._last_layer_t: Optional[float] = None
        self._impl = impl
        self._pimpl = prefill_impl or impl
        self.speculative = speculative
        self.max_replays = max_replays
        self.spec_block = max(1, spec_block)
        # executions per speculative step or block, in order
        self.replay_counts: list = []
        # cumulative seconds of the speculative loop by phase, and the misses
        # that only an eviction inside a dispatch's scope made (_tally_lease)
        self.phase_timings: dict = {}
        self.lease_counts: dict = {}
        # one-token decoder steps run on the device, replays included
        self.executed_steps = 0
        self._moe_lis = [mli for mli in map(model.moe_layer_index, range(model.spec.num_layers))
                         if mli is not None]
        self._spec_block_cache: dict = {}
        self._graph_step = getattr(model, "graph_step", False)
        # one graph per step shape (the JAX engine's jit cache), over the
        # K/V caches the engine owns per (B, capacity)
        self.graphs: Optional[GraphCache] = None
        # (paged layers run eagerly: they take the per-layer path only)
        if graphs and dense_arena is None and (graph_backend is not None
                                               or model.device.type == "cuda"):
            if not self._graph_step:
                raise _not_ported(
                    f"CUDA graphs of the {model.arch} decode step (pass graphs=False)",
                    "10a part 2")
            self.graphs = graph_cache(graphs, graph_backend, model.device, impl)
            self._buffers = DecodeBuffers(model)
            self._param_tensors = flat_tensors(params)

    # ---- stepper protocol ----------------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        """The K/V caches of one request: with graphs the engine's own of
        this shape, which its graphs read by address; else new ones."""
        if self.graphs is not None:
            return self._buffers.caches(batch, max_len)
        return self.model.init_cache(batch, max_len)

    def begin_sequences(self, batch: int) -> Optional[List[str]]:
        if self.tracer is None:
            return None
        return [self.tracer.create_entry() for _ in range(batch)]

    def end_sequences(self, seq_ids) -> None:
        if self.tracer is None or not seq_ids:
            return
        for sid in seq_ids:
            self.tracer.finish_entry(sid)

    def forward(self, tokens, positions, kv_caches, kv_len: int, seq_ids=None):
        """One step of tokens [B, T] at cache column ``kv_len``: (logits
        [B, T, V] f32, the caches (written in place), router trace (ids
        [L_moe, B, T, K], weights)). A one-token step with ``speculative``
        runs whole over the slots; anything else runs layer by layer."""
        model, params = self.model, self.params
        if self.speculative and tokens.shape[1] == 1:
            try:
                return self._speculative_step(tokens, kv_len, kv_caches, seq_ids)
            except RuntimeError as e:
                if not is_spec_capacity_error(e):
                    raise
                _log.warning("speculative decode disabled (%s); falling back to the "
                             "per-layer path", e)
                self.speculative = False
        if tokens.shape[1] == 1:
            self.executed_steps += 1
        x = model.embed(params, tokens)
        trace_ids, trace_w = [], []
        self._last_layer_t = None  # the host's gap between steps is no layer period
        for li in range(model.spec.num_layers):
            self._tick_layer_clock()
            mli = model.moe_layer_index(li)
            if self.dense_arena is not None:
                x, kv_caches[li], routed = self._paged_layer(
                    li, mli, x, kv_caches[li], positions, kv_len, seq_ids)
                if routed is not None:
                    trace_ids.append(routed[0])
                    trace_w.append(routed[1])
                continue
            pl = params["layers"][li]
            if mli is None:  # a leading dense layer (DeepSeek)
                x, kv_caches[li] = model.dense_layer(pl, x, kv_caches[li], positions, kv_len)
                continue
            x, h, cw, ids, kv_caches[li] = model.pre_moe(pl, x, kv_caches[li], positions, kv_len)
            ids_np = ids.cpu().numpy()  # [B, T, K]; the host waits for the routing
            keys = [(mli, int(e)) for e in np.unique(ids_np)]
            self._trace_and_prefetch(ids_np, mli, seq_ids)
            x = self._moe_apply(pl, x, h, cw, ids, ids_np, keys, mli)
            trace_ids.append(ids)
            trace_w.append(cw)
        return model.head(params, x), kv_caches, (torch.stack(trace_ids), torch.stack(trace_w))

    def _paged_layer(self, li, mli, x, kv, positions, kv_len, seq_ids):
        """One layer on its dense-arena slot (and, for a MoE layer, K3 over
        the expert arena): (x, kv, (ids, cw) or None). As in JAX, its MoE
        block acquires with no host fallback and runs ``impl``."""
        da, model = self.dense_arena, self.model
        slot = da.acquire(li)
        try:
            pl = da.layer_view(li, slot)
            if mli is None:
                x, kv = model.dense_layer(pl, x, kv, positions, kv_len)
                return x, kv, None
            x, h, cw, ids, kv = model.pre_moe(pl, x, kv, positions, kv_len)
            ids_np = ids.cpu().numpy()
            keys = [(mli, int(e)) for e in np.unique(ids_np)]
            self._trace_and_prefetch(ids_np, mli, seq_ids)
            self.arena.acquire(keys, mli)
            row = torch.from_numpy(self.arena.slot_map(mli)).to(model.device)
            with self.arena.locked_tree(keys) as tree:
                weights, biases = _split_arena_tree(tree)
                x = model.apply_moe(pl, x, h, cw, ids, weights, row, biases, self._impl)
            self.arena.release(keys)
            return x, kv, (ids, cw)
        finally:
            da.release(li)

    def _moe_apply(self, pl, x, h, cw, ids, ids_np, keys, mli):
        """Acquire + grouped-FFN apply of one MoE layer over the slots."""
        impl = self._impl if h.shape[1] == 1 else self._pimpl
        return apply_over_slots(
            self, keys, mli, h, cw, ids_np,
            lambda weights, row, biases: self.model.apply_moe(
                pl, x, h, cw, ids, weights, row, biases, impl))

    def _trace_and_prefetch(self, ids_np, mli: int, seq_ids) -> None:
        """Record this layer's routing in the tracer and, with prefetch on,
        plan and enqueue the next layers' likely experts."""
        if self.tracer is None or not seq_ids:
            return
        if self.prefetch:
            score = None
            for b, sid in enumerate(seq_ids):
                # predict() also records the activations in the tracer
                score = self.predictor.predict(sid, ids_np[b], mli)
            self.arena.set_context(mli, self.tracer.get_entry_decoder(seq_ids[0]).matrix)
            orders = plan_prefetch(score, mli, lookahead=self.lookahead,
                                   budget=self._current_budget(),
                                   is_resident=self.arena.is_resident)
            if orders:
                self.arena.prefetch(orders)
        else:
            for b, sid in enumerate(seq_ids):
                self.tracer.update_entry(sid, ids_np[b], mli)

    # ---- speculative decode --------------------------------------------------
    def _step_arg(self, step: int):
        """The step as the speculative path passes it: with graphs the int
        (the graph's 0-d input buffer takes it); eagerly, for a model with
        ``graph_step``, a 0-d device tensor, so that the eager path launches
        what a replay does (K1 planned from the cache's capacity)."""
        if self.graphs is None and self._graph_step:
            return torch.full((), step, dtype=torch.int32, device=self.model.device)
        return step

    def _closes_over(self, tree, kvs) -> list:
        """Every tensor a step's graph reads by address."""
        return [*self._param_tensors, *flat_tensors(tree), *flat_tensors(kvs)]

    def _spec_step(self, tree, slot_rows, tokens, step, kvs):
        """One whole decoder step over the slots: (logits, weights trace,
        ids trace). With graphs, one replay of the step's graph, whose
        outputs the next replay overwrites."""
        self.executed_steps += 1
        model, B = self.model, tokens.shape[0]

        def run(tok, step, rows):
            weights, biases = _split_arena_tree(tree)
            logits, _, (ids, w) = model.forward(
                self.params, None, tok, step_positions(step, B, tok.device), kvs, step,
                for_layer=lambda _experts, mli: (weights, rows[mli], biases), impl=self._impl)
            return logits, w, ids

        if self.graphs is None:
            return run(tokens, step, slot_rows)
        return self.graphs.run("step", run, {"tok": tokens, "step": step, "rows": slot_rows},
                               self._closes_over(tree, kvs))

    def _speculative_step(self, tokens, kv_len: int, kv_caches, seq_ids):
        step = self._step_arg(kv_len)

        def run(tree, slot_rows):
            return self._spec_step(tree, slot_rows, tokens, step, kv_caches)

        limit = self.max_replays or (len(self._moe_lis) + 2)
        (logits, t_w), ids_np, execs = run_speculative(
            self.arena, self._moe_lis, run, limit, timings=self.phase_timings,
            counters=self.lease_counts)
        self.replay_counts.append(execs)
        spec_trace_and_prefetch(self, ids_np, self._moe_lis, seq_ids)
        # copies: a later replay overwrites a graph's outputs
        return logits.clone(), kv_caches, (torch.from_numpy(ids_np), t_w.clone())

    def _spec_block_fn(self, k: int):
        """A k-step greedy block over the slots: ``block(tree, slot_rows,
        tok0 [B, 1], step0, kvs)`` queues k decode steps, each fed the
        argmax of the step before, and returns (toks [B, k], kvs, trace
        [L_moe, B, k, K]), all on the device. The body is cached per k, as
        the JAX engine caches its jitted block; with graphs each call is one
        replay of the block's graph."""
        steps = self._spec_block_cache.get(k)
        if steps is None:
            steps = self._spec_block_cache[k] = _decoder_block_steps(
                self.model, self.params, self._impl, k)

        def block(tree, slot_rows, tok0, step0, kvs):
            self.executed_steps += k
            step0 = self._step_arg(step0)
            if self.graphs is None:
                toks, trace = steps(tree, slot_rows, tok0, step0, kvs)
            else:
                toks, trace = self.graphs.run(
                    f"block{k}", lambda tok, step, rows: steps(tree, rows, tok, step, kvs),
                    {"tok": tok0, "step": step0, "rows": slot_rows},
                    self._closes_over(tree, kvs), steps=k)
            return toks, kvs, trace

        return block

    def decode_block(self, tok, pos: int, kv_caches, k: int, seq_ids=None):
        """k greedy decode steps from token ``tok`` [B, 1] at cache column
        ``pos`` as one speculative block: ``whole`` (the default
        ``MOE_SPEC_BLOCK_MODE``) runs the whole block again on a miss,
        ``prefix`` accepts the verified prefix and runs the suffix again.
        Returns (tokens [B, k] numpy, kv_caches). A capacity error (the
        arena cannot hold the block's union) is raised for the caller to
        take a smaller block."""
        mlis = self._moe_lis
        if os.environ.get("MOE_SPEC_BLOCK_MODE", "whole") == "whole":
            fn = self._spec_block_fn(k)

            def run(tree, slot_rows):
                toks, kvs, tr = fn(tree, slot_rows, tok, pos, kv_caches)
                return toks, kvs, tr.reshape(tr.shape[0], tr.shape[1], -1)

            limit = self.max_replays or (len(mlis) + 2 + k)
            on_replay, blog = make_block_monitor(self, mlis)
            (toks, kvs), ids_np, execs = run_speculative(
                self.arena, mlis, run, limit, on_replay=on_replay,
                timings=self.phase_timings, counters=self.lease_counts)
            record_block_log(self, blog)
            self.replay_counts.append(execs)
            spec_trace_and_prefetch(self, ids_np, mlis, seq_ids, budget_scale=k)
            # a copy: the next dispatch replays the graph whose output this
            # is (on the CPU, .numpy() shares it)
            return toks.cpu().numpy().copy(), kvs

        def dispatch(tree, slot_rows, cur, j0, kk, kvs_):
            return self._spec_block_fn(kk)(tree, slot_rows, cur, pos + j0, kvs_)

        limit = self.max_replays or (len(mlis) + 2) * k
        toks, kvs, execs, acc_ids = run_speculative_block(
            self.arena, mlis, dispatch, k, limit, tok, kv_caches,
            timings=self.phase_timings, counters=self.lease_counts)
        self.replay_counts.append(execs)
        spec_trace_and_prefetch(self, acc_ids.reshape(acc_ids.shape[0], acc_ids.shape[1], -1),
                                mlis, seq_ids, budget_scale=k)
        return toks, kvs

    # ---- metrics ---------------------------------------------------------------
    def hit_rate(self) -> float:
        return self.arena.policy.stats.hit_rate

    def stats(self) -> dict:
        out = self.arena.hit_stats()
        out.update(speculative_stats(self.replay_counts))
        if self.dense_arena is not None:
            out.update(self.dense_arena.stats())
        if self.host_fallback:
            out["host_exec_count"] = self.host_exec_count
        return out

    def node_stats(self) -> dict:
        return self.arena.node_stats()

    def graph_stats(self) -> dict:
        """Captures, replays and capture seconds of the engine's graphs
        (empty when it runs eagerly)."""
        return self.graphs.stats() if self.graphs is not None else {}
