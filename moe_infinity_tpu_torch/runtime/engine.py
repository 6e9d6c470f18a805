"""Helpers of the offload engines, from ``moe_infinity_tpu/runtime/engine.py``:
``_split_arena_tree`` and the speculative helpers the seq2seq engine runs.

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
tokens once they are accepted. The decoder-only ``OffloadEngine`` and the
host fallback (``host_exec.py``) wait for ROADMAP queue-1 items 14 and 8.
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Dict, Sequence

import numpy as np
import torch

from moe_infinity_tpu_torch.memory.prefetch_plan import plan_prefetch

_BIAS_KEYS = ("gate_bias", "down_bias")


def _split_arena_tree(tree: Dict[str, torch.Tensor]):
    """(weights, biases or None) of an arena's slot tensors."""
    weights = {k: v for k, v in tree.items() if k not in _BIAS_KEYS}
    biases = {k: v for k, v in tree.items() if k in _BIAS_KEYS}
    return weights, (biases or None)


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
