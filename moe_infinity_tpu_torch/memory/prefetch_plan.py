"""Prefetch planning: predicted activation matrix -> ordered fetch list,
from ``moe_infinity_tpu/memory/prefetch_plan.py``.

Take the predictor's [L, E] score matrix, keep positive scores, sort
descending, and emit (layer, expert) fetch orders, bounded by a lookahead
window and a count budget so the host controller never floods the copy
queue.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

Key = Tuple[int, int]


def plan_prefetch(
    score_matrix: np.ndarray,  # [L, E] predicted activation scores
    current_layer: int,
    *,
    lookahead: Optional[int] = None,  # layers ahead to consider (None = all)
    budget: Optional[int] = None,  # max number of fetch orders
    is_resident: Optional[Callable[[Key], bool]] = None,
    balance_layers: bool = False,
) -> List[Key]:
    """Ordered (layer, expert) prefetch list, best score first.

    balance_layers: round-robin the budget across layers (each layer's
    candidates stay score-ordered) instead of one global flat sort. The
    flat sort is right for within-step lookahead, where nearer layers ARE
    more urgent; a speculative block revisits ALL its MoE layers within
    about one dispatch, and under the predictor's layer-distance decay the
    flat sort spends the whole budget on early layers, starving depth."""
    L, E = score_matrix.shape
    m = score_matrix.astype(np.float64).copy()
    m[: current_layer + 1, :] = 0.0
    if lookahead is not None:
        m[current_layer + 1 + lookahead :, :] = 0.0
    if balance_layers:
        per_layer = []
        for layer in range(L):
            nz = np.flatnonzero(m[layer] > 0)
            if nz.size:
                per_layer.append(
                    (layer, nz[np.argsort(-m[layer][nz], kind="stable")])
                )
        out: List[Key] = []
        rank = 0
        while per_layer and (budget is None or len(out) < budget):
            advanced = False
            for layer, order in per_layer:
                if rank >= order.size:
                    continue
                advanced = True
                key = (layer, int(order[rank]))
                if is_resident is not None and is_resident(key):
                    continue
                out.append(key)
                if budget is not None and len(out) >= budget:
                    break
            if not advanced:
                break
            rank += 1
        return out
    flat = m.reshape(-1)
    nz = np.flatnonzero(flat > 0)
    if nz.size == 0:
        return []
    order = nz[np.argsort(-flat[nz], kind="stable")]
    out = []
    for idx in order:
        key = (int(idx // E), int(idx % E))
        if is_resident is not None and is_resident(key):
            continue
        out.append(key)
        if budget is not None and len(out) >= budget:
            break
    return out


def adaptive_prefetch_budget(
    layer_seconds: Optional[float],
    fetch_seconds: Optional[float],
    workers: int,
    lookahead: int,
    cap: int,
) -> int:
    """Bandwidth-aware prefetch budget: how many expert fetches the arena
    can land before the lookahead window closes.

    `workers` fetchers each take `fetch_seconds` per expert (EWMA measured
    by the arena), and the plan's window is `lookahead` layers of
    `layer_seconds` each. Queueing more than window * workers /
    fetch_seconds orders just builds a backlog that the next plan purges.
    Returns a value in [1, cap]."""
    if not layer_seconds or not fetch_seconds or fetch_seconds <= 0:
        return cap
    can_land = int(lookahead * layer_seconds * workers / fetch_seconds)
    return max(1, min(cap, can_land))
