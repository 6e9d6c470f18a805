"""Activation-aware expert prediction, from
``moe_infinity_tpu/memory/predictor.py``.

Update the sequence's EAM, find the most-similar historical matrix, zero
the past, and apply a linear layer-distance decay `-(x - l)/(L + 1) + 1`
so nearer layers score higher. Output is a [L, E] score matrix over future
layers. The next layer's row is sharpened with measured inter-layer expert
affinity - P(expert at l+1 | experts routed at l) from the tracer's
transition counts; the blend keeps the row's magnitude so the global flat
ranking across layers stays comparable.
"""

from __future__ import annotations

import numpy as np

from moe_infinity_tpu_torch.memory.tracer import ExpertTracer


class ExpertPredictor:
    def __init__(self, tracer: ExpertTracer, affinity_weight: float = 0.5):
        self.tracer = tracer
        self.num_layers = tracer.num_layers
        self.num_experts = tracer.num_experts
        self.affinity_weight = float(affinity_weight)

    def predict(
        self, seq_id: str, expert_ids: np.ndarray, layer_idx: int
    ) -> np.ndarray:
        """Record this layer's routing and return predicted activation
        scores for layers >= layer_idx ([L, E] float32, zeros for the past)."""
        self.tracer.update_entry(seq_id, expert_ids, layer_idx)
        score = self.predict_from(seq_id, layer_idx)
        w = self.affinity_weight
        if w > 0 and layer_idx + 1 < self.num_layers:
            t = self.tracer.transitions[layer_idx]  # [E, E] counts
            rows = t[np.unique(np.asarray(expert_ids).reshape(-1))]
            total = rows.sum()
            if total > 0:
                aff = rows.sum(axis=0) / total  # P(expert at l+1)
                nr = score[layer_idx + 1]
                # rescale the distribution to the row's magnitude so the
                # blended row ranks comparably in the flat cross-layer sort
                amax = aff.max()
                scale = nr.max() if nr.max() > 0 else 1.0
                score[layer_idx + 1] = (1.0 - w) * nr + w * (
                    aff / (amax or 1.0)
                ) * scale
        return score

    def predict_block(
        self, seq_id: str, obs: dict, from_layer: int = 0
    ) -> np.ndarray:
        """Block-aware scoring for speculative k-step decode: the
        EAM-similarity prior (predict_from) with transition affinity
        blended into EVERY future layer's row from the block's realized
        routing — predict() sharpens only layer+1, but a speculative block
        observes all its MoE layers at once, so each observed layer l can
        sharpen layer l+1 from the tracer's (L-1) x E x E transition
        counts.

        obs: {moe_layer_index: routed expert-id array} for the block."""
        score = self.predict_from(seq_id, from_layer)
        w = self.affinity_weight
        if w <= 0:
            return score
        n_trans = self.tracer.transitions.shape[0]
        for mli, ids in obs.items():
            nl = mli + 1
            if nl >= self.num_layers or nl < from_layer or mli >= n_trans:
                continue
            rows = self.tracer.transitions[mli][
                np.unique(np.asarray(ids).reshape(-1))
            ]
            total = rows.sum()
            if total <= 0:
                continue
            aff = rows.sum(axis=0) / total
            nr = score[nl]
            amax = aff.max()
            scale = nr.max() if nr.max() > 0 else 1.0
            score[nl] = (1.0 - w) * nr + w * (aff / (amax or 1.0)) * scale
        return score

    def predict_from(self, seq_id: str, from_layer: int = 0) -> np.ndarray:
        """Scoring only (no routing update): predicted activations for
        layers >= from_layer from the sequence's current EAM. The
        speculative whole-step decoder uses this with from_layer=0 (or the
        first decoder layer) to warm the NEXT step across ALL its MoE
        layers — predict()'s score zeroes everything below the layer just
        recorded, which is right for within-step lookahead only."""
        current = self.tracer.get_entry(seq_id)
        matrix = self.tracer.find_most_similar(current.matrix, from_layer)
        matrix[:from_layer, :] = 0.0
        L = self.num_layers
        future = np.arange(from_layer, L, dtype=np.float32)
        decay = -(future - from_layer) / (L + 1) + 1.0  # [L - from_layer]
        matrix[from_layer:, :] = (
            matrix[from_layer:, :] + 1e-8
        ) * decay[:, None]
        return matrix
