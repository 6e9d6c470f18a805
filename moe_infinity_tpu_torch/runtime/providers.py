"""Expert weight providers: how MoE layers obtain their expert weights
(from ``moe_infinity_tpu/runtime/providers.py``).

A provider contributes (a) a tree of device tensors and (b) an accessor
``for_layer(tree, moe_layer_id) -> (weights, expert_to_slot, biases)`` whose
output feeds ``ops.moe.grouped_ffn``.

* ``ResidentProvider`` - every expert of every MoE layer resident on the
  device ([L][role][E, ...]); expert_to_slot is the identity.
"""

from __future__ import annotations

from typing import Dict, List

import torch


class ResidentProvider:
    """All experts of all layers on the device, from an expert tree
    ``{"layers": [{role: tensor}], "slot_map": [E] int32}`` as
    ``NllbModel.init_random`` and ``bridge.to_torch`` produce it."""

    def __init__(self, tree: Dict):
        self._layers: List[Dict[str, torch.Tensor]] = list(tree["layers"])
        self._slot_map = tree["slot_map"]

    # -- provider protocol -------------------------------------------------
    def pytree(self):
        return {"layers": self._layers, "slot_map": self._slot_map}

    @staticmethod
    def for_layer(tree, moe_layer_id: int):
        w = dict(tree["layers"][moe_layer_id])
        biases = {bk: w.pop(bk) for bk in ("gate_bias", "down_bias") if bk in w}
        return w, tree["slot_map"], (biases or None)

    def nbytes(self) -> int:
        """Device bytes of every expert tensor."""
        return sum(
            v.numel() * v.element_size() for layer in self._layers for v in layer.values()
        )
