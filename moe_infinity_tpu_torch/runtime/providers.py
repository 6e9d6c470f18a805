"""Expert weight providers: how MoE layers obtain their expert weights
(from ``moe_infinity_tpu/runtime/providers.py``).

A provider contributes (a) a tree of device tensors and (b) an accessor
``for_layer(tree, moe_layer_id) -> (weights, expert_to_slot, biases)`` whose
output feeds ``ops.moe.grouped_ffn``.

* ``ResidentProvider`` - every expert of every MoE layer resident on the
  device ([L][role][E, ...]); expert_to_slot is the identity. Built from an
  expert tree (``NllbModel.init_random``, ``bridge.to_torch``) or, with
  ``from_store``, by stacking a store's records per layer.
* ``runtime/arena.py::ExpertArena`` - one shared slot arena and per-layer
  slot rows: the offload path.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.common.arch import FFN_ROLES
from moe_infinity_tpu_torch.utils.dtypes import to_tensor


def role_map_for(store_meta: dict) -> Dict[str, Optional[str]]:
    arch = store_meta["arch"]
    if arch == "switch" and store_meta.get("gated"):
        return FFN_ROLES["switch_gated"]
    return FFN_ROLES[arch]


_ROLE_KEYS = {"gate_or_in": "gate", "up": "up", "down": "down"}
_BIAS_TAILS = {"fc1.bias": "gate_bias", "fc2.bias": "down_bias"}


class ResidentProvider:
    """All experts of all layers on the device, from an expert tree
    ``{"layers": [{role: tensor}], "slot_map": [E] int32}`` as
    ``NllbModel.init_random`` and ``bridge.to_torch`` produce it."""

    def __init__(self, tree: Dict):
        self._layers: List[Dict[str, torch.Tensor]] = list(tree["layers"])
        self._slot_map = tree["slot_map"]

    @classmethod
    def from_store(cls, store, *, dtype=torch.bfloat16, device="cuda") -> "ResidentProvider":
        """Stack every record of ``store`` per layer, with the bytes the
        store holds: quantized roles stay quantized (packed int4 under
        ``'<role>4'``, the scale under ``'<role>_scale'``), unquantized
        roles are cast to ``dtype``, biases to f32."""
        dev = resolve_device(device)
        roles = role_map_for(store.meta)
        names = set(store.field_names)
        fdtype = {f.name: f.dtype for f in store.fields}
        E = store.num_experts

        layers = []
        for layer in range(store.num_layers):
            recs = [store.get_expert(layer, e) for e in range(E)]  # one read a record

            def stacked(tail):
                return to_tensor(np.stack([r[tail] for r in recs]), fdtype[tail])

            w: Dict[str, torch.Tensor] = {}
            for role, tail in roles.items():
                if tail is None:
                    continue
                key = _ROLE_KEYS[role]
                t = stacked(tail)
                if tail + ".scale" in names:
                    w[key + "4" if fdtype[tail] == "int4" else key] = t.to(dev)
                    w[key + "_scale"] = stacked(tail + ".scale").to(dev)
                else:
                    w[key] = t.to(device=dev, dtype=dtype if t.is_floating_point() else t.dtype)
            for tail, key in _BIAS_TAILS.items():
                if tail in names:
                    w[key] = stacked(tail).to(device=dev, dtype=torch.float32)
            layers.append(w)
        return cls({"layers": layers,
                    "slot_map": torch.arange(E, dtype=torch.int32, device=dev)})

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
