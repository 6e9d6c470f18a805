"""Expert role names per architecture, from ``moe_infinity_tpu/common/arch.py``
(``FFN_ROLES``): the canonical roles of the MoE blocks mapped onto the
store's tensor tails. 'up' is None for non-gated FFNs."""

from __future__ import annotations

from typing import Dict, Optional

FFN_ROLES: Dict[str, Dict[str, Optional[str]]] = {
    "switch": {"gate_or_in": "wi.weight", "up": None, "down": "wo.weight"},
    "switch_gated": {
        "gate_or_in": "wi_0.weight",
        "up": "wi_1.weight",
        "down": "wo.weight",
    },
    "nllb": {"gate_or_in": "fc1.weight", "up": None, "down": "fc2.weight"},
    "mixtral": {"gate_or_in": "w1.weight", "up": "w3.weight", "down": "w2.weight"},
    "arctic": {"gate_or_in": "w1.weight", "up": "w3.weight", "down": "w2.weight"},
    "grok": {
        "gate_or_in": "linear.weight",
        "up": "linear_v.weight",
        "down": "linear_1.weight",
    },
    "deepseek": {
        "gate_or_in": "gate_proj.weight",
        "up": "up_proj.weight",
        "down": "down_proj.weight",
    },
    "deepseek_v3": {
        "gate_or_in": "gate_proj.weight",
        "up": "up_proj.weight",
        "down": "down_proj.weight",
    },
}
