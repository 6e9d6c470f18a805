"""Helpers of the offload engines, from ``moe_infinity_tpu/runtime/engine.py``.

Only ``_split_arena_tree`` is ported; the decoder-only ``OffloadEngine`` and
the speculative helpers wait for ROADMAP queue-1 item 8.
"""

from __future__ import annotations

from typing import Dict

import torch

_BIAS_KEYS = ("gate_bias", "down_bias")


def _split_arena_tree(tree: Dict[str, torch.Tensor]):
    """(weights, biases or None) of an arena's slot tensors."""
    weights = {k: v for k, v in tree.items() if k not in _BIAS_KEYS}
    biases = {k: v for k, v in tree.items() if k in _BIAS_KEYS}
    return weights, (biases or None)
