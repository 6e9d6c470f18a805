"""Carry parameter trees between numpy and the port's tensors.

The JAX package's NLLB param pytree and expert tree, turned into numpy
arrays, map one to one onto the port's: the same keys, shapes and layouts
(dense ``[out, in]``, experts ``[E, D, F]``, packed int4 under ``"<role>4"``
with ``"<role>_scale"``). numpy has no bfloat16 of its own, so a bf16 array
travels as its uint16 bit pattern: ``to_torch`` reads every uint16 array as
bf16 bits, and ``to_numpy`` writes bf16 tensors that way.
"""

from __future__ import annotations

import numpy as np
import torch

from moe_infinity_tpu_torch import resolve_device


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint16:  # bf16 bit pattern
        return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def to_torch(tree, device="cuda"):
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    tensors on ``device``. Other leaves (ints, None) pass through."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, (np.ndarray, np.generic)):
            return _tensor(x, dev)
        return x

    return conv(tree)


def to_numpy(tree):
    """Inverse of ``to_torch``: tensors -> numpy arrays on the host, bf16 as
    uint16 bits."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu()
            if t.dtype == torch.bfloat16:
                return t.view(torch.int16).numpy().view(np.uint16)
            return t.numpy()
        return x

    return conv(tree)
