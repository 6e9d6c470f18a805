"""Carry parameter trees between numpy and the port's tensors.

The JAX package's param pytrees and expert trees, turned into numpy
arrays, map one to one onto the port's: the same keys, shapes and layouts
(dense ``[out, in]``, experts ``[E, D, F]``, packed int4 under ``"<role>4"``
with ``"<role>_scale"``, fp8 experts beside their scales). numpy has no
bfloat16 and no fp8 of its own, so a bf16 array travels as its uint16 bit
pattern and a float8_e4m3fn array as its uint8 codes: ``to_torch`` reads
every uint16 array as bf16 bits and every uint8 array as e4m3 codes, and
``to_numpy`` writes such tensors that way.
"""

from __future__ import annotations

import numpy as np
import torch

from moe_infinity_tpu_torch import resolve_device


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint16:  # bf16 bit pattern
        return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    if a.dtype == np.uint8:  # float8_e4m3fn codes
        return torch.tensor(a, device=device).view(torch.float8_e4m3fn)
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
    uint16 bits, fp8 as uint8 codes."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu()
            if t.dtype == torch.bfloat16:
                return t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.float8_e4m3fn:
                return t.view(torch.uint8).numpy()
            return t.numpy()
        return x

    return conv(tree)
