"""dtype names of the expert store, from ``moe_infinity_tpu/utils/dtypes.py``,
without ``ml_dtypes`` (it ships with jax).

numpy has no bfloat16: a bf16 field is held on the host as its raw ``uint16``
bits and viewed as ``torch.bfloat16`` once it is a tensor (``to_tensor``,
``host_copy``). ``float8_e4m3fn`` raises ``NotImplementedError``: K3 takes
no fp8 weights yet.
"""

from __future__ import annotations

import numpy as np
import torch

_NAME_TO_NP = {
    "bfloat16": np.dtype(np.uint16),  # raw bits
    "float32": np.dtype(np.float32),
    "float16": np.dtype(np.float16),
    "int8": np.dtype(np.int8),
    # int4 is stored packed two-per-byte in an int8 container; field shapes
    # carry the PACKED (halved out-axis) dims (store/quant.py pack_int4_np)
    "int4": np.dtype(np.int8),
}

_NAME_TO_TORCH = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
    "int4": torch.int8,
}

# same-size integer view of each torch dtype, for copies through numpy
_TORCH_TO_NP_VIEW = {
    torch.bfloat16: (torch.int16, np.uint16),
    torch.float32: (torch.float32, np.float32),
    torch.float16: (torch.float16, np.float16),
    torch.int8: (torch.int8, np.int8),
}


def _no_fp8(name: str) -> None:
    if name == "float8_e4m3fn":
        raise NotImplementedError(
            "float8_e4m3fn fields are not ported (ROADMAP queue 2, part 1: K3 takes no "
            "fp8 weights yet)"
        )


def np_dtype(name: str) -> np.dtype:
    _no_fp8(name)
    return _NAME_TO_NP[name]


def torch_dtype(name: str) -> torch.dtype:
    _no_fp8(name)
    return _NAME_TO_TORCH[name]


def dtype_name(dt) -> str:
    """Store name of a numpy dtype (``uint16`` reads as ``bfloat16`` bits)."""
    dt = np.dtype(dt)
    for name, cand in _NAME_TO_NP.items():
        if cand == dt:
            return name
    return dt.name


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """Round to bfloat16 (to nearest, ties to even) and return the bits as
    ``uint16``, as ``astype(ml_dtypes.bfloat16)`` rounds."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def to_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    """CPU tensor of a host field of store dtype ``name`` (bf16 bits viewed
    as ``torch.bfloat16``). Shares memory with ``a`` when ``a`` is writable;
    a read-only view (a memory-mapped store) is copied first."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def host_copy(dst: torch.Tensor, a: np.ndarray, name: str) -> None:
    """Write host field ``a`` (store dtype ``name``) into the CPU tensor
    ``dst``, cast to ``dst``'s dtype. Without a cast the bytes go through
    numpy, which reads a read-only memory map without copying it first."""
    if torch_dtype(name) == dst.dtype:
        tview, nview = _TORCH_TO_NP_VIEW[dst.dtype]
        np.copyto(dst.view(tview).numpy().view(nview), a.view(nview), casting="no")
    else:
        dst.copy_(to_tensor(a, name))
