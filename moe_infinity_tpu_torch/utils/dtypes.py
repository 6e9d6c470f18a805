"""dtype names of the expert store, from ``moe_infinity_tpu/utils/dtypes.py``,
without ``ml_dtypes`` (it ships with jax).

numpy has no bfloat16 and no fp8: a bf16 field is held on the host as its
raw ``uint16`` bits and viewed as ``torch.bfloat16`` once it is a tensor
(``to_tensor``, ``host_copy``); a ``float8_e4m3fn`` field likewise as its
``uint8`` codes, viewed as ``torch.float8_e4m3fn``. ``fp8_bits`` rounds to
those codes as ``astype(ml_dtypes.float8_e4m3fn)`` does.
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
    "float8_e4m3fn": np.dtype(np.uint8),  # raw codes
}

_NAME_TO_TORCH = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
    "int4": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}

# same-size integer view of each torch dtype, for copies through numpy
_TORCH_TO_NP_VIEW = {
    torch.bfloat16: (torch.int16, np.uint16),
    torch.float32: (torch.float32, np.float32),
    torch.float16: (torch.float16, np.float16),
    torch.int8: (torch.int8, np.int8),
    torch.float8_e4m3fn: (torch.uint8, np.uint8),
}

_FP8 = "float8_e4m3fn"
# the bound past which ml_dtypes (and jnp) round to e4m3fn's NaN: the
# midpoint of its largest value, 448, and the missing next step, 480
FP8_NAN_BOUND = 464.0


def np_dtype(name: str) -> np.dtype:
    return _NAME_TO_NP[name]


def torch_dtype(name: str) -> torch.dtype:
    return _NAME_TO_TORCH[name]


def dtype_name(dt) -> str:
    """Store name of a numpy dtype (``uint16`` reads as ``bfloat16`` bits; a
    ``uint8`` array stays ``uint8``: only a store field says it holds fp8
    codes)."""
    dt = np.dtype(dt)
    for name, cand in _NAME_TO_NP.items():
        if cand == dt and name != _FP8:
            return name
    return dt.name


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """Round to bfloat16 (to nearest, ties to even) and return the bits as
    ``uint16``, as ``astype(ml_dtypes.bfloat16)`` rounds."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def f32_view(a: np.ndarray) -> np.ndarray:
    """``a`` as a writable f32 array in its own memory order (no copy for a
    writable f32 array, strided or not), ready for ``torch.from_numpy``."""
    a = np.asarray(a, dtype=np.float32)
    return a if a.flags.writeable else a.copy(order="K")


def fp8_bits(a: np.ndarray) -> np.ndarray:
    """Round to float8_e4m3fn and return the codes as ``uint8``, as
    ``astype(ml_dtypes.float8_e4m3fn)`` rounds: through f32, to nearest with
    ties to even, subnormals below 2^-6 kept; a magnitude above 464, an
    infinity or a NaN becomes the NaN code of its sign (torch's cast would
    saturate those to 448)."""
    t = torch.from_numpy(f32_view(a))
    codes = t.to(torch.float8_e4m3fn).view(torch.uint8)
    over = ~(t.abs() <= FP8_NAN_BOUND)
    if over.any():
        codes = codes.clone()
        codes[over] = torch.where(torch.signbit(t[over]), 0xFF, 0x7F).to(torch.uint8)
    return codes.numpy()


def fp8_values(codes: np.ndarray) -> np.ndarray:
    """f32 values of ``uint8`` e4m3fn codes (exact); read-only codes (a
    memory-mapped checkpoint) are copied first."""
    a = np.ascontiguousarray(codes, dtype=np.uint8)
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.view(torch.float8_e4m3fn).float().numpy()


def to_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    """CPU tensor of a host field of store dtype ``name`` (bf16 bits viewed
    as ``torch.bfloat16``, fp8 codes as ``torch.float8_e4m3fn``). Shares
    memory with ``a`` when ``a`` is writable; a read-only view (a
    memory-mapped store) is copied first."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    if name in ("bfloat16", _FP8):
        return t.view(_NAME_TO_TORCH[name])
    return t


def host_copy(dst: torch.Tensor, a: np.ndarray, name: str) -> None:
    """Write host field ``a`` (store dtype ``name``) into the CPU tensor
    ``dst``, cast to ``dst``'s dtype. Without a cast the bytes go through
    numpy, which reads a read-only memory map without copying it first."""
    if torch_dtype(name) == dst.dtype:
        tview, nview = _TORCH_TO_NP_VIEW[dst.dtype]
        np.copyto(dst.view(tview).numpy().view(nview), a.view(nview), casting="no")
    else:
        dst.copy_(to_tensor(a, name))
