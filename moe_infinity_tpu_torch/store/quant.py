"""Weight-only quantization for offloaded experts (host side), from
``moe_infinity_tpu/store/quant.py``. ``quantize_rowwise`` runs on CPU
tensors, so torch's intra-op threads share the work; each operation is the
JAX package's numpy one (an f32 division, rounding half to even), so the
bytes are the same.

Symmetric per-output-channel scaling:
  int8:          q = round(w / s), s = rowmax(|w|) / 127
  int4:          q = round(w / s), s = rowmax(|w|) / 7, two values per byte
  float8_e4m3fn: q = w / s,        s = rowmax(|w|) / 448, rounded to e4m3
                 as ``ml_dtypes`` rounds (``utils.dtypes.fp8_bits``); the
                 codes are ``uint8`` bytes

A zero row takes the scale 1.0. Scales are float32 and stored alongside the
quantized tensor in the expert record as '<name>.scale'; the dequantization
is fused into K3 (``ops/gmm.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from moe_infinity_tpu_torch.utils.dtypes import FP8_NAN_BOUND, f32_view, fp8_bits, fp8_values

INT8_MAX = 127.0
INT4_MAX = 7.0
FP8_E4M3_MAX = 448.0


def pack_int4_np(v: np.ndarray) -> np.ndarray:
    """Pack int8 values in [-8, 7] SPLIT-wise along the LAST axis: byte i
    = (v[i+N/2] << 4) | (v[i] & 0xF) - the layout of ``ops.moe.pack_int4``
    and K3."""
    n = v.shape[-1] // 2
    lo = v[..., :n].astype(np.int8) & np.int8(0x0F)
    hi = (v[..., n:].astype(np.int8) << 4).astype(np.int8)
    return (hi | lo).astype(np.int8)


def unpack_int4_np(w8: np.ndarray) -> np.ndarray:
    lo = ((w8.astype(np.int8) << 4) >> 4).astype(np.int8)
    hi = (w8.astype(np.int8) >> 4).astype(np.int8)
    return np.concatenate([lo, hi], axis=-1)


_QMAX = {"int8": INT8_MAX, "int4": INT4_MAX, "float8_e4m3fn": FP8_E4M3_MAX}


def quantize_rowwise(w: np.ndarray, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize a 2-D weight [out, in] row-wise; returns (q, scale[out]).
    ``w`` may be strided (a transposed view): q keeps its memory order where
    the ops do, and a caller's transpose of it is then free."""
    assert w.ndim == 2, w.shape
    if dtype not in _QMAX:
        raise ValueError(f"unsupported quant dtype {dtype}")
    w32 = torch.from_numpy(f32_view(w))
    absmax = w32.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / _QMAX[dtype], 1.0)
    v = w32 / scale[:, None]
    if dtype == "float8_e4m3fn":
        # a row's largest |v| is its absmax / scale (division is monotonic):
        # within e4m3's range torch's cast is fp8_bits, without its scan
        if bool((absmax / scale <= FP8_NAN_BOUND).all()):
            return v.to(torch.float8_e4m3fn).view(torch.uint8).numpy(), scale.numpy()
        return fp8_bits(v.numpy()), scale.numpy()
    lo, hi = (-127, 127) if dtype == "int8" else (-8, 7)
    q = torch.round(v).clamp_(lo, hi).to(torch.int8)
    if dtype == "int4":
        # pack adjacent OUT channels per byte: HF layout is [out, in] and
        # the compute layout transposes to [in, out], where ops.moe expects
        # the packed axis last. Returns q [out//2, in] + scale [out]:
        # pack_int4_np(q.T).T, packed along the out axis in place
        n = q.shape[0] // 2
        q = (q[n:] << 4) | (q[:n] & 0x0F)
    return q.numpy(), scale.numpy()


def dequantize_rowwise(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """f32 ``q * scale`` row-wise; ``uint8`` ``q`` holds e4m3 codes."""
    vals = fp8_values(q) if q.dtype == np.uint8 else q.astype(np.float32)
    return vals * scale[:, None]
