"""Weight-only quantization for offloaded experts (host side, numpy), from
``moe_infinity_tpu/store/quant.py``.

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

from moe_infinity_tpu_torch.utils.dtypes import fp8_bits, fp8_values

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


def quantize_rowwise(w: np.ndarray, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize a 2-D weight [out, in] row-wise; returns (q, scale[out])."""
    assert w.ndim == 2, w.shape
    w32 = w.astype(np.float32)
    absmax = np.abs(w32).max(axis=1)
    if dtype == "int8":
        scale = np.where(absmax > 0, absmax / INT8_MAX, 1.0).astype(np.float32)
        q = np.clip(np.rint(w32 / scale[:, None]), -127, 127).astype(np.int8)
    elif dtype == "int4":
        # pack adjacent OUT channels per byte: HF layout is [out, in] and
        # the compute layout transposes to [in, out], where ops.moe expects
        # the packed axis last. Returns q [out//2, in] + scale [out].
        scale = np.where(absmax > 0, absmax / INT4_MAX, 1.0).astype(np.float32)
        q = np.clip(np.rint(w32 / scale[:, None]), -8, 7).astype(np.int8)
        q = pack_int4_np(q.T).T
    elif dtype == "float8_e4m3fn":
        scale = np.where(absmax > 0, absmax / FP8_E4M3_MAX, 1.0).astype(np.float32)
        q = fp8_bits(w32 / scale[:, None])
    else:
        raise ValueError(f"unsupported quant dtype {dtype}")
    return q, scale


def dequantize_rowwise(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """f32 ``q * scale`` row-wise; ``uint8`` ``q`` holds e4m3 codes."""
    vals = fp8_values(q) if q.dtype == np.uint8 else q.astype(np.float32)
    return vals * scale[:, None]
