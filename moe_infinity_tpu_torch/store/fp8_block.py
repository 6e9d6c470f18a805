"""DeepSeek-V3's official block-scaled fp8 checkpoints, from
``moe_infinity_tpu/store/fp8_block.py``.

The official release stores every quantized Linear as
  <prefix>.weight            float8_e4m3fn [out, in]
  <prefix>.weight_scale_inv  float32 [ceil(out/B0), ceil(in/B1)]
with ``quantization_config = {"quant_method": "fp8", "weight_block_size":
[B0, B1]}`` (B0 = B1 = 128). Ingest dequantizes them into the store's own
dtype (bf16, row-wise int8/int4 or per-channel fp8), so every path
downstream works unchanged.

fp8 codes travel as ``uint8`` (``utils/dtypes.py``): ``pack_fp8_block``
rounds with ``fp8_bits``, whose codes equal ``ml_dtypes``'. The
arithmetic runs as torch ops; a torch tensor given to ``pack_fp8_block``
is packed on its device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from moe_infinity_tpu_torch.store.gptq import _tensor
from moe_infinity_tpu_torch.utils.dtypes import FP8_NAN_BOUND, fp8_bits

FP8_E4M3_MAX = 448.0


def fp8_block_config(config) -> Optional[dict]:
    """Normalized fp8 block-quant config of an HF config, else None."""
    qc = getattr(config, "quantization_config", None)
    if qc is None:
        return None
    if not isinstance(qc, dict):
        qc = qc.to_dict() if hasattr(qc, "to_dict") else vars(qc)
    if qc.get("quant_method") != "fp8":
        return None
    b = qc.get("weight_block_size") or [128, 128]
    return {"block": (int(b[0]), int(b[1]))}


def _expand(scale: torch.Tensor, shape, block) -> torch.Tensor:
    """[ceil(O/B0), ceil(I/B1)] block scales repeated to [O, I] (ragged
    edge blocks cut)."""
    O, I = shape
    b0, b1 = block
    return scale.repeat_interleave(b0, dim=0)[:O].repeat_interleave(b1, dim=1)[:, :I]


def dequant_fp8_block(weight: np.ndarray, scale_inv: np.ndarray, block: tuple = (128, 128)
                      ) -> np.ndarray:
    """W[o, i] = fp8(w)[o, i] * scale_inv[o // B0, i // B1], in f32. ``weight``
    holds e4m3 codes as ``uint8``, or float values; ``scale_inv`` f32."""
    if weight.dtype == np.uint8:
        w = _tensor(weight, np.uint8).view(torch.float8_e4m3fn).float()
    else:
        w = _tensor(weight, np.float32)
    s = _tensor(scale_inv, np.float32)
    (O, I), (b0, b1) = w.shape, block
    if O % b0 == 0 and I % b1 == 0:  # whole blocks: broadcast each block's scale
        return (w.view(O // b0, b0, I // b1, b1) * s[:, None, :, None]).view(O, I).numpy()
    return (w * _expand(s, w.shape, block)).numpy()


def pack_fp8_block(weight, block: tuple = (128, 128)):
    """Quantize a [out, in] float weight into the official DeepSeek-V3
    layout: (e4m3 codes as uint8, scale_inv [ceil(out/B0), ceil(in/B1)] f32),
    per-block absmax scaling to the e4m3 range. A numpy weight gives numpy
    arrays, a torch tensor tensors on its device."""
    as_numpy = isinstance(weight, np.ndarray)
    w = _tensor(weight, np.float32) if as_numpy else weight.float()
    O, I = w.shape
    b0, b1 = block
    n0, n1 = -(-O // b0), -(-I // b1)
    padded = torch.zeros(n0 * b0, n1 * b1, dtype=torch.float32, device=w.device)
    padded[:O, :I] = w
    absmax = padded.reshape(n0, b0, n1, b1).abs().amax(dim=(1, 3))  # [n0, n1]
    scale = torch.clamp_min(absmax / FP8_E4M3_MAX, 1e-12)
    v = (padded / _expand(scale, padded.shape, block))[:O, :I]
    if as_numpy:
        return fp8_bits(v.numpy()), scale.numpy()
    if not bool((v.abs() <= FP8_NAN_BOUND).all()):  # where torch's cast and ml_dtypes part
        raise ValueError("pack_fp8_block: a scaled value past the e4m3 range")
    return v.to(torch.float8_e4m3fn).view(torch.uint8), scale


class Fp8BlockReassembler:
    """Streaming pairing of (weight, weight_scale_inv): emits plain f32
    ``.weight`` tensors once both halves of a quantized linear arrive;
    unquantized tensors pass through."""

    SCALE_SUFFIX = ".weight_scale_inv"

    def __init__(self, qcfg: dict):
        self.block = qcfg["block"]
        self._weights: Dict[str, np.ndarray] = {}
        self._scales: Dict[str, np.ndarray] = {}

    def feed(self, name: str, arr: np.ndarray, is_fp8: bool):
        if name.endswith(self.SCALE_SUFFIX):
            prefix = name[: -len(self.SCALE_SUFFIX)]
            self._scales[prefix] = arr
            if prefix in self._weights:
                yield prefix + ".weight", self._emit(prefix)
            return
        if name.endswith(".weight") and is_fp8:
            prefix = name[: -len(".weight")]
            self._weights[prefix] = arr
            if prefix in self._scales:
                yield prefix + ".weight", self._emit(prefix)
            return
        yield name, arr

    def _emit(self, prefix: str) -> np.ndarray:
        return dequant_fp8_block(self._weights.pop(prefix), self._scales.pop(prefix), self.block)

    def flush(self):
        if self._weights or self._scales:
            raise RuntimeError(
                "unpaired FP8 tensors after ingest: "
                f"weights={sorted(self._weights)} scales={sorted(self._scales)}"
            )
        return iter(())
