"""GPTQ checkpoints, from ``moe_infinity_tpu/store/gptq.py``: packed 2/4/8-bit
linears are dequantized once at ingest into the store's own dtype, so the
runtime sees ordinary weights.

Format (AutoGPTQ / optimum "gptq" v1, per quantized Linear of [out, in]):
  qweight  int32 [in * bits/32, out]   - ``bits``-bit codes packed along in
  qzeros   int32 [groups, out * bits/32]
  scales   fp16  [groups, out]
  g_idx    int32 [in]                  - group id per input row
v1 stores zero-points offset by -1 (dequant adds 1); ``checkpoint_format:
"gptq_v2"`` stores them directly.

The arithmetic runs as torch ops (on the host for numpy inputs): each
result is an elementwise f32 product, bit-equal to the numpy formula of the
JAX package. ``pack_gptq`` also takes a torch tensor and then packs on its
device (a checkpoint made on the card).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

GPTQ_COMPONENTS = ("qweight", "qzeros", "scales", "g_idx")
_U32 = 0xFFFFFFFF


def _unpack_rows(packed: np.ndarray, bits: int) -> np.ndarray:
    """Unpack along axis 0: int32 [K*bits/32, N] -> uint32 [K, N]."""
    return _codes(_i32(packed), bits, 0).numpy().astype(np.uint32)


def _unpack_cols(packed: np.ndarray, bits: int) -> np.ndarray:
    """Unpack along axis 1: int32 [G, N*bits/32] -> uint32 [G, N]."""
    return _codes(_i32(packed), bits, 1).numpy().astype(np.uint32)


def _tensor(a, dtype) -> torch.Tensor:
    """CPU tensor of ``a`` as ``dtype``; a read-only array (a memory-mapped
    checkpoint) is copied first."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _i32(a) -> torch.Tensor:
    return _tensor(a, np.int32)


def _codes(packed: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """``_unpack_rows`` (axis 0) or ``_unpack_cols`` (axis 1) of an int32
    tensor, as int32. An arithmetic shift fills the high bits with the sign,
    and the mask drops them."""
    per = 32 // bits
    shifts = torch.arange(per, dtype=torch.int32, device=packed.device) * bits
    if axis == 0:
        u = (packed[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
        return u.reshape(-1, packed.shape[1])
    u = (packed[:, :, None] >> shifts[None, None, :]) & ((1 << bits) - 1)
    return u.reshape(packed.shape[0], -1)


def _f32(a) -> torch.Tensor:
    return _tensor(a, np.float32)


def dequant_gptq(
    qweight: np.ndarray,
    qzeros: np.ndarray,
    scales: np.ndarray,
    g_idx: Optional[np.ndarray],
    *,
    bits: int = 4,
    group_size: int = 128,
    v2: bool = False,
) -> np.ndarray:
    """Reconstruct the float weight in torch Linear layout [out, in], f32 (a
    transposed view of an [in, out] buffer)."""
    if bits not in (2, 4, 8):
        raise NotImplementedError(f"GPTQ bits={bits} not supported (2/4/8)")
    w = _codes(_i32(qweight), bits, 0).float()  # [in, out]
    z = _codes(_i32(qzeros), bits, 1)  # [groups, out]
    if not v2:
        z = z + 1
    z, s = z.float(), _f32(scales)
    K, N = w.shape
    gi = np.arange(K) // group_size if g_idx is None else np.asarray(g_idx, np.int64)
    if K % group_size == 0 and np.array_equal(gi, np.arange(K) // group_size):
        # contiguous groups: broadcast each group's row instead of gathering it
        g = w.view(K // group_size, group_size, N)
        g.sub_(z[:, None]).mul_(s[:, None])  # the same f32 ops, in place
    else:
        gi = torch.from_numpy(gi)
        w = s[gi] * (w - z[gi])
    # [out, in] as a transposed view: quantizing it row-wise and transposing
    # the codes back to [in, out] (the ingest's compute layout) copies nothing
    return w.T.numpy()


def _pack(a: torch.Tensor, per: int, bits: int, axis: int) -> torch.Tensor:
    """Pack ``per`` codes (int64, below 2^32) into each uint32 along
    ``axis``, wrapping mod 2^32 as numpy's uint32 shift and sum do, then
    reinterpret as int32."""
    shifts = torch.arange(per, dtype=torch.int64, device=a.device) * bits
    if axis == 0:
        a = a.reshape(-1, per, a.shape[1])
        s = ((a << shifts[None, :, None]) & _U32).sum(dim=1) & _U32
    else:
        a = a.reshape(a.shape[0], -1, per)
        s = ((a << shifts[None, None, :]) & _U32).sum(dim=2) & _U32
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def pack_gptq(weight, *, bits: int = 4, group_size: int = 128) -> Dict[str, object]:
    """Quantize + pack a [out, in] float weight into GPTQ v1 tensors
    (asymmetric per-group min/max quantization), byte-equal to the JAX
    package's numpy version. A numpy weight gives numpy arrays; a torch
    tensor gives tensors on its device, computed there."""
    as_numpy = isinstance(weight, np.ndarray)
    w = _f32(weight) if as_numpy else weight.float()
    out_f, in_f = w.shape
    if in_f % group_size:
        raise ValueError(f"in_features {in_f} not divisible by {group_size}")
    per = 32 // bits
    maxq = (1 << bits) - 1
    wt = w.T  # [in, out]
    groups = in_f // group_size
    g = wt.reshape(groups, group_size, out_f)
    lo, hi = g.amin(dim=1), g.amax(dim=1)  # [groups, out]
    scale = torch.clamp_min((hi - lo) / maxq, 1e-8)
    zero = torch.clamp(torch.round(-lo / scale), 0, maxq).to(torch.int64)
    g_idx = torch.arange(in_f, device=w.device) // group_size
    # the numpy version adds the uint32 zero to the f32 quotient in f64
    q = torch.round((wt / scale[g_idx]).double() + zero[g_idx].double())
    q = torch.clamp(q, 0, maxq).to(torch.int64)  # [in, out]
    out = {
        "qweight": _pack(q, per, bits, 0),
        "qzeros": _pack((zero - 1) & _U32, per, bits, 1),  # v1: zeros offset by -1
        "scales": scale.half(),
        "g_idx": g_idx.to(torch.int32),
    }
    if as_numpy:
        return {k: v.numpy() for k, v in out.items()}
    return out


def gptq_config(config) -> Optional[dict]:
    """Normalized GPTQ quantization config of an HF config, or None when
    the checkpoint is not GPTQ-quantized."""
    qc = getattr(config, "quantization_config", None)
    if qc is None:
        return None
    if not isinstance(qc, dict):
        qc = qc.to_dict() if hasattr(qc, "to_dict") else vars(qc)
    if qc.get("quant_method") != "gptq":
        return None
    return {
        "bits": int(qc.get("bits", 4)),
        "group_size": int(qc.get("group_size", 128)),
        "v2": qc.get("checkpoint_format") == "gptq_v2",
        "sym": bool(qc.get("sym", False)),
    }


class GptqReassembler:
    """Streaming reassembly of GPTQ component tensors into dequantized
    ``.weight`` tensors. Feed (name, np.ndarray) in shard order; emits
    (name, array) pairs: a quantized linear comes out as ``<prefix>.weight``
    (f32) when its last component arrives, other tensors as they come;
    ``flush`` emits the linears without a ``g_idx`` in insertion order."""

    def __init__(self, qcfg: dict):
        self.qcfg = qcfg
        self._partial: Dict[str, Dict[str, np.ndarray]] = {}

    def feed(self, name: str, arr: np.ndarray):
        for comp in GPTQ_COMPONENTS:
            suffix = "." + comp
            if name.endswith(suffix):
                prefix = name[: -len(suffix)]
                parts = self._partial.setdefault(prefix, {})
                parts[comp] = arr
                if all(k in parts for k in GPTQ_COMPONENTS):
                    yield prefix + ".weight", self._emit(prefix)
                return
        yield name, arr

    def _emit(self, prefix: str) -> np.ndarray:
        parts = self._partial.pop(prefix)
        return dequant_gptq(
            parts["qweight"],
            parts["qzeros"],
            parts["scales"],
            parts.get("g_idx"),
            bits=self.qcfg["bits"],
            group_size=self.qcfg["group_size"],
            v2=self.qcfg["v2"],
        )

    def flush(self):
        """Emit any linears whose g_idx never arrived (derived from
        group_size); raise for groups still incomplete."""
        for prefix in list(self._partial):
            parts = self._partial[prefix]
            if all(k in parts for k in ("qweight", "qzeros", "scales")):
                yield prefix + ".weight", self._emit(prefix)
        leftover = {p: sorted(parts) for p, parts in self._partial.items() if parts}
        if leftover:
            raise RuntimeError(f"incomplete GPTQ tensor groups after ingest: {leftover}")
