"""Run-on-host expert execution, from ``moe_infinity_tpu/runtime/host_exec.py``.

When the engine cannot make a routed expert resident within a deadline
(``host_fallback_timeout``), it points that expert's slot row at the
arena's reserved zero slot, so the grouped FFN contributes exactly 0 for
its (token, k) pairs (every expert FFN maps zero weights and biases to a
zero output), and the true contribution is computed here, on the host, from
the store record, and added to the layer output. A miss then costs a small
host GEMM over the expert's routed tokens instead of a blocking fetch.

The host math is PyTorch on CPU tensors at f32 over the dequantized record,
in the JAX order: gate (+ ``fc1.bias``), the activation (gelu in its tanh
form, as the JAX executor computes it), times up where there is one, down
(+ ``fc2.bias``); then ``index_add_`` of ``cw * y`` at the routed rows.

int8 and split-nibble int4 records are dequantized by their per-channel
scale as the JAX ``_weight`` does. An ``float8_e4m3fn`` store is refused:
the JAX executor applies ``.scale`` to int8 codes only, so it would multiply
raw e4m3 codes without their scale, which is not the device's expert
function (ROADMAP queue 3, "These are not faults").
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from moe_infinity_tpu_torch.ops.moe import unpack_int4
from moe_infinity_tpu_torch.runtime.providers import role_map_for
from moe_infinity_tpu_torch.utils.dtypes import to_tensor

# the expert FFN's nonlinearity per arch (a Switch store may override it
# through meta["activation"])
_ARCH_ACT = {
    "switch": "relu",
    "nllb": "relu",
    "mixtral": "silu",
    "arctic": "silu",
    "grok": "gelu",
    "deepseek": "silu",
    "deepseek_v3": "silu",
}

_GELU_C = math.sqrt(2.0 / math.pi)


def activation_for(store_meta: dict) -> str:
    return store_meta.get("activation") or _ARCH_ACT[store_meta["arch"]]


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.clamp_min(x, 0.0)
    if name == "silu":
        return x / (1.0 + torch.exp(-x))
    if name in ("gelu", "gelu_tanh"):
        # the tanh form, as the JAX executor (and jax.nn.gelu) computes it
        return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * x ** 3)))
    raise ValueError(f"unknown activation {name!r}")


class HostExpertExecutor:
    """Computes one expert's FFN on the host from its store record."""

    def __init__(self, store, activation: str):
        self._dtype = {f.name: f.dtype for f in store.fields}
        if "float8_e4m3fn" in self._dtype.values():
            raise ValueError(
                "host fallback over a float8_e4m3fn store: the JAX executor multiplies the "
                "raw e4m3 codes without their per-channel scale, which is not the device's "
                "expert function (ROADMAP queue 3)")
        self.store = store
        self.activation = activation
        roles = role_map_for(store.meta)
        self.gate_tail = roles["gate_or_in"]
        self.up_tail = roles.get("up")
        self.down_tail = roles.get("down")
        if not (self.gate_tail and self.down_tail):
            raise ValueError(f"store roles {roles} lack a gate or a down projection")
        self.gate_bias = "fc1.bias" if "fc1.bias" in self._dtype else None
        self.down_bias = "fc2.bias" if "fc2.bias" in self._dtype else None

    def _f32(self, record: Dict[str, np.ndarray], name: str) -> torch.Tensor:
        return to_tensor(record[name], self._dtype[name]).float()

    def _weight(self, record: Dict[str, np.ndarray], tail: str) -> torch.Tensor:
        """The [in, out] weight at f32: int8 and packed int4 codes times
        their per-channel scale."""
        w = record[tail]
        if w.dtype == np.int8 and (tail + ".scale") in record:
            scale = self._f32(record, tail + ".scale")
            codes = torch.from_numpy(np.array(w))
            if w.shape[-1] * 2 == scale.shape[0]:  # packed int4
                codes = unpack_int4(codes)
            return codes.float() * scale[None, :]
        return self._f32(record, tail)

    def ffn(self, layer: int, expert: int, x: torch.Tensor) -> torch.Tensor:
        """x [n, D] f32 -> [n, D] f32: the expert's FFN output before the
        combine weights."""
        record = self.store.get_expert(layer, expert, prio=0, gen=0)
        g = x @ self._weight(record, self.gate_tail)  # [n, F]
        if self.gate_bias:
            g = g + self._f32(record, self.gate_bias)[None, :]
        h = _act(self.activation, g)
        if self.up_tail is not None:
            h = h * (x @ self._weight(record, self.up_tail))
        y = h @ self._weight(record, self.down_tail)  # [n, D]
        if self.down_bias:
            y = y + self._f32(record, self.down_bias)[None, :]
        return y


def host_moe_delta(
    executor: HostExpertExecutor,
    mli: int,
    missing: Sequence[Tuple[int, int]],  # [(mli, expert)]
    h: torch.Tensor,  # [B, T, D] the pre-FFN hidden, on the host
    cw: torch.Tensor,  # [B, T, K] combine weights, on the host
    ids: np.ndarray,  # [B, T, K] routed expert ids
) -> torch.Tensor:
    """The layer output's correction for the experts that ran as the zero
    slot: the sum over them of cw * FFN_e(h) at their routed positions,
    [B, T, D] f32 on the host."""
    B, T, D = h.shape
    h2 = h.float().reshape(B * T, D)
    cw2 = cw.float().reshape(B * T, -1)
    ids2 = np.asarray(ids).reshape(B * T, -1)
    delta = torch.zeros(B * T, D, dtype=torch.float32)
    for _, e in missing:
        rows, ks = np.nonzero(ids2 == e)
        if rows.size == 0:
            continue
        rows_t = torch.from_numpy(rows)
        y = executor.ffn(mli, int(e), h2[rows_t])
        delta.index_add_(0, rows_t, y * cw2[rows_t, torch.from_numpy(ks)][:, None])
    return delta.reshape(B, T, D)
