"""MoE compute ops: routing, int4 packing and the slot-indexed grouped
expert FFN.

Port of ``moe_infinity_tpu/ops/moe.py``. Weight layout ("compute layout"):
gate/up ``[S, D, F]``, down ``[S, F, D]``, or gate and up fused as
``gateup`` ``[S, D, 2F]`` (``fuse_gateup``); a packed int4 array lives under
``"<role>4"`` (``[S, D, F/2]`` int8, split nibbles) with its scale under
``"<role>_scale"`` ``[S, out]``, as do int8 and ``float8_e4m3fn`` arrays
under ``"<role>"``. A per-layer int32 ``expert_to_slot[E]`` maps router
expert ids to weight rows.

Implementations of ``grouped_ffn``:
  * ``"ragged"`` - plain PyTorch: sort by slot, one matmul per routed group
    (reads the group sizes on the host), combine;
  * ``"pallas"`` - the gmm kernel (K3) through ``ops.gmm.gffn_pallas``;
  * ``"gather"`` - plain PyTorch, no sort: each (token, k) row gathers its
    expert's slab and runs a batched matvec (plain XLA in the JAX package;
    as there, the first products round x to the slab's type, fp8 too);
  * ``"dense"`` - plain PyTorch reference: every slot for every token
    through one-hot masks, O(T*S*F*D), for tests and tiny models.

A ``StreamSource`` in place of the weights gathers the routed experts from
the pinned tier inside the step (``ops/stream.py``).

``grouped_ffn_ep`` is the expert-parallel grouped FFN of a mesh
(``parallel/mesh.py``): each rank computes its local experts' share of its
tokens and the ranks sum the shares with one ``all_reduce``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from moe_infinity_tpu_torch.utils.dtypes import FP8_NAN_BOUND


def topk_router(router_logits, k: int, *, pre_softmax: bool = True,
                normalize: bool = False, scaling: float = 1.0):
    """Generic top-k router over ``[T, E]`` logits (promoted to f32).
    Returns (combine_weights [T, k] f32, expert_ids [T, k] int32, probs
    [T, E] f32). pre_softmax: top-k of the softmax probs (Mixtral), else
    softmax over the top-k raw logits; normalize: the k weights sum to 1."""
    logits = router_logits.float()
    probs = torch.softmax(logits, dim=-1)
    if pre_softmax:
        weights, ids = torch.topk(probs, k, dim=-1)
    else:
        top_logits, ids = torch.topk(logits, k, dim=-1)
        weights = torch.softmax(top_logits, dim=-1)
    if normalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    if scaling != 1.0:
        weights = weights * scaling
    return weights, ids.to(torch.int32), probs


def _activate(h_gate, h_up, activation: str):
    if activation == "relu":
        a = torch.relu(h_gate)
    elif activation == "gelu":
        a = F.gelu(h_gate)
    elif activation == "gelu_tanh":
        a = F.gelu(h_gate, approximate="tanh")
    elif activation == "silu":
        a = F.silu(h_gate)
    else:
        raise ValueError(f"unknown activation {activation}")
    return a * h_up if h_up is not None else a


def _dequant(w, scale: Optional[torch.Tensor], dtype):
    """Row-wise dequant: w [..., in, out] x scale [..., out]."""
    if scale is None:
        return w.to(dtype)
    return w.float() * scale[..., None, :].float()


# --------------------------------------------------------------------------
# int4 packing: two signed nibbles per int8 byte, split along the last axis
# (byte i holds channel i low and channel i + N/2 high).
# --------------------------------------------------------------------------

def pack_int4(v: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] [..., N] -> packed int8 [..., N/2]."""
    n = v.shape[-1] // 2
    lo = v[..., :n].to(torch.int8) & 0x0F
    hi = v[..., n:].to(torch.int8) << 4
    return hi | lo


def unpack_int4(w8: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4, sign-extended by arithmetic shifts on int8."""
    lo = (w8 << 4) >> 4
    hi = w8 >> 4
    return torch.cat([lo, hi], dim=-1)


def _unpack4_weights(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """'<role>4' packed entries -> full int8 '<role>' arrays."""
    if not any(k.endswith("4") for k in weights):
        return weights
    return {
        (k[:-1] if k.endswith("4") else k): (unpack_int4(v) if k.endswith("4") else v)
        for k, v in weights.items()
    }


def _split_gateup(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """View a fused 'gateup' [S, D, 2F] dict as separate gate/up (views, no
    copies)."""
    w = dict(weights)
    gu = w.pop("gateup")
    F = gu.shape[-1] // 2
    w["gate"], w["up"] = gu[..., :F], gu[..., F:]
    if "gateup_scale" in w:
        sc = w.pop("gateup_scale")
        w["gate_scale"], w["up_scale"] = sc[..., :F], sc[..., F:]
    return w


def fuse_gateup(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Concatenate gate and up (and their scales) into 'gateup': one grouped
    matmul then serves both projections. Packed int4 fuses by unpack,
    concatenate, repack (split packing is positional), so the fused array's
    low nibbles are the gate columns and its high nibbles the up columns."""
    if "up4" in weights and "gateup4" not in weights:
        w = dict(weights)
        w["gateup4"] = pack_int4(torch.cat(
            [unpack_int4(w.pop("gate4")), unpack_int4(w.pop("up4"))], dim=-1
        ))
    elif "up" in weights and "gateup" not in weights:
        w = dict(weights)
        w["gateup"] = torch.cat([w.pop("gate"), w.pop("up")], dim=-1)
    else:
        return weights
    if "gate_scale" in w:
        w["gateup_scale"] = torch.cat([w.pop("gate_scale"), w.pop("up_scale")], dim=-1)
    return w


def capturable(impl: str) -> bool:
    """Whether ``grouped_ffn`` under ``impl`` can run inside a CUDA graph:
    every impl but "ragged", which reads its group sizes on the host."""
    return impl != "ragged"


def grouped_ffn(
    x: torch.Tensor,  # [T, D]
    expert_ids: torch.Tensor,  # [T, K] int router choices
    combine_weights: torch.Tensor,  # [T, K] f32
    expert_to_slot: torch.Tensor,  # [E] int (identity when resident)
    weights: Dict[str, torch.Tensor],
    activation: str,
    *,
    biases: Optional[Dict[str, torch.Tensor]] = None,
    impl: str = "ragged",
) -> torch.Tensor:
    """Apply the routed expert FFN and combine. Returns [T, D] in x.dtype.
    weights: 'gate' [S, D, F], optional 'up' [S, D, F] (gated, e.g. SiLU
    for Mixtral), or fused 'gateup' [S, D, 2F]; 'down' [S, F, D]; optional
    '<role>_scale' [S, out]. biases (NLLB): 'gate_bias' [S, F], 'down_bias'
    [S, D]. weights may instead be a ``StreamSource`` (``ops/stream.py``):
    the routed experts are gathered from the pinned tier in the step, and
    expert_to_slot is not read."""
    if hasattr(weights, "rec_row"):
        from moe_infinity_tpu_torch.ops.stream import gffn_stream

        return gffn_stream(x, expert_ids, combine_weights, weights, activation,
                           max_unique=weights.max_unique, impl=weights.impl or impl)
    # a -1 slot (non-resident expert) contributes zero, never a stale slot
    expert_ids = expert_ids.long()
    invalid = expert_to_slot[expert_ids] < 0
    combine_weights = torch.where(invalid, 0.0, combine_weights.float())
    expert_to_slot = expert_to_slot.clamp(min=0)
    if impl == "ragged":
        return _gffn_ragged(
            x, expert_ids, combine_weights, expert_to_slot,
            _unpack4_weights(weights), activation, biases,
        )
    if impl == "pallas":
        from moe_infinity_tpu_torch.ops.gmm import gffn_pallas

        return gffn_pallas(
            x, expert_ids, combine_weights, expert_to_slot, weights,
            activation, biases,
        )
    if impl == "gather":
        return _gffn_gather(
            x, expert_ids, combine_weights, expert_to_slot, weights,
            activation, biases,
        )
    if impl == "dense":
        return _gffn_dense(
            x, expert_ids, combine_weights, expert_to_slot,
            _unpack4_weights(weights), activation, biases,
        )
    raise ValueError(f"unknown grouped_ffn impl {impl!r}")


def _as_operand(x, dtype):
    """x cast to a weight's type as the JAX package casts it: f32 values
    rounded to float8_e4m3fn for fp8 (NaN past 464, as ``jnp``'s cast),
    else ``x.to(dtype)``."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    x32 = x.float()
    q = x32.to(torch.float8_e4m3fn).float()  # torch's cast saturates past 448
    return torch.where(x32.abs() <= FP8_NAN_BOUND, q, torch.nan)


def _row_dot(x, w):
    """Per-row ``x[t] @ w[t]`` with exact products of the operands and f32
    sums (einsum with preferred f32 in the JAX package)."""
    return torch.einsum("td,tdf->tf", x.float(), w.float())


def _gffn_gather(x, expert_ids, combine_weights, expert_to_slot, weights,
                 activation, biases):
    """Decode-path grouped FFN as gather + batched matvec: each (token, k)
    row gathers its expert's slab; combine is a weighted sum over k. int8 and
    packed int4 slabs become bf16 (exact), and x is rounded to the slab's
    type (bf16, f32 or fp8), as in the JAX package."""
    T, D = x.shape
    K = expert_ids.shape[1]
    compute_dtype = x.dtype
    rows = expert_to_slot[expert_ids].reshape(-1).long()  # [T*K]
    x_rep = x.repeat_interleave(K, dim=0)  # [TK, D]

    def dq(role):
        if role + "4" in weights:  # packed int4: gather bytes, then unpack
            return unpack_int4(weights[role + "4"][rows]).to(torch.bfloat16)
        w = weights[role][rows]
        return w.to(torch.bfloat16) if w.dtype == torch.int8 else w

    def scaled(h, role):
        sc = weights.get(role + "_scale")
        return h if sc is None else h * sc[rows]

    if "gateup" in weights or "gateup4" in weights:
        wgu = dq("gateup")
        xb = _as_operand(x_rep, wgu.dtype)
        hcat = scaled(_row_dot(xb, wgu), "gateup")
        F = hcat.shape[-1] // 2
        h = _activate(hcat[:, :F], hcat[:, F:], activation)
    else:
        wg = dq("gate")
        xb = _as_operand(x_rep, wg.dtype)
        h = scaled(_row_dot(xb, wg), "gate")
        if biases is not None and "gate_bias" in biases:
            h = h + biases["gate_bias"][rows]
        hu = None
        if "up" in weights or "up4" in weights:
            hu = scaled(_row_dot(xb, dq("up")), "up")
        h = _activate(h, hu, activation)
    out = scaled(_row_dot(h.to(compute_dtype), dq("down")), "down")
    if biases is not None and "down_bias" in biases:
        out = out + biases["down_bias"][rows]
    out = out * combine_weights.reshape(-1).float()[:, None]
    return out.reshape(T, K, D).sum(dim=1).to(compute_dtype)


def _gffn_dense(x, expert_ids, combine_weights, expert_to_slot, weights,
                activation, biases):
    """Reference implementation: every slot for every token, mixed by the
    per-token per-slot combine weight."""
    if "gateup" in weights:
        weights = _split_gateup(weights)
    S = weights["gate"].shape[0]
    compute_dtype = x.dtype
    slot_ids = expert_to_slot[expert_ids].long()  # [T, K]
    onehot = F.one_hot(slot_ids, S).float()  # [T, K, S]
    mix = torch.einsum("tk,tks->ts", combine_weights.float(), onehot)
    x32 = x.float()

    def w32(role):
        return _dequant(weights[role], weights.get(role + "_scale"), compute_dtype).float()

    h = torch.einsum("td,sdf->tsf", x32, w32("gate"))
    if biases is not None and "gate_bias" in biases:
        h = h + biases["gate_bias"][None]
    h_up = torch.einsum("td,sdf->tsf", x32, w32("up")) if "up" in weights else None
    h = _activate(h, h_up, activation)
    out = torch.einsum("tsf,sfd->tsd", h, w32("down"))
    if biases is not None and "down_bias" in biases:
        out = out + biases["down_bias"][None]
    return torch.einsum("tsd,ts->td", out, mix).to(compute_dtype)


def _ragged_dot(xs, w, scale, sizes, dtype):
    """Per-group ``xs_g @ dequant(w[g])`` with operands in ``dtype`` and f32
    sums (jax.lax.ragged_dot with preferred f32). Dequantizes only the
    routed groups."""
    out = torch.zeros(xs.shape[0], w.shape[-1], dtype=torch.float32, device=xs.device)
    start = 0
    for g, n in enumerate(sizes.tolist()):
        if n:
            wg = _dequant(w[g], None if scale is None else scale[g], dtype)
            out[start:start + n] = xs[start:start + n].float() @ wg.to(dtype).float()
        start += n
    return out


def _gffn_ragged(x, expert_ids, combine_weights, expert_to_slot, weights,
                 activation, biases):
    T, D = x.shape
    K = expert_ids.shape[1]
    S = weights["gateup" if "gateup" in weights else "gate"].shape[0]
    compute_dtype = x.dtype

    flat_slots = expert_to_slot[expert_ids].reshape(-1).long()
    order = torch.argsort(flat_slots, stable=True)
    inv_token = order // K
    xs = x[inv_token]
    sorted_slots = flat_slots[order]
    sizes = torch.bincount(flat_slots, minlength=S)

    def dot(role, xin):
        return _ragged_dot(xin, weights[role], weights.get(role + "_scale"),
                           sizes, compute_dtype)

    if "gateup" in weights:
        hcat = dot("gateup", xs)
        F = hcat.shape[-1] // 2
        h = _activate(hcat[:, :F], hcat[:, F:], activation)
    else:
        h = dot("gate", xs)
        if biases is not None and "gate_bias" in biases:
            h = h + biases["gate_bias"][sorted_slots]
        h = _activate(h, dot("up", xs) if "up" in weights else None, activation)
    out = dot("down", h.to(compute_dtype))
    if biases is not None and "down_bias" in biases:
        out = out + biases["down_bias"][sorted_slots]
    out = out * combine_weights.reshape(-1)[order][:, None]
    combined = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    combined.index_add_(0, inv_token, out)
    return combined.to(compute_dtype)


def _num_slots(weights: Dict[str, torch.Tensor]) -> int:
    for k in ("gateup", "gateup4", "gate", "gate4"):
        if k in weights:
            return weights[k].shape[0]
    raise KeyError("weight dict has no gate/gateup entry")


def grouped_ffn_ep(
    x: torch.Tensor,  # [T, D] this rank's tokens (its data shard)
    expert_ids: torch.Tensor,  # [T, K]
    combine_weights: torch.Tensor,  # [T, K]
    expert_to_slot: torch.Tensor,  # [E] global slot ids, or [dp, E] one row per data rank
    weights: Dict[str, torch.Tensor],  # this rank's slots (``parallel.shard_params``)
    activation: str,
    *,
    mesh,
    biases: Optional[Dict[str, torch.Tensor]] = None,
    expert_axis: str = "expert",
    data_axis: str = "data",
    model_axis: str = "model",
    impl: str = "ragged",
) -> torch.Tensor:
    """Expert-parallel grouped FFN, JAX ``ops/moe.py::grouped_ffn_ep``: this
    rank computes its local experts' contribution to its tokens (through
    K3 for ``impl="pallas"`` on the card, on the unsharded layer's grid), a
    route to a remote expert taking weight 0, and the ranks of the expert axis sum the contributions with
    one ``all_reduce``: the sum is the combine, and no token all-to-all is
    needed. Rank c of the expert axis holds global slots
    ``[c * S, (c + 1) * S)`` of its ``S`` local ones.

    A 2-D ``expert_to_slot`` ([dp, E]) is the joint DP x EP mode: the slot
    stack is sharded over both axes, data-major (global slot
    ``(d * ep + c) * S + s`` on coordinate (d, c)), and each data rank reads
    its own row. Under a model axis above 1 the weights hold a d_ff slice
    (``common/arch.py::TP_MODEL_DIMS``) and the sum runs over the model axis
    too; ``down_bias`` is added on model coordinate 0 only. Returns this
    rank's [T, D] in x's dtype."""
    joint = expert_to_slot.dim() == 2
    ep, tp = mesh.shape[expert_axis], mesh.shape[model_axis]
    shard = mesh.axis_index(expert_axis)
    slot_map = expert_to_slot
    if joint:
        d = mesh.axis_index(data_axis)
        shard = d * ep + shard
        slot_map = expert_to_slot[d]
    s_local = _num_slots(weights)
    # every expert keeps its entry (-1 where remote: grouped_ffn gives such a
    # route weight 0), so K3 launches the unsharded layer's grid and split
    # plan, and a routed row sums its reduction in the unsharded order
    local = slot_map.long() - shard * s_local
    local = torch.where((local >= 0) & (local < s_local), local, -1).to(torch.int32)
    if tp > 1 and biases is not None and "down_bias" in biases and mesh.axis_index(model_axis):
        biases = {k: (torch.zeros_like(v) if k == "down_bias" else v) for k, v in biases.items()}
    out = grouped_ffn(x, expert_ids, combine_weights, local, weights, activation,
                      biases=biases, impl=impl)
    return mesh.all_reduce(out, expert_axis, model_axis)


def routed_ffn(mesh, x, expert_ids, combine_weights, expert_to_slot, weights, activation, *,
               biases=None, impl: str = "ragged") -> torch.Tensor:
    """A model's routed experts: ``grouped_ffn_ep`` under a mesh whose expert
    or model axis is above 1 (the experts then hold a slice of the slots or
    of d_ff, ``parallel.expert_shardings``), else ``grouped_ffn``."""
    if mesh is not None and (mesh.shape["expert"] > 1 or mesh.shape["model"] > 1):
        return grouped_ffn_ep(x, expert_ids, combine_weights, expert_to_slot, weights,
                              activation, mesh=mesh, biases=biases, impl=impl)
    return grouped_ffn(x, expert_ids, combine_weights, expert_to_slot, weights, activation,
                       biases=biases, impl=impl)
