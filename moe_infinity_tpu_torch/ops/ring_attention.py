"""Ring attention: sequence-parallel attention over a mesh axis, from
``moe_infinity_tpu/ops/ring_attention.py``.

Each rank of the ``seq`` axis holds one contiguous time block of the
queries, keys and values ([B, T/s, H, Dh]). ``ring_attention`` runs s
block-steps: every rank attends its queries to the K/V block it holds,
accumulates with the online softmax (running max, rescaled numerator and
denominator, all in f32), then passes the block one hop around the ring
(``Mesh.ring_hop``: rank i to rank i + 1). The un-repeated K/V rides the
ring; GQA heads are repeated inside each block step. Scores never exceed one
[B, H, T/s, T/s] f32 block a step, so activation memory scales 1/s with the
ring.

``sp_decode_attention`` is the decode counterpart: the prompt's K/V stays
sharded and frozen, each rank computes the flash partial over its shard, the
partials merge with a max over the ranks and one sum of the rescaled
numerators and denominators (O(B·H·Dv) bytes, whatever the context), and a
replicated tail of generated tokens folds in after them. No K/V moves.

The block body is plain PyTorch einsums, as the JAX package's is plain XLA
(no Pallas kernel is reached): on the card the einsums run through cuBLAS.
K2 (``flash_attend``) returns no log-sum-exp, so its output cannot merge
across blocks.
"""

from __future__ import annotations

from typing import Optional

import torch

# parallel.mesh.SEQ (not imported: the parallel package imports this module)
SEQ = "seq"
_NEG = torch.finfo(torch.float32).min


def _repeat_heads(t, rep: int):
    return t if rep == 1 else t.repeat_interleave(rep, dim=2)


def ring_attention(
    q: torch.Tensor,  # [B, Tl, H, Dh] this rank's query block (rope applied)
    k: torch.Tensor,  # [B, Tl, Hkv, Dh] this rank's key block (rope applied)
    v: torch.Tensor,  # [B, Tl, Hkv, Dv] this rank's value block
    mesh,
    *,
    axis: str = SEQ,
    causal: bool = True,
    scale: Optional[float] = None,
    bias_fn=None,  # (q_pos [Tq], k_pos [Tk]) -> additive [.., H, Tq, Tk]
    logit_softcap: Optional[float] = None,  # tanh cap (Grok)
) -> torch.Tensor:
    """Blockwise ring attention of this rank's time block over ``axis`` of
    ``mesh`` (every rank of the axis calls it at once). GQA by repeating the
    KV heads; the value dim may differ from the key dim (MLA latents).
    ``bias_fn`` takes GLOBAL positions (T5 relative bias). Returns
    [B, Tl, H, Dv] in q's dtype."""
    B, Tl, H, Dh = q.shape
    Dv = v.shape[-1]
    n = mesh.shape[axis]
    if scale is None:
        scale = Dh ** -0.5
    rep = H // k.shape[2]
    qf = q.float() * scale
    idx = mesh.axis_index(axis)
    local = torch.arange(Tl, dtype=torch.int32, device=q.device)
    q_pos = idx * Tl + local  # [Tl] global

    num = torch.zeros(B, H, Tl, Dv, dtype=torch.float32, device=q.device)
    den = torch.zeros(B, H, Tl, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tl), float("-inf"), dtype=torch.float32, device=q.device)
    cur_k, cur_v = k, v
    for t in range(n):
        # after t hops this rank holds the block of rank (idx - t) mod n
        src = (idx - t) % n
        logits = torch.einsum("bthd,bshd->bhts", qf, _repeat_heads(cur_k, rep).float())
        if logit_softcap is not None:
            logits = torch.tanh(logits / logit_softcap) * logit_softcap
        k_pos = src * Tl + local
        if bias_fn is not None:
            logits = logits + bias_fn(q_pos, k_pos).float()
        if causal:
            valid = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
            logits = torch.where(valid, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        p = torch.exp(logits - safe_m[..., None])
        p = torch.where(torch.isfinite(logits), p, 0.0)  # masked block rows
        num = num * corr[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p, _repeat_heads(cur_v, rep).float())
        den = den * corr + p.sum(dim=-1)
        m = m_new
        del logits, p
        if t < n - 1:
            cur_k = mesh.ring_hop(cur_k, axis)
            cur_v = mesh.ring_hop(cur_v, axis)
    out = num / torch.clamp(den, min=1e-30)[..., None]  # [B, H, Tl, Dv]
    return out.transpose(1, 2).to(q.dtype)


def _flash_partial(qf, k, v, valid, softcap):
    """Online-softmax partial over one K/V block. qf [B, H, Tq, Dh] f32
    pre-scaled; k/v [B, S, Hkv, D*]; valid optional [S] bool. Returns
    (m [B, H, Tq], num [B, H, Tq, Dv], den [B, H, Tq]): a mergeable triple."""
    rep = qf.shape[1] // k.shape[2]
    logits = torch.einsum("bhtd,bshd->bhts", qf, _repeat_heads(k, rep).float())
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    if valid is not None:
        logits = torch.where(valid[None, None, None, :], logits, _NEG)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    p = torch.where(logits > _NEG / 2, p, 0.0)  # zero masked columns
    num = torch.einsum("bhts,bshd->bhtd", p, _repeat_heads(v, rep).float())
    return m, num, p.sum(dim=-1)


def sp_decode_attention(
    q: torch.Tensor,  # [B, 1, H, Dh] replicated query (rope applied)
    k_shard: torch.Tensor,  # [B, Ts, Hkv, Dh] this rank's frozen prefill shard
    v_shard: torch.Tensor,  # [B, Ts, Hkv, Dv]
    tail_k: torch.Tensor,  # [B, C, Hkv, Dh] replicated decode tail
    tail_v: torch.Tensor,  # [B, C, Hkv, Dv]
    tail_len,  # int or 0-d tensor: the tail's valid columns
    mesh,
    *,
    axis: str = SEQ,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Flash decoding over a sequence-sharded cache: each rank's partial
    over its own shard, merged over ``axis`` with an ``all_reduce`` max of
    the running max and one ``all_reduce`` sum of the rescaled numerator and
    denominator (packed in one buffer), then the tail's partial (the same
    on every rank) folded in. Returns [B, 1, H, Dv], the same on every
    rank."""
    B, Tq, H, Dh = q.shape
    if scale is None:
        scale = Dh ** -0.5
    qf = (q.float() * scale).transpose(1, 2)  # [B, H, Tq, Dh]
    m_s, n_s, d_s = _flash_partial(qf, k_shard, v_shard, None, logit_softcap)
    tvalid = torch.arange(tail_k.shape[1], device=q.device) < tail_len
    m_t, n_t, d_t = _flash_partial(qf, tail_k, tail_v, tvalid, logit_softcap)
    m_g = torch.maximum(mesh.all_reduce(m_s.clone(), axis, op="max"), m_t)
    c_s = torch.exp(m_s - m_g)
    c_t = torch.exp(m_t - m_g)  # 0 when the tail is empty (m_t = _NEG)
    part = mesh.all_reduce(torch.cat([n_s * c_s[..., None], (d_s * c_s)[..., None]], dim=-1),
                           axis)
    num = part[..., :-1] + n_t * c_t[..., None]
    den = part[..., -1] + d_t * c_t
    out = num / torch.clamp(den, min=1e-30)[..., None]  # [B, H, Tq, Dv]
    return out.transpose(1, 2).to(q.dtype)


def ring_attend(
    q: torch.Tensor,  # [B, T, H, Dh] whole (every rank passes the same)
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    seq_axis: str = SEQ,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Standalone entry: this rank's time block of q/k/v through the ring,
    and the blocks gathered again, so every rank returns the whole
    [B, T, H, Dv] output. ``sp_prefill`` calls ``ring_attention`` on its
    blocks directly."""
    s = mesh.shape[seq_axis]
    T = q.shape[1]
    if T % s:
        raise ValueError(f"T={T} not divisible by seq={s}")
    Tl = T // s
    lo = mesh.axis_index(seq_axis) * Tl
    out = ring_attention(q[:, lo:lo + Tl], k[:, lo:lo + Tl], v[:, lo:lo + Tl], mesh,
                         axis=seq_axis, causal=causal, scale=scale)
    return mesh.gather_rows(out.transpose(0, 1), lo, T, seq_axis).transpose(0, 1).contiguous()
