"""Shared transformer building blocks of the port (plain functions on
tensors), from ``moe_infinity_tpu/models/layers.py``.

Dense weights keep the HF ``[out, in]`` layout. Activations are batch-first
``[B, T, D]``. ``attend`` sends every call to the attention kernels: K1
(``flash_decode``) for one query token without a bias, K2 (``flash_attend``)
otherwise; ``attend_cache`` sends a one-token causal step over a paged cache
to K4 (``paged_flash_decode``), which reads the pool's pages in place, and
everything else to ``attend`` on the gathered view. On CUDA tensors the
kernels launch, on CPU tensors their plain versions run.
``set_attention_impl("naive")`` selects the einsum oracle
``attend_reference`` instead (for f32 parity tests).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from moe_infinity_tpu_torch.ops import flash_attention as fa


def rms_norm(x, weight, eps: float):
    """LLaMA-style RMSNorm: normalise in f32, scale, cast back."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias: Optional[torch.Tensor], eps: float):
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def linear(x, w, b: Optional[torch.Tensor] = None):
    """x [..., in] @ w[out, in] (HF layout) -> [..., out]. A plain matmul,
    as the JAX package leaves the dense projections to XLA."""
    y = torch.matmul(x, w.to(x.dtype).t())
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# --------------------------------------------------------------------------
# Rotary position embeddings (f32, as the JAX package computes them)
# --------------------------------------------------------------------------

def rope_cos_sin(positions, dim: int, base: float = 10000.0, *,
                 scaling_factor: float = 1.0):
    """Default (llama/neox) RoPE tables: cos/sin [B, T, dim] f32, the
    half-duplicated ``cat(freqs, freqs)`` convention."""
    inv_freq = 1.0 / (
        base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    )
    freqs = (positions.float() / scaling_factor)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q [B, T, H, Dh], k [B, T, Hkv, Dh], cos/sin [B, T, Dh]; rotated in
    f32 and cast back."""
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    q32, k32 = q.float(), k.float()
    q_out = q32 * cos + _rotate_half(q32) * sin
    k_out = k32 * cos + _rotate_half(k32) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def random_expert_layer(E: int, D: int, F: int, expert_dtype: str,
                        generator: torch.Generator, device) -> dict:
    """One MoE layer's random gated experts ``gate``/``up`` ``[E, D, F]`` and
    ``down`` ``[E, F, D]`` on ``device`` (where ``generator`` must live):
    ``"bf16"`` normal, std 0.02; ``"int8"`` values in [-127, 127) with
    per-channel f32 scales in [1e-3, 2e-3) under '<role>_scale' (the JAX
    bench's resident int8 arenas); ``"int4"`` split-nibble packed '<role>4'
    with scales in [3e-3, 5.6e-3); ``"fp8"`` float8_e4m3fn codes of normal
    values of std 64 clamped to e4m3's 448 (7 sigma) with scales in
    [2.5e-4, 3.75e-4), so weights of std about 0.02, drawn one expert at a
    time (an f32 draw of a whole Grok-1 role would take 6.4 GB)."""
    from moe_infinity_tpu_torch.ops.moe import pack_int4

    if expert_dtype not in ("bf16", "int8", "int4", "fp8"):
        raise ValueError(f"expert_dtype {expert_dtype!r}: bf16, int8, int4 or fp8")
    g = generator

    def scale(n, lo, hi):
        return torch.empty((E, n), dtype=torch.float32, device=device).uniform_(
            lo, hi, generator=g)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, dtype=torch.int8, device=device, generator=g)

    w = {}
    for role, shape in (("gate", (E, D, F)), ("up", (E, D, F)), ("down", (E, F, D))):
        if expert_dtype == "bf16":
            w[role] = torch.empty(shape, dtype=torch.bfloat16, device=device).normal_(
                0.0, 0.02, generator=g)
        elif expert_dtype == "int8":
            w[role] = ints(shape, -127, 127)
            w[role + "_scale"] = scale(shape[2], 1e-3, 2e-3)
        elif expert_dtype == "int4":
            w[role + "4"] = pack_int4(ints(shape, -8, 8))
            w[role + "_scale"] = scale(shape[2], 0.003, 0.0056)
        else:
            codes = torch.empty(shape, dtype=torch.float8_e4m3fn, device=device)
            for e in range(E):
                codes[e] = torch.empty(shape[1:], dtype=torch.float32, device=device).normal_(
                    0.0, 64.0, generator=g).clamp_(-448.0, 448.0)
            w[role] = codes
            w[role + "_scale"] = scale(shape[2], 2.5e-4, 3.75e-4)
    return w


class KVCache:
    """Per-layer contiguous KV cache, k/v ``[B, S_max, Hkv, Dh]``, updated
    in place (the JAX version returns a new cache)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @classmethod
    def empty(cls, batch, max_len, n_kv, head_dim, dtype, device):
        shape = (batch, max_len, n_kv, head_dim)
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    def update(self, k_new, v_new, offset) -> "KVCache":
        """Write [B, T, Hkv, Dh] at time ``offset``: an int, or a 0-d
        integer tensor on the cache's device (the step a CUDA graph reads
        at replay), written with ``index_copy_`` at ``offset + arange(T)``."""
        T = k_new.shape[1]
        if isinstance(offset, torch.Tensor):
            cols = offset.long() + torch.arange(T, device=offset.device)
            self.k.index_copy_(1, cols, k_new.to(self.k.dtype))
            self.v.index_copy_(1, cols, v_new.to(self.v.dtype))
            return self
        self.k[:, offset:offset + T] = k_new
        self.v[:, offset:offset + T] = v_new
        return self

    def update_rows(self, k_new, v_new, offsets) -> "KVCache":
        """Write [B, 1, Hkv, Dh] at per-row columns ``offsets`` [B] (an int
        tensor on the cache's device, never read on the host), in place with
        ``index_put_`` at (arange(B), offsets), so that a CUDA graph can
        capture it. The JAX version rewrites the cache through a one-hot
        select; the values written are the same."""
        rows = torch.arange(k_new.shape[0], device=offsets.device)
        cols = offsets.long()
        self.k.index_put_((rows, cols), k_new[:, 0].to(self.k.dtype))
        self.v.index_put_((rows, cols), v_new[:, 0].to(self.v.dtype))
        return self


# "flash" (the kernels) or "naive" (the einsum oracle, for parity tests)
_ATTN_IMPL = "flash"


def set_attention_impl(impl: str) -> None:
    global _ATTN_IMPL
    if impl not in ("flash", "naive"):
        raise ValueError(f"unknown attention impl {impl!r}")
    _ATTN_IMPL = impl


def get_attention_impl() -> str:
    return _ATTN_IMPL


def attend(
    q,  # [B, T, H, Dh]
    k_cache,  # [B, S, Hkv, Dh]
    v_cache,
    q_positions,  # [B, T] absolute positions of the queries
    kv_len: int,  # number of valid cache entries
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    logit_softcap: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,  # [B|1, H|1, T|1, S] additive
    pad_mask: Optional[torch.Tensor] = None,  # [B, S] True = valid key
):
    """Masked multi-head attention over a (possibly over-allocated) cache,
    GQA by grouping, softmax in f32. Returns [B, T, H, Dh] in q's dtype."""
    kw = dict(scale=scale, causal=causal, logit_softcap=logit_softcap,
              pad_mask=pad_mask)
    if _ATTN_IMPL == "naive":
        return attend_reference(q, k_cache, v_cache, q_positions, kv_len,
                                bias=bias, **kw)
    if q.shape[1] == 1 and bias is None:
        return fa.flash_decode(q, k_cache, v_cache, q_positions, kv_len, **kw)
    return fa.flash_attend(q, k_cache, v_cache, q_positions, kv_len, bias=bias, **kw)


def attend_cache(
    q,  # [B, T, H, Dh]
    kv,  # KVCache or PagedKVCache, already holding this step's K/V
    q_positions,  # [B, T]
    kv_len: int,
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    logit_softcap: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    pad_mask: Optional[torch.Tensor] = None,  # [B, S] True = valid key
):
    """``attend`` over a cache object. A one-token causal step without a
    bias over a paged cache goes to K4, which reads the pool's pages in
    place, with ``min(kv_len, q_pos + 1)`` live keys per row; everything
    else runs ``attend`` on the cache's (gathered) logical view.

    ``kv_len`` is an int, or a 0-d tensor on the device (the step a CUDA
    graph reads at replay), which is never read on the host: the causal
    bound then limits each row, and the kernels take the cache's capacity
    as ``kv_len`` and plan their splits from it."""
    if isinstance(kv_len, torch.Tensor):
        if not causal:
            raise ValueError("attend_cache: a device kv_len needs the causal bound")
        kv_len = kv.max_len
    if (_ATTN_IMPL == "flash" and q.shape[1] == 1 and causal and bias is None
            and hasattr(kv, "pool_k")):
        row_len = torch.clamp(q_positions[:, 0].to(torch.int32) + 1, max=int(kv_len))
        out = fa.paged_flash_decode(
            q[:, 0], kv.pool_k, kv.pool_v, kv.page_table, row_len,
            scale=scale, logit_softcap=logit_softcap, pad_mask=pad_mask,
            max_len=int(kv_len),
        )
        return out[:, None]
    return attend(q, kv.k, kv.v, q_positions, kv_len, scale=scale,
                  causal=causal, logit_softcap=logit_softcap, bias=bias,
                  pad_mask=pad_mask)


def attend_reference(
    q, k_cache, v_cache, q_positions, kv_len: int, *,
    scale: Optional[float] = None,
    causal: bool = True,
    logit_softcap: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    pad_mask: Optional[torch.Tensor] = None,
):
    """The einsum oracle: masked logits take finfo(f32).min (so a row with no
    valid key averages V, unlike the kernels, which return 0)."""
    B, T, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    rep = H // Hkv
    qg = q.reshape(B, T, Hkv, rep, Dh).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k_cache.float()) * scale
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if bias is not None:
        Bb, Hb, Tb, Sb = bias.shape
        b32 = bias.float()
        logits = logits + (b32[:, :, None] if Hb == 1 else b32.reshape(Bb, Hkv, rep, Tb, Sb))
    key_pos = torch.arange(S, device=q.device)
    valid = (key_pos < kv_len)[None, None, None, None, :]
    if causal:
        valid = valid & (
            key_pos[None, None, None, None, :]
            <= q_positions.long()[:, None, None, :, None]
        )
    if pad_mask is not None:
        valid = valid & pad_mask.to(torch.bool)[:, None, None, None, :]
    logits = torch.where(valid, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v_cache.float())
    return out.reshape(B, T, H, Dh).to(q.dtype)


def pad_bias(mask):
    """[B, S] key mask (1 = real token) -> additive f32 bias [B, 1, 1, S]:
    0, or finfo(f32).min for a pad key, as the JAX models build it."""
    return torch.where(
        mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min
    ).to(torch.float32)


# --------------------------------------------------------------------------
# T5-style relative position bias (Switch Transformers)
# --------------------------------------------------------------------------

def t5_relative_bucket(relative_position, bidirectional: bool, num_buckets: int,
                       max_distance: int):
    """T5's bucket of each relative position (key - query), in the JAX
    package's order of f32 operations, so that a position at a bucket's edge
    lands in the same bucket. Everything runs on the positions' device: the
    two constants are made there with ``torch.full`` (no host copy, so a CUDA
    graph can capture it), and divisions are by tensors, as JAX divides."""
    rel = relative_position
    dev, f32 = rel.device, torch.float32
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    exact = torch.full((), float(max_exact), dtype=f32, device=dev)
    span = torch.full((), max_distance / max_exact, dtype=f32, device=dev).log()
    large = max_exact + (
        torch.log(n.to(f32) / exact + 1e-9) / span * (num_buckets - max_exact)
    ).to(rel.dtype)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def t5_position_bias(rel_bias_table, q_positions, k_positions, bidirectional: bool,
                     num_buckets: int = 32, max_distance: int = 128):
    """[1, H, T, S] additive attention bias from the ``[num_buckets, H]``
    table for query positions [T] and key positions [S] (device tensors;
    no host read)."""
    rel = k_positions[None, :] - q_positions[:, None]  # [T, S]
    buckets = t5_relative_bucket(rel, bidirectional, num_buckets, max_distance)
    bias = rel_bias_table[buckets.long()]  # [T, S, H]
    return bias.permute(2, 0, 1)[None]


def sinusoidal_embedding(num_positions: int, dim: int,
                         padding_idx: Optional[int] = 1, device="cpu"):
    """M2M100-style sinusoidal table [num_positions, dim] (f32)."""
    half = dim // 2
    emb = np.log(10000.0) / (half - 1)
    emb = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(num_positions, dtype=np.float64)[:, None] * emb[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_positions, 1))], axis=1)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return torch.tensor(table, dtype=torch.float32, device=device)
