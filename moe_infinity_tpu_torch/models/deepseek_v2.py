"""DeepSeek-V2 family (V2, V2-Lite, V3 routing) in PyTorch, from
``moe_infinity_tpu/models/deepseek_v2.py``: MLA attention and a shared-expert
MoE.

Attention is the **absorbed MLA** form. The KV cache holds, per token, only
the compressed latent (``kv_lora_rank`` wide, the cache's k slot) and the
shared rope key (``qk_rope_head_dim`` wide, the v slot); the kv_b
up-projection is folded into the query and output sides:

    q_lat[h]  = q_nope[h] @ W_uk[h]          # [R]
    score     = q_lat . c_s + q_pe[h] . k_pe_s
    out[h]    = (sum_s p_s c_s) @ W_uv[h]^T  # [Dv]

A one-token step goes to K5 (``ops.flash_attention.mla_flash_decode``),
which streams the live latent and rope caches once for all heads; a step of
T > 1 tokens (prefill, the batcher's chunk steps) is a masked einsum softmax,
as in the JAX package, and so is every step under
``set_attention_impl("naive")`` and every step at a latent width R that is
not a multiple of 128, where the JAX kernel declines (returns None) and its
model takes the einsum. That choice is made from the shapes before any
call, never by catching a kernel's error: there is no fallback, and K5
raises on the card for a shape it does not take. RoPE pairs
``(x[2i], x[2i+1])`` and stays in f32.

Routing: softmax scores with greedy or group-limited top-k (V2), or sigmoid
scores with a correction bias and sum-of-top-2 group scores (V3); ties go to
the lowest expert index, as ``jax.lax.top_k`` resolves them. Shared experts
run densely on every token, or sit in the routed pool as always-routed
pseudo-experts (``shared_in_pool``).

Parameters are nested dicts of tensors with the JAX package's keys and
layouts, so ``bridge`` carries one into the other. Caches are updated in
place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.models import layers
from moe_infinity_tpu_torch.models.layers import KVCache, linear, rms_norm
from moe_infinity_tpu_torch.ops import flash_attention as fa
from moe_infinity_tpu_torch.ops import gmm as gm
from moe_infinity_tpu_torch.ops.moe import _activate, _gffn_gather, pack_int4, routed_ffn
from moe_infinity_tpu_torch.store.blob import param_getter


@dataclass(frozen=True)
class DeepseekV2Spec:
    vocab_size: int
    hidden_size: int
    intermediate_size: int  # dense-MLP ffn dim
    moe_intermediate_size: int
    num_layers: int
    num_heads: int
    q_lora_rank: Optional[int]
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    num_experts: int
    top_k: int
    n_shared_experts: int
    first_k_dense_replace: int
    topk_method: str  # 'greedy' | 'group_limited_greedy'
    n_group: Optional[int]
    topk_group: Optional[int]
    routed_scaling_factor: float
    rms_eps: float
    rope_theta: float
    tie_embeddings: bool
    router_variant: str = "v2"  # 'v2' softmax | 'v3' sigmoid + noaux bias
    norm_topk_prob: bool = False

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @classmethod
    def from_hf(cls, config) -> "DeepseekV2Spec":
        """From an HF ``DeepseekV2Config``/``DeepseekV3Config``-like object
        (attributes only)."""
        return cls(
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            moe_intermediate_size=config.moe_intermediate_size,
            num_layers=config.num_hidden_layers,
            num_heads=config.num_attention_heads,
            q_lora_rank=getattr(config, "q_lora_rank", None),
            kv_lora_rank=config.kv_lora_rank,
            qk_nope_head_dim=config.qk_nope_head_dim,
            qk_rope_head_dim=config.qk_rope_head_dim,
            v_head_dim=config.v_head_dim,
            num_experts=config.n_routed_experts,
            top_k=config.num_experts_per_tok,
            n_shared_experts=config.n_shared_experts or 0,
            first_k_dense_replace=config.first_k_dense_replace,
            topk_method=getattr(config, "topk_method", "greedy"),
            n_group=getattr(config, "n_group", None),
            topk_group=getattr(config, "topk_group", None),
            routed_scaling_factor=getattr(config, "routed_scaling_factor", 1.0),
            rms_eps=config.rms_norm_eps,
            rope_theta=getattr(config, "rope_theta", 10000.0),
            tie_embeddings=getattr(config, "tie_word_embeddings", False),
            router_variant=(
                "v3" if getattr(config, "model_type", "") == "deepseek_v3" else "v2"
            ),
            norm_topk_prob=getattr(config, "norm_topk_prob", False),
        )


def rope_interleaved(x, cos, sin):
    """DeepSeek rope: complex/interleaved pairing (x[2i], x[2i+1]).
    x: [B, T, H, P]; cos/sin: [B, T, P/2]. Rotated in f32, cast back."""
    B, T, H, P = x.shape
    x32 = x.float().reshape(B, T, H, P // 2, 2)
    xr, xi = x32[..., 0], x32[..., 1]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1)
    return out.reshape(B, T, H, P).to(x.dtype)


def top_k_lowest_first(x, k: int):
    """(values, indices) of the k largest entries along the last axis, in
    descending order, equal values in ascending index order: the order of
    ``jax.lax.top_k`` (``torch.topk`` promises none among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_mask(group_scores, topk_group: int, group_size: int):
    """[n, G] group scores -> [n, G * group_size] bool, True for the experts
    of each row's ``topk_group`` best groups."""
    _, gidx = top_k_lowest_first(group_scores, topk_group)
    gmask = torch.zeros_like(group_scores).scatter_(1, gidx, 1.0)
    return gmask.repeat_interleave(group_size, dim=-1) > 0


class DeepseekV2Model:
    """Forward over explicit params/experts. ``shared_in_pool`` folds the
    shared experts into the routed expert pool as ``n_shared_experts``
    always-routed pseudo-experts (the down projection decomposes exactly
    over F-sized chunks, so outputs are identical); the expert tree then has
    E + n_shared rows per layer."""

    arch = "deepseek"

    def __init__(self, spec: DeepseekV2Spec, compute_dtype=torch.bfloat16,
                 device="cuda", mesh=None, shared_in_pool: bool = False):
        self.mesh = mesh  # parallel/mesh.py: the experts under ops.moe.routed_ffn
        self.spec = spec
        self.dtype = compute_dtype
        self.device = resolve_device(device)
        self.shared_in_pool = shared_in_pool and spec.n_shared_experts > 0

    # ---- params ----------------------------------------------------------
    def load_params(self, dense) -> Dict[str, Any]:
        """The dense param tree on the model's device from a ``DenseArchive``
        (``store/blob.py``): ``kv_b_proj`` [H*(Dn+Dv), R] splits into the
        absorbed ``w_uk`` [H, Dn, R] and ``w_uv`` [H, Dv, R]."""
        s = self.spec
        get = param_getter(dense, self.dtype, self.device)
        layers = []
        for i in range(s.num_layers):
            p = f"model.layers.{i}."
            pl: Dict[str, Any] = {
                "input_norm": get(p + "input_layernorm.weight"),
                "post_norm": get(p + "post_attention_layernorm.weight"),
                "kv_a": get(p + "self_attn.kv_a_proj_with_mqa.weight"),
                "kv_a_norm": get(p + "self_attn.kv_a_layernorm.weight"),
                "o": get(p + "self_attn.o_proj.weight"),
            }
            if s.q_lora_rank is None:
                pl["q"] = get(p + "self_attn.q_proj.weight")
            else:
                pl["q_a"] = get(p + "self_attn.q_a_proj.weight")
                pl["q_a_norm"] = get(p + "self_attn.q_a_layernorm.weight")
                pl["q_b"] = get(p + "self_attn.q_b_proj.weight")
            kv_b = dense.tensor(p + "self_attn.kv_b_proj.weight").reshape(
                s.num_heads, s.qk_nope_head_dim + s.v_head_dim, s.kv_lora_rank)
            pl["w_uk"] = kv_b[:, : s.qk_nope_head_dim].to(self.device, self.dtype).contiguous()
            pl["w_uv"] = kv_b[:, s.qk_nope_head_dim:].to(self.device, self.dtype).contiguous()
            if i < s.first_k_dense_replace:
                pl["mlp_gate"] = get(p + "mlp.gate_proj.weight")
                pl["mlp_up"] = get(p + "mlp.up_proj.weight")
                pl["mlp_down"] = get(p + "mlp.down_proj.weight")
            else:
                pl["router"] = get(p + "mlp.gate.weight", torch.float32)
                if s.router_variant == "v3":
                    pl["router_bias"] = get(p + "mlp.gate.e_score_correction_bias",
                                            torch.float32)
                if s.n_shared_experts:
                    pl["shared_gate"] = get(p + "mlp.shared_experts.gate_proj.weight")
                    pl["shared_up"] = get(p + "mlp.shared_experts.up_proj.weight")
                    pl["shared_down"] = get(p + "mlp.shared_experts.down_proj.weight")
            layers.append(pl)
        params: Dict[str, Any] = {
            "embed": get("model.embed_tokens.weight"),
            "final_norm": get("model.norm.weight"),
            "layers": layers,
        }
        if not s.tie_embeddings and "lm_head.weight" in dense:
            params["lm_head"] = get("lm_head.weight")
        return params

    def init_random(self, generator: torch.Generator, expert_dtype: str = "bf16",
                    with_experts: bool = True):
        """Random params and resident expert tree at spec geometry, built on
        the model's device (where ``generator`` must live), one layer at a
        time. Dense matrices and the router: normal, std 0.02; norms one.
        Experts as ``MixtralModel.init_random``: ``"bf16"`` normal std 0.02;
        ``"int8"`` values in [-127, 127) with per-channel f32 scales in
        [1e-3, 2e-3) under '<role>_scale'; ``"int4"`` split-nibble packed
        '<role>4' with scales in [3e-3, 5.6e-3)."""
        if expert_dtype not in ("bf16", "int8", "int4"):
            raise ValueError(f"expert_dtype {expert_dtype!r}: bf16, int8 or int4")
        s = self.spec
        dev, g = self.device, generator
        D, Fm = s.hidden_size, s.moe_intermediate_size
        E = s.num_experts + (s.n_shared_experts if self.shared_in_pool else 0)
        H, R, P = s.num_heads, s.kv_lora_rank, s.qk_rope_head_dim

        def mat(shape, dtype=self.dtype):
            return torch.empty(shape, dtype=dtype, device=dev).normal_(0.0, 0.02, generator=g)

        def ones(n):
            return torch.ones(n, dtype=torch.float32, device=dev)

        def scale(n, lo, hi):
            return torch.empty((E, n), dtype=torch.float32, device=dev).uniform_(lo, hi, generator=g)

        def ints(shape, lo, hi):
            return torch.randint(lo, hi, shape, dtype=torch.int8, device=dev, generator=g)

        def expert_layer():
            shapes = {"gate": (E, D, Fm), "up": (E, D, Fm), "down": (E, Fm, D)}
            w: Dict[str, torch.Tensor] = {}
            for role, shape in shapes.items():
                if expert_dtype == "bf16":
                    w[role] = mat(shape, torch.bfloat16)
                elif expert_dtype == "int8":
                    w[role] = ints(shape, -127, 127)
                    w[role + "_scale"] = scale(shape[2], 1e-3, 2e-3)
                else:
                    w[role + "4"] = pack_int4(ints(shape, -8, 8))
                    w[role + "_scale"] = scale(shape[2], 0.003, 0.0056)
            return w

        params_layers, experts = [], []
        for i in range(s.num_layers):
            pl = {
                "input_norm": ones(D), "post_norm": ones(D),
                "kv_a": mat((R + P, D)), "kv_a_norm": ones(R),
                "o": mat((D, H * s.v_head_dim)),
                "w_uk": mat((H, s.qk_nope_head_dim, R)),
                "w_uv": mat((H, s.v_head_dim, R)),
            }
            if s.q_lora_rank is None:
                pl["q"] = mat((H * s.qk_head_dim, D))
            else:
                pl["q_a"] = mat((s.q_lora_rank, D))
                pl["q_a_norm"] = ones(s.q_lora_rank)
                pl["q_b"] = mat((H * s.qk_head_dim, s.q_lora_rank))
            if i < s.first_k_dense_replace:
                pl["mlp_gate"] = mat((s.intermediate_size, D))
                pl["mlp_up"] = mat((s.intermediate_size, D))
                pl["mlp_down"] = mat((D, s.intermediate_size))
            else:
                pl["router"] = mat((s.num_experts, D), torch.float32)
                if s.n_shared_experts and not self.shared_in_pool:
                    fs = Fm * s.n_shared_experts
                    pl["shared_gate"] = mat((fs, D))
                    pl["shared_up"] = mat((fs, D))
                    pl["shared_down"] = mat((D, fs))
                if with_experts:
                    experts.append(expert_layer())
            params_layers.append(pl)
        params: Dict[str, Any] = {
            "embed": mat((s.vocab_size, D)),
            "final_norm": ones(D),
            "layers": params_layers,
        }
        if not s.tie_embeddings:
            params["lm_head"] = mat((s.vocab_size, D))
        if not with_experts:
            return params, None
        return params, {
            "layers": experts,
            "slot_map": torch.arange(E, dtype=torch.int32, device=dev),
        }

    # ---- caches ------------------------------------------------------------
    def _cache(self, *lead) -> KVCache:
        s = self.spec
        # k slot: compressed latent [.., S, 1, R]; v slot: roped key [.., S, 1, P]
        return KVCache(
            torch.zeros(*lead, 1, s.kv_lora_rank, dtype=self.dtype, device=self.device),
            torch.zeros(*lead, 1, s.qk_rope_head_dim, dtype=self.dtype, device=self.device),
        )

    def init_cache(self, batch: int, max_len: int) -> List[KVCache]:
        return [self._cache(batch, max_len) for _ in range(self.spec.num_layers)]

    def embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.dtype)

    # ---- MLA attention -----------------------------------------------------
    def _rope_tables(self, positions):
        s = self.spec
        half = s.qk_rope_head_dim // 2
        inv_freq = 1.0 / (
            s.rope_theta
            ** (torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
        )
        freqs = positions.float()[..., None] * inv_freq  # [B, T, half]
        return torch.cos(freqs), torch.sin(freqs)

    @staticmethod
    def _rope_positions(positions, pad_offsets, rope_positions):
        if rope_positions is not None:
            return rope_positions
        if pad_offsets is not None:
            return torch.clamp(positions - pad_offsets[:, None], min=0)
        return positions

    def attn_block(self, pl, x, kv, positions, kv_len: int, pad_offsets=None,
                   rope_positions=None, key_valid=None, rope=None):
        """positions are cache columns. With left padding, pad_offsets [B]
        shifts RoPE to sequence positions and masks the pad columns; on a
        per-row timeline, rope_positions [B, T] gives each row's sequence
        positions and key_valid [B, S] masks hole columns. rope=(cos, sin)
        passes tables computed once per step. Writes this step's latent and
        rope key into ``kv`` (in place) and returns (x + attn, kv).

        With folded params (``fold_mla_params``) the q projection emits the
        latent-absorbed, pre-scaled query directly and w_uv is folded into
        the output projection."""
        s = self.spec
        B, T, _ = x.shape
        H, R = s.num_heads, s.kv_lora_rank
        folded = "o_fold" in pl
        h = rms_norm(x, pl["input_norm"], s.rms_eps)

        if s.q_lora_rank is None:
            q = linear(h, pl["q_fold" if folded else "q"])
        else:
            q = linear(
                rms_norm(linear(h, pl["q_a"]), pl["q_a_norm"], s.rms_eps),
                pl["q_b_fold" if folded else "q_b"],
            )
        if folded:
            q = q.reshape(B, T, H, R + s.qk_rope_head_dim)
            q_lat = q[..., :R].float()  # pre-scaled
            q_pe = q[..., R:]
        else:
            q = q.reshape(B, T, H, s.qk_head_dim)
            q_nope = q[..., : s.qk_nope_head_dim]
            q_pe = q[..., s.qk_nope_head_dim:]

        ckv = linear(h, pl["kv_a"])  # [B, T, R + P]
        c = rms_norm(ckv[..., :R], pl["kv_a_norm"], s.rms_eps)
        k_pe = ckv[..., R:][:, :, None, :]  # [B, T, 1, P]

        if rope is None:
            rope = self._rope_tables(
                self._rope_positions(positions, pad_offsets, rope_positions))
        cos, sin = rope
        q_pe = rope_interleaved(q_pe, cos, sin)
        k_pe = rope_interleaved(k_pe, cos, sin)

        kv = kv.update(c[:, :, None, :], k_pe, kv_len)
        c_cache = kv.k[:, :, 0, :]  # [B, S, R] (a gathered copy when paged)
        kpe_cache = kv.v[:, :, 0, :]  # [B, S, P]
        S = c_cache.shape[1]

        if not folded:
            q_lat = torch.einsum("bthd,hdr->bthr", q_nope.float(), pl["w_uk"].float())
        scale = 1.0 if folded else s.qk_head_dim ** -0.5

        if T == 1 and layers.get_attention_impl() == "flash" and c_cache.shape[-1] % 128 == 0:
            mask = key_valid
            if mask is None and pad_offsets is not None:
                mask = torch.arange(S, device=x.device)[None, :] >= pad_offsets[:, None]
            out_lat = fa.mla_flash_decode(
                q_lat[:, 0], q_pe[:, 0].float(), c_cache, kpe_cache,
                positions[:, 0], kv_len + T, scale=scale, pad_mask=mask,
            )[:, None]  # [B, 1, H, R]
        else:
            c32 = c_cache.float()
            logits = (
                torch.einsum("bthr,bsr->bhts", q_lat, c32)
                + torch.einsum("bthp,bsp->bhts", q_pe.float(), kpe_cache.float())
            )
            if not folded:
                logits = logits * scale
            key_pos = torch.arange(S, device=x.device)[None, None, None, :]
            valid = (key_pos < kv_len + T) & (key_pos <= positions.long()[:, None, :, None])
            if key_valid is not None:
                valid = valid & key_valid.to(torch.bool)[:, None, None, :]
            elif pad_offsets is not None:
                valid = valid & (key_pos >= pad_offsets[:, None, None, None])
            logits = torch.where(valid, logits, torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1)
            out_lat = torch.einsum("bhts,bsr->bthr", probs, c32)
        if folded:
            out = torch.einsum("bthr,dhr->btd", out_lat, pl["o_fold"].float()).to(self.dtype)
        else:
            out = torch.einsum("bthr,hdr->bthd", out_lat, pl["w_uv"].float())
            out = linear(out.reshape(B, T, H * s.v_head_dim).to(self.dtype), pl["o"])
        return x + out, kv

    # ---- routing -------------------------------------------------------------
    def route(self, pl, h):
        """h [B, T, D] post-norm hidden -> (combine [B, T, K] f32, ids int32)."""
        s = self.spec
        B, T, _ = h.shape
        logits = linear(h.float(), pl["router"]).reshape(B * T, -1)  # [n, E]
        if s.router_variant == "v3":
            cw, ids = self._route_v3(pl, logits)
        else:
            scores = torch.softmax(logits, dim=-1)
            if s.topk_method == "group_limited_greedy":
                gsz = s.num_experts // s.n_group
                group_scores = scores.reshape(-1, s.n_group, gsz).amax(dim=-1)
                keep = _group_mask(group_scores, s.topk_group, gsz)
                scores = torch.where(keep, scores, 0.0)
            cw, ids = top_k_lowest_first(scores, s.top_k)
        cw = cw * s.routed_scaling_factor
        return cw.reshape(B, T, s.top_k), ids.to(torch.int32).reshape(B, T, s.top_k)

    def _route_v3(self, pl, logits):
        """DeepSeek-V3 noaux-tc router: sigmoid scores; selection uses
        scores + router_bias with sum-of-top-2 group scoring; combine weights
        are the raw sigmoid scores of the selected experts, optionally
        normalised. Returns (combine before the routed scaling, ids)."""
        s = self.spec
        scores = torch.sigmoid(logits)  # [n, E]
        choice = scores + pl["router_bias"][None, :]
        gsz = s.num_experts // s.n_group
        group_scores = torch.topk(
            choice.reshape(-1, s.n_group, gsz), 2, dim=-1).values.sum(dim=-1)
        keep = _group_mask(group_scores, s.topk_group, gsz)
        _, ids = top_k_lowest_first(torch.where(keep, choice, 0.0), s.top_k)
        cw = torch.gather(scores, 1, ids)
        if s.norm_topk_prob:
            cw = cw / (cw.sum(dim=-1, keepdim=True) + 1e-20)
        return cw, ids

    # ---- MoE / dense-MLP blocks ------------------------------------------------
    def _dense_mlp(self, x, wg, wu, wd):
        return linear(F.silu(linear(x, wg)) * linear(x, wu), wd)

    def _shared_mlp(self, pl, h):
        return self._dense_mlp(h, pl["shared_gate"], pl["shared_up"], pl["shared_down"])

    def moe_layer_index(self, layer_idx: int) -> Optional[int]:
        if layer_idx < self.spec.first_k_dense_replace:
            return None
        return layer_idx - self.spec.first_k_dense_replace

    def dense_layer(self, pl, x, kv, positions, kv_len: int, pad_offsets=None,
                    rope_positions=None, key_valid=None, rope=None):
        """Full step of a ``first_k_dense_replace`` layer."""
        x, kv = self.attn_block(pl, x, kv, positions, kv_len, pad_offsets,
                                rope_positions, key_valid, rope)
        h = rms_norm(x, pl["post_norm"], self.spec.rms_eps)
        return x + self._dense_mlp(h, pl["mlp_gate"], pl["mlp_up"], pl["mlp_down"]), kv

    def pre_moe(self, pl, x, kv, positions, kv_len: int, pad_offsets=None,
                rope_positions=None, key_valid=None, rope=None):
        """Attention, post-norm and routing of one MoE layer. Returns
        (x_resid, h_norm, combine, ids, kv)."""
        x, kv = self.attn_block(pl, x, kv, positions, kv_len, pad_offsets,
                                rope_positions, key_valid, rope)
        h = rms_norm(x, pl["post_norm"], self.spec.rms_eps)
        cw, ids = self.route(pl, h)
        return x, h, cw, ids, kv

    def apply_moe(self, pl, x, h, cw, ids, weights, slot_map, biases, impl):
        """Expert compute, shared experts and residual of one layer."""
        s = self.spec
        B, T, D = h.shape
        if self.shared_in_pool:
            n = s.n_shared_experts
            extra = torch.arange(s.num_experts, s.num_experts + n, dtype=ids.dtype,
                                 device=ids.device).expand(B, T, n)
            ids = torch.cat([ids, extra], dim=-1)
            cw = torch.cat([cw, torch.ones(B, T, n, dtype=cw.dtype, device=cw.device)], dim=-1)
        K = ids.shape[-1]
        y = routed_ffn(
            self.mesh, h.reshape(B * T, D), ids.reshape(B * T, K),
            cw.reshape(B * T, K).float(), slot_map, weights, "silu",
            biases=biases, impl=impl,
        ).reshape(B, T, D)
        if s.n_shared_experts and not self.shared_in_pool:
            y = y + self._shared_mlp(pl, h)
        return x + y

    def head(self, params, x):
        """Final norm and the LM head in f32, as the JAX model computes it."""
        h = rms_norm(x, params["final_norm"], self.spec.rms_eps)
        w = params.get("lm_head", params["embed"])
        return linear(h.float(), w.float())

    # ---- full forward ----------------------------------------------------------
    def forward(self, params, experts, tokens, positions, kv_caches, kv_len: int,
                *, for_layer, impl: str = "ragged", pad_offsets=None,
                rope_positions=None, key_valid=None):
        """Whole-model step over tokens [B, T] at cache column ``kv_len`` (an
        int, or a 0-d device tensor that is never read on the host, as
        ``decode_scan`` gives it: K5 then plans from the cache's capacity).
        Returns (logits [B, T, V] f32, the caches (updated in place), router
        trace of the MoE layers (ids [Lm, B, T, K] int32, weights f32))."""
        s = self.spec
        x = self.embed(params, tokens)
        # the rope tables are the same in every layer: compute them once
        rope = self._rope_tables(self._rope_positions(positions, pad_offsets, rope_positions))
        trace_ids, trace_w = [], []
        for li in range(s.num_layers):
            pl = params["layers"][li]
            mli = self.moe_layer_index(li)
            args = (pl, x, kv_caches[li], positions, kv_len, pad_offsets,
                    rope_positions, key_valid, rope)
            if mli is None:
                x, _ = self.dense_layer(*args)
                continue
            x, h, cw, ids, _ = self.pre_moe(*args)
            w, slot_map, biases = for_layer(experts, mli)
            x = self.apply_moe(pl, x, h, cw, ids, w, slot_map, biases, impl)
            trace_ids.append(ids)
            trace_w.append(cw)
        return self.head(params, x), kv_caches, (torch.stack(trace_ids), torch.stack(trace_w))

    # ---- MLA weight folding (fewer ops on the decode path) -----------------------
    def fold_mla_params(self, params):
        """Fold the absorbed-MLA weights into the projections: w_uk and the
        attention scale into the q (or q_b) projection, which then emits
        [latent query | rope part] per head in one matmul; w_uv into o_proj.
        Exact up to f32 re-association (folded in f32, stored in the compute
        dtype). Returns new params without the per-layer originals (q/q_b,
        w_uk, w_uv, o)."""
        s = self.spec
        H = s.num_heads
        scale = s.qk_head_dim ** -0.5
        qkey = "q" if s.q_lora_rank is None else "q_b"
        new_layers = []
        for pl in params["layers"]:
            pl = dict(pl)
            wuk = pl.pop("w_uk").float()  # [H, Dn, R]
            wuv = pl.pop("w_uv").float()  # [H, Dv, R]
            wq = pl.pop(qkey).float()  # [H*Dk, In] (HF layout)
            wq = wq.reshape(H, s.qk_head_dim, wq.shape[-1])
            wql = torch.einsum("hni,hnr->hri", wq[:, : s.qk_nope_head_dim], wuk)  # [H, R, In]
            fold = torch.cat([wql, wq[:, s.qk_nope_head_dim:]], dim=1) * scale
            pl[qkey + "_fold"] = fold.reshape(
                H * (s.kv_lora_rank + s.qk_rope_head_dim), -1).to(self.dtype)
            wo = pl.pop("o").float().reshape(-1, H, s.v_head_dim)  # [D, H, Dv]
            pl["o_fold"] = torch.einsum("dhv,hvr->dhr", wo, wuv).to(self.dtype)
            new_layers.append(pl)
        return {**params, "layers": new_layers}

    def pool_shared_experts(self, expert_layers, params):
        """The extended expert tree for ``shared_in_pool`` from a default
        expert tree and params: shared gate/up split into F-sized column
        chunks, shared down into F-sized row chunks; summing the chunk
        outputs reproduces the shared MLP exactly."""
        s = self.spec
        Fm, n, k0 = s.moe_intermediate_size, s.n_shared_experts, s.first_k_dense_replace
        out = []
        for mli, lt in enumerate(expert_layers):
            if "gate" not in lt or lt["gate"].dtype == torch.int8:
                raise NotImplementedError(
                    "pool_shared_experts requires unquantized trees; quantize after pooling"
                )
            pl = params["layers"][k0 + mli]
            g, u, d = pl["shared_gate"], pl["shared_up"], pl["shared_down"]
            extra = {
                "gate": torch.stack([g[k * Fm:(k + 1) * Fm, :].t() for k in range(n)]),
                "up": torch.stack([u[k * Fm:(k + 1) * Fm, :].t() for k in range(n)]),
                "down": torch.stack([d[:, k * Fm:(k + 1) * Fm].t() for k in range(n)]),
            }
            new = dict(lt)
            for role, w in extra.items():
                new[role] = torch.cat([lt[role], w.to(lt[role].dtype)], dim=0)
            out.append(new)
        return {
            "layers": out,
            "slot_map": torch.arange(s.num_experts + n, dtype=torch.int32,
                                     device=out[0]["gate"].device),
        }

    # ---- fused path: stacked expert pool, one loop over the layers ----------------
    def stack_moe_layers(self, params):
        """The MoE layers' params stacked along a new leading axis ({key:
        [Lm, ...]}); the leading ``first_k_dense_replace`` layers stay in
        ``params``. ``fused_forward`` walks the stack layer by layer."""
        moe_pls = params["layers"][self.spec.first_k_dense_replace:]
        return {k: torch.stack([pl[k] for pl in moe_pls]) for k in moe_pls[0]}

    @staticmethod
    def stack_experts(layer_trees, layout="tiled"):
        """Per-layer expert dicts ([E, ...] tensors) -> one [Lm*E, ...] pool
        per role: the layout K3's ``group_offset`` reads. ``"tiled"`` (the
        JAX package's default) packs each 3-D role as ``ops.gmm.pack_tiled``
        does, [Lm*E, F/tf, D, tf]; ``"flat"`` keeps [Lm*E, D, F] rows, which
        the gather decode path needs. The tiled pool is one ``cat`` of each
        layer's tiled view, written straight into the pool, so building it
        holds the layer trees and one pool, never a third copy of the
        experts."""
        if layout not in ("tiled", "flat"):
            raise ValueError(f"stack_experts: layout {layout!r} is not 'tiled' or 'flat'")
        out = {}
        for k in layer_trees[0]:
            parts = [lt[k] for lt in layer_trees]
            if layout == "tiled" and parts[0].dim() == 3:
                parts = [gm.tiled_view(p) for p in parts]
            out[k] = torch.cat(parts, dim=0)
        return out

    def _fused_moe_gather(self, h, cw, ids, pool, offset: int):
        """Decode-path MoE as gather + batched matvec over the stacked pool:
        the ``"gather"`` impl of ``grouped_ffn`` with layer ``offset``'s rows
        of the pool as its slots. Plain PyTorch, as it is plain XLA in the JAX
        package (whose fused variant also rounds the activation to bf16 under
        f32 compute; here it stays in the compute dtype)."""
        if pool["gate"].dim() != 3:
            raise ValueError(
                "the gather decode path reads flat [S, D, F] rows: build its pool with "
                "stack_experts(..., layout='flat'), not the tiled layout")
        B, T, D = h.shape
        K = ids.shape[-1]
        slots = torch.arange(offset, offset + self.spec.num_experts, device=h.device)
        y = _gffn_gather(h.reshape(B * T, D), ids.reshape(B * T, K).long(),
                         cw.reshape(B * T, K), slots, pool, "silu", None)
        return y.reshape(B, T, D)

    def _fused_moe(self, h, cw, ids, pool, offset: int):
        """Grouped FFN against the stacked expert pool, flat or tiled, on K3
        with a per-layer group offset: all E groups, the empty ones owning no
        work in the kernel. No host read."""
        E = self.spec.num_experts
        B, T, D = h.shape
        K = ids.shape[-1]
        x = h.reshape(B * T, D)
        flat = ids.reshape(-1).long()
        order = torch.argsort(flat, stable=True)
        inv_token = order // K
        xs = x[inv_token]
        group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device)
        group_sizes.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))

        def run(role, xin):
            return gm.gmm(xin, pool[role], group_sizes, pool.get(role + "_scale"),
                          group_offset=offset)

        a = _activate(run("gate", xs), run("up", xs), "silu").to(x.dtype)
        out = run("down", a) * cw.reshape(-1).float()[order][:, None]
        comb = torch.zeros(B * T, D, dtype=torch.float32, device=x.device)
        comb.index_add_(0, inv_token, out)
        return comb.reshape(B, T, D).to(h.dtype)

    def init_fused_cache(self, batch: int, max_len: int):
        """(dense-layer KVCache list, one KVCache of the MoE layers with a
        leading Lm axis)."""
        k0 = self.spec.first_k_dense_replace
        return ([self._cache(batch, max_len) for _ in range(k0)],
                self._cache(self.spec.num_layers - k0, batch, max_len))

    def fused_forward(self, params, stacked, pool, tokens, positions, kv_state,
                      kv_len: int, *, moe_impl: str = "gmm"):
        """Forward over the stacked MoE layers and the stacked expert pool
        (a Python loop where the JAX package scans). kv_state: (dense kv
        list, stacked MoE KVCache [Lm, B, S, 1, .]), updated in place.
        Returns (logits, kv_state). Reads nothing on the host."""
        s = self.spec
        k0, E = s.first_k_dense_replace, s.num_experts
        dense_kv, moe_kv = kv_state
        x = self.embed(params, tokens)
        rope = self._rope_tables(positions)
        for li in range(k0):
            x, _ = self.dense_layer(params["layers"][li], x, dense_kv[li], positions,
                                    kv_len, rope=rope)
        moe = self._fused_moe_gather if moe_impl == "gather" else self._fused_moe
        keys = list(stacked)
        for li, vals in enumerate(zip(*(stacked[k].unbind(0) for k in keys))):
            pl = dict(zip(keys, vals))
            x, h, cw, ids, _ = self.pre_moe(
                pl, x, KVCache(moe_kv.k[li], moe_kv.v[li]), positions, kv_len, rope=rope)
            y = moe(h, cw, ids, pool, li * E)
            if s.n_shared_experts:
                y = y + self._shared_mlp(pl, h)
            x = x + y
        return self.head(params, x), kv_state
