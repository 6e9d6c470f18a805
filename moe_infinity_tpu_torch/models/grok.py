"""Grok-1 decoder-only MoE model in PyTorch, from
``moe_infinity_tpu/models/grok.py``.

Norm-sandwich blocks: four RMS norms per layer, each inside the residual
(``x + post_attn(attn(pre_attn(x)))``, then ``x + post_moe(moe(pre_moe(x)))``);
llama RoPE with GQA (48 query heads over 8 kv heads in the published
config: rep 6), the scores ``q . k`` times ``attn_output_multiplier`` (no
``1/sqrt(d)``) and then ``max_attn_value * tanh(x / max_attn_value)``, which
the attention kernels take as their ``scale`` and ``softcap``; a top-2
router over the softmax with no renormalisation; GELU-gated experts
(``linear * linear_v -> linear_1``, exact erf). The embedding is scaled by
``embedding_multiplier_scale`` in the compute dtype, the f32 LM head (the
embedding when the checkpoint has no ``lm_head``) by
``output_multiplier_scale``.

Parameters are nested dicts with the JAX model's keys and layouts (dense
``[out, in]``, experts ``[E, D, F]``), so ``bridge`` carries one into the
other. The step's cache column may be a 0-d device tensor (``graph_step``),
so that a CUDA graph captures a step, as ``models/mixtral.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.models.layers import (
    KVCache,
    apply_rope,
    attend_cache,
    linear,
    random_expert_layer,
    rms_norm,
    rope_cos_sin,
)
from moe_infinity_tpu_torch.ops.moe import routed_ffn, topk_router
from moe_infinity_tpu_torch.store.blob import param_getter


@dataclass(frozen=True)
class GrokSpec:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    num_experts: int
    top_k: int
    rms_eps: float
    attn_output_multiplier: float
    max_attn_value: float
    embedding_multiplier_scale: float
    output_multiplier_scale: float

    @classmethod
    def from_hf(cls, config) -> "GrokSpec":
        """From a Grok-1 ``config.json`` namespace (attributes only)."""
        return cls(
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            num_layers=config.num_hidden_layers,
            num_heads=config.num_attention_heads,
            num_kv_heads=config.num_key_value_heads,
            head_dim=config.hidden_size // config.num_attention_heads,
            num_experts=config.num_experts,
            top_k=config.num_experts_per_tok,
            rms_eps=config.rms_norm_eps,
            attn_output_multiplier=config.attn_output_multiplier,
            max_attn_value=config.max_attn_value,
            embedding_multiplier_scale=config.embedding_multiplier_scale,
            output_multiplier_scale=config.output_multiplier_scale,
        )


class GrokModel:
    """Forward over explicit params/experts (the same instance serves the
    whole-model and the per-layer paths)."""

    arch = "grok"
    # a decode step takes its cache column as a 0-d device tensor and reads
    # nothing on the host, so a CUDA graph can capture it
    graph_step = True

    def __init__(self, spec: GrokSpec, compute_dtype=torch.bfloat16, device="cuda",
                 mesh=None):
        self.mesh = mesh  # parallel/mesh.py: the experts under ops.moe.routed_ffn
        self.spec = spec
        self.dtype = compute_dtype
        self.device = resolve_device(device)
        # the embedding scale as the JAX model multiplies by it: a Python
        # float takes the compute dtype there, so bf16(x * bf16(scale))
        self._embed_scale = torch.full((), spec.embedding_multiplier_scale,
                                       dtype=compute_dtype, device=self.device)

    # ---- params ----------------------------------------------------------
    def load_params(self, dense) -> Dict[str, Any]:
        """The dense param tree on the model's device from a ``DenseArchive``
        (``store/blob.py``), under the checkpoint's tensor names."""
        s = self.spec
        get = param_getter(dense, self.dtype, self.device)
        layers = []
        for i in range(s.num_layers):
            p = f"model.layers.{i}."
            layers.append({
                "pre_attn": get(p + "pre_attn_norm.scale"),
                "post_attn": get(p + "post_attn_norm.scale"),
                "pre_moe": get(p + "pre_moe_norm.scale"),
                "post_moe": get(p + "post_moe_norm.scale"),
                "q": get(p + "attn.q_proj.weight"),
                "k": get(p + "attn.k_proj.weight"),
                "v": get(p + "attn.v_proj.weight"),
                "o": get(p + "attn.o_proj.weight"),
                "router": get(p + "moe_block.gate.weight", torch.float32),
            })
        params: Dict[str, Any] = {
            "embed": get("model.embed_tokens.weight"),
            "final_norm": get("model.norm.scale"),
            "layers": layers,
        }
        if "lm_head.weight" in dense:
            params["lm_head"] = get("lm_head.weight")
        return params

    def init_random(self, generator: torch.Generator, expert_dtype: str = "bf16",
                    with_experts: bool = True):
        """Random params and resident expert tree at spec geometry (the JAX
        model's shapes: no ``lm_head``, the head reads the embedding), built
        on the model's device (where ``generator`` must live), one layer at a
        time. Dense matrices and the router: normal, std 0.02; norms one.
        Experts: ``layers.random_expert_layer`` (bf16, int8, int4 or fp8)."""
        s = self.spec
        dev, g = self.device, generator
        D, F, E = s.hidden_size, s.intermediate_size, s.num_experts
        hd, kvd = s.num_heads * s.head_dim, s.num_kv_heads * s.head_dim

        def mat(shape, dtype=self.dtype):
            return torch.empty(shape, dtype=dtype, device=dev).normal_(0.0, 0.02, generator=g)

        def ones():
            return torch.ones(D, dtype=torch.float32, device=dev)

        layers, experts = [], []
        for _ in range(s.num_layers):
            layers.append({
                "pre_attn": ones(), "post_attn": ones(), "pre_moe": ones(),
                "post_moe": ones(),
                "q": mat((hd, D)), "k": mat((kvd, D)), "v": mat((kvd, D)),
                "o": mat((D, hd)), "router": mat((E, D), torch.float32),
            })
            if with_experts:
                experts.append(random_expert_layer(E, D, F, expert_dtype, g, dev))
        params: Dict[str, Any] = {
            "embed": mat((s.vocab_size, D)),
            "final_norm": ones(),
            "layers": layers,
        }
        if not with_experts:
            return params, None
        return params, {
            "layers": experts,
            "slot_map": torch.arange(E, dtype=torch.int32, device=dev),
        }

    # ---- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[KVCache]:
        s = self.spec
        return [
            KVCache.empty(batch, max_len, s.num_kv_heads, s.head_dim, self.dtype, self.device)
            for _ in range(s.num_layers)
        ]

    # ---- building blocks ---------------------------------------------------
    def embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.dtype) * self._embed_scale

    def moe_layer_index(self, layer_idx: int) -> Optional[int]:
        return layer_idx

    # ---- layer-step protocol -----------------------------------------------
    def pre_moe(self, pl, x, kv, positions, kv_len, pad_offsets=None,
                rope_positions=None, key_valid=None):
        """Attention with its two norms, the pre-MoE norm and routing of one
        layer; the position streams as ``MixtralModel.attn_block`` takes
        them. Returns (x_resid, h_norm, combine, ids, kv)."""
        s = self.spec
        B, T, _ = x.shape
        h = rms_norm(x, pl["pre_attn"], s.rms_eps)
        q = linear(h, pl["q"]).reshape(B, T, s.num_heads, s.head_dim)
        k = linear(h, pl["k"]).reshape(B, T, s.num_kv_heads, s.head_dim)
        v = linear(h, pl["v"]).reshape(B, T, s.num_kv_heads, s.head_dim)
        rope_pos, pad_mask = positions, None
        if rope_positions is not None:
            rope_pos, pad_mask = rope_positions, key_valid
        elif pad_offsets is not None:
            rope_pos = torch.clamp(positions - pad_offsets[:, None], min=0)
            cols = torch.arange(kv.max_len, device=x.device)[None, :]
            pad_mask = cols >= pad_offsets[:, None]
        cos, sin = rope_cos_sin(rope_pos, s.head_dim, 10000.0)
        q, k = apply_rope(q, k, cos, sin)
        kv = kv.update(k, v, kv_len)
        a = attend_cache(q, kv, positions, kv_len + T, scale=s.attn_output_multiplier,
                         logit_softcap=s.max_attn_value, pad_mask=pad_mask)
        a = linear(a.reshape(B, T, -1), pl["o"])
        x = x + rms_norm(a, pl["post_attn"], s.rms_eps)
        h = rms_norm(x, pl["pre_moe"], s.rms_eps)
        logits = linear(h.float(), pl["router"])
        cw, ids, _ = topk_router(logits.reshape(B * T, -1), s.top_k, normalize=False)
        return x, h, cw.reshape(B, T, -1), ids.reshape(B, T, -1), kv

    def apply_moe(self, pl, x, h, cw, ids, weights, slot_map, biases, impl):
        """GELU-gated experts, the post-MoE norm and the residual."""
        B, T, D = h.shape
        K = ids.shape[-1]
        y = routed_ffn(
            self.mesh, h.reshape(B * T, D), ids.reshape(B * T, K), cw.reshape(B * T, K).float(),
            slot_map, weights, "gelu", biases=biases, impl=impl,
        )
        return x + rms_norm(y.reshape(B, T, D), pl["post_moe"], self.spec.rms_eps)

    def head(self, params, x):
        """Final norm, then the LM head in f32 times ``output_multiplier_scale``."""
        s = self.spec
        h = rms_norm(x, params["final_norm"], s.rms_eps)
        w = params.get("lm_head", params["embed"])
        return linear(h.float(), w.float()) * s.output_multiplier_scale

    # ---- full forward --------------------------------------------------------
    def forward(self, params, experts, tokens, positions, kv_caches, kv_len,
                *, for_layer, impl: str = "ragged", pad_offsets=None,
                rope_positions=None, key_valid=None):
        """Whole-model step over tokens [B, T] at cache column ``kv_len`` (an
        int, or a 0-d device tensor that a graph reads at replay).
        Returns (logits [B, T, V] f32, the caches (updated in place), router
        trace (ids [L, B, T, K] int32, weights [L, B, T, K] f32))."""
        x = self.embed(params, tokens)
        trace_ids, trace_w = [], []
        for li in range(self.spec.num_layers):
            pl = params["layers"][li]
            x, h, cw, ids, _ = self.pre_moe(
                pl, x, kv_caches[li], positions, kv_len, pad_offsets,
                rope_positions, key_valid,
            )
            w, slot_map, biases = for_layer(experts, li)
            x = self.apply_moe(pl, x, h, cw, ids, w, slot_map, biases, impl)
            trace_ids.append(ids)
            trace_w.append(cw)
        return self.head(params, x), kv_caches, (torch.stack(trace_ids), torch.stack(trace_w))
