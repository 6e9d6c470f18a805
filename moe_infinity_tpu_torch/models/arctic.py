"""Snowflake Arctic, a dense + MoE hybrid with a parallel residual, in
PyTorch, from ``moe_infinity_tpu/models/arctic.py``.

Mixtral-style GQA attention (scaled, llama RoPE; 56 query heads over 8 kv
heads in the published config: rep 7). On a MoE layer with
``parallel_attn_mlp_res`` the MoE branch reads the pre-attention input while
a dense residual MLP reads the post-attention stream:

    a   = x + attn(ln_in(x))
    rr  = a + residual_mlp(ln_res(a))
    out = rr + moe(ln_post(x))          # ln_post applied to x, not a

The router is Mixtral's softmax top-k, renormalised when k > 1; the experts
are silu-gated ``w1``/``w3``/``w2``. Layers where
``(i + 1) % moe_layer_frequency != 0`` run a dense silu MLP instead
(``dense_layer``, which the offload engine's per-layer loop calls as it
calls DeepSeek's leading dense layer). Parameters are nested dicts with the
JAX model's keys and layouts; the step's cache column may be a 0-d device
tensor (``graph_step``), as ``models/mixtral.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

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
class ArcticSpec:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    num_experts: int
    top_k: int
    moe_layer_frequency: int
    parallel_attn_mlp_res: bool
    rms_eps: float
    rope_theta: float

    @classmethod
    def from_hf(cls, config) -> "ArcticSpec":
        """From an Arctic ``config.json`` namespace, with the JAX model's
        defaults for the fields it may leave out."""
        return cls(
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            num_layers=config.num_hidden_layers,
            num_heads=config.num_attention_heads,
            num_kv_heads=config.num_key_value_heads,
            head_dim=config.hidden_size // config.num_attention_heads,
            num_experts=config.num_local_experts,
            top_k=config.num_experts_per_tok,
            moe_layer_frequency=getattr(config, "moe_layer_frequency", 1),
            parallel_attn_mlp_res=getattr(config, "parallel_attn_mlp_res", False),
            rms_eps=config.rms_norm_eps,
            rope_theta=getattr(config, "rope_theta", 1e6),
        )

    def is_moe(self, layer: int) -> bool:
        return (layer + 1) % self.moe_layer_frequency == 0


class ArcticModel:
    """Forward over explicit params/experts (the same instance serves the
    whole-model and the per-layer paths)."""

    arch = "arctic"
    # a decode step takes its cache column as a 0-d device tensor and reads
    # nothing on the host, so a CUDA graph can capture it
    graph_step = True

    def __init__(self, spec: ArcticSpec, compute_dtype=torch.bfloat16, device="cuda",
                 mesh=None):
        self.mesh = mesh  # parallel/mesh.py: the experts under ops.moe.routed_ffn
        self.spec = spec
        self.dtype = compute_dtype
        self.device = resolve_device(device)

    # ---- params ----------------------------------------------------------
    def load_params(self, dense) -> Dict[str, Any]:
        """The dense param tree on the model's device from a ``DenseArchive``,
        at the shapes the checkpoint holds."""
        s = self.spec
        get = param_getter(dense, self.dtype, self.device)
        layers = []
        for i in range(s.num_layers):
            p = f"model.layers.{i}."
            pl = {
                "input_norm": get(p + "input_layernorm.weight"),
                "post_norm": get(p + "post_attention_layernorm.weight"),
                "q": get(p + "self_attn.q_proj.weight"),
                "k": get(p + "self_attn.k_proj.weight"),
                "v": get(p + "self_attn.v_proj.weight"),
                "o": get(p + "self_attn.o_proj.weight"),
            }
            if s.is_moe(i):
                pl["router"] = get(p + "block_sparse_moe.gate.weight", torch.float32)
                if s.parallel_attn_mlp_res:
                    pl["res_norm"] = get(p + "residual_layernorm.weight")
                    for w in ("w1", "w2", "w3"):
                        pl["res_" + w] = get(p + f"residual_mlp.{w}.weight")
            else:
                for w in ("w1", "w2", "w3"):
                    pl["mlp_" + w] = get(p + f"block_sparse_moe.mlp.{w}.weight")
            layers.append(pl)
        params: Dict[str, Any] = {
            "embed": get("model.embed_tokens.weight"),
            "final_norm": get("model.norm.weight"),
            "layers": layers,
        }
        if "lm_head.weight" in dense:
            params["lm_head"] = get("lm_head.weight")
        return params

    def init_random(self, generator: torch.Generator, expert_dtype: str = "bf16",
                    with_experts: bool = True):
        """Random params and resident expert tree at spec geometry (the JAX
        model's shapes: the residual and dense MLPs sized by
        ``intermediate_size``, no ``lm_head``), built on the model's device
        (where ``generator`` must live). Dense matrices and the router:
        normal, std 0.02; norms one. Experts: ``layers.random_expert_layer``
        (bf16, int8, int4 or fp8), one entry per MoE layer."""
        s = self.spec
        dev, g = self.device, generator
        D, Fd, E = s.hidden_size, s.intermediate_size, s.num_experts
        hd, kvd = s.num_heads * s.head_dim, s.num_kv_heads * s.head_dim

        def mat(shape, dtype=self.dtype):
            return torch.empty(shape, dtype=dtype, device=dev).normal_(0.0, 0.02, generator=g)

        def ones():
            return torch.ones(D, dtype=torch.float32, device=dev)

        def mlp(prefix):
            return {prefix + "w1": mat((Fd, D)), prefix + "w2": mat((D, Fd)),
                    prefix + "w3": mat((Fd, D))}

        layers, experts = [], []
        for i in range(s.num_layers):
            pl = {
                "input_norm": ones(), "post_norm": ones(),
                "q": mat((hd, D)), "k": mat((kvd, D)), "v": mat((kvd, D)),
                "o": mat((D, hd)),
            }
            if s.is_moe(i):
                pl["router"] = mat((E, D), torch.float32)
                if s.parallel_attn_mlp_res:
                    pl["res_norm"] = ones()
                    pl.update(mlp("res_"))
                if with_experts:
                    experts.append(random_expert_layer(E, D, Fd, expert_dtype, g, dev))
            else:
                pl.update(mlp("mlp_"))
            layers.append(pl)
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
        return params["embed"][tokens.long()].to(self.dtype)

    def moe_layer_index(self, layer_idx: int) -> Optional[int]:
        if not self.spec.is_moe(layer_idx):
            return None
        return (layer_idx + 1) // self.spec.moe_layer_frequency - 1

    @staticmethod
    def _silu_mlp(x, w1, w2, w3):
        return linear(F.silu(linear(x, w1)) * linear(x, w3), w2)

    def _attn(self, pl, x, kv, positions, kv_len, pad_offsets=None,
              rope_positions=None, key_valid=None):
        """x + attention of one layer (the position streams as
        ``MixtralModel.attn_block`` takes them); writes this step's K/V into
        ``kv`` in place."""
        s = self.spec
        B, T, _ = x.shape
        h = rms_norm(x, pl["input_norm"], s.rms_eps)
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
        cos, sin = rope_cos_sin(rope_pos, s.head_dim, s.rope_theta)
        q, k = apply_rope(q, k, cos, sin)
        kv = kv.update(k, v, kv_len)
        a = attend_cache(q, kv, positions, kv_len + T, pad_mask=pad_mask)
        return x + linear(a.reshape(B, T, -1), pl["o"]), kv

    # ---- layer-step protocol -----------------------------------------------
    def dense_layer(self, pl, x, kv, positions, kv_len, pad_offsets=None,
                    rope_positions=None, key_valid=None):
        """A layer without experts: attention, then the dense silu MLP."""
        x, kv = self._attn(pl, x, kv, positions, kv_len, pad_offsets,
                           rope_positions, key_valid)
        h = rms_norm(x, pl["post_norm"], self.spec.rms_eps)
        return x + self._silu_mlp(h, pl["mlp_w1"], pl["mlp_w2"], pl["mlp_w3"]), kv

    def pre_moe(self, pl, x, kv, positions, kv_len, pad_offsets=None,
                rope_positions=None, key_valid=None):
        """Attention, the residual MLP and routing of one MoE layer. Returns
        (x_resid, h_moe_input, combine, ids, kv): with
        ``parallel_attn_mlp_res`` the MoE input is ``post_norm`` of the
        pre-attention x and x_resid already holds the residual MLP."""
        s = self.spec
        B, T, _ = x.shape
        x_pre = x
        x, kv = self._attn(pl, x, kv, positions, kv_len, pad_offsets,
                           rope_positions, key_valid)
        if s.parallel_attn_mlp_res:
            hr = rms_norm(x, pl["res_norm"], s.rms_eps)
            x = x + self._silu_mlp(hr, pl["res_w1"], pl["res_w2"], pl["res_w3"])
            h = rms_norm(x_pre, pl["post_norm"], s.rms_eps)
        else:
            h = rms_norm(x, pl["post_norm"], s.rms_eps)
        logits = linear(h.float(), pl["router"])
        cw, ids, _ = topk_router(logits.reshape(B * T, -1), s.top_k,
                                 normalize=s.top_k > 1)
        return x, h, cw.reshape(B, T, -1), ids.reshape(B, T, -1), kv

    def apply_moe(self, pl, x, h, cw, ids, weights, slot_map, biases, impl):
        """Silu-gated experts and the residual."""
        B, T, D = h.shape
        K = ids.shape[-1]
        y = routed_ffn(
            self.mesh, h.reshape(B * T, D), ids.reshape(B * T, K), cw.reshape(B * T, K).float(),
            slot_map, weights, "silu", biases=biases, impl=impl,
        )
        return x + y.reshape(B, T, D)

    def head(self, params, x):
        """Final norm and the LM head in f32 (the embedding without ``lm_head``)."""
        h = rms_norm(x, params["final_norm"], self.spec.rms_eps)
        w = params.get("lm_head", params["embed"])
        return linear(h.float(), w.float())

    # ---- full forward --------------------------------------------------------
    def forward(self, params, experts, tokens, positions, kv_caches, kv_len,
                *, for_layer, impl: str = "ragged", pad_offsets=None,
                rope_positions=None, key_valid=None):
        """Whole-model step over tokens [B, T] at cache column ``kv_len`` (an
        int, or a 0-d device tensor that a graph reads at replay).
        Returns (logits [B, T, V] f32, the caches (updated in place), router
        trace of the MoE layers (ids [L_moe, B, T, K] int32, weights))."""
        x = self.embed(params, tokens)
        trace_ids, trace_w = [], []
        for li in range(self.spec.num_layers):
            pl = params["layers"][li]
            mli = self.moe_layer_index(li)
            if mli is None:
                x, _ = self.dense_layer(pl, x, kv_caches[li], positions, kv_len,
                                        pad_offsets, rope_positions, key_valid)
                continue
            x, h, cw, ids, _ = self.pre_moe(
                pl, x, kv_caches[li], positions, kv_len, pad_offsets,
                rope_positions, key_valid,
            )
            w, slot_map, biases = for_layer(experts, mli)
            x = self.apply_moe(pl, x, h, cw, ids, w, slot_map, biases, impl)
            trace_ids.append(ids)
            trace_w.append(cw)
        return self.head(params, x), kv_caches, (torch.stack(trace_ids), torch.stack(trace_w))
