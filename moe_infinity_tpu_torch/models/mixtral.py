"""Mixtral (and Mixtral-family) decoder-only MoE model in PyTorch, from
``moe_infinity_tpu/models/mixtral.py``.

HF semantics: pre-RMSNorm blocks, GQA attention with RoPE (no biases),
a top-k softmax router with the k weights renormalised, SiLU-gated experts
run as one grouped FFN per layer (``ops.moe.grouped_ffn``). Parameters are
nested dicts of tensors with the JAX package's keys and layouts (dense
``[out, in]``, experts ``[E, D, F]``), so ``bridge`` carries one into the
other.

Two position streams: ``positions`` are cache columns (causal masking and
``kv_len`` follow them), while RoPE takes the sequence positions, which
differ from the columns under left padding (``pad_offsets``) or on the
continuous batcher's shared timeline (``rope_positions`` per row, with
``key_valid`` masking the hole columns).

Under a mesh (``parallel/mesh.py``) the experts run through
``ops.moe.grouped_ffn_ep``. With a model axis of ``tp`` above 1 the dense
weights are Megatron-sharded as ``parallel.mixtral_param_shardings`` cuts
them: each rank holds ``H / tp`` query heads and ``Hkv / tp`` KV heads (and
a cache of those), K1/K2 attend over them, the o projection and the
embedding lookup (a slice of the vocabulary) end in an ``all_reduce`` over
the model axis, and the logits are assembled over the vocabulary.
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
class MixtralSpec:
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
    rope_theta: float
    tie_embeddings: bool

    @classmethod
    def from_hf(cls, config) -> "MixtralSpec":
        """From an HF ``MixtralConfig``-like object (attributes only)."""
        return cls(
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            num_layers=config.num_hidden_layers,
            num_heads=config.num_attention_heads,
            num_kv_heads=config.num_key_value_heads,
            head_dim=getattr(config, "head_dim", None)
            or config.hidden_size // config.num_attention_heads,
            num_experts=config.num_local_experts,
            top_k=config.num_experts_per_tok,
            rms_eps=config.rms_norm_eps,
            rope_theta=getattr(config, "rope_theta", 1e6),
            tie_embeddings=getattr(config, "tie_word_embeddings", False),
        )


class MixtralModel:
    """Forward over explicit params/experts (the same instance serves the
    whole-model and the per-layer paths)."""

    arch = "mixtral"
    # a decode step takes its cache column as a 0-d device tensor and reads
    # nothing on the host, so a CUDA graph can capture it
    graph_step = True

    def __init__(self, spec: MixtralSpec, compute_dtype=torch.bfloat16,
                 device="cuda", mesh=None, shard_dense: bool = True):
        """mesh: a ``parallel.mesh.Mesh``; its model axis splits the heads
        and the vocabulary (raises where they do not divide: JAX's GSPMD
        would reshard a KV head across ranks, the port does not).
        shard_dense=False keeps the dense weights whole on every rank and
        splits only the experts over the model axis, as the pod engines run
        (``runtime/pod_engine.py``)."""
        self.spec = spec
        self.dtype = compute_dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        tp = 1 if mesh is None or not shard_dense else mesh.shape["model"]
        if spec.num_kv_heads % tp or spec.num_heads % tp or spec.vocab_size % tp:
            raise ValueError(
                f"a model axis of {tp} must divide the KV heads ({spec.num_kv_heads}), the "
                f"query heads ({spec.num_heads}) and the vocabulary ({spec.vocab_size}): "
                "a rank holds whole KV heads and an equal slice of the vocabulary")
        self.tp = tp
        self.num_heads, self.num_kv_heads = spec.num_heads // tp, spec.num_kv_heads // tp

    # ---- params ----------------------------------------------------------
    def load_params(self, dense) -> Dict[str, Any]:
        """The dense param tree on the model's device from a ``DenseArchive``
        (``store/blob.py``), under HF's tensor names."""
        s = self.spec
        get = param_getter(dense, self.dtype, self.device)
        layers = []
        for i in range(s.num_layers):
            p = f"model.layers.{i}."
            layers.append({
                "input_norm": get(p + "input_layernorm.weight"),
                "post_norm": get(p + "post_attention_layernorm.weight"),
                "q": get(p + "self_attn.q_proj.weight"),
                "k": get(p + "self_attn.k_proj.weight"),
                "v": get(p + "self_attn.v_proj.weight"),
                "o": get(p + "self_attn.o_proj.weight"),
                "router": get(p + "block_sparse_moe.gate.weight", torch.float32),
            })
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
        Experts: ``layers.random_expert_layer`` at ``"bf16"``, ``"int8"`` or
        ``"int4"``."""
        if expert_dtype not in ("bf16", "int8", "int4"):
            raise ValueError(f"expert_dtype {expert_dtype!r}: bf16, int8 or int4")
        s = self.spec
        dev, g = self.device, generator
        D, F, E = s.hidden_size, s.intermediate_size, s.num_experts
        hd, kvd = s.num_heads * s.head_dim, s.num_kv_heads * s.head_dim

        def mat(shape, dtype=self.dtype):
            return torch.empty(shape, dtype=dtype, device=dev).normal_(0.0, 0.02, generator=g)

        def ones(n):
            return torch.ones(n, dtype=torch.float32, device=dev)

        layers, experts = [], []
        for _ in range(s.num_layers):
            layers.append({
                "input_norm": ones(D), "post_norm": ones(D),
                "q": mat((hd, D)), "k": mat((kvd, D)), "v": mat((kvd, D)),
                "o": mat((D, hd)), "router": mat((E, D), torch.float32),
            })
            if with_experts:
                experts.append(random_expert_layer(E, D, F, expert_dtype, g, dev))
        params: Dict[str, Any] = {
            "embed": mat((s.vocab_size, D)),
            "final_norm": ones(D),
            "layers": layers,
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
    def init_cache(self, batch: int, max_len: int) -> List[KVCache]:
        s = self.spec
        return [
            KVCache.empty(batch, max_len, self.num_kv_heads, s.head_dim, self.dtype, self.device)
            for _ in range(s.num_layers)
        ]

    # ---- building blocks ---------------------------------------------------
    def embed(self, params, tokens):
        if self.tp == 1:
            return params["embed"][tokens.long()].to(self.dtype)
        # this rank's vocabulary slice: its ids look up, the rest give 0
        n = params["embed"].shape[0]
        local = tokens.long() - self.mesh.axis_index("model") * n
        mine = (local >= 0) & (local < n)
        x = params["embed"][local.clamp(0, n - 1)].to(self.dtype) * mine[..., None].to(self.dtype)
        return self.mesh.all_reduce(x, "model")

    def attn_block(self, pl, x, kv, positions, kv_len, pad_offsets=None,
                   rope_positions=None, key_valid=None):
        """positions are cache columns. With left padding, pad_offsets [B]
        shifts RoPE to sequence positions and masks the pad columns; on a
        per-row timeline, rope_positions [B, T] gives each row's sequence
        positions and key_valid [B, S] masks hole columns. ``kv_len``, the
        cache column of the first token, is an int or a 0-d device tensor
        (``graph_step``). Writes this step's K/V into ``kv`` (in place) and
        returns (x + attn, kv)."""
        s = self.spec
        B, T, _ = x.shape
        h = rms_norm(x, pl["input_norm"], s.rms_eps)
        q = linear(h, pl["q"]).reshape(B, T, self.num_heads, s.head_dim)
        k = linear(h, pl["k"]).reshape(B, T, self.num_kv_heads, s.head_dim)
        v = linear(h, pl["v"]).reshape(B, T, self.num_kv_heads, s.head_dim)
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
        out = attend_cache(q, kv, positions, kv_len + T, pad_mask=pad_mask)
        o = linear(out.reshape(B, T, -1), pl["o"])
        if self.tp > 1:  # each rank's heads' share of the projection
            self.mesh.all_reduce(o, "model")
        return x + o, kv

    def route(self, pl, h):
        """h [B, T, D] post-norm hidden -> (combine [B, T, K] f32, ids)."""
        logits = linear(h.float(), pl["router"])
        B, T, _ = logits.shape
        cw, ids, _ = topk_router(logits.reshape(B * T, -1), self.spec.top_k,
                                 normalize=True)
        return cw.reshape(B, T, -1), ids.reshape(B, T, -1)

    def moe_block(self, h, cw, ids, weights, slot_map, biases, impl):
        B, T, D = h.shape
        K = ids.shape[-1]
        y = routed_ffn(
            self.mesh, h.reshape(B * T, D), ids.reshape(B * T, K),
            cw.reshape(B * T, K).float(), slot_map, weights, "silu",
            biases=biases, impl=impl,
        )
        return y.reshape(B, T, D)

    # ---- layer-step protocol -----------------------------------------------
    def pre_moe(self, pl, x, kv, positions, kv_len, pad_offsets=None,
                rope_positions=None, key_valid=None):
        """Attention, post-norm and routing of one layer. Returns (x_resid,
        h_norm, combine, ids, kv)."""
        x, kv = self.attn_block(pl, x, kv, positions, kv_len, pad_offsets,
                                rope_positions, key_valid)
        h = rms_norm(x, pl["post_norm"], self.spec.rms_eps)
        cw, ids = self.route(pl, h)
        return x, h, cw, ids, kv

    def apply_moe(self, pl, x, h, cw, ids, weights, slot_map, biases, impl):
        """Expert compute and residual of one layer."""
        return x + self.moe_block(h, cw, ids, weights, slot_map, biases, impl)

    def head(self, params, x):
        """Final norm and the LM head in f32, as the JAX model computes it."""
        h = rms_norm(x, params["final_norm"], self.spec.rms_eps)
        w = params.get("lm_head", params["embed"])
        logits = linear(h.float(), w.float())
        return logits if self.tp == 1 else self.mesh.gather_cols(logits, "model")

    def moe_layer_index(self, layer_idx: int) -> Optional[int]:
        return layer_idx

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
            w, slot_map, biases = for_layer(experts, self.moe_layer_index(li))
            x = self.apply_moe(pl, x, h, cw, ids, w, slot_map, biases, impl)
            trace_ids.append(ids)
            trace_w.append(cw)
        return self.head(params, x), kv_caches, (torch.stack(trace_ids), torch.stack(trace_w))
