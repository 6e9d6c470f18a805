"""OPT, the dense decoder-only family, in PyTorch, from
``moe_infinity_tpu/models/opt.py``.

HF semantics (``transformers`` ``modeling_opt.py``): learned positional
embeddings at a +2 index offset, biased q/k/v/out and fc projections,
pre-norm blocks (``do_layer_norm_before``; the post-norm OPT-350m variant is
refused at spec build, as is ``word_embed_proj_dim != hidden_size``), the
final decoder LayerNorm, the LM head tied to the token embedding and
computed in f32, as the JAX model computes it.

The per-layer stage protocol (``embed_step``, ``dense_layer``, ``head``) is
what dense paging (``runtime/dense_arena.py::PagedDenseEngine``) drives;
``forward`` is the whole-model step of ``ResidentStepper``. Attention goes
through ``models/layers.py::attend``: K1 for one-token steps, K2 for the
prefill. The kernels take head dim 64 or 128 (OPT-125m to 1.3B, and 6.7B
up to OPT-66B's 9216 / 72); OPT-2.7B's 80 is refused on the card (ROADMAP
queue 2 part 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.models.layers import KVCache, attend, layer_norm, linear
from moe_infinity_tpu_torch.store.blob import param_getter

_EPS = 1e-5  # nn.LayerNorm's default; OPTConfig carries no eps
_KERNEL_HEAD_DIMS = (64, 128)


@dataclass(frozen=True)
class OPTSpec:
    vocab_size: int
    hidden_size: int
    ffn_dim: int
    num_layers: int
    num_heads: int
    max_positions: int
    activation: str = "relu"

    @classmethod
    def from_hf(cls, cfg) -> "OPTSpec":
        if not getattr(cfg, "do_layer_norm_before", True):
            raise NotImplementedError("OPT post-norm variant (350m) is not supported")
        proj = getattr(cfg, "word_embed_proj_dim", cfg.hidden_size)
        if proj not in (None, cfg.hidden_size):
            raise NotImplementedError("OPT word_embed_proj_dim != hidden_size is not supported")
        return cls(
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.hidden_size,
            ffn_dim=cfg.ffn_dim,
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            max_positions=cfg.max_position_embeddings,
            activation=getattr(cfg, "activation_function", "relu"),
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class OPTModel:
    arch = "opt"

    def __init__(self, spec: OPTSpec, compute_dtype=torch.bfloat16, device="cuda"):
        self.spec = spec
        self.dtype = compute_dtype
        self.device = resolve_device(device)
        if self.device.type == "cuda" and spec.head_dim not in _KERNEL_HEAD_DIMS:
            raise NotImplementedError(
                f"OPT at head dim {spec.head_dim}: K1 and K2 take 64 or 128 "
                "(head dim 80, OPT-2.7B, is ROADMAP queue 2 part 3)")

    # ---- cache -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[KVCache]:
        s = self.spec
        return [KVCache.empty(batch, max_len, s.num_heads, s.head_dim, self.dtype, self.device)
                for _ in range(s.num_layers)]

    def moe_layer_index(self, li: int):
        return None  # every layer is dense

    # ---- forward (the stepper protocol) --------------------------------------
    def forward(self, params, experts, tokens, positions, kv_caches, kv_len, *,
                for_layer=None, impl: str = "ragged", pad_offsets=None):
        """Whole-model step over tokens [B, T] at cache column ``kv_len``:
        (logits [B, T, V] f32, the caches (written in place), None)."""
        x = self.embed_step(params, tokens, positions, pad_offsets)
        for li in range(self.spec.num_layers):
            x, kv_caches[li] = self.dense_layer(params["layers"][li], x, kv_caches[li],
                                                positions, kv_len)
        return self.head(params, x), kv_caches, None

    # ---- the per-layer stages (dense paging drives these) ------------------
    def embed_step(self, params, tokens, positions, pad_offsets=None):
        pos = positions
        if pad_offsets is not None:
            pos = positions - pad_offsets[:, None]
        # learned positions at HF's +2 offset
        emb = params["embed"][tokens.long()] + params["pos"][torch.clamp(pos.long(), min=0) + 2]
        return emb.to(self.dtype)

    def dense_layer(self, pl, x, kv, positions, kv_len: int):
        """One pre-norm block; writes this step's K/V into ``kv`` in place
        and returns (x, kv)."""
        s = self.spec
        B, T = x.shape[:2]
        H, Dh = s.num_heads, s.head_dim
        h = layer_norm(x, pl["ln0_w"], pl["ln0_b"], _EPS)
        q = linear(h, pl["q"], pl["qb"]).reshape(B, T, H, Dh)
        k = linear(h, pl["k"], pl["kb"]).reshape(B, T, H, Dh)
        v = linear(h, pl["v"], pl["vb"]).reshape(B, T, H, Dh)
        kv = kv.update(k, v, kv_len)
        a = attend(q, kv.k, kv.v, positions, kv_len + T, causal=True)
        x = x + linear(a.reshape(B, T, -1), pl["o"], pl["ob"])
        h = layer_norm(x, pl["lnf_w"], pl["lnf_b"], _EPS)
        f = linear(h, pl["fc1"], pl["fc1b"])
        # jax.nn.gelu's default is the tanh form
        f = (torch.nn.functional.gelu(f, approximate="tanh")
             if s.activation.startswith("gelu") else torch.relu(f))
        return x + linear(f, pl["fc2"], pl["fc2b"]), kv

    def head(self, params, x):
        """The final LayerNorm and the tied embedding, in f32."""
        x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], _EPS)
        return linear(x.float(), params["embed"].float())

    # ---- params ------------------------------------------------------------
    def load_params(self, dense) -> Dict[str, Any]:
        """The param tree on the model's device from a ``DenseArchive``:
        matrices in the compute dtype, vectors in f32, the two embeddings in
        the compute dtype."""
        s = self.spec
        get = param_getter(dense, self.dtype, self.device)
        layers = []
        for i in range(s.num_layers):
            p = f"model.decoder.layers.{i}."
            layers.append({
                "ln0_w": get(p + "self_attn_layer_norm.weight"),
                "ln0_b": get(p + "self_attn_layer_norm.bias"),
                "q": get(p + "self_attn.q_proj.weight"),
                "qb": get(p + "self_attn.q_proj.bias"),
                "k": get(p + "self_attn.k_proj.weight"),
                "kb": get(p + "self_attn.k_proj.bias"),
                "v": get(p + "self_attn.v_proj.weight"),
                "vb": get(p + "self_attn.v_proj.bias"),
                "o": get(p + "self_attn.out_proj.weight"),
                "ob": get(p + "self_attn.out_proj.bias"),
                "lnf_w": get(p + "final_layer_norm.weight"),
                "lnf_b": get(p + "final_layer_norm.bias"),
                "fc1": get(p + "fc1.weight"),
                "fc1b": get(p + "fc1.bias"),
                "fc2": get(p + "fc2.weight"),
                "fc2b": get(p + "fc2.bias"),
            })
        return {
            "embed": get("model.decoder.embed_tokens.weight", self.dtype),
            "pos": get("model.decoder.embed_positions.weight", self.dtype),
            "final_ln_w": get("model.decoder.final_layer_norm.weight"),
            "final_ln_b": get("model.decoder.final_layer_norm.bias"),
            "layers": layers,
        }

    def init_random(self, generator: torch.Generator, num_distinct: Optional[int] = None):
        """Random params at spec geometry, made on the model's device (where
        ``generator`` lives): matrices normal with std 0.02, biases zero,
        norms one. num_distinct: draw that many layers and let the stack's
        layers alias them in turn (layer i is draw i % num_distinct), so a
        deep stack costs the memory of a few."""
        s = self.spec
        dev, g = self.device, generator
        D, F = s.hidden_size, s.ffn_dim

        def mat(shape):
            return torch.empty(shape, dtype=self.dtype, device=dev).normal_(0.0, 0.02, generator=g)

        def vec(n, fill=0.0):
            return torch.full((n,), fill, dtype=torch.float32, device=dev)

        n = min(num_distinct or s.num_layers, s.num_layers)
        drawn = []
        for _ in range(n):
            layer = {"ln0_w": vec(D, 1.0), "ln0_b": vec(D), "q": mat((D, D)), "qb": vec(D),
                     "k": mat((D, D)), "kb": vec(D), "v": mat((D, D)), "vb": vec(D),
                     "o": mat((D, D)), "ob": vec(D), "lnf_w": vec(D, 1.0), "lnf_b": vec(D),
                     "fc1": mat((F, D)), "fc1b": vec(F), "fc2": mat((D, F)), "fc2b": vec(D)}
            drawn.append(layer)
        return {
            "embed": mat((s.vocab_size, D)),
            "pos": mat((s.max_positions + 2, D)),
            "final_ln_w": vec(D, 1.0),
            "final_ln_b": vec(D),
            "layers": [drawn[i % n] for i in range(s.num_layers)],
        }
