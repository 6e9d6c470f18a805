"""NLLB-MoE (facebook/nllb-moe-54b) in PyTorch, from
``moe_infinity_tpu/models/nllb.py``. Inference-mode semantics:

* pre-LN transformer with biased LayerNorms and biased attention
  projections; scaled dot-product attention (1/sqrt(d_head));
* sinusoidal positions (M2M100 table, padding_idx = pad id, position ids =
  cumsum of the non-pad mask + padding_idx), embeddings scaled by
  sqrt(d_model);
* top-2 router: top-1 by softmax prob, top-2 = argmax of the logits with
  the top-1 masked out, combine weights the two probs normalised to sum to
  one (no capacity dropping at eval);
* sparse FF every ``sparse_step`` blocks at (i + 1) % step == 0; expert FFNs
  carry fc1/fc2 biases.

Parameters are nested dicts of tensors with the JAX package's keys and
layouts (dense ``[out, in]``, experts ``[E, D, F]``), so ``bridge`` carries
one into the other.

The stage protocol of the JAX model (``enc_prelude``, ``enc_block_sparse_pre``,
``enc_block_dense``, ``enc_final``, ``dec_prelude``, ``dec_embed``,
``dec_block_sparse_pre``, ``dec_block_dense``, ``dec_final``, ``cross_kv_block``
and ``apply_ff``) is what the offload engine drives layer by layer, with the
routed ids read on the host between a block's routing and its experts;
``encode`` and ``decode_step`` run the same stages in one call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.models.layers import (
    KVCache,
    attend,
    layer_norm,
    linear,
    pad_bias,
    sinusoidal_embedding,
)
from moe_infinity_tpu_torch.ops.moe import routed_ffn
from moe_infinity_tpu_torch.store.blob import param_getter


@dataclass(frozen=True)
class NllbSpec:
    vocab_size: int
    d_model: int
    num_heads: int
    encoder_layers: int
    decoder_layers: int
    encoder_ffn_dim: int
    decoder_ffn_dim: int
    encoder_sparse_step: int
    decoder_sparse_step: int
    num_experts: int
    pad_token_id: int
    decoder_start_token_id: int
    max_positions: int
    scale_embedding: bool

    @classmethod
    def from_hf(cls, config) -> "NllbSpec":
        """From an HF ``NllbMoeConfig``-like object (attributes only)."""
        return cls(
            vocab_size=config.vocab_size,
            d_model=config.d_model,
            num_heads=config.encoder_attention_heads,
            encoder_layers=config.encoder_layers,
            decoder_layers=config.decoder_layers,
            encoder_ffn_dim=config.encoder_ffn_dim,
            decoder_ffn_dim=config.decoder_ffn_dim,
            encoder_sparse_step=config.encoder_sparse_step,
            decoder_sparse_step=config.decoder_sparse_step,
            num_experts=config.num_experts,
            pad_token_id=config.pad_token_id,
            decoder_start_token_id=config.decoder_start_token_id,
            max_positions=config.max_position_embeddings,
            scale_embedding=getattr(config, "scale_embedding", True),
        )

    def is_sparse(self, block: int, decoder: bool) -> bool:
        step = self.decoder_sparse_step if decoder else self.encoder_sparse_step
        return step > 0 and (block + 1) % step == 0

    def moe_layer_id(self, block: int, decoder: bool) -> int:
        step = self.decoder_sparse_step if decoder else self.encoder_sparse_step
        base = 0
        if decoder:
            base = self.encoder_layers // self.encoder_sparse_step
        return base + block // step


class NllbModel:
    arch = "nllb"

    def __init__(self, spec: NllbSpec, compute_dtype=torch.float32, device="cuda", mesh=None):
        self.spec = spec
        self.dtype = compute_dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self._pos_table = sinusoidal_embedding(
            spec.max_positions + spec.pad_token_id + 1,
            spec.d_model,
            padding_idx=spec.pad_token_id,
            device=self.device,
        )
        self._scale = spec.d_model ** 0.5 if spec.scale_embedding else 1.0
        # runner-up experts per (token, layer) that ``decode_step``'s trace
        # carries beyond the top-2 (the speculative engine sets it)
        self.route_margin = 0

    # ---- params ---------------------------------------------------------
    def load_params(self, dense) -> Dict[str, Any]:
        """The dense param tree on the model's device from a ``DenseArchive``
        (``store/blob.py``). A sparse block's ``router_bias`` is zero (HF's
        router classifier has none); benches set it for skewed routing."""
        s = self.spec
        get = param_getter(dense, self.dtype, self.device)

        def attn(prefix):
            return {
                "q": get(prefix + "q_proj.weight"), "qb": get(prefix + "q_proj.bias"),
                "k": get(prefix + "k_proj.weight"), "kb": get(prefix + "k_proj.bias"),
                "v": get(prefix + "v_proj.weight"), "vb": get(prefix + "v_proj.bias"),
                "o": get(prefix + "out_proj.weight"), "ob": get(prefix + "out_proj.bias"),
            }

        def stack(prefix, n, decoder):
            blocks = []
            for i in range(n):
                p = f"{prefix}.layers.{i}."
                b: Dict[str, Any] = {
                    "self_attn": attn(p + "self_attn."),
                    "ln0_w": get(p + "self_attn_layer_norm.weight"),
                    "ln0_b": get(p + "self_attn_layer_norm.bias"),
                    "lnf_w": get(p + "ff_layer_norm.weight"),
                    "lnf_b": get(p + "ff_layer_norm.bias"),
                }
                if decoder:
                    b["cross_attn"] = attn(p + "cross_attention.")
                    b["lnc_w"] = get(p + "cross_attention_layer_norm.weight")
                    b["lnc_b"] = get(p + "cross_attention_layer_norm.bias")
                if s.is_sparse(i, decoder):
                    b["router"] = get(p + "ffn.router.classifier.weight", torch.float32)
                    b["router_bias"] = torch.zeros(s.num_experts, dtype=torch.float32,
                                                   device=self.device)
                else:
                    b["fc1"] = get(p + "ffn.fc1.weight")
                    b["fc1b"] = get(p + "ffn.fc1.bias")
                    b["fc2"] = get(p + "ffn.fc2.weight")
                    b["fc2b"] = get(p + "ffn.fc2.bias")
                blocks.append(b)
            return blocks

        return {
            "embed": get("model.shared.weight"),
            "enc_blocks": stack("model.encoder", s.encoder_layers, False),
            "enc_final_ln_w": get("model.encoder.layer_norm.weight"),
            "enc_final_ln_b": get("model.encoder.layer_norm.bias"),
            "dec_blocks": stack("model.decoder", s.decoder_layers, True),
            "dec_final_ln_w": get("model.decoder.layer_norm.weight"),
            "dec_final_ln_b": get("model.decoder.layer_norm.bias"),
        }

    def init_random(self, generator: torch.Generator, device=None, expert_dtype="int4",
                    with_experts: bool = True):
        """Random params and resident expert tree at spec geometry, built
        directly on ``device`` (the model's by default) from ``generator``
        (which must live on that device). Experts are packed int4 (random
        bytes, scales near 0.0043 so weights have std near 0.02); dense
        experts at NLLB-54B size would take 103 GB. Biases are zero, router
        weights std 0.5, other matrices std 0.02. with_experts=False skips
        the expert tree and returns (params, None): the offload path streams
        the experts from a store instead."""
        if expert_dtype != "int4":
            raise ValueError(f"expert_dtype {expert_dtype!r}: only 'int4' is built")
        s = self.spec
        dev = resolve_device(device) if device is not None else self.device
        D, E = s.d_model, s.num_experts
        g = generator

        def mat(shape, dtype=self.dtype, std=0.02):
            return torch.empty(shape, dtype=dtype, device=dev).normal_(0.0, std, generator=g)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=dev)

        def attn():
            return {
                "q": mat((D, D)), "qb": zeros(D),
                "k": mat((D, D)), "kb": zeros(D),
                "v": mat((D, D)), "vb": zeros(D),
                "o": mat((D, D)), "ob": zeros(D),
            }

        def packed(d_in, d_out):
            return torch.randint(-128, 128, (E, d_in, d_out // 2),
                                 dtype=torch.int8, device=dev, generator=g)

        def scale(d_out):
            return torch.empty((E, d_out), dtype=torch.float32,
                               device=dev).uniform_(0.003, 0.0056, generator=g)

        def expert_layer(F):
            return {"gate4": packed(D, F), "gate_scale": scale(F),
                    "down4": packed(F, D), "down_scale": scale(D),
                    "gate_bias": zeros(E, F), "down_bias": zeros(E, D)}

        experts: List[Dict[str, Any]] = []

        def block(i, decoder):
            F = s.decoder_ffn_dim if decoder else s.encoder_ffn_dim
            b: Dict[str, Any] = {
                "self_attn": attn(),
                "ln0_w": ones(D), "ln0_b": zeros(D),
                "lnf_w": ones(D), "lnf_b": zeros(D),
            }
            if decoder:
                b["cross_attn"] = attn()
                b["lnc_w"] = ones(D)
                b["lnc_b"] = zeros(D)
            if s.is_sparse(i, decoder):
                b["router"] = mat((E, D), torch.float32, std=0.5)
                b["router_bias"] = zeros(E)
                if with_experts:
                    experts.append(expert_layer(F))
            else:
                b["fc1"] = mat((F, D))
                b["fc1b"] = zeros(F)
                b["fc2"] = mat((D, F))
                b["fc2b"] = zeros(D)
            return b

        params = {
            "embed": mat((s.vocab_size, D)),
            "enc_blocks": [block(i, False) for i in range(s.encoder_layers)],
            "enc_final_ln_w": ones(D),
            "enc_final_ln_b": zeros(D),
            "dec_blocks": [block(i, True) for i in range(s.decoder_layers)],
            "dec_final_ln_w": ones(D),
            "dec_final_ln_b": zeros(D),
        }
        if not with_experts:
            return params, None
        tree = {
            "layers": experts,
            "slot_map": torch.arange(E, dtype=torch.int32, device=dev),
        }
        return params, tree

    # ---- building blocks -------------------------------------------------
    def _attn(self, a, x_q, k, v, q_pos, kv_len, *, causal, pad_bias=None):
        B, T, D = x_q.shape
        H = self.spec.num_heads
        Dh = D // H
        q = linear(x_q, a["q"], a["qb"]).reshape(B, T, H, Dh)
        out = attend(q, k, v, q_pos, kv_len, scale=Dh ** -0.5, causal=causal,
                     bias=pad_bias)
        return linear(out.reshape(B, T, D), a["o"], a["ob"])

    def _kv(self, a, x):
        B, T, D = x.shape
        H = self.spec.num_heads
        k = linear(x, a["k"], a["kb"]).reshape(B, T, H, D // H)
        v = linear(x, a["v"], a["vb"]).reshape(B, T, H, D // H)
        return k, v

    def _route_top2(self, b, h, margin: int = 0):
        """Eval-mode NLLB top-2 (no capacity dropping): (cw [BT, 2] f32,
        ids [BT, 2] int32, trace_ids [BT, 2 + margin] int32). trace_ids are
        the top-2, then the next ``margin`` experts by logit; equal logits
        go in ascending expert order, the order ``lax.top_k`` gives."""
        E = self.spec.num_experts
        B, T, D = h.shape
        logits = linear(h.float(), b["router"]).reshape(B * T, E)
        rb = b.get("router_bias")
        if rb is not None:
            logits = logits + rb
        probs = torch.softmax(logits, dim=-1)
        top1 = torch.argmax(probs, dim=-1)
        masked = logits.scatter(1, top1[:, None], float("-inf"))
        top2 = torch.argmax(masked, dim=-1)
        w1 = probs.gather(1, top1[:, None])[:, 0]
        w2 = probs.gather(1, top2[:, None])[:, 0]
        denom = torch.clamp(w1 + w2, min=torch.finfo(torch.float32).eps)
        ids = torch.stack([top1, top2], dim=-1).to(torch.int32)
        cw = torch.stack([w1 / denom, w2 / denom], dim=-1)
        if margin <= 0:
            return cw, ids, ids
        masked2 = masked.scatter(1, top2[:, None], float("-inf"))
        nxt = torch.sort(masked2, dim=-1, descending=True, stable=True).indices[:, :margin]
        return cw, ids, torch.cat([ids, nxt.to(torch.int32)], dim=-1)

    def _positions(self, tokens, past):
        mask = (tokens != self.spec.pad_token_id).to(torch.int32)
        return (torch.cumsum(mask, dim=1) + past) * mask + self.spec.pad_token_id

    def _embed(self, params, tokens, past=0):
        x = params["embed"][tokens.long()].to(self.dtype) * self._scale
        pos = self._positions(tokens, past)
        return x + self._pos_table[pos.long()].to(self.dtype)

    def _dense_ff(self, b, h):
        a = torch.relu(linear(h, b["fc1"], b["fc1b"]))
        return linear(a, b["fc2"], b["fc2b"])

    # ---- stage protocol (the offload engine drives these) ----------------
    def apply_ff(self, x, h, cw, ids, weights, slot_map, biases, impl):
        """x + the routed expert FFN of h [B, T, D] (ids, cw [B, T, K])."""
        B, T, D = h.shape
        K = ids.shape[-1]
        y = routed_ffn(self.mesh, h.reshape(B * T, D), ids.reshape(B * T, K),
                       cw.reshape(B * T, K), slot_map, weights, "relu", biases=biases, impl=impl)
        return x + y.reshape(B, T, D)

    def enc_prelude(self, params, tokens, pad_mask):
        B, T = tokens.shape
        q_pos = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
        return self._embed(params, tokens), pad_bias(pad_mask), q_pos

    def _enc_attn(self, b, x, bias, q_pos):
        T = x.shape[1]
        h = layer_norm(x, b["ln0_w"], b["ln0_b"], 1e-5)
        k, v = self._kv(b["self_attn"], h)
        x = x + self._attn(b["self_attn"], h, k, v, q_pos, T, causal=False, pad_bias=bias)
        return x, layer_norm(x, b["lnf_w"], b["lnf_b"], 1e-5)

    def enc_block_sparse_pre(self, b, x, bias, q_pos):
        """(x, h, cw [B, T, 2], ids [B, T, 2]): attention and routing."""
        x, h = self._enc_attn(b, x, bias, q_pos)
        B, T, _ = h.shape
        cw, ids, _ = self._route_top2(b, h)
        return x, h, cw.reshape(B, T, -1), ids.reshape(B, T, -1)

    def enc_block_dense(self, b, x, bias, q_pos):
        x, h = self._enc_attn(b, x, bias, q_pos)
        return x + self._dense_ff(b, h)

    def enc_final(self, params, x):
        return layer_norm(x, params["enc_final_ln_w"], params["enc_final_ln_b"], 1e-5)

    def dec_prelude(self, params, positions, cache_len: int, enc_mask):
        return None, pad_bias(enc_mask)  # no self-attention bias in NLLB

    def dec_embed(self, params, dec_tokens, step=0):
        return self._embed(params, dec_tokens, step)

    def _dec_attn(self, b, x, kv, positions, kv_len, bias, ck, cv, cross_bias,
                  row_offsets=None):
        """``kv_len`` (the cache offset, an int or a 0-d tensor) only places
        the step's K/V, or ``row_offsets`` [B] places each row's at its own
        column. The self-attention reads up to the cache's capacity and the
        causal bound from ``positions`` (the cache columns) limits each row,
        so no launch depends on the step, and the columns past a row's own
        (what an execution that was not accepted, or a slot's previous
        occupant, left) stay unread."""
        h = layer_norm(x, b["ln0_w"], b["ln0_b"], 1e-5)
        k, v = self._kv(b["self_attn"], h)
        kv = kv.update(k, v, kv_len) if row_offsets is None else kv.update_rows(k, v, row_offsets)
        x = x + self._attn(b["self_attn"], h, kv.k, kv.v, positions, kv.max_len, causal=True)
        h = layer_norm(x, b["lnc_w"], b["lnc_b"], 1e-5)
        x = x + self._attn(b["cross_attn"], h, ck, cv, positions, ck.shape[1],
                           causal=False, pad_bias=cross_bias)
        return x, layer_norm(x, b["lnf_w"], b["lnf_b"], 1e-5), kv

    def dec_block_sparse_pre(self, b, x, kv, positions, kv_len, bias, ck, cv, cross_bias):
        """(x, h, cw [B, T, 2], ids [B, T, 2], kv); the cache is written in
        place."""
        x, h, kv = self._dec_attn(b, x, kv, positions, kv_len, bias, ck, cv, cross_bias)
        B, T, _ = h.shape
        cw, ids, _ = self._route_top2(b, h)
        return x, h, cw.reshape(B, T, -1), ids.reshape(B, T, -1), kv

    def dec_block_dense(self, b, x, kv, positions, kv_len, bias, ck, cv, cross_bias,
                        row_offsets=None):
        x, h, kv = self._dec_attn(b, x, kv, positions, kv_len, bias, ck, cv, cross_bias,
                                  row_offsets)
        return x + self._dense_ff(b, h), kv

    def dec_final(self, params, x):
        """Logits [B, T, V] f32: the LM head in f32, as the JAX model."""
        x = layer_norm(x, params["dec_final_ln_w"], params["dec_final_ln_b"], 1e-5)
        return linear(x.float(), params["embed"].float())

    def cross_kv_block(self, b, enc_out):
        """One decoder block's cross-attention K/V."""
        return self._kv(b["cross_attn"], enc_out)

    # ---- encoder --------------------------------------------------------
    def encode(self, params, experts, tokens, pad_mask, for_layer, impl="ragged"):
        s = self.spec
        x, bias, q_pos = self.enc_prelude(params, tokens, pad_mask)
        for i, b in enumerate(params["enc_blocks"]):
            if s.is_sparse(i, False):
                x, h, cw, ids = self.enc_block_sparse_pre(b, x, bias, q_pos)
                weights, slot_map, biases = for_layer(experts, s.moe_layer_id(i, False))
                x = self.apply_ff(x, h, cw, ids, weights, slot_map, biases, impl)
            else:
                x = self.enc_block_dense(b, x, bias, q_pos)
        return self.enc_final(params, x)

    # ---- decoder --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[KVCache]:
        s = self.spec
        H = s.num_heads
        return [
            KVCache.empty(batch, max_len, H, s.d_model // H, self.dtype, self.device)
            for _ in range(s.decoder_layers)
        ]

    def cross_kv(self, params, enc_out):
        return [self.cross_kv_block(b, enc_out) for b in params["dec_blocks"]]

    def decode_step(self, params, experts, dec_tokens, positions, kvs, kv_len,
                    enc_mask, cross, for_layer, impl="ragged", row_offsets=None):
        """One decoder step for tokens [B, T] at cache offset ``kv_len`` (an
        int, or a 0-d integer tensor on the device, which a CUDA graph reads
        at replay); writes the step's K/V into ``kvs`` in place. Returns (logits
        [B, T, V] f32, kvs, trace): trace is the routed ids of the decoder's
        sparse layers in order, [L_dec_moe, B, T, 2 + route_margin] int32,
        left on the device.

        row_offsets [B] (a device int tensor, T must be 1): per-row decode
        positions, for the continuous batcher's slots at different depths:
        each row embeds its own position and writes its K/V at its own
        column (``KVCache.update_rows``); ``positions`` then holds the same
        columns, ``kv_len`` is unused and nothing is read on the host."""
        s = self.spec
        B, T = dec_tokens.shape
        if row_offsets is not None and T != 1:
            raise ValueError("decode_step: row_offsets needs one token per row")
        bias, cross_bias = self.dec_prelude(params, positions, kvs[0].max_len, enc_mask)
        x = self.dec_embed(params, dec_tokens,
                           kv_len if row_offsets is None else row_offsets[:, None])
        trace = []
        for i, b in enumerate(params["dec_blocks"]):
            ck, cv = cross[i]
            if s.is_sparse(i, True):
                x, h, kvs[i] = self._dec_attn(b, x, kvs[i], positions, kv_len, bias, ck, cv,
                                              cross_bias, row_offsets)
                cw, ids, trace_ids = self._route_top2(b, h, self.route_margin)
                trace.append(trace_ids.reshape(B, T, -1))
                weights, slot_map, biases = for_layer(experts, s.moe_layer_id(i, True))
                x = self.apply_ff(x, h, cw.reshape(B, T, -1), ids.reshape(B, T, -1), weights,
                                  slot_map, biases, impl)
            else:
                x, kvs[i] = self.dec_block_dense(
                    b, x, kvs[i], positions, kv_len, bias, ck, cv, cross_bias, row_offsets)
        if trace:
            trace = torch.stack(trace)
        else:
            trace = torch.empty((0, B, T, 2 + self.route_margin), dtype=torch.int32,
                                device=x.device)
        return self.dec_final(params, x), kvs, trace
