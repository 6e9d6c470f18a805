"""Switch Transformers (google/switch-*) in PyTorch, from
``moe_infinity_tpu/models/switch.py``: the T5 encoder-decoder with MoE
feed-forward blocks. Inference-mode semantics:

* T5 attention: no 1/sqrt(d) scaling (``scale=1.0`` is passed to every
  attention call); a relative position bias from block 0's bucket table,
  shared by all blocks of a stack, bidirectional in the encoder and
  unidirectional in the decoder; no position bias on cross-attention;
* a top-1 router in f32 with **expert capacity**: per sequence, tokens
  routed to an expert past ``expert_capacity`` (counted in token order, pad
  tokens included) get combine weight 0, so only the residual passes;
* a sparse FF block at odd indices (``i % step == 1`` or ``step == 1``),
  the dense T5 FF otherwise; experts and dense FF are ``wi``/``wo`` with
  ReLU, or the tanh GELU where ``dense_act_fn`` is a GELU (``is_gated``
  only names the gated dense class of HF's checkpoints; the experts of a
  store written with ``gated`` carry ``wi_0``/``wi_1``, which ``grouped_ffn``
  runs as gate and up);
* tied embeddings: the decoder output is scaled by ``d_model ** -0.5``
  before the head, and the head runs in f32.

Global MoE layer ids put the encoder's sparse layers first, then the
decoder's, as the expert store does. The stage protocol is NLLB's
(``models/nllb.py``), so the offload engine drives both the same way; the
decoder's trace is stacked ``[L_dec_moe, B, T, 1 + route_margin]``, as
NLLB's is. Attention goes to K2 (``flash_attend``) everywhere, since every
call carries a bias: the encoder's ``[B, H, T, T]`` (T5 plus pad), the
decoder's ``[1, H, T, S_cap]`` and cross-attention's ``[B, 1, 1, S_enc]``,
at Switch's head dim of 64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.models.layers import (
    KVCache,
    attend,
    linear,
    pad_bias,
    rms_norm,
    t5_position_bias,
    t5_relative_bucket,
)
from moe_infinity_tpu_torch.ops.moe import routed_ffn
from moe_infinity_tpu_torch.store.blob import param_getter


@dataclass(frozen=True)
class SwitchSpec:
    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    num_heads: int
    num_encoder_layers: int
    num_decoder_layers: int
    encoder_sparse_step: int
    decoder_sparse_step: int
    num_experts: int
    expert_capacity: int
    rel_buckets: int
    rel_max_distance: int
    rms_eps: float
    tie_embeddings: bool
    is_gated: bool
    dense_act_gelu: bool
    decoder_start_token_id: int

    @classmethod
    def from_hf(cls, config) -> "SwitchSpec":
        """From a ``SwitchTransformersConfig`` (or any object with its
        attributes): reads attributes only."""
        return cls(
            vocab_size=config.vocab_size,
            d_model=config.d_model,
            d_kv=config.d_kv,
            d_ff=config.d_ff,
            num_heads=config.num_heads,
            num_encoder_layers=config.num_layers,
            num_decoder_layers=config.num_decoder_layers,
            encoder_sparse_step=config.encoder_sparse_step,
            decoder_sparse_step=config.decoder_sparse_step,
            num_experts=config.num_experts,
            expert_capacity=config.expert_capacity,
            rel_buckets=config.relative_attention_num_buckets,
            rel_max_distance=config.relative_attention_max_distance,
            rms_eps=config.layer_norm_epsilon,
            tie_embeddings=getattr(config, "tie_word_embeddings", True),
            is_gated=getattr(config, "is_gated_act", False),
            dense_act_gelu=getattr(config, "dense_act_fn", "relu") in ("gelu_new", "gelu"),
            decoder_start_token_id=config.decoder_start_token_id,
        )

    def is_sparse(self, block: int, decoder: bool) -> bool:
        step = self.decoder_sparse_step if decoder else self.encoder_sparse_step
        if step <= 0:
            return False
        return block % step == 1 or step == 1

    def moe_layer_id(self, block: int, decoder: bool) -> int:
        """Global MoE layer id of a sparse block."""
        step = self.decoder_sparse_step if decoder else self.encoder_sparse_step
        base = 0
        if decoder:
            base = sum(1 for i in range(self.num_encoder_layers) if self.is_sparse(i, False))
        return base + block // step

    @property
    def num_moe_layers(self) -> int:
        return sum(
            1 for i in range(self.num_encoder_layers) if self.is_sparse(i, False)
        ) + sum(1 for i in range(self.num_decoder_layers) if self.is_sparse(i, True))


class SwitchModel:
    arch = "switch"

    def __init__(self, spec: SwitchSpec, compute_dtype=torch.float32, device="cuda",
                 mesh=None):
        self.spec = spec
        self.dtype = compute_dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        # runner-up experts per (token, layer) that ``decode_step``'s trace
        # carries beyond the top-1 (the speculative engine sets it)
        self.route_margin = 0
        # the experts' and the dense FF's activation follows dense_act_fn
        self.activation = "gelu_tanh" if spec.dense_act_gelu else "relu"

    # ---- params ---------------------------------------------------------
    def load_params(self, dense) -> Dict[str, Any]:
        """The dense param tree on the model's device from a ``DenseArchive``
        (``store/blob.py``); the T5 relative bias of each stack comes from
        its block 0."""
        s = self.spec
        get = param_getter(dense, self.dtype, self.device)

        def stack(prefix, n, decoder):
            blocks = []
            for i in range(n):
                p = f"{prefix}.block.{i}.layer."
                b: Dict[str, Any] = {
                    "ln0": get(p + "0.layer_norm.weight"),
                    "q": get(p + "0.SelfAttention.q.weight"),
                    "k": get(p + "0.SelfAttention.k.weight"),
                    "v": get(p + "0.SelfAttention.v.weight"),
                    "o": get(p + "0.SelfAttention.o.weight"),
                }
                if i == 0:
                    b["rel_bias"] = get(p + "0.SelfAttention.relative_attention_bias.weight",
                                        torch.float32)
                ff = "2" if decoder else "1"
                if decoder:
                    b["ln_cross"] = get(p + "1.layer_norm.weight")
                    b["cq"] = get(p + "1.EncDecAttention.q.weight")
                    b["ck"] = get(p + "1.EncDecAttention.k.weight")
                    b["cv"] = get(p + "1.EncDecAttention.v.weight")
                    b["co"] = get(p + "1.EncDecAttention.o.weight")
                b["ln_ff"] = get(p + f"{ff}.layer_norm.weight")
                if s.is_sparse(i, decoder):
                    b["router"] = get(p + f"{ff}.mlp.router.classifier.weight", torch.float32)
                else:
                    # the dense FF is DenseActDense (is_gated_act picks only
                    # the activation function)
                    b["wi"] = get(p + f"{ff}.mlp.wi.weight")
                    b["wo"] = get(p + f"{ff}.mlp.wo.weight")
                blocks.append(b)
            return blocks

        params: Dict[str, Any] = {
            "embed": get("shared.weight"),
            "enc_blocks": stack("encoder", s.num_encoder_layers, False),
            "enc_final_ln": get("encoder.final_layer_norm.weight"),
            "dec_blocks": stack("decoder", s.num_decoder_layers, True),
            "dec_final_ln": get("decoder.final_layer_norm.weight"),
        }
        if not s.tie_embeddings and "lm_head.weight" in dense:
            params["lm_head"] = get("lm_head.weight")
        return params

    def init_random(self, generator: torch.Generator, device=None, expert_dtype=None,
                    with_experts: bool = True):
        """Random params and resident expert tree at spec geometry, built on
        ``device`` (the model's by default) from ``generator`` (which must
        live there). Matrices have std 0.02, the router std 0.5, norms are
        ones. Experts are ``gate`` [E, D, F] / ``down`` [E, F, D] in
        ``expert_dtype`` (default the compute dtype), or, with
        ``expert_dtype="int4"``, packed int4 under ``gate4``/``down4``
        (random bytes) with per-channel scales near 0.0043, so weights have
        std near 0.02: Switch-large-128's experts are 51.5 GB in bf16, 12.9 GB
        so. with_experts=False returns (params, None)."""
        s = self.spec
        dev = resolve_device(device) if device is not None else self.device
        g = generator
        D, E, Fd = s.d_model, s.num_experts, s.d_ff
        hd = s.num_heads * s.d_kv

        def mat(shape, dtype=self.dtype, std=0.02):
            return torch.empty(shape, dtype=dtype, device=dev).normal_(0.0, std, generator=g)

        def ones(n):
            return torch.ones(n, dtype=torch.float32, device=dev)

        def expert_layer():
            if expert_dtype == "int4":
                def packed(d_in, d_out):
                    return torch.randint(-128, 128, (E, d_in, d_out // 2), dtype=torch.int8,
                                         device=dev, generator=g)

                def scale(d_out):
                    return torch.empty((E, d_out), dtype=torch.float32,
                                       device=dev).uniform_(0.003, 0.0056, generator=g)

                return {"gate4": packed(D, Fd), "gate_scale": scale(Fd),
                        "down4": packed(Fd, D), "down_scale": scale(D)}
            dt = expert_dtype or self.dtype
            return {"gate": mat((E, D, Fd), dt), "down": mat((E, Fd, D), dt)}

        experts: List[Dict[str, Any]] = []

        def block(i, decoder):
            b: Dict[str, Any] = {
                "ln0": ones(D), "ln_ff": ones(D),
                "q": mat((hd, D)), "k": mat((hd, D)), "v": mat((hd, D)), "o": mat((D, hd)),
            }
            if i == 0:
                b["rel_bias"] = mat((s.rel_buckets, s.num_heads), torch.float32)
            if decoder:
                b["ln_cross"] = ones(D)
                b["cq"], b["ck"], b["cv"] = mat((hd, D)), mat((hd, D)), mat((hd, D))
                b["co"] = mat((D, hd))
            if s.is_sparse(i, decoder):
                b["router"] = mat((E, D), torch.float32, std=0.5)
                if with_experts:
                    experts.append(expert_layer())
            else:
                b["wi"] = mat((Fd, D))
                b["wo"] = mat((D, Fd))
            return b

        params = {
            "embed": mat((s.vocab_size, D)),
            "enc_blocks": [block(i, False) for i in range(s.num_encoder_layers)],
            "enc_final_ln": ones(D),
            "dec_blocks": [block(i, True) for i in range(s.num_decoder_layers)],
            "dec_final_ln": ones(D),
        }
        if not s.tie_embeddings:
            params["lm_head"] = mat((s.vocab_size, D))
        if not with_experts:
            return params, None
        return params, {"layers": experts,
                        "slot_map": torch.arange(E, dtype=torch.int32, device=dev)}

    # ---- attention ------------------------------------------------------
    def _attn(self, b, x, k, v, q_pos, kv_len, bias, prefix=""):
        s = self.spec
        B, T, _ = x.shape
        q = linear(x, b[prefix + "q"]).reshape(B, T, s.num_heads, s.d_kv)
        out = attend(q, k, v, q_pos, kv_len, scale=1.0, causal=False, bias=bias)
        return linear(out.reshape(B, T, -1), b[prefix + "o"])

    def _kv(self, b, h, prefix=""):
        s = self.spec
        B, T, _ = h.shape
        k = linear(h, b[prefix + "k"]).reshape(B, T, s.num_heads, s.d_kv)
        v = linear(h, b[prefix + "v"]).reshape(B, T, s.num_heads, s.d_kv)
        return k, v

    # ---- routing and FF -------------------------------------------------
    def switch_route(self, b, h, margin: int = 0):
        """Capacity-masked top-1 router over h [B, T, D]: (cw [B, T, 1] f32,
        ids [B, T, 1] int32, trace ids). A token's priority is its place
        among the tokens of its sequence routed to the same expert (pad
        tokens count); past ``expert_capacity`` its weight is 0. margin > 0
        widens the trace ids to [B, T, 1 + margin] with the next experts by
        logit, equal logits in ascending expert order (``lax.top_k``'s)."""
        s = self.spec
        logits = linear(h.float(), b["router"])  # [B, T, E]
        probs = torch.softmax(logits, dim=-1)
        idx = torch.argmax(probs, dim=-1)  # the first of equal maxima
        onehot = torch.zeros_like(logits, dtype=torch.int32).scatter_(-1, idx[..., None], 1)
        priority = torch.cumsum(onehot, dim=1)  # over the tokens of a sequence
        keep = (priority <= s.expert_capacity).float()
        keep = keep.gather(-1, idx[..., None])[..., 0]
        maxp = probs.amax(dim=-1)
        cw = (maxp * keep)[..., None]
        ids = idx[..., None].to(torch.int32)
        if margin <= 0:
            return cw, ids, ids
        masked = logits.masked_fill(onehot.bool(), float("-inf"))
        nxt = torch.sort(masked, dim=-1, descending=True, stable=True).indices[..., :margin]
        return cw, ids, torch.cat([ids, nxt.to(torch.int32)], dim=-1)

    def apply_ff(self, x, h, cw, ids, weights, slot_map, biases, impl):
        """x + the routed expert FF of h [B, T, D] (ids, cw [B, T, 1])."""
        B, T, D = h.shape
        y = routed_ffn(self.mesh, h.reshape(B * T, D), ids.reshape(B * T, 1),
                       cw.reshape(B * T, 1), slot_map, weights, self.activation,
                       biases=biases, impl=impl)
        return x + y.reshape(B, T, D)

    def _routed_ff(self, b, h, mli, experts, for_layer, impl):
        """(y, trace ids [B, T, 1 + route_margin])."""
        cw, ids, tids = self.switch_route(b, h, self.route_margin)
        weights, slot_map, biases = for_layer(experts, mli)
        y = self.apply_ff(torch.zeros_like(h), h, cw, ids, weights, slot_map, biases, impl)
        return y, tids

    def _dense_ff(self, b, h):
        a = linear(h, b["wi"])
        a = F.gelu(a, approximate="tanh") if self.spec.dense_act_gelu else torch.relu(a)
        return linear(a, b["wo"])

    # ---- stage protocol (the offload engine drives these) ----------------
    def enc_prelude(self, params, tokens, pad_mask):
        """(x, bias [B, H, T, T] f32: T5 plus pad, q_pos [B, T])."""
        s = self.spec
        B, T = tokens.shape
        x = params["embed"][tokens.long()].to(self.dtype)
        pos = torch.arange(T, dtype=torch.int32, device=tokens.device)
        bias = t5_position_bias(params["enc_blocks"][0]["rel_bias"], pos, pos, True,
                                s.rel_buckets, s.rel_max_distance)
        bias = bias + pad_bias(pad_mask)
        return x, bias, pos.expand(B, T)

    def _enc_attn(self, b, x, bias, q_pos):
        s = self.spec
        h = rms_norm(x, b["ln0"], s.rms_eps)
        k, v = self._kv(b, h)
        x = x + self._attn(b, h, k, v, q_pos, x.shape[1], bias)
        return x, rms_norm(x, b["ln_ff"], s.rms_eps)

    def enc_block_sparse_pre(self, b, x, bias, q_pos):
        """(x, h, cw [B, T, 1], ids [B, T, 1]): attention and routing."""
        x, h = self._enc_attn(b, x, bias, q_pos)
        cw, ids, _ = self.switch_route(b, h)
        return x, h, cw, ids

    def enc_block_dense(self, b, x, bias, q_pos):
        x, h = self._enc_attn(b, x, bias, q_pos)
        return x + self._dense_ff(b, h)

    def enc_final(self, params, x):
        return rms_norm(x, params["enc_final_ln"], self.spec.rms_eps)

    def dec_prelude(self, params, positions, cache_len: int, enc_mask):
        """(self bias [1, H, T, cache_len] from the first row's positions
        [B, T], a device tensor a graph reads at replay; cross bias
        [B, 1, 1, S_enc])."""
        s = self.spec
        k_pos = torch.arange(cache_len, dtype=torch.int32, device=positions.device)
        bias = t5_position_bias(params["dec_blocks"][0]["rel_bias"], positions[0].to(torch.int32),
                                k_pos, False, s.rel_buckets, s.rel_max_distance)
        return bias, pad_bias(enc_mask)

    def row_bias(self, params, row_offsets, cache_len: int):
        """The decoder's self-attention bias [B, H, 1, cache_len] of one step
        at per-row positions ``row_offsets`` [B]: the T5 bucket of
        ``k_pos - row_offsets[b]`` gathered from the relative-bias table on
        the device (no host read)."""
        s = self.spec
        k_pos = torch.arange(cache_len, dtype=torch.int32, device=row_offsets.device)
        rel = k_pos[None, :] - row_offsets.to(torch.int32)[:, None]  # [B, S]
        buckets = t5_relative_bucket(rel, False, s.rel_buckets, s.rel_max_distance)
        table = params["dec_blocks"][0]["rel_bias"]
        return table[buckets.long()].permute(0, 2, 1)[:, :, None, :]  # [B, H, 1, S]

    def dec_embed(self, params, dec_tokens, step=0):
        return params["embed"][dec_tokens.long()].to(self.dtype)

    def _dec_attn(self, b, x, kv, positions, kv_len, bias, ck, cv, cross_bias,
                  row_offsets=None):
        """``kv_len`` (an int or a 0-d tensor) only places the step's K/V, or
        ``row_offsets`` [B] places each row's at its own column; the
        self-attention reads up to the cache's capacity under the causal
        bound of ``positions``, as ``NllbModel._dec_attn`` does."""
        s = self.spec
        B, T, _ = x.shape
        h = rms_norm(x, b["ln0"], s.rms_eps)
        k, v = self._kv(b, h)
        kv = kv.update(k, v, kv_len) if row_offsets is None else kv.update_rows(k, v, row_offsets)
        q = linear(h, b["q"]).reshape(B, T, s.num_heads, s.d_kv)
        a = attend(q, kv.k, kv.v, positions, kv.max_len, scale=1.0, causal=True, bias=bias)
        x = x + linear(a.reshape(B, T, -1), b["o"])
        h = rms_norm(x, b["ln_cross"], s.rms_eps)
        x = x + self._attn(b, h, ck, cv, positions, ck.shape[1], cross_bias, prefix="c")
        return x, rms_norm(x, b["ln_ff"], s.rms_eps), kv

    def dec_block_sparse_pre(self, b, x, kv, positions, kv_len, bias, ck, cv, cross_bias):
        """(x, h, cw [B, T, 1], ids [B, T, 1], kv); the cache is written in
        place."""
        x, h, kv = self._dec_attn(b, x, kv, positions, kv_len, bias, ck, cv, cross_bias)
        cw, ids, _ = self.switch_route(b, h)
        return x, h, cw, ids, kv

    def dec_block_dense(self, b, x, kv, positions, kv_len, bias, ck, cv, cross_bias,
                        row_offsets=None):
        x, h, kv = self._dec_attn(b, x, kv, positions, kv_len, bias, ck, cv, cross_bias,
                                  row_offsets)
        return x + self._dense_ff(b, h), kv

    def dec_final(self, params, x):
        """Logits [B, T, V] f32: the input scaled by d_model ** -0.5 before a
        tied head, the head in f32, as the JAX model."""
        s = self.spec
        x = rms_norm(x, params["dec_final_ln"], s.rms_eps)
        if s.tie_embeddings:
            x = x * (s.d_model ** -0.5)
            w = params["embed"]
        else:
            w = params["lm_head"]
        return linear(x.float(), w.float())

    def cross_kv_block(self, b, enc_out):
        """One decoder block's cross-attention K/V."""
        return self._kv(b, enc_out, prefix="c")

    def cross_kv(self, params, enc_out):
        return [self.cross_kv_block(b, enc_out) for b in params["dec_blocks"]]

    # ---- encoder --------------------------------------------------------
    def encode(self, params, experts, tokens, pad_mask, for_layer, impl="ragged"):
        """tokens [B, T]; pad_mask [B, T] 1 = real. Returns [B, T, D]."""
        s = self.spec
        x, bias, q_pos = self.enc_prelude(params, tokens, pad_mask)
        for i, b in enumerate(params["enc_blocks"]):
            if s.is_sparse(i, False):
                x, h = self._enc_attn(b, x, bias, q_pos)
                y, _ = self._routed_ff(b, h, s.moe_layer_id(i, False), experts, for_layer,
                                       impl)
                x = x + y
            else:
                x = self.enc_block_dense(b, x, bias, q_pos)
        return self.enc_final(params, x)

    # ---- decoder --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[KVCache]:
        s = self.spec
        return [
            KVCache.empty(batch, max_len, s.num_heads, s.d_kv, self.dtype, self.device)
            for _ in range(s.num_decoder_layers)
        ]

    def decode_step(self, params, experts, dec_tokens, positions, kvs, kv_len,
                    enc_mask, cross, for_layer, impl="ragged", row_offsets=None):
        """One decoder step for tokens [B, T] at cache offset ``kv_len`` (an
        int, or a 0-d integer tensor on the device, which a CUDA graph reads
        at replay); writes the step's K/V into ``kvs`` in place. Returns
        (logits [B, T, V] f32, kvs, trace): the routed ids of the decoder's
        sparse layers in order, [L_dec_moe, B, T, 1 + route_margin] int32,
        left on the device (the JAX model returns a list of [B, T] ids at
        margin 0).

        row_offsets [B] (a device int tensor, T must be 1): per-row decode
        positions, as ``NllbModel.decode_step`` takes them; each row's
        self-attention bias comes from its own position (``row_bias``, a
        per-row [B, H, 1, S] bias to K2)."""
        s = self.spec
        B, T = dec_tokens.shape
        bias, cross_bias = self.dec_prelude(params, positions, kvs[0].max_len, enc_mask)
        if row_offsets is not None:
            if T != 1:
                raise ValueError("decode_step: row_offsets needs one token per row")
            bias = self.row_bias(params, row_offsets, kvs[0].max_len)
        x = self.dec_embed(params, dec_tokens, kv_len)
        trace = []
        for i, b in enumerate(params["dec_blocks"]):
            ck, cv = cross[i]
            if s.is_sparse(i, True):
                x, h, kvs[i] = self._dec_attn(b, x, kvs[i], positions, kv_len, bias, ck, cv,
                                              cross_bias, row_offsets)
                y, tids = self._routed_ff(b, h, s.moe_layer_id(i, True), experts, for_layer,
                                          impl)
                x = x + y
                trace.append(tids)
            else:
                x, kvs[i] = self.dec_block_dense(b, x, kvs[i], positions, kv_len, bias, ck, cv,
                                                 cross_bias, row_offsets)
        if trace:
            trace = torch.stack(trace)
        else:
            trace = torch.empty((0, B, T, 1 + self.route_margin), dtype=torch.int32,
                                device=x.device)
        return self.dec_final(params, x), kvs, trace
