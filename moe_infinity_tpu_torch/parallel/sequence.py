"""Sequence-parallel (long-context) prefill, encode and decode over the
``seq`` axis of a mesh, from ``moe_infinity_tpu/parallel/sequence.py``.

The prompt's tokens are split into one contiguous time block per rank of the
axis: every rank embeds its block and runs the whole layer stack on it,
attention crosses blocks through the ring (``ops/ring_attention.py``), and
the MoE FFN runs on the rank's own tokens with replicated expert weights
(``ops.moe.grouped_ffn`` under the caller's ``impl``: K3 under "pallas" on
the card). Activation memory scales 1/s with the ring, so an s-rank ring
prefills an s-times longer prompt. SPMD as the rest of the port's mesh:
every rank calls the same function with the same whole inputs and gets its
own time shard back.

Families: llama-style (Mixtral), MLA (DeepSeek V2/V3: the absorbed latent
reduces to the same ring, keys [c | k_pe] and values c, so the latent cache
itself rides the ring), Grok (softcapped attention, post-attention and
post-MoE norms), Arctic (parallel-residual MLP) and, through ``sp_encode``,
the seq2seq encoders (NLLB, Switch). ``caches_from_sp`` gathers the shards
into regular ``KVCache``s; ``SPDecoder`` keeps them where they landed and
decodes over them with a replicated tail.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from moe_infinity_tpu_torch.models.layers import (
    KVCache,
    apply_rope,
    layer_norm,
    linear,
    rms_norm,
    rope_cos_sin,
    t5_position_bias,
)
from moe_infinity_tpu_torch.ops.moe import grouped_ffn, topk_router
from moe_infinity_tpu_torch.ops.ring_attention import ring_attention, sp_decode_attention
from moe_infinity_tpu_torch.parallel.mesh import SEQ


def _is_mla(model) -> bool:
    return hasattr(model.spec, "kv_lora_rank")


def _block(tokens, mesh, seq_axis, model):
    """This rank's time block of the whole ``tokens`` [B, T] on the model's
    device, and its global positions [B, Tl]."""
    s = mesh.shape[seq_axis]
    tokens = torch.as_tensor(tokens, device=model.device)
    B, T = tokens.shape
    if T % s:
        raise ValueError(f"prompt length {T} not divisible by seq={s}")
    Tl = T // s
    lo = mesh.axis_index(seq_axis) * Tl
    pos = lo + torch.arange(Tl, dtype=torch.int32, device=model.device)
    return tokens[:, lo:lo + Tl], pos.expand(B, Tl)


def _grouped(hn, cw, ids, w, slot_map, biases, act, impl):
    """The routed FFN of hn [B, T, D] (cw, ids [B, T, K])."""
    B, T, D = hn.shape
    K = ids.shape[-1]
    return grouped_ffn(hn.reshape(B * T, D), ids.reshape(B * T, K),
                       cw.reshape(B * T, K).float(), slot_map, w, act,
                       biases=biases, impl=impl).reshape(B, T, D)


def _router(model, pl, hn, normalize):
    """Grok's and Arctic's top-k router over hn [B, T, D]."""
    B, T, _ = hn.shape
    logits = linear(hn.float(), pl["router"])
    cw, ids, _ = topk_router(logits.reshape(B * T, -1), model.spec.top_k, normalize=normalize)
    return cw.reshape(B, T, -1), ids.reshape(B, T, -1)


def _moe_y(model, pl, hn, mli, experts, for_layer, impl):
    """Mixtral's and DeepSeek's routed experts (and DeepSeek's shared ones)."""
    cw, ids = model.route(pl, hn)
    w, slot_map, biases = for_layer(experts, mli)
    y = _grouped(hn, cw, ids, w, slot_map, biases, "silu", impl)
    if getattr(model.spec, "n_shared_experts", 0):
        y = y + model._dense_mlp(hn, pl["shared_gate"], pl["shared_up"], pl["shared_down"])
    return y


def _qkv(model, pl, h, positions, theta):
    """Llama-layout q/k/v projections with rope at ``positions``."""
    spec = model.spec
    B, T, _ = h.shape
    q = linear(h, pl["q"]).reshape(B, T, spec.num_heads, spec.head_dim)
    k = linear(h, pl["k"]).reshape(B, T, spec.num_kv_heads, spec.head_dim)
    v = linear(h, pl["v"]).reshape(B, T, spec.num_kv_heads, spec.head_dim)
    cos, sin = rope_cos_sin(positions, spec.head_dim, theta)
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v


def _mla_qc(model, pl, x, positions):
    """MLA's absorbed query [B, T, H, R + P] f32 (``[q_lat | q_pe]``), the
    latent c [B, T, R] and the rope key k_pe [B, T, 1, P], as
    ``DeepseekV2Model.attn_block``'s unfolded path computes them."""
    from moe_infinity_tpu_torch.models.deepseek_v2 import rope_interleaved

    spec = model.spec
    B, T, _ = x.shape
    h = rms_norm(x, pl["input_norm"], spec.rms_eps)
    if spec.q_lora_rank is None:
        q = linear(h, pl["q"])
    else:
        q = linear(rms_norm(linear(h, pl["q_a"]), pl["q_a_norm"], spec.rms_eps), pl["q_b"])
    q = q.reshape(B, T, spec.num_heads, spec.qk_head_dim)
    q_nope = q[..., :spec.qk_nope_head_dim]
    q_pe = q[..., spec.qk_nope_head_dim:]
    ckv = linear(h, pl["kv_a"])
    c = rms_norm(ckv[..., :spec.kv_lora_rank], pl["kv_a_norm"], spec.rms_eps)
    k_pe = ckv[..., spec.kv_lora_rank:][:, :, None, :]
    cos, sin = model._rope_tables(positions)
    q_pe = rope_interleaved(q_pe, cos, sin)
    k_pe = rope_interleaved(k_pe, cos, sin)
    q_lat = torch.einsum("bthd,hdr->bthr", q_nope.float(), pl["w_uk"].float())
    return torch.cat([q_lat, q_pe.float()], dim=-1), c, k_pe


def _mla_out(model, pl, x, out_lat):
    """x + MLA's output projection of the latent attention [B, T, H, R]."""
    spec = model.spec
    B, T = x.shape[:2]
    out = torch.einsum("bthr,hdr->bthd", out_lat.float(), pl["w_uv"].float())
    return x + linear(out.reshape(B, T, spec.num_heads * spec.v_head_dim).to(model.dtype), pl["o"])


def _post_attn_ffn(model, pl, x, mli, experts, for_layer, impl):
    """Mixtral's and DeepSeek's post-norm FFN: dense for DeepSeek's
    ``first_k_dense_replace`` layers, routed otherwise."""
    hn = rms_norm(x, pl["post_norm"], model.spec.rms_eps)
    if mli is None:
        return x + model._dense_mlp(hn, pl["mlp_gate"], pl["mlp_up"], pl["mlp_down"])
    return x + _moe_y(model, pl, hn, mli, experts, for_layer, impl)


def _grok_ffn(model, pl, x, mli, experts, for_layer, impl):
    spec = model.spec
    hn = rms_norm(x, pl["pre_moe"], spec.rms_eps)
    cw, ids = _router(model, pl, hn, normalize=False)
    w, slot_map, biases = for_layer(experts, mli)
    y = _grouped(hn, cw, ids, w, slot_map, biases, "gelu", impl)
    return x + rms_norm(y, pl["post_moe"], spec.rms_eps)


def _arctic_ffn(model, pl, x, x_pre, mli, experts, for_layer, impl):
    """Arctic's FFN after attention: the dense MLP, or the experts with the
    parallel residual MLP (MoE input taken from the pre-attention x)."""
    spec = model.spec
    if mli is None:
        hn = rms_norm(x, pl["post_norm"], spec.rms_eps)
        return x + model._silu_mlp(hn, pl["mlp_w1"], pl["mlp_w2"], pl["mlp_w3"])
    if spec.parallel_attn_mlp_res:
        hr = rms_norm(x, pl["res_norm"], spec.rms_eps)
        x = x + model._silu_mlp(hr, pl["res_w1"], pl["res_w2"], pl["res_w3"])
        hn = rms_norm(x_pre, pl["post_norm"], spec.rms_eps)
    else:
        hn = rms_norm(x, pl["post_norm"], spec.rms_eps)
    cw, ids = _router(model, pl, hn, normalize=spec.top_k > 1)
    w, slot_map, biases = for_layer(experts, mli)
    return x + _grouped(hn, cw, ids, w, slot_map, biases, "silu", impl)


def sp_prefill(
    model,
    params: Dict[str, Any],
    experts: Dict[str, Any],
    tokens,  # [B, T] whole, T % mesh.shape[seq_axis] == 0
    mesh,
    *,
    for_layer,
    impl: str = "gather",
    seq_axis: str = SEQ,
) -> Tuple[torch.Tensor, List[KVCache]]:
    """Whole-model prefill with the sequence split over ``seq_axis``: this
    rank's time block through every layer, attention over the ring. Returns
    this rank's shards: logits [B, Tl, V] f32 and each layer's KVCache with
    k/v [B, Tl, Hkv, Dh] (MLA: the latent [B, Tl, 1, R] and rope key
    [B, Tl, 1, P])."""
    spec = model.spec
    arch = getattr(model, "arch", None)
    tok, positions = _block(tokens, mesh, seq_axis, model)
    B, Tl = tok.shape

    def ring(q, k, v, **kw):
        return ring_attention(q, k, v, mesh, axis=seq_axis, causal=True, **kw)

    x = model.embed(params, tok)
    kvs = []
    for li in range(spec.num_layers):
        pl = params["layers"][li]
        mli = model.moe_layer_index(li)
        if arch == "grok":
            h = rms_norm(x, pl["pre_attn"], spec.rms_eps)
            q, k, v = _qkv(model, pl, h, positions, 10000.0)
            a = ring(q, k, v, scale=spec.attn_output_multiplier, logit_softcap=spec.max_attn_value)
            x = x + rms_norm(linear(a.reshape(B, Tl, -1), pl["o"]), pl["post_attn"], spec.rms_eps)
            x = _grok_ffn(model, pl, x, mli, experts, for_layer, impl)
        elif arch == "arctic":
            x_pre = x
            h = rms_norm(x, pl["input_norm"], spec.rms_eps)
            q, k, v = _qkv(model, pl, h, positions, spec.rope_theta)
            x = x + linear(ring(q, k, v).reshape(B, Tl, -1), pl["o"])
            x = _arctic_ffn(model, pl, x, x_pre, mli, experts, for_layer, impl)
        elif _is_mla(model):
            q_ring, c, k_pe = _mla_qc(model, pl, x, positions)
            k_ring = torch.cat([c.float(), k_pe[:, :, 0, :].float()], dim=-1)[:, :, None, :]
            out_lat = ring(q_ring, k_ring, c.float()[:, :, None, :],
                           scale=spec.qk_head_dim ** -0.5)  # [B, Tl, H, R]
            x = _mla_out(model, pl, x, out_lat)
            # the decode caches hold (c, k_pe): the latent is the cache
            k, v = c[:, :, None, :], k_pe
            x = _post_attn_ffn(model, pl, x, mli, experts, for_layer, impl)
        else:
            h = rms_norm(x, pl["input_norm"], spec.rms_eps)
            q, k, v = _qkv(model, pl, h, positions, spec.rope_theta)
            x = x + linear(ring(q, k, v).reshape(B, Tl, -1), pl["o"])
            x = _post_attn_ffn(model, pl, x, mli, experts, for_layer, impl)
        kvs.append(KVCache(k.to(model.dtype), v.to(model.dtype)))
    return model.head(params, x), kvs


def sp_encode(
    model,
    params: Dict[str, Any],
    experts: Dict[str, Any],
    tokens,  # [B, T] whole and unpadded, T % mesh.shape[seq_axis] == 0
    mesh,
    *,
    for_layer,
    impl: str = "gather",
    seq_axis: str = SEQ,
) -> torch.Tensor:
    """Sequence-parallel encoder of the seq2seq families: bidirectional ring
    attention, the FFN on this rank's tokens. Switch's T5 bias rides
    ``bias_fn`` from global positions, and its capacity router stays exact
    across blocks: each block's budget for an expert is the capacity less
    the tokens earlier blocks routed to it (an ``all_reduce`` of a
    zero-filled [s, B, E] count table). Returns this rank's block of the
    encoder output [B, Tl, D]."""
    spec = model.spec
    tok, positions = _block(tokens, mesh, seq_axis, model)
    B, Tl = tok.shape
    gpos = positions[0]  # [Tl] global

    def ring(q, k, v, **kw):
        return ring_attention(q, k, v, mesh, axis=seq_axis, causal=False, **kw)

    if hasattr(spec, "d_kv"):  # Switch
        table = params["enc_blocks"][0]["rel_bias"]
        s, me = mesh.shape[seq_axis], mesh.axis_index(seq_axis)

        def bias_fn(qp, kp):
            return t5_position_bias(table, qp, kp, True, spec.rel_buckets, spec.rel_max_distance)

        def capacity_route(b, h):
            """``switch_route`` with the budget earlier blocks left."""
            logits = linear(h.float(), b["router"])  # [B, Tl, E]
            probs = torch.softmax(logits, dim=-1)
            idx = torch.argmax(probs, dim=-1)
            onehot = torch.zeros_like(logits, dtype=torch.int32).scatter_(-1, idx[..., None], 1)
            counts = onehot.new_zeros((s, B, logits.shape[-1]))
            counts[me] = onehot.sum(dim=1)
            prefix = mesh.all_reduce(counts, seq_axis)[:me].sum(dim=0)  # [B, E]
            priority = prefix[:, None, :] + torch.cumsum(onehot, dim=1)
            keep = (priority <= spec.expert_capacity).float().gather(-1, idx[..., None])[..., 0]
            return (probs.amax(dim=-1) * keep)[..., None], idx[..., None].to(torch.int32)

        H, Dk = spec.num_heads, spec.d_kv
        x = params["embed"][tok.long()].to(model.dtype)
        for i, b in enumerate(params["enc_blocks"]):
            h = rms_norm(x, b["ln0"], spec.rms_eps)
            q = linear(h, b["q"]).reshape(B, Tl, H, Dk)
            k = linear(h, b["k"]).reshape(B, Tl, H, Dk)
            v = linear(h, b["v"]).reshape(B, Tl, H, Dk)
            attn = ring(q, k, v, scale=1.0, bias_fn=bias_fn)
            x = x + linear(attn.reshape(B, Tl, H * Dk), b["o"])
            h = rms_norm(x, b["ln_ff"], spec.rms_eps)
            if spec.is_sparse(i, False):
                cw, ids = capacity_route(b, h)
                w, slot_map, biases = for_layer(experts, spec.moe_layer_id(i, False))
                y = model.apply_ff(torch.zeros_like(h), h, cw, ids, w, slot_map, biases, impl)
            else:
                y = model._dense_ff(b, h)
            x = x + y
        return rms_norm(x, params["enc_final_ln"], spec.rms_eps)

    # NLLB / M2M100: pre-LN attention with biases, sinusoidal positions
    # (unpadded: position id = global index + 1 + pad_token_id)
    pos_ids = (gpos + 1 + spec.pad_token_id).long()
    x = (params["embed"][tok.long()].to(model.dtype) * model._scale
         + model._pos_table[pos_ids].to(model.dtype))
    H = spec.num_heads
    Dh = spec.d_model // H
    for i, b in enumerate(params["enc_blocks"]):
        a = b["self_attn"]
        h = layer_norm(x, b["ln0_w"], b["ln0_b"], 1e-5)
        q = linear(h, a["q"], a["qb"]).reshape(B, Tl, H, Dh)
        k = linear(h, a["k"], a["kb"]).reshape(B, Tl, H, Dh)
        v = linear(h, a["v"], a["vb"]).reshape(B, Tl, H, Dh)
        x = x + linear(ring(q, k, v, scale=Dh ** -0.5).reshape(B, Tl, -1), a["o"], a["ob"])
        h = layer_norm(x, b["lnf_w"], b["lnf_b"], 1e-5)
        if spec.is_sparse(i, False):
            cw, ids, _ = model._route_top2(b, h)
            w, slot_map, biases = for_layer(experts, spec.moe_layer_id(i, False))
            x = x + _grouped(h, cw.reshape(B, Tl, -1), ids.reshape(B, Tl, -1), w, slot_map,
                             biases, "relu", impl)
        else:
            x = x + model._dense_ff(b, h)
    return layer_norm(x, params["enc_final_ln_w"], params["enc_final_ln_b"], 1e-5)


def caches_from_sp(sp_kvs: List[KVCache], max_len: int, mesh=None, *,
                   seq_axis: str = SEQ) -> List[KVCache]:
    """The time shards of ``sp_prefill`` gathered over ``seq_axis`` into
    regular decode caches [B, max_len, ...] (zero past the prompt), the same
    on every rank, so generation continues on the regular decode path with
    kv_len = T. mesh None: the caches are whole already (one rank)."""
    s = 1 if mesh is None else mesh.shape[seq_axis]
    out = []
    for c in sp_kvs:
        Tl = c.k.shape[1]
        T = Tl * s
        if T > max_len:
            raise ValueError(f"prefill length {T} exceeds cache {max_len}")
        lo = 0 if mesh is None else mesh.axis_index(seq_axis) * Tl

        def whole(t):
            if mesh is None:
                full = t.new_zeros((t.shape[0], max_len, *t.shape[2:]))
                full[:, :Tl] = t
                return full
            return mesh.gather_rows(t.transpose(0, 1), lo, max_len,
                                    seq_axis).transpose(0, 1).contiguous()

        out.append(KVCache(whole(c.k), whole(c.v)))
    return out


class SPDecoder:
    """Long-context decode over sequence-sharded caches: the prompt's K/V
    stays where ``sp_prefill`` left it, frozen and time-sharded over
    ``seq_axis``; generated tokens go to a small replicated tail of
    ``tail_cap`` columns. Each step runs the single token through every
    layer on every rank: attention merges each rank's partial over its shard
    with two small collectives (``sp_decode_attention``), the tail folds in
    replicated, and the MoE FFN runs replicated on the one token. No K/V
    moves at decode time. Batch 1, greedy (``generate``).

    Families: llama-style (Mixtral), MLA (the latent shard serves as key
    ``[c | k_pe]`` and value ``c``), Grok, Arctic. Eager: no CUDA graph holds
    a collective of the mesh."""

    def __init__(self, model, params: Dict[str, Any], experts: Dict[str, Any], mesh, *,
                 for_layer, impl: str = "gather", tail_cap: int = 64, seq_axis: str = SEQ):
        self.model = model
        self.params = params
        self.experts = experts
        self.mesh = mesh
        self.for_layer = for_layer
        self.impl = impl
        self.tail_cap = int(tail_cap)
        self.seq_axis = seq_axis
        self.s = mesh.shape[seq_axis]
        self.arch = getattr(model, "arch", None)
        self._state = None  # (shards k, shards v, tails k, tails v) after prefill
        self.last_logits = None  # [B, V] f32: the prefill's last position, on every rank

    # ---- one decode step's layer bodies (sp_prefill's, over one token) ----
    def _attend(self, q, li, g, **kw):
        ks, vs, tks, tvs = self._state
        return sp_decode_attention(q, ks[li], vs[li], tks[li], tvs[li], g + 1, self.mesh,
                                   axis=self.seq_axis, **kw)

    def _to_tail(self, li, g, k, v):
        _, _, tks, tvs = self._state
        tks[li][:, g:g + 1] = k.to(tks[li].dtype)
        tvs[li][:, g:g + 1] = v.to(tvs[li].dtype)

    def _layer(self, li, x, pos, g):
        model, spec = self.model, self.model.spec
        pl = self.params["layers"][li]
        mli = model.moe_layer_index(li)
        args = (self.experts, self.for_layer, self.impl)
        B = x.shape[0]
        if self.arch == "grok":
            h = rms_norm(x, pl["pre_attn"], spec.rms_eps)
            q, k, v = _qkv(model, pl, h, pos, 10000.0)
            self._to_tail(li, g, k, v)
            a = self._attend(q, li, g, scale=spec.attn_output_multiplier,
                             logit_softcap=spec.max_attn_value)
            x = x + rms_norm(linear(a.reshape(B, 1, -1), pl["o"]), pl["post_attn"], spec.rms_eps)
            return _grok_ffn(model, pl, x, mli, *args)
        if self.arch == "arctic":
            x_pre = x
            h = rms_norm(x, pl["input_norm"], spec.rms_eps)
            q, k, v = _qkv(model, pl, h, pos, spec.rope_theta)
            self._to_tail(li, g, k, v)
            x = x + linear(self._attend(q, li, g).reshape(B, 1, -1), pl["o"])
            return _arctic_ffn(model, pl, x, x_pre, mli, *args)
        if _is_mla(model):
            q_ring, c, k_pe = _mla_qc(model, pl, x, pos)
            self._to_tail(li, g, c[:, :, None, :], k_pe)
            ks, vs, tks, tvs = self._state
            c_sh, tc = ks[li].float(), tks[li].float()
            out_lat = sp_decode_attention(
                q_ring, torch.cat([c_sh, vs[li].float()], dim=-1), c_sh,
                torch.cat([tc, tvs[li].float()], dim=-1), tc, g + 1, self.mesh,
                axis=self.seq_axis, scale=spec.qk_head_dim ** -0.5)  # [B, 1, H, R]
            x = _mla_out(model, pl, x, out_lat)
            return _post_attn_ffn(model, pl, x, mli, *args)
        h = rms_norm(x, pl["input_norm"], spec.rms_eps)
        q, k, v = _qkv(model, pl, h, pos, spec.rope_theta)
        self._to_tail(li, g, k, v)
        x = x + linear(self._attend(q, li, g).reshape(B, 1, -1), pl["o"])
        return _post_attn_ffn(model, pl, x, mli, *args)

    # ---- public API ------------------------------------------------------
    def prefill(self, tokens) -> int:
        """Sequence-parallel prefill of ``tokens`` [B, T]; keeps this rank's
        K/V shards in place and zeroes the tails. Returns the first greedy
        token id of row 0 (the last rank's last logits, shared with every
        rank: ``last_logits``)."""
        logits, kvs = sp_prefill(self.model, self.params, self.experts, tokens, self.mesh,
                                 for_layer=self.for_layer, impl=self.impl,
                                 seq_axis=self.seq_axis)
        last = torch.zeros_like(logits[:, -1])
        if self.mesh.axis_index(self.seq_axis) == self.s - 1:
            last.copy_(logits[:, -1])
        self.last_logits = self.mesh.all_reduce(last, self.seq_axis)
        B, C = logits.shape[0], self.tail_cap
        ks = [c.k for c in kvs]
        vs = [c.v for c in kvs]
        tks = [k.new_zeros((B, C) + k.shape[2:]) for k in ks]
        tvs = [v.new_zeros((B, C) + v.shape[2:]) for v in vs]
        self._state = (ks, vs, tks, tvs)
        self._T = logits.shape[1] * self.s
        return int(self.last_logits[0].argmax())

    @torch.inference_mode()
    def step(self, token: int, g: int) -> torch.Tensor:
        """One decode step: ``token`` (the g-th generated token, 0-based) at
        global position T + g. Returns logits [B, 1, V] f32."""
        if self._state is None:
            raise RuntimeError("call prefill() first")
        if g >= self.tail_cap:
            raise ValueError(f"decode tail exhausted ({self.tail_cap}); raise tail_cap")
        model = self.model
        B = self._state[0][0].shape[0]
        dev = model.device
        tok = torch.full((B, 1), int(token), dtype=torch.int32, device=dev)
        pos = torch.full((B, 1), self._T + g, dtype=torch.int32, device=dev)
        x = model.embed(self.params, tok)
        for li in range(model.spec.num_layers):
            x = self._layer(li, x, pos, g)
        return model.head(self.params, x)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32, eos_token_id=None) -> np.ndarray:
        """Greedy long-context generation, batch 1: the ring prefills the
        largest prefix whose length the ring divides, the remaining (fewer
        than s) prompt tokens ride decode steps into the tail, and only the
        last of those steps' argmax is read. Returns the whole sequence
        (prompt and generated) as a 1-D numpy array."""
        from moe_infinity_tpu_torch.runtime.generate import eos_hit

        arr = np.atleast_2d(np.asarray(input_ids))
        if arr.shape[0] != 1:
            raise ValueError("SPDecoder.generate supports batch size 1")
        T = arr.shape[1]
        r = T % self.s
        if T - r == 0:
            raise ValueError(f"prompt length {T} is shorter than the ring size {self.s}")
        if r + max_new_tokens > self.tail_cap:
            raise ValueError(f"prompt remainder ({r}) + max_new_tokens "
                             f"({max_new_tokens}) > tail_cap {self.tail_cap}")
        tok = self.prefill(torch.as_tensor(arr[:, :T - r].astype(np.int32)))
        g = 0
        for i in range(r):  # the remainder's prompt tokens -> the tail
            logits = self.step(int(arr[0, T - r + i]), g)
            g += 1
            if i == r - 1:
                tok = int(logits[0, -1].argmax())
        generated = [tok]
        while len(generated) < max_new_tokens and not (
                eos_token_id is not None and eos_hit(tok, eos_token_id)):
            logits = self.step(tok, g)
            g += 1
            tok = int(logits[0, -1].argmax())
            generated.append(tok)
        return np.concatenate([arr[0], np.asarray(generated, np.int64)])
