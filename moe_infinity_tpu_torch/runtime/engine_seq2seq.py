"""Offload engine for encoder-decoder MoE models (NLLB), from
``moe_infinity_tpu/runtime/engine_seq2seq.py``: the per-layer path.

The engine owns the block loop and drives the model's stage protocol
(``enc_prelude`` / ``enc_block_*`` / ``dec_block_*`` / ``*_final``). At every
MoE layer the router's expert ids come back to the host; the engine then

1. updates the EAMC tracer and runs the predictor (activation-aware),
2. plans and enqueues prefetch for the next layers (priority queue, arena),
3. acquires the routed experts - blocking only on true misses - and runs
   the grouped FFN (K3) over the arena's slots with the layer's slot row,

across the whole encoder -> decoder layer sequence (the cache policy's
encoder/decoder topology scoring applies). After the encoder the whole
decoder tier is planned from the EAMC prediction, so the first decode steps
find their experts landing.

Not ported (each raises ``NotImplementedError``): speculative whole-step and
k-step decode (ROADMAP queue-1 items 8, 9.2-9.3), direct-tier layers (9.4),
stream decode (13), dense-layer paging (16), the host fallback (8) and
sampled decode (11).
"""

from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np
import torch

from moe_infinity_tpu_torch.memory.prefetch_plan import adaptive_prefetch_budget, plan_prefetch
from moe_infinity_tpu_torch.runtime.engine import _split_arena_tree
from moe_infinity_tpu_torch.runtime.generate import (
    GenerationResult,
    _bucket_len,
    _Clock,
    eos_hit,
    require_greedy,
)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported (ROADMAP queue-1 item {item})")


class Seq2SeqOffloadEngine:
    def __init__(
        self,
        model,
        params,
        arena,
        *,
        tracer=None,
        predictor=None,
        prefetch: bool = True,
        lookahead: int = 3,
        prefetch_budget: Optional[int] = None,
        impl: str = "ragged",
        prefill_impl: Optional[str] = None,
        adaptive_budget: bool = True,
        speculative: bool = False,
        max_direct_layers: Optional[int] = 0,
        stream_decode: bool = False,
        dense_arena=None,
        host_fallback: bool = False,
    ):
        """impl: the grouped-FFN implementation of one-token decode steps
        (``"pallas"`` is K3); prefill_impl: that of the encoder and of
        steps of more than one token (default ``impl``).
        max_direct_layers: 0 keeps every layer on the arena; any other value
        asks for direct-tier layers, which are not ported and raise when the
        tier holds a layer that could serve them."""
        if speculative:
            raise _not_ported("speculative decode", "8 and 9.2-9.3")
        if stream_decode:
            raise _not_ported("stream_decode", "13")
        if dense_arena is not None:
            raise _not_ported("dense_arena (paging of the dense layers)", "16")
        if host_fallback:
            raise _not_ported("host_fallback", "8")
        if arena.num_slots < model.spec.num_experts:
            raise ValueError("arena must fit one full MoE layer of experts")
        tier = arena._tier
        if max_direct_layers != 0 and tier is not None and any(
            tier.direct_segment(mli) is not None for mli in range(arena.num_layers)
        ):
            raise _not_ported("direct-tier dispatch (layers staged whole in the tier)", "9.4")
        self.model = model
        self.params = params
        self.arena = arena
        self.tracer = tracer
        self.predictor = predictor
        self.prefetch = prefetch and predictor is not None
        self.lookahead = lookahead
        self.prefetch_budget = prefetch_budget or max(1, arena.num_slots // 2)
        self.adaptive_budget = adaptive_budget
        self._impl = impl
        self._pimpl = prefill_impl or impl
        self._layer_seconds = None
        self._last_layer_t = None
        s = model.spec
        self._n_enc = s.encoder_layers
        self._n_dec = s.decoder_layers
        # decoder sparse-layer ids, in order
        self.dec_mlis = [
            s.moe_layer_id(i, True) for i in range(s.decoder_layers) if s.is_sparse(i, True)
        ]

    def reset_arena(self, arena, *, speculative: Optional[bool] = None, tracer=None,
                    predictor=None) -> None:
        """Swap the expert arena (and optionally tracer/predictor) in place."""
        if speculative:
            raise _not_ported("speculative decode", "8 and 9.2-9.3")
        self.arena = arena
        if tracer is not None:
            self.tracer = tracer
            self.predictor = predictor
            self.prefetch = self.prefetch and predictor is not None
        self._layer_seconds = None
        self._last_layer_t = None

    def is_resident(self, key) -> bool:
        return self.arena.is_resident(key)

    # ---- shared expert acquire/apply --------------------------------------
    def _tick_layer_clock(self):
        t = _time.perf_counter()
        if self._last_layer_t is not None:
            dt = t - self._last_layer_t
            self._layer_seconds = (
                dt if self._layer_seconds is None else 0.8 * self._layer_seconds + 0.2 * dt
            )
        self._last_layer_t = t

    def _current_budget(self) -> int:
        if not self.adaptive_budget:
            return self.prefetch_budget
        return adaptive_prefetch_budget(
            self._layer_seconds,
            self.arena.fetch_seconds_ewma,
            self.arena.num_workers,
            self.lookahead,
            self.prefetch_budget,
        )

    def init_cache(self, batch: int, cap: int):
        return self.model.init_cache(batch, cap)

    def _moe(self, x, h, cw, ids, mli, seq_ids):
        self._tick_layer_clock()
        ids_np = ids.cpu().numpy()  # [B, T, K]; the host waits for the routing
        keys = [(mli, int(e)) for e in np.unique(ids_np)]
        self._plan_layer(ids_np, mli, seq_ids)
        return self._moe_dispatch(x, h, cw, ids, keys, mli)

    def _plan_layer(self, ids_np, mli, seq_ids):
        """Trace this layer's routing and enqueue lookahead prefetch."""
        if self.tracer is None or not seq_ids:
            return
        if self.prefetch:
            score = None
            for b, sid in enumerate(seq_ids):
                score = self.predictor.predict(sid, ids_np[b], mli)
            self.arena.set_context(mli, self.tracer.get_entry_decoder(seq_ids[0]).matrix)
            orders = plan_prefetch(
                score, mli,
                lookahead=self.lookahead, budget=self._current_budget(),
                is_resident=self.is_resident,
            )
            if orders:
                self.arena.prefetch(orders)
        else:
            for b, sid in enumerate(seq_ids):
                self.tracer.update_entry(sid, ids_np[b], mli)

    def _moe_dispatch(self, x, h, cw, ids, keys, mli):
        """Acquire + apply one MoE layer against the slot arena."""
        self.arena.acquire(keys, mli)
        # a fresh host copy of the row, uploaded synchronously: the compute
        # stream holds no queued work here (the routed ids were just read)
        row = torch.from_numpy(self.arena.slot_map(mli)).to(self.model.device)
        with self.arena.locked_tree(keys) as tree:
            weights, biases = _split_arena_tree(tree)
            impl = self._impl if h.shape[1] == 1 else self._pimpl
            x = self.model.apply_ff(x, h, cw, ids, weights, row, biases, impl)
        self.arena.release(keys)
        return x

    def _prefetch_decoder_tier(self, seq_ids) -> None:
        """Encode->decode transition prefetch: plan the whole decoder tier
        from the EAMC prediction (full depth) so the first decode steps find
        their experts resident."""
        if not (self.prefetch and seq_ids and self.dec_mlis):
            return
        first_dec = self.dec_mlis[0]
        # the encoder's last MoE routing sharpens the first decoder row
        # through the cross-boundary transition counts
        ent = self.tracer.get_entry(seq_ids[0])
        obs = {ent.last_layer: ent.last_experts} if ent.last_experts is not None else {}
        score = self.predictor.predict_block(seq_ids[0], obs, from_layer=first_dec)
        self.arena.set_context(first_dec, self.tracer.get_entry_decoder(seq_ids[0]).matrix)
        orders = plan_prefetch(
            score, first_dec - 1, lookahead=None, budget=self._current_budget(),
            is_resident=self.is_resident,
        )
        if orders:
            self.arena.prefetch(orders)

    def run_encoder(self, input_ids, mask, seq_ids=None):
        """Per-layer (acquire/prefetch) encoder pass + cross K/V."""
        model, params, s = self.model, self.params, self.model.spec
        x, bias, q_pos = model.enc_prelude(params, input_ids, mask)
        for i in range(self._n_enc):
            b = params["enc_blocks"][i]
            if s.is_sparse(i, False):
                x, h, cw, ids = model.enc_block_sparse_pre(b, x, bias, q_pos)
                x = self._moe(x, h, cw, ids, s.moe_layer_id(i, False), seq_ids)
            else:
                x = model.enc_block_dense(b, x, bias, q_pos)
        enc_out = model.enc_final(params, x)
        return enc_out, model.cross_kv(params, enc_out)

    def decode_step(self, cur_tok, step: int, kvs, mask, cross, seq_ids=None):
        """One per-layer decode step of tokens [B, 1] at cache offset
        ``step``; writes the K/V into ``kvs`` in place. Returns logits
        [B, 1, V] f32."""
        model, params, s = self.model, self.params, self.model.spec
        B = cur_tok.shape[0]
        positions = torch.full((B, 1), step, dtype=torch.int32, device=model.device)
        bias, cross_bias = model.dec_prelude(params, positions, kvs[0].max_len, mask)
        x = model.dec_embed(params, cur_tok, step)
        for i in range(self._n_dec):
            ck, cv = cross[i]
            b = params["dec_blocks"][i]
            if s.is_sparse(i, True):
                x, h, cw, ids, kvs[i] = model.dec_block_sparse_pre(
                    b, x, kvs[i], positions, step, bias, ck, cv, cross_bias)
                x = self._moe(x, h, cw, ids, s.moe_layer_id(i, True), seq_ids)
            else:
                x, kvs[i] = model.dec_block_dense(
                    b, x, kvs[i], positions, step, bias, ck, cv, cross_bias)
        return model.dec_final(params, x)

    # ---- generation -------------------------------------------------------
    @torch.inference_mode()
    def generate(
        self,
        input_ids: np.ndarray,
        max_new_tokens: int = 32,
        *,
        attention_mask: Optional[np.ndarray] = None,
        eos_token_id: Optional[int] = 1,
        pad_token_id: int = 0,
        decoder_start_token_id: Optional[int] = None,
        cache_len: Optional[int] = None,
        **sampling,
    ) -> GenerationResult:
        """Greedy decode of ``max_new_tokens`` per row. ``sampling`` takes
        the JAX signature's sampling keywords; any that asks for more than
        argmax raises NotImplementedError. cache_len: the decoder KV
        capacity (default: bucketed from max_new_tokens). ``stats`` of the
        result: encode_ms and decode_ms on the device's timeline."""
        require_greedy(**sampling)
        model, s = self.model, self.model.spec
        dev = model.device
        input_ids = np.atleast_2d(np.asarray(input_ids))
        B, T = input_ids.shape
        seq_ids = [self.tracer.create_entry() for _ in range(B)] if self.tracer is not None else None
        start = decoder_start_token_id if decoder_start_token_id is not None \
            else s.decoder_start_token_id
        mask = (torch.as_tensor(attention_mask, dtype=torch.float32).to(dev)
                if attention_mask is not None
                else torch.ones(B, T, dtype=torch.float32, device=dev))
        clock = _Clock(dev)
        t0 = clock.mark()
        enc_out, cross = self.run_encoder(
            torch.as_tensor(input_ids, dtype=torch.int32).to(dev), mask, seq_ids)
        # warm the decoder's predicted hot set NOW: these fetches overlap
        # the first decode step
        self._prefetch_decoder_tier(seq_ids)
        t1 = clock.mark()

        cap = cache_len or _bucket_len(max_new_tokens + 1)
        if cap < max_new_tokens + 1:
            raise ValueError(
                f"cache_len {cap} cannot hold max_new_tokens={max_new_tokens} (+1 start token)"
            )
        kvs = self.init_cache(B, cap)
        out = np.full((B, max_new_tokens + 1), pad_token_id, dtype=np.int64)
        out[:, 0] = start
        finished = np.zeros(B, dtype=bool)
        num_gen = np.zeros(B, dtype=np.int64)
        cur_tok = torch.full((B, 1), start, dtype=torch.int32, device=dev)
        # decode-window counter snapshot: decode_window_stats() isolates this
        # generate()'s decode phase from the encoder's one-shot misses
        self._dw0 = self.arena.hit_stats()
        ns = self.arena.policy.node_stats
        self._dw_miss0 = ns["misses"].copy()
        self._dw_visit0 = ns["visits"].copy()
        self._dw_evict0 = ns["evictions"].copy()
        steps = 0
        for step in range(max_new_tokens):
            logits = self.decode_step(cur_tok, step, kvs, mask, cross, seq_ids)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy().astype(np.int64)
            out[~finished, step + 1] = nxt[~finished]
            num_gen[~finished] += 1
            steps = step + 1
            if eos_token_id is not None:
                finished |= eos_hit(nxt, eos_token_id)
                if finished.all():
                    break
            cur_tok = torch.as_tensor(nxt[:, None], dtype=torch.int32).to(dev)
        t2 = clock.mark()
        if self.tracer is not None and seq_ids:
            for sid in seq_ids:
                self.tracer.finish_entry(sid)
        return GenerationResult(
            sequences=out[:, : int(num_gen.max()) + 1],
            num_generated=num_gen,
            stats={"encode_ms": clock.ms(t0, t1), "decode_ms": clock.ms(t1, t2),
                   "decode_steps": steps},
        )

    def stats(self) -> dict:
        return self.arena.hit_stats()

    def decode_window_stats(self) -> dict:
        """Counter deltas since the last generate()'s decode loop began: the
        decode-regime hit rate plus per-MoE-layer miss/visit attribution."""
        if not hasattr(self, "_dw0"):
            return {}
        now = self.arena.hit_stats()
        d = {k: now.get(k, 0) - self._dw0.get(k, 0)
             for k in ("visits", "hits", "misses", "evictions")}
        d["decode_hit_rate"] = d["hits"] / d["visits"] if d["visits"] else 0.0
        ns = self.arena.policy.node_stats
        miss = ns["misses"] - self._dw_miss0
        visit = ns["visits"] - self._dw_visit0
        d["miss_by_layer"] = miss.sum(axis=1).astype(int).tolist()
        d["visit_by_layer"] = visit.sum(axis=1).astype(int).tolist()
        # churn attribution: a key with BOTH evictions and misses inside the
        # window is (to first order) a churn victim; fresh misses are
        # routing drift the planner failed to cover
        evict = ns["evictions"] - self._dw_evict0
        churn = (evict > 0) & (miss > 0)
        d["miss_churn"] = int(miss[churn].sum())
        d["miss_fresh"] = int(miss[~churn].sum())
        # working set vs capacity; hot/cold evictions separate "displaced
        # something in use" from "prefetched, never used, displaced"
        d["distinct_routed"] = int((visit > 0).sum())
        d["evict_hot"] = int(evict[(evict > 0) & (visit > 0)].sum())
        d["evict_cold"] = int(evict[(evict > 0) & (visit == 0)].sum())
        return d

    def node_stats(self) -> dict:
        return self.arena.node_stats()

    def hit_rate(self) -> float:
        return self.arena.policy.stats.hit_rate
