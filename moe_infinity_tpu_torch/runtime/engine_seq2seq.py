"""Offload engine for encoder-decoder MoE models (NLLB, Switch), from
``moe_infinity_tpu/runtime/engine_seq2seq.py``.

The engine owns the block loop and drives the model's stage protocol
(``enc_prelude`` / ``enc_block_*`` / ``dec_block_*`` / ``*_final``).

**Per-layer path** (the encoder always; the decoder with
``speculative=False``). At every MoE layer the router's expert ids come back
to the host; the engine then

1. updates the EAMC tracer and runs the predictor (activation-aware),
2. plans and enqueues prefetch for the next layers (priority queue, arena),
3. acquires the routed experts - blocking only on true misses - and runs
   the grouped FFN (K3) over the arena's slots with the layer's slot row,

across the whole encoder -> decoder layer sequence (the cache policy's
encoder/decoder topology scoring applies). After the encoder the whole
decoder tier is planned from the EAMC prediction, so the first decode steps
find their experts landing.

**Speculative path** (``speculative=True``, the main path's default). A
decode step (``spec_block`` 1) or a block of k greedy steps runs on the
device against the arena's current slots with no host read inside: each
next token is the argmax of the logits and stays on the device, and the
model returns the routed ids of every decoder MoE layer as one trace,
widened by ``route_margin`` runner-ups. The host reads the trace once per
dispatch, verifies it against the residency the dispatch saw and runs again
after loading the misses (``runtime/engine.py``). Blocks replay whole
(``MOE_SPEC_BLOCK_MODE=whole``, the default) or accept their verified
prefix (``prefix``). A capacity error halves the block; at k = 1 it falls
back to the per-layer path for good. k hill-climbs on executions per
committed token over the halving chain. The K/V cache is written in place:
an execution that is not accepted leaves garbage in the columns it wrote,
and the next one rewrites each of them before any kernel reads it.

**CUDA graphs** (``graphs=True``, the default on the card). The speculative
whole step and each k-step block run as one CUDA graph per step shape
(``runtime/graphs.py``), captured once and replayed at every dispatch and
request of that shape, as the JAX engine jits ``_spec_step`` and caches
one jitted block per k. The start token, the step offset and the slot rows
are the graph's device inputs; the engine owns the K/V caches per
(B, capacity) and the cross K/V and encoder mask per (B, S_enc), and copies
each request's into them. A replay is queued on the compute stream inside
the dispatch's ``dispatch_snapshot`` scope, after its waits and before its
end event, so the arena's fences keep their meaning. ``graphs=False`` runs
the same launches eagerly (for comparison); on CPU tensors the steps run
eagerly unless a capture backend is given. The per-layer path and the
encoder stay eager: they read the routing on the host at every MoE layer.

**Direct-tier layers.** A MoE layer whose whole expert set sits in one
segment of a layer-aligned pinned tier (``align_rows=num_experts``) runs its
grouped FFN straight from that segment (``PinnedExpertTier.layer_stack``,
copied to the card once) with an identity slot row: no slot, no fetch, no
miss, no replay for that layer, on every path. ``max_direct_layers`` takes
the deepest such layers (None: all; 0: none). Speculative verification and
prefetch leave them out.

**Stream decode** (``stream_decode=True``, with a tier and
``speculative=True``). Greedy blocks of k steps (k = 1 too) gather each
decoder MoE layer's routed experts from the tier inside the step
(``ops/stream.py``: ``stream_gather``, then K3 over the scratch), so the
decoder needs no arena residency and has no replay. The trace is read once
per dispatch; a layer that routed more than U distinct experts (or an
unstaged one) at some step had those contributions masked, so the block
runs again at twice the U, which stays (one graph per (k, U)). At U = E an
unstaged expert raises. The encoder keeps the per-layer arena path.

One difference from the JAX engine: only capacity errors
(``is_spec_capacity_error``) change the path. JAX treats any other
``RuntimeError`` as transient and single-steps or falls back to the
per-layer path, and turns stream decode off for good when a stream
dispatch fails; here a failed CUDA launch is a ``RuntimeError`` too, so
such errors are raised, never hidden behind another path.

Sampled requests (``runtime/sampling.py``) take the speculative step or
the per-layer path, one token a step; the k-step blocks stay plain greedy,
as in JAX.

**Dense-layer paging** (``dense_arena``): the blocks page through a
``DenseLayerArena`` over the combined stack (encoder block i -> layer i,
decoder block i -> ``n_enc + i``; ``params["enc_blocks"]`` and
``["dec_blocks"]`` may then be one-element stubs holding only what the
preludes read, Switch's ``rel_bias``), on the per-layer path only, eagerly.

**Host fallback** (``host_fallback``): on the per-layer path, a routed
expert that is not resident within ``host_fallback_timeout`` reads the
arena's zero slot and runs on the host (``runtime/host_exec.py``). Under the
arena's ``dequant_on_write`` no layer runs direct from the tier and stream
decode is refused: the tier holds the stored codes, the slots the compute
dtype.
"""

from __future__ import annotations

import os
import time as _time
from typing import Optional

import numpy as np
import torch

from moe_infinity_tpu_torch.memory.prefetch_plan import plan_prefetch
from moe_infinity_tpu_torch.runtime.engine import (
    _LayerClock,
    _split_arena_tree,
    apply_over_slots,
    is_spec_capacity_error,
    make_block_monitor,
    margin_key_fns,
    quantize_block,
    record_block_log,
    run_speculative,
    run_speculative_block,
    spec_trace_and_prefetch,
    speculative_stats,
    split_margin_columns,
)
from moe_infinity_tpu_torch.runtime.generate import (
    GenerationResult,
    _bucket_len,
    _Clock,
    _Logprobs,
    eos_hit,
)
from moe_infinity_tpu_torch.runtime.graphs import (
    DecodeBuffers,
    GraphCache,
    flat_tensors,
    graph_cache,
    step_positions,
)
from moe_infinity_tpu_torch.runtime.sampling import Sampler, params_from_kwargs
from moe_infinity_tpu_torch.utils.logger import get_logger

_log = get_logger("engine_seq2seq")


def stack_depths(spec) -> tuple:
    """(encoder blocks, decoder blocks) of a seq2seq spec: ``NllbSpec`` names
    them ``encoder_layers``/``decoder_layers``, ``SwitchSpec``
    ``num_encoder_layers``/``num_decoder_layers``."""
    return tuple(getattr(spec, name, 0) or getattr(spec, "num_" + name, 0)
                 for name in ("encoder_layers", "decoder_layers"))


def _block_steps(model, params, impl: str, k: int):
    """The body of a k-step greedy block: ``steps(for_layer, tok0, step0,
    kvs, mask, cross) -> (toks [B, k], trace [L_moe, B, k, K'])``, step0 an
    int or a 0-d tensor on the device."""

    def steps(for_layer, tok0, step0, kvs, mask, cross):
        B = tok0.shape[0]
        tok, toks, traces = tok0, [], []
        for j in range(k):
            step = step0 + j
            logits, kvs, trace = model.decode_step(
                params, None, tok, step_positions(step, B, tok.device), kvs, step, mask,
                cross, for_layer, impl)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            traces.append(trace)  # [L, B, 1, K']
        return torch.cat(toks, dim=1), torch.cat(traces, dim=2)

    return steps


def _slot_layers(tree, rows, direct, ident):
    """``for_layer`` of a step over the arena's slot tensors and the slot rows
    ``[L, E]``; a direct-tier layer (``direct``: MoE layer -> (weights,
    biases)) gets its stack and the identity row ``ident``."""
    weights, biases = _split_arena_tree(tree)

    def for_layer(_experts, mli):
        d = direct.get(mli)
        if d is not None:
            return d[0], ident, d[1]
        return weights, rows[mli], biases

    return for_layer


class Seq2SeqOffloadEngine(_LayerClock):
    # the hill-climb of the block size: blocks per probed size, and blocks
    # between two probes of the whole halving chain
    _PROBE_BLOCKS = 3
    _REPROBE_EVERY = 24

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
        max_replays: Optional[int] = None,
        spec_block: int = 1,
        route_margin: int = 2,
        max_direct_layers: Optional[int] = None,
        stream_decode: bool = False,
        stream_unique: int = 32,
        dense_arena=None,
        host_fallback: bool = False,
        host_fallback_timeout: float = 0.25,
        graphs: bool = True,
        graph_backend=None,
    ):
        """impl: the grouped-FFN implementation of one-token decode steps
        (``"pallas"`` is K3); prefill_impl: that of the encoder and of
        steps of more than one token (default ``impl``).
        max_direct_layers: of the layers a layer-aligned tier stages whole,
        how many (the deepest) run direct from the tier (None: all, 0: none).
        stream_decode: decode greedy blocks by gathering the routed experts
        from the tier in the step (needs the tier and speculative);
        stream_unique: the first U of that gather (at least 2).
        speculative: decode by speculative steps (``spec_block`` 1) or
        k-step blocks; max_replays bounds the executions of one step or
        block (default: from the MoE depth and k); route_margin: runner-up
        experts the trace carries for prefetch (``MOE_ROUTE_MARGIN``
        overrides it).
        graphs: run the speculative steps and blocks as CUDA graphs on the
        card (False runs them eagerly); graph_backend: the capture backend
        (default ``CudaGraphBackend`` on a CUDA model; on the CPU the steps
        run eagerly unless one is given). On the card an ``impl`` that
        cannot be captured ("ragged") raises ``ValueError`` unless graphs is
        False.
        dense_arena: a ``DenseLayerArena`` over the combined block stack
        (forces the per-layer path); host_fallback: a routed expert not
        resident within ``host_fallback_timeout`` seconds runs on the host
        (needs the arena's zero slot)."""
        if dense_arena is not None and speculative:
            raise ValueError(
                "speculative decode requires the dense side resident; "
                "disable speculative_decode when dense paging is active")
        self.dense_arena = dense_arena
        self.host_fallback = host_fallback
        self.host_fallback_timeout = host_fallback_timeout
        self.host_exec_count = 0
        self._host_exec = None
        if host_fallback:
            if arena.zero_slot is None:
                raise ValueError("host_fallback requires an arena built with reserve_zero_slot=True")
            from moe_infinity_tpu_torch.runtime.host_exec import HostExpertExecutor, activation_for

            self._host_exec = HostExpertExecutor(arena.store, activation_for(arena.store.meta))
        # the pod subclass sets arena_multiplicity to the expert axis's size:
        # the constraint is on the global slot count
        if arena.num_slots * getattr(self, "arena_multiplicity", 1) < model.spec.num_experts:
            raise ValueError("arena must fit one full MoE layer of experts")
        tier = arena._tier
        if stream_decode:
            if tier is None or not tier.fields:
                raise ValueError("stream_decode requires a pinned tier")
            if arena.dequant_on_write:
                raise ValueError("stream_decode computes from the tier's stored dtype; "
                                 "disable dequant_on_write")
            if not speculative:
                raise ValueError("stream_decode rides the block-decode loop; pass "
                                 "speculative=True")
            route_margin = 0  # a margin column would count as a routed expert
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
        self.speculative = speculative
        self.max_replays = max_replays
        self.spec_block = max(1, spec_block)
        # the configured block size: a capacity error halves spec_block and
        # caps the hill-climb (_k_cap), which probes the halving chain below
        self._spec_block_cfg = self.spec_block
        self.adaptive_spec = True
        self._k_trace: list = []
        self._ppt_ewma: dict = {}
        self._probe_queue: Optional[list] = None
        self._chosen: Optional[tuple] = None
        self._blocks_since_probe = 0
        self._k_cap = self._spec_block_cfg
        # executions per speculative step or block, in order
        self.replay_counts: list = []
        # cumulative seconds of the speculative loop by phase: lock_wait_s,
        # dispatch_s (snapshot, launches, trace read), replay_hook_s,
        # acquire_s, trace_prefetch_s
        self.phase_timings: dict = {}
        # misses that only an eviction inside a dispatch's scope made, and
        # the executions they alone rejected (runtime/engine.py::_tally_lease)
        self.lease_counts: dict = {}
        self.spec_log: list = []
        # (tokens committed, seconds) of each decode iteration
        self.step_times: list = []
        # decoder steps run on the device, replays included
        self.executed_steps = 0
        # tier records the stream gathers read, over every executed step
        self.stream_records = 0
        E = model.spec.num_experts
        self._identity = torch.arange(E, dtype=torch.int32, device=model.device)
        # ---- direct-tier layers: role -> the layer's [E, ...] stack on the card
        self._direct: dict = {}
        # (a dequant-on-write arena's slots hold the compute dtype, the
        # tier the stored codes: those keep the slot path)
        if tier is not None and not arena.dequant_on_write:
            candidates = [mli for mli in range(arena.num_layers)
                          if tier.layer_stack(mli, promote=False) is not None]
            if max_direct_layers is not None:
                # deepest first: deep layers churn most and settle last
                candidates = candidates[max(0, len(candidates) - max_direct_layers):]
            for mli in candidates:
                stack = tier.layer_stack(mli)
                self._direct[str(mli)] = {akey: stack[tail]
                                          for akey, tail in arena._role_to_tail.items()
                                          if akey in arena._arena}
        self._direct_mlis = frozenset(int(k) for k in self._direct)
        self._direct_split = {int(k): _split_arena_tree(d) for k, d in self._direct.items()}
        if self._direct:
            _log.info("direct-tier dispatch for %d/%d MoE layers: %s", len(self._direct),
                      arena.num_layers, sorted(self._direct_mlis))
        # ---- stream decode: the tier's segments, read in the step
        self._stream = bool(stream_decode)
        if self._stream:
            self._stream_fields = {akey: list(tier.fields[tail])
                                   for akey, tail in arena._role_to_tail.items()
                                   if akey in arena._arena}
            self._stream_rec_rows = {mli: tier._rec_row[mli * E:(mli + 1) * E].copy()
                                     for mli in range(arena.num_layers)}
            self._stream_rows_dev = {mli: torch.from_numpy(r).to(model.device)
                                     for mli, r in self._stream_rec_rows.items()}
            self._stream_seg_rows = tier._seg_rows
            self._stream_U = max(2, int(stream_unique))
            self._stream_src_cache: dict = {}
            self._stream_block_cache: dict = {}
            # the segments' device addresses, checked and made once, shared by
            # every layer's source
            self._stream_table = None
            if model.device.type == "cuda":
                self._stream_table = self._stream_source(0, self._stream_U).device_table(
                    model.device)
            _log.info("stream decode: in-step gather from %d tier segments, U0=%d",
                      len(next(iter(self._stream_fields.values()))), self._stream_U)
        if speculative:
            model.route_margin = max(0, int(os.environ.get("MOE_ROUTE_MARGIN", route_margin)))
        # one graph per step shape (the JAX engine's jit cache), and the
        # buffers those graphs read by address
        # (paged blocks run eagerly: they take the per-layer path only)
        self.graphs: Optional[GraphCache] = graph_cache(
            graphs and dense_arena is None, graph_backend, model.device, impl)
        if self.graphs is not None:
            self._buffers = DecodeBuffers(model)
            self._param_tensors = flat_tensors(params)
        self._spec_block_cache: dict = {}
        s = model.spec
        self._n_enc, self._n_dec = stack_depths(s)
        # decoder sparse-layer ids, in order
        self.dec_mlis = [
            s.moe_layer_id(i, True) for i in range(self._n_dec) if s.is_sparse(i, True)
        ]

    def reset_arena(self, arena, *, speculative: Optional[bool] = None, tracer=None,
                    predictor=None) -> None:
        """Swap the expert arena (and optionally the speculative mode and
        tracer/predictor) in place."""
        self.arena = arena
        if speculative is not None:
            self.speculative = speculative
        if tracer is not None:
            self.tracer = tracer
            self.predictor = predictor
            self.prefetch = self.prefetch and predictor is not None
        self._layer_seconds = None
        self._last_layer_t = None

    def is_resident(self, key) -> bool:
        """Residency counting direct-tier layers: the planners never order a
        fetch of an expert that is computed in place."""
        return key[0] in self._direct_mlis or self.arena.is_resident(key)

    # ---- shared expert acquire/apply --------------------------------------
    def init_cache(self, batch: int, cap: int):
        return self.model.init_cache(batch, cap)

    def decode_state(self, batch: int, cap: int, mask, cross):
        """(kvs, mask, cross) of one request's decode. With graphs: the
        engine's own buffers of this shape, which its graphs read, with the
        request's mask and cross K/V copied in; else a new cache."""
        if self.graphs is None:
            return self.init_cache(batch, cap), mask, cross
        return self._buffers.take(batch, cap, mask, cross)

    def _moe(self, x, h, cw, ids, mli, seq_ids):
        self._tick_layer_clock()
        ids_np = ids.cpu().numpy()  # [B, T, K]; the host waits for the routing
        keys = [(mli, int(e)) for e in np.unique(ids_np)]
        self._plan_layer(ids_np, mli, seq_ids)
        return self._moe_dispatch(x, h, cw, ids, ids_np, keys, mli)

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

    def _moe_dispatch(self, x, h, cw, ids, ids_np, keys, mli):
        """Acquire + apply one MoE layer against the slot arena, with the
        host fallback for experts that miss its deadline (a direct-tier
        layer: straight from its stack, nothing acquired)."""
        impl = self._impl if h.shape[1] == 1 else self._pimpl
        if mli in self._direct_mlis:
            weights, biases = self._direct_split[mli]
            return self.model.apply_ff(x, h, cw, ids, weights, self._identity, biases, impl)
        return apply_over_slots(
            self, keys, mli, h, cw, ids_np,
            lambda weights, row, biases: self.model.apply_ff(
                x, h, cw, ids, weights, row, biases, impl))

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
            score, first_dec - 1, lookahead=None,
            budget=self._current_budget() * max(1, self.spec_block),
            is_resident=self.is_resident,
        )
        if orders:
            self.arena.prefetch(orders)

    # ---- dense-layer paging: block i of the encoder is layer i of the
    # dense arena, block i of the decoder layer n_enc + i --------------------
    def _enc_block_paged(self, i, x, bias, q_pos, seq_ids):
        da, m, s = self.dense_arena, self.model, self.model.spec
        slot = da.acquire(i)
        try:
            b = da.layer_view(i, slot)
            if s.is_sparse(i, False):
                x, h, cw, ids = m.enc_block_sparse_pre(b, x, bias, q_pos)
                # the expert acquire blocks inside the block's protection:
                # the block cannot be evicted mid-layer
                return self._moe(x, h, cw, ids, s.moe_layer_id(i, False), seq_ids)
            return m.enc_block_dense(b, x, bias, q_pos)
        finally:
            da.release(i)

    def _dec_block_paged(self, i, x, kv, positions, step, bias, ck, cv, cross_bias, seq_ids):
        da, m, s = self.dense_arena, self.model, self.model.spec
        li = self._n_enc + i
        slot = da.acquire(li)
        try:
            b = da.layer_view(li, slot)
            if s.is_sparse(i, True):
                x, h, cw, ids, kv = m.dec_block_sparse_pre(b, x, kv, positions, step, bias,
                                                           ck, cv, cross_bias)
                return self._moe(x, h, cw, ids, s.moe_layer_id(i, True), seq_ids), kv
            return m.dec_block_dense(b, x, kv, positions, step, bias, ck, cv, cross_bias)
        finally:
            da.release(li)

    def _cross_paged(self, enc_out):
        """Cross-attention K/V of each decoder block, each on its slot."""
        da, out = self.dense_arena, []
        for i in range(self._n_dec):
            li = self._n_enc + i
            slot = da.acquire(li)
            try:
                out.append(self.model.cross_kv_block(da.layer_view(li, slot), enc_out))
            finally:
                da.release(li)
        return out

    def run_encoder(self, input_ids, mask, seq_ids=None):
        """Per-layer (acquire/prefetch) encoder pass + cross K/V."""
        model, params, s = self.model, self.params, self.model.spec
        x, bias, q_pos = model.enc_prelude(params, input_ids, mask)
        for i in range(self._n_enc):
            if self.dense_arena is not None:
                x = self._enc_block_paged(i, x, bias, q_pos, seq_ids)
                continue
            b = params["enc_blocks"][i]
            if s.is_sparse(i, False):
                x, h, cw, ids = model.enc_block_sparse_pre(b, x, bias, q_pos)
                x = self._moe(x, h, cw, ids, s.moe_layer_id(i, False), seq_ids)
            else:
                x = model.enc_block_dense(b, x, bias, q_pos)
        enc_out = model.enc_final(params, x)
        if self.dense_arena is not None:
            return enc_out, self._cross_paged(enc_out)
        return enc_out, model.cross_kv(params, enc_out)

    def decode_step(self, cur_tok, step: int, kvs, mask, cross, seq_ids=None):
        """One per-layer decode step of tokens [B, 1] at cache offset
        ``step``; writes the K/V into ``kvs`` in place. Returns logits
        [B, 1, V] f32."""
        model, params, s = self.model, self.params, self.model.spec
        B = cur_tok.shape[0]
        self.executed_steps += 1
        positions = torch.full((B, 1), step, dtype=torch.int32, device=model.device)
        bias, cross_bias = model.dec_prelude(params, positions, kvs[0].max_len, mask)
        x = model.dec_embed(params, cur_tok, step)
        for i in range(self._n_dec):
            ck, cv = cross[i]
            if self.dense_arena is not None:
                x, kvs[i] = self._dec_block_paged(i, x, kvs[i], positions, step, bias, ck, cv,
                                                  cross_bias, seq_ids)
                continue
            b = params["dec_blocks"][i]
            if s.is_sparse(i, True):
                x, h, cw, ids, kvs[i] = model.dec_block_sparse_pre(
                    b, x, kvs[i], positions, step, bias, ck, cv, cross_bias)
                x = self._moe(x, h, cw, ids, s.moe_layer_id(i, True), seq_ids)
            else:
                x, kvs[i] = model.dec_block_dense(
                    b, x, kvs[i], positions, step, bias, ck, cv, cross_bias)
        return model.dec_final(params, x)

    # ---- speculative decode -----------------------------------------------
    def _closes_over(self, tree, kvs, mask, cross) -> list:
        """Every tensor a step's graph reads by address (the direct-tier
        stacks too)."""
        return [*self._param_tensors, *flat_tensors(tree), *flat_tensors(self._direct),
                *flat_tensors(kvs), mask, *flat_tensors(cross)]

    def _spec_step(self, tree, slot_rows, tok, positions, step, kvs, mask, cross):
        """One whole decoder step over the slots: (logits, kvs, trace). With
        graphs, one replay of the step's graph (``positions`` then comes from
        the step, a device input); the logits are its static output."""
        self.executed_steps += 1
        model, params, impl = self.model, self.params, self._impl
        direct, ident = self._direct_split, self._identity

        def run(tok, step, rows, positions):
            logits, _, trace = model.decode_step(
                params, None, tok, positions, kvs, step, mask, cross,
                _slot_layers(tree, rows, direct, ident), impl,
            )
            return logits, trace

        if self.graphs is None:
            logits, trace = run(tok, step, slot_rows, positions)
        else:
            logits, trace = self.graphs.run(
                "step",
                lambda tok, step, rows: run(tok, step, rows,
                                            step_positions(step, tok.shape[0], tok.device)),
                {"tok": tok, "step": step, "rows": slot_rows},
                self._closes_over(tree, kvs, mask, cross))
        return logits, kvs, trace

    def _spec_block_fn(self, k: int):
        """A k-step greedy block over the slots: ``block(tree, slot_rows,
        tok0 [B, 1], step0, kvs, mask, cross)`` queues k decode steps, each
        fed the argmax of the step before, and returns (toks [B, k], kvs,
        trace [L_moe, B, k, 2 + margin]), all on the device. The block's
        body is cached per k, as the JAX engine caches its jitted block; with
        graphs each call is one replay of the block's graph, whose outputs
        the next replay overwrites. (The cache holds no reference to the
        engine, so that dropping the engine frees its arena at once.)"""
        steps = self._spec_block_cache.get(k)
        if steps is None:
            steps = self._spec_block_cache[k] = _block_steps(
                self.model, self.params, self._impl, k)

        def block(tree, slot_rows, tok0, step0, kvs, mask, cross):
            self.executed_steps += k
            direct, ident = self._direct_split, self._identity
            if self.graphs is None:
                toks, trace = steps(_slot_layers(tree, slot_rows, direct, ident), tok0, step0,
                                    kvs, mask, cross)
            else:
                toks, trace = self.graphs.run(
                    f"block{k}",
                    lambda tok, step, rows: steps(_slot_layers(tree, rows, direct, ident), tok,
                                                  step, kvs, mask, cross),
                    {"tok": tok0, "step": step0, "rows": slot_rows},
                    self._closes_over(tree, kvs, mask, cross), steps=k)
            return toks, kvs, trace

        return block

    def _direct_filtered(self, key_fn, margin_fn, mlis):
        """(key_fn, margin_fn) with direct-tier layers dropped from
        verification and acquisition (their experts are always in place) and
        from margin prefetch; with no direct layer, unchanged."""
        if not self._direct_mlis:
            return key_fn, margin_fn
        base = key_fn or (lambda ids, j: np.unique(ids[j]))
        direct = self._direct_mlis

        def kf(ids, j):
            return np.empty(0, np.int64) if mlis[j] in direct else base(ids, j)

        mf = None
        if margin_fn is not None:
            def mf(ids_np):
                return [key for key in margin_fn(ids_np) if key[0] not in direct]

        return kf, mf

    # ---- stream decode ----------------------------------------------------
    def _stream_source(self, mli: int, U: int):
        from moe_infinity_tpu_torch.ops.stream import StreamSource

        return StreamSource(self._stream_fields, self._stream_rows_dev[mli],
                            self._stream_seg_rows, max_unique=U, impl=self._impl,
                            table=self._stream_table)

    def _stream_sources(self, U: int) -> dict:
        """MoE layer -> its ``StreamSource`` at gather width U (made once per U)."""
        src = self._stream_src_cache.get(U)
        if src is None:
            src = self._stream_src_cache[U] = {
                mli: self._stream_source(mli, U) for mli in self._stream_rec_rows}
        return src

    def _stream_block_fn(self, k: int):
        """A k-step greedy block whose MoE layers gather their routed experts
        from the tier: ``block(U, tok0 [B, 1], step0, kvs, mask, cross)`` ->
        (toks [B, k], kvs, trace [L_moe, B, k, K]), on the device. With
        graphs each call is one replay of the graph of (k, U), as the JAX
        engine compiles one block per (k, U)."""
        steps = self._stream_block_cache.get(k)
        if steps is None:
            steps = self._stream_block_cache[k] = _block_steps(
                self.model, self.params, self._impl, k)

        def block(U, tok0, step0, kvs, mask, cross):
            self.executed_steps += k
            sources, ident = self._stream_sources(U), self._identity

            def for_layer(_experts, mli):
                return sources[mli], ident, None

            if self.graphs is None:
                toks, trace = steps(for_layer, tok0, step0, kvs, mask, cross)
            else:
                reads = [*self._param_tensors, *flat_tensors(kvs), mask, *flat_tensors(cross),
                         *self._stream_rows_dev.values(), self._stream_table]
                toks, trace = self.graphs.run(
                    f"stream{k}u{U}",
                    lambda tok, step: steps(for_layer, tok, step, kvs, mask, cross),
                    {"tok": tok0, "step": step0}, [t for t in reads if t is not None],
                    steps=k)
            return toks, kvs, trace

        return block

    def _stream_block(self, cur_tok, step: int, kvs, mask, cross, dec_mlis, seq_ids, k: int):
        """k greedy decode steps with the experts gathered in the step. The
        only re-dispatch is the host's exact check of the trace: a (layer,
        step) that routed more than U distinct experts, or an unstaged one,
        had those contributions masked, so the block runs again at twice the
        U, which stays (routing width belongs to the workload, not to one
        block). Returns (tokens [B, k] numpy, kvs)."""
        from moe_infinity_tpu_torch.ops.stream import stream_overflow, stream_records

        E = self.model.spec.num_experts
        fn = self._stream_block_fn(k)
        execs = 0
        while True:
            t0 = _time.perf_counter()
            toks, kvs, tr = fn(self._stream_U, cur_tok, step, kvs, mask, cross)
            ids_np = tr.cpu().numpy()  # [L, B, k, K]
            toks = toks.cpu().numpy().copy()  # a copy: the next replay overwrites the output
            self.phase_timings["dispatch_s"] = (
                self.phase_timings.get("dispatch_s", 0.0) + _time.perf_counter() - t0)
            execs += 1
            self.stream_records += sum(
                stream_records(ids_np[j, :, jj], self._stream_U, self._stream_rec_rows[mli])
                for j, mli in enumerate(dec_mlis) for jj in range(k))
            over = any(stream_overflow(ids_np[j, :, jj], self._stream_U,
                                       self._stream_rec_rows[mli])
                       for j, mli in enumerate(dec_mlis) for jj in range(k))
            if not over:
                break
            if self._stream_U >= E:
                raise RuntimeError("stream decode: an unstaged expert was routed at U=E; "
                                   "stage the full decoder tier or disable stream_decode")
            self._stream_U = min(E, self._stream_U * 2)
            _log.info("stream decode U escalated to %d", self._stream_U)
        self.replay_counts.append(execs)
        if self.tracer is not None and seq_ids:
            for j, mli in enumerate(dec_mlis):
                for b, sid in enumerate(seq_ids):
                    if sid is not None:
                        self.tracer.update_entry(sid, ids_np[j, b].ravel(), mli)
        return toks, kvs

    def _trace_and_prefetch(self, top, dec_mlis, seq_ids, k, extra_orders=()):
        t0 = _time.perf_counter()
        spec_trace_and_prefetch(
            self, top, dec_mlis, seq_ids,
            plan_floor=dec_mlis[0] - 1 if dec_mlis else -1,
            budget_scale=k, extra_orders=extra_orders,
        )
        self.phase_timings["trace_prefetch_s"] = (
            self.phase_timings.get("trace_prefetch_s", 0.0) + _time.perf_counter() - t0)

    def _speculative_block(self, cur_tok, step: int, kvs, mask, cross, dec_mlis, seq_ids,
                           k: int):
        """k greedy decode steps as one speculative block. ``whole`` (the
        default ``MOE_SPEC_BLOCK_MODE``) replays the whole block on a miss;
        ``prefix`` accepts the verified prefix and runs the suffix again.
        Under stream decode, a stream block instead. Returns (tokens [B, k]
        numpy, kvs)."""
        if self._stream:
            return self._stream_block(cur_tok, step, kvs, mask, cross, dec_mlis, seq_ids, k)
        margin = self.model.route_margin
        if os.environ.get("MOE_SPEC_BLOCK_MODE", "whole") == "whole":
            fn = self._spec_block_fn(k)

            def run(tree, slot_rows):
                return fn(tree, slot_rows, cur_tok, step, kvs, mask, cross)

            key_fn, margin_fn = self._direct_filtered(
                *margin_key_fns(dec_mlis, margin), dec_mlis)
            limit = self.max_replays or (len(dec_mlis) + 2 + k)
            on_replay, blog = make_block_monitor(self, dec_mlis, margin_fn=margin_fn)
            (toks, kvs), ids_np, execs = run_speculative(
                self.arena, dec_mlis, run, limit, key_fn=key_fn, on_replay=on_replay,
                timings=self.phase_timings, counters=self.lease_counts,
            )
            record_block_log(self, blog)
            self.replay_counts.append(execs)
            top, _ = split_margin_columns(ids_np, margin)
            self._trace_and_prefetch(
                top.reshape(top.shape[0], top.shape[1], -1), dec_mlis, seq_ids, k,
                extra_orders=margin_fn(ids_np) if margin_fn else ())
            # a copy: the next dispatch replays the graph whose output this is
            # (on the CPU, .numpy() shares it)
            return toks.cpu().numpy().copy(), kvs

        def dispatch(tree, slot_rows, cur, j0, kk, kvs_):
            return self._spec_block_fn(kk)(tree, slot_rows, cur, step + j0, kvs_, mask, cross)

        limit = self.max_replays or (len(dec_mlis) + 2) * k
        toks, kvs, execs, acc_ids = run_speculative_block(
            self.arena, dec_mlis, dispatch, k, limit, cur_tok, kvs, margin=margin,
            skip_mlis=self._direct_mlis, timings=self.phase_timings, counters=self.lease_counts,
        )
        self.replay_counts.append(execs)
        self._trace_and_prefetch(acc_ids.reshape(acc_ids.shape[0], acc_ids.shape[1], -1),
                                 dec_mlis, seq_ids, k)
        return toks, kvs

    def _speculative_step(self, cur_tok, positions, step: int, kvs, mask, cross, dec_mlis,
                          seq_ids):
        """One decode step as one speculative execution over the slots,
        replayed until its routed experts were all resident. Returns
        (logits, kvs)."""

        def run(tree, slot_rows):
            return self._spec_step(tree, slot_rows, cur_tok, positions, step, kvs, mask, cross)

        margin = self.model.route_margin
        key_fn, margin_fn = self._direct_filtered(*margin_key_fns(dec_mlis, margin), dec_mlis)
        limit = self.max_replays or (len(dec_mlis) + 2)
        (logits, kvs), ids_np, execs = run_speculative(
            self.arena, dec_mlis, run, limit, key_fn=key_fn, timings=self.phase_timings,
            counters=self.lease_counts)
        self.replay_counts.append(execs)
        top, _ = split_margin_columns(ids_np, margin)
        self._trace_and_prefetch(top, dec_mlis, seq_ids, 1,
                                 extra_orders=margin_fn(ids_np) if margin_fn else ())
        return logits, kvs

    def _halving_chain(self) -> list:
        chain, k = [], min(self._spec_block_cfg, self._k_cap)
        while k >= 1:
            chain.append(k)
            if k == 1:
                break
            k //= 2
        return chain

    def _adapt_spec_block(self, k: Optional[int] = None, tokens: Optional[int] = None) -> None:
        """After a block (or step): hill-climb the block size on measured
        executions per committed token. Probe each size of the halving chain
        for ``_PROBE_BLOCKS`` blocks, keep the cheapest, and probe again every
        ``_REPROBE_EVERY`` blocks or when the kept size's cost rises 1.5x
        above its cost when chosen. A block of s steps costs at least 1/s
        per token, so a size that cannot beat the best measured one is not
        probed."""
        if not self.replay_counts:
            return
        k = k or self.spec_block
        toks = tokens or k
        ppt = self.replay_counts[-1] / max(1, toks)
        old = self._ppt_ewma.get(k)
        self._ppt_ewma[k] = ppt if old is None else 0.7 * old + 0.3 * ppt
        self._k_trace.append(k)
        if len(self._k_trace) > 512:
            del self._k_trace[: len(self._k_trace) - 512]
        if not self.adaptive_spec:
            return
        self._blocks_since_probe += 1
        chain = self._halving_chain()
        if len(chain) == 1:
            self.spec_block = chain[0]
            return
        while self._probe_queue:
            s = self._probe_queue.pop(0)
            best = min(self._ppt_ewma.values(), default=None)
            if best is not None and best <= 1.0 / s:
                continue
            self.spec_block = s
            return
        if self._chosen is None:
            if self._probe_queue is None:  # the first block: start a probe
                self._probe_queue = [s for s in chain for _ in range(self._PROBE_BLOCKS)]
                self.spec_block = self._probe_queue.pop(0)
                return
            # the probe has measured every size: choose
            scored = {s: self._ppt_ewma[s] for s in chain if s in self._ppt_ewma}
            best = min(scored, key=scored.get)
            self._chosen = (best, scored[best])
            self._blocks_since_probe = 0
            self.spec_block = best
            _log.info("speculative block chosen k=%d (executions/token %s)", best,
                      {s: round(v, 2) for s, v in sorted(scored.items())})
            return
        cur_k, chosen_ppt = self._chosen
        self.spec_block = cur_k
        cur = self._ppt_ewma.get(cur_k, chosen_ppt)
        if self._blocks_since_probe >= self._REPROBE_EVERY or cur > 1.5 * chosen_ppt:
            # the regime may have moved either way: probe afresh
            self._probe_queue = [s for s in chain for _ in range(self._PROBE_BLOCKS)]
            self._chosen = None
            self._ppt_ewma = {}
            self._blocks_since_probe = 0
            self.spec_block = self._probe_queue.pop(0)
            _log.info("speculative block re-probing (from k=%d)", cur_k)

    def _degrade_block(self, err) -> None:
        """A capacity error: halve the block and cap the hill-climb there."""
        self.spec_block = max(1, self.spec_block // 2)
        self._k_cap = self.spec_block
        self._probe_queue = None
        self._chosen = None
        self._ppt_ewma = {}
        _log.warning("speculative block decode degraded to k=%d (%s)", self.spec_block, err)

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
        temperature: float = 0.0,
        do_sample: Optional[bool] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        repetition_penalty: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        logprobs: int = 0,
        logit_bias=None,
        seed: int = 0,
        cache_len: Optional[int] = None,
    ) -> GenerationResult:
        """Decode ``max_new_tokens`` per row, each token picked by the sampler
        (``runtime/sampling.py``); plain greedy requests run in speculative
        k-step blocks when ``spec_block`` > 1. cache_len: the decoder KV
        capacity (default: bucketed from max_new_tokens). ``stats`` of the
        result: encode_ms and decode_ms on the device's timeline, and
        decode_steps, the tokens committed per row."""
        sp = params_from_kwargs(
            temperature=temperature, do_sample=do_sample, top_k=top_k, top_p=top_p,
            min_p=min_p, repetition_penalty=repetition_penalty,
            presence_penalty=presence_penalty, frequency_penalty=frequency_penalty,
            logprobs=logprobs, logit_bias=logit_bias,
        )
        sampler, sstate, lps = Sampler(sp), None, _Logprobs(sp.logprobs)
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
        kvs, mask, cross = self.decode_state(B, cap, mask, cross)
        out = np.full((B, max_new_tokens + 1), pad_token_id, dtype=np.int64)
        out[:, 0] = start
        finished = np.zeros(B, dtype=bool)
        num_gen = np.zeros(B, dtype=np.int64)
        cur_tok = torch.full((B, 1), start, dtype=torch.int32, device=dev)
        dec_mlis = self.dec_mlis
        self.step_times = []
        # decode-window counter snapshot: decode_window_stats() isolates this
        # generate()'s decode phase from the encoder's one-shot misses
        self._dw0 = self.arena.hit_stats()
        ns = self.arena.policy.node_stats
        self._dw_miss0 = ns["misses"].copy()
        self._dw_visit0 = ns["visits"].copy()
        self._dw_evict0 = ns["evictions"].copy()
        step = steps = 0
        while step < max_new_tokens:
            it0 = _time.perf_counter()
            # stream decode takes the block path at k = 1 too: its block is
            # the in-step gather, with no arena verification
            if self.speculative and (self.spec_block > 1 or self._stream) and sp.trivial:
                k = quantize_block(max_new_tokens - step, self.spec_block)
                try:
                    toks, kvs = self._speculative_block(cur_tok, step, kvs, mask, cross,
                                                        dec_mlis, seq_ids, k)
                except RuntimeError as e:
                    if not is_spec_capacity_error(e):
                        raise
                    self._degrade_block(e)
                    continue
                self._adapt_spec_block(k=k)
                for jj in range(k):
                    nxt = toks[:, jj].astype(np.int64)
                    out[~finished, step + jj + 1] = nxt[~finished]
                    num_gen[~finished] += 1
                    if eos_token_id is not None:
                        finished |= eos_hit(nxt, eos_token_id)
                        if finished.all():
                            break
                # EOS can end the batch inside the block: count what was kept
                steps = step + jj + 1
                self.step_times.append((jj + 1, _time.perf_counter() - it0))
                if finished.all():
                    break
                cur_tok = torch.as_tensor(toks[:, -1:], dtype=torch.int32).to(dev)
                step += k
                continue
            logits = None
            if self.speculative:
                positions = torch.full((B, 1), step, dtype=torch.int32, device=dev)
                try:
                    logits, kvs = self._speculative_step(cur_tok, positions, step, kvs, mask,
                                                         cross, dec_mlis, seq_ids)
                    # after a degradation to k = 1 the hill-climb may grow k
                    self._adapt_spec_block(k=1, tokens=1)
                except RuntimeError as e:
                    if not is_spec_capacity_error(e):
                        raise
                    _log.warning("speculative decode disabled (%s); falling back to the "
                                 "per-layer path", e)
                    self.speculative = False
            if logits is None:
                logits = self.decode_step(cur_tok, step, kvs, mask, cross, seq_ids)
            if sstate is None:
                sstate = sampler.init(B, logits.shape[-1], prompt_ids=np.full((B, 1), start),
                                      seed=seed, device=dev)
            sout, sstate = sampler(logits[:, -1, :], sstate)
            lps.record(sout)
            nxt = sout.token.cpu().numpy().astype(np.int64)
            out[~finished, step + 1] = nxt[~finished]
            num_gen[~finished] += 1
            steps = step + 1
            self.step_times.append((1, _time.perf_counter() - it0))
            if eos_token_id is not None:
                finished |= eos_hit(nxt, eos_token_id)
                if finished.all():
                    break
            cur_tok = torch.as_tensor(nxt[:, None], dtype=torch.int32).to(dev)
            step += 1
        t2 = clock.mark()
        if self.tracer is not None and seq_ids:
            for sid in seq_ids:
                self.tracer.finish_entry(sid)
        return GenerationResult(
            sequences=out[:, : int(num_gen.max()) + 1],
            num_generated=num_gen,
            stats={"encode_ms": clock.ms(t0, t1), "decode_ms": clock.ms(t1, t2),
                   "decode_steps": steps},
            **lps.fields(),
        )

    def stats(self) -> dict:
        out = self.arena.hit_stats()
        out.update(speculative_stats(self.replay_counts))
        if self.dense_arena is not None:
            out.update(self.dense_arena.stats())
        if self.host_fallback:
            out["host_exec_count"] = self.host_exec_count
        return out

    def graph_stats(self) -> dict:
        """Captures, replays and capture seconds of the engine's graphs
        (empty when it runs eagerly)."""
        return self.graphs.stats() if self.graphs is not None else {}

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
