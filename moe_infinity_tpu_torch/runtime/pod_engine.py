"""Offload serving across ranks, from ``moe_infinity_tpu/runtime/pod_engine.py``.

The steppers that compose the pod pieces (``parallel/pod.py``: coordinate-
affine arenas, the slot-row exchange, the host fallback) into what the facade
serves under ``multihost`` (``entrypoints/api.py``).

Execution model: every rank runs this same program on the same inputs
(SPMD), one process per rank. The dense stages run whole on every rank (the
dense weights are not sharded: Mixtral is built with ``shard_dense=False``),
so the activations are the same on every rank. At each MoE layer the routed
ids come back to every rank's host alike, each rank warms its coordinate's
share in its arena, the ranks exchange their slot fragments and agree on
residency, and the model's grouped FFN (``ops/moe.py::routed_ffn``: K3 over
the rank's own slots) sums the ranks' contributions. An expert that misses
the host fallback's deadline reads -1 on every rank, and every rank adds the
same host-computed delta.

Under a mesh the engines run eagerly: a process group's collectives (gloo
stages CUDA tensors through the host) cannot be captured in a CUDA graph, so
``graphs=True`` raises, as ``decode_scan`` does under a mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from moe_infinity_tpu_torch.memory.prefetch_plan import plan_prefetch
from moe_infinity_tpu_torch.parallel.pod import PodOffloadExecutor, PodSpecView
from moe_infinity_tpu_torch.runtime.engine import (
    _decoder_block_steps,
    _LayerClock,
    _split_arena_tree,
    is_spec_capacity_error,
    run_speculative,
    spec_trace_and_prefetch,
    speculative_stats,
)
from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("pod_engine")


def _check_pod_model(model, graphs: bool, name: str) -> None:
    if model.mesh is None or model.mesh.shape["expert"] < 2:
        raise ValueError(f"{name} needs a model built with an expert-axis mesh (model.mesh)")
    if getattr(model, "tp", 1) > 1:
        raise ValueError(f"{name} keeps the dense weights whole on every rank: build the model "
                         "with shard_dense=False")
    if graphs:
        raise ValueError(f"{name}: a mesh's collectives cannot be captured in a CUDA graph "
                         "(gloo stages them through the host); pass graphs=False")


def _plan_and_prefetch(engine, ids_np, mli, seq_ids) -> None:
    """Trace one layer's routing and, with prefetch on, order the next
    layers' likely experts on each rank's own coordinate (both engines'
    per-layer planning)."""
    if engine.tracer is None or not seq_ids:
        return
    if engine.prefetch:
        score = None
        for b, sid in enumerate(seq_ids):
            score = engine.predictor.predict(sid, ids_np[b], mli)
        engine.executor.set_context(mli, engine.tracer.get_entry_decoder(seq_ids[0]).matrix)
        orders = plan_prefetch(score, mli, lookahead=engine.lookahead,
                               budget=engine._current_budget(),
                               is_resident=engine.executor.is_resident)
        if orders:
            engine.executor.prefetch(orders)
    else:
        for b, sid in enumerate(seq_ids):
            engine.tracer.update_entry(sid, ids_np[b], mli)


def _pod_apply(ex, mli, keys, h, cw, ids_np, apply, row_keys=None):
    """One MoE layer through the executor: ``ensure_step``, then ``apply(
    weights, row, biases)`` over this rank's slots, then the host deltas of
    the experts that are -1 in the exchanged row (the same on every rank),
    then ``release_step``."""
    slot_row, _local_miss = ex.ensure_step(mli, keys, row_keys=row_keys)
    if ex.dp == 1:
        missing = [k for k in keys if slot_row[k[1]] < 0]
    else:
        missing = [(d, k) for d in range(ex.dp) for k in row_keys[d] if slot_row[d, k[1]] < 0]
    row = torch.from_numpy(np.ascontiguousarray(slot_row)).to(h.device)
    try:
        with ex.dispatch_leases() as tree:
            weights, biases = _split_arena_tree(tree)
            x = apply(weights, row, biases)
        if missing:
            delta = (ex.host_delta if ex.dp == 1 else ex.host_delta_rows)(
                mli, missing, h.cpu(), cw.cpu(), ids_np)
            x = x + delta.to(device=x.device, dtype=x.dtype)
    finally:
        ex.release_step(keys, row_keys=row_keys)
    return x


class PodOffloadEngine(_LayerClock):
    """Decoder-only offload stepper of ``Generator`` over an
    ``expert``-axis mesh (``data x model x expert``; the batch splits over
    ``data`` in the grouped FFN). ``model`` must be built with ``mesh=`` (and
    Mixtral with ``shard_dense=False``) so that its MoE blocks run through
    ``grouped_ffn_ep``.

    Two protocols: per layer (the default), one exchange per MoE layer
    before its dispatch, L_moe barrier joins a token; speculative, whole
    decode steps and k-step greedy blocks (``decode_block``) run against a
    pod-wide snapshot (``PodSpecView``), verified from its shared resident
    set and run again on a miss: a converged block joins one or two
    barriers in all. The host fallback is a per-layer feature. Only
    capacity errors change the path (as ``OffloadEngine``): one turns the
    speculative path off on every rank alike."""

    def __init__(
        self,
        model,
        params,
        executor: PodOffloadExecutor,
        *,
        tracer=None,
        predictor=None,
        prefetch: bool = True,
        lookahead: int = 3,
        prefetch_budget: Optional[int] = None,
        adaptive_budget: bool = True,
        impl: str = "ragged",
        speculative: bool = False,
        spec_block: int = 1,
        max_replays: Optional[int] = None,
        graphs: bool = False,
    ):
        _check_pod_model(model, graphs, "PodOffloadEngine")
        self.model = model
        self.params = params
        self.executor = executor
        self.tracer = tracer
        self.predictor = predictor
        self.prefetch = prefetch and predictor is not None
        self.lookahead = lookahead
        self.prefetch_budget = prefetch_budget or max(1, executor.s_local // 2)
        self.adaptive_budget = adaptive_budget
        self._impl = impl
        self._layer_seconds: Optional[float] = None
        self._last_layer_t: Optional[float] = None
        self.speculative = speculative
        self.spec_block = max(1, spec_block)
        self.max_replays = max_replays
        self.replay_counts: list = []
        self._spec_block_cache: dict = {}
        # the budget probes, and the snapshot facade of the speculative runners
        self.arena = PodSpecView(executor)
        self._moe_lis = [mli for mli in map(model.moe_layer_index, range(model.spec.num_layers))
                         if mli is not None]

    # ---- speculative decode --------------------------------------------------
    def _spec_run(self, tokens, positions, kv_caches, kv_len):
        model, params, impl = self.model, self.params, self._impl

        def run(tree, slot_rows):
            weights, biases = _split_arena_tree(tree)
            logits, _, (t_ids, t_w) = model.forward(
                params, None, tokens, positions, kv_caches, kv_len,
                for_layer=lambda _experts, mli: (weights, slot_rows[mli], biases), impl=impl)
            return logits, t_w, t_ids

        return run

    def decode_block(self, tok, pos: int, kv_caches, k: int, seq_ids=None):
        """k greedy decode steps from ``tok`` [B, 1] at cache column ``pos``
        as one speculative block over the pod snapshot (the whole block runs
        again on a miss). Returns (tokens [B, k] numpy, kv_caches); a
        capacity error (a coordinate's arena cannot hold its share of the
        block's union) is raised on every rank for the caller to halve k."""
        steps = self._spec_block_cache.get(k)
        if steps is None:
            steps = self._spec_block_cache[k] = _decoder_block_steps(
                self.model, self.params, self._impl, k)

        def run(tree, slot_rows):
            toks, tr = steps(tree, slot_rows, tok, pos, kv_caches)
            return toks, kv_caches, tr.reshape(tr.shape[0], tr.shape[1], -1)

        limit = self.max_replays or (len(self._moe_lis) + 2 + k)
        (toks, kvs), ids_np, execs = run_speculative(self.arena, self._moe_lis, run, limit)
        self.replay_counts.append(execs)
        spec_trace_and_prefetch(self, ids_np, self._moe_lis, seq_ids, budget_scale=k)
        return toks.cpu().numpy().copy(), kvs

    # ---- stepper protocol ------------------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        return self.model.init_cache(batch, max_len)

    def begin_sequences(self, batch: int) -> Optional[List[str]]:
        if self.tracer is None:
            return None
        return [self.tracer.create_entry() for _ in range(batch)]

    def end_sequences(self, seq_ids: Optional[Sequence[str]]) -> None:
        if self.tracer is None or not seq_ids:
            return
        for sid in seq_ids:
            self.tracer.finish_entry(sid)

    def forward(self, tokens, positions, kv_caches: List, kv_len, seq_ids=None):
        """One step of tokens [B, T] at cache column ``kv_len``: (logits
        [B, T, V] f32, the caches, router trace (ids [L_moe, B, T, K],
        weights)). A one-token step with ``speculative`` runs whole against
        the pod snapshot; anything else runs layer by layer."""
        model, ex = self.model, self.executor
        if self.speculative and tokens.shape[1] == 1:
            # prefill keeps the per-layer path: its union can exceed an arena
            limit = self.max_replays or (len(self._moe_lis) + 2)
            try:
                (logits, t_w), ids_np, execs = run_speculative(
                    self.arena, self._moe_lis,
                    self._spec_run(tokens, positions, kv_caches, kv_len), limit)
            except RuntimeError as e:
                if not is_spec_capacity_error(e):
                    raise
                logger.warning("pod speculative decode disabled (%s); falling back to the "
                               "per-layer path", e)
                self.speculative = False
            else:
                self.replay_counts.append(execs)
                spec_trace_and_prefetch(self, ids_np, self._moe_lis, seq_ids)
                return logits, kv_caches, (torch.from_numpy(ids_np), t_w)
        x = model.embed(self.params, tokens)
        trace_ids, trace_w = [], []
        self._last_layer_t = None
        for li in range(model.spec.num_layers):
            self._tick_layer_clock()
            mli = model.moe_layer_index(li)
            pl = self.params["layers"][li]
            if mli is None:
                x, kv_caches[li] = model.dense_layer(pl, x, kv_caches[li], positions, kv_len)
                continue
            x, h, cw, ids, kv_caches[li] = model.pre_moe(pl, x, kv_caches[li], positions, kv_len)
            ids_np = ids.cpu().numpy()  # the same on every rank
            keys = [(mli, int(e)) for e in np.unique(ids_np)]
            row_keys = None
            if ex.dp > 1:
                B = ids_np.shape[0]
                if B % ex.dp:
                    raise ValueError(f"batch {B} must divide over the data axis ({ex.dp})")
                b = B // ex.dp
                # row d warms only what its batch slice routes to
                row_keys = [[(mli, int(e)) for e in np.unique(ids_np[d * b:(d + 1) * b])]
                            for d in range(ex.dp)]
            _plan_and_prefetch(self, ids_np, mli, seq_ids)
            x = _pod_apply(ex, mli, keys, h, cw, ids_np,
                           lambda w, row, bi: model.apply_moe(pl, x, h, cw, ids, w, row, bi,
                                                              self._impl),
                           row_keys=row_keys)
            trace_ids.append(ids)
            trace_w.append(cw)
        logits = model.head(self.params, x)
        return logits, kv_caches, (torch.stack(trace_ids), torch.stack(trace_w))

    # ---- metrics -------------------------------------------------------------
    def hit_rate(self) -> float:
        return self.executor.stats()["hit_rate"]

    def stats(self) -> dict:
        out = self.executor.stats()
        out.update(speculative_stats(self.replay_counts))
        out["barrier_joins"] = self.executor.barrier_joins
        return out

    def node_stats(self) -> dict:
        return {c: a.node_stats() for c, a in self.executor.arenas.items()}


class PodSeq2SeqOffloadEngine(Seq2SeqOffloadEngine):
    """Encoder-decoder offload serving (NLLB-MoE, Switch) over an
    ``expert``-axis mesh, ``model x expert`` with the data axis 1, as JAX's.
    The ``Seq2SeqOffloadEngine`` stepping is reused whole (encoder pass,
    cross K/V, per-layer decode, tracing); only the expert residency layer
    changes: every MoE layer goes through the executor's ``ensure_step``
    and the grouped FFN over the rank's slots, with the host fallback
    applied alike on every rank. Decoding takes the per-layer path (JAX's
    pod engine has no seq2seq speculative path). Unlike JAX's, the
    encoder-to-decoder prefetch orders only the rank's own coordinate's
    experts (JAX's orders every expert into its first coordinate's
    arena)."""

    def __init__(
        self,
        model,
        params,
        executor: PodOffloadExecutor,
        *,
        tracer=None,
        predictor=None,
        prefetch: bool = True,
        lookahead: int = 3,
        prefetch_budget: Optional[int] = None,
        adaptive_budget: bool = True,
        impl: str = "ragged",
        prefill_impl: Optional[str] = None,
        graphs: bool = False,
    ):
        _check_pod_model(model, graphs, "PodSeq2SeqOffloadEngine")
        if executor.dp != 1:
            raise ValueError("PodSeq2SeqOffloadEngine composes model x expert (data axis 1)")
        self.executor = executor
        # the capacity constraint is on the global slot count (ep x local)
        self.arena_multiplicity = executor.ep
        super().__init__(model, params, executor.arena, tracer=tracer, predictor=predictor,
                         prefetch=prefetch, lookahead=lookahead, prefetch_budget=prefetch_budget,
                         adaptive_budget=adaptive_budget, impl=impl, prefill_impl=prefill_impl,
                         speculative=False, graphs=False)

    def is_resident(self, key) -> bool:
        return self.executor.is_resident(key)

    def _plan_layer(self, ids_np, mli, seq_ids):
        _plan_and_prefetch(self, ids_np, mli, seq_ids)

    def _prefetch_decoder_tier(self, seq_ids) -> None:
        """The encode-to-decode prefetch of ``Seq2SeqOffloadEngine``, on this
        rank's coordinate."""
        if not (self.prefetch and seq_ids and self.dec_mlis):
            return
        first_dec = self.dec_mlis[0]
        ent = self.tracer.get_entry(seq_ids[0])
        obs = {ent.last_layer: ent.last_experts} if ent.last_experts is not None else {}
        score = self.predictor.predict_block(seq_ids[0], obs, from_layer=first_dec)
        self.executor.set_context(first_dec, self.tracer.get_entry_decoder(seq_ids[0]).matrix)
        orders = plan_prefetch(score, first_dec - 1, lookahead=None,
                               budget=self._current_budget() * max(1, self.spec_block),
                               is_resident=self.is_resident)
        if orders:
            self.executor.prefetch(orders)

    def _moe_dispatch(self, x, h, cw, ids, ids_np, keys, mli):
        impl = self._impl if h.shape[1] == 1 else self._pimpl
        return _pod_apply(self.executor, mli, keys, h, cw, ids_np,
                          lambda w, row, bi: self.model.apply_ff(x, h, cw, ids, w, row, bi, impl))

    def hit_rate(self) -> float:
        return self.executor.stats()["hit_rate"]

    def stats(self) -> dict:
        out = self.executor.stats()
        out["barrier_joins"] = self.executor.barrier_joins
        return out

    def node_stats(self) -> dict:
        return {c: a.node_stats() for c, a in self.executor.arenas.items()}
