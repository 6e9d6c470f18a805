"""Continuous batching for encoder-decoder models (Switch, NLLB), from
``moe_infinity_tpu/runtime/continuous_s2s.py``.

Requests join and leave the decode batch mid-flight, where the wave batcher
(``runtime/batching.py::Seq2SeqDynamicBatcher``) coalesces them into aligned
waves. A joining request:

* runs its encoder pass alone, at a bucketed width (right padding is exact:
  Switch's capacity is a per-row prefix count, NLLB masks pads throughout);
* has its cross-attention K/V copied into its slot's rows of the shared
  ``[L, B, Se, H, Dk]`` cross buffers, and its encoder mask into its row of
  the shared ``[B, Se]`` mask, in place;
* then decodes at its own position: the shared step takes per-row
  ``row_offsets`` (``decode_step(row_offsets=...)``), so each row writes its
  self-attention K/V at its own column (``KVCache.update_rows``) and sees its
  own position. A previous occupant's columns lie past the new row's causal
  bound, so reusing a slot needs no reset.

Every tensor the shared step reads (the caches, the cross buffers, the
mask) is made once and keeps its address for the batcher's life. On the
card the step is one CUDA graph for that life (``runtime/graphs.py``), the
counterpart of the JAX version's one jitted step: the tokens and offsets are
its device inputs, copied in before each replay, and a join's copies are
queued on the same stream before the next replay. ``graphs=False`` runs the
step eagerly (for comparison); on CPU tensors it runs eagerly unless a
capture backend is given.

Offload mode (``engine=``, a ``Seq2SeqOffloadEngine``): a join encodes
through the engine's per-layer acquire/prefetch path under the arena's
``client_lock``, with a tracer entry for its slot, and every shared step is
one speculative execution over the arena's slots (``run_speculative``),
verified against the live rows' dispatched top-k and run again after loading
the misses, then traced and prefetched. With the engine's graphs the step is
a replay of one graph in the engine's ``GraphCache``. The arena must hold one
step's union of routed experts across the decoder MoE layers and live rows.

A failed step fails the active requests only; the scheduler thread keeps
serving. The caches are zeroed in place (not rebuilt), so that a captured
graph's addresses stay valid. The batcher decodes greedily; the facade sends
other requests to the generator.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from moe_infinity_tpu_torch.runtime.engine import (
    _split_arena_tree,
    margin_key_fns,
    run_speculative,
    spec_trace_and_prefetch,
    speculative_stats,
    split_margin_columns,
)
from moe_infinity_tpu_torch.runtime.generate import _bucket_len, eos_hit
from moe_infinity_tpu_torch.runtime.graphs import GraphCache, flat_tensors, graph_cache


@dataclass
class _Req:
    input_ids: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    future: Future = field(default_factory=Future)


@dataclass
class _Slot:
    req: Optional[_Req] = None
    generated: list = field(default_factory=list)
    cur: int = 0  # token to feed next step
    active: bool = False
    seq_id: Optional[str] = None  # EAMC tracer entry (offload mode)


class Seq2SeqContinuousBatcher:
    def __init__(
        self,
        model,
        params,
        experts,
        for_layer: Optional[Callable],
        *,
        impl: str = "ragged",
        max_batch_size: int = 4,
        max_src_len: int = 64,
        max_decode_len: int = 64,
        idle_sleep_s: float = 0.002,
        engine=None,
        max_replays: Optional[int] = None,
        graphs: bool = True,
        graph_backend=None,
    ):
        """engine: a ``Seq2SeqOffloadEngine`` for offload mode (then
        ``experts``/``for_layer`` are unused, and the engine's graphs decide
        whether the step is captured); without one, ``experts`` and
        ``for_layer`` carry the resident expert tree. graphs: run the shared
        step as a CUDA graph on the card (resident mode; False runs it
        eagerly); graph_backend: the capture backend (default
        ``CudaGraphBackend`` on a CUDA model). On the card an ``impl`` that
        cannot be captured ("ragged", the default) raises ``ValueError``
        unless graphs is False."""
        s = model.spec
        if engine is not None and engine.arena.num_slots < s.num_experts:
            raise ValueError("arena must fit one full MoE layer of experts")
        self.model = model
        self.params = params
        self.experts = experts
        self._for_layer = for_layer
        self.impl = impl
        self.engine = engine
        self.max_replays = max_replays
        self.replay_counts: list = []
        self.B = max_batch_size
        self.Se = int(max_src_len)
        self.cap = int(max_decode_len)
        self.idle_sleep_s = idle_sleep_s
        self._device = model.device

        # the shared device state, at fixed addresses for the batcher's life
        self._kvs = model.init_cache(self.B, self.cap)
        L = len(self._kvs)
        Dk = getattr(s, "d_kv", None) or s.d_model // s.num_heads
        shape = (L, self.B, self.Se, s.num_heads, Dk)
        self._ck = torch.zeros(shape, dtype=model.dtype, device=self._device)
        self._cv = torch.zeros_like(self._ck)
        self._cross = [(self._ck[i], self._cv[i]) for i in range(L)]
        self._mask = torch.zeros((self.B, self.Se), dtype=torch.float32, device=self._device)

        self.graphs: Optional[GraphCache] = None
        if engine is not None:
            self._dec_mlis = engine.dec_mlis
            self.graphs = engine.graphs
        else:
            self.graphs = graph_cache(graphs, graph_backend, self._device, impl)
            self._reads = [*flat_tensors(params), *flat_tensors(experts),
                           *flat_tensors(self._kvs), self._mask, self._ck, self._cv]
        # counters: shared steps, joins, host seconds of the steps
        self.steps = self.joins = 0
        self.step_seconds = 0.0

        self._slots = [_Slot() for _ in range(self.B)]
        self._queue: "queue.Queue[_Req]" = queue.Queue()
        self._shutdown = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- client API ------------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int = 32, eos_token_id=None) -> Future:
        """Queue one request (host work only); the future resolves to the
        decoder ids [start, tok, ...], the wave batcher's surface."""
        ids = np.asarray(input_ids).reshape(-1)
        if len(ids) > self.Se:
            raise ValueError(
                f"source length {len(ids)} exceeds max_src_len={self.Se}; "
                "the continuous batcher never truncates")
        if max_new_tokens + 1 > self.cap:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds decode cache capacity {self.cap}")
        req = _Req(ids, max_new_tokens, eos_token_id)
        self._queue.put(req)
        return req.future

    def generate(self, input_ids, **kw) -> np.ndarray:
        return self.submit(input_ids, **kw).result()

    def shutdown(self):
        self._shutdown = True
        self._thread.join(timeout=5)

    def stats(self) -> dict:
        """The arena's hit counters (offload mode) and the speculative
        executions per step."""
        out = self.engine.arena.hit_stats() if self.engine is not None else {}
        out.update(speculative_stats(self.replay_counts))
        return out

    def step_stats(self) -> dict:
        """Shared steps, joins and the host's ms per step (each step ends in
        a host read of its tokens)."""
        return {"steps": self.steps, "joins": self.joins,
                "ms_per_step": 1e3 * self.step_seconds / max(1, self.steps)}

    def graph_stats(self) -> dict:
        """Captures, replays and capture seconds of the step's graph (in
        offload mode, of all the engine's graphs); empty when eager."""
        return self.graphs.stats() if self.graphs is not None else {}

    # ---- scheduler -------------------------------------------------------
    def _admit(self) -> bool:
        s = self.model.spec
        pad = getattr(s, "pad_token_id", 0)
        dev = self._device
        for b, slot in enumerate(self._slots):
            if slot.active:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            # the encoder pass of this request alone, at a bucketed width;
            # cross columns past it keep a previous occupant's values, which
            # the mask row hides
            n = len(req.input_ids)
            S1 = min(self.Se, _bucket_len(n))
            tok = np.full((1, S1), pad, np.int64)
            tok[0, :n] = req.input_ids
            mrow = np.zeros((1, self.Se), np.float32)
            mrow[0, :n] = 1.0
            tok_d = torch.from_numpy(tok).to(dev)
            m_d = torch.from_numpy(mrow).to(dev)
            seq_id = None
            try:
                if self.engine is None:
                    enc = self.model.encode(self.params, self.experts, tok_d, m_d[:, :S1],
                                            self._for_layer, self.impl)
                    rows = self.model.cross_kv(self.params, enc)
                else:
                    # the engine's per-layer acquire/prefetch encode, under
                    # client_lock: its protections must not overlap another
                    # executor's protected set
                    if self.engine.tracer is not None:
                        seq_id = self.engine.tracer.create_entry()
                    with self.engine.arena.client_lock:
                        _enc, rows = self.engine.run_encoder(
                            tok_d, m_d[:, :S1], [seq_id] if seq_id else None)
                # seat the rows in place: a graph reads these buffers
                self._ck[:, b, :S1].copy_(torch.stack([c[0][0] for c in rows]))
                self._cv[:, b, :S1].copy_(torch.stack([c[1][0] for c in rows]))
            except Exception as e:  # noqa: BLE001 - a failed join fails only this request
                # the tracer entry is finished before the waiter can wake
                if seq_id is not None:
                    self.engine.tracer.finish_entry(seq_id)
                req.future.set_exception(e)
                continue
            self._mask[b].copy_(m_d[0])
            slot.seq_id = seq_id
            slot.req = req
            slot.generated = []
            slot.cur = s.decoder_start_token_id
            slot.active = True
            self.joins += 1
        return any(sl.active for sl in self._slots)

    def _finish(self, slot: _Slot):
        req = slot.req
        start = self.model.spec.decoder_start_token_id
        if slot.seq_id is not None:
            self.engine.tracer.finish_entry(slot.seq_id)
            slot.seq_id = None
        req.future.set_result(np.asarray([start] + slot.generated, dtype=np.int64))
        slot.req = None
        slot.active = False

    def _fail_active(self, exc: BaseException):
        """Fail every active request; the scheduler thread survives and no
        future hangs. The caches are zeroed in place first (new tensors would
        move the addresses a captured graph reads), so a caller woken by the
        failure finds them zeroed, its tracer entry finished and its slot
        free."""
        for kv in self._kvs:
            kv.k.zero_()
            kv.v.zero_()
        for sl in self._slots:
            if sl.active:
                req = sl.req
                if sl.seq_id is not None:
                    self.engine.tracer.finish_entry(sl.seq_id)
                    sl.seq_id = None
                sl.req = None
                sl.active = False
                req.future.set_exception(exc)

    def _loop(self):
        if self._device.type == "cuda":
            # a new thread launches on the current device: name it
            torch.cuda.set_device(self._device)
        start = self.model.spec.decoder_start_token_id
        with torch.inference_mode():
            while not self._shutdown:
                if not self._admit():
                    time.sleep(self.idle_sleep_s)
                    continue
                try:
                    self._step_once(start)
                except Exception as e:  # noqa: BLE001 - a failed step fails the batch only
                    self._fail_active(e)

    def _decode(self, experts, for_layer, tok, offs):
        """The shared step over all B slots: (logits [B, 1, V] f32, next
        tokens [B], trace)."""
        logits, _, trace = self.model.decode_step(
            self.params, experts, tok, offs[:, None], self._kvs, 0, self._mask,
            self._cross, for_layer, self.impl, row_offsets=offs)
        return logits, torch.argmax(logits[:, -1, :], dim=-1), trace

    def _step(self, tok, offs, tree=None, slot_rows=None):
        """The shared step: (logits, next tokens, trace), a graph's outputs
        that the next replay overwrites. Resident mode leaves ``tree`` and
        ``slot_rows`` out and gets no trace; offload mode runs over the
        arena's ``tree`` and ``slot_rows``."""
        if self.engine is None:
            return (*self._resident_step(tok, offs), None)
        return self._spec_step(tree, slot_rows, tok, offs)

    def _resident_step(self, tok, offs):
        """(logits, next tokens) of one shared step: a replay of the
        batcher's graph or an eager run."""
        def run(tok, offs):
            return self._decode(self.experts, self._for_layer, tok, offs)[:2]

        if self.graphs is None:
            return run(tok, offs)
        return self.graphs.run("rows_step", run, {"tok": tok, "offs": offs}, self._reads)

    def _spec_step(self, tree, slot_rows, tok, offs):
        """One speculative execution of the shared step over the arena's
        slots: (logits, next tokens, trace)."""
        weights, biases = _split_arena_tree(tree)

        def run(tok, offs, rows):
            return self._decode(None, lambda _e, mli: (weights, rows[mli], biases), tok, offs)

        if self.graphs is None:
            return run(tok, offs, slot_rows)
        reads = [*flat_tensors(self.params), *flat_tensors(tree), *flat_tensors(self._kvs),
                 self._mask, self._ck, self._cv]
        return self.graphs.run("rows_step", run, {"tok": tok, "offs": offs, "rows": slot_rows},
                               reads)

    def _step_once(self, start: int):
        t0 = time.perf_counter()
        toks = np.full((self.B, 1), start, np.int32)
        offs = np.zeros(self.B, np.int32)
        for b, sl in enumerate(self._slots):
            if sl.active:
                toks[b, 0] = sl.cur
                offs[b] = len(sl.generated)
        dev = self._device
        toks_d = torch.from_numpy(toks).to(dev)
        offs_d = torch.from_numpy(offs).to(dev)
        if self.engine is None:
            _logits, nxt, _ = self._step(toks_d, offs_d)
            nxt = nxt.cpu().numpy()
        else:
            live = [b for b, sl in enumerate(self._slots) if sl.active]
            margin = getattr(self.model, "route_margin", 0)

            def run(tree, slot_rows):
                return self._step(toks_d, offs_d, tree, slot_rows)

            def live_keys(ids, j):
                row = ids[j][live]
                if margin > 0:
                    # verify and acquire the dispatched top-k only; the
                    # runner-up margin columns go to soft prefetch
                    row = row[..., : row.shape[-1] - margin]
                return np.unique(row) if live else np.empty(0, np.int64)

            limit = self.max_replays or (len(self._dec_mlis) + 2)
            # client_lock: a concurrent direct engine.generate must not
            # protect arena keys while this step holds its union; the tokens
            # are read inside it, before another dispatch replays the graph
            with self.engine.arena.client_lock:
                (_logits, nxt), ids_np, execs = run_speculative(
                    self.engine.arena, self._dec_mlis, run, limit, key_fn=live_keys)
                nxt = nxt.cpu().numpy()
            self.replay_counts.append(execs)
            seq_ids = [sl.seq_id if sl.active else None for sl in self._slots]
            _, margin_fn = margin_key_fns(self._dec_mlis, margin)
            top, _m = split_margin_columns(ids_np, margin)
            spec_trace_and_prefetch(
                self.engine, top, self._dec_mlis, seq_ids,
                plan_floor=self._dec_mlis[0] - 1 if self._dec_mlis else -1,
                extra_orders=margin_fn(ids_np) if margin_fn else (),
            )
        for b, sl in enumerate(self._slots):
            if not sl.active:
                continue
            tok = int(nxt[b])
            sl.generated.append(tok)
            sl.cur = tok
            done = len(sl.generated) >= sl.req.max_new_tokens or (
                sl.req.eos_token_id is not None and eos_hit(tok, sl.req.eos_token_id))
            if done:
                self._finish(sl)
        self.steps += 1
        self.step_seconds += time.perf_counter() - t0
