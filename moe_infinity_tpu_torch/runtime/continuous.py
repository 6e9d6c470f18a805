"""Continuous batching: slot-level admission over the paged KV cache, from
``moe_infinity_tpu/runtime/continuous.py`` (resident mode, greedy).

Requests join and leave a persistent decode batch mid-flight:

* the batch runs on a shared cache-column timeline C (every active slot
  writes its K/V at columns [C, C+W) each step), so the scalar kv_len stays
  batch-uniform while RoPE takes per-row *logical* positions
  (``rope_positions``) and a per-row column-validity bitmap (``key_valid``)
  masks hole columns;
* a joining request takes a free slot and piggybacks its prefill: its prompt
  is fed ``prefill_chunk`` tokens per shared step while other slots decode;
  decode rows feed their one real token at the first chunk column and the
  remaining columns become masked holes;
* each slot owns pages of the shared pool only for its live column range;
  completion frees the pages and the slot at once.

A one-token step (W = 1) reads the pool in place through K4
(``paged_flash_decode``); a ``prefill_chunk``-wide step runs K2 over the
gathered view. An MLA model (DeepSeek) reads the gathered view of its latent
and rope-key pools on every step and hands it to K5 on a one-token step, as
the JAX model does; the pools take each model's own cache slot shapes. One
scheduler thread runs every step; the page table goes to
the device and the tokens come back to the host each step, as in the JAX
version. A step that raises fails every active request's future, rebuilds
the pools and leaves the thread serving.

Requests carry their own sampling settings (``RequestSampling``): the
step's logits go through ``runtime/sampling.py::sample_rows`` with per-row
temperature, top-k/p, min-p, penalties (counts [B, V] kept on the device)
and ``logit_bias``; row b draws from the generator of (seed, tokens it has
generated), so a request samples the same alone or batched. A batch of
plain greedy requests takes the argmax alone.

Offload mode (``arena=...``): the batch's experts live in an
``ExpertArena`` instead of a resident tree, and every shared step runs
speculatively: one execution over the arena's current slots, the routed ids
verified on the host against the residency the execution saw, and run again
after loading the misses (``runtime/engine.py::run_speculative``, pooled
over the whole batch). Only the live columns of active rows are verified,
so the garbage ids of idle rows and hole columns never force a fetch. The
arena must hold one step's union of routed experts across the MoE layers and
rows (a ``prefill_chunk`` of 1 keeps it smallest). Each execution rewrites
the same pool columns, so a replay needs no copy of the pools. The accepted
routing feeds the EAMC tracer per request and warms the next step's experts
through the predictor. The step runs eagerly.
"""

from __future__ import annotations

import logging
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
    run_speculative,
    spec_trace_and_prefetch,
    speculative_stats,
)
from moe_infinity_tpu_torch.runtime.generate import eos_hit
from moe_infinity_tpu_torch.runtime.paged_kv import PageAllocator, PagedKVCache
from moe_infinity_tpu_torch.runtime.sampling import (
    RowParams,
    normalize_logit_bias,
    reset_rows,
    sample_rows,
    update_counts,
)


@dataclass(frozen=True)
class RequestSampling:
    """Per-request sampling settings for batched serving."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: int = 0
    # ((token_id, bias), ...) added to the row's raw logits every step
    # (OpenAI logit_bias; normalized from a dict by submit())
    logit_bias: Optional[tuple] = None

    @property
    def greedy_plain(self) -> bool:
        return (
            self.temperature == 0.0
            and self.repetition_penalty == 1.0
            and self.presence_penalty == 0.0
            and self.frequency_penalty == 0.0
            and not self.logit_bias
        )

    @property
    def needs_counts(self) -> bool:
        return (
            self.repetition_penalty != 1.0
            or self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0
        )


_GREEDY = RequestSampling()
_log = logging.getLogger(__name__)


@dataclass
class _Req:
    input_ids: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    on_token: Optional[Callable[[int], None]] = None
    sampling: RequestSampling = _GREEDY
    future: Future = field(default_factory=Future)


@dataclass
class _Slot:
    req: Optional[_Req] = None
    start_col: int = 0
    prompt_pos: int = 0  # next prompt token to feed
    generated: list = field(default_factory=list)
    active: bool = False
    seq_id: Optional[str] = None  # EAMC tracer entry (offload mode)

    @property
    def prefilling(self) -> bool:
        return self.active and self.prompt_pos < len(self.req.input_ids)


class ContinuousBatcher:
    """Serves requests through one persistent batch of ``max_batch_size``
    slots on the model's device. ``max_cols`` (the shared timeline) must be
    a multiple of ``page_size``, so that the hole mask covers exactly the
    page table's columns. ``arena`` (with ``tracer``, ``predictor``,
    ``prefetch`` and ``max_replays``) selects offload mode; ``experts`` and
    ``for_layer`` are then unused."""

    def __init__(
        self,
        model,
        params,
        experts,
        for_layer: Callable,
        *,
        impl: str = "ragged",
        max_batch_size: int = 4,
        page_size: int = 16,
        num_pages: int = 64,
        max_cols: int = 256,
        prefill_chunk: int = 1,
        idle_sleep_s: float = 0.005,
        arena=None,
        tracer=None,
        predictor=None,
        prefetch: bool = True,
        max_replays: Optional[int] = None,
    ):
        if arena is not None and arena.num_slots < model.spec.num_experts:
            raise ValueError(
                f"arena num_slots={arena.num_slots} < num_experts={model.spec.num_experts}; "
                "speculative batched decode needs at least one full MoE layer of slots")
        if max_cols % page_size != 0:
            raise ValueError(
                f"max_cols={max_cols} must be a multiple of page_size={page_size}"
            )
        self.model = model
        self.B = max_batch_size
        self.page_size = page_size
        self.max_cols = max_cols
        self.max_pages_per_seq = max_cols // page_size
        self.chunk = max(1, int(prefill_chunk))
        self.alloc = PageAllocator(num_pages, page_size)
        # reserve page 0 as the null page: inactive slots write their
        # (masked) rows there and unused table entries point at it
        self.alloc.allocate("__null__", 1)
        self.idle_sleep_s = idle_sleep_s
        self._device = model.device

        # per-layer pool shapes from the model's own cache layout
        probe = model.init_cache(1, 1)
        self._pool_specs = [
            ((num_pages, page_size) + tuple(kv.k.shape[2:]), kv.k.dtype,
             (num_pages, page_size) + tuple(kv.v.shape[2:]), kv.v.dtype)
            for kv in probe
        ]
        self._pools = self._fresh_pools()

        self._params = params
        self._experts = experts
        self._for_layer = for_layer
        self._impl = impl

        # ---- offload (speculative) mode ---------------------------------
        self.arena = arena
        self.tracer = tracer
        self.predictor = predictor
        self.prefetch = bool(prefetch and predictor is not None and arena is not None)
        self.max_replays = max_replays
        self.replay_counts: list = []
        if arena is not None:
            self._moe_lis = [mli for mli in map(model.moe_layer_index, range(model.spec.num_layers))
                             if mli is not None]
            # no more than half the arena per plan
            self.prefetch_budget = max(1, arena.num_slots // 2)
        # per-row timeline state
        self._valid = np.zeros((self.B, max_cols), dtype=bool)
        self._logical = np.zeros(self.B, dtype=np.int64)
        self._last_tokens = np.zeros(self.B, dtype=np.int64)
        # per-row sampling state: token counts on the device for the
        # penalties; logit_bias rows with a host mirror, uploaded on change
        V = model.spec.vocab_size
        self._counts_full = torch.zeros((self.B, V), dtype=torch.int32, device=self._device)
        self._counts_gen = torch.zeros((self.B, V), dtype=torch.int32, device=self._device)
        self._bias_host = np.zeros((self.B, V), np.float32)
        self._bias_dev = torch.from_numpy(self._bias_host).to(self._device)
        self._slots = [_Slot() for _ in range(self.B)]
        self._col = 0  # shared cache-column clock
        # width -> [steps, host seconds] (each step ends in a host read)
        self._step_time = {}
        self._queue: "queue.Queue[_Req]" = queue.Queue()
        self._shutdown = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _fresh_pools(self):
        return [
            (torch.zeros(ks, dtype=kd, device=self._device),
             torch.zeros(vs, dtype=vd, device=self._device))
            for ks, kd, vs, vd in self._pool_specs
        ]

    # ---- client API ------------------------------------------------------
    def submit(self, input_ids, max_new_tokens=32, eos_token_id=None,
               on_token=None, sampling: Optional[RequestSampling] = None,
               **sampling_kwargs) -> Future:
        """Queue one request; its future resolves to the prompt followed by
        the generated tokens. on_token: optional callback fired from the
        scheduler thread for every generated token. Per-request sampling:
        a ``RequestSampling`` or its fields as keywords (temperature, top_k,
        top_p, min_p, the penalties, seed, logit_bias)."""
        if sampling is None:
            sampling_kwargs.pop("do_sample", None)
            if sampling_kwargs.get("logit_bias"):
                sampling_kwargs["logit_bias"] = normalize_logit_bias(sampling_kwargs["logit_bias"])
            else:
                sampling_kwargs.pop("logit_bias", None)
            sampling = RequestSampling(**sampling_kwargs) if sampling_kwargs else _GREEDY
        r = _Req(np.asarray(input_ids).reshape(-1), max_new_tokens, eos_token_id, on_token,
                 sampling)
        self._queue.put(r)
        return r.future

    def generate(self, input_ids, **kw) -> np.ndarray:
        return self.submit(input_ids, **kw).result()

    def shutdown(self):
        self._shutdown = True
        self._thread.join(timeout=5)

    def step_stats(self) -> dict:
        """{width: {"steps": n, "ms_per_step": host ms}} since construction
        or the last reset_step_stats()."""
        return {
            w: {"steps": n, "ms_per_step": 1e3 * t / n}
            for w, (n, t) in sorted(self._step_time.items())
        }

    def reset_step_stats(self) -> None:
        self._step_time = {}

    def stats(self) -> dict:
        """The arena's hit counters (offload mode) and the speculative
        executions per step."""
        out = self.arena.hit_stats() if self.arena is not None else {}
        out.update(speculative_stats(self.replay_counts))
        return out

    def _current_budget(self) -> int:
        """The prefetch budget ``spec_trace_and_prefetch`` plans with."""
        return self.prefetch_budget

    # ---- scheduler -------------------------------------------------------
    def _admit(self) -> bool:
        """Seat queued requests into free slots. Returns True if any slot
        is active afterwards."""
        for b, slot in enumerate(self._slots):
            if slot.active:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            T = len(req.input_ids)
            if self._col + T + req.max_new_tokens + self.chunk >= self.max_cols:
                # timeline nearly exhausted; requeue until reset
                self._queue.put(req)
                break
            try:
                # range-offset allocation: no pages below the start column
                self.alloc.allocate(
                    id(req), self._col + T + req.max_new_tokens + 1,
                    start_token=self._col,
                )
            except RuntimeError:
                self._queue.put(req)  # pool full; wait for completions
                break
            slot.req = req
            slot.start_col = self._col
            slot.prompt_pos = 0
            slot.generated = []
            slot.active = True
            slot.seq_id = self.tracer.create_entry() if self.tracer is not None else None
            self._valid[b, :] = False
            self._logical[b] = 0
            if req.sampling.needs_counts:
                keep = torch.ones(self.B, dtype=torch.int32, device=self._device)
                keep[b] = 0
                self._counts_full, self._counts_gen = reset_rows(
                    self._counts_full, self._counts_gen, keep)
            if req.sampling.logit_bias or self._bias_host[b].any():
                # normalize here too: submit(sampling=RequestSampling(...))
                # may carry a raw {token: bias} dict
                self._bias_host[b] = 0.0
                for t, v in normalize_logit_bias(req.sampling.logit_bias) or ():
                    if 0 <= t < self._bias_host.shape[1]:
                        self._bias_host[b, t] = v
                self._bias_dev = torch.from_numpy(self._bias_host).to(self._device)
        return any(s.active for s in self._slots)

    def _finish(self, slot: _Slot):
        req = slot.req
        self.alloc.release(id(req))
        if slot.seq_id is not None:
            self.tracer.finish_entry(slot.seq_id)
            slot.seq_id = None
        req.future.set_result(
            np.concatenate([req.input_ids, np.asarray(slot.generated, dtype=np.int64)])
        )
        slot.req = None
        slot.active = False

    def _fail_all(self, exc: BaseException):
        """Abort every active request; the scheduler thread survives and no
        future hangs. Rebuilds the pools (a step that failed midway may have
        written some layers) and resets the column timeline."""
        for s in self._slots:
            if not s.active:
                continue
            self.alloc.release(id(s.req))
            if s.seq_id is not None:
                self.tracer.finish_entry(s.seq_id)
                s.seq_id = None
            s.req.future.set_exception(exc)
            s.req = None
            s.active = False
        self._pools = self._fresh_pools()
        self._col = 0
        self._valid[:] = False

    def _reset_if_idle(self):
        if not any(s.active for s in self._slots) and self._col > 0:
            self._col = 0  # fresh timeline once the batch drains
            self._valid[:] = False

    def _loop(self):
        if self._device.type == "cuda":
            # a new thread launches on the current device: name it
            torch.cuda.set_device(self._device)
        with torch.inference_mode():
            while not self._shutdown:
                self._reset_if_idle()
                if not self._admit():
                    time.sleep(self.idle_sleep_s)
                    continue
                try:
                    self._step_iteration()
                except Exception as e:  # noqa: BLE001 - the thread must survive
                    self._fail_all(e)

    def _forward(self, toks, positions, kvs, col, rope_pos, valid, experts, for_layer):
        """One shared step of the model: (logits [B, W, V], caches, trace)."""
        return self.model.forward(
            self._params, experts, toks, positions, kvs, col,
            for_layer=for_layer, impl=self._impl,
            rope_positions=rope_pos, key_valid=valid,
        )

    def _speculative_forward(self, toks, positions, kvs, col, rope_pos, valid, n_feed):
        """Offload mode: the shared step as speculative executions over the
        arena's slots, verified on the live columns of active rows; then the
        accepted routing traced and the next step's experts prefetched.
        Returns the accepted execution's logits."""
        def run(tree, slot_rows):
            weights, biases = _split_arena_tree(tree)
            logits, _, (ids, _w) = self._forward(
                toks, positions, kvs, col, rope_pos, valid, None,
                lambda _experts, mli: (weights, slot_rows[mli], biases))
            return logits, ids

        # verify only live routing: idle rows and hole columns carry garbage
        # ids that must not force fetches (their outputs reach no live row)
        live = [(b, int(n_feed[b])) for b, s in enumerate(self._slots)
                if s.active and n_feed[b] > 0]

        def live_keys(ids, j):
            if not live:
                return np.empty(0, np.int64)
            return np.unique(np.concatenate([ids[j, b, :n].ravel() for b, n in live]))

        limit = self.max_replays or (len(self._moe_lis) + 2)
        # client_lock: a concurrent direct engine.generate (the facade's
        # path for what the batcher does not take) must not protect arena
        # keys while this step holds its union
        with self.arena.client_lock:
            (logits,), ids_np, execs = run_speculative(
                self.arena, self._moe_lis, run, limit, key_fn=live_keys)
        self.replay_counts.append(execs)
        seq_ids = [s.seq_id if s.active else None for s in self._slots]
        spec_trace_and_prefetch(self, ids_np, self._moe_lis, seq_ids, n_feed=n_feed)
        return logits

    def _next_tokens(self, logits, toks, n_feed, W: int) -> np.ndarray:
        """[B, W] next tokens on the host: the argmax of every column for a
        batch of plain greedy requests; otherwise each row's token from its
        last fed column through ``sample_rows``, after this step's fed
        tokens are counted (prompt tokens for prefill rows, the previously
        generated token for decode rows)."""
        active = [s for s in self._slots if s.active]
        if all(s.req.sampling.greedy_plain for s in active):
            return torch.argmax(logits, dim=-1).cpu().numpy()
        dev = self._device
        if any(s.req.sampling.needs_counts for s in active):
            fed_valid = np.zeros((self.B, W), dtype=bool)
            gen_mask = np.zeros((self.B, W), dtype=bool)
            for b, s in enumerate(self._slots):
                if not s.active or n_feed[b] == 0:
                    continue
                fed_valid[b, : int(n_feed[b])] = True
                # a decode row feeds a generated token at column 0; its first
                # feed is the prompt's last token only while generated is empty
                gen_mask[b, 0] = not s.prefilling and len(s.generated) > 0
            update_counts(self._counts_full, self._counts_gen,
                          torch.from_numpy(toks).to(dev), torch.from_numpy(fed_valid).to(dev),
                          torch.from_numpy(gen_mask).to(dev))
        sp = [s.req.sampling if s.active else _GREEDY for s in self._slots]
        rp = RowParams.from_lists(
            [p.temperature for p in sp], [p.top_k for p in sp], [p.top_p for p in sp],
            [p.min_p for p in sp], [p.repetition_penalty for p in sp],
            [p.presence_penalty for p in sp], [p.frequency_penalty for p in sp], device=dev)
        idx = torch.from_numpy(np.maximum(n_feed - 1, 0)).to(dev)
        row = logits.gather(1, idx[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
        seeds = [p.seed if p.temperature > 0.0 else None for p in sp]
        counters = [len(s.generated) if s.active else 0 for s in self._slots]
        tok = sample_rows(row, seeds, counters, self._counts_full, self._counts_gen, rp,
                          self._bias_dev).cpu().numpy()
        return np.broadcast_to(tok[:, None], (self.B, W))

    def _step_iteration(self):
        t0 = time.perf_counter()
        last_tokens = self._last_tokens
        # ---- pick this step's width -------------------------------------
        W = (
            self.chunk
            if any(s.prefilling for s in self._slots)
            and self._col + self.chunk <= self.max_cols
            else 1
        )
        if self._col + W > self.max_cols:
            # timeline exhausted with live slots: truncate them
            for s in self._slots:
                if s.active:
                    self._finish(s)
            return
        # ---- build this step's inputs -----------------------------------
        toks = np.zeros((self.B, W), dtype=np.int32)
        rope_pos = np.zeros((self.B, W), dtype=np.int32)
        n_feed = np.zeros(self.B, dtype=np.int64)  # real tokens per row
        for b, s in enumerate(self._slots):
            if not s.active:
                continue
            rope_pos[b] = self._logical[b] + np.arange(W)
            if s.prefilling:
                n = min(W, len(s.req.input_ids) - s.prompt_pos)
                toks[b, :n] = s.req.input_ids[s.prompt_pos:s.prompt_pos + n]
                n_feed[b] = n
            else:
                toks[b, 0] = last_tokens[b]
                n_feed[b] = 1
            self._valid[b, self._col:self._col + int(n_feed[b])] = True
            # extend the page allocation over this step's columns
            # (holes burn columns beyond the admission-time estimate)
            try:
                self.alloc.allocate(id(s.req), self._col + W, start_token=s.start_col)
            except RuntimeError:
                self._finish(s)  # pool exhausted: truncate this slot
                n_feed[b] = 0
        table = self.alloc.table(
            [id(s.req) if s.active else "__free__" for s in self._slots],
            self.max_pages_per_seq,
        )
        dev = self._device
        table_d = torch.from_numpy(table).to(dev)
        kvs = [PagedKVCache(pk, pv, table_d) for pk, pv in self._pools]
        positions = torch.from_numpy(
            np.broadcast_to(self._col + np.arange(W, dtype=np.int32), (self.B, W)).copy()
        ).to(dev)
        step_in = (torch.from_numpy(toks).to(dev), positions, kvs, self._col,
                   torch.from_numpy(rope_pos).to(dev), torch.from_numpy(self._valid).to(dev))
        if self.arena is not None:
            logits = self._speculative_forward(*step_in, n_feed)
        else:
            logits, _, _ = self._forward(*step_in, self._experts, self._for_layer)
        nxt = self._next_tokens(logits, toks, n_feed, W)
        self._col += W
        # ---- bookkeeping ------------------------------------------------
        for b, s in enumerate(self._slots):
            if not s.active or n_feed[b] == 0:
                continue
            if s.prefilling:
                s.prompt_pos += int(n_feed[b])
                self._logical[b] += int(n_feed[b])
                if s.prefilling:
                    continue  # still consuming the prompt
                # final prompt token consumed at chunk index n_feed - 1:
                # its logits give the first generated token
                tok = int(nxt[b, int(n_feed[b]) - 1])
            else:
                self._logical[b] += 1
                tok = int(nxt[b, 0])
            s.generated.append(tok)
            last_tokens[b] = tok
            if s.req.on_token is not None:
                try:
                    s.req.on_token(tok)
                except Exception:  # noqa: BLE001 - a stream consumer must not stall decode
                    _log.exception("on_token callback raised; decoding goes on")
            done = len(s.generated) >= s.req.max_new_tokens or (
                s.req.eos_token_id is not None and eos_hit(tok, s.req.eos_token_id)
            )
            if done:
                self._finish(s)
        n, t = self._step_time.get(W, (0, 0.0))
        self._step_time[W] = (n + 1, t + time.perf_counter() - t0)
