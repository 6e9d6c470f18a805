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
the device and the argmax comes back to the host each step, as in the JAX
version. A step that raises fails every active request's future, rebuilds
the pools and leaves the thread serving.

Waits for later ports: sampled requests (``RequestSampling`` other than
greedy raises ``NotImplementedError`` at ``submit``) and offload mode
(``arena=``).
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

from moe_infinity_tpu_torch.runtime.generate import eos_hit
from moe_infinity_tpu_torch.runtime.paged_kv import PageAllocator, PagedKVCache


@dataclass(frozen=True)
class RequestSampling:
    """Per-request sampling settings (the JAX signature). Only greedy
    requests are served by the port."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: int = 0
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


_GREEDY = RequestSampling()
_log = logging.getLogger(__name__)


@dataclass
class _Req:
    input_ids: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    on_token: Optional[Callable[[int], None]] = None
    future: Future = field(default_factory=Future)


@dataclass
class _Slot:
    req: Optional[_Req] = None
    start_col: int = 0
    prompt_pos: int = 0  # next prompt token to feed
    generated: list = field(default_factory=list)
    active: bool = False

    @property
    def prefilling(self) -> bool:
        return self.active and self.prompt_pos < len(self.req.input_ids)


class ContinuousBatcher:
    """Serves requests through one persistent batch of ``max_batch_size``
    slots on the model's device. ``max_cols`` (the shared timeline) must be
    a multiple of ``page_size``, so that the hole mask covers exactly the
    page table's columns."""

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
    ):
        if arena is not None:
            raise NotImplementedError(
                "offload mode (arena=) waits for the port of runtime/arena.py"
            )
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
        # per-row timeline state
        self._valid = np.zeros((self.B, max_cols), dtype=bool)
        self._logical = np.zeros(self.B, dtype=np.int64)
        self._last_tokens = np.zeros(self.B, dtype=np.int64)
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
        scheduler thread for every generated token. Sampling settings (a
        ``RequestSampling`` or its fields as keywords) must be greedy."""
        if sampling is None:
            sampling_kwargs.pop("do_sample", None)
            if not sampling_kwargs.get("logit_bias"):
                sampling_kwargs.pop("logit_bias", None)
            sampling = RequestSampling(**sampling_kwargs) if sampling_kwargs else _GREEDY
        if not sampling.greedy_plain:
            raise NotImplementedError(
                "only greedy requests are ported; sampling, penalties and "
                "logit_bias wait for the port of runtime/sampling.py"
            )
        r = _Req(np.asarray(input_ids).reshape(-1), max_new_tokens, eos_token_id, on_token)
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
            self._valid[b, :] = False
            self._logical[b] = 0
        return any(s.active for s in self._slots)

    def _finish(self, slot: _Slot):
        req = slot.req
        self.alloc.release(id(req))
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

    def _forward(self, toks, positions, kvs, col, rope_pos, valid):
        """One shared step of the model: (logits [B, W, V], caches, trace)."""
        return self.model.forward(
            self._params, self._experts, toks, positions, kvs, col,
            for_layer=self._for_layer, impl=self._impl,
            rope_positions=rope_pos, key_valid=valid,
        )

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
        logits, _, _ = self._forward(
            torch.from_numpy(toks).to(dev), positions, kvs, self._col,
            torch.from_numpy(rope_pos).to(dev),
            torch.from_numpy(self._valid).to(dev),
        )
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # [B, W]
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
