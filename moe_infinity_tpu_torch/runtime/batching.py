"""Wave batching for serving, from ``moe_infinity_tpu/runtime/batching.py``.

A scheduler thread coalesces concurrent requests into one batched decode, a
wave: a wave admits up to ``max_batch_size`` requests and runs to its end,
and requests that arrive meanwhile wait for the next one. Sequences finish
on their own EOS, and results return through per-request futures.

* ``DynamicBatcher`` (decoder-only): prompts are left-padded to a shared
  width; cache columns drive the causal mask, sequence positions drive RoPE,
  and pad columns are masked out (``forward(pad_offsets=...)``, which the
  Mixtral family takes).
* ``Seq2SeqDynamicBatcher`` (Switch, NLLB): sources are right-padded under
  the encoder mask (NLLB's positions come from the mask's cumulative sum, so
  padding does not move them), encoded once per wave, and the wave decodes
  greedily as a batch.

The steps run eagerly on the model's device; each wave's caches are new.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from moe_infinity_tpu_torch.runtime.generate import _bucket_len, eos_hit


@dataclass
class _Request:
    input_ids: np.ndarray  # [T]
    max_new_tokens: int
    eos_token_id: Optional[int]
    future: Future = field(default_factory=Future)


class _WaveLoop:
    """The scheduler thread, the queue and the wave collection shared by
    both batchers; a subclass provides ``_run_wave``."""

    def _start(self, max_batch_size: int, max_wait_s: float, device):
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_s
        self._device = device
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._shutdown = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, input_ids: np.ndarray, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None) -> Future:
        """Queue one request (host work only)."""
        req = _Request(np.asarray(input_ids).reshape(-1), max_new_tokens, eos_token_id)
        self._queue.put(req)
        return req.future

    def generate(self, input_ids, **kw) -> np.ndarray:
        return self.submit(input_ids, **kw).result()

    def shutdown(self):
        self._shutdown = True
        self._thread.join(timeout=5)

    def _collect_wave(self) -> List[_Request]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        wave = [first]
        t0 = time.monotonic()
        while len(wave) < self.max_batch_size:
            remaining = self.max_wait_s - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                wave.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return wave

    def _loop(self):
        if self._device.type == "cuda":
            # a new thread launches on the current device: name it
            torch.cuda.set_device(self._device)
        with torch.inference_mode():
            while not self._shutdown:
                wave = self._collect_wave()
                if not wave:
                    continue
                try:
                    self._run_wave(wave)
                except Exception as e:  # noqa: BLE001 - the thread must survive
                    for r in wave:
                        if not r.future.done():
                            r.future.set_exception(e)


def _record(out, done, ngen, wave, tok_host) -> None:
    """Append each unfinished row's token and mark the rows that end here."""
    for b, r in enumerate(wave):
        if done[b]:
            continue
        out[b].append(int(tok_host[b]))
        ngen[b] += 1
        if (r.eos_token_id is not None and eos_hit(tok_host[b], r.eos_token_id)) \
                or ngen[b] >= r.max_new_tokens:
            done[b] = True


class DynamicBatcher(_WaveLoop):
    """A decoder-only model, params and experts behind a wave loop. The
    model must take ``forward(..., pad_offsets=...)`` (left-padded batched
    attention); the Mixtral family does. Futures resolve to the prompt
    followed by the generated ids, without padding."""

    def __init__(self, model, params, experts, for_layer: Callable, *, impl: str = "ragged",
                 max_batch_size: int = 8, max_wait_s: float = 0.02, max_seq_len: int = 2048,
                 pad_token_id: int = 0):
        self.model = model
        self.params = params
        self.experts = experts
        self._for_layer = for_layer
        self.impl = impl
        self.max_seq_len = max_seq_len
        self.pad_token_id = pad_token_id
        self._start(max_batch_size, max_wait_s, model.device)

    def _fwd(self, tokens, positions, kv, kv_len, pad_offsets):
        return self.model.forward(self.params, self.experts, tokens, positions, kv, kv_len,
                                  for_layer=self._for_layer, impl=self.impl,
                                  pad_offsets=pad_offsets)

    def _run_wave(self, wave: Sequence[_Request]) -> None:
        dev = self._device
        B = len(wave)
        lens = [len(r.input_ids) for r in wave]
        P = max(lens)
        max_new = max(r.max_new_tokens for r in wave)
        cap = min(self.max_seq_len, _bucket_len(P + max_new))

        tokens = np.full((B, P), self.pad_token_id, dtype=np.int64)
        pad_offsets = np.zeros(B, dtype=np.int32)
        for b, r in enumerate(wave):
            tokens[b, P - lens[b]:] = r.input_ids  # left pad
            pad_offsets[b] = P - lens[b]

        kv = self.model.init_cache(B, cap)
        pad_d = torch.from_numpy(pad_offsets).to(dev)
        positions = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
        logits, kv, _ = self._fwd(torch.from_numpy(tokens).to(dev), positions, kv, 0, pad_d)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)

        out = [list(r.input_ids) for r in wave]
        done = np.zeros(B, dtype=bool)
        ngen = np.zeros(B, dtype=np.int64)
        cur = P
        for step in range(max_new):
            tok_host = nxt.cpu().numpy()
            _record(out, done, ngen, wave, tok_host)
            if done.all() or step == max_new - 1:
                break
            positions = torch.full((B, 1), cur, dtype=torch.int32, device=dev)
            logits, kv, _ = self._fwd(nxt[:, None].to(torch.int32), positions, kv, cur, pad_d)
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            cur += 1

        for b, r in enumerate(wave):
            r.future.set_result(np.asarray(out[b], dtype=np.int64))


class Seq2SeqDynamicBatcher(_WaveLoop):
    """Wave batching for encoder-decoder models (Switch, NLLB): one batched
    encode and one batched greedy decode per wave. Futures resolve to the
    decoder ids [start, tok, ...], one row of ``Seq2SeqGenerator.generate``'s
    sequences."""

    def __init__(self, model, params, experts, for_layer: Callable, *, impl: str = "ragged",
                 max_batch_size: int = 8,
                 # small: a lone request pays it once per wave, so it must be
                 # negligible against one decode step; bursts still coalesce
                 max_wait_s: float = 0.005, max_seq_len: int = 512):
        self.model = model
        self.params = params
        self.experts = experts
        self._for_layer = for_layer
        self.impl = impl
        self.max_seq_len = max_seq_len
        self._start(max_batch_size, max_wait_s, model.device)

    def _run_wave(self, wave: Sequence[_Request]) -> None:
        model, s, dev = self.model, self.model.spec, self._device
        B = len(wave)
        lens = [len(r.input_ids) for r in wave]
        if max(lens) > self.max_seq_len:
            raise ValueError(
                f"source length {max(lens)} exceeds max_seq_len={self.max_seq_len}; "
                "the wave batcher never truncates")
        S = min(self.max_seq_len, _bucket_len(max(lens)))
        max_new = max(r.max_new_tokens for r in wave)
        pad = getattr(s, "pad_token_id", 0)
        tokens = np.full((B, S), pad, dtype=np.int64)
        mask = np.zeros((B, S), dtype=np.float32)
        for b, r in enumerate(wave):
            tokens[b, :lens[b]] = r.input_ids
            mask[b, :lens[b]] = 1.0

        mask_d = torch.from_numpy(mask).to(dev)
        enc = model.encode(self.params, self.experts, torch.from_numpy(tokens).to(dev), mask_d,
                           self._for_layer, self.impl)
        cross = model.cross_kv(self.params, enc)
        kvs = model.init_cache(B, _bucket_len(max_new + 1))
        start = s.decoder_start_token_id
        cur = torch.full((B, 1), start, dtype=torch.int32, device=dev)
        out = [[start] for _ in wave]
        done = np.zeros(B, dtype=bool)
        ngen = np.zeros(B, dtype=np.int64)
        for step in range(max_new):
            positions = torch.full((B, 1), step, dtype=torch.int32, device=dev)
            logits, kvs, _ = model.decode_step(self.params, self.experts, cur, positions, kvs,
                                               step, mask_d, cross, self._for_layer, self.impl)
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            _record(out, done, ngen, wave, nxt.cpu().numpy())
            if done.all():
                break
            cur = nxt[:, None].to(torch.int32)

        for b, r in enumerate(wave):
            r.future.set_result(np.asarray(out[b], dtype=np.int64))
