"""Token generation, from ``moe_infinity_tpu/runtime/generate.py``.

* ``Generator`` over a stepper (decoder-only models): a ``ResidentStepper``
  (every expert resident) or the offload engine
  (``runtime/engine.py::OffloadEngine``). It prefills the prompt in one
  forward (K2; an einsum softmax for an MLA model), then takes one-token
  steps over a contiguous KV cache (K1, or K5 for MLA), reading each step's
  token on the host as the JAX loop does. A speculative stepper with
  ``decode_block`` decodes plain greedy requests in k-step blocks instead
  (JAX ``runtime/generate.py:505-590``), halving its ``spec_block`` on a
  capacity error.
* ``Seq2SeqGenerator`` (encoder-decoder): encodes once, computes the
  cross-attention K/V, then decodes in a Python loop. On the card each
  step is one replay of a CUDA graph per (B, capacity, S_enc)
  (``runtime/graphs.py``), the counterpart of the JAX version's jitted
  ``_step``: the token and the step are its device inputs, and the
  generator owns the K/V caches, cross K/V and mask it reads
  (``graphs=False`` runs the step eagerly). With graphs one request decodes
  at a time: concurrent ``generate`` calls of one shape would share those
  buffers and the graph's static outputs, so each holds the generator's
  lock from copying its inputs in to its last read of an output, and the
  next request's stream waits for the last replay's (the JAX version keeps
  no per-call buffers, so its calls are independent). A plain greedy loop
  keeps the tokens on the device and copies them to the host once at the end; with
  ``eos_token_id`` set, or any sampling, it reads each step's tokens on the
  host, as the JAX version does.

Both take the JAX signature's sampling keywords (``runtime/sampling.py``:
temperature, top-k/p, min-p, penalties, ``logit_bias``, logprobs with
``top_logprobs``/``top_tokens`` in ``GenerationResult``); the sampler runs
as tensor ops on the model's device after each step's logits.
``decode_scan`` (the JAX on-device scan) raises ``NotImplementedError``
(ROADMAP queue-1 item 11).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from moe_infinity_tpu_torch.runtime.engine import is_spec_capacity_error, quantize_block
from moe_infinity_tpu_torch.runtime.graphs import (
    DecodeBuffers,
    flat_tensors,
    graph_cache,
    step_positions,
)
from moe_infinity_tpu_torch.runtime.sampling import Sampler, params_from_kwargs
from moe_infinity_tpu_torch.utils.logger import get_logger

_log = get_logger("generate")


def eos_hit(tok, eos_token_id):
    """HF semantics: eos_token_id may be an int or a list/tuple of ints."""
    if isinstance(eos_token_id, (list, tuple)):
        return np.isin(tok, np.asarray(eos_token_id))
    return tok == eos_token_id


def _bucket_len(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


@dataclass
class GenerationResult:
    # decoder-only: [B, prompt + new] padded with pad_token_id;
    # seq2seq: [B, 1 + new], the decoder start token, then tokens
    sequences: np.ndarray
    num_generated: np.ndarray  # [B]
    router_trace: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
    # encode_ms / decode_ms: device time (CUDA events) or host time (CPU)
    stats: dict = field(default_factory=dict)
    # with logprobs: [B, steps], [B, steps, N], [B, steps, N]
    token_logprobs: Optional[np.ndarray] = None
    top_logprobs: Optional[np.ndarray] = None
    top_tokens: Optional[np.ndarray] = None


class _Logprobs:
    """Host copies of each sampled step's logprobs, when asked for."""

    def __init__(self, n: int):
        self.n = n
        self.tok, self.top, self.ids = [], [], []

    def record(self, sout) -> None:
        if self.n > 0:
            self.tok.append(sout.logprob.cpu().numpy())
            self.top.append(sout.top_logprobs.cpu().numpy())
            self.ids.append(sout.top_tokens.cpu().numpy())

    def fields(self) -> dict:
        if not self.tok:
            return {}
        return {"token_logprobs": np.stack(self.tok, 1), "top_logprobs": np.stack(self.top, 1),
                "top_tokens": np.stack(self.ids, 1)}


class _Clock:
    """Marks on the device's timeline (CUDA events, read after the final
    copy has synchronised) or the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


class ResidentStepper:
    """Whole-model forward over fully resident experts (decoder-only)."""

    def __init__(self, model, params, experts, for_layer: Callable, *,
                 impl: str = "ragged", prefill_impl: Optional[str] = None):
        """impl: the grouped-FFN implementation of one-token steps
        (``"pallas"`` is K3); prefill_impl: that of longer steps (default
        ``impl``)."""
        self.model = model
        self.params = params
        self.experts = experts
        self._for_layer = for_layer
        self._impl = impl
        self._prefill_impl = prefill_impl or impl

    def init_cache(self, batch: int, max_len: int):
        return self.model.init_cache(batch, max_len)

    def begin_sequences(self, batch: int):
        return None

    def end_sequences(self, seq_ids):
        pass

    def forward(self, tokens, positions, kv, kv_len: int, seq_ids=None):
        """(logits [B, T, V] f32, kv, router trace)."""
        impl = self._impl if tokens.shape[1] == 1 else self._prefill_impl
        return self.model.forward(
            self.params, self.experts, tokens, positions, kv, kv_len,
            for_layer=self._for_layer, impl=impl,
        )

    def decode_scan(self, *args, **kwargs):
        raise NotImplementedError(
            "decode_scan (the JAX package's on-device lax.scan decode loop) is not "
            "ported (ROADMAP queue-1 item 11)"
        )


class Generator:
    """Host-side generation loop over a stepper (decoder-only)."""

    def __init__(self, model=None, params=None, experts=None,
                 for_layer: Optional[Callable] = None, *, stepper=None,
                 impl: str = "ragged", prefill_impl: Optional[str] = None,
                 max_seq_len: int = 2048):
        if stepper is None:
            if model is None or params is None:
                raise ValueError("pass either stepper= or (model, params, experts, for_layer)")
            stepper = ResidentStepper(model, params, experts, for_layer, impl=impl,
                                      prefill_impl=prefill_impl)
        self.stepper = stepper
        self.max_seq_len = max_seq_len

    @torch.inference_mode()
    def generate(
        self,
        input_ids: np.ndarray,  # [B, T] prompts of one length
        max_new_tokens: int = 32,
        *,
        eos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
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
        collect_trace: bool = False,
        cache_len: Optional[int] = None,
    ) -> GenerationResult:
        """Prefill, then one step per new token, each token picked by the
        sampler (``runtime/sampling.py``) from the step's logits.
        cache_len: the KV capacity (default: bucketed from the prompt and
        the new tokens), so that a warm-up and a timed call share one
        capacity, and so one graph per step shape. A speculative stepper
        with ``decode_block`` and a ``spec_block`` above 1 decodes plain
        greedy requests (no penalty, bias or logprobs) in k-step blocks when
        no trace is collected: each yields k tokens, consumed one per step
        by the bookkeeping below; a capacity error halves ``spec_block``."""
        input_ids = np.asarray(input_ids)
        if input_ids.ndim == 1:
            input_ids = input_ids[None]
        B, T = input_ids.shape
        cap = cache_len or min(self.max_seq_len, _bucket_len(T + max_new_tokens))
        if T + max_new_tokens > cap:
            raise ValueError(f"prompt {T} + new {max_new_tokens} exceeds capacity {cap}")
        sp = params_from_kwargs(
            temperature=temperature, do_sample=do_sample, top_k=top_k, top_p=top_p,
            min_p=min_p, repetition_penalty=repetition_penalty,
            presence_penalty=presence_penalty, frequency_penalty=frequency_penalty,
            logprobs=logprobs, logit_bias=logit_bias,
        )
        sampler = Sampler(sp)
        stepper = self.stepper
        dev = stepper.model.device
        kv = stepper.init_cache(B, cap)
        seq_ids = stepper.begin_sequences(B)

        tokens = torch.as_tensor(input_ids, dtype=torch.int32).to(dev)
        positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        logits, kv, trace = stepper.forward(tokens, positions, kv, 0, seq_ids=seq_ids)
        traces = []
        if collect_trace:
            traces.append((trace[0].cpu().numpy(), trace[1].cpu().numpy()))
        state = sampler.init(B, logits.shape[-1], prompt_ids=input_ids, seed=seed, device=dev)
        lps = _Logprobs(sp.logprobs)
        sout, state = sampler(logits[:, -1, :], state)
        lps.record(sout)
        next_tok = sout.token

        out = np.full((B, T + max_new_tokens), pad_token_id, dtype=np.int64)
        out[:, :T] = input_ids
        finished = np.zeros(B, dtype=bool)
        num_gen = np.zeros(B, dtype=np.int64)
        use_blocks = (sp.trivial and not collect_trace
                      and getattr(stepper, "speculative", False)
                      and hasattr(stepper, "decode_block"))
        pending: list = []  # a block's tokens not yet recorded, as numpy [B]
        cur = T
        for step in range(max_new_tokens):
            tok_host = next_tok if isinstance(next_tok, np.ndarray) else next_tok.cpu().numpy()
            out[~finished, cur] = tok_host[~finished]
            num_gen[~finished] += 1
            cur += 1
            if eos_token_id is not None:
                finished |= eos_hit(tok_host, eos_token_id)
                if finished.all():
                    break
            if step == max_new_tokens - 1:
                break
            if pending:
                next_tok = pending.pop(0)
                continue
            tok_dev = torch.as_tensor(tok_host[:, None], dtype=torch.int32).to(dev)
            if use_blocks and stepper.spec_block > 1:
                k = quantize_block(max_new_tokens - 1 - step, stepper.spec_block)
                if k >= 2:
                    try:
                        toks, kv = stepper.decode_block(tok_dev, cur - 1, kv, k, seq_ids=seq_ids)
                    except RuntimeError as e:
                        if not is_spec_capacity_error(e):
                            raise
                        # the arena cannot hold a k-step union: halve the
                        # block, and make this token's progress by one step
                        stepper.spec_block = max(1, stepper.spec_block // 2)
                        _log.warning("speculative block decode degraded to k=%d (%s)",
                                     stepper.spec_block, e)
                    else:
                        next_tok = toks[:, 0].astype(np.int64)
                        pending = [toks[:, j].astype(np.int64) for j in range(1, k)]
                        continue
            positions = torch.full((B, 1), cur - 1, dtype=torch.int32, device=dev)
            logits, kv, trace = stepper.forward(tok_dev, positions, kv, cur - 1, seq_ids=seq_ids)
            if collect_trace:
                traces.append((trace[0].cpu().numpy(), trace[1].cpu().numpy()))
            sout, state = sampler(logits[:, -1, :], state)
            lps.record(sout)
            next_tok = sout.token

        stepper.end_sequences(seq_ids)
        return GenerationResult(
            sequences=out[:, :cur],
            num_generated=num_gen,
            router_trace=traces if collect_trace else None,
            **lps.fields(),
        )


class Seq2SeqGenerator:
    """Encoder-decoder generation (NLLB, Switch): encode once, precompute
    cross-attention K/V, then incremental decode."""

    def __init__(self, model, params, experts, for_layer: Callable, *,
                 impl: str = "ragged", graphs: bool = True, graph_backend=None):
        """graphs: run each decode step as a CUDA graph on the card (False
        runs it eagerly); graph_backend: the capture backend (default
        ``CudaGraphBackend`` on a CUDA model; on the CPU the step runs
        eagerly unless one is given). On the card an ``impl`` that cannot be
        captured ("ragged") raises ``ValueError`` unless graphs is False."""
        self.model = model
        self.params = params
        self.experts = experts
        self._for_layer = for_layer
        self._impl = impl
        self.graphs = graph_cache(graphs, graph_backend, model.device, impl)
        if self.graphs is not None:
            self._buffers = DecodeBuffers(model)
            self._weights = flat_tensors(params) + flat_tensors(experts)
            self._lock = threading.Lock()
            self._done: Optional[torch.cuda.Event] = None  # the last decode's replays

    @contextmanager
    def _decoding(self):
        """One request's hold on the buffers and graphs, with graphs on: the
        lock, and on the card the current stream ordered after the replays of
        the decode before (the host lock does not order the device: another
        thread's stream could copy its mask in while they are still queued).
        Whatever leaves the scope must be a copy of a graph output."""
        if self.graphs is None:
            yield
            return
        dev = self.model.device
        with self._lock:
            if self._done is not None:
                torch.cuda.current_stream(dev).wait_event(self._done)
            try:
                yield
            finally:
                if dev.type == "cuda":
                    self._done = torch.cuda.Event()
                    self._done.record(torch.cuda.current_stream(dev))

    def decoder(self, B: int, cap: int, mask, cross):
        """``step(cur [B, 1] int32, step) -> (logits [B, 1, V] f32, next
        token [B] int64)`` over a cache of ``cap`` columns. With graphs the
        mask and cross K/V are copied into the generator's buffers and each
        call is one replay, whose outputs the next overwrites."""
        model = self.model
        if self.graphs is None:
            kvs = model.init_cache(B, cap)
        else:
            kvs, mask, cross = self._buffers.take(B, cap, mask, cross)

        def run(cur, step):
            logits, _, _ = model.decode_step(
                self.params, self.experts, cur, step_positions(step, B, cur.device), kvs,
                step, mask, cross, self._for_layer, self._impl,
            )
            return logits, torch.argmax(logits[:, -1, :], dim=-1)

        if self.graphs is None:
            return run
        reads = [*self._weights, *flat_tensors(kvs), mask, *flat_tensors(cross)]
        return lambda cur, step: self.graphs.run("step", run, {"cur": cur, "step": step}, reads)

    def graph_stats(self) -> dict:
        """Captures, replays and capture seconds of the generator's graphs
        (empty when it runs eagerly)."""
        return self.graphs.stats() if self.graphs is not None else {}

    def decode_scan(self, *args, **kwargs):
        raise NotImplementedError(
            "decode_scan (the JAX package's on-device lax.scan decode loop) is not "
            "ported (ROADMAP queue-1 item 11)"
        )

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
    ) -> GenerationResult:
        """Decode ``max_new_tokens`` per row, each token picked by the sampler
        (``runtime/sampling.py``) from the step's logits; the repetition
        penalty counts decoder ids only, as HF's does for an encoder-decoder
        (at step 0 just the start token)."""
        sp = params_from_kwargs(
            temperature=temperature, do_sample=do_sample, top_k=top_k, top_p=top_p,
            min_p=min_p, repetition_penalty=repetition_penalty,
            presence_penalty=presence_penalty, frequency_penalty=frequency_penalty,
            logprobs=logprobs, logit_bias=logit_bias,
        )
        model, dev = self.model, self.model.device
        input_ids = np.atleast_2d(np.asarray(input_ids))
        B, T = input_ids.shape
        start = (decoder_start_token_id if decoder_start_token_id is not None
                 else model.spec.decoder_start_token_id)
        tokens = torch.as_tensor(input_ids, dtype=torch.int32).to(dev)
        mask = (torch.as_tensor(attention_mask, dtype=torch.float32).to(dev)
                if attention_mask is not None
                else torch.ones(B, T, dtype=torch.float32, device=dev))

        clock = _Clock(dev)
        t0 = clock.mark()
        enc_out = model.encode(self.params, self.experts, tokens, mask,
                               self._for_layer, self._impl)
        cross = model.cross_kv(self.params, enc_out)
        t1 = clock.mark()

        out = np.full((B, max_new_tokens + 1), pad_token_id, dtype=np.int64)
        out[:, 0] = start
        finished = np.zeros(B, dtype=bool)
        num_gen = np.zeros(B, dtype=np.int64)
        new_toks = torch.empty(B, max_new_tokens, dtype=torch.int64, device=dev)
        cur = torch.full((B, 1), start, dtype=torch.int32, device=dev)
        sampler, state, lps = Sampler(sp), None, _Logprobs(sp.logprobs)
        host_loop = eos_token_id is not None or not sp.trivial
        steps = 0
        with self._decoding():
            step_fn = self.decoder(B, _bucket_len(max_new_tokens + 1), mask, cross)
            for step in range(max_new_tokens):
                logits, nxt = step_fn(cur, step)
                if not sp.trivial:
                    if state is None:
                        state = sampler.init(B, logits.shape[-1],
                                             prompt_ids=np.full((B, 1), start), seed=seed,
                                             device=dev)
                    # the sampler's state and logprobs are new tensors, not views
                    sout, state = sampler(logits[:, -1, :], state)
                    lps.record(sout)
                    nxt = sout.token
                new_toks[:, step] = nxt
                steps = step + 1
                if host_loop:
                    tok_host = nxt.cpu().numpy()
                    out[~finished, step + 1] = tok_host[~finished]
                    num_gen[~finished] += 1
                    if eos_token_id is not None:
                        finished |= eos_hit(tok_host, eos_token_id)
                        if finished.all():
                            break
                cur = nxt[:, None].to(torch.int32)  # a copy: int64 -> int32
        t2 = clock.mark()
        if not host_loop:
            out[:, 1:steps + 1] = new_toks[:, :steps].cpu().numpy()  # one sync
            num_gen[:] = steps
        stats = {"encode_ms": clock.ms(t0, t1), "decode_ms": clock.ms(t1, t2),
                 "decode_steps": steps}
        return GenerationResult(
            sequences=out[:, : int(num_gen.max()) + 1],
            num_generated=num_gen,
            stats=stats,
            **lps.fields(),
        )
