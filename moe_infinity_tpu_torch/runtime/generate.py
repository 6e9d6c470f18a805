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

``decode_scan`` (``ResidentStepper`` and ``Seq2SeqGenerator``), the JAX
package's whole decode loop as one jitted ``lax.scan``: the token, the
positions and the sampler's state (its penalty counts, updated in place,
and a CUDA generator registered with the graphs, so that every replay draws
fresh noise and a seed gives the eager run's tokens) live in device
buffers; on the card the steps run as replays of CUDA graphs of
``SCAN_BLOCK`` steps (and one of the remainder), keyed by the block, the
sampling parameters, the batch and the cache capacity, never by the start
position, which is a device input. Nothing is read on the host between the
first step and the copy of the tokens the caller makes. ``graphs=False``
and the CPU run the same steps eagerly.

Under a mesh (``parallel/mesh.py``) ``ResidentStepper.set_data_sharding``
gives each data rank its share of the batch rows; ``forward`` and
``decode_scan`` return the whole batch on every rank, gathered with an
``all_reduce`` of a zero-filled buffer.
"""

from __future__ import annotations

import dataclasses
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
from moe_infinity_tpu_torch.runtime.sampling import (
    Sampler,
    SamplerState,
    SamplingParams,
    _bias_row,
    gumbel,
    params_from_kwargs,
    sample_step,
)
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


# decode_scan's graph length: the steps one CUDA graph replays. A replay costs
# the host one launch, some microseconds, against about a millisecond of the
# card's time per step of Mixtral-8x7B, so 8 steps leave its share of a token
# under a percent; a longer block only makes the capture longer (its warm-up
# runs the block once) and the graph larger. 8 divides the bench's 16- and
# 32-token runs, which then need no graph of a remainder.
SCAN_BLOCK = 8


def _scan_blocks(num_steps: int, block: int = SCAN_BLOCK) -> List[int]:
    """The graph lengths of a ``num_steps`` scan: whole blocks, then the rest."""
    full, rest = divmod(int(num_steps), block)
    return [block] * full + ([rest] if rest else [])


def _scan_params(sampling: Optional[SamplingParams], vocab: int, device):
    """(params of the in-graph sampler or None for argmax, the logit bias
    [V] or an empty tensor). The bias is a tensor made before any capture
    (``process_logits`` would copy it from the host inside the graph), and
    logprobs, which ``decode_scan`` does not return, are not computed."""
    if sampling is None:
        return None, torch.zeros(0, dtype=torch.float32, device=device)
    bias = _bias_row(sampling.logit_bias, vocab, torch.float32, device)
    sp = dataclasses.replace(sampling, logit_bias=None, logprobs=0)
    if bias is None:
        bias = torch.zeros(0, dtype=torch.float32, device=device)
    return (None if sp.trivial else sp), bias


def _scan_state(tok0, B: int, vocab: int, sp) -> dict:
    """The sampler's device state of a scan: the fed-back token [B, 1] int32
    and the penalty counts [B, V] int32 (zero-size when a penalty is off),
    which start empty as in the JAX scan (no prompt counted)."""
    dev = tok0.device

    def counts(on):
        return torch.zeros((B, vocab if on else 0), dtype=torch.int32, device=dev)

    return {"tok": tok0.to(torch.int32).reshape(B, 1).clone(),
            "counts_full": counts(sp is not None and sp.needs_full_counts),
            "counts_gen": counts(sp is not None and sp.needs_gen_counts)}


def _scan_pick(logits, sp, bias, counts_full, counts_gen, generator, noise_rows=None):
    """The next token [B] int64 of a scan step from its raw [B, V] logits:
    the bias, then argmax, or the sampler with its counts updated in place.
    ``noise_rows`` (lo, hi, batch): a data rank's rows of the whole batch's
    noise, so that the draws do not depend on the sharding."""
    if bias.numel():
        logits = logits + bias
    if sp is None:
        return torch.argmax(logits, dim=-1)
    noise = None
    if not sp.greedy and noise_rows is not None:
        lo, hi, batch = noise_rows
        noise = gumbel((batch, logits.shape[-1]), generator, logits.device, logits.dtype)[lo:hi]
    out, _ = sample_step(logits, SamplerState(generator, counts_full, counts_gen), sp,
                         noise, inplace=True)
    return out.token


def _scan_generator(sp, device, seed: int, graphs, cache: dict, key):
    """The generator of a sampled scan: a fresh one, seeded, when it runs
    eagerly; with graphs one per key, which the graphs close over (on the
    card registered with each of them, ``CudaGraphBackend.capture``) and
    ``_run_scan`` reseeds per call."""
    if sp is None or sp.greedy:
        return None
    if graphs is None:
        return torch.Generator(device=device).manual_seed(int(seed))
    gen = cache.get(key)
    if gen is None:
        gen = cache[key] = torch.Generator(device=device)
    return gen


def _run_scan(graphs, name, make_block, state: dict, closes_over, num_steps: int,
              B: int, gen, seed: int, device):
    """The scan's tokens [B, num_steps] int64: eagerly, ``make_block(n)(**state)``
    per block; with graphs, every block length's graph is captured first
    (their warm-ups run on copies of the state and move the generator on),
    the generator is reseeded, and each block is one replay fed the state
    the replay before left in its buffers."""
    out = torch.empty(B, num_steps, dtype=torch.int64, device=device)
    blocks = _scan_blocks(num_steps)
    if graphs is None:
        done = 0
        for n in blocks:
            toks, *rest = make_block(n)(**state)
            state = dict(zip(state, rest))
            out[:, done:done + n] = toks
            done += n
        return out
    gens = [gen] if gen is not None and torch.device(device).type == "cuda" else []
    made = {n: graphs.get((name, n), make_block(n), state, closes_over, steps=n,
                          generators=gens)
            for n in sorted(set(blocks))}
    if gen is not None:
        gen.manual_seed(int(seed))
    done = 0
    for n in blocks:
        toks, *rest = graphs.replay(made[n], state)
        state = dict(zip(state, rest))
        out[:, done:done + n] = toks
        done += n
    return out


class _Serial:
    """One decode at a time over a graph owner's buffers: a lock, and on the
    card the current stream ordered after the last decode's replays (the
    host lock does not order the device: another thread's stream could
    copy its inputs in while they are still queued). Whatever leaves the
    scope must be a copy of a graph output."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done: Optional[torch.cuda.Event] = None

    @contextmanager
    def hold(self, dev: torch.device):
        with self._lock:
            if self._done is not None:
                torch.cuda.current_stream(dev).wait_event(self._done)
            try:
                yield
            finally:
                if dev.type == "cuda":
                    self._done = torch.cuda.Event()
                    self._done.record(torch.cuda.current_stream(dev))


class ResidentStepper:
    """Whole-model forward over fully resident experts (decoder-only)."""

    def __init__(self, model, params, experts, for_layer: Callable, *,
                 impl: str = "ragged", prefill_impl: Optional[str] = None,
                 graphs: bool = True, graph_backend=None):
        """impl: the grouped-FFN implementation of one-token steps
        (``"pallas"`` is K3); prefill_impl: that of longer steps (default
        ``impl``). graphs / graph_backend: ``decode_scan`` as CUDA graphs
        (``runtime/graphs.py::graph_cache``; on the card an ``impl`` that
        cannot be captured raises there unless graphs is False)."""
        self.model = model
        self.params = params
        self.experts = experts
        self._for_layer = for_layer
        self._impl = impl
        self._prefill_impl = prefill_impl or impl
        self._graphs_on = graphs
        self._graph_backend = graph_backend
        self.graphs = None  # made at the first decode_scan that uses graphs
        self._scan_gens: dict = {}
        self._dp_mesh = None
        self._dp_axis = "data"

    def set_data_sharding(self, mesh, axis: str = "data") -> None:
        """Data parallelism over ``axis`` of ``mesh`` (``parallel/mesh.py``):
        each rank of the axis steps its ``B / n`` batch rows over a cache of
        those rows, and ``forward`` and ``decode_scan`` return the whole batch
        on every rank. A batch that ``n`` does not divide runs replicated,
        every rank stepping every row, as the JAX version's ``put`` leaves
        such an array replicated."""
        self._dp_mesh = mesh
        self._dp_axis = axis

    def _rows(self, batch: int) -> Tuple[int, int]:
        """This rank's batch rows [lo, hi)."""
        mesh = self._dp_mesh
        n = 1 if mesh is None else mesh.shape[self._dp_axis]
        if n == 1 or batch % n:
            return 0, batch
        i = mesh.axis_index(self._dp_axis)
        return i * batch // n, (i + 1) * batch // n

    def _gather(self, t, batch: int):
        """The whole batch's tensor from this rank's rows of it (dim 0)."""
        lo, hi = self._rows(batch)
        if hi - lo == batch:
            return t
        return self._dp_mesh.gather_rows(t, lo, batch, self._dp_axis)

    def init_cache(self, batch: int, max_len: int):
        lo, hi = self._rows(batch)
        return self.model.init_cache(hi - lo, max_len)

    def begin_sequences(self, batch: int):
        return None

    def end_sequences(self, seq_ids):
        pass

    def forward(self, tokens, positions, kv, kv_len: int, seq_ids=None):
        """(logits [B, T, V] f32, kv, router trace)."""
        impl = self._impl if tokens.shape[1] == 1 else self._prefill_impl
        B = tokens.shape[0]
        lo, hi = self._rows(B)
        logits, kv, trace = self.model.forward(
            self.params, self.experts, tokens[lo:hi], positions[lo:hi], kv, kv_len,
            for_layer=self._for_layer, impl=impl,
        )
        if hi - lo == B:
            return logits, kv, trace
        ids, w = trace
        return (self._gather(logits, B), kv,
                (self._gather(ids.transpose(0, 1), B).transpose(0, 1),
                 self._gather(w.transpose(0, 1), B).transpose(0, 1)))

    @torch.inference_mode()
    def decode_scan(self, tok0, pos0, kv, num_steps: int,
                    sampling: Optional[SamplingParams] = None, seed: int = 0):
        """Decode ``num_steps`` tokens from ``tok0`` [B, 1] at cache columns
        ``pos0`` [B] over ``kv`` (the caches of ``init_cache``, holding the
        prompt): step i feeds token i back at ``pos0 + i`` with
        ``kv_len = pos[0]``, as the JAX body does. Greedy unless
        ``sampling`` (``SamplingParams``) says otherwise. Returns ([B, N]
        int64 tokens on the device, the caches). With graphs the caches
        returned are the stepper's own buffers of that shape (``kv`` is
        copied in unless it is them), which its next ``decode_scan`` of the
        shape overwrites."""
        model, dev = self.model, self.model.device
        tok0 = torch.as_tensor(tok0).to(dev)
        B = tok0.shape[0]
        pos0 = torch.as_tensor(pos0).to(dev).to(torch.int32).reshape(B)
        lo, hi = self._rows(B)
        b, cap = hi - lo, kv[0].max_len
        vocab = model.spec.vocab_size
        sp, bias = _scan_params(sampling, vocab, dev)
        state = _scan_state(tok0[lo:hi], b, vocab, sp)
        state["pos"] = pos0[lo:hi].clone()
        state["bias"] = bias
        graphs = self._scan_graphs()
        if graphs is not None and self._dp_mesh is not None:
            raise ValueError("decode_scan under a mesh runs its collectives on the host "
                             "(gloo): build the stepper with graphs=False")
        noise_rows = (lo, hi, B) if b != B else None
        gen = _scan_generator(sp, dev, seed, graphs, self._scan_gens, (sampling, b))

        def run(kvs):
            def make_block(n):
                def block(tok, counts_full, counts_gen, pos, bias):
                    toks = []
                    for _ in range(n):
                        logits, _, _ = model.forward(
                            self.params, self.experts, tok, pos[:, None], kvs, pos[0],
                            for_layer=self._for_layer, impl=self._impl)
                        nxt = _scan_pick(logits[:, -1, :], sp, bias, counts_full, counts_gen,
                                         gen, noise_rows)
                        tok.copy_(nxt[:, None])
                        pos.add_(1)
                        toks.append(nxt)
                    return torch.stack(toks, 1), tok, counts_full, counts_gen, pos, bias
                return block

            closes = [] if graphs is None else [*self._weights, *flat_tensors(kvs)]
            return _run_scan(graphs, ("scan", sampling), make_block, state, closes,
                             num_steps, b, gen, seed, dev)

        if graphs is None:
            toks = run(kv)
        else:
            with self._serial.hold(dev):
                kvs = self._buffers.caches(b, cap)
                if kvs[0].k.data_ptr() != kv[0].k.data_ptr():
                    for dst, src in zip(flat_tensors(kvs), flat_tensors(kv)):
                        dst.copy_(src)
                kv = kvs
                toks = run(kvs)
        return self._gather(toks, B), kv

    def _scan_graphs(self):
        """The graph cache of ``decode_scan`` (None when it runs eagerly)."""
        if self.graphs is None and self._graphs_on:
            self.graphs = graph_cache(True, self._graph_backend, self.model.device, self._impl)
            if self.graphs is not None:
                self._buffers = DecodeBuffers(self.model)
                self._weights = flat_tensors(self.params) + flat_tensors(self.experts)
                self._serial = _Serial()
        return self.graphs

    def graph_stats(self) -> dict:
        """Captures, replays and capture seconds of ``decode_scan``'s graphs
        (empty when none was made)."""
        return self.graphs.stats() if self.graphs is not None else {}


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
        self._scan_gens: dict = {}
        if self.graphs is not None:
            self._buffers = DecodeBuffers(model)
            self._weights = flat_tensors(params) + flat_tensors(experts)
            self._serial = _Serial()

    @contextmanager
    def _decoding(self):
        """One request's hold on the buffers and graphs, with graphs on
        (``_Serial``); ``generate`` and ``decode_scan`` share it."""
        if self.graphs is None:
            yield
            return
        with self._serial.hold(self.model.device):
            yield

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

    @torch.inference_mode()
    def decode_scan(self, input_ids: np.ndarray, num_steps: int, *,
                    attention_mask: Optional[np.ndarray] = None,
                    decoder_start_token_id: Optional[int] = None,
                    sampling: Optional[SamplingParams] = None, seed: int = 0):
        """Encode ``input_ids`` [B, T] (numpy, or tensors on the model's
        device, which are read nowhere on the host) once, compute the cross
        K/V, then decode ``num_steps``
        tokens over a cache of ``_bucket_len(num_steps + 1)`` columns, step i
        at column i, with no host read between the first step and the copy
        of the tokens (``generate`` reads each step's token when it stops at
        EOS or samples). Greedy unless ``sampling`` says otherwise. Returns
        ([B, num_steps] int64 tokens on the device, the K/V caches; with
        graphs the generator's buffers, which its next decode of the shape
        overwrites)."""
        model, dev = self.model, self.model.device
        if not isinstance(input_ids, torch.Tensor):  # a device tensor is taken as it is
            input_ids = np.atleast_2d(np.asarray(input_ids))
        B, T = input_ids.shape
        start = (decoder_start_token_id if decoder_start_token_id is not None
                 else model.spec.decoder_start_token_id)
        tokens = torch.as_tensor(input_ids, dtype=torch.int32).to(dev)
        mask = (torch.as_tensor(attention_mask, dtype=torch.float32).to(dev)
                if attention_mask is not None
                else torch.ones(B, T, dtype=torch.float32, device=dev))
        enc_out = model.encode(self.params, self.experts, tokens, mask,
                               self._for_layer, self._impl)
        cross = model.cross_kv(self.params, enc_out)
        cap = _bucket_len(num_steps + 1)
        vocab = model.spec.vocab_size
        sp, bias = _scan_params(sampling, vocab, dev)
        state = _scan_state(torch.full((B, 1), start, dtype=torch.int32, device=dev),
                            B, vocab, sp)
        state["step"] = torch.zeros((), dtype=torch.int32, device=dev)
        state["bias"] = bias
        gen = _scan_generator(sp, dev, seed, self.graphs, self._scan_gens, (sampling, B))

        def run(kvs, mask, cross):
            def make_block(n):
                def block(tok, counts_full, counts_gen, step, bias):
                    toks = []
                    for _ in range(n):
                        logits, _, _ = model.decode_step(
                            self.params, self.experts, tok, step_positions(step, B, dev), kvs,
                            step, mask, cross, self._for_layer, self._impl)
                        nxt = _scan_pick(logits[:, -1, :], sp, bias, counts_full, counts_gen,
                                         gen)
                        tok.copy_(nxt[:, None])
                        step.add_(1)
                        toks.append(nxt)
                    return torch.stack(toks, 1), tok, counts_full, counts_gen, step, bias
                return block

            closes = ([] if self.graphs is None
                      else [*self._weights, *flat_tensors(kvs), mask, *flat_tensors(cross)])
            return _run_scan(self.graphs, ("scan", sampling), make_block, state, closes,
                             num_steps, B, gen, seed, dev)

        if self.graphs is None:
            kvs = model.init_cache(B, cap)
            return run(kvs, mask, cross), kvs
        with self._decoding():
            kvs, mask, cross = self._buffers.take(B, cap, mask, cross)
            return run(kvs, mask, cross), kvs

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
