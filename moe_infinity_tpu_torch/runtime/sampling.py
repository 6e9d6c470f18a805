"""Sampling on the model's device, from ``moe_infinity_tpu/runtime/sampling.py``:
the OpenAI/HF sampling surface as tensor ops with HF semantics
(``transformers.generation.logits_process``):

* temperature, top-k, top-p and min-p, in HF's warper order (temperature ->
  top-k -> top-p -> min-p);
* the repetition penalty over prompt + generated tokens;
* presence and frequency penalties (OpenAI) over generated tokens only;
* ``logit_bias`` added to the raw logits first.

The draw is kept apart from the pick: a sampled token is
``argmax(processed + noise)`` with Gumbel noise (``gumbel``), which is how
``jax.random.categorical`` draws, so a test can hand the JAX package's
noise to these functions. Draws come from explicit ``torch.Generator``s on
the logits' device: ``Sampler`` keeps one per generate call, seeded by the
request; the batcher's rows (``sample_rows``) draw from a generator seeded
by the row's ``(seed, counter)``, as the JAX version keys them by
``fold_in(PRNGKey(seed), counter)``, so a request's tokens do not depend on
its neighbours. The PRNG streams differ from JAX's, so sampled tokens do
too; the processed logits do not. Everything stays on the device; the
callers read the token on the host, as the JAX loops do, except
``decode_scan`` (``runtime/generate.py``), which keeps the sampler's state
in device buffers (``sample_step(..., inplace=True)`` adds the penalty
counts to them) and draws from a CUDA generator registered with its graphs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_NEG_INF = -float("inf")


@dataclass(frozen=True)
class SamplingParams:
    """Sampling configuration of one generate call."""

    temperature: float = 1.0
    top_k: int = 0  # 0 disables
    top_p: float = 1.0
    min_p: float = 0.0  # 0 disables
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    do_sample: bool = True
    logprobs: int = 0  # collect top-N logprobs per step (0 = off)
    # OpenAI logit_bias: ((token_id, bias), ...) added to the raw logits
    # before penalties and warpers; a sorted tuple, so the params hash
    logit_bias: Optional[Tuple[Tuple[int, float], ...]] = None

    @property
    def greedy(self) -> bool:
        return (not self.do_sample) or self.temperature == 0.0

    @property
    def needs_full_counts(self) -> bool:
        """The repetition penalty counts prompt + generated tokens."""
        return self.repetition_penalty != 1.0

    @property
    def needs_gen_counts(self) -> bool:
        """Presence/frequency penalties count generated tokens only."""
        return self.presence_penalty != 0.0 or self.frequency_penalty != 0.0

    @property
    def trivial(self) -> bool:
        """Plain greedy with no penalties, bias or logprobs: argmax."""
        return (
            self.greedy
            and not self.needs_full_counts
            and not self.needs_gen_counts
            and self.logprobs == 0
            and not self.logit_bias
        )


class SamplerState(NamedTuple):
    """Per-call state: the draw generator (None when greedy) and the count
    tensors [B, V] int32 (zero-size V axis when the penalty is off)."""

    generator: Optional[torch.Generator]
    counts_full: torch.Tensor  # prompt + generated (repetition penalty)
    counts_gen: torch.Tensor  # generated only (presence/frequency)


class StepOutput(NamedTuple):
    token: torch.Tensor  # [B] int64
    logprob: torch.Tensor  # [B] f32 log-prob of the chosen token (raw logits)
    top_logprobs: torch.Tensor  # [B, N] f32
    top_tokens: torch.Tensor  # [B, N] int64


# ---------------------------------------------------------------------------
# logit processors (HF semantics)
# ---------------------------------------------------------------------------


def apply_repetition_penalty(logits, counts, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor: for every token that has
    appeared, divide positive scores by ``penalty``, multiply negative ones."""
    scaled = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(counts > 0, scaled, logits)


def apply_presence_frequency(logits, counts, presence: float, frequency: float):
    """OpenAI: logit -= frequency * count + presence * 1[count > 0]."""
    c = counts.to(logits.dtype)
    return logits - frequency * c - presence * (c > 0).to(logits.dtype)


def top_k_filter(logits, k: int):
    """HF TopKLogitsWarper: keep scores >= the k-th largest, -inf the rest."""
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, _NEG_INF)


def min_p_filter(logits, min_p: float):
    """HF MinPLogitsWarper (min_tokens_to_keep=1): drop tokens whose
    probability is below min_p * max_prob. The top-1 always survives."""
    probs = torch.softmax(logits, dim=-1)
    cutoff = min_p * probs.amax(dim=-1, keepdim=True)
    return logits.masked_fill(probs < cutoff, _NEG_INF)


def _top_p_remove(logits, p):
    """Mask of the tokens HF's TopPLogitsWarper drops: sort ascending (ties
    by index), drop those whose ascending cumulative probability is <= 1 - p,
    never the largest. ``p`` is a float or a [B, 1] tensor."""
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, stable=True)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = cum <= (1.0 - p)
    remove_sorted[..., -1] = False  # keep at least one token
    return torch.zeros_like(remove_sorted).scatter_(-1, sorted_idx, remove_sorted)


def top_p_filter(logits, p: float):
    """HF TopPLogitsWarper (min_tokens_to_keep=1)."""
    return logits.masked_fill(_top_p_remove(logits, p), _NEG_INF)


def _bias_row(logit_bias, V: int, dtype, device) -> Optional[torch.Tensor]:
    """[V] bias of a normalized ``logit_bias``; out-of-vocab ids dropped."""
    items = [(t, v) for t, v in (logit_bias or ()) if 0 <= t < V]
    if not items:
        return None
    row = torch.zeros(V, dtype=dtype)
    for t, v in items:
        row[t] += v
    return row.to(device)


def process_logits(logits, state: SamplerState, params: SamplingParams):
    """The full HF processor/warper chain on raw [B, V] logits."""
    if params.logit_bias:
        # added to the raw logits first (OpenAI: "added to the logits prior
        # to sampling"); it moves the greedy argmax too
        row = _bias_row(params.logit_bias, logits.shape[-1], logits.dtype, logits.device)
        if row is not None:
            logits = logits + row
    if params.needs_full_counts:
        logits = apply_repetition_penalty(logits, state.counts_full, params.repetition_penalty)
    if params.needs_gen_counts:
        logits = apply_presence_frequency(
            logits, state.counts_gen, params.presence_penalty, params.frequency_penalty)
    if not params.greedy and params.temperature != 1.0:
        logits = logits / params.temperature
    if not params.greedy and params.top_k > 0:
        logits = top_k_filter(logits, params.top_k)
    if not params.greedy and params.top_p < 1.0:
        logits = top_p_filter(logits, params.top_p)
    if not params.greedy and params.min_p > 0.0:
        logits = min_p_filter(logits, params.min_p)
    return logits


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------


def gumbel(shape, generator: torch.Generator, device, dtype=torch.float32):
    """Standard Gumbel noise -log(-log(U)), U uniform in (0, 1), from
    ``generator`` on ``device``."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def pick(processed, noise):
    """The sampled token: argmax(processed + noise), which draws from
    softmax(processed) for Gumbel noise (-inf entries are never picked)."""
    return torch.argmax(processed + noise, dim=-1)


def _row_generator(seed: int, counter: int, device) -> torch.Generator:
    """The generator of one batcher row at one step, keyed by the request's
    seed and its count of generated tokens."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(counter) & 0xFFFFFFFF))
    return g


# ---------------------------------------------------------------------------
# state init / step
# ---------------------------------------------------------------------------


def _count_tokens(ids, mask, vocab: int):
    """[B, T] ids (+ optional validity mask) -> [B, vocab] int32 counts."""
    one = torch.ones(ids.shape, dtype=torch.int32, device=ids.device) if mask is None \
        else mask.to(torch.int32)
    return torch.zeros(ids.shape[0], vocab, dtype=torch.int32,
                       device=ids.device).scatter_add_(1, ids.long(), one)


def init_state(params: SamplingParams, batch: int, vocab: int, *, prompt_ids=None,
               prompt_mask=None, seed: int = 0, device="cpu") -> SamplerState:
    dev = torch.device(device)
    gen = None
    if not params.greedy:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    empty = torch.zeros((batch, 0), dtype=torch.int32, device=dev)
    counts_full = empty
    if params.needs_full_counts:
        if prompt_ids is not None:
            ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64).to(dev)
            mask = None if prompt_mask is None else torch.as_tensor(np.asarray(prompt_mask)).to(dev)
            counts_full = _count_tokens(ids, mask, vocab)
        else:
            counts_full = torch.zeros((batch, vocab), dtype=torch.int32, device=dev)
    counts_gen = (torch.zeros((batch, vocab), dtype=torch.int32, device=dev)
                  if params.needs_gen_counts else empty)
    return SamplerState(gen, counts_full, counts_gen)


def _top_lowest_first(x, n: int):
    """(values, indices) of the n largest along the last axis, equal values
    in ascending index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def sample_step(logits, state: SamplerState, params: SamplingParams,
                noise=None, *, inplace: bool = False) -> Tuple[StepOutput, SamplerState]:
    """One sampling step on [B, V] raw f32 logits. ``noise`` ([B, V]): the
    Gumbel noise of a sampled step (default: drawn from the state's
    generator). ``inplace``: the penalty counts are added to the state's own
    tensors (a CUDA graph's buffers, ``decode_scan``) instead of new ones."""
    processed = process_logits(logits, state, params)
    if params.greedy:
        token = torch.argmax(processed, dim=-1)
    else:
        if noise is None:
            noise = gumbel(processed.shape, state.generator, processed.device, processed.dtype)
        token = pick(processed, noise)
    B = logits.shape[0]
    if params.logprobs > 0:
        lp = torch.log_softmax(logits, dim=-1)
        chosen = lp.gather(1, token[:, None])[:, 0]
        top_lp, top_tok = _top_lowest_first(lp, params.logprobs)
    else:
        chosen = torch.zeros(B, dtype=logits.dtype, device=logits.device)
        top_lp = torch.zeros((B, 0), dtype=logits.dtype, device=logits.device)
        top_tok = torch.zeros((B, 0), dtype=torch.int64, device=logits.device)
    one = torch.ones((B, 1), dtype=torch.int32, device=logits.device)
    counts_full, counts_gen = state.counts_full, state.counts_gen
    add = "scatter_add_" if inplace else "scatter_add"
    if params.needs_full_counts:
        counts_full = getattr(counts_full, add)(1, token[:, None], one)
    if params.needs_gen_counts:
        counts_gen = getattr(counts_gen, add)(1, token[:, None], one)
    return (StepOutput(token, chosen, top_lp, top_tok),
            SamplerState(state.generator, counts_full, counts_gen))


class Sampler:
    """One params setting: ``init`` a state per call, then call per step."""

    def __init__(self, params: SamplingParams):
        self.params = params

    def init(self, batch: int, vocab: int, **kw) -> SamplerState:
        return init_state(self.params, batch, vocab, **kw)

    def __call__(self, logits, state: SamplerState) -> Tuple[StepOutput, SamplerState]:
        return sample_step(logits, state, self.params)


# ---------------------------------------------------------------------------
# row-wise (per-request) sampling for the continuous batcher
# ---------------------------------------------------------------------------


class RowParams(NamedTuple):
    """Per-row sampling parameters as [B] tensors on the device."""

    temperature: torch.Tensor  # f32; 0 = greedy
    top_k: torch.Tensor  # int64; 0 = off
    top_p: torch.Tensor  # f32; 1 = off
    min_p: torch.Tensor  # f32; 0 = off
    repetition_penalty: torch.Tensor  # f32; 1 = off
    presence_penalty: torch.Tensor  # f32
    frequency_penalty: torch.Tensor  # f32

    @classmethod
    def from_lists(cls, temperature, top_k, top_p, min_p, repetition_penalty,
                   presence_penalty, frequency_penalty, device="cpu") -> "RowParams":
        def f32(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)

        return cls(f32(temperature), torch.tensor(np.asarray(top_k, np.int64), device=device),
                   f32(top_p), f32(min_p), f32(repetition_penalty), f32(presence_penalty),
                   f32(frequency_penalty))


def process_rows(logits, counts_full, counts_gen, rp: RowParams, bias=None):
    """(greedy token [B], warped logits [B, V]) of one batched step with
    per-row parameters: the processors apply to every row (HF applies them
    in greedy mode too), the warpers to the sampling rows."""
    B, V = logits.shape
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    rep = rp.repetition_penalty[:, None]
    scaled = torch.where(logits < 0, logits * rep, logits / rep)
    x = torch.where(counts_full > 0, scaled, logits)
    c = counts_gen.to(x.dtype)
    x = x - rp.frequency_penalty[:, None] * c - rp.presence_penalty[:, None] * (c > 0).to(x.dtype)
    greedy = rp.temperature <= 0.0
    greedy_tok = torch.argmax(x, dim=-1)

    t = torch.where(greedy, torch.ones_like(rp.temperature), rp.temperature)[:, None]
    w = x / t
    # per-row top-k: keep scores >= the k-th largest (k = 0 disables)
    sorted_desc = torch.sort(w, dim=-1, descending=True).values
    k_idx = torch.clamp(rp.top_k - 1, 0, V - 1)
    kth = sorted_desc.gather(1, k_idx[:, None])
    kth = torch.where((rp.top_k > 0)[:, None], kth, torch.full_like(kth, _NEG_INF))
    w = w.masked_fill(w < kth, _NEG_INF)
    # per-row top-p (HF semantics, min_tokens_to_keep=1)
    w = w.masked_fill(_top_p_remove(w, rp.top_p[:, None]), _NEG_INF)
    # per-row min-p, after top-p as in HF's warper order
    probs = torch.softmax(w, dim=-1)
    cutoff = rp.min_p[:, None] * probs.amax(dim=-1, keepdim=True)
    w = w.masked_fill(probs < cutoff, _NEG_INF)
    return greedy_tok, w


def sample_rows(logits, seeds: Sequence[Optional[int]], counters: Sequence[int], counts_full,
                counts_gen, rp: RowParams, bias=None, noise=None):
    """One batched sampling step with per-row parameters: tokens [B] int64.
    Row b's noise comes from the generator of (seeds[b], counters[b]), so a
    request's draws depend only on its own progress; a row whose seed is
    None draws nothing (a greedy row). ``noise`` [B, V] overrides the draws.
    Greedy rows (temperature 0) take the argmax."""
    greedy_tok, w = process_rows(logits, counts_full, counts_gen, rp, bias)
    if noise is None:
        noise = torch.zeros_like(w)
        for b, seed in enumerate(seeds):
            if seed is not None:
                noise[b] = gumbel((w.shape[1],), _row_generator(seed, counters[b], w.device),
                                  w.device, w.dtype)
    return torch.where(rp.temperature <= 0.0, greedy_tok, pick(w, noise))


def update_counts(counts_full, counts_gen, tokens, valid, gen_mask):
    """Scatter-add this step's tokens [B, W] into the per-row counts (in
    place): ``valid`` tokens into counts_full, ``valid & gen_mask`` ones into
    counts_gen."""
    counts_full.scatter_add_(1, tokens.long(), valid.to(torch.int32))
    counts_gen.scatter_add_(1, tokens.long(), (valid & gen_mask).to(torch.int32))
    return counts_full, counts_gen


def reset_rows(counts_full, counts_gen, keep):
    """Zero the count rows where keep[b] is False (a slot re-seated)."""
    m = keep[:, None]
    return counts_full * m, counts_gen * m


def normalize_logit_bias(logit_bias) -> Optional[Tuple[Tuple[int, float], ...]]:
    """{token_id: bias} dict (or a normalized tuple) -> sorted hashable
    tuple; None/empty -> None."""
    if not logit_bias:
        return None
    items = logit_bias.items() if hasattr(logit_bias, "items") else logit_bias
    return tuple(sorted((int(t), float(v)) for t, v in items))


def params_from_kwargs(
    *,
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
) -> SamplingParams:
    """HF-style generate kwargs -> SamplingParams. ``do_sample=None`` infers
    from temperature (0.0 -> greedy)."""
    if do_sample is None:
        do_sample = temperature != 0.0
    return SamplingParams(
        logit_bias=normalize_logit_bias(logit_bias),
        temperature=float(temperature),
        top_k=int(top_k or 0),
        top_p=float(top_p),
        min_p=float(min_p or 0.0),
        repetition_penalty=float(repetition_penalty),
        presence_penalty=float(presence_penalty),
        frequency_penalty=float(frequency_penalty),
        do_sample=bool(do_sample),
        logprobs=int(logprobs or 0),
    )
