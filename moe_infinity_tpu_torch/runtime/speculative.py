"""Speculative decoding by prompt lookup, from
``moe_infinity_tpu/runtime/speculative.py``: n-gram drafts and one batched
verification.

Drafts come from matching the trailing n-gram of the context against the
earlier context (HF's ``prompt_lookup_num_tokens``): no draft model and no
extra weights, which suits outputs that repeat spans of the prompt.

Verification is one forward of width k+1 through the stepper (K2 with k+1
causal query rows; the experts through K3): greedy targets
t_i = argmax(logits[:, i]), and drafts are accepted while d_{i+1} == t_i.
The output equals sequential greedy decoding token for token.

Rollback costs nothing with the contiguous cache: the causal bound hides the
columns past the accepted ones, and the next step's writes start at the next
offset and overwrite them. A step yields 1 to k+1 tokens.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from moe_infinity_tpu_torch.runtime.generate import GenerationResult, _bucket_len, eos_hit


def ngram_draft(context: np.ndarray, k: int, max_ngram: int = 3,
                min_ngram: int = 1) -> Optional[np.ndarray]:
    """The k tokens that followed the most recent earlier occurrence of the
    longest matching trailing n-gram (padded with its last token), or None
    when nothing matches."""
    n_ctx = len(context)
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        tail = context[n_ctx - n:]
        # the latest earlier occurrence (the trailing one excluded)
        for start in range(n_ctx - n - 1, -1, -1):
            if np.array_equal(context[start:start + n], tail):
                cont = context[start + n:start + n + k]
                if len(cont) > 0:
                    if len(cont) < k:  # pad by repeating the last token
                        cont = np.concatenate([cont, np.full(k - len(cont), cont[-1])])
                    return cont.astype(np.int64)
        # fall through to a shorter n-gram
    return None


class SpeculativeDecoder:
    """Greedy decoding with n-gram speculation over a stepper (batch 1):
    ``ResidentStepper`` or an offload engine, whose ``forward`` takes
    (tokens [1, T], positions, caches, kv_len)."""

    def __init__(self, stepper, *, spec_tokens: int = 4, max_ngram: int = 3,
                 max_seq_len: int = 2048):
        self.stepper = stepper
        self.k = int(spec_tokens)
        self.max_ngram = max_ngram
        self.max_seq_len = max_seq_len

    @torch.inference_mode()
    def generate(self, input_ids: np.ndarray, max_new_tokens: int = 32, *,
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 **_ignored) -> GenerationResult:
        input_ids = np.asarray(input_ids)
        if input_ids.ndim == 1:
            input_ids = input_ids[None]
        if input_ids.shape[0] != 1:
            raise ValueError("speculative decoding supports batch size 1")
        T = input_ids.shape[1]
        cap = min(self.max_seq_len, _bucket_len(T + max_new_tokens + self.k + 1))
        if T + max_new_tokens + self.k + 1 > cap:
            raise ValueError("prompt + new tokens exceed capacity")
        stepper = self.stepper
        dev = stepper.model.device
        kv = stepper.init_cache(1, cap)
        seq_ids = stepper.begin_sequences(1)

        # ---- prefill ------------------------------------------------------
        tokens = torch.as_tensor(input_ids, dtype=torch.int32).to(dev)
        positions = torch.arange(T, dtype=torch.int32, device=dev)[None]
        logits, kv, _ = stepper.forward(tokens, positions, kv, 0, seq_ids=seq_ids)
        first = int(torch.argmax(logits[0, -1, :]))

        context = list(input_ids[0]) + [first]
        generated = [first]
        accepted_hist = []
        cur = T + 1  # tokens whose K/V is final
        done = eos_token_id is not None and bool(eos_hit(first, eos_token_id))
        while not done and len(generated) < max_new_tokens:
            draft = ngram_draft(np.asarray(context), self.k, self.max_ngram)
            if draft is None:
                draft = np.full(self.k, context[-1], dtype=np.int64)
            # feed [last accepted, d1..dk] at columns cur-1 .. cur+k-1
            step_toks = np.concatenate([[context[-1]], draft])[None]
            pos = torch.arange(cur - 1, cur + self.k, dtype=torch.int32, device=dev)[None]
            logits, kv, _ = stepper.forward(
                torch.as_tensor(step_toks, dtype=torch.int32).to(dev), pos, kv, cur - 1,
                seq_ids=seq_ids)
            targets = torch.argmax(logits[0], dim=-1).cpu().numpy()  # [k+1]
            # accept drafts while they match the model's own greedy choice
            n_acc = 0
            while n_acc < self.k and draft[n_acc] == targets[n_acc]:
                n_acc += 1
            accepted_hist.append(n_acc)
            for t in targets[:n_acc + 1]:  # the accepted drafts and one correction
                if len(generated) >= max_new_tokens:
                    break
                generated.append(int(t))
                context.append(int(t))
                if eos_token_id is not None and eos_hit(t, eos_token_id):
                    done = True
                    break
            # K/V is final through the last input column whose target was
            # accepted: inputs were context[-1], d1..d_{n_acc}
            cur += n_acc + 1

        stepper.end_sequences(seq_ids)
        out = np.concatenate([input_ids[0], np.asarray(generated, dtype=np.int64)])[None]
        return GenerationResult(
            sequences=out,
            num_generated=np.asarray([len(generated)]),
            stats={
                "spec_steps": len(accepted_hist),
                "spec_accepted": int(np.sum(accepted_hist)) if accepted_hist else 0,
                "spec_accept_rate": (
                    float(np.mean(accepted_hist)) / self.k if accepted_hist else 0.0),
            },
        )
