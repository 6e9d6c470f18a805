"""Fused serving runner, from ``moe_infinity_tpu/runtime/fused.py``.

Wraps a model's ``fused_forward`` (one loop over the stacked MoE layers, the
stacked expert pool read by K3 through ``group_offset``) into two entry
points:

* ``prefill(tokens, positions, kv_state, kv_len)`` - one forward;
* ``decode(tok0, pos0, kv_state, n)`` - n greedy steps with no host read
  inside the loop: the start column is read once before it, and the argmax,
  the positions and the cache offset advance without one.

PyTorch runs eagerly, so where the JAX package compiles one ``lax.scan``
over the layers and one over the steps, both loops here are Python loops
that only queue work on the device.
"""

from __future__ import annotations

import torch


class FusedRunner:
    def __init__(self, model, params, pool, *, moe_impl: str = "gmm"):
        if moe_impl not in ("gmm", "gather"):
            raise ValueError(f"unknown moe_impl {moe_impl!r} (gmm, gather)")
        self.model = model
        self.params = params
        self.pool = pool
        self.stacked = model.stack_moe_layers(params)
        self.moe_impl = moe_impl

    def init_cache(self, batch: int, max_len: int):
        return self.model.init_fused_cache(batch, max_len)

    @torch.inference_mode()
    def prefill(self, tokens, positions, kv_state, kv_len: int):
        """(logits [B, T, V] f32, kv_state) for tokens written at cache
        columns [kv_len, kv_len + T)."""
        return self.model.fused_forward(
            self.params, self.stacked, self.pool, tokens, positions, kv_state,
            int(kv_len), moe_impl=self.moe_impl,
        )

    @torch.inference_mode()
    def decode(self, tok0, pos0, kv_state, num_steps: int):
        """Greedy-decode ``num_steps`` tokens on the device from tok0 [B, 1]
        at positions pos0 [B] (all rows at one cache column). Returns
        ([B, num_steps] int32, kv_state)."""
        col = int(pos0[0])  # the one host read, before the loop
        tok = tok0.to(torch.int32)
        pos = pos0.to(torch.int32)
        toks = torch.empty(tok.shape[0], num_steps, dtype=torch.int32, device=tok.device)
        for i in range(num_steps):
            logits, kv_state = self.model.fused_forward(
                self.params, self.stacked, self.pool, tok, pos[:, None], kv_state,
                col + i, moe_impl=self.moe_impl,
            )
            tok = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True).to(torch.int32)
            toks[:, i] = tok[:, 0]
            pos = pos + 1
        return toks, kv_state
