"""Time DeepSeek-V2-Lite's FusedRunner over the flat expert pool and over the
pre-tiled one (the layout the JAX package's ``stack_experts`` builds by
default) in turns, in one process, to tell a cost of the layout from one of
the order in which chip_smoke.py's phase 7 runs them.

    python3 tools/ab_fused_pool.py [ROUNDS]

Builds the kernels (``chip_smoke.phase_device``) and phase 7's model
(``chip_smoke._deepseek``: the published width, all 27 layers, bf16, seed
2468), stacks the experts flat, then runs ROUNDS (default 3) rounds of flat
then tiled, or tiled then flat in every other round, the pool converted role
by role between runs (never two copies of a role's pool on the card). Each
run is phase 7's request 1 through a new FusedRunner: a warm-up, then the
timed prefill and ``NEW_TOKENS - 1`` decode steps (ms per token, and the
host's ms per token to queue all of it), then two more under torch.profiler
(the device's busy ms per call and its share of the wall). Every run's
prefill logits must be bit-equal to the first run's and its tokens equal.
Prints the card, one line per run, and a JSON line with the medians by
layout. Needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _convert(pool, layout):
    """Each 3-D/4-D expert role of ``pool`` rewritten in ``layout``, one role
    at a time (the old tensor freed as the new one lands)."""
    from moe_infinity_tpu_torch.ops import gmm as gm

    for role in list(pool):
        w = pool[role]
        if layout == "tiled" and w.dim() == 3:
            pool[role] = gm.pack_tiled(w)
        elif layout == "flat" and w.dim() == 4:
            S, nf, D, tf = w.shape
            pool[role] = w.permute(0, 2, 1, 3).reshape(S, D, nf * tf)
        del w
        torch.cuda.empty_cache()


def main() -> int:
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.fused import FusedRunner

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    model, params, provider, _ = cs._deepseek(dev, torch.bfloat16, 2468)
    experts = provider.pytree()
    pool = model.stack_experts(experts["layers"], layout="flat")
    del experts, provider
    torch.cuda.empty_cache()
    prompt = np.random.default_rng(7).integers(3, model.spec.vocab_size, cs.PROMPT_LENS[0])
    T, n_new = len(prompt), cs.NEW_TOKENS
    tok = torch.as_tensor(prompt[None], dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    pos0 = torch.full((1,), T, dtype=torch.int32, device=dev)

    def fused(runner):
        logits, kv = runner.prefill(tok, pos, runner.init_cache(1, 64), 0)
        tok0 = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        toks, _ = runner.decode(tok0, pos0, kv, n_new - 1)
        return logits, torch.cat([tok0, toks], dim=1)

    rows, ref = [], None
    for r in range(rounds):
        for layout in (("flat", "tiled") if r % 2 == 0 else ("tiled", "flat")):
            _convert(pool, layout)
            runner = FusedRunner(model, params, pool, moe_impl="gmm")
            fused(runner)  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            logits, new = fused(runner)
            queued = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in launch_counts().items() if v}
            if ref is None:
                ref = (logits, new)
            same = torch.equal(logits, ref[0]) and torch.equal(new, ref[1])
            prof = cs._profile_streams(f"FusedRunner over the {layout} pool, round {r + 1}",
                                       lambda: fused(runner), 2) or {}
            row = dict(round=r + 1, layout=layout, ms_per_token=wall * 1e3 / n_new,
                       host_queued_ms_per_token=queued * 1e3 / n_new,
                       profiled_wall_ms=prof.get("wall_ms"),
                       device_busy_ms=prof.get("busy_ms"),
                       busy_share=(prof["busy_ms"] / prof["wall_ms"]) if prof else None,
                       equal_to_first_run=same, launches=counts)
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not same:
                raise AssertionError(f"{layout} pool, round {r + 1}: logits or tokens differ")
            del runner, logits, new
    med = {lay: {k: statistics.median(x[k] for x in rows if x["layout"] == lay)
                 for k in ("ms_per_token", "host_queued_ms_per_token", "device_busy_ms",
                           "busy_share")}
           for lay in ("flat", "tiled")}
    print(f"[card] {smi}", flush=True)
    print(json.dumps({"rounds": rounds, "tokens": n_new, "median": med}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
