"""Time the attention kernels' head-dim-64 and -128 rows of chip_smoke.py's
phase 2 from one or more checkouts of the repo, to compare two commits on
one card.

    python3 tools/ab_attention_rows.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (the repo itself, or a commit
unpacked with ``git archive`` into a git-ignored directory). Each runs in a
process of its own, in the order given, builds that checkout's kernels
(``phase_device``) and runs that checkout's own ``chip_smoke.py`` checks with
the same seed: K1 at NLLB's decode step (B=4 H=16 Dh=128), K2 at Mixtral's
16-wide chunk step, K4 at Mixtral's decode step and K2 at Switch's decoder
self-attention (head dim 64), each against its plain version. Prints the
card, then one JSON line per checkout with each kernel's ms (the rows'
``ms`` in ``PERF.md`` section 6), and exits non-zero if any run failed.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def _one(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if Path(cs.__file__).resolve().parent != Path(root).resolve():
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not from {root}")
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    recs = [cs.check_flash_decode(g, dev), cs.check_flash_attend_chunk(g, dev),
            cs.check_paged_decode(g, dev), cs.check_switch_attention(g, dev)]
    print(json.dumps({"root": root, "card": smi,
                      "ms": {r["name"]: r["ms"] for r in recs}}), flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        _one(sys.argv[2])
        return 0
    failed = 0
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                             text=True)
        lines = out.stdout.splitlines()
        print(next((ln for ln in reversed(lines) if ln.startswith("{")), f"{root}: no result"),
              flush=True)
        if out.returncode != 0:
            failed += 1
            print(out.stdout[-4000:], out.stderr[-4000:], flush=True)
    return 1 if failed or len(sys.argv) < 2 else 0


if __name__ == "__main__":
    sys.exit(main())
