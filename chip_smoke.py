"""Drive the PyTorch + CUDA port of moe_infinity_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device and build: needs a CUDA device, prints the card's name and power
   limit, builds every kernel from ``moe_infinity_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the shapes
   of the NLLB-MoE-54B and Mixtral-8x7B paths, with the error, its
   tolerance and the times of the kernel, the plain version and one library
   call for the same function;
3. the seq2seq main path: NLLB-MoE-54B geometry (d_model 2048, 16 heads,
   FFN 8192, 128 experts top-2, every 4th block sparse, vocab 256,206) with
   random weights from a seed, bf16 compute, packed int4 experts, resident
   on the card, ``Seq2SeqGenerator.generate`` answering 4 padded requests
   with 16 greedy tokens each (K1, K2 and K3 must each launch);
4. its whole-path check: at full width and 2+2 blocks, the first decode
   step's logits through the kernels against the plain versions on the card;
5. the decoder-only main path: Mixtral-8x7B (``bench.py``'s
   ``MIXTRAL_8X7B_SPEC``: d_model 4096, 32 layers, 32 heads over 8 KV heads,
   FFN 14336, 8 experts top-2, vocab 32,000) at full width and depth, bf16
   compute, int8 experts made on the card from a seed, served by
   ``ContinuousBatcher`` over the paged KV cache: 8 requests submitted
   together into 4 slots, 16 greedy tokens each (K4, K2 and K3 must each
   launch); request 1 again alone through ``Generator`` (K1, K2, K3);
6. its whole-path check: at full width and 2 layers, a 16-wide chunk step
   and a one-token step over paged caches with holes, logits through the
   kernels against the plain versions on the card (f32 on three seeds,
   bf16 on one).

The line before the last is the per-kernel JSON record (launches: the sum
of phase 3's and phase 5's counts); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2  # rtol = atol for bf16 operands (the JAX suite's gmm tolerance)

NLLB_54B = dict(
    vocab_size=256206, d_model=2048, num_heads=16,
    encoder_layers=24, decoder_layers=24,
    encoder_ffn_dim=8192, decoder_ffn_dim=8192,
    encoder_sparse_step=4, decoder_sparse_step=4,
    num_experts=128, pad_token_id=1, decoder_start_token_id=2,
    max_positions=1024, scale_embedding=True,
)
SRC_LENS = (64, 48, 40, 24)  # the 4 requests' source lengths, padded to 64
NEW_TOKENS = 16

# bench.py MIXTRAL_8X7B_SPEC
MIXTRAL_8X7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    num_experts=8, top_k=2, rms_eps=1e-5, rope_theta=1e6,
    tie_embeddings=False,
)
PROMPT_LENS = (24, 40, 64, 96, 17, 33, 50, 80)  # 8 requests into 4 slots
SLOTS, PAGE, MAX_COLS, CHUNK = 4, 16, 512, 16
NLLB_KERNELS = ("flash_decode", "flash_attend", "gmm")
BATCHER_KERNELS = ("paged_flash_decode", "flash_attend", "gmm")


def say(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Device time per call. A spin kernel of some 60 ms goes first, so the host
    has queued every call before the device reaches them and the events
    time the device's work, not the host's launch rate (a function that
    reads a value on the host inside, as gmm_plain does, waits for the spin
    and is then timed with its host work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def compare(name, got, want, tol=TOL) -> float:
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # share of the allclose limit used by the worst element: fails above 1
    used = (diff / (tol + tol * want.float().abs())).max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    finite = bool(torch.isfinite(got.float()).all())
    say(f"[check] {name}: max_abs_err={err:.3e} tol(rtol=atol)={tol} "
        f"limit_used={used:.3f} {'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from moe_infinity_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    say(f"[build] {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s")
    for stem, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    say(f"[ptxas] {stem}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pad_bias(dev, S):
    valid = torch.zeros(len(SRC_LENS), S, dtype=torch.bool, device=dev)
    for i, n in enumerate(SRC_LENS):
        valid[i, :n] = True
    bias = torch.where(valid, 0.0, torch.finfo(torch.float32).min)
    return bias[:, None, None, :].contiguous()


def _sdpa_mask_call(q, k, v, mask):
    import torch.nn.functional as F

    # [B, T, H, Dh] -> [B, H, T, Dh] views; the float mask broadcasts
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def check_flash_decode(g, dev):
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, H, Dh, S = 4, 16, 128, 32
    kv_len, step = NEW_TOKENS + 1, NEW_TOKENS  # the last decode step
    q = torch.randn(B, 1, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.full((B, 1), step, dtype=torch.int32, device=dev)
    run = lambda: fa.flash_decode(q, k, v, pos, kv_len)  # noqa: E731
    plain = lambda: fa.flash_decode_plain(  # noqa: E731
        q[:, 0], k, v, pos[:, 0], kv_len, scale=Dh ** -0.5
    )
    err = compare("flash_decode B=4 H=16 S=32 kv_len=17", run()[:, 0], plain())
    live = min(kv_len, step + 1)
    mask = torch.full((B, 1, 1, S), float("-inf"), device=dev, dtype=torch.bfloat16)
    mask[..., :live] = 0
    nbytes = 2 * B * H * Dh * 2 + 2 * B * live * H * Dh * 2 + B * 4
    b_ms, b_by = bound_ms(nbytes, 4 * B * H * live * Dh)
    return dict(
        name="flash_decode", route="cuda",
        source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
        replaces="moe_infinity_tpu/ops/flash_attention.py:308",
        max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(_sdpa_mask_call(q, k, v, mask)),
        shape=f"B={B} H={H} Dh={Dh} S={S} live={live} bf16",
    )


def check_flash_attend(g, dev):
    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, H, Dh, S = 4, 16, 128, max(SRC_LENS)
    bias = _pad_bias(dev, S)
    recs = {}
    for label, T in (("encoder", S), ("cross", 1)):
        q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T).contiguous()
        run = lambda: fa.flash_attend(  # noqa: E731
            q, k, v, pos, S, causal=False, bias=bias
        )
        plain = lambda: fa.flash_attend_plain(  # noqa: E731
            q, k, v, pos, S, scale=Dh ** -0.5, causal=False, bias=bias
        )
        err = compare(f"flash_attend {label} B={B} T={T} S={S} pad bias", run(), plain())
        nbytes = 2 * B * T * H * Dh * 2 + 2 * B * S * H * Dh * 2 + B * S * 4 + B * T * 4
        b_ms, b_by = bound_ms(nbytes, 4 * B * H * T * S * Dh)
        recs[label] = dict(
            name="flash_attend", route="cuda",
            source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
            replaces="moe_infinity_tpu/ops/flash_attention.py:81",
            max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(_sdpa_mask_call(q, k, v, bias.to(torch.bfloat16))),
            shape=f"{label}: B={B} T={T} H={H} Dh={Dh} S={S} bf16",
        )
    say(f"[time] flash_attend encoder shape: {json.dumps(recs['encoder'])}")
    return recs["cross"]


def _routed_rows(g, dev, tokens, E, K=2):
    """Sorted (token, k) rows of top-K routing over E experts: (slots,
    group_ids, group_sizes) as gffn_pallas builds them."""
    from moe_infinity_tpu_torch.ops.gmm import compact_groups

    ids = torch.stack([
        torch.randperm(E, generator=g, device=dev)[:K] for _ in range(tokens)
    ])
    flat = ids.reshape(-1)
    sorted_slots = flat[torch.argsort(flat, stable=True)]
    gid, gsz = compact_groups(sorted_slots, min(E, flat.shape[0]))
    return gid, gsz, int(torch.unique(flat).numel())


def _gmm_case(name, g, dev, *, rows, D, F, S, kind, gid=None, gsz=None,
              active=None, time_it=False):
    from moe_infinity_tpu_torch.ops import gmm as gm

    x = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
    packed = kind == "int4"
    Fw = F // 2 if packed else F
    scale = None
    if kind == "bf16":
        w = (torch.randn(S, D, Fw, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    else:
        lo, hi = (-128, 128)
        w = torch.randint(lo, hi, (S, D, Fw), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(S, F, generator=g, device=dev) * 0.0026 + 0.003
        if kind == "int8":
            scale = scale / 16
    run = lambda: gm.gmm(x, w, gsz, scale, group_ids=gid, packed=packed)  # noqa: E731
    plain = lambda: gm.gmm_plain(  # noqa: E731
        x, w, gsz, scale, group_ids=gid, packed=packed
    )
    err = compare(f"gmm {name}", run(), plain())
    if not time_it:
        return err, None
    wbytes = active * D * Fw * w.element_size()
    nbytes = rows * D * 2 + wbytes + active * F * 4 + rows * F * 4
    return err, dict(
        ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=5, warmup=1),
        nbytes=nbytes, flops=2 * rows * D * F,
    )


def check_gmm(g, dev):
    E, D, F = 128, 2048, 8192
    B = len(SRC_LENS)
    errs, timed = [], {}
    for label, tokens in (("decode", B), ("prefill", B * max(SRC_LENS) // 1)):
        gid, gsz, active = _routed_rows(g, dev, tokens, E)
        for role, (d_in, f_out) in (("gate", (D, F)), ("down", (F, D))):
            err, t = _gmm_case(
                f"int4 {label} {role} rows={2 * tokens} D={d_in} F={f_out} "
                f"S={E} active={active}", g, dev, rows=2 * tokens, D=d_in,
                F=f_out, S=E, kind="int4", gid=gid, gsz=gsz, active=active,
                time_it=True,
            )
            errs.append(err)
            timed[(label, role)] = t
            b_ms, b_by = bound_ms(t["nbytes"], t["flops"])
            say(f"[time] gmm int4 {label} {role}: ms={t['ms']:.4f} "
                f"plain_ms={t['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})")
    # small bf16 / int8 cases, and empty groups with compacted ids
    sizes = torch.tensor([5, 0, 9, 0, 2], dtype=torch.int32, device=dev)
    for kind in ("bf16", "int8"):
        errs.append(_gmm_case(f"{kind} S=5 with empty groups", g, dev, rows=16,
                              D=256, F=384, S=5, kind=kind, gsz=sizes)[0])
    gid = torch.tensor([3, 17, 40, 0, 0], dtype=torch.int32, device=dev)
    gsz = torch.tensor([6, 1, 9, 0, 0], dtype=torch.int32, device=dev)
    errs.append(_gmm_case("int4 compacted ids, padded empty groups", g, dev,
                          rows=16, D=512, F=1024, S=64, kind="int4",
                          gid=gid, gsz=gsz)[0])
    gate, down = timed[("decode", "gate")], timed[("decode", "down")]
    b_ms, b_by = bound_ms(gate["nbytes"] + down["nbytes"], gate["flops"] + down["flops"])
    say(f"[time] gmm NLLB decode MoE layer (gate + down, 8 rows, packed int4, "
        f"D=2048 F=8192 S=128): ms={gate['ms'] + down['ms']:.4f} plain_ms="
        f"{gate['plain_ms'] + down['plain_ms']:.4f} bound_ms={b_ms:.5f} ({b_by})")
    return max(errs)


def check_gmm_mixtral(g, dev, err_nllb):
    """One Mixtral decode MoE layer on K3: gate, up and down launches over 8
    rows (4 tokens x top-2) routed to all 8 experts, int8 with per-channel
    scales, D=4096 F=14336."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import gmm as gm
    from moe_infinity_tpu_torch.ops.gmm import compact_groups

    E, D, F, rows = 8, 4096, 14336, 8
    flat = torch.randperm(E, generator=g, device=dev)  # 4 tokens x 2 experts
    gid, gsz = compact_groups(torch.sort(flat).values, E)
    x = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
    w, sc = {}, {}
    for role, (d_in, d_out) in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D))):
        w[role] = torch.randint(-127, 127, (E, d_in, d_out), generator=g, device=dev,
                                dtype=torch.int8)
        sc[role] = torch.rand(E, d_out, generator=g, device=dev) * 1e-3 + 1e-3
    h = gm.gmm(x, w["gate"], gsz, sc["gate"], group_ids=gid)
    hu = gm.gmm(x, w["up"], gsz, sc["up"], group_ids=gid)
    a = (F_.silu(h) * hu).to(torch.bfloat16)

    def calls(fn):
        return lambda: [fn(xin, w[r], gsz, sc[r], group_ids=gid)
                        for r, xin in (("gate", x), ("up", x), ("down", a))]

    run, plain = calls(gm.gmm), calls(gm.gmm_plain)
    errs = [err_nllb] + [
        compare(f"gmm int8 Mixtral decode {r} rows={rows} active={E}", got, want)
        for r, got, want in zip(("gate", "up", "down"), run(), plain())
    ]
    nbytes = (E * 3 * D * F + E * (2 * F + D) * 4  # weights, scales
              + 2 * rows * D * 2 + rows * F * 2  # x read twice, a
              + 2 * rows * F * 4 + rows * D * 4)  # f32 outputs
    b_ms, b_by = bound_ms(nbytes, 2 * rows * D * F * 3)
    return dict(
        name="gmm", route="cuda", source="moe_infinity_tpu_torch/csrc/gmm.cu",
        replaces="moe_infinity_tpu/ops/gmm.py:46", max_abs_err=max(errs),
        ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=5, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="one Mixtral decode MoE layer: gate + up + down launches, 8 rows "
              "over 8 experts, int8 + scales, D=4096 F=14336",
    )


def check_paged_decode(g, dev):
    """K4 at Mixtral decode shapes: B=4, H=32 over Hkv=8, page 16, 32 pages
    per row (512 columns) from a 160-page pool, shuffled page table, rows of
    113, 200, 37 and 512 live keys, a hole mask, bf16."""
    import torch.nn.functional as F_

    from moe_infinity_tpu_torch.ops import flash_attention as fa

    B, H, Hkv, Dh, P, NP = 4, 32, 8, 128, MAX_COLS // PAGE, 160
    S = P * PAGE
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    pk = torch.randn(NP, PAGE, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    pv = torch.randn(NP, PAGE, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    table = torch.randperm(NP, generator=g, device=dev)[:B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([113, 200, 37, 512], dtype=torch.int32, device=dev)
    holes = torch.rand(B, S, generator=g, device=dev) > 0.1
    run = lambda: fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=holes)  # noqa: E731
    plain = lambda: fa.paged_flash_decode_plain(  # noqa: E731
        q, pk, pv, table, lengths, scale=Dh ** -0.5, pad_mask=holes
    )
    err = compare("paged_flash_decode B=4 H=32 Hkv=8 page=16 P=32 lengths=(113,200,37,512) holes",
                  run(), plain())
    live = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    valid = int((live & holes).sum())
    nbytes = (2 * valid * Hkv * Dh * 2  # live K and V rows read
              + int(lengths.sum())  # mask bytes of the live range
              + 2 * B * H * Dh * 2 + B * P * 4 + B * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * H * Dh * valid)
    # library yardstick: SDPA over a pre-gathered contiguous view, KV heads
    # expanded to H beforehand, with the same mask as a float bias
    idx = table.long()
    kc = pk[idx].reshape(B, S, Hkv, Dh).repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    vc = pv[idx].reshape(B, S, Hkv, Dh).repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    bias = torch.where(live & holes, 0.0, float("-inf")).to(torch.bfloat16)[:, None, None, :]
    qs = q[:, :, None, :]
    lib = lambda: F_.scaled_dot_product_attention(qs, kc, vc, attn_mask=bias)  # noqa: E731
    # K1 over the same rows gathered into a contiguous cache: the same
    # decode_block body without the page indirection, so the two times
    # split K4's cost between its shared body and the page-table reads
    kg = pk[idx].reshape(B, S, Hkv, Dh)
    vg = pv[idx].reshape(B, S, Hkv, Dh)
    q1, qpos = q[:, None], (lengths - 1)[:, None]
    contig = lambda: fa.flash_decode(q1, kg, vg, qpos, S, pad_mask=holes)  # noqa: E731
    compare("flash_decode on the gathered rows vs paged_flash_decode", contig()[:, 0], run())
    say(f"[time] K4 vs K1 on the same rows ({valid} valid keys): paged ms="
        f"{cuda_ms(run):.4f} contiguous ms={cuda_ms(contig):.4f}")
    return dict(
        name="paged_flash_decode", route="cuda",
        source="moe_infinity_tpu_torch/csrc/flash_attention.cu",
        replaces="moe_infinity_tpu/ops/flash_attention.py:700",
        max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib),
        shape=f"B={B} H={H} Hkv={Hkv} page={PAGE} P={P} pool={NP} "
              f"{valid} valid keys, bf16 (library: SDPA on a pre-gathered view)",
    )


def phase_kernels(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    recs = [check_flash_decode(g, dev), check_flash_attend(g, dev),
            check_gmm_mixtral(g, dev, check_gmm(g, dev)), check_paged_decode(g, dev)]
    for r in recs:
        say(f"[time] {r['name']} ({r['shape']}): ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
    return recs


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def _requests(vocab, g, dev):
    B, T = len(SRC_LENS), max(SRC_LENS)
    ids = np.full((B, T), NLLB_54B["pad_token_id"], dtype=np.int64)
    mask = np.zeros((B, T), dtype=np.float32)
    body = torch.randint(3, vocab, (B, T), generator=g, device=dev).cpu().numpy()
    for i, n in enumerate(SRC_LENS):
        ids[i, :n] = body[i, :n]
        ids[i, n - 1] = 2  # eos closes each source
        mask[i, :n] = 1.0
    return ids, mask


def phase_main_path(dev):
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = NllbSpec(**NLLB_54B)
    say(f"[main] NLLB-MoE-54B geometry, depth {spec.encoder_layers}+"
        f"{spec.decoder_layers} blocks, sparse_step {spec.encoder_sparse_step}, "
        f"bf16 compute, int4 experts, impl=pallas")
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    t0 = time.perf_counter()
    model = NllbModel(spec, compute_dtype=torch.bfloat16, device=dev)
    params, tree = model.init_random(g, expert_dtype="int4")
    provider = ResidentProvider(tree)
    torch.cuda.synchronize()
    say(f"[main] weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"experts {provider.nbytes() / 1e9:.2f} GB, allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    gen = Seq2SeqGenerator(
        model, params, provider.pytree(), ResidentProvider.for_layer, impl="pallas"
    )
    ids, mask = _requests(spec.vocab_size, g, dev)
    gen.generate(ids, max_new_tokens=2, attention_mask=mask, eos_token_id=None)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = gen.generate(ids, max_new_tokens=NEW_TOKENS, attention_mask=mask,
                       eos_token_id=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = res.stats
    say(f"[main] sequences shape {res.sequences.shape}; first row {res.sequences[0].tolist()}")
    say(f"[main] encode_ms={st['encode_ms']:.3f} decode_ms_per_step="
        f"{st['decode_ms'] / NEW_TOKENS:.3f} tokens_per_s="
        f"{len(SRC_LENS) * NEW_TOKENS / (st['decode_ms'] / 1e3):.1f} "
        f"wall_s={wall:.3f} max_memory_allocated_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    say(f"[main] launches {json.dumps(counts)}")
    if res.sequences.shape != (len(SRC_LENS), NEW_TOKENS + 1):
        raise AssertionError(f"unexpected output shape {res.sequences.shape}")
    _require_launched(counts, NLLB_KERNELS, "NLLB main path")
    if not np.all((res.sequences >= 0) & (res.sequences < spec.vocab_size)):
        raise AssertionError("token ids out of range")
    # logits of one more step are finite
    logits = _first_step_logits(model, params, provider, ids, mask, "pallas")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    say(f"[main] first-step logits finite, shape {tuple(logits.shape)}")
    _profile_main_path(model, params, provider, ids, mask)
    del gen, params, tree, provider, model
    torch.cuda.empty_cache()
    return counts


def _require_launched(counts, names, what):
    missing = [n for n in names if counts.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing} ({counts})")


def _profile(label, fn, n):
    """Run fn() n times under torch.profiler: host wall time per call, the
    device's busy time per call (sum of kernel intervals; one stream, so no
    overlap) and its busy share, and the kernels taking the most time."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
    if not by_name:
        say(f"[profile] {label}: device time not measured (no CUDA events traced)")
        return
    busy = sum(by_name.values())
    say(f"[profile] {label}: wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
        f"busy_share={busy / wall_ms:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"[profile]   {ms:8.3f} ms  {name[:110]}")


def _profile_main_path(model, params, provider, ids, mask):
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    dev, for_layer, experts = model.device, ResidentProvider.for_layer, provider.pytree()
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    B = tok.shape[0]

    def encode():
        return model.cross_kv(params, model.encode(params, experts, tok, m, for_layer, "pallas"))

    cross = encode()
    kvs = model.init_cache(B, 32)
    cur = torch.full((B, 1), model.spec.decoder_start_token_id, dtype=torch.int32, device=dev)
    step = [0]

    def decode():
        pos = torch.full((B, 1), step[0], dtype=torch.int32, device=dev)
        logits, _ = model.decode_step(params, experts, cur, pos, kvs, step[0], m, cross,
                                      for_layer, "pallas")
        cur.copy_(torch.argmax(logits[:, -1], -1, keepdim=True))
        step[0] += 1

    with torch.inference_mode():
        _profile("encode (4 x 64 tokens) + cross K/V", encode, 2)
        _profile("decode step (4 rows)", decode, 4)


def _first_step_logits(model, params, provider, ids, mask, impl):
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    dev = model.device
    experts = provider.pytree()
    tok = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    m = torch.as_tensor(mask, device=dev)
    enc = model.encode(params, experts, tok, m, ResidentProvider.for_layer, impl)
    cross = model.cross_kv(params, enc)
    kvs = model.init_cache(tok.shape[0], 32)
    start = torch.full((tok.shape[0], 1), model.spec.decoder_start_token_id,
                       dtype=torch.int32, device=dev)
    pos = torch.zeros_like(start)
    logits, _ = model.decode_step(params, experts, start, pos, kvs, 0, m, cross,
                                  ResidentProvider.for_layer, impl)
    return logits


class _plain_kernels:
    """Route the model's kernel calls to the plain versions (the card's
    tensors then run the PyTorch arithmetic): a check-only path."""

    def __enter__(self):
        from moe_infinity_tpu_torch.ops import flash_attention as fa, gmm as gm

        self._saved = (fa.flash_decode, fa.flash_attend, fa.paged_flash_decode, gm.gmm)

        def decode(q, k, v, qp, kv_len, *, scale=None, causal=True,
                   logit_softcap=None, pad_mask=None):
            out = fa.flash_decode_plain(
                q[:, 0], k, v, qp.reshape(-1), int(kv_len),
                scale=scale if scale is not None else q.shape[-1] ** -0.5,
                causal=causal, logit_softcap=logit_softcap, pad_mask=pad_mask,
            )
            return out[:, None]

        def attend(q, k, v, qp, kv_len, *, scale=None, causal=True,
                   logit_softcap=None, bias=None, pad_mask=None):
            return fa.flash_attend_plain(
                q, k, v, qp, int(kv_len),
                scale=scale if scale is not None else q.shape[-1] ** -0.5,
                causal=causal, logit_softcap=logit_softcap, bias=bias,
                pad_mask=pad_mask,
            )

        def paged(q, pk, pv, table, lengths, *, scale=None, logit_softcap=None,
                  pad_mask=None):
            return fa.paged_flash_decode_plain(
                q, pk, pv, table, lengths,
                scale=scale if scale is not None else q.shape[-1] ** -0.5,
                logit_softcap=logit_softcap, pad_mask=pad_mask,
            )

        def gmm(x, w, gs, scale=None, group_offset=0, group_ids=None, *, packed=False):
            return gm.gmm_plain(x, w, gs, scale, group_offset, group_ids, packed=packed)

        fa.flash_decode, fa.flash_attend, fa.paged_flash_decode, gm.gmm = (
            decode, attend, paged, gmm)
        return self

    def __exit__(self, *exc):
        from moe_infinity_tpu_torch.ops import flash_attention as fa, gmm as gm

        fa.flash_decode, fa.flash_attend, fa.paged_flash_decode, gm.gmm = self._saved
        return False


def phase_whole_path(dev):
    """f32 compute is held to the tolerance: there kernel and plain differ
    only in summation order (~1e-6), so the check sees wiring faults. In
    bf16 a last-bit difference can flip a rounding of the residual stream
    or a near-tie of the top-2 router, which moves that request's logits
    by more than a kernel's error; the bf16 run is reported per request,
    and its outputs must be finite."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    spec = NllbSpec(**dict(NLLB_54B, encoder_layers=2, decoder_layers=2,
                           encoder_sparse_step=2, decoder_sparse_step=2))
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev)
        g.manual_seed(99)
        model = NllbModel(spec, compute_dtype=dtype, device=dev)
        params, tree = model.init_random(g, expert_dtype="int4")
        provider = ResidentProvider(tree)
        ids, mask = _requests(spec.vocab_size, g, dev)
        reset_launches()
        got = _first_step_logits(model, params, provider, ids, mask, "pallas")
        counts = launch_counts()
        with _plain_kernels():
            want = _first_step_logits(model, params, provider, ids, mask, "pallas")
        if launch_counts() != counts:
            raise AssertionError(f"the plain run launched kernels: {counts} -> {launch_counts()}")
        _require_launched(counts, NLLB_KERNELS, "NLLB whole-path check")
        label = f"whole path logits {str(dtype).split('.')[-1]} (full width, 2+2 blocks, sparse_step 2, int4 experts)"
        if dtype == torch.float32:
            compare(label, got, want)
        else:
            rows = (got - want).abs().amax(dim=(1, 2)).tolist()
            same = (got.argmax(-1) == want.argmax(-1)).all().item()
            say(f"[check] {label}: per-request max_abs_err="
                f"{['%.3e' % r for r in rows]} argmax equal={same} "
                f"(reported, not held to a tolerance)")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("bf16 whole-path logits are not finite")
        del model, params, tree, provider, got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 5 and 6: Mixtral-8x7B through the continuous batcher
# ---------------------------------------------------------------------------

def _mixtral(dev, dtype, seed, **spec_overrides):
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = MixtralModel(MixtralSpec(**dict(MIXTRAL_8X7B, **spec_overrides)),
                         compute_dtype=dtype, device=dev)
    params, tree = model.init_random(g, expert_dtype="int8")
    return model, params, ResidentProvider(tree), g


def phase_mixtral(dev):
    """Serve 8 requests through 4 slots; returns the launch counts of the
    batcher's run and of the Generator's run."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
    from moe_infinity_tpu_torch.runtime.continuous import ContinuousBatcher
    from moe_infinity_tpu_torch.runtime.generate import Generator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    say(f"[mixtral] Mixtral-8x7B geometry, {MIXTRAL_8X7B['num_layers']} layers, "
        f"bf16 compute, int8 experts, impl=pallas; ContinuousBatcher("
        f"max_batch_size={SLOTS}, page_size={PAGE}, max_cols={MAX_COLS}, "
        f"num_pages={(MAX_COLS // PAGE) * (SLOTS + 1)}, prefill_chunk={CHUNK})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, provider, g = _mixtral(dev, torch.bfloat16, 4321)
    torch.cuda.synchronize()
    say(f"[mixtral] weights built on the card in {time.perf_counter() - t0:.1f} s; "
        f"experts {provider.nbytes() / 1e9:.2f} GB, allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    vocab = model.spec.vocab_size
    prompts = [torch.randint(1, vocab, (n,), generator=g, device=dev).cpu().numpy()
               for n in PROMPT_LENS]
    experts = provider.pytree()
    batcher = ContinuousBatcher(
        model, params, experts, ResidentProvider.for_layer, impl="pallas",
        max_batch_size=SLOTS, page_size=PAGE, max_cols=MAX_COLS,
        num_pages=(MAX_COLS // PAGE) * (SLOTS + 1), prefill_chunk=CHUNK,
    )
    try:
        # warm-up: one request runs both step widths once
        batcher.submit(prompts[4], max_new_tokens=2).result(timeout=600)
        torch.cuda.synchronize()
        batcher.reset_step_stats()
        reset_launches()
        t0 = time.perf_counter()
        futures = [batcher.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        outs = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        steps = batcher.step_stats()
    finally:
        batcher.shutdown()
    n_tok = len(prompts) * NEW_TOKENS
    say(f"[mixtral] {len(prompts)} requests x {NEW_TOKENS} tokens (prompts "
        f"{PROMPT_LENS}): wall_s={wall:.3f} tokens_per_s={n_tok / wall:.2f} "
        f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    for w, st in steps.items():
        say(f"[mixtral] steps of width {w}: {st['steps']} at "
            f"{st['ms_per_step']:.3f} ms per step (host clock, ends in the argmax read)")
    say(f"[mixtral] launches {json.dumps(counts)}")
    say(f"[mixtral] request 1 tokens {outs[0][len(prompts[0]):].tolist()}")
    _require_launched(counts, BATCHER_KERNELS, "Mixtral batcher path")
    for p, out in zip(prompts, outs):
        if out.shape != (len(p) + NEW_TOKENS,) or not np.array_equal(out[:len(p)], p):
            raise AssertionError(f"request of {len(p)} tokens came back as {out.shape}")
        if not np.all((out >= 0) & (out < vocab)):
            raise AssertionError("token ids out of range")

    # request 1 alone through Generator: contiguous cache, K2 prefill, K1 decode
    reset_launches()
    res = Generator(model, params, experts, ResidentProvider.for_layer, impl="pallas",
                    max_seq_len=MAX_COLS).generate(prompts[0][None], max_new_tokens=NEW_TOKENS)
    gen_counts = launch_counts()
    _require_launched(gen_counts, NLLB_KERNELS, "Mixtral Generator path")
    same = np.array_equal(res.sequences[0], outs[0])
    say(f"[mixtral] Generator alone, request 1: tokens equal to the batcher's: {same} "
        f"(bf16, reported, not held); launches {json.dumps(gen_counts)}")

    # profile the batcher's own steps, driven here with its thread stopped
    for p in prompts[:SLOTS]:
        batcher.submit(p, max_new_tokens=NEW_TOKENS)
    with torch.inference_mode():
        batcher._admit()
        _profile("batcher chunk step W=16 (4 rows prefilling)", batcher._step_iteration, 1)
        while any(s.prefilling for s in batcher._slots):
            batcher._step_iteration()
        _profile("batcher decode step W=1 (4 rows)", batcher._step_iteration, 4)
    del batcher, params, provider, experts, model
    torch.cuda.empty_cache()
    return {k: counts[k] + gen_counts[k] for k in counts}


def _batcher_steps(model, params, experts, inputs):
    """A 16-wide chunk step, then a one-token step, over fresh paged caches
    as the batcher builds them: rows fed 16, 16, 9 and 1 real tokens in the
    chunk (the rest are hole columns), per-row RoPE positions."""
    from moe_infinity_tpu_torch.runtime.paged_kv import PagedKVCache
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    s = model.spec
    dev = model.device
    shape = (inputs["num_pages"], PAGE, s.num_kv_heads, s.head_dim)
    kvs = [PagedKVCache(torch.zeros(shape, dtype=model.dtype, device=dev),
                        torch.zeros(shape, dtype=model.dtype, device=dev), inputs["table"])
           for _ in range(s.num_layers)]
    valid = inputs["valid"].clone()
    B = valid.shape[0]
    chunk = torch.arange(CHUNK, dtype=torch.int32, device=dev).expand(B, CHUNK)
    out = []
    for toks, pos, rope, col in ((inputs["toks1"], chunk, chunk, 0),
                                 (inputs["toks2"], torch.full((B, 1), CHUNK, dtype=torch.int32, device=dev),
                                  inputs["rope2"], CHUNK)):
        if col:
            valid[:, col] = True
        logits, _, _ = model.forward(params, experts, toks, pos, kvs, col,
                                     for_layer=ResidentProvider.for_layer, impl="pallas",
                                     rope_positions=rope, key_valid=valid)
        out.append(logits)
    return out


class _gmm_inputs:
    """Record the x of every K3 call (kernel or plain, whichever ``gm.gmm``
    is on entry) as the bf16 values K3 multiplies."""

    def __init__(self, store):
        self.store = store

    def __enter__(self):
        from moe_infinity_tpu_torch.ops import gmm as gm

        self._saved = inner = gm.gmm

        def recorded(x, *a, **k):
            self.store.append(x.to(torch.bfloat16))
            return inner(x, *a, **k)

        gm.gmm = recorded
        return self

    def __exit__(self, *exc):
        from moe_infinity_tpu_torch.ops import gmm as gm

        gm.gmm = self._saved
        return False


def phase_mixtral_whole_path(dev):
    """f32 is held to the tolerance on three seeds (kernel and plain differ
    in summation order only; K3 rounds its x to bf16 in both, so an order
    difference upstream can flip a rounding there, which the line of K3
    inputs counts); bf16 is reported per request, as in phase 4."""
    from moe_infinity_tpu_torch.ops import launch_counts, reset_launches

    for dtype, seed in ((torch.float32, 77), (torch.float32, 78), (torch.float32, 79),
                        (torch.bfloat16, 77)):
        model, params, provider, g = _mixtral(dev, dtype, seed, num_layers=2)
        experts = provider.pytree()
        B, P, NP = SLOTS, MAX_COLS // PAGE, (MAX_COLS // PAGE) * (SLOTS + 1)
        fed = torch.tensor([16, 16, 9, 1], device=dev)
        valid = torch.zeros(B, MAX_COLS, dtype=torch.bool, device=dev)
        valid[torch.arange(MAX_COLS, device=dev)[None, :] < fed[:, None]] = True
        inputs = dict(
            num_pages=NP, valid=valid,
            table=(torch.randperm(NP - 1, generator=g, device=dev)[:B * P] + 1)
            .reshape(B, P).to(torch.int32),
            toks1=torch.randint(1, model.spec.vocab_size, (B, CHUNK), generator=g,
                                device=dev, dtype=torch.int32),
            toks2=torch.randint(1, model.spec.vocab_size, (B, 1), generator=g,
                                device=dev, dtype=torch.int32),
            rope2=fed.to(torch.int32)[:, None],
        )
        xs_got, xs_want = [], []
        with torch.inference_mode():
            reset_launches()
            with _gmm_inputs(xs_got):
                got = _batcher_steps(model, params, experts, inputs)
            counts = launch_counts()
            with _plain_kernels(), _gmm_inputs(xs_want):
                want = _batcher_steps(model, params, experts, inputs)
        if launch_counts() != counts:
            raise AssertionError(f"the plain run launched kernels: {counts} -> {launch_counts()}")
        _require_launched(counts, BATCHER_KERNELS, "Mixtral whole-path check")
        name = str(dtype).split(".")[-1]
        if dtype == torch.float32:
            flips = [int((a != b).sum()) for a, b in zip(xs_got, xs_want)]
            say(f"[check] seed {seed}: K3 inputs whose bf16 rounding differs between the "
                f"kernel and plain runs, per call (layer 0 gate, up, down, layer 1 ...; "
                f"W=16 step, then W=1): {flips} of {[a.numel() for a in xs_got]}")
        for label, a, b in (("W=16 chunk step", got[0], want[0]),
                            ("W=1 paged step", got[1], want[1])):
            full = (f"Mixtral whole path logits {name} seed {seed}, {label} (full width, "
                    f"2 layers, int8 experts, paged, holes)")
            if dtype == torch.float32:
                compare(full, a, b)
            else:
                rows = (a - b).abs().amax(dim=(1, 2)).tolist()
                same = (a.argmax(-1) == b.argmax(-1)).all().item()
                say(f"[check] {full}: per-request max_abs_err={['%.3e' % r for r in rows]} "
                    f"argmax equal={same} (reported, not held to a tolerance)")
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError("bf16 Mixtral whole-path logits are not finite")
        del model, params, provider, experts, got, want, xs_got, xs_want
        torch.cuda.empty_cache()


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    recs = phase_kernels(dev)
    counts = phase_main_path(dev)
    phase_whole_path(dev)
    mix_counts = phase_mixtral(dev)
    phase_mixtral_whole_path(dev)
    for r in recs:
        r["launches"] = counts[r["name"]] + mix_counts[r["name"]]
        r.pop("shape")
    say(f"[card] {smi}")
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
