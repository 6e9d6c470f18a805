"""Drive the PyTorch + CUDA port of moe_infinity_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device and build: needs a CUDA device, prints the card's name and power
   limit, builds every kernel from ``moe_infinity_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the shapes
   of the NLLB-MoE-54B path, with the error, its tolerance and the times of
   the kernel, the plain version and one library call for the same function;
3. the main path: NLLB-MoE-54B geometry (d_model 2048, 16 heads, FFN 8192,
   128 experts top-2, every 4th block sparse, vocab 256,206) with random
   weights from a seed, bf16 compute, packed int4 experts, resident on the
   card, ``Seq2SeqGenerator.generate`` answering 4 padded requests with 16
   greedy tokens each, through the kernels (launch counts must all be > 0);
4. a whole-path check: at full width and 2+2 blocks, the first decode step's
   logits through the kernels against the same model run through the plain
   versions on the card.

The line before the last is the per-kernel JSON record; the last line is
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
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    finite = bool(torch.isfinite(got.float()).all())
    say(f"[check] {name}: max_abs_err={err:.3e} tol(rtol=atol)={tol} "
        f"{'ok' if ok and finite else 'FAIL'}")
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
    return dict(
        name="gmm", route="cuda", source="moe_infinity_tpu_torch/csrc/gmm.cu",
        replaces="moe_infinity_tpu/ops/gmm.py:46", max_abs_err=max(errs),
        ms=gate["ms"] + down["ms"], plain_ms=gate["plain_ms"] + down["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="one decode MoE layer: gate + down launches, 8 rows, packed int4, "
              "D=2048 F=8192 S=128",
    )


def phase_kernels(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    recs = [check_flash_decode(g, dev), check_flash_attend(g, dev), check_gmm(g, dev)]
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
    if not all(n > 0 for n in counts.values()):
        raise AssertionError(f"a kernel of the path was never launched: {counts}")
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

        self._saved = (fa.flash_decode, fa.flash_attend, gm.gmm)

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

        def gmm(x, w, gs, scale=None, group_offset=0, group_ids=None, *, packed=False):
            return gm.gmm_plain(x, w, gs, scale, group_offset, group_ids, packed=packed)

        fa.flash_decode, fa.flash_attend, gm.gmm = decode, attend, gmm
        return self

    def __exit__(self, *exc):
        from moe_infinity_tpu_torch.ops import flash_attention as fa, gmm as gm

        fa.flash_decode, fa.flash_attend, gm.gmm = self._saved
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
        if launch_counts() != counts or not all(n > 0 for n in counts.values()):
            raise AssertionError(f"kernel launches wrong in the whole-path check: {counts}")
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


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    recs = phase_kernels(dev)
    counts = phase_main_path(dev)
    phase_whole_path(dev)
    for r in recs:
        r["launches"] = counts[r["name"]]
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
