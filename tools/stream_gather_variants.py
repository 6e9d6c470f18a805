"""Time ways of gathering expert records from page-locked host memory into
device scratch, on one card, back to back in one process: the loads that
``csrc/stream.cu`` makes (``__ldcs``, 16-byte vectors, four in flight a
thread), the same with eight in flight, the same with an L2 prefetch hint of
256 bytes, a TMA bulk copy (``cp.async.bulk``) of 64 KB a block through
shared memory, and the copy engine (one ``copy_(non_blocking=True)`` a
record). Each gathers U = 8 records of 16.86 MB (NLLB-MoE-54B's int4
record) out of 128 at scattered rows, and must equal the copy engine's
bytes. Prints one line per round and a JSON summary (median ms, GB/s).

    python3 tools/stream_gather_variants.py [--rounds 3] [--records 128]

Needs a CUDA card and nvcc; imports torch only. The kernels build into
the port's git-ignored ``moe_infinity_tpu_torch/_build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from pathlib import Path

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int VECS, bool L2HINT>
__global__ void __launch_bounds__(256) vec_gather(const char* base, const int* rows,
                                                   char* dst, long long rec) {
  const long long chunk = 256LL * VECS * 16;
  const long long off = (long long)blockIdx.x * chunk;
  const int u = blockIdx.y;
  const long long left = rec - off;
  const int nv = (int)((left < chunk ? left : chunk) / 16);
  const uint4* src = reinterpret_cast<const uint4*>(base + rows[u] * rec + off);
  uint4* d = reinterpret_cast<uint4*>(dst + u * rec + off);
  uint4 v[VECS];
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int j = threadIdx.x + i * 256;
    if (j < nv) {
      if (L2HINT) {
        asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];"
                     : "=r"(v[i].x), "=r"(v[i].y), "=r"(v[i].z), "=r"(v[i].w)
                     : "l"(src + j));
      } else {
        v[i] = __ldcs(src + j);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int j = threadIdx.x + i * 256;
    if (j < nv) d[j] = v[i];
  }
}

// one thread a block: a bulk copy of up to 64 KB into shared memory, an
// mbarrier that counts its bytes, then a bulk copy out
__global__ void bulk_gather(const char* base, const int* rows, char* dst, long long rec,
                            int chunk, int* timed_out) {
  extern __shared__ __align__(128) char smem[];
  __shared__ __align__(8) unsigned long long bar;
  const long long off = (long long)blockIdx.x * chunk;
  const int u = blockIdx.y;
  const int n = (int)(rec - off < chunk ? rec - off : chunk);
  if (threadIdx.x != 0) return;
  const char* src = base + rows[u] * rec + off;
  char* d = dst + u * rec + off;
  const unsigned b = (unsigned)__cvta_generic_to_shared(&bar);
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b));
  asm volatile("fence.mbarrier_init.release.cluster;");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(n));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(s), "l"(src), "r"(n), "r"(b) : "memory");
  unsigned done = 0;
  for (long long it = 0; it < (1LL << 24) && !done; ++it) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b) : "memory");
  }
  if (!done) {
    atomicAdd(timed_out, 1);
    return;
  }
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(d), "r"(s), "r"(n) : "memory");
  asm volatile("cp.async.bulk.commit_group;");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

extern "C" int run_vec(int kind, const void* base, const void* rows, int U, void* dst,
                       long long rec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vecs = kind == 1 ? 8 : 4;
  const long long chunk = 256LL * vecs * 16;
  const dim3 grid((unsigned)((rec + chunk - 1) / chunk), (unsigned)U);
  const char* b = static_cast<const char*>(base);
  const int* r = static_cast<const int*>(rows);
  char* d = static_cast<char*>(dst);
  if (kind == 0) vec_gather<4, false><<<grid, 256, 0, st>>>(b, r, d, rec);
  if (kind == 1) vec_gather<8, false><<<grid, 256, 0, st>>>(b, r, d, rec);
  if (kind == 2) vec_gather<4, true><<<grid, 256, 0, st>>>(b, r, d, rec);
  return (int)cudaGetLastError();
}

extern "C" int run_bulk(const void* base, const void* rows, int U, void* dst, long long rec,
                        int chunk, void* timed_out, void* stream) {
  cudaFuncSetAttribute(bulk_gather, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk);
  const dim3 grid((unsigned)((rec + chunk - 1) / chunk), (unsigned)U);
  bulk_gather<<<grid, 32, chunk, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(base), static_cast<const int*>(rows), static_cast<char*>(dst),
      rec, chunk, static_cast<int*>(timed_out));
  return (int)cudaGetLastError();
}
"""

REC = 16_859_136  # NLLB-MoE-54B's int4 record, bytes (6 roles), a multiple of 16
U = 8
BULK_CHUNK = 64 * 1024


def build() -> ctypes.CDLL:
    out = Path(__file__).resolve().parents[1] / "moe_infinity_tpu_torch" / "_build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "v.cu").write_text(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out / "v.so"),
                    str(out / "v.cu")], check=True)
    lib = ctypes.CDLL(str(out / "v.so"))
    c = ctypes.c_void_p
    lib.run_vec.argtypes = [ctypes.c_int, c, c, ctypes.c_int, c, ctypes.c_longlong, c]
    lib.run_bulk.argtypes = [c, c, ctypes.c_int, c, ctypes.c_longlong, ctypes.c_int, c, c]
    return lib


def event_ms(fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # the host queues every call before the card starts
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--records", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    lib = build()
    host = torch.empty(args.records * REC, dtype=torch.uint8, pin_memory=True)
    for lo in range(0, host.numel(), 1 << 30):  # random bytes, made on the card
        n = min(1 << 30, host.numel() - lo)
        host[lo:lo + n].copy_(torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev))
    g = torch.Generator().manual_seed(16)
    rows = torch.randperm(args.records, generator=g)[:U].to(torch.int32)
    rows_d = rows.to(dev)
    dst = torch.empty(U * REC, dtype=torch.uint8, device=dev)
    want = torch.empty_like(dst)
    timed_out = torch.zeros(1, dtype=torch.int32, device=dev)
    recs = host.view(args.records, REC)
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)  # noqa: E731

    def copies(out=want):
        for u, r in enumerate(rows.tolist()):
            out[u * REC:(u + 1) * REC].copy_(recs[r], non_blocking=True)

    def vec(kind):
        return lambda: lib.run_vec(kind, host.data_ptr(), rows_d.data_ptr(), U,
                                   dst.data_ptr(), REC, st())

    def bulk():
        return lib.run_bulk(host.data_ptr(), rows_d.data_ptr(), U, dst.data_ptr(), REC,
                            BULK_CHUNK, timed_out.data_ptr(), st())

    runs = {"ldcs_x4 (csrc/stream.cu)": vec(0), "ldcs_x8": vec(1), "ld_L2_256B_x4": vec(2),
            "bulk_64KB": bulk, "copy_engine": lambda: copies(dst)}
    copies()
    for name, fn in runs.items():  # each must move the copy engine's bytes
        dst.zero_()
        err = fn()
        torch.cuda.synchronize()
        ok = (err in (0, None)) and torch.equal(dst, want) and timed_out.item() == 0
        print(f"[check] {name}: launch {err}, equal {ok}", flush=True)
        if not ok:
            raise SystemExit(f"{name} did not gather the records")
    times = {k: [] for k in runs}
    for rnd in range(args.rounds):
        for name, fn in runs.items():
            times[name].append(event_ms(fn))
        print(f"[round {rnd}] " + " ".join(f"{k}={v[-1]:.4f}" for k, v in times.items()),
              flush=True)
    nbytes = U * REC
    summary = {k: {"ms": sorted(v)[len(v) // 2], "gb_per_s": nbytes / sorted(v)[len(v) // 2] / 1e6}
               for k, v in times.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "U": U, "record_bytes": REC, "variants": summary}))


if __name__ == "__main__":
    main()
