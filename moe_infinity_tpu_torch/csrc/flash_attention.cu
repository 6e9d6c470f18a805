// Hand-written Hopper attention kernels: head_dim 64 or 128 (K1, K2, K4) and
// the absorbed-MLA decode over a 512 + 64 wide latent cache (K5).
//
// flash_decode_kernel  replaces moe_infinity_tpu/ops/flash_attention.py
//                      _decode_kernel / flash_decode (one query token).
// paged_decode_kernel  replaces _paged_decode_kernel / paged_flash_decode
//                      (one query token over a paged K/V pool).
// attend_rows_kernel,  replace _attend_kernel / flash_attend (T >= 1, with
// flash_attend_kernel, additive bias, causal and pad masks): the first when
// flash_attend_f32_kernel  the T * rep query rows of a kv head fit the decode
//                      body (NLLB's cross-attention), the second for bf16 on
//                      the tensor cores, the third for f32 on the CUDA cores.
// mla_decode_kernel,   replace _mla_decode_kernel / mla_flash_decode (one
// mla_decode_f32_kernel query token of DeepSeek's absorbed MLA, one launch a
//                      call): the first for bf16 caches on the tensor cores,
//                      the second for f32 caches; their note stands above
//                      them.
//
// All keep the TPU kernels' arithmetic: scores and softmax in f32, online
// softmax with the finite kNeg, a row with no valid key returns 0, softcap
// before the bias. flash_attend rounds p to V's type before P.V, as the TPU
// kernel does; the decode kernels keep p in f32, as theirs do.
//
// What bounds them on the H100. One decode step reads each live K/V row once
// and does 4 operations per byte of it, so the bound is the bytes; at the
// serving paths' sizes (a few hundred keys, B * Hkv <= 64) those bytes take
// under a microsecond and what is left is latency: a launch, and every
// dependent trip to device memory. So the decode body (K1, K4 and K2's
// few-row route share it) makes the chain short and wide instead of long and
// thin: the keys of a (batch row, kv head) are split over blocks, a block
// starts all 16-byte loads of a 64-key tile at once (cp.async, into shared
// memory in the cache's own type, the next tile in flight while this one is
// consumed), a lane owns a key for the scores and 4 head dims for the values,
// and the online softmax is updated once per 32 keys, not per key. The last
// split of a row to finish merges them all; a plan of one split writes the
// result itself. flash_attend at T >= 16 is bound by operations once the
// keys are a few hundred (4 * T * S * Dh per head against 4 * S * Dh bytes
// per kv head), so its bf16 kernel runs both products on the tensor cores
// (mma.sync m16n8k16, the 16-row tile that fits a 16-wide chunk step).
// No kernel reads a row at or past the live length (kv_len, the causal
// bound), nor a key whose mask byte is 0.
#include <limits.h>

#include <atomic>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

// K1, K2 and K4 take the head dim DH as a template parameter, 64 (Switch's
// T5 attention) or 128 (NLLB, Mixtral). Where a lane owns head dims of the
// values, it owns DH / 32 consecutive ones: 4 at 128, 2 at 64.
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load2(const float* p, float o[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float o[2]) {
  const unsigned v = *reinterpret_cast<const unsigned*>(p);
  o[0] = __uint_as_float(v << 16);
  o[1] = __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void store2(float* p, const float x[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float x[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
}
// N (2 or 4) consecutive elements as float, and back; p aligned to N elements
template <int N, typename T>
__device__ __forceinline__ void load_lane(const T* p, float* o) {
  if constexpr (N == 4)
    mit::load4(p, o);
  else
    load2(p, o);
}
template <int N, typename T>
__device__ __forceinline__ void store_lane(T* p, const float* x) {
  if constexpr (N == 4)
    mit::store4(p, x);
  else
    store2(p, x);
}

using mit::cp_async16;
using mit::cp_async_commit;
using mit::cp_async_wait;

// ---------------------------------------------------------------------------
// The decode body: grid (split, Hkv, B). A block owns the `Tq * rep` query
// rows of one kv head of one batch row (row j = t * rep + r is query token t,
// head hk * rep + r) over the keys [split * kc, (split + 1) * kc) of that
// batch row, so those cache rows are read once for all its heads. It walks
// them in tiles of kDecTile keys. Warp (row group, slot) owns 1 or 2 query
// rows and the slot's 32 keys of every tile, with its own online-softmax
// state: in the score phase lane j takes the DH-long dot product of key j
// (rows are padded by 16 bytes, so the lanes of a quarter warp read 8
// different bank groups), then one max, one sum and one rescale per 32 keys,
// then lane j accumulates p * v for head dims [jN, jN + N), N = DH / 32. No
// block-wide
// exchange happens between the two phases; the block synchronises only on a
// tile's arrival and release. At the end the two slots of a row merge through
// shared memory, and the block either writes the result (a plan of one
// split) or its (m, l) and unnormalised sum to scratch, where the last split
// of the (batch row, kv head) to finish (a ticket counter) merges them.
//
// Keys at or past the live length, and keys whose mask byte is 0, are never
// loaded: their shared-memory rows are zero-filled, so whatever a hole holds
// (NaN included) cannot reach a sum.
//
// All 256 threads of a block load, 4 chunk rows of a bf16 tile each whatever
// the row count (at these sizes a cold kernel pays for every instruction it
// fetches: 16 unrolled rows per thread cost 3 us); the first
// `row groups * 2` warps compute.
//
// K1 (contiguous cache), K4 (page pool behind a page table) and K2's few-row
// route (bias, per-row causal positions, p rounded to V's type) differ in
// what DecArgs carries, not in the body; it has three kernel names so that a
// profile tells them apart.
// ---------------------------------------------------------------------------
constexpr int kDecTile = 64;  // keys per tile: the wrappers plan in whole tiles
constexpr int kDecSlots = 2;  // 32-key slots of a tile, one warp each per row group

struct DecArgs {
  const void* q;           // [B, Tq, H, Dh]
  const void* k;           // [B, S, Hkv, Dh], or the pool [NP, page, Hkv, Dh]
  const void* v;
  void* out;               // [B, Tq, H, Dh]
  const int32_t* qpos;     // [B, Tq], or null (paged: causality is in lengths)
  const int32_t* lengths;  // [B] live keys per row, or null (then kv_len)
  const int32_t* table;    // [B, P] physical page ids, or null (contiguous)
  const uint8_t* mask;     // [B, S] or null
  const float* bias;       // strided [B|1, H|1, Tq|1, S] or null
  long long bsb, bsh, bst;
  float* part_acc;         // [B, Hkv, NS, Tq * rep, Dh] when NS > 1
  float* part_ml;          // [B, Hkv, NS, Tq * rep, 2]
  int* tickets;            // [B, Hkv], zero between launches, when NS > 1
  int Tq, H, Hkv, rep, S, P, page, page_shift, kv_len, causal, round_p, kc, NS;
  float scale, softcap;
};

template <typename T, int DH>
struct DecTile {
  static constexpr int kPer = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  static constexpr int kChunks = DH / kPer;         // chunks of a row
  static constexpr int kRowBytes = DH * (int)sizeof(T) + 16;  // 16 of padding
  // the next tile loads during this one, except for f32 rows of 128, whose
  // one buffer of K and V is as large as two of bf16
  static constexpr int kBufs = DH * (int)sizeof(T) <= 256 ? 2 : 1;
};

__device__ __forceinline__ void dec_unpack(const uint4& u, float* f,
                                           const __nv_bfloat16*) {
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
  f[4] = __uint_as_float(u.z << 16);
  f[5] = __uint_as_float(u.z & 0xffff0000u);
  f[6] = __uint_as_float(u.w << 16);
  f[7] = __uint_as_float(u.w & 0xffff0000u);
}
__device__ __forceinline__ void dec_unpack(const uint4& u, float* f,
                                           const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

constexpr int kDecThreads = 256;  // all load; RowGroups * kDecSlots warps compute

template <int MAXR>
struct DecShape {
  static constexpr int kRowsPerWarp = MAXR > 4 ? MAXR / 4 : 1;
  static constexpr int kRowGroups = MAXR / kRowsPerWarp;  // 1, 2, 4, 4
};

template <typename T, int DH>
constexpr int dec_smem_bytes() {
  return DecTile<T, DH>::kBufs * 2 * kDecTile * DecTile<T, DH>::kRowBytes;
}

// Live keys of batch row b: below kv_len (or lengths[b]) and S and, when
// causal, at most the row's last query position.
__device__ __forceinline__ int dec_row_len(const DecArgs& a, int b) {
  int n = min(a.lengths ? a.lengths[b] : a.kv_len, a.S);
  if (a.causal && a.qpos) {
    int mx = -1;
    for (int t = 0; t < a.Tq; ++t) mx = max(mx, a.qpos[(size_t)b * a.Tq + t]);
    n = min(n, mx + 1);
  }
  return max(n, 0);
}

// Split 0 is live even for an empty row (it then writes an empty state), so
// every (b, hk) has a live split for the merge to read.
__device__ __forceinline__ int dec_live_splits(const DecArgs& a, int row_len) {
  return min(a.NS, max(1, (row_len + a.kc - 1) / a.kc));
}

template <typename T, int DH>
__device__ __forceinline__ T* dec_out_row(const DecArgs& a, int b, int hk,
                                          int j) {
  const int t = j / a.rep, r = j % a.rep;
  return static_cast<T*>(a.out) +
         (((size_t)b * a.Tq + t) * a.H + (size_t)hk * a.rep + r) * DH;
}

// Combine the live splits of (b, hk) and write the result: thread = (query
// row, 4 head dims), `nthreads` threads. Reads past the L1 (other blocks
// wrote the scratch).
template <typename T, int DH>
__device__ __forceinline__ void dec_merge(const DecArgs& a, int b, int hk,
                                          int live, int nthreads) {
  constexpr int kD4 = DH / 4;
  const int nrows = a.Tq * a.rep;
  const size_t base = ((size_t)b * a.Hkv + hk) * a.NS;
  for (int idx = threadIdx.x; idx < nrows * kD4; idx += nthreads) {
    const int j = idx / kD4, d4 = idx % kD4;
    float M = mit::kNeg;
    for (int s = 0; s < live; ++s)
      M = fmaxf(M, __ldcg(a.part_ml + ((base + s) * nrows + j) * 2));
    float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < live; ++s) {
      const size_t row = (base + s) * nrows + j;
      const float w = expf(__ldcg(a.part_ml + row * 2) - M);
      L += __ldcg(a.part_ml + row * 2 + 1) * w;
      const float4 pa = __ldcg(
          reinterpret_cast<const float4*>(a.part_acc + row * DH + d4 * 4));
      A[0] = fmaf(pa.x, w, A[0]);
      A[1] = fmaf(pa.y, w, A[1]);
      A[2] = fmaf(pa.z, w, A[2]);
      A[3] = fmaf(pa.w, w, A[3]);
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) A[i] *= inv;
    mit::store4(dec_out_row<T, DH>(a, b, hk, j) + d4 * 4, A);
  }
}

template <typename T, int MAXR, bool PAGED, int DH>
__device__ __forceinline__ void decode_body(const DecArgs& a) {
  using TL = DecTile<T, DH>;
  using SH = DecShape<MAXR>;
  constexpr int RPW = SH::kRowsPerWarp;
  constexpr int kLD = DH / 32;  // head dims of the values a lane owns
  constexpr int NT = kDecThreads;
  constexpr int kBufBytes = 2 * kDecTile * TL::kRowBytes;  // K then V
  extern __shared__ __align__(16) unsigned char dec_smem[];
  __shared__ __align__(16) float q_s[MAXR][DH];
  __shared__ __align__(16) float mrg_s[MAXR][DH + 4];  // slot 1: sum, m, l
  __shared__ int valid_s[TL::kBufs][kDecTile];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp / kDecSlots, slot = warp % kDecSlots;
  const bool computes = rg < SH::kRowGroups;  // the other warps only load
  const int nrows = a.Tq * a.rep;
  const int row_len = dec_row_len(a, b);
  const int k_begin = split * a.kc;
  if (split > 0 && k_begin >= row_len) return;  // owns no live key
  // the last split takes whatever a too-small plan left over
  const int k_end =
      split == a.NS - 1 ? row_len : min(k_begin + a.kc, row_len);
  const int ntiles = max(0, (k_end - k_begin + kDecTile - 1) / kDecTile);
  const int fill_end = k_begin + ((k_end - k_begin + 31) & ~31);
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  const size_t srow = (size_t)a.Hkv * DH;

  bool row_ok[RPW];
  int pos[RPW];
  float m[RPW], l[RPW], acc[RPW][kLD];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int j = rg * RPW + rr;
    row_ok[rr] = computes && j < nrows;
    pos[rr] = (a.causal && a.qpos && row_ok[rr])
                  ? a.qpos[(size_t)b * a.Tq + j / a.rep]
                  : INT_MAX;
    m[rr] = mit::kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kLD; ++i) acc[rr][i] = 0.f;
  }

  // Loads: a thread owns one 16-byte chunk column of ITER rows of a tile.
  // fetch(ti) reads the mask bytes and page-table entries of its rows of tile
  // ti into registers; load_tile(ti, buf), one tile later, starts every K and
  // V load of the tile at once. So the loads of tile ti + 1 never wait for a
  // trip to device memory of their own.
  constexpr int RSTEP = NT / TL::kChunks;
  constexpr int ITER = kDecTile / RSTEP;
  const int lc = tid % TL::kChunks, lr0 = tid / TL::kChunks;
  unsigned char mk[ITER];  // 0: not to be loaded
  int pg[ITER];            // the row's physical page (paged caches)
  auto fetch = [&](int ti) {
    const int s0 = k_begin + ti * kDecTile + lr0;
#pragma unroll
    for (int n = 0; n < ITER; ++n) {
      const int s = s0 + n * RSTEP;
      const bool in = s < k_end;
      mk[n] = (in && a.mask != nullptr) ? a.mask[(size_t)b * a.S + s]
                                        : (unsigned char)in;
      pg[n] = 0;
      if (PAGED && in)
        pg[n] = a.table[(size_t)b * a.P +
                        (a.page_shift >= 0 ? s >> a.page_shift : s / a.page)];
    }
  };
  auto load_tile = [&](int ti, int buf) {
    const int s0 = k_begin + ti * kDecTile + lr0;
    unsigned char* kb = dec_smem + (size_t)buf * kBufBytes;
    unsigned char* vb = kb + kDecTile * TL::kRowBytes;
#pragma unroll
    for (int n = 0; n < ITER; ++n) {
      const int row = lr0 + n * RSTEP, s = s0 + n * RSTEP;
      unsigned char* kd = kb + row * TL::kRowBytes + lc * 16;
      unsigned char* vd = vb + row * TL::kRowBytes + lc * 16;
      const bool ok = mk[n] != 0;
      if (lc == 0) valid_s[buf][row] = ok;
      if (ok) {
        const size_t r =
            !PAGED ? (size_t)b * a.S + s
                   : (size_t)pg[n] * a.page +
                         (a.page_shift >= 0 ? s & (a.page - 1) : s % a.page);
        const size_t e = r * srow + (size_t)hk * DH + lc * TL::kPer;
        cp_async16(kd, kg + e);
        cp_async16(vd, vg + e);
      } else if (s < fill_end) {
        // never loaded: whatever a hole holds cannot reach a sum (a slot
        // wholly past the live keys is skipped and needs no zeros)
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  fetch(0);
#pragma unroll
  for (int s = 0; s < TL::kBufs - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
    fetch(s + 1);
  }

  // the block's query rows as f32, zero for a row past nrows (after the
  // first tile's loads are on their way, so that the two overlap)
  for (int i = tid; i < MAXR * (DH / 4); i += NT) {
    const int j = i / (DH / 4), c = (i % (DH / 4)) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < nrows) {
      const int t = j / a.rep, r = j % a.rep;
      mit::load4(static_cast<const T*>(a.q) +
                     (((size_t)b * a.Tq + t) * a.H + (size_t)hk * a.rep + r) *
                         DH + c,
                 f);
    }
    *reinterpret_cast<float4*>(&q_s[j][c]) = make_float4(f[0], f[1], f[2], f[3]);
  }

  for (int ti = 0; ti < ntiles; ++ti) {
    const int nxt = ti + TL::kBufs - 1;
    if (nxt < ntiles) load_tile(nxt, nxt % TL::kBufs);
    cp_async_commit();
    fetch(nxt + 1);
    cp_async_wait<TL::kBufs - 1>();  // tile ti has landed
    __syncthreads();
    const int buf = ti % TL::kBufs;
    const unsigned char* kb = dec_smem + (size_t)buf * kBufBytes;
    const unsigned char* vb = kb + kDecTile * TL::kRowBytes;
    const int krow_i = slot * 32 + lane;
    const bool kvalid = computes && valid_s[buf][krow_i] != 0;
    const unsigned vmask = __ballot_sync(kFull, kvalid);
    if (computes && vmask != 0u) {  // the slot holds a valid key
      const int key = k_begin + ti * kDecTile + krow_i;
      float sc4[RPW][4];  // four partial sums: a chain of 32, not 128
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc4[rr][i] = 0.f;
      const unsigned char* krow = kb + krow_i * TL::kRowBytes;
#pragma unroll 4
      for (int c = 0; c < TL::kChunks; ++c) {
        float kf[TL::kPer];
        dec_unpack(*reinterpret_cast<const uint4*>(krow + c * 16), kf, kg);
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          const float4* qv = reinterpret_cast<const float4*>(
              &q_s[rg * RPW + rr][c * TL::kPer]);
#pragma unroll
          for (int e = 0; e < TL::kPer / 4; ++e) {
            const float4 qq = qv[e];
            sc4[rr][0] = fmaf(kf[4 * e], qq.x, sc4[rr][0]);
            sc4[rr][1] = fmaf(kf[4 * e + 1], qq.y, sc4[rr][1]);
            sc4[rr][2] = fmaf(kf[4 * e + 2], qq.z, sc4[rr][2]);
            sc4[rr][3] = fmaf(kf[4 * e + 3], qq.w, sc4[rr][3]);
          }
        }
      }
      float pb[RPW];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int j = rg * RPW + rr;
        float x = ((sc4[rr][0] + sc4[rr][1]) + (sc4[rr][2] + sc4[rr][3])) * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        const bool valid = kvalid && row_ok[rr] && key <= pos[rr];
        if (a.bias != nullptr && valid)
          x += a.bias[b * a.bsb + ((long long)hk * a.rep + j % a.rep) * a.bsh +
                      (j / a.rep) * a.bst + key];
        x = valid ? x : mit::kNeg;
        const float mn = fmaxf(m[rr], mit::warp_max(x));
        const float alpha = expf(m[rr] - mn);
        const float p = valid ? expf(x - mn) : 0.f;
        l[rr] = l[rr] * alpha + mit::warp_sum(p);
        pb[rr] = a.round_p ? mit::round_as(p, kg) : p;
        m[rr] = mn;
#pragma unroll
        for (int i = 0; i < kLD; ++i) acc[rr][i] *= alpha;
      }
      const unsigned char* vrow = vb + (size_t)slot * 32 * TL::kRowBytes;
      const int s_end = 32 - __clz(vmask);  // past the slot's last valid key
#pragma unroll 8
      for (int s = 0; s < s_end; ++s) {
        float vf[kLD];
        load_lane<kLD>(reinterpret_cast<const T*>(vrow + s * TL::kRowBytes) +
                           lane * kLD,
                       vf);
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          const float pj = __shfl_sync(kFull, pb[rr], s);
#pragma unroll
          for (int i = 0; i < kLD; ++i) acc[rr][i] = fmaf(pj, vf[i], acc[rr][i]);
        }
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
  }

  // slot 1 hands its state to slot 0
  if (computes && slot == 1) {
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int j = rg * RPW + rr;
      store_lane<kLD>(&mrg_s[j][lane * kLD], acc[rr]);
      if (lane == 0) {
        mrg_s[j][DH] = m[rr];
        mrg_s[j][DH + 1] = l[rr];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int j = rg * RPW + rr;
    if (!computes || slot != 0 || j >= nrows) continue;
    const float m1 = mrg_s[j][DH], l1 = mrg_s[j][DH + 1];
    float a1[kLD];
    load_lane<kLD>(&mrg_s[j][lane * kLD], a1);
    const float M = fmaxf(m[rr], m1);
    const float c0 = expf(m[rr] - M), c1 = expf(m1 - M);
    const float L = l[rr] * c0 + l1 * c1;
    float o[kLD];
#pragma unroll
    for (int i = 0; i < kLD; ++i) o[i] = acc[rr][i] * c0 + a1[i] * c1;
    if (a.NS == 1) {
      const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
      for (int i = 0; i < kLD; ++i) o[i] *= inv;
      store_lane<kLD>(dec_out_row<T, DH>(a, b, hk, j) + lane * kLD, o);
    } else {  // this split's state, one writer per element
      const size_t row =
          (((size_t)b * a.Hkv + hk) * a.NS + split) * nrows + j;
      store_lane<kLD>(a.part_acc + row * DH + lane * kLD, o);
      if (lane == 0) {
        a.part_ml[row * 2] = M;
        a.part_ml[row * 2 + 1] = L;
      }
    }
  }
  if (a.NS == 1) return;
  // The last live split of (b, hk) to get here merges them all (a second
  // kernel for the merge cost 1.7 us more per call at Mixtral's decode shape).
  __shared__ int last_s;
  __threadfence();
  __syncthreads();
  const int live = dec_live_splits(a, row_len);
  if (tid == 0) {
    int* ticket = a.tickets + (size_t)b * a.Hkv + hk;
    last_s = atomicAdd(ticket, 1) == live - 1;
    if (last_s) *ticket = 0;  // every other split has drawn: ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  dec_merge<T, DH>(a, b, hk, live, NT);
}

template <typename T, int MAXR, int DH>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const DecArgs a) {
  decode_body<T, MAXR, false, DH>(a);
}

template <typename T, int MAXR, int DH>
__global__ void __launch_bounds__(kDecThreads)
    paged_decode_kernel(const DecArgs a) {
  decode_body<T, MAXR, true, DH>(a);
}

template <typename T, int MAXR, int DH>
__global__ void __launch_bounds__(kDecThreads)
    attend_rows_kernel(const DecArgs a) {
  decode_body<T, MAXR, false, DH>(a);
}

enum DecKind { kDecContig = 0, kDecPaged = 1, kDecAttend = 2 };

template <typename T, int MAXR, int DH>
int launch_rows_r(int kind, const DecArgs& a, int B, cudaStream_t stream) {
  void (*kern)(const DecArgs) =
      kind == kDecContig  ? flash_decode_kernel<T, MAXR, DH>
      : kind == kDecPaged ? paged_decode_kernel<T, MAXR, DH>
                          : attend_rows_kernel<T, MAXR, DH>;
  static std::atomic<unsigned long long> sized[3];  // per kind, a bit per device
  constexpr int smem = dec_smem_bytes<T, DH>();
  const int err = mit::smem_once(reinterpret_cast<const void*>(kern), smem, sized[kind]);
  if (err != 0) return err;
  kern<<<dim3(a.NS, a.Hkv, B), kDecThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_rows(int kind, const DecArgs& a, int B, cudaStream_t stream) {
  const int nrows = a.Tq * a.rep;
  if (nrows <= 1) return launch_rows_r<T, 1, DH>(kind, a, B, stream);
  if (nrows <= 2) return launch_rows_r<T, 2, DH>(kind, a, B, stream);
  if (nrows <= 4) return launch_rows_r<T, 4, DH>(kind, a, B, stream);
  if (nrows <= 8) return launch_rows_r<T, 8, DH>(kind, a, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_rows_dh(int kind, const DecArgs& a, int B, int head_dim,
                   cudaStream_t stream) {
  if (head_dim == 64) return launch_rows<T, 64>(kind, a, B, stream);
  if (head_dim == 128) return launch_rows<T, 128>(kind, a, B, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// flash_attend, bf16, T * rep > 8: both products on the tensor cores.
// Grid (ceil(units / 4), Hkv, B), where a unit is 16 query tokens of one
// head and unit u = chunk * rep + r, so that a block's 4 units are the rep
// heads of one kv head where rep = 4 (Mixtral's chunk step) and 4 chunks of
// one head where rep = 1 (NLLB's encoder): the K/V rows a block stages are
// read once for all of them. A warp owns its unit: the Q fragments stay in
// registers, K and V stages of 128 keys stay bf16 in shared memory (cp.async,
// two buffers, rows padded by 16 bytes so that ldmatrix's 8 rows fall in 8
// bank groups), scores are f32 mma fragments, the online softmax runs on the
// fragments (a row lives in a quad: two shuffles give its max), and p rounded
// to bf16 is the A operand of the P.V product, which is the TPU kernel's
// rounding. With more than 64 live keys each unit has HALVES = 2 warps, one
// per 64-key half of every 128-key stage, so that a few hundred keys are a
// chain of two or three tiles per warp and an SM's schedulers each hold two
// warps; the halves merge through shared memory at the end. Stages wholly in
// the future of a block's queries are never read; a warp skips the tiles
// wholly in the future of its own.
// ---------------------------------------------------------------------------
constexpr int kMmaUnits = 4;       // units of a block; warp = (key half, unit)
constexpr int kMmaTile = 64;       // keys a warp takes at a time

template <int DH>
__host__ __device__ constexpr int mma_row_bytes() {  // a bf16 row padded by 16 bytes
  return DH * 2 + 16;
}

template <int HALVES, int DH>
constexpr int mma_smem_bytes() {  // two buffers of K then V
  return 2 * 2 * HALVES * kMmaTile * mma_row_bytes<DH>();
}

using mit::ldmatrix_x4;
using mit::ldmatrix_x4_trans;
using mit::mma_bf16;
using mit::pack_bf16;

template <int HALVES, int DH>
__global__ void __launch_bounds__(HALVES * kMmaUnits * 32) flash_attend_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, T, H, Dh]
    const __nv_bfloat16* __restrict__ k,   // [B, S, Hkv, Dh]
    const __nv_bfloat16* __restrict__ v,   // [B, S, Hkv, Dh]
    const int32_t* __restrict__ qpos,      // [B, T]
    const float* __restrict__ bias,        // strided [B|1, H|1, T|1, S] or null
    long long bsb, long long bsh, long long bst,
    const uint8_t* __restrict__ mask,      // [B, S] or null
    __nv_bfloat16* __restrict__ out,       // [B, T, H, Dh]
    int Tq, int H, int Hkv, int S, int kv_len, int causal, float scale,
    float softcap) {
  constexpr int kMmaWarps = HALVES * kMmaUnits;
  constexpr int kMmaStage = HALVES * kMmaTile;  // keys loaded at a time
  constexpr int kMmaRowBytes = mma_row_bytes<DH>();
  constexpr int kMmaBufBytes = 2 * kMmaStage * kMmaRowBytes;
  constexpr int kRowChunks = DH / 8;  // 16-byte chunks of a row
  constexpr int kLoadRows = kMmaWarps * 32 / kRowChunks;  // rows of one loader pass
  constexpr int kKs = DH / 16;   // k-steps of the score product
  constexpr int kDn = DH / 8;    // 8-wide head-dim groups of the P.V product
  extern __shared__ __align__(16) unsigned char att_smem[];
  __shared__ int valid_s[2][kMmaStage];
  __shared__ int wmax_s[kMmaWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // the fragment's row and column pair
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int units = ((Tq + 15) / 16) * rep;
  const int half = warp / kMmaUnits;  // which 64 keys of a stage
  const int u = blockIdx.x * kMmaUnits + warp % kMmaUnits;
  const bool warp_on = u < units;
  const int h = hk * rep + (warp_on ? u % rep : 0);
  const int t0 = (warp_on ? u / rep : 0) * 16;
  const int tA = t0 + g, tB = t0 + g + 8;  // this thread's two query tokens
  const bool okA = warp_on && tA < Tq, okB = warp_on && tB < Tq;
  const int posA = okA ? qpos[(size_t)b * Tq + tA] : -1;
  const int posB = okB ? qpos[(size_t)b * Tq + tB] : -1;

  // live keys: below kv_len and, when causal, at most the last position of
  // the block's (for loading) and of the warp's (for computing) queries
  int kv_end = min(kv_len, S), my_end = kv_end;
  if (causal) {
    int wmax = max(posA, posB);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      wmax = max(wmax, __shfl_xor_sync(kFull, wmax, o));
    if (lane == 0) wmax_s[warp] = wmax;
    __syncthreads();
    int bmax = -1;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) bmax = max(bmax, wmax_s[w]);
    my_end = min(kv_end, wmax + 1);
    kv_end = min(kv_end, bmax + 1);
  }
  if (!warp_on) my_end = 0;
  kv_end = max(kv_end, 0);
  const int ntiles = (kv_end + kMmaStage - 1) / kMmaStage;  // stages
  const int fill_end = (kv_end + kMmaTile - 1) / kMmaTile * kMmaTile;

  // Q as A fragments: DH / 16 k-steps of 16 head dims
  unsigned qa[kKs][4];
  {
    const __nv_bfloat16* qA = q + (((size_t)b * Tq + tA) * H + h) * DH;
    const __nv_bfloat16* qB = q + (((size_t)b * Tq + tB) * H + h) * DH;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const int c = ks * 16 + 2 * tq;
      qa[ks][0] = okA ? *reinterpret_cast<const unsigned*>(qA + c) : 0u;
      qa[ks][1] = okB ? *reinterpret_cast<const unsigned*>(qB + c) : 0u;
      qa[ks][2] = okA ? *reinterpret_cast<const unsigned*>(qA + c + 8) : 0u;
      qa[ks][3] = okB ? *reinterpret_cast<const unsigned*>(qB + c + 8) : 0u;
    }
  }

  float o[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float mA = mit::kNeg, mB = mit::kNeg, lA = 0.f, lB = 0.f;

  const size_t srow = (size_t)Hkv * DH;
  // a thread owns chunk column lc of the rows of a stage kLoadRows apart; the
  // mask bytes of its rows are read one stage ahead of the loads they gate
  const int lc = tid % kRowChunks, lr0 = tid / kRowChunks;
  unsigned char mk[kMmaStage / kLoadRows];  // 0: not to be loaded
  auto fetch = [&](int ti) {
#pragma unroll
    for (int n = 0; n < kMmaStage / kLoadRows; ++n) {
      const int s = ti * kMmaStage + lr0 + n * kLoadRows;
      const bool in = s < kv_end;
      mk[n] = (in && mask != nullptr) ? mask[(size_t)b * S + s]
                                      : (unsigned char)in;
    }
  };
  auto load_tile = [&](int ti, int buf) {
    unsigned char* kb = att_smem + (size_t)buf * kMmaBufBytes;
    unsigned char* vb = kb + kMmaStage * kMmaRowBytes;
#pragma unroll
    for (int n = 0; n < kMmaStage / kLoadRows; ++n) {
      const int row = lr0 + n * kLoadRows, s = ti * kMmaStage + row;
      const bool ok = mk[n] != 0;
      unsigned char* kd = kb + row * kMmaRowBytes + lc * 16;
      unsigned char* vd = vb + row * kMmaRowBytes + lc * 16;
      if (lc == 0) valid_s[buf][row] = ok;
      if (ok) {
        const size_t e = ((size_t)b * S + s) * srow + (size_t)hk * DH + lc * 8;
        cp_async16(kd, k + e);
        cp_async16(vd, v + e);
      } else if (s < fill_end) {
        // never loaded: whatever a hole holds cannot reach a sum (a half
        // wholly past the live keys is skipped and needs no zeros)
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  fetch(0);
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();
  fetch(1);
  for (int ti = 0; ti < ntiles; ++ti) {
    if (ti + 1 < ntiles) load_tile(ti + 1, (ti + 1) & 1);
    cp_async_commit();
    fetch(ti + 2);
    cp_async_wait<1>();  // tile ti has landed
    __syncthreads();
    const int buf = ti & 1, s0 = ti * kMmaStage + half * kMmaTile;
    if (s0 < my_end) {  // warp-uniform
      const unsigned char* kb = att_smem + (size_t)buf * kMmaBufBytes +
                                (size_t)half * kMmaTile * kMmaRowBytes;
      const unsigned char* vb = kb + kMmaStage * kMmaRowBytes;
      const int* vs = valid_s[buf] + half * kMmaTile;
      // scores: 8 key groups of 8, each over DH / 16 k-steps
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const unsigned char* rowp =
            kb + (nt * 8 + (lane & 7)) * kMmaRowBytes + (lane >> 3) * 16;
#pragma unroll
        for (int ks = 0; ks < kKs; ks += 2) {
          unsigned kf[4];  // B fragments of k-steps ks and ks + 1
          ldmatrix_x4(kf, rowp + ks * 32);
          mma_bf16(s[nt], qa[ks], kf[0], kf[1]);
          mma_bf16(s[nt], qa[ks + 1], kf[2], kf[3]);
        }
      }
      // masks, bias, the tile's row maxima
      unsigned vbits = 0u;
      float mxA = mit::kNeg, mxB = mit::kNeg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = nt * 8 + 2 * tq + (e & 1), key = s0 + kl;
          const bool rowB = e >= 2;
          const int pos = rowB ? posB : posA;
          const bool valid = vs[kl] != 0 && (rowB ? okB : okA) &&
                             (!causal || key <= pos);
          float x = s[nt][e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (bias != nullptr && valid)
            x += bias[b * bsb + h * bsh + (rowB ? tB : tA) * bst + key];
          x = valid ? x : mit::kNeg;
          s[nt][e] = x;
          if (valid) vbits |= 1u << (nt * 4 + e);
          if (rowB)
            mxB = fmaxf(mxB, x);
          else
            mxA = fmaxf(mxA, x);
        }
      }
      mxA = fmaxf(mxA, __shfl_xor_sync(kFull, mxA, 1));
      mxA = fmaxf(mxA, __shfl_xor_sync(kFull, mxA, 2));
      mxB = fmaxf(mxB, __shfl_xor_sync(kFull, mxB, 1));
      mxB = fmaxf(mxB, __shfl_xor_sync(kFull, mxB, 2));
      const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
      const float alA = __expf(mA - mnA), alB = __expf(mB - mnB);
      mA = mnA;
      mB = mnB;
      float sumA = 0.f, sumB = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = (vbits >> (nt * 4 + e)) & 1u;
          const float p = valid ? __expf(s[nt][e] - (e >= 2 ? mnB : mnA)) : 0.f;
          s[nt][e] = p;
          if (e >= 2)
            sumB += p;
          else
            sumA += p;
        }
      }
      lA = lA * alA + sumA;  // this thread's share; the quad sums at the end
      lB = lB * alB + sumB;
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn) {
        o[dn][0] *= alA;
        o[dn][1] *= alA;
        o[dn][2] *= alB;
        o[dn][3] *= alB;
      }
      // P.V: 4 k-steps of 16 keys, DH / 8 groups of 8 head dims
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const unsigned char* rowp =
            vb + (kk * 16 + (lane & 15)) * kMmaRowBytes + (lane >> 4) * 16;
#pragma unroll
        for (int dn = 0; dn < kDn; dn += 2) {
          unsigned vf[4];  // B fragments of dim groups dn and dn + 1
          ldmatrix_x4_trans(vf, rowp + dn * 16);
          mma_bf16(o[dn], pa, vf[0], vf[1]);
          mma_bf16(o[dn + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the buffer is free for the stage after next
  }

  lA += __shfl_xor_sync(kFull, lA, 1);
  lA += __shfl_xor_sync(kFull, lA, 2);
  lB += __shfl_xor_sync(kFull, lB, 1);
  lB += __shfl_xor_sync(kFull, lB, 2);
  if (HALVES == 2 && kv_end > kMmaTile) {  // the second halves hold keys
    constexpr int kO = kDn * 4;  // a thread's sums
    float* mrg = reinterpret_cast<float*>(att_smem) +
                 (size_t)(warp % kMmaUnits) * (kO + 4) * 32 + lane;  // [kO + 4][32]
    if (half == 1) {
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) mrg[(dn * 4 + e) * 32] = o[dn][e];
      mrg[kO * 32] = mA;
      mrg[(kO + 1) * 32] = mB;
      mrg[(kO + 2) * 32] = lA;
      mrg[(kO + 3) * 32] = lB;
    }
    __syncthreads();
    if (half == 0) {
      const float m1A = mrg[kO * 32], m1B = mrg[(kO + 1) * 32];
      const float MA = fmaxf(mA, m1A), MB = fmaxf(mB, m1B);
      const float c0A = __expf(mA - MA), c1A = __expf(m1A - MA);
      const float c0B = __expf(mB - MB), c1B = __expf(m1B - MB);
      lA = lA * c0A + mrg[(kO + 2) * 32] * c1A;
      lB = lB * c0B + mrg[(kO + 3) * 32] * c1B;
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn) {
        o[dn][0] = o[dn][0] * c0A + mrg[(dn * 4) * 32] * c1A;
        o[dn][1] = o[dn][1] * c0A + mrg[(dn * 4 + 1) * 32] * c1A;
        o[dn][2] = o[dn][2] * c0B + mrg[(dn * 4 + 2) * 32] * c1B;
        o[dn][3] = o[dn][3] * c0B + mrg[(dn * 4 + 3) * 32] * c1B;
      }
    }
  }
  if (half != 0) return;
  const float invA = lA > 0.f ? 1.f / lA : 0.f;
  const float invB = lB > 0.f ? 1.f / lB : 0.f;
  __nv_bfloat16* oA = out + (((size_t)b * Tq + tA) * H + h) * DH + 2 * tq;
  __nv_bfloat16* oB = out + (((size_t)b * Tq + tB) * H + h) * DH + 2 * tq;
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) {
    if (okA)
      *reinterpret_cast<unsigned*>(oA + dn * 8) =
          pack_bf16(o[dn][0] * invA, o[dn][1] * invA);
    if (okB)
      *reinterpret_cast<unsigned*>(oB + dn * 8) =
          pack_bf16(o[dn][2] * invB, o[dn][3] * invB);
  }
}

// ---------------------------------------------------------------------------
// flash_attend, f32, T * rep > 8: full f32 on the CUDA cores (the whole-path
// checks hold f32 attention to summation order; TF32 or bf16 products would
// be a fault there). Grid (ceil(T/kBT), H, B). A block owns kBT query rows
// of one head (each output row has exactly one owner) and walks the live key
// range in tiles of kBS keys staged in shared memory. In the score phase lane
// j owns key j of the tile; in the P.V phase lane j owns head dims
// [jN, jN + N), N = DH / 32. Each warp carries the online-softmax state of 4
// query rows.
// ---------------------------------------------------------------------------
constexpr int kBT = 16;
constexpr int kBS = 32;
constexpr int kAttWarps = 4;
constexpr int kRows = kBT / kAttWarps;

template <int DH>
__global__ void __launch_bounds__(kAttWarps * 32) flash_attend_f32_kernel(
    const float* __restrict__ q,         // [B, T, H, Dh]
    const float* __restrict__ k,         // [B, S, Hkv, Dh]
    const float* __restrict__ v,         // [B, S, Hkv, Dh]
    const int32_t* __restrict__ qpos,    // [B, T]
    const float* __restrict__ bias,      // strided [B|1, H|1, T|1, S] or null
    long long bsb, long long bsh, long long bst,
    const uint8_t* __restrict__ mask,    // [B, S] or null
    float* __restrict__ out,             // [B, T, H, Dh]
    int Tq, int H, int Hkv, int S, int kv_len, int causal, float scale,
    float softcap) {
  constexpr int kLD = DH / 32;  // head dims of the values a lane owns
  __shared__ float q_s[kBT][DH];
  __shared__ float k_s[kBS][DH + 1];  // +1: lane j reads row j conflict-free
  __shared__ __align__(16) float v_s[kBS][DH];

  const int t0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qstride = (size_t)H * DH;
  const size_t kstride = (size_t)Hkv * DH;

  for (int i = tid; i < kBT * (DH / 4); i += blockDim.x) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t0 + r < Tq)
      mit::load4(q + ((size_t)b * Tq + t0 + r) * qstride + (size_t)h * DH + c,
                 f);
#pragma unroll
    for (int e = 0; e < 4; ++e) q_s[r][c + e] = f[e];
  }

  // live keys: below kv_len and, when causal, at most the block's last
  // query position (tiles wholly in the future are never read)
  int kv_end = min(kv_len, S);
  int pos[kRows];
  bool row_ok[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int t = t0 + warp * kRows + rr;
    row_ok[rr] = t < Tq;
    pos[rr] = row_ok[rr] ? qpos[(size_t)b * Tq + t] : -1;
  }
  if (causal) {
    int mx = -1;
    for (int r = 0; r < kBT && t0 + r < Tq; ++r)
      mx = max(mx, qpos[(size_t)b * Tq + t0 + r]);
    kv_end = min(kv_end, mx + 1);
  }

  float m[kRows], l[kRows], acc[kRows][kLD];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = mit::kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kLD; ++i) acc[rr][i] = 0.f;
  }

  for (int s0 = 0; s0 < kv_end; s0 += kBS) {
    __syncthreads();  // the previous tile is consumed; q_s is staged
    for (int i = tid; i < kBS * (DH / 4); i += blockDim.x) {
      const int j = i / (DH / 4), c = (i % (DH / 4)) * 4;
      float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (s0 + j < kv_end) {  // rows past the live range stay zero
        const size_t off =
            ((size_t)b * S + s0 + j) * kstride + (size_t)hk * DH + c;
        mit::load4(k + off, kf);
        mit::load4(v + off, vf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) k_s[j][c + e] = kf[e];
      *reinterpret_cast<float4*>(&v_s[j][c]) =
          make_float4(vf[0], vf[1], vf[2], vf[3]);
    }
    __syncthreads();

    const int key = s0 + lane;
    bool kvalid = key < kv_end;
    if (kvalid && mask) kvalid = mask[(size_t)b * S + key] != 0;

    float sc[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) sc[rr] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        sc[rr] = fmaf(q_s[warp * kRows + rr][d], kd, sc[rr]);
    }

#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int t = t0 + warp * kRows + rr;
      float x = sc[rr] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      const bool valid = kvalid && row_ok[rr] && (!causal || key <= pos[rr]);
      if (bias != nullptr && valid)
        x += bias[b * bsb + h * bsh + t * bst + key];
      x = valid ? x : mit::kNeg;
      const float mn = fmaxf(m[rr], mit::warp_max(x));
      const float alpha = expf(m[rr] - mn);
      const float p = valid ? expf(x - mn) : 0.f;
      l[rr] = l[rr] * alpha + mit::warp_sum(p);
#pragma unroll
      for (int i = 0; i < kLD; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kBS; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        float vv[kLD];
        load_lane<kLD>(&v_s[j][lane * kLD], vv);
#pragma unroll
        for (int i = 0; i < kLD; ++i) acc[rr][i] = fmaf(pj, vv[i], acc[rr][i]);
      }
      m[rr] = mn;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (!row_ok[rr]) continue;
    const int t = t0 + warp * kRows + rr;
    float* o = out + ((size_t)b * Tq + t) * qstride + (size_t)h * DH + lane * kLD;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    float r[kLD];
#pragma unroll
    for (int i = 0; i < kLD; ++i) r[i] = acc[rr][i] * inv;
    store_lane<kLD>(o, r);
  }
}

template <int DH>
int launch_attend_bf16(const void* q, const void* k, const void* v,
                       const void* qpos, const void* bias, long long bsb,
                       long long bsh, long long bst, const void* mask,
                       void* out, int B, int Tq, int H, int Hkv, int S,
                       int kv_len, int causal, float scale, float softcap,
                       cudaStream_t stream) {
  // one warp per unit where a single 64-key tile holds every live key
  const int halves = min(kv_len, S) > kMmaTile ? 2 : 1;
  auto kern = halves == 2 ? flash_attend_kernel<2, DH> : flash_attend_kernel<1, DH>;
  const int smem = halves == 2 ? mma_smem_bytes<2, DH>() : mma_smem_bytes<1, DH>();
  static std::atomic<unsigned long long> sized[2];  // per instance, a bit per device
  const int err = mit::smem_once(reinterpret_cast<const void*>(kern), smem, sized[halves - 1]);
  if (err != 0) return err;
  const int units = ((Tq + 15) / 16) * (H / Hkv);
  const dim3 grid((units + kMmaUnits - 1) / kMmaUnits, Hkv, B);
  kern<<<grid, halves * kMmaUnits * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const float*>(bias), bsb, bsh, bst,
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out), Tq,
      H, Hkv, S, kv_len, causal, scale, softcap);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_attend_f32(const void* q, const void* k, const void* v,
                      const void* qpos, const void* bias, long long bsb,
                      long long bsh, long long bst, const void* mask,
                      void* out, int B, int Tq, int H, int Hkv, int S,
                      int kv_len, int causal, float scale, float softcap,
                      cudaStream_t stream) {
  const dim3 grid((Tq + kBT - 1) / kBT, H, B);
  flash_attend_f32_kernel<DH><<<grid, kAttWarps * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const float*>(bias), bsb, bsh, bst,
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), Tq, H, Hkv,
      S, kv_len, causal, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5, absorbed-MLA decode: replaces moe_infinity_tpu/ops/flash_attention.py
// _mla_decode_kernel / mla_flash_decode.
//   score[h, s] = (q_lat[h] . c[s] + q_pe[h] . k_pe[s]) * scale
//   out[h]      = sum_s softmax(score)[h, s] * c[s]
// The values are the latent itself and one key stream serves every head.
// q, scores, p and the sums are f32 whatever the cache type (p is not rounded
// to the cache type before p.c, as in the TPU kernel); a row with no valid
// key gives 0; no key at or past row_len = min(kv_len, qpos + 1, S) is read,
// nor one whose mask byte is 0.
//
// What bounds it on the H100. A step moves each live key row once (1,152
// bytes in bf16) and does about 2 * H * 1,088 operations on it, so bytes
// bound it at any H up to a few hundred. Long rows (thousands of keys a row)
// are bound by those bytes: 18.9 MB take 5.6 us. Short rows (V2-Lite's
// batcher step: a few hundred keys a row, 0.9 MB) take a third of a
// microsecond of bytes, and what is left is latency: the launch (4.4 us of
// an empty kernel of this grid, back to back), the first tile's arrival, the
// chain of tiles a block walks and the merge of the splits. Measured on the
// card, one block walks a 64-key tile in about 3 us, the parts adding up:
// the tile's copies 1.1 (a block fills its shared memory at some 25 GB/s),
// the value products 0.7, the score products 0.6, the rest 0.7. So a split
// is one tile where the row allows, and long rows spread over every SM.
//
// The design, against PR 3's body (which launched a second kernel for the
// merge, took partials allocated on every call, staged 16-key tiles and all
// 16 x 576 queries as f32 with synchronous loads per block, and ran both
// products as dependent fmaf chains on the CUDA cores):
// - One launch. Grid (split, 16-head group, b) in clusters of CL = 1, 2, 4
//   or 8 splits; a split owns whole 32-key steps of the plan (the wrapper
//   plans them from integers). Each block leaves its (m, l) and unnormalised
//   sum in its own shared memory; the cluster merges them in split order over
//   distributed shared memory, each block a slice of the 512 columns, and
//   writes the result. Only a row of more than one cluster (long rows) goes
//   through scratch: each cluster writes its combined slices, and the last
//   cluster to finish a slice (a ticket per slice, set back to 0) merges the
//   clusters' slices in order. (A merge in global memory by the last split
//   cost 7-11 us at V2-Lite's rows.)
// - Key tiles of 64 [c | k_pe] rows come by 16-byte cp.async in bf16 into
//   rows padded to 1,168 bytes (ldmatrix's 8 rows meet in 8 bank groups);
//   the next tile is in flight while this one is consumed, and each thread
//   reads its key's mask byte one tile ahead. A key that is not valid is
//   zero-filled and never read.
// - Both products run on the tensor cores (mma.sync m16n8k16; 16 heads are
//   one m16 tile, zero past H), with f32 precision kept: each f32 operand
//   (q, made once per block; p, per tile) is split into bf16 halves hi =
//   bf16(x) and lo = bf16(x - hi), about 16 significant bits, and each
//   product is two mma on the same B fragment. Scores: warp = (a quarter of
//   the 576-long product, 32 keys); its quarter of q stays in registers as
//   A fragments for the whole block (re-reading q from shared memory every
//   tile cost a third of the tile), the quarters meet in shared memory.
//   Softmax: warp w takes keys 8w..8w+7 of every head, the row maxima meet
//   in shared memory, and p goes there as bf16 halves (three block barriers
//   a tile). Values: warp w owns 64 of the 512 columns. mma.sync rounds its
//   f32 accumulation short, so a tile's product goes into fresh fragments
//   and is added as acc = acc * alpha + tile in ordinary f32.
// - Tried and dropped (the card's times are in PERF.md): 16 warps a block,
//   32-key tiles in 3 or 4 stages, and two 16-head tiles a block (at H = 128
//   one key tile read for 32 heads): each was slower.
// f32 caches (the whole-path checks at f32) keep the CUDA-core arithmetic of
// PR 3 (16 keys by 16 heads a step, f32 staging) in mla_decode_f32_kernel,
// and go through the same launch, plan and merge.
// ---------------------------------------------------------------------------
constexpr int kMlaR = 512;       // latent width (the value width)
constexpr int kMlaP = 64;        // rope key width
constexpr int kMlaW = kMlaR + kMlaP;
constexpr int kMlaHeads = 16;    // heads of an m16 tile
constexpr int kMlaTile = 32;     // keys per step of the plan: splits are whole steps
constexpr int kMlaThreads = 256;
constexpr int kMlaRowBytes = kMlaW * 2 + 16;  // a bf16 row of 1,152 bytes, padded
static_assert(kMlaHeads * (kMlaW / 4) % kMlaThreads == 0, "whole q loads");
constexpr int kMlaStRow = kMlaR + 8;  // floats: a row of a block's state
constexpr int kMlaMaxCluster = 8;     // blocks of a cluster (the portable most)

struct MlaArgs {
  const float* q_lat;      // [B, H, R]
  const float* q_pe;       // [B, H, P]
  const void* c;           // [B, S, R]
  const void* kpe;         // [B, S, P]
  const int32_t* qpos;     // [B]
  const uint8_t* mask;     // [B, S] or null
  float* part_acc;         // [B, NS / CL, H, R] when NS > CL
  float* part_ml;          // [B, NS / CL, CL, H, 2]
  int* tickets;            // [B, HG, CL], zero between launches, when NS > CL
  float* out;              // [B, H, R]
  int H, S, kv_len, kc, NS, HG, CL;
  float scale;
};

constexpr int kMlaKeys = 64;     // keys per tile of the bf16 body
constexpr int kMlaKParts = 4;    // parts of the 576-long score product
constexpr int kMlaKSteps = kMlaW / 16 / kMlaKParts;  // k-steps of a part: 9
constexpr int kMlaScRow = kMlaKeys + 8;    // floats: float2 rows conflict-free
constexpr int kMlaPRow = (kMlaKeys + 8) * 2;  // bytes: a bf16 row of p, padded
constexpr int kMlaSmem = 2 * kMlaKeys * kMlaRowBytes     // key stages
                         + 2 * kMlaHeads * kMlaRowBytes  // q as hi and lo
                         + kMlaKParts * kMlaHeads * kMlaScRow * 4  // scores
                         + 2 * kMlaHeads * kMlaPRow;     // p as hi and lo

__device__ __forceinline__ int mla_row_len(const int32_t* qpos, int b, int S,
                                           int kv_len) {
  return max(0, min(min(kv_len, S), qpos[b] + 1));
}

// Split 0 is live even for an empty row, so every (b, head group) has a live
// split for the merge to read.
__device__ __forceinline__ int mla_live_splits(const MlaArgs& a, int row_len) {
  return min(a.NS, max(1, (row_len + a.kc - 1) / a.kc));
}

// x and y as bf16 halves: hi = bf16(x), lo = bf16(x - hi) (the difference is
// exact in f32), packed as mma.sync's operand pairs.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = mit::pack_bf16(x - __low2float(h), y - __high2float(h));
}

// The merge. Every block of a cluster of CL splits has its state in shared
// memory: (m, l) per head in `st_ml` and the unnormalised sum in `st_acc`
// [16][kMlaStRow]. Block rank r combines columns [r R / CL, (r + 1) R / CL)
// of every head over the cluster's ranks, in rank (= split) order, reading
// the others' shared memory; a row held by one cluster (NS == CL) writes its
// result there. Otherwise the cluster's combined state of that slice goes to
// scratch, and the last cluster of the row to finish a slice (a ticket per
// slice) combines the clusters' states of the slice in cluster order.
__device__ __forceinline__ void mla_finish(const MlaArgs& a, int b, int hg,
                                           int h0, int nh, int live,
                                           const float* st_acc,
                                           const float2* st_ml) {
  namespace cgs = cooperative_groups;
  cgs::cluster_group cluster = cgs::this_cluster();
  __shared__ float2 ml_s[kMlaMaxCluster][kMlaHeads];  // every rank's (m, l)
  __shared__ int last_s;
  const int CL = a.CL, rank = (int)cluster.block_rank(), tid = threadIdx.x;
  const int W = kMlaR / CL, c0 = rank * W;  // this block's columns
  const int nc = a.NS / CL, ci = blockIdx.x / CL;
  const int live_c = (live + CL - 1) / CL;  // clusters of the row with a live split
  cluster.sync();  // every rank's state is in its shared memory
  const float* peer[kMlaMaxCluster];
#pragma unroll
  for (int r = 0; r < kMlaMaxCluster; ++r)
    peer[r] = cluster.map_shared_rank(st_acc, r < CL ? r : 0);
  for (int i = tid; i < CL * nh; i += kMlaThreads)
    ml_s[i / nh][i % nh] = cluster.map_shared_rank(st_ml, i / nh)[i % nh];
  __syncthreads();
  const size_t cbase = (size_t)b * nc + ci;
  for (int i = tid; i < nh * (W / 4); i += kMlaThreads) {
    const int hh = i / (W / 4), col = c0 + (i % (W / 4)) * 4;
    float4 v[kMlaMaxCluster];
#pragma unroll
    for (int r = 0; r < kMlaMaxCluster; ++r)
      if (r < CL)
        v[r] = *reinterpret_cast<const float4*>(peer[r] + hh * kMlaStRow + col);
    float M = mit::kNeg;
    for (int r = 0; r < CL; ++r) M = fmaxf(M, ml_s[r][hh].x);
    float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kMlaMaxCluster; ++r) {
      if (r >= CL) break;
      const float w = expf(ml_s[r][hh].x - M);
      L += ml_s[r][hh].y * w;
      A[0] = fmaf(v[r].x, w, A[0]);
      A[1] = fmaf(v[r].y, w, A[1]);
      A[2] = fmaf(v[r].z, w, A[2]);
      A[3] = fmaf(v[r].w, w, A[3]);
    }
    if (nc == 1) {
      const float inv = L > 0.f ? 1.f / L : 0.f;
      *reinterpret_cast<float4*>(a.out + ((size_t)b * a.H + h0 + hh) * kMlaR + col) =
          make_float4(A[0] * inv, A[1] * inv, A[2] * inv, A[3] * inv);
    } else if (ci < live_c) {
      *reinterpret_cast<float4*>(a.part_acc + (cbase * a.H + h0 + hh) * kMlaR + col) =
          make_float4(A[0], A[1], A[2], A[3]);
      if (col == c0)
        *reinterpret_cast<float2*>(
            a.part_ml + ((cbase * CL + rank) * a.H + h0 + hh) * 2) = make_float2(M, L);
    }
  }
  cluster.sync();  // the other ranks have read this block's state
  if (nc == 1 || ci >= live_c) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = a.tickets + ((size_t)b * a.HG + hg) * CL + rank;
    last_s = atomicAdd(ticket, 1) == live_c - 1;
    if (last_s) *ticket = 0;  // every other cluster has drawn: ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int i = tid; i < nh * (W / 4); i += kMlaThreads) {
    const int h = h0 + i / (W / 4), col = c0 + (i % (W / 4)) * 4;
    float M = mit::kNeg;
    for (int cc = 0; cc < live_c; ++cc)
      M = fmaxf(M, __ldcg(a.part_ml + ((((size_t)b * nc + cc) * CL + rank) * a.H + h) * 2));
    float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int cc = 0; cc < live_c; ++cc) {
      const size_t cb = (size_t)b * nc + cc;
      const float2 ml =
          __ldcg(reinterpret_cast<const float2*>(a.part_ml + ((cb * CL + rank) * a.H + h) * 2));
      const float4 pa =
          __ldcg(reinterpret_cast<const float4*>(a.part_acc + (cb * a.H + h) * kMlaR + col));
      const float w = expf(ml.x - M);
      L += ml.y * w;
      A[0] = fmaf(pa.x, w, A[0]);
      A[1] = fmaf(pa.y, w, A[1]);
      A[2] = fmaf(pa.z, w, A[2]);
      A[3] = fmaf(pa.w, w, A[3]);
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    *reinterpret_cast<float4*>(a.out + ((size_t)b * a.H + h) * kMlaR + col) =
        make_float4(A[0] * inv, A[1] * inv, A[2] * inv, A[3] * inv);
  }
}

__global__ void __launch_bounds__(kMlaThreads, 1)
    mla_decode_kernel(const MlaArgs a) {
  extern __shared__ __align__(16) unsigned char mla_smem[];
  unsigned char* kbuf = mla_smem;  // [2][64][1168 B]: key stages
  unsigned char* qbuf = kbuf + 2 * kMlaKeys * kMlaRowBytes;  // [hi, lo][16][1168 B]
  float* sc_s = reinterpret_cast<float*>(
      qbuf + 2 * kMlaHeads * kMlaRowBytes);  // [K part][16][72]: scores
  unsigned char* p_s = reinterpret_cast<unsigned char*>(
      sc_s + kMlaKParts * kMlaHeads * kMlaScRow);  // [hi, lo][16][72] bf16: p
  __shared__ int valid_s[2][kMlaKeys];
  __shared__ __align__(16) float rmax_s[kMlaHeads][8];  // [row][warp]: tile maxima

  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int h0 = hg * kMlaHeads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // the fragment's row and column pair
  const int row_len = mla_row_len(a.qpos, b, a.S, a.kv_len);
  const int k_begin = split * a.kc;  // a split past the live keys owns none,
  const int k_end = min(k_begin + a.kc, row_len);  // but joins its cluster's merge
  const int ntiles = max(0, (k_end - k_begin + kMlaKeys - 1) / kMlaKeys);
  const int live = mla_live_splits(a, row_len);
  const __nv_bfloat16* cg =
      static_cast<const __nv_bfloat16*>(a.c) + (size_t)b * a.S * kMlaR;
  const __nv_bfloat16* pg =
      static_cast<const __nv_bfloat16*>(a.kpe) + (size_t)b * a.S * kMlaP;

  // q's loads first: they are in flight while the first mask bytes come
  constexpr int kQ = kMlaHeads * (kMlaW / 4) / kMlaThreads;
  float4 qv[kQ];
#pragma unroll
  for (int n = 0; n < kQ; ++n) {
    const int i = tid + n * kMlaThreads;
    const int h = h0 + i / (kMlaW / 4), col = (i % (kMlaW / 4)) * 4;
    const size_t row = (size_t)b * a.H + h;
    qv[n] = h >= a.H || ntiles == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
            : col < kMlaR
                ? *reinterpret_cast<const float4*>(a.q_lat + row * kMlaR + col)
                : *reinterpret_cast<const float4*>(a.q_pe + row * kMlaP + col - kMlaR);
  }

  // Loads: 4 neighbouring threads copy one key of a tile, thread chunks
  // lch + 4 j of the key's 72 16-byte chunks (the latent's 64, then the rope
  // key's 8), so that they read 64 contiguous bytes. fetch(ti) reads the
  // key's mask byte of tile ti into a register, one tile before
  // load_tile(ti, buf) starts the copies, which zero-fill a key that is not
  // to be read.
  constexpr int kLd = kMlaThreads / kMlaKeys;
  const int lkey = tid / kLd, lch = tid % kLd;
  const __nv_bfloat16* csrc = cg + (size_t)(k_begin + lkey) * kMlaR + lch * 8;
  const __nv_bfloat16* psrc = pg + (size_t)(k_begin + lkey) * kMlaP + lch * 8;
  unsigned char* ldst = kbuf + lkey * kMlaRowBytes + lch * 16;
  unsigned char mk;  // 0: the key is not to be read
  auto fetch = [&](int ti) {
    const int s = k_begin + ti * kMlaKeys + lkey;
    const bool in = s < k_end;
    mk = (in && a.mask != nullptr) ? a.mask[(size_t)b * a.S + s] : (unsigned char)in;
  };
  auto load_tile = [&](int ti, int buf) {
    const bool ok = mk != 0;
    const size_t t0 = (size_t)ti * kMlaKeys;
    unsigned char* dst = ldst + buf * kMlaKeys * kMlaRowBytes;
#pragma unroll
    for (int j = 0; j < kMlaR / 8 / kLd; ++j)
      mit::cp_async16(dst + j * kLd * 16, ok ? csrc + t0 * kMlaR + j * kLd * 8 : cg,
                      ok ? 16 : 0);
#pragma unroll
    for (int j = 0; j < kMlaP / 8 / kLd; ++j)
      mit::cp_async16(dst + kMlaR * 2 + j * kLd * 16,
                      ok ? psrc + t0 * kMlaP + j * kLd * 8 : cg, ok ? 16 : 0);
    if (lch == 0) valid_s[buf][lkey] = ok;
  };

  fetch(0);
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();
  fetch(1);

  // q as bf16 halves in shared memory, zero for a head past H; then each warp
  // keeps the A fragments of its part of the product in registers
#pragma unroll
  for (int n = 0; n < kQ; ++n) {
    const int i = tid + n * kMlaThreads;
    const int hh = i / (kMlaW / 4), col = (i % (kMlaW / 4)) * 4;
    uint2 hi, lo;
    split_bf16(qv[n].x, qv[n].y, hi.x, lo.x);
    split_bf16(qv[n].z, qv[n].w, hi.y, lo.y);
    unsigned char* dst = qbuf + hh * kMlaRowBytes + col * 2;
    *reinterpret_cast<uint2*>(dst) = hi;
    *reinterpret_cast<uint2*>(dst + kMlaHeads * kMlaRowBytes) = lo;
  }
  __syncthreads();
  // scores: warp = (K part kp of 9 k-steps, key half kh of 4 8-key groups)
  const int kp = warp & 3, kh = warp >> 2;
  unsigned qh[kMlaKSteps][4], ql[kMlaKSteps][4];
  {
    const unsigned char* arow =
        qbuf + (lane & 15) * kMlaRowBytes + (lane >> 4) * 16 + kp * kMlaKSteps * 32;
#pragma unroll
    for (int ks = 0; ks < kMlaKSteps; ++ks) {
      mit::ldmatrix_x4(qh[ks], arow + ks * 32);
      mit::ldmatrix_x4(ql[ks], arow + kMlaHeads * kMlaRowBytes + ks * 32);
    }
  }

  // the running maxima of rows g and g + 8 (identical in every warp) and the
  // warp's 64 columns of their sums; the running maximum of row srow and
  // this lane's share of its l (softmax: warp w takes keys [8 w, 8 w + 8),
  // lane (row lane % 16, keys 4 (lane / 16) ..))
  float m[2] = {mit::kNeg, mit::kNeg}, ms = mit::kNeg, ls = 0.f, acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int srow = lane & 15, sk0 = warp * 8 + (lane >> 4) * 4;
  const unsigned char* prow = p_s + (lane & 15) * kMlaPRow + (lane >> 4) * 16;

  for (int ti = 0; ti < ntiles; ++ti) {
    cp_async_wait<0>();  // tile ti has landed
    __syncthreads();     // ... for every thread; tile ti - 1 is consumed
    const int buf = ti & 1;
    if (ti + 1 < ntiles) load_tile(ti + 1, buf ^ 1);
    cp_async_commit();
    fetch(ti + 2);
    const unsigned char* kt = kbuf + buf * kMlaKeys * kMlaRowBytes;

    // scores: this warp's 32 keys over its 144 columns, hi and lo halves of q
    // in separate chains
    {
      float shi[4][4], slo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) shi[j][e] = slo[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* brow = kt + ((kh * 4 + j) * 8 + (lane & 7)) * kMlaRowBytes +
                                    (lane >> 3) * 16 + kp * kMlaKSteps * 32;
#pragma unroll
        for (int ks = 0; ks < kMlaKSteps; ks += 2) {
          unsigned kf[4];  // B fragments of k-steps ks and ks + 1 (unused past the part)
          mit::ldmatrix_x4(kf, brow + ks * 32);
          mit::mma_bf16(shi[j], qh[ks], kf[0], kf[1]);
          mit::mma_bf16(slo[j], ql[ks], kf[0], kf[1]);
          if (ks + 1 < kMlaKSteps) {
            mit::mma_bf16(shi[j], qh[ks + 1], kf[2], kf[3]);
            mit::mma_bf16(slo[j], ql[ks + 1], kf[2], kf[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* sp = sc_s + (kp * kMlaHeads + g) * kMlaScRow + (kh * 4 + j) * 8 + 2 * tq;
        *reinterpret_cast<float2*>(sp) =
            make_float2(shi[j][0] + slo[j][0], shi[j][1] + slo[j][1]);
        *reinterpret_cast<float2*>(sp + 8 * kMlaScRow) =
            make_float2(shi[j][2] + slo[j][2], shi[j][3] + slo[j][3]);
      }
    }
    __syncthreads();  // every part of every key's scores is in sc_s

    // softmax over this warp's slice; the tile's row maxima meet in rmax_s,
    // and p goes to p_s as bf16 halves
    float x[4];
    {
      float mx = mit::kNeg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = sk0 + i;
        float v = 0.f;
#pragma unroll
        for (int p = 0; p < kMlaKParts; ++p) v += sc_s[(p * kMlaHeads + srow) * kMlaScRow + k];
        x[i] = valid_s[buf][k] ? v * a.scale : mit::kNeg;
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
      if (lane < 16) rmax_s[srow][warp] = mx;
    }
    __syncthreads();  // the tile's maxima of every row are in rmax_s
    float alpha[2];
    {
      float mn[3];  // the new maxima of rows g and g + 8 (for the sums) and srow (for p)
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int row = r == 2 ? srow : g + 8 * r;
        const float4 u = *reinterpret_cast<const float4*>(&rmax_s[row][0]);
        const float4 w = *reinterpret_cast<const float4*>(&rmax_s[row][4]);
        mn[r] = fmaxf(fmaxf(fmaxf(u.x, u.y), fmaxf(u.z, u.w)),
                      fmaxf(fmaxf(w.x, w.y), fmaxf(w.z, w.w)));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mn[r] = fmaxf(m[r], mn[r]);
        alpha[r] = __expf(m[r] - mn[r]);
        m[r] = mn[r];
      }
      mn[2] = fmaxf(ms, mn[2]);
      float sum = 0.f, pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = valid_s[buf][sk0 + i] ? __expf(x[i] - mn[2]) : 0.f;
        sum += pv[i];
      }
      ls = ls * __expf(ms - mn[2]) + sum;
      ms = mn[2];
      unsigned char* ph = p_s + srow * kMlaPRow + sk0 * 2;
      uint2 hi, lo;
      split_bf16(pv[0], pv[1], hi.x, lo.x);
      split_bf16(pv[2], pv[3], hi.y, lo.y);
      *reinterpret_cast<uint2*>(ph) = hi;
      *reinterpret_cast<uint2*>(ph + kMlaHeads * kMlaPRow) = lo;
    }
    __syncthreads();  // p is in p_s

    // values: this warp's 64 columns; each tile's product in fresh fragments
    {
      const unsigned char* vrow =
          kt + (lane & 15) * kMlaRowBytes + (lane >> 4) * 16 + warp * 64 * 2;
      float f[4][2][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[np][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMlaKeys / 16; ++kk) {
        unsigned ph[4], pl[4];  // p's A fragments of keys 16 kk .. 16 kk + 15
        mit::ldmatrix_x4(ph, prow + kk * 32);
        mit::ldmatrix_x4(pl, prow + kMlaHeads * kMlaPRow + kk * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned vf[4];  // B fragments of column groups 2 np and 2 np + 1
          mit::ldmatrix_x4_trans(vf, vrow + kk * 16 * kMlaRowBytes + np * 32);
          mit::mma_bf16(f[np][0], ph, vf[0], vf[1]);
          mit::mma_bf16(f[np][0], pl, vf[0], vf[1]);
          mit::mma_bf16(f[np][1], ph, vf[2], vf[3]);
          mit::mma_bf16(f[np][1], pl, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[2 * np + j][e] = acc[2 * np + j][e] * alpha[e >> 1] + f[np][j][e];
    }
  }

  // this block's state into shared memory (the key stages are free), then
  // the merge
  __shared__ float2 st_ml[kMlaHeads];
  __shared__ float lsum_s[kMlaHeads][16];  // [row][warp, half]: shares of l
  float* st_acc = reinterpret_cast<float*>(kbuf);  // [16][kMlaStRow]
  __syncthreads();
  lsum_s[srow][warp * 2 + (lane >> 4)] = ls;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(st_acc + (g + 8 * r) * kMlaStRow + warp * 64 + n * 8 +
                                 2 * tq) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  __syncthreads();
  if (tid < kMlaHeads) {  // row tid: its m is this lane's ms, l in a fixed order
    float lr = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) lr += lsum_s[tid][i];
    st_ml[tid] = make_float2(ms, lr);
  }
  mla_finish(a, b, hg, h0, min(kMlaHeads, a.H - h0), live, st_acc, st_ml);
}

// f32 caches: PR 3's CUDA-core body, one head tile a block. In a block of 256
// threads: score phase, thread (key s = t % 16, head h = t / 16) takes the
// 576-long dot product and the 16 lanes of a head reduce max and sum by
// shuffles; value phase, thread (4 latent columns, 8 heads) accumulates
// p[s, h] * c[s, cols] in registers.
constexpr int kMlaF32Keys = 16;  // keys per step (a tile of the plan is two)
constexpr int kMlaKeyStride = kMlaW + 4;  // rows 4 banks apart
constexpr int kMlaF32Smem =
    (kMlaHeads * kMlaW + kMlaF32Keys * kMlaKeyStride + kMlaF32Keys * kMlaHeads +
     kMlaHeads + kMlaF32Keys) * (int)sizeof(float);

__global__ void __launch_bounds__(kMlaThreads)
    mla_decode_f32_kernel(const MlaArgs a) {
  extern __shared__ __align__(16) float mla_f32_smem[];
  float* q_s = mla_f32_smem;                           // [heads][W]
  float* key_s = q_s + kMlaHeads * kMlaW;              // [keys][W + 4]
  float* p_s = key_s + kMlaF32Keys * kMlaKeyStride;    // [keys][heads]
  float* alpha_s = p_s + kMlaF32Keys * kMlaHeads;      // [heads]
  int* valid_s = reinterpret_cast<int*>(alpha_s + kMlaHeads);  // [keys]
  const float* c = static_cast<const float*>(a.c);
  const float* kpe = static_cast<const float*>(a.kpe);

  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int h0 = hg * kMlaHeads;
  const int row_len = mla_row_len(a.qpos, b, a.S, a.kv_len);
  const int k_begin = split * a.kc;  // a split past the live keys owns none,
  const int k_end = min(k_begin + a.kc, row_len);  // but joins its cluster's merge
  const int live = mla_live_splits(a, row_len);
  const int tid = threadIdx.x;

  // the block's queries: [q_lat | q_pe] per head, zero for a head past H
  for (int i = tid; i < (k_begin < k_end ? kMlaHeads * (kMlaW / 4) : 0); i += kMlaThreads) {
    const int h = i / (kMlaW / 4), g = i % (kMlaW / 4);
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (h0 + h < a.H) {
      const size_t row = (size_t)b * a.H + h0 + h;
      if (g < kMlaR / 4)
        mit::load4(a.q_lat + row * kMlaR + g * 4, f);
      else
        mit::load4(a.q_pe + row * kMlaP + (g - kMlaR / 4) * 4, f);
    }
    *reinterpret_cast<float4*>(q_s + h * kMlaW + g * 4) =
        make_float4(f[0], f[1], f[2], f[3]);
  }

  const int s_own = tid & (kMlaF32Keys - 1), h_own = tid / kMlaF32Keys;
  const int cg = tid & 127, hg8 = tid >> 7;
  float m_run = mit::kNeg, l_run = 0.f;
  float acc[8][4];
#pragma unroll
  for (int hh = 0; hh < 8; ++hh)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[hh][j] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += kMlaF32Keys) {
    __syncthreads();  // the previous step is consumed; q_s is staged
    if (tid < kMlaF32Keys) {
      const int ks = t0 + tid;
      valid_s[tid] =
          ks < k_end && (a.mask == nullptr || a.mask[(size_t)b * a.S + ks] != 0);
    }
    __syncthreads();
    for (int i = tid; i < kMlaF32Keys * (kMlaW / 4); i += kMlaThreads) {
      const int s = i / (kMlaW / 4), g = i % (kMlaW / 4);
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (valid_s[s]) {
        const size_t row = (size_t)b * a.S + t0 + s;
        if (g < kMlaR / 4)
          mit::load4(c + row * kMlaR + g * 4, f);
        else
          mit::load4(kpe + row * kMlaP + (g - kMlaR / 4) * 4, f);
      }
      *reinterpret_cast<float4*>(key_s + s * kMlaKeyStride + g * 4) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
    __syncthreads();

    const float4* kr =
        reinterpret_cast<const float4*>(key_s + s_own * kMlaKeyStride);
    const float4* qr = reinterpret_cast<const float4*>(q_s + h_own * kMlaW);
    float sc = 0.f;
#pragma unroll 8
    for (int i = 0; i < kMlaW / 4; ++i) {
      const float4 kv4 = kr[i], qv4 = qr[i];
      sc = fmaf(kv4.x, qv4.x, sc);
      sc = fmaf(kv4.y, qv4.y, sc);
      sc = fmaf(kv4.z, qv4.z, sc);
      sc = fmaf(kv4.w, qv4.w, sc);
    }
    const bool ok = valid_s[s_own] != 0;
    sc = ok ? sc * a.scale : mit::kNeg;
    float mx = sc;
#pragma unroll
    for (int o = kMlaF32Keys / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    const float p = ok ? expf(sc - m_new) : 0.f;
    float ps = p;
#pragma unroll
    for (int o = kMlaF32Keys / 2; o > 0; o >>= 1)
      ps += __shfl_xor_sync(kFull, ps, o);
    l_run = l_run * alpha + ps;
    m_run = m_new;
    p_s[s_own * kMlaHeads + h_own] = p;
    if (s_own == 0) alpha_s[h_own] = alpha;
    __syncthreads();

#pragma unroll
    for (int hh = 0; hh < 8; ++hh) {
      const float al = alpha_s[hg8 * 8 + hh];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hh][j] *= al;
    }
#pragma unroll 4
    for (int s = 0; s < kMlaF32Keys; ++s) {
      const float4 cv =
          *reinterpret_cast<const float4*>(key_s + s * kMlaKeyStride + cg * 4);
      const float4 pa =
          *reinterpret_cast<const float4*>(p_s + s * kMlaHeads + hg8 * 8);
      const float4 pb =
          *reinterpret_cast<const float4*>(p_s + s * kMlaHeads + hg8 * 8 + 4);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int hh = 0; hh < 8; ++hh) {
        acc[hh][0] = fmaf(pv[hh], cv.x, acc[hh][0]);
        acc[hh][1] = fmaf(pv[hh], cv.y, acc[hh][1]);
        acc[hh][2] = fmaf(pv[hh], cv.z, acc[hh][2]);
        acc[hh][3] = fmaf(pv[hh], cv.w, acc[hh][3]);
      }
    }
  }

  // this block's state into shared memory (q and the keys are no longer
  // needed), then the merge
  __shared__ float2 st_ml[kMlaHeads];
  float* st_acc = mla_f32_smem;  // [16][kMlaStRow]
  __syncthreads();
  if (s_own == 0) st_ml[h_own] = make_float2(m_run, l_run);
#pragma unroll
  for (int hh = 0; hh < 8; ++hh)
    *reinterpret_cast<float4*>(st_acc + (hg8 * 8 + hh) * kMlaStRow + cg * 4) =
        make_float4(acc[hh][0], acc[hh][1], acc[hh][2], acc[hh][3]);
  mla_finish(a, b, hg, h0, min(kMlaHeads, a.H - h0), live, st_acc, st_ml);
}

// A launch in clusters of a.CL blocks along the splits.
template <typename Kern>
int launch_mla(Kern kern, int smem, const MlaArgs& a, int B, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.NS, a.HG, B);
  cfg.blockDim = dim3(kMlaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int launch_mla_bf16(const MlaArgs& a, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> sized{0};
  const int err = mit::smem_once(reinterpret_cast<const void*>(mla_decode_kernel),
                            kMlaSmem, sized);
  if (err != 0) return err;
  return launch_mla(mla_decode_kernel, kMlaSmem, a, B, stream);
}

int launch_mla_f32(const MlaArgs& a, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> sized{0};
  const int err = mit::smem_once(reinterpret_cast<const void*>(mla_decode_f32_kernel),
                            kMlaF32Smem, sized);
  if (err != 0) return err;
  return launch_mla(mla_decode_f32_kernel, kMlaF32Smem, a, B, stream);
}

}  // namespace

// The decode body for kind 0 (K1: contiguous cache, qpos [B, 1]), 1 (K4:
// pool, table [B, P], lengths [B], S = P * page) and 2 (K2 with
// Tq * rep <= 8 query rows per kv head: bias, qpos [B, Tq], round_p). kc
// (a multiple of 64) and NS are the wrapper's plan; scratch is used when
// NS > 1: part_acc [B, Hkv, NS, Tq * rep, head_dim] and part_ml [.., 2], f32.
// head_dim is 64 or 128.
extern "C" int mit_decode_rows(
    int kind, const void* q, const void* k, const void* v, void* out,
    const void* qpos, const void* lengths, const void* table,
    const void* mask, const void* bias, long long bsb, long long bsh,
    long long bst, void* part_acc, void* part_ml, void* tickets, int B, int Tq,
    int H,
    int Hkv, int S, int P, int page, int kv_len, int causal, int round_p,
    int kc, int NS, float scale, float softcap, int is_bf16, int head_dim,
    void* stream) {
  if (kind < 0 || kind > 2 || Hkv <= 0 || H % Hkv != 0 || kc <= 0 ||
      kc % kDecTile != 0 || NS <= 0 || NS > 65535 || B > 65535 ||
      Hkv > 65535 || (head_dim != 64 && head_dim != 128) ||
      (NS > 1 && (part_acc == nullptr || part_ml == nullptr ||
                  tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  DecArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.qpos = static_cast<const int32_t*>(qpos);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.table = static_cast<const int32_t*>(table);
  a.mask = static_cast<const uint8_t*>(mask);
  a.bias = static_cast<const float*>(bias);
  a.bsb = bsb;
  a.bsh = bsh;
  a.bst = bst;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<int*>(tickets);
  a.Tq = Tq;
  a.H = H;
  a.Hkv = Hkv;
  a.rep = H / Hkv;
  a.S = S;
  a.P = P;
  a.page = page;
  a.page_shift = -1;  // log2(page) when page is a power of two
  if (page > 0 && (page & (page - 1)) == 0)
    for (int p = page; p > 0; p >>= 1) ++a.page_shift;
  a.kv_len = kv_len;
  a.causal = causal;
  a.round_p = round_p;
  a.kc = kc;
  a.NS = NS;
  a.scale = scale;
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_rows_dh<__nv_bfloat16>(kind, a, B, head_dim, st);
  return launch_rows_dh<float>(kind, a, B, head_dim, st);
}

// K2 with more than 8 query rows per kv head: tensor cores for bf16, the
// CUDA cores for f32.
extern "C" int mit_flash_attend(const void* q, const void* k, const void* v,
                                const void* qpos, const void* bias,
                                long long bsb, long long bsh, long long bst,
                                const void* mask, void* out, int B, int Tq,
                                int H, int Hkv, int S, int kv_len, int causal,
                                float scale, float softcap, int is_bf16,
                                int head_dim, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B > 65535 || Hkv > 65535 || H > 65535 ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && head_dim == 64)
    return launch_attend_bf16<64>(q, k, v, qpos, bias, bsb, bsh, bst, mask, out,
                                  B, Tq, H, Hkv, S, kv_len, causal, scale,
                                  softcap, st);
  if (is_bf16)
    return launch_attend_bf16<128>(q, k, v, qpos, bias, bsb, bsh, bst, mask,
                                   out, B, Tq, H, Hkv, S, kv_len, causal, scale,
                                   softcap, st);
  if (head_dim == 64)
    return launch_attend_f32<64>(q, k, v, qpos, bias, bsb, bsh, bst, mask, out,
                                 B, Tq, H, Hkv, S, kv_len, causal, scale,
                                 softcap, st);
  return launch_attend_f32<128>(q, k, v, qpos, bias, bsb, bsh, bst, mask, out,
                                B, Tq, H, Hkv, S, kv_len, causal, scale, softcap,
                                st);
}

// R and P must be 512 and 64 (every published DeepSeek MLA geometry); kc
// (a multiple of 32) is the keys per split, NS >= ceil(min(kv_len, S) / kc)
// the splits, a multiple of the cluster size CL (1, 2, 4 or 8); a block
// holds 16 heads. Scratch and tickets are used when NS > CL: part_acc
// [B, NS / CL, H, R] and part_ml [B, NS / CL, CL, H, 2] f32, tickets
// [B, ceil(H / 16), CL] int32, zero between launches.
extern "C" int mit_mla_flash_decode(const void* q_lat, const void* q_pe,
                                    const void* c, const void* kpe,
                                    const void* qpos, const void* mask,
                                    void* part_acc, void* part_ml,
                                    void* tickets, void* out, int B, int H,
                                    int S, int R, int P, int kv_len, int kc,
                                    int NS, int CL, float scale,
                                    int is_bf16, void* stream) {
  const int live_max = kv_len < S ? kv_len : S;
  if (R != kMlaR || P != kMlaP || kc <= 0 || kc % kMlaTile != 0 || NS <= 0 ||
      NS > 65535 || (long long)NS * kc < live_max || B > 65535 || H <= 0 ||
      (CL != 1 && CL != 2 && CL != 4 && CL != kMlaMaxCluster) || NS % CL != 0 ||
      (NS > CL && (part_acc == nullptr || part_ml == nullptr ||
                   tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  MlaArgs a;
  a.q_lat = static_cast<const float*>(q_lat);
  a.q_pe = static_cast<const float*>(q_pe);
  a.c = c;
  a.kpe = kpe;
  a.qpos = static_cast<const int32_t*>(qpos);
  a.mask = static_cast<const uint8_t*>(mask);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<int*>(tickets);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.S = S;
  a.kv_len = kv_len;
  a.kc = kc;
  a.NS = NS;
  a.CL = CL;
  a.HG = (H + kMlaHeads - 1) / kMlaHeads;
  a.scale = scale;
  if (a.HG > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_mla_f32(a, B, st);
  return launch_mla_bf16(a, B, st);
}
