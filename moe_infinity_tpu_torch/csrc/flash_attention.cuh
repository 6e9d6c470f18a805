// K1, K2 and K4: hand-written Hopper attention kernels at any head dim from
// 1 to 256 and any GQA ratio rep = H / Hkv. Two translation units compile
// them: flash_attention.cu holds the instances at head dim 64 (Switch's T5
// attention) and 128 (NLLB, Mixtral, OPT-66B), with the dim a compile-time
// constant; flash_attention_pad128.cu holds the zero-padded instances of
// width 128 for every other dim below 128 (OPT-2.7B's 80) and
// flash_attention_pad256.cu those of width 256 for 129 to 256, the true dim
// a runtime argument. The three build at once.
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
// consumed), a lane owns a key for the scores and DH / 32 head dims for the
// values, and the online softmax is updated once per 32 keys, not per key.
// The last split of a row to finish merges them all; a plan of one split
// writes the result itself. flash_attend at T >= 16 is bound by operations
// once the keys are a few hundred (4 * T * S * Dh per head against
// 4 * S * Dh bytes per kv head), so its bf16 kernel runs both products on
// the tensor cores (mma.sync m16n8k16, the 16-row tile that fits a 16-wide
// chunk step). No kernel reads a row at or past the live length (kv_len,
// the causal bound), nor a key whose mask byte is 0.
//
// The padded instances (PAD) read only the true dh columns of a row, so
// their bound is the same bytes: the shared-memory columns at or past dh are
// zeroed once when a block starts and never loaded, q's are zero, a zero
// column adds nothing to q . k, and an output column at or past dh is never
// stored. Rows whose bytes are a multiple of 16 (bf16 dh % 8 == 0, f32
// dh % 4 == 0: OPT-2.7B's 80) keep the 16-byte cp.async loads; other rows
// are copied an element at a time. The score loops stop at the last live
// column. Never a padded copy of the cache.
//
// A block of the decode body holds at most 8 query rows of a kv head; a
// kv head with more (rep 16: 64 query heads over 4) is split over G =
// ceil(rows / 8) blocks along the grid's y axis, each over the same keys.
#pragma once

#include <limits.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

// K1, K2 and K4 take the width DH of their shared-memory rows as a template
// parameter (64, 128 or 256) and PAD: false where the head dim is DH itself,
// true where the true head dim dh <= DH comes at run time. Where a lane owns
// head dims of the values, it owns DH / 32 consecutive ones: 8 at 256, 4 at
// 128, 2 at 64.
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 256;  // the widest instance

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
// N (2, 4 or 8) consecutive elements as float, and back; p aligned to
// min(N, 4) elements
template <int N, typename T>
__device__ __forceinline__ void load_lane(const T* p, float* o) {
  if constexpr (N == 8) {
    mit::load4(p, o);
    mit::load4(p + 4, o + 4);
  } else if constexpr (N == 4) {
    mit::load4(p, o);
  } else {
    load2(p, o);
  }
}
template <int N, typename T>
__device__ __forceinline__ void store_lane(T* p, const float* x) {
  if constexpr (N == 8) {
    mit::store4(p, x);
    mit::store4(p + 4, x + 4);
  } else if constexpr (N == 4) {
    mit::store4(p, x);
  } else {
    store2(p, x);
  }
}

// One element as float, and back (any alignment).
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// The first n (<= N) of N consecutive elements from float: a padded
// instance's output row, whose columns at or past dh are never stored.
template <int N, typename T>
__device__ __forceinline__ void store_part(T* p, const float* x, int n) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) st1(p + i, x[i]);
}
// A 16-byte shared-memory chunk from the first n (<= 16 / sizeof(T))
// elements of src at any alignment, zeros after them: a row whose bytes are
// not a multiple of 16 takes its chunks so.
template <typename T>
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const T* src,
                                           int n) {
  using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned>;
  constexpr int kPer = 16 / (int)sizeof(T);
  const Bits* s = reinterpret_cast<const Bits*>(src);
  Bits* d = reinterpret_cast<Bits*>(dst);
#pragma unroll
  for (int i = 0; i < kPer; ++i) d[i] = i < n ? s[i] : Bits(0);
}
// Zero the 16-byte chunks [c0, c1) of `rows` rows of `row_bytes` each: the
// columns of a padded instance's shared-memory rows that are never loaded.
__device__ __forceinline__ void zero_chunks(unsigned char* base, int rows,
                                            int row_bytes, int c0, int c1) {
  const int dead = c1 - c0;
  if (dead <= 0) return;
  for (int i = threadIdx.x; i < rows * dead; i += blockDim.x)
    *reinterpret_cast<uint4*>(base + (size_t)(i / dead) * row_bytes +
                              (c0 + i % dead) * 16) = make_uint4(0, 0, 0, 0);
}

using mit::cp_async16;
using mit::cp_async_commit;
using mit::cp_async_wait;

// ---------------------------------------------------------------------------
// The decode body: grid (split, Hkv * G, B). A block owns up to MAXR of the
// `Tq * rep` query rows of one kv head of one batch row (row j = t * rep + r
// is query token t, head hk * rep + r; group g of the G takes rows
// [g * MAXR, (g + 1) * MAXR)) over the keys [split * kc, (split + 1) * kc)
// of that batch row, so those cache rows are read once for all its heads
// (G times where a kv head has more than 8 rows). It walks them in tiles of
// kDecTile keys. Warp (row group, slot) owns 1 or 2 query rows and the
// slot's 32 keys of every tile, with its own online-softmax state: in the
// score phase lane j takes the dh-long dot product of key j (rows are padded
// by 16 bytes, so the lanes of a quarter warp read 8 different bank groups),
// then one max, one sum and one rescale per 32 keys, then lane j accumulates
// p * v for head dims [jN, jN + N), N = DH / 32. No block-wide exchange
// happens between the two phases; the block synchronises only on a tile's
// arrival and release. At the end the two slots of a row merge through
// shared memory, and the block either writes the result (a plan of one
// split) or its (m, l) and unnormalised sum to scratch, where the last split
// of the (batch row, kv head, group) to finish (a ticket counter) merges
// them.
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
constexpr int kDecMaxRows = 8;  // query rows a block takes at most

struct DecArgs {
  const void* q;           // [B, Tq, H, dh]
  const void* k;           // [B, S, Hkv, dh], or the pool [NP, page, Hkv, dh]
  const void* v;
  void* out;               // [B, Tq, H, dh]
  const int32_t* qpos;     // [B, Tq], or null (paged: causality is in lengths)
  const int32_t* lengths;  // [B] live keys per row, or null (then kv_len)
  const int32_t* table;    // [B, P] physical page ids, or null (contiguous)
  const uint8_t* mask;     // [B, S] or null
  const float* bias;       // strided [B|1, H|1, Tq|1, S] or null
  long long bsb, bsh, bst;
  float* part_acc;         // [B, Hkv, NS, Tq * rep, DH] when NS > 1
  float* part_ml;          // [B, Hkv, NS, Tq * rep, 2]
  int* tickets;            // [B, Hkv, G], zero between launches, when NS > 1
  int Tq, H, Hkv, rep, S, P, page, page_shift, kv_len, causal, round_p, kc, NS;
  int dh;                  // the true head dim (DH, or less in a padded instance)
  int G;                   // row groups of a kv head: blocks along y per kv head
  float scale, softcap;
};

template <typename T, int DH>
struct DecTile {
  static constexpr int kPer = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  static constexpr int kChunks = DH / kPer;         // chunks of a row
  static constexpr int kRowBytes = DH * (int)sizeof(T) + 16;  // 16 of padding
  // the next tile loads during this one, except for f32 rows of 128 and any
  // rows of 256, whose one buffer of K and V is as large as two of bf16 128
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

template <typename T, int DH, bool PAD>
__device__ __forceinline__ T* dec_out_row(const DecArgs& a, int b, int hk,
                                          int j) {
  const int t = j / a.rep, r = j % a.rep;
  return static_cast<T*>(a.out) +
         (((size_t)b * a.Tq + t) * a.H + (size_t)hk * a.rep + r) *
             (PAD ? a.dh : DH);
}

// Combine the live splits of (b, hk) for rows [j0, j0 + nrows_g) and write
// the result: thread = (query row, 4 head dims), `nthreads` threads. Reads
// past the L1 (other blocks wrote the scratch).
template <typename T, int DH, bool PAD>
__device__ __forceinline__ void dec_merge(const DecArgs& a, int b, int hk,
                                          int j0, int nrows_g, int live,
                                          int nthreads) {
  constexpr int kD4 = DH / 4;
  const int nd4 = PAD ? (a.dh + 3) / 4 : kD4;  // groups holding a live column
  const int nrows = a.Tq * a.rep;
  const size_t base = ((size_t)b * a.Hkv + hk) * a.NS;
  for (int idx = threadIdx.x; idx < nrows_g * nd4; idx += nthreads) {
    const int j = j0 + idx / nd4, d4 = idx % nd4;
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
    T* o = dec_out_row<T, DH, PAD>(a, b, hk, j) + d4 * 4;
    if (PAD)
      store_part<4>(o, A, a.dh - d4 * 4);
    else
      mit::store4(o, A);
  }
}

template <typename T, int MAXR, bool PAGED, int DH, bool PAD>
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

  const int split = blockIdx.x, b = blockIdx.z;
  // only the 8-row instance runs on row groups (G > 1: more than 8 rows)
  constexpr bool kGroups = MAXR == kDecMaxRows;
  const int hk = kGroups ? blockIdx.y / a.G : blockIdx.y;
  const int j0 = kGroups ? blockIdx.y % a.G * MAXR : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp / kDecSlots, slot = warp % kDecSlots;
  const bool computes = rg < SH::kRowGroups;  // the other warps only load
  const int nrows = a.Tq * a.rep;
  const int nrows_g = min(MAXR, nrows - j0);  // this block's rows
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
  const int dh = PAD ? a.dh : DH;
  const size_t srow = (size_t)a.Hkv * dh;
  // chunks holding a live column, and whether they take 16-byte copies
  const int live_ch = PAD ? (dh + TL::kPer - 1) / TL::kPer : TL::kChunks;
  const bool vec = !PAD || dh % TL::kPer == 0;
  if (PAD)  // the columns never loaded, in every buffer of K and V
    zero_chunks(dec_smem, TL::kBufs * 2 * kDecTile, TL::kRowBytes, live_ch,
                TL::kChunks);

  bool row_ok[RPW];
  int pos[RPW];
  float m[RPW], l[RPW], acc[RPW][kLD];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int jl = rg * RPW + rr;
    row_ok[rr] = computes && jl < nrows_g;
    pos[rr] = (a.causal && a.qpos && row_ok[rr])
                  ? a.qpos[(size_t)b * a.Tq + (j0 + jl) / a.rep]
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
  const bool lc_live = lc < live_ch;  // false only in a padded instance
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
      if (!lc_live) continue;
      if (ok) {
        const size_t r =
            !PAGED ? (size_t)b * a.S + s
                   : (size_t)pg[n] * a.page +
                         (a.page_shift >= 0 ? s & (a.page - 1) : s % a.page);
        const size_t e = r * srow + (size_t)hk * dh + lc * TL::kPer;
        if (vec) {
          cp_async16(kd, kg + e);
          cp_async16(vd, vg + e);
        } else {
          const int n_el = min(TL::kPer, dh - lc * TL::kPer);
          copy_chunk(kd, kg + e, n_el);
          copy_chunk(vd, vg + e, n_el);
        }
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

  // the block's query rows as f32, zero for a row past nrows_g and a column
  // past dh (after the first tile's loads are on their way, so that the two
  // overlap)
  if (PAD) {
    for (int i = tid; i < MAXR * DH; i += NT) {
      const int j = i / DH, c = i % DH;
      float f = 0.f;
      if (j < nrows_g && c < dh) {
        const int t = (j0 + j) / a.rep, r = (j0 + j) % a.rep;
        f = ld1(static_cast<const T*>(a.q) +
                (((size_t)b * a.Tq + t) * a.H + (size_t)hk * a.rep + r) * dh + c);
      }
      q_s[j][c] = f;
    }
  } else {
    for (int i = tid; i < MAXR * (DH / 4); i += NT) {
      const int j = i / (DH / 4), c = (i % (DH / 4)) * 4;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nrows_g) {
        const int t = (j0 + j) / a.rep, r = (j0 + j) % a.rep;
        mit::load4(static_cast<const T*>(a.q) +
                       (((size_t)b * a.Tq + t) * a.H + (size_t)hk * a.rep + r) *
                           DH + c,
                   f);
      }
      *reinterpret_cast<float4*>(&q_s[j][c]) = make_float4(f[0], f[1], f[2], f[3]);
    }
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
      for (int c = 0; c < live_ch; ++c) {
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
        const int j = j0 + rg * RPW + rr;
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
      const int jl = rg * RPW + rr;
      store_lane<kLD>(&mrg_s[jl][lane * kLD], acc[rr]);
      if (lane == 0) {
        mrg_s[jl][DH] = m[rr];
        mrg_s[jl][DH + 1] = l[rr];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int jl = rg * RPW + rr, j = j0 + jl;
    if (!computes || slot != 0 || jl >= nrows_g) continue;
    const float m1 = mrg_s[jl][DH], l1 = mrg_s[jl][DH + 1];
    float a1[kLD];
    load_lane<kLD>(&mrg_s[jl][lane * kLD], a1);
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
      T* dst = dec_out_row<T, DH, PAD>(a, b, hk, j) + lane * kLD;
      if (PAD)
        store_part<kLD>(dst, o, dh - lane * kLD);
      else
        store_lane<kLD>(dst, o);
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
  // The last live split of (b, hk, group) to get here merges them all (a
  // second kernel for the merge cost 1.7 us more per call at Mixtral's
  // decode shape).
  __shared__ int last_s;
  __threadfence();
  __syncthreads();
  const int live = dec_live_splits(a, row_len);
  if (tid == 0) {
    int* ticket = a.tickets + (size_t)b * a.Hkv * a.G + blockIdx.y;
    last_s = atomicAdd(ticket, 1) == live - 1;
    if (last_s) *ticket = 0;  // every other split has drawn: ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  dec_merge<T, DH, PAD>(a, b, hk, j0, nrows_g, live, NT);
}

template <typename T, int MAXR, int DH, bool PAD>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const DecArgs a) {
  decode_body<T, MAXR, false, DH, PAD>(a);
}

template <typename T, int MAXR, int DH, bool PAD>
__global__ void __launch_bounds__(kDecThreads)
    paged_decode_kernel(const DecArgs a) {
  decode_body<T, MAXR, true, DH, PAD>(a);
}

template <typename T, int MAXR, int DH, bool PAD>
__global__ void __launch_bounds__(kDecThreads)
    attend_rows_kernel(const DecArgs a) {
  decode_body<T, MAXR, false, DH, PAD>(a);
}

enum DecKind { kDecContig = 0, kDecPaged = 1, kDecAttend = 2 };

template <typename T, int MAXR, int DH, bool PAD>
int launch_rows_r(int kind, const DecArgs& a, int B, cudaStream_t stream) {
  void (*kern)(const DecArgs) =
      kind == kDecContig  ? flash_decode_kernel<T, MAXR, DH, PAD>
      : kind == kDecPaged ? paged_decode_kernel<T, MAXR, DH, PAD>
                          : attend_rows_kernel<T, MAXR, DH, PAD>;
  static std::atomic<unsigned long long> sized[3];  // per kind, a bit per device
  constexpr int smem = dec_smem_bytes<T, DH>();
  const int err = mit::smem_once(reinterpret_cast<const void*>(kern), smem, sized[kind]);
  if (err != 0) return err;
  kern<<<dim3(a.NS, a.Hkv * a.G, B), kDecThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instance for a.Tq * a.rep rows over a.G groups: the rows of a block
// (all of them where G is 1, else 8) rounded up to 1, 2, 4 or 8.
template <typename T, int DH, bool PAD>
int launch_rows(int kind, const DecArgs& a, int B, cudaStream_t stream) {
  const int nrows = a.G > 1 ? kDecMaxRows : a.Tq * a.rep;
  if (nrows <= 1) return launch_rows_r<T, 1, DH, PAD>(kind, a, B, stream);
  if (nrows <= 2) return launch_rows_r<T, 2, DH, PAD>(kind, a, B, stream);
  if (nrows <= 4) return launch_rows_r<T, 4, DH, PAD>(kind, a, B, stream);
  if (nrows <= 8) return launch_rows_r<T, 8, DH, PAD>(kind, a, B, stream);
  return (int)cudaErrorInvalidValue;
}

// Fill DecArgs for mit_decode_rows and mit_decode_rows_pad; false where
// the plan or the shape is not one the body takes (G must be
// max(1, ceil(Tq * rep / 8))).
inline bool dec_args(DecArgs& a, int kind, const void* q, const void* k,
                     const void* v, void* out, const void* qpos,
                     const void* lengths, const void* table, const void* mask,
                     const void* bias, long long bsb, long long bsh,
                     long long bst, void* part_acc, void* part_ml,
                     void* tickets, int B, int Tq, int H, int Hkv, int S, int P,
                     int page, int kv_len, int causal, int round_p, int kc,
                     int NS, int G, float scale, float softcap, int head_dim) {
  if (kind < 0 || kind > 2 || Hkv <= 0 || Tq < 0 || H % Hkv != 0 || kc <= 0 ||
      kc % kDecTile != 0 || NS <= 0 || NS > 65535 || B > 65535 ||
      head_dim <= 0 || head_dim > kMaxHeadDim ||
      G != max(1, (Tq * (H / Hkv) + kDecMaxRows - 1) / kDecMaxRows) ||
      (long long)Hkv * G > 65535 ||
      (NS > 1 && (part_acc == nullptr || part_ml == nullptr ||
                  tickets == nullptr)))
    return false;
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
  a.dh = head_dim;
  a.G = G;
  a.scale = scale;
  a.softcap = softcap;
  return true;
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
// wholly in the future of its own. A padded instance (DH 256 takes one half
// only: two 128-key stages of 528-byte rows would not fit the shared memory)
// skips the k-steps and dim groups wholly past dh.
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

template <int HALVES, int DH, bool PAD>
__global__ void __launch_bounds__(HALVES * kMmaUnits * 32) flash_attend_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, T, H, dh]
    const __nv_bfloat16* __restrict__ k,   // [B, S, Hkv, dh]
    const __nv_bfloat16* __restrict__ v,   // [B, S, Hkv, dh]
    const int32_t* __restrict__ qpos,      // [B, T]
    const float* __restrict__ bias,        // strided [B|1, H|1, T|1, S] or null
    long long bsb, long long bsh, long long bst,
    const uint8_t* __restrict__ mask,      // [B, S] or null
    __nv_bfloat16* __restrict__ out,       // [B, T, H, dh]
    int Tq, int H, int Hkv, int S, int kv_len, int causal, float scale,
    float softcap, int dh_arg) {
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
  const int dh = PAD ? dh_arg : DH;
  // 16-byte chunks holding a live column, and whether they take cp.async
  const int live_ch = PAD ? (dh + 7) / 8 : kRowChunks;
  const bool vec = !PAD || dh % 8 == 0;
  if (PAD)  // the columns never loaded, in both buffers of K and V
    zero_chunks(att_smem, 2 * 2 * kMmaStage, kMmaRowBytes, live_ch, kRowChunks);
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

  // Q as A fragments: DH / 16 k-steps of 16 head dims (zero past dh)
  unsigned qa[kKs][4];
  {
    const __nv_bfloat16* qA = q + (((size_t)b * Tq + tA) * H + h) * dh;
    const __nv_bfloat16* qB = q + (((size_t)b * Tq + tB) * H + h) * dh;
    // two bf16 at column c of a row, as a fragment register
    auto pair = [&](const __nv_bfloat16* row, int c, bool ok) -> unsigned {
      if (!ok) return 0u;
      if (!PAD) return *reinterpret_cast<const unsigned*>(row + c);
      const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
      const unsigned lo = c < dh ? r[c] : 0u, hi = c + 1 < dh ? r[c + 1] : 0u;
      return lo | hi << 16;
    };
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const int c = ks * 16 + 2 * tq;
      qa[ks][0] = pair(qA, c, okA);
      qa[ks][1] = pair(qB, c, okB);
      qa[ks][2] = pair(qA, c + 8, okA);
      qa[ks][3] = pair(qB, c + 8, okB);
    }
  }

  float o[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float mA = mit::kNeg, mB = mit::kNeg, lA = 0.f, lB = 0.f;

  const size_t srow = (size_t)Hkv * dh;
  // a thread owns chunk column lc of the rows of a stage kLoadRows apart; the
  // mask bytes of its rows are read one stage ahead of the loads they gate
  const int lc = tid % kRowChunks, lr0 = tid / kRowChunks;
  const bool lc_live = lc < live_ch;  // false only in a padded instance
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
      if (!lc_live) continue;
      if (ok) {
        const size_t e = ((size_t)b * S + s) * srow + (size_t)hk * dh + lc * 8;
        if (vec) {
          cp_async16(kd, k + e);
          cp_async16(vd, v + e);
        } else {
          copy_chunk(kd, k + e, min(8, dh - lc * 8));
          copy_chunk(vd, v + e, min(8, dh - lc * 8));
        }
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
          if (PAD && ks * 16 >= dh) break;  // the rest is zeros
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
          if (PAD && dn * 8 >= dh) break;  // columns never stored
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
  __nv_bfloat16* oA = out + (((size_t)b * Tq + tA) * H + h) * dh + 2 * tq;
  __nv_bfloat16* oB = out + (((size_t)b * Tq + tB) * H + h) * dh + 2 * tq;
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) {
    if (PAD) {  // columns dn * 8 + 2 * tq and the next, where below dh
      const int c = dn * 8 + 2 * tq;
      const float xa[2] = {o[dn][0] * invA, o[dn][1] * invA};
      const float xb[2] = {o[dn][2] * invB, o[dn][3] * invB};
      if (okA) store_part<2>(oA + dn * 8, xa, dh - c);
      if (okB) store_part<2>(oB + dn * 8, xb, dh - c);
      continue;
    }
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
// query rows. At DH 256 the tiles (81 KB) take dynamic shared memory; a
// padded instance stages zeros past dh and its score loop stops at dh.
// ---------------------------------------------------------------------------
constexpr int kBT = 16;
constexpr int kBS = 32;
constexpr int kAttWarps = 4;
constexpr int kRows = kBT / kAttWarps;

// floats of q_s [kBT][DH], k_s [kBS][DH + 1] and v_s [kBS][DH]
template <int DH>
__host__ __device__ constexpr int f32_smem_floats() {
  return kBT * DH + kBS * (DH + 1) + kBS * DH;
}
// whether they exceed the 48 KB of static shared memory
template <int DH>
__host__ __device__ constexpr bool f32_dynamic() {
  return f32_smem_floats<DH>() * 4 > 48 * 1024;
}

template <int DH, bool PAD>
__global__ void __launch_bounds__(kAttWarps * 32) flash_attend_f32_kernel(
    const float* __restrict__ q,         // [B, T, H, dh]
    const float* __restrict__ k,         // [B, S, Hkv, dh]
    const float* __restrict__ v,         // [B, S, Hkv, dh]
    const int32_t* __restrict__ qpos,    // [B, T]
    const float* __restrict__ bias,      // strided [B|1, H|1, T|1, S] or null
    long long bsb, long long bsh, long long bst,
    const uint8_t* __restrict__ mask,    // [B, S] or null
    float* __restrict__ out,             // [B, T, H, dh]
    int Tq, int H, int Hkv, int S, int kv_len, int causal, float scale,
    float softcap, int dh_arg) {
  constexpr int kLD = DH / 32;  // head dims of the values a lane owns
  constexpr bool kDyn = f32_dynamic<DH>();
  extern __shared__ __align__(16) float f32_dyn[];
  __shared__ __align__(16) float f32_st[kDyn ? 4 : f32_smem_floats<DH>()];
  float* const base = kDyn ? f32_dyn : f32_st;
  auto q_s = reinterpret_cast<float(*)[DH]>(base);
  auto k_s = reinterpret_cast<float(*)[DH + 1]>(base + kBT * DH);  // +1: lane j reads row j conflict-free
  auto v_s = reinterpret_cast<float(*)[DH]>(base + kBT * DH + kBS * (DH + 1));

  const int t0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dh = PAD ? dh_arg : DH;
  const size_t qstride = (size_t)H * dh;
  const size_t kstride = (size_t)Hkv * dh;

  for (int i = tid; i < kBT * (DH / 4); i += blockDim.x) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t0 + r < Tq) {
      const float* src = q + ((size_t)b * Tq + t0 + r) * qstride + (size_t)h * dh + c;
      if (!PAD) {
        mit::load4(src, f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = c + e < dh ? src[e] : 0.f;
      }
    }
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
            ((size_t)b * S + s0 + j) * kstride + (size_t)hk * dh + c;
        if (!PAD) {
          mit::load4(k + off, kf);
          mit::load4(v + off, vf);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < dh) {
              kf[e] = k[off + e];
              vf[e] = v[off + e];
            }
        }
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
    for (int d = 0; d < dh; ++d) {
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
    float* o = out + ((size_t)b * Tq + t) * qstride + (size_t)h * dh + lane * kLD;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    float r[kLD];
#pragma unroll
    for (int i = 0; i < kLD; ++i) r[i] = acc[rr][i] * inv;
    if (PAD)
      store_part<kLD>(o, r, dh - lane * kLD);
    else
      store_lane<kLD>(o, r);
  }
}

template <int DH, bool PAD>
int launch_attend_bf16(const void* q, const void* k, const void* v,
                       const void* qpos, const void* bias, long long bsb,
                       long long bsh, long long bst, const void* mask,
                       void* out, int B, int Tq, int H, int Hkv, int S,
                       int kv_len, int causal, float scale, float softcap,
                       int head_dim, cudaStream_t stream) {
  // one warp per unit where a single 64-key tile holds every live key (and
  // always at DH 256: two halves' stages do not fit the shared memory)
  constexpr int kMaxHalves = DH > 128 ? 1 : 2;
  const int halves = min(kv_len, S) > kMmaTile ? kMaxHalves : 1;
  auto kern = halves == 2 ? flash_attend_kernel<kMaxHalves, DH, PAD>
                          : flash_attend_kernel<1, DH, PAD>;
  const int smem = halves == 2 ? mma_smem_bytes<kMaxHalves, DH>()
                               : mma_smem_bytes<1, DH>();
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
      H, Hkv, S, kv_len, causal, scale, softcap, head_dim);
  return (int)cudaGetLastError();
}

template <int DH, bool PAD>
int launch_attend_f32(const void* q, const void* k, const void* v,
                      const void* qpos, const void* bias, long long bsb,
                      long long bsh, long long bst, const void* mask,
                      void* out, int B, int Tq, int H, int Hkv, int S,
                      int kv_len, int causal, float scale, float softcap,
                      int head_dim, cudaStream_t stream) {
  constexpr int smem = f32_dynamic<DH>() ? f32_smem_floats<DH>() * 4 : 0;
  if (smem > 0) {
    static std::atomic<unsigned long long> sized{0};
    const int err = mit::smem_once(
        reinterpret_cast<const void*>(flash_attend_f32_kernel<DH, PAD>), smem, sized);
    if (err != 0) return err;
  }
  const dim3 grid((Tq + kBT - 1) / kBT, H, B);
  flash_attend_f32_kernel<DH, PAD><<<grid, kAttWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const float*>(bias), bsb, bsh, bst,
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), Tq, H, Hkv,
      S, kv_len, causal, scale, softcap, head_dim);
  return (int)cudaGetLastError();
}

// K2 with more than 8 query rows per kv head at instance width DH: the
// tensor cores for bf16, the CUDA cores for f32.
template <int DH, bool PAD>
int launch_attend(const void* q, const void* k, const void* v,
                  const void* qpos, const void* bias, long long bsb,
                  long long bsh, long long bst, const void* mask, void* out,
                  int B, int Tq, int H, int Hkv, int S, int kv_len, int causal,
                  float scale, float softcap, int is_bf16, int head_dim,
                  cudaStream_t st) {
  if (is_bf16)
    return launch_attend_bf16<DH, PAD>(q, k, v, qpos, bias, bsb, bsh, bst, mask,
                                       out, B, Tq, H, Hkv, S, kv_len, causal,
                                       scale, softcap, head_dim, st);
  return launch_attend_f32<DH, PAD>(q, k, v, qpos, bias, bsb, bsh, bst, mask,
                                    out, B, Tq, H, Hkv, S, kv_len, causal,
                                    scale, softcap, head_dim, st);
}

// The shape checks of mit_flash_attend and mit_flash_attend_pad.
inline bool attend_shape_ok(int B, int H, int Hkv, int head_dim) {
  return Hkv > 0 && H % Hkv == 0 && B <= 65535 && Hkv <= 65535 && H <= 65535 &&
         head_dim > 0 && head_dim <= kMaxHeadDim;
}

// Whether the zero-padded instance of width W takes head_dim: 64 and 128
// have instances of their own, width 128 takes the other dims below 128
// and width 256 those from 129 to 256.
template <int W>
constexpr bool padded_takes(int head_dim) {
  return head_dim != 64 && head_dim != 128 && head_dim <= W &&
         (W == 128 || head_dim > 128);
}

// mit_decode_rows_pad and mit_flash_attend_pad of the padded instances of
// width W (flash_attention_pad128.cu, flash_attention_pad256.cu): the
// checks and launches of mit_decode_rows and mit_flash_attend
// (flash_attention.cu); part_acc rows are W long.
template <int W>
int decode_rows_padded(int kind, const void* q, const void* k, const void* v,
                       void* out, const void* qpos, const void* lengths,
                       const void* table, const void* mask, const void* bias,
                       long long bsb, long long bsh, long long bst,
                       void* part_acc, void* part_ml, void* tickets, int B,
                       int Tq, int H, int Hkv, int S, int P, int page,
                       int kv_len, int causal, int round_p, int kc, int NS,
                       int G, float scale, float softcap, int is_bf16,
                       int head_dim, void* stream) {
  DecArgs a;
  if (!padded_takes<W>(head_dim) ||
      !dec_args(a, kind, q, k, v, out, qpos, lengths, table, mask, bias, bsb,
                bsh, bst, part_acc, part_ml, tickets, B, Tq, H, Hkv, S, P, page,
                kv_len, causal, round_p, kc, NS, G, scale, softcap, head_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_rows<__nv_bfloat16, W, true>(kind, a, B, st);
  return launch_rows<float, W, true>(kind, a, B, st);
}

template <int W>
int flash_attend_padded(const void* q, const void* k, const void* v,
                        const void* qpos, const void* bias, long long bsb,
                        long long bsh, long long bst, const void* mask,
                        void* out, int B, int Tq, int H, int Hkv, int S,
                        int kv_len, int causal, float scale, float softcap,
                        int is_bf16, int head_dim, void* stream) {
  if (!attend_shape_ok(B, H, Hkv, head_dim) || !padded_takes<W>(head_dim))
    return (int)cudaErrorInvalidValue;
  return launch_attend<W, true>(q, k, v, qpos, bias, bsb, bsh, bst, mask, out,
                                B, Tq, H, Hkv, S, kv_len, causal, scale,
                                softcap, is_bf16, head_dim,
                                static_cast<cudaStream_t>(stream));
}

}  // namespace
