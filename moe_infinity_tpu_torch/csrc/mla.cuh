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
// Two translation units compile it: flash_attention.cu holds the instance at
// latent width R 512 and rope width P 64 (every published DeepSeek MLA
// geometry), with the widths compile-time constants; mla_pad.cu holds the
// zero-padded instance (PAD) for every R that is a multiple of 128 up to 512
// and every P from 1 to 64, the true widths runtime arguments. They build at
// once.
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
// The design, against the first body (which launched a second kernel for the
// merge, took partials allocated on every call, staged 16-key tiles and all
// 16 x 576 queries as f32 with synchronous loads per block, and ran both
// products as dependent fmaf chains on the CUDA cores):
// - One launch. Grid (split, 16-head group, b) in clusters of CL = 1, 2, 4
//   or 8 splits; a split owns whole 32-key steps of the plan (the wrapper
//   plans them from integers). Each block leaves its (m, l) and unnormalised
//   sum in its own shared memory; the cluster merges them in split order over
//   distributed shared memory, each block a slice of the R columns, and
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
// the first body (16 keys by 16 heads a step, f32 staging) in mla_decode_f32_kernel,
// and go through the same launch, plan and merge.
//
// The padded instance keeps the 512/64 shared-memory layout (the latent at
// columns [0, 512) of a row, the rope key at [512, 576)), whose 207,360
// bytes already fill most of a block's 227 KB, and reads only the live
// columns: the latent's [0, R) and the rope key's [512, 512 + P). The key
// stages' other columns are zeroed once when a block starts and never
// loaded, q's are zero, so they add nothing to a score. A rope row of P * 2
// bytes that is not a multiple of 16 (P % 8 != 0) is copied an element at a
// time. The score products skip the k-steps that hold no live column, the
// value products the warps whose 64 columns lie past R, the f32 body its
// loops past the live columns, and the merge and the stores stop at R. Never
// a padded copy of the cache. R and P wider than 512 and 64 need a new
// design of the shared memory (ROADMAP queue 2 part 4's remainder).
#pragma once

#include <cooperative_groups.h>

#include "flash_attention.cuh"

namespace {

constexpr int kMlaR = 512;       // latent width (the value width) of a row
constexpr int kMlaP = 64;        // rope key width of a row
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
  int R, P;                // the live widths (kMlaR and kMlaP but in PAD)
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

// Whether k-step gk (row columns [16 gk, 16 gk + 16)) holds a live column.
__device__ __forceinline__ bool mla_live_step(int gk, int R, int P) {
  const int c0 = gk * 16;
  return c0 < R || (c0 >= kMlaR && c0 - kMlaR < P);
}

// The first n (< 4: zeros after them) or all 4 floats at p; a float4 load
// where `vec` says p is 16-byte aligned.
__device__ __forceinline__ float4 mla_ld4(const float* p, int n, bool vec) {
  if (n >= 4 && vec) return *reinterpret_cast<const float4*>(p);
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = i < n ? p[i] : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
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
// slice) combines the clusters' states of the slice in cluster order. R is
// a multiple of 128, so a slice is whole float4s.
template <bool PAD>
__device__ __forceinline__ void mla_finish(const MlaArgs& a, int b, int hg,
                                           int h0, int nh, int live,
                                           const float* st_acc,
                                           const float2* st_ml) {
  namespace cgs = cooperative_groups;
  cgs::cluster_group cluster = cgs::this_cluster();
  __shared__ float2 ml_s[kMlaMaxCluster][kMlaHeads];  // every rank's (m, l)
  __shared__ int last_s;
  const int R = PAD ? a.R : kMlaR;
  const int CL = a.CL, rank = (int)cluster.block_rank(), tid = threadIdx.x;
  const int W = R / CL, c0 = rank * W;  // this block's columns
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
      *reinterpret_cast<float4*>(a.out + ((size_t)b * a.H + h0 + hh) * R + col) =
          make_float4(A[0] * inv, A[1] * inv, A[2] * inv, A[3] * inv);
    } else if (ci < live_c) {
      *reinterpret_cast<float4*>(a.part_acc + (cbase * a.H + h0 + hh) * R + col) =
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
          __ldcg(reinterpret_cast<const float4*>(a.part_acc + (cb * a.H + h) * R + col));
      const float w = expf(ml.x - M);
      L += ml.y * w;
      A[0] = fmaf(pa.x, w, A[0]);
      A[1] = fmaf(pa.y, w, A[1]);
      A[2] = fmaf(pa.z, w, A[2]);
      A[3] = fmaf(pa.w, w, A[3]);
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    *reinterpret_cast<float4*>(a.out + ((size_t)b * a.H + h) * R + col) =
        make_float4(A[0] * inv, A[1] * inv, A[2] * inv, A[3] * inv);
  }
}

template <bool PAD>
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
  const int R = PAD ? a.R : kMlaR, P = PAD ? a.P : kMlaP;
  const bool pe_vec = !PAD || P % 8 == 0;  // rope rows of whole 16-byte chunks
  const int row_len = mla_row_len(a.qpos, b, a.S, a.kv_len);
  const int k_begin = split * a.kc;  // a split past the live keys owns none,
  const int k_end = min(k_begin + a.kc, row_len);  // but joins its cluster's merge
  const int ntiles = max(0, (k_end - k_begin + kMlaKeys - 1) / kMlaKeys);
  const int live = mla_live_splits(a, row_len);
  const __nv_bfloat16* cg =
      static_cast<const __nv_bfloat16*>(a.c) + (size_t)b * a.S * R;
  const __nv_bfloat16* pg =
      static_cast<const __nv_bfloat16*>(a.kpe) + (size_t)b * a.S * P;

  // q's loads first: they are in flight while the first mask bytes come
  constexpr int kQ = kMlaHeads * (kMlaW / 4) / kMlaThreads;
  float4 qv[kQ];
#pragma unroll
  for (int n = 0; n < kQ; ++n) {
    const int i = tid + n * kMlaThreads;
    const int h = h0 + i / (kMlaW / 4), col = (i % (kMlaW / 4)) * 4;
    const size_t row = (size_t)b * a.H + h;
    if (h >= a.H || ntiles == 0)
      qv[n] = make_float4(0.f, 0.f, 0.f, 0.f);
    else if (col < kMlaR)
      qv[n] = !PAD || col < R ? *reinterpret_cast<const float4*>(a.q_lat + row * R + col)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    else if (!PAD)
      qv[n] = *reinterpret_cast<const float4*>(a.q_pe + row * kMlaP + col - kMlaR);
    else
      qv[n] = mla_ld4(a.q_pe + row * P + col - kMlaR, P - (col - kMlaR), P % 4 == 0);
  }

  // Loads: 4 neighbouring threads copy one key of a tile, thread chunks
  // lch + 4 j of the key's 72 16-byte chunks (the latent's 64, then the rope
  // key's 8), so that they read 64 contiguous bytes. fetch(ti) reads the
  // key's mask byte of tile ti into a register, one tile before
  // load_tile(ti, buf) starts the copies, which zero-fill a key that is not
  // to be read. A padded instance copies only the live chunks, the last
  // rope chunk of a row an element at a time where rows are not whole
  // chunks.
  constexpr int kLd = kMlaThreads / kMlaKeys;
  const int lkey = tid / kLd, lch = tid % kLd;
  const __nv_bfloat16* csrc = cg + (size_t)(k_begin + lkey) * R + lch * 8;
  const __nv_bfloat16* psrc = pg + (size_t)(k_begin + lkey) * P + lch * 8;
  unsigned char* ldst = kbuf + lkey * kMlaRowBytes + lch * 16;
  if (PAD) {  // the columns never loaded, in both key stages
    zero_chunks(kbuf, 2 * kMlaKeys, kMlaRowBytes, R / 8, kMlaR / 8);
    zero_chunks(kbuf, 2 * kMlaKeys, kMlaRowBytes, (kMlaR + P + 7) / 8, kMlaW / 8);
  }
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
    for (int j = 0; j < kMlaR / 8 / kLd; ++j) {
      if (PAD && (lch + j * kLd) * 8 >= R) break;
      mit::cp_async16(dst + j * kLd * 16, ok ? csrc + t0 * R + j * kLd * 8 : cg,
                      ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < kMlaP / 8 / kLd; ++j) {
      const int pc = (lch + j * kLd) * 8;  // the chunk's first rope column
      if (PAD && pc >= P) break;
      unsigned char* d = dst + kMlaR * 2 + j * kLd * 16;
      if (pe_vec)
        mit::cp_async16(d, ok ? psrc + t0 * P + j * kLd * 8 : cg, ok ? 16 : 0);
      else
        copy_chunk(d, psrc + t0 * P + j * kLd * 8, ok ? min(8, P - pc) : 0);
    }
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
  const bool warp_cols = !PAD || warp * 64 < R;  // the warp's value columns hold a live one

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
          if (PAD) {  // a pair of k-steps with no live column adds nothing
            const int gk = kp * kMlaKSteps + ks;
            if (!mla_live_step(gk, R, P) && !(ks + 1 < kMlaKSteps && mla_live_step(gk + 1, R, P)))
              continue;
          }
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
    if (warp_cols) {
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
  mla_finish<PAD>(a, b, hg, h0, min(kMlaHeads, a.H - h0), live, st_acc, st_ml);
}

// f32 caches: the first CUDA-core body, one head tile a block. In a block of 256
// threads: score phase, thread (key s = t % 16, head h = t / 16) takes the
// 576-long dot product and the 16 lanes of a head reduce max and sum by
// shuffles; value phase, thread (4 latent columns, 8 heads) accumulates
// p[s, h] * c[s, cols] in registers. A padded instance loads, multiplies and
// accumulates only the live columns (q's and the keys' 4-column groups of
// [0, R) and [512, 512 + P), the last rope group zero past P); the columns
// past them in shared memory are never read.
constexpr int kMlaF32Keys = 16;  // keys per step (a tile of the plan is two)
constexpr int kMlaKeyStride = kMlaW + 4;  // rows 4 banks apart
constexpr int kMlaF32Smem =
    (kMlaHeads * kMlaW + kMlaF32Keys * kMlaKeyStride + kMlaF32Keys * kMlaHeads +
     kMlaHeads + kMlaF32Keys) * (int)sizeof(float);

template <bool PAD>
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
  const int R = PAD ? a.R : kMlaR, P = PAD ? a.P : kMlaP;
  const bool pe_vec = !PAD || P % 4 == 0;  // rope rows of whole float4s
  const int row_len = mla_row_len(a.qpos, b, a.S, a.kv_len);
  const int k_begin = split * a.kc;  // a split past the live keys owns none,
  const int k_end = min(k_begin + a.kc, row_len);  // but joins its cluster's merge
  const int live = mla_live_splits(a, row_len);
  const int tid = threadIdx.x;
  // the live 4-column groups: the latent's R / 4, then the rope key's
  const int nlat = R / 4, ng = nlat + (P + 3) / 4;
  auto group = [&](int gi) { return !PAD || gi < nlat ? gi : kMlaR / 4 + gi - nlat; };

  // the block's queries: [q_lat | q_pe] per head, zero for a head past H
  for (int i = tid; i < (k_begin < k_end ? kMlaHeads * ng : 0); i += kMlaThreads) {
    const int h = i / ng, gc = group(i % ng);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h0 + h < a.H) {
      const size_t row = (size_t)b * a.H + h0 + h;
      const int pc = (gc - kMlaR / 4) * 4;  // a rope group's first column
      if (gc < kMlaR / 4)
        f = *reinterpret_cast<const float4*>(a.q_lat + row * R + gc * 4);
      else if (!PAD)
        f = *reinterpret_cast<const float4*>(a.q_pe + row * kMlaP + pc);
      else
        f = mla_ld4(a.q_pe + row * P + pc, P - pc, pe_vec);
    }
    *reinterpret_cast<float4*>(q_s + h * kMlaW + gc * 4) = f;
  }

  const int s_own = tid & (kMlaF32Keys - 1), h_own = tid / kMlaF32Keys;
  const int cg = tid & 127, hg8 = tid >> 7;
  const bool cols_live = !PAD || cg * 4 < R;  // this thread's value columns
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
    for (int i = tid; i < kMlaF32Keys * ng; i += kMlaThreads) {
      const int s = i / ng, gc = group(i % ng);
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid_s[s]) {
        const size_t row = (size_t)b * a.S + t0 + s;
        const int pc = (gc - kMlaR / 4) * 4;
        if (gc < kMlaR / 4)
          f = *reinterpret_cast<const float4*>(c + row * R + gc * 4);
        else if (!PAD)
          f = *reinterpret_cast<const float4*>(kpe + row * kMlaP + pc);
        else
          f = mla_ld4(kpe + row * P + pc, P - pc, pe_vec);
      }
      *reinterpret_cast<float4*>(key_s + s * kMlaKeyStride + gc * 4) = f;
    }
    __syncthreads();

    const float4* kr =
        reinterpret_cast<const float4*>(key_s + s_own * kMlaKeyStride);
    const float4* qr = reinterpret_cast<const float4*>(q_s + h_own * kMlaW);
    float sc = 0.f;
#pragma unroll 8
    for (int gi = 0; gi < ng; ++gi) {
      const int i = group(gi);
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

    if (!cols_live) continue;  // no barrier before the next step's first
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
  mla_finish<PAD>(a, b, hg, h0, min(kMlaHeads, a.H - h0), live, st_acc, st_ml);
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

template <bool PAD>
int launch_mla_bf16(const MlaArgs& a, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> sized{0};
  const int err = mit::smem_once(reinterpret_cast<const void*>(mla_decode_kernel<PAD>),
                                 kMlaSmem, sized);
  if (err != 0) return err;
  return launch_mla(mla_decode_kernel<PAD>, kMlaSmem, a, B, stream);
}

template <bool PAD>
int launch_mla_f32(const MlaArgs& a, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> sized{0};
  const int err = mit::smem_once(reinterpret_cast<const void*>(mla_decode_f32_kernel<PAD>),
                                 kMlaF32Smem, sized);
  if (err != 0) return err;
  return launch_mla(mla_decode_f32_kernel<PAD>, kMlaF32Smem, a, B, stream);
}

// The entry points' body: kc (a multiple of 32) is the keys per split, NS >=
// ceil(min(kv_len, S) / kc) the splits, a multiple of the cluster size CL
// (1, 2, 4 or 8); a block holds 16 heads. Scratch and tickets are used when
// NS > CL: part_acc [B, NS / CL, H, R] and part_ml [B, NS / CL, CL, H, 2]
// f32, tickets [B, ceil(H / 16), CL] int32, zero between launches. R and P
// must be 512 and 64 for the unpadded instance, R a multiple of 128 up to
// 512 and P 1 to 64 for the padded one.
template <bool PAD>
int mla_flash_decode(const void* q_lat, const void* q_pe, const void* c,
                     const void* kpe, const void* qpos, const void* mask,
                     void* part_acc, void* part_ml, void* tickets, void* out,
                     int B, int H, int S, int R, int P, int kv_len, int kc,
                     int NS, int CL, float scale, int is_bf16, void* stream) {
  const int live_max = kv_len < S ? kv_len : S;
  const bool widths_ok = PAD ? (R >= 128 && R <= kMlaR && R % 128 == 0 && P >= 1 && P <= kMlaP)
                             : (R == kMlaR && P == kMlaP);
  if (!widths_ok || kc <= 0 || kc % kMlaTile != 0 || NS <= 0 ||
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
  a.R = R;
  a.P = P;
  a.scale = scale;
  if (a.HG > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_mla_f32<PAD>(a, B, st);
  return launch_mla_bf16<PAD>(a, B, st);
}

}  // namespace
