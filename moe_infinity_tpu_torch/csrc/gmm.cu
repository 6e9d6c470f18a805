// Hand-written Hopper grouped matmul with fused weight dequantization (K3).
//
// Replaces moe_infinity_tpu/ops/gmm.py _gmm_kernel / gmm:
//   out[r, :] = bf16(x[r, :]) @ bf16(w[group_ids[g] + group_offset]) * scale
// for the rows r of group g (rows are sorted by group; group g owns rows
// [group_start[g], group_start[g+1])). f32 accumulation, the per-output
// channel scale applied after the sum. Weights: bf16, int8, float8 e4m3
// (the JAX kernel's float8_e4m3fn arena: its values convert to bf16 exactly,
// so the products are still bf16(x) x bf16(w); x is never rounded to fp8,
// which the fp8 tensor-core products would do), or split-nibble packed int4
// (byte c of a row holds output channel c in its low nibble and channel
// c + F/2 in its high nibble, sign-extended).
//
// Two weight layouts, one kernel: flat [S, D, Fw] and the JAX kernel's
// pre-tiled [S, Fw / tf, D, tf] (ops/gmm.py::pack_tiled: slab fi holds
// stored columns [fi tf, (fi + 1) tf)). The flat layout is the tiled one with
// a single slab, tf = Fw, so column c at k-row d of slot gw lies at element
// ((gw nf + c / tf) D + d) tf + c % tf either way. A 16-byte piece lies in
// one slab when tf * elt is a multiple of 16; a column tile of 128 may still
// straddle two slabs (slabs of 352 columns, say), each piece reading its own. The
// products and their order are the same in both layouts, so a tiled call is
// bit-equal to the flat call on the same values.
//
// What bounds it on the H100: the routed experts' weight bytes, at 3.35
// TB/s. A decode step gives each routed expert a few rows (8 to 24 rows in
// all), Mixtral's 16-wide chunk step about 16 and NLLB's prefill about 4:
// at most some 64 operations per weight byte, far below the tensor cores'
// 295 but above what the CUDA cores' 67 TFLOP/s keep up with. bf16 calls
// are bound by the loads; int8, int4 and e4m3 calls by the conversion to
// bf16 and the products, whose instructions take longer than the loads they
// wait on;
// every call pays about 4 us of launch and output zeroing (PERF.md). The
// design:
//
// - Ownership. Block (column tile, k-split, chunk) owns 128 stored columns
//   of a chunk of up to 64 rows of one group over a range of the reduction.
//   A group of up to 64 rows reads its weight slab once; an empty group owns
//   no chunk and moves no byte, so cost follows routed groups, not slots.
//   The block computes only the ceil(rows / 16) m16 tiles that hold rows, so
//   a one-row decode group costs one. Groups own disjoint rows, so every
//   output element has one writer. The wrapper passes the group sizes; each
//   block finds its chunk by one scan of them, and the grid's chunk axis is
//   a bound (rows / 64 + groups), last, so that the blocks past the last
//   chunk come after the live ones and return at once.
// - Loads. The block walks its range in 64-deep k-tiles: 16-byte cp.async
//   copies of the x tile (bf16) and of the weight tile in its stored type
//   (16 KB bf16, 8 KB int8, e4m3 or packed int4), as many stages deep as 72 KB of
//   shared memory hold, so that three one-tile blocks share an SM (the x
//   tile is only as tall as the call's rows need). Each thread's copy sources are computed once and advanced by a
//   k-tile per load. Rows past the chunk, columns past the weight's width and
//   the tail of D are zero-filled by cp.async's source size, never read.
// - Dequantization. Each warp converts its own 16 stored columns of an int8,
//   int4 or e4m3 stage into a bf16 tile (exact: -128..127 and -8..7 are
//   bf16 values, built from the bytes with byte permutes and one add; an
//   e4m3 pair becomes two halves by cvt.rn.f16x2.e4m3x2, each widened to f32
//   and cut to its upper half, which loses nothing: e4m3 has 3 mantissa
//   bits and bf16 7), so only a __syncwarp stands between conversion and
//   use. This costs about ten bytes
//   of shared-memory traffic per int4 byte read; converting straight into
//   the B fragments in registers is the later fix.
// - Products on the tensor cores: mma.sync m16n8k16 bf16 -> f32, A fragments
//   from the x tile by ldmatrix, B fragments from the bf16 weight tile by
//   ldmatrix.trans, each B fragment used for every live m16 tile. The f32
//   accumulators stay in registers; how far their rounding takes a deep
//   reduction from an f32 matmul is measured in PERF.md. Rows of
//   every shared tile are padded by 16 bytes, so that ldmatrix's 8 rows fall
//   in 8 bank groups.
// - Split-K for short grids. Where the column tiles times the chunks are too
//   few blocks for the card, the wrapper's planner cuts the reduction into
//   whole k-tile splits (grid.y). Each split writes its f32 partial tile to a
//   workspace; the last split of a (column tile, chunk) to finish (a
//   __threadfence() and a ticket counter it resets to 0) sums the partials in
//   split order, applies the scale and stores: deterministic, one launch.
#include <cuda_fp16.h>

#include <algorithm>

#include "common.cuh"

namespace {

enum WKind { kBF16 = 0, kINT8 = 1, kINT4 = 2, kE4M3 = 3 };

constexpr int kThreads = 256;  // 8 warps; warp w owns stored columns [16w, 16w + 16)
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;       // stored columns of a tile
constexpr int kBM = 64;        // rows of a chunk
constexpr int kBK = 64;        // depth of a k-tile
constexpr int kSmemBudget = 72 * 1024;  // shared memory of a block's stages
constexpr int kXCopies = kBK * 2 / 16;  // 16-byte copies per x row
constexpr int kXRow = kBK * 2 + 16;     // bytes of an x row of a stage, padded
constexpr unsigned kFull = 0xffffffffu;

template <int KIND, int MT>  // MT: m16 tiles the x tile holds
struct Tile {
  static constexpr int kElt = KIND == kBF16 ? 2 : 1;  // bytes of a stored weight
  static constexpr int kWCopies = kBN * kElt / 16;    // 16-byte copies per weight row
  static constexpr int kWRow = kBN * kElt + 16;       // bytes of a stage's weight row
  static constexpr int kHalves = KIND == kINT4 ? 2 : 1;  // int4: low and high nibbles
  static constexpr int kBRow = kHalves * kBN * 2 + 16;   // bytes of a bf16 tile row
  static constexpr int kXBytes = MT * 16 * kXRow;
  static constexpr int kStage = kXBytes + kBK * kWRow;
  static constexpr int kConv = KIND == kBF16 ? 0 : kBK * kBRow;  // the bf16 tile
  static constexpr int kStages = (kSmemBudget - kConv) / kStage;  // 2 to 4
  static constexpr int kSmem = kStages * kStage + kConv;
  static_assert(kStages >= 2, "the budget must hold two stages");
};

struct Args {
  const __nv_bfloat16* x;  // [T, D]
  const void* w;           // [S, D, Fw]
  const float* scale;      // [S, F] or null
  const int32_t* sizes;    // [G] rows of each group
  const int32_t* gids;     // [G], or null for 0 .. G - 1
  float* part;             // [splits, T, F] partial sums when splits > 1
  int32_t* tickets;        // [chunks, tiles], zero between launches, when splits > 1
  int G, goff, T, D, Fw, F, kps, splits;
  int tf;      // stored columns of a slab: Fw when flat
  float* out;  // [T, F]
};

// The chunk `c` of the call: f = {group, first row, rows, weight row}, or
// f[0] = -1 past the last chunk. One coalesced read of the group sizes and
// ids (kThreads groups at a time): the block scans the sizes and the chunk
// counts ceil(size / kBM); the thread whose group holds chunk c writes f.
// G > 0.
__device__ __forceinline__ void find_chunk(const Args& a, int c, int* sw, int* f) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int rows0 = 0, chunks0 = 0;  // totals of the groups before this pass
  if (tid == 0) f[0] = -1;
  for (int g0 = 0; g0 < a.G; g0 += kThreads) {
    const int g = g0 + tid;
    const int n = g < a.G ? a.sizes[g] : 0;
    const int id = g >= a.G ? 0 : a.gids != nullptr ? a.gids[g] : g;
    const int nc = (n + kBM - 1) / kBM;
    int sn = n, sc = nc;  // inclusive scans over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int un = __shfl_up_sync(kFull, sn, o), uc = __shfl_up_sync(kFull, sc, o);
      if (lane >= o) {
        sn += un;
        sc += uc;
      }
    }
    if (lane == 31) {
      sw[warp] = sn;
      sw[kWarps + warp] = sc;
    }
    __syncthreads();
    int bn = rows0, bc = chunks0;
    for (int v = 0; v < warp; ++v) {
      bn += sw[v];
      bc += sw[kWarps + v];
    }
    const int c0 = bc + sc - nc;  // the first chunk of group g
    if (c0 <= c && c < c0 + nc) {
      const int k = c - c0;
      f[0] = g;
      f[1] = bn + sn - n + k * kBM;
      f[2] = min(kBM, n - k * kBM);
      f[3] = id;
    }
    for (int v = 0; v < kWarps; ++v) {
      rows0 += sw[v];
      chunks0 += sw[kWarps + v];
    }
    __syncthreads();
    if (f[0] >= 0) break;  // uniform: every thread reads f after the barrier
  }
}

// bf16 pair (lo in the low half) of two int8 values, each byte b of `u`
// placed as the f32 2^23 + (b ^ 0x80) and shifted down by 2^23 + 128.
__device__ __forceinline__ unsigned int8_pair(unsigned u, unsigned sel_lo,
                                              unsigned sel_hi) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, sel_lo)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, sel_hi)) - 8388736.f;
  return mit::pack_bf16(lo, hi);
}

// bf16 pair of two nibbles already offset to 0..15 in the low nibbles of
// bytes of `q`: the bf16 128 + q (0x4300 | q) less 136 is q - 8, exactly.
__device__ __forceinline__ unsigned int4_pair(unsigned q, unsigned sel) {
  const unsigned v = __byte_perm(q, 0x43434343u, sel), k = 0x43084308u;  // bf16 136, 136
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k));
  return *reinterpret_cast<const unsigned*>(&r);
}

// bf16 pair of the two e4m3 codes in the low (lo) and high byte of `v`:
// cvt gives the f16 pair (every e4m3 value, NaN included, is an f16 value),
// each half widens to f32 exactly, and the upper 16 bits of an f32 that a
// bf16 holds are that bf16.
__device__ __forceinline__ unsigned e4m3_pair(unsigned short v) {
  unsigned h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(v));
  const __half2 h = *reinterpret_cast<const __half2*>(&h2);
  const float2 f = __half22float2(h);
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

// Warp `warp` converts its 16 stored columns of the raw stage `raw` into
// the bf16 tile `bq` (int4: low nibbles at columns [0, 128), high nibbles
// at [128, 256)); lane l takes rows l, l + 32, ...
template <int KIND, int MT>
__device__ __forceinline__ void dequant(const unsigned char* raw, unsigned char* bq,
                                        int warp, int lane) {
  using C = Tile<KIND, MT>;
#pragma unroll
  for (int h = 0; h < kBK / 32; ++h) {
    const int row = lane + 32 * h;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + row * C::kWRow + warp * 16);
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
    unsigned char* dst = bq + row * C::kBRow + warp * 32;
    if (KIND == kINT8 || KIND == kE4M3) {
      unsigned o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (KIND == kINT8) {
          const unsigned b = u[j] ^ 0x80808080u;
          o[2 * j] = int8_pair(b, 0x7440, 0x7441);
          o[2 * j + 1] = int8_pair(b, 0x7442, 0x7443);
        } else {
          o[2 * j] = e4m3_pair((unsigned short)(u[j] & 0xffffu));
          o[2 * j + 1] = e4m3_pair((unsigned short)(u[j] >> 16));
        }
      }
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
    } else {
      unsigned lo[8], hi[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned ql = (u[j] & 0x0F0F0F0Fu) ^ 0x08080808u;
        const unsigned qh = ((u[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        lo[2 * j] = int4_pair(ql, 0x5140);
        lo[2 * j + 1] = int4_pair(ql, 0x5342);
        hi[2 * j] = int4_pair(qh, 0x5140);
        hi[2 * j + 1] = int4_pair(qh, 0x5342);
      }
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      reinterpret_cast<uint4*>(dst + kBN * 2)[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      reinterpret_cast<uint4*>(dst + kBN * 2)[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

// Grid (column tile, k-split, chunk).
template <int KIND, int MT>
__global__ void __launch_bounds__(kThreads, 2) gmm_kernel(const Args a) {
  using C = Tile<KIND, MT>;
  constexpr int NT = 2 * C::kHalves;  // n8 tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int sw[2 * kWarps], f[4], last;
  find_chunk(a, blockIdx.z, sw, f);
  if (f[0] < 0) return;  // past the last chunk: nothing to do
  const int r0 = f[1], nr = f[2];
  const int mts = (nr + 15) >> 4;  // live m16 tiles (<= MT), uniform across the block
  const size_t gw = (size_t)f[3] + a.goff;
  const int nk = (a.D + kBK - 1) / kBK;
  const int kt0 = blockIdx.y * a.kps;  // the host plans no empty split
  const int kt1 = min(nk, kt0 + a.kps);
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int stages = C::kStages;
  const unsigned char* xg = reinterpret_cast<const unsigned char*>(a.x + (size_t)r0 * a.D);
  const unsigned char* wg =
      static_cast<const unsigned char*>(a.w) + gw * a.D * a.Fw * C::kElt;

  // The loader's copies are fixed per thread: x copy i = tid + kThreads * j
  // is piece i % kXCopies of row i / kXCopies of every k-tile, weight copy j
  // likewise; their sources advance one k-tile per load (loads run in k-tile
  // order), so a load costs a compare, an add and a cp.async per copy.
  constexpr int JX = (MT * 16 * kXCopies + kThreads - 1) / kThreads;
  constexpr int JW = kBK * C::kWCopies / kThreads;
  const unsigned char* xsrc[JX];
  const unsigned char* wsrc[JW];
  int xdst[JX], xk[JX], wdst[JW], wk[JW];
  bool xok[JX], wok[JW];
#pragma unroll
  for (int j = 0; j < JX; ++j) {
    const int i = tid + j * kThreads, r = i / kXCopies, ch = i % kXCopies;
    xdst[j] = r < mts * 16 ? r * kXRow + ch * 16 : -1;  // -1: no copy
    xok[j] = r < nr;
    xk[j] = ch * 8;
    xsrc[j] = xg + ((size_t)r * a.D + kt0 * kBK + ch * 8) * 2;
  }
#pragma unroll
  for (int j = 0; j < JW; ++j) {
    const int i = tid + j * kThreads, kk = i / C::kWCopies, ch = i % C::kWCopies;
    const int col = col0 + ch * (16 / C::kElt);
    wdst[j] = kk * C::kWRow + ch * 16;
    wk[j] = kk;
    wok[j] = col < a.Fw;
    wsrc[j] = wg + (((size_t)(col / a.tf) * a.D + kt0 * kBK + kk) * a.tf + col % a.tf) *
                       C::kElt;
  }
  const size_t wstep = (size_t)kBK * a.tf * C::kElt;
  // stage s <- the next k-tile, kt
  auto load = [&](int kt, int s) {
    unsigned char* xs = smem + s * C::kStage;
    unsigned char* ws = xs + C::kXBytes;
    const int k0 = kt * kBK;
    const bool full = k0 + kBK <= a.D;  // else zero-fill the rows past D
#pragma unroll
    for (int j = 0; j < JX; ++j) {
      if (xdst[j] < 0) continue;
      const bool ok = xok[j] && (full || k0 + xk[j] < a.D);
      mit::cp_async16(xs + xdst[j], ok ? xsrc[j] : xg, ok ? 16 : 0);
      xsrc[j] += kBK * 2;
    }
#pragma unroll
    for (int j = 0; j < JW; ++j) {
      const bool ok = wok[j] && (full || k0 + wk[j] < a.D);
      mit::cp_async16(ws + wdst[j], ok ? wsrc[j] : wg, ok ? 16 : 0);
      wsrc[j] += wstep;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (kt0 + s < kt1) load(kt0 + s, s);
    mit::cp_async_commit();
  }
  int s = 0;  // the stage of k-tile kt
  for (int kt = kt0; kt < kt1; ++kt) {
    mit::cp_async_wait<stages - 2>();
    __syncthreads();  // stage s has landed; every warp is done with stage s - 1
    {
      const int nxt = kt + stages - 1;
      if (nxt < kt1) load(nxt, s == 0 ? stages - 1 : s - 1);
      mit::cp_async_commit();
    }
    const unsigned char* xs = smem + s * C::kStage;
    const unsigned char* bt = xs + C::kXBytes;
    if (KIND != kBF16) {
      unsigned char* bq = smem + stages * C::kStage;
      dequant<KIND, MT>(bt, bq, warp, lane);
      __syncwarp();  // the warp reads only the columns it converted
      bt = bq;
    }
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      unsigned b[C::kHalves][4];
      const unsigned char* bp =
          bt + (ks * 16 + (lane & 15)) * C::kBRow + (warp * 16 + (lane >> 4) * 8) * 2;
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h) mit::ldmatrix_x4_trans(b[h], bp + h * kBN * 2);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < mts) {
          unsigned af[4];
          mit::ldmatrix_x4(af, xs + (m * 16 + (lane & 15)) * kXRow +
                                   (ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int h = 0; h < C::kHalves; ++h) {
            mit::mma_bf16(acc[m][2 * h], af, b[h][0], b[h][1]);
            mit::mma_bf16(acc[m][2 * h + 1], af, b[h][2], b[h][3]);
          }
        }
      }
    }
    s = s + 1 == stages ? 0 : s + 1;
  }
  mit::cp_async_wait<0>();  // no copy outlives the block

  // Fragment (m, n, e) of a lane: rows m * 16 + lane / 4 + 8e, stored columns
  // u and u + 1; output columns h * Fw + u (int4's high half at F/2 = Fw).
  const bool split = a.splits > 1;
  float* part = a.part + (size_t)blockIdx.y * a.T * a.F;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= mts) break;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int u = col0 + warp * 16 + (n & 1) * 8 + (lane & 3) * 2;
      if (u >= a.Fw) continue;  // Fw is even: the pair is in or out
      const int col = (n >> 1) * a.Fw + u;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m * 16 + (lane >> 2) + 8 * e;
        if (row >= nr) continue;
        const size_t at = (size_t)(r0 + row) * a.F + col;
        float v0 = acc[m][n][2 * e], v1 = acc[m][n][2 * e + 1];
        if (split) {
          *reinterpret_cast<float2*>(part + at) = make_float2(v0, v1);
          continue;
        }
        if (a.scale != nullptr) {
          v0 *= a.scale[gw * a.F + col];
          v1 *= a.scale[gw * a.F + col + 1];
        }
        *reinterpret_cast<float2*>(a.out + at) = make_float2(v0, v1);
      }
    }
  }
  if (!split) return;

  // The last split of (tile, chunk) to finish sums the partials in split
  // order; its own are still in registers.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = a.tickets + (size_t)blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(ticket, 1) == a.splits - 1;
    if (last) *ticket = 0;  // every other split has drawn: ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= mts) break;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int u = col0 + warp * 16 + (n & 1) * 8 + (lane & 3) * 2;
      if (u >= a.Fw) continue;
      const int col = (n >> 1) * a.Fw + u;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m * 16 + (lane >> 2) + 8 * e;
        if (row >= nr) continue;
        const size_t at = (size_t)(r0 + row) * a.F + col;
        float v0 = 0.f, v1 = 0.f;
        for (int z = 0; z < a.splits; ++z) {
          if (z == (int)blockIdx.y) {
            v0 += acc[m][n][2 * e];
            v1 += acc[m][n][2 * e + 1];
          } else {
            const float2 p = __ldcg(
                reinterpret_cast<const float2*>(a.part + (size_t)z * a.T * a.F + at));
            v0 += p.x;
            v1 += p.y;
          }
        }
        if (a.scale != nullptr) {
          v0 *= a.scale[gw * a.F + col];
          v1 *= a.scale[gw * a.F + col + 1];
        }
        *reinterpret_cast<float2*>(a.out + at) = make_float2(v0, v1);
      }
    }
  }
}

template <int KIND, int MT>
int launch(const Args& a, dim3 grid, cudaStream_t st) {
  using C = Tile<KIND, MT>;
  // the kernel may take C::kSmem of dynamic shared memory: a bit per device
  static std::atomic<unsigned long long> sized;
  const int err =
      mit::smem_once(reinterpret_cast<const void*>(gmm_kernel<KIND, MT>), C::kSmem, sized);
  if (err != 0) return err;
  gmm_kernel<KIND, MT><<<grid, kThreads, C::kSmem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(const Args& a, dim3 grid, int mt, cudaStream_t st) {
  if (mt <= 1) return launch<KIND, 1>(a, grid, st);
  if (mt == 2) return launch<KIND, 2>(a, grid, st);
  return launch<KIND, 4>(a, grid, st);
}

}  // namespace

// w is [S, Fw / tf, D, tf] (tf = Fw: the flat [S, D, Fw]), tf * elt a
// multiple of 16 bytes. `splits` whole-k-tile splits of
// ceil(ceil(D / 64) / splits) k-tiles each,
// none empty; with more than one, `part` holds splits * T * F floats and
// `tickets` max_chunks * ceil(Fw / 128) zeroed counters. rows_per_chunk
// must equal kBM; max_chunks bounds the chunk count (rows / kBM + G) and
// sizes the grid. The x tile holds min(T, kBM) rows rounded up to m16 tiles.
extern "C" int mit_gmm(const void* x, const void* w, const void* scale,
                       const void* sizes, const void* gids, void* part, void* tickets,
                       int goff, int G, int max_chunks, int rows_per_chunk, int T,
                       int D, int Fw, int F, int kind, int splits, int tf,
                       void* out, void* stream) {
  const int nk = (D + kBK - 1) / kBK;
  const int kps = splits > 0 ? (nk + splits - 1) / splits : 0;
  const int elt = kind == kBF16 ? 2 : 1;
  if (rows_per_chunk != kBM || G < 1 || max_chunks > 65535 || splits < 1 ||
      splits > 65535 || (splits - 1) * kps >= nk || D % 8 != 0 ||
      (Fw * elt) % 16 != 0 || tf <= 0 || Fw % tf != 0 || (tf * elt) % 16 != 0 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.scale = static_cast<const float*>(scale);
  a.sizes = static_cast<const int32_t*>(sizes);
  a.gids = static_cast<const int32_t*>(gids);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int32_t*>(tickets);
  a.G = G;
  a.goff = goff;
  a.T = T;
  a.D = D;
  a.Fw = Fw;
  a.F = F;
  a.kps = kps;
  a.splits = splits;
  a.tf = tf;
  a.out = static_cast<float*>(out);
  const dim3 grid((Fw + kBN - 1) / kBN, splits, max_chunks);
  const int mt = (std::min(T, kBM) + 15) / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBF16:
      return launch_kind<kBF16>(a, grid, mt, st);
    case kINT8:
      return launch_kind<kINT8>(a, grid, mt, st);
    case kINT4:
      return launch_kind<kINT4>(a, grid, mt, st);
    case kE4M3:
      return launch_kind<kE4M3>(a, grid, mt, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
