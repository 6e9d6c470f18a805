// Hand-written Hopper grouped matmul with fused weight dequantization.
//
// Replaces moe_infinity_tpu/ops/gmm.py _gmm_kernel / gmm:
//   out[r, :] = bf16(x[r, :]) @ bf16(w[group_ids[g] + group_offset]) * scale
// for the rows r of group g (rows are sorted by group; group g owns rows
// [group_start[g], group_start[g+1])). f32 accumulation, the per-output
// channel scale applied after the dot. Weights: bf16, int8, or split-nibble
// packed int4 (byte c of a row holds output channel c
// in its low nibble and channel c + F/2 in its high nibble, sign-extended).
//
// What bounds it on the H100: on the NLLB path every group holds a handful of
// rows (4 requests x top-2 at decode: 8 rows over <= 8 experts), so each
// expert slab is read once for a few rows of work and the kernel is bound by
// the routed experts' weight bytes (16.8 MB per int4 expert), at 3.35 TB/s.
// The design therefore (a) reads each routed slab exactly once per row chunk
// of up to 8 rows, with coalesced 4-byte loads per lane (128 bytes per warp
// per weight row), (b) moves and computes nothing for an empty group - it
// owns no chunk, so cost follows routed groups, not slots - and (c) unpacks
// the nibbles in registers with arithmetic shifts, so packed int4 costs half
// the bytes of int8. The products run on the CUDA cores, so a prefill-sized
// call (hundreds of rows) is bound by them instead; a tensor-core (wgmma)
// version for large groups is later work.
//
// Ownership: the rows of each group are cut into chunks of up to kRM rows,
// and block (tile, c) owns output columns of tile `tile` for the rows of
// chunk c. Groups own disjoint row ranges, so every output element has one
// writer and no block carries state to another; a group that routes many
// rows spreads over many blocks instead of serialising in one. The wrapper
// passes the cumulative chunk counts; the grid's chunk axis is an upper bound
// (rows / kRM + groups) and the blocks past the last chunk return at once.
// Rows outside every group are left as the caller initialised them (zero).
#include "common.cuh"

namespace {

enum WKind { kBF16 = 0, kINT8 = 1, kINT4 = 2 };

template <int KIND>
struct W;

template <>
struct W<kBF16> {
  using S = __nv_bfloat16;
  static constexpr int NOUT = 4;
  __device__ static void load(const S* p, float w[4]) { mit::load4(p, w); }
};

template <>
struct W<kINT8> {
  using S = int8_t;
  static constexpr int NOUT = 4;
  __device__ static void load(const S* p, float w[4]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (float)((int32_t)(u << (24 - 8 * j)) >> 24);
  }
};

template <>
struct W<kINT4> {
  using S = int8_t;
  static constexpr int NOUT = 8;  // 4 low-nibble + 4 high-nibble channels
  __device__ static void load(const S* p, float w[8]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = (float)((int32_t)(u << (28 - 8 * j)) >> 28);      // low nibble
      w[4 + j] = (float)((int32_t)(u << (24 - 8 * j)) >> 28);  // high nibble
    }
  }
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // storage columns per block: 32 lanes x 4
constexpr int kRM = 8;      // rows per chunk
constexpr int kKC = 256;    // reduction depth staged per step

struct Args {
  const __nv_bfloat16* x;  // [T, D]
  const void* w;           // [S, D, Fw]
  const float* scale;      // [S, F] or null
  const int32_t* gstart;   // [G + 1] first row of each group
  const int32_t* cchunk;   // [G + 1] first chunk of each group
  const int32_t* gids;     // [G]
  int G, goff, D, Fw, F;
  float* out;              // [T, F]
};

// One chunk of R (>= live rows) rows of a group: the block's warps split the
// reduction dimension; lane l holds 4 storage columns of every row.
template <int KIND, int R>
__device__ __forceinline__ void gmm_chunk(const Args& a, int gw, int r0,
                                          int nr, float (*xs)[kKC],
                                          float (*red)[8][32]) {
  using Tr = W<KIND>;
  constexpr int NOUT = Tr::NOUT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int u0 = blockIdx.x * kTile + lane * 4;
  const bool col_ok = u0 < a.Fw;
  const typename Tr::S* wg =
      static_cast<const typename Tr::S*>(a.w) + (size_t)gw * a.D * a.Fw;

  float acc[R][NOUT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NOUT; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < a.D; k0 += kKC) {
    const int kc = min(kKC, a.D - k0);
    __syncthreads();  // xs and red of the previous step are consumed
    for (int i = tid; i < R * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC;
      xs[r][kk] = (r < nr && kk < kc)
                      ? __bfloat162float(a.x[(size_t)(r0 + r) * a.D + k0 + kk])
                      : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      const typename Tr::S* wk = wg + (size_t)k0 * a.Fw + u0;
#pragma unroll 4
      for (int kk = warp; kk < kc; kk += kWarps) {
        float wv[NOUT];
        Tr::load(wk + (size_t)kk * a.Fw, wv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = xs[r][kk];
#pragma unroll
          for (int j = 0; j < NOUT; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
        }
      }
    }
  }

  // reduce the warps' partial sums row by row, apply the scale, store
  const int half = (KIND == kINT4) ? a.Fw : 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) break;  // nr is uniform across the block
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NOUT; ++j) red[warp][j][lane] = acc[r][j];
    __syncthreads();
    for (int idx = tid; idx < NOUT * 32; idx += kThreads) {
      const int j = idx / 32, ln = idx % 32;
      const int u = blockIdx.x * kTile + ln * 4;
      if (u >= a.Fw) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][j][ln];
      const int col = (j < 4) ? u + j : half + u + (j - 4);
      if (a.scale != nullptr) s *= a.scale[(size_t)gw * a.F + col];
      a.out[(size_t)(r0 + r) * a.F + col] = s;
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) gmm_kernel(Args a) {
  __shared__ float xs[kRM][kKC];
  __shared__ float red[kWarps][8][32];
  const int c = blockIdx.y;
  if (c >= a.cchunk[a.G]) return;  // past the last chunk: nothing to do
  // the group owning chunk c: the last g with cchunk[g] <= c (an empty
  // group has no chunk, so it is never chosen and moves no bytes)
  int lo = 0, hi = a.G;  // cchunk[lo] <= c < cchunk[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a.cchunk[mid] <= c)
      lo = mid;
    else
      hi = mid;
  }
  const int r0 = a.gstart[lo] + (c - a.cchunk[lo]) * kRM;
  const int nr = min(kRM, a.gstart[lo + 1] - r0);
  const int gw = a.gids[lo] + a.goff;
  if (nr > 4)
    gmm_chunk<KIND, 8>(a, gw, r0, nr, xs, red);
  else if (nr > 2)
    gmm_chunk<KIND, 4>(a, gw, r0, nr, xs, red);
  else if (nr > 1)
    gmm_chunk<KIND, 2>(a, gw, r0, nr, xs, red);
  else
    gmm_chunk<KIND, 1>(a, gw, r0, nr, xs, red);
}

}  // namespace

// rows_per_chunk must equal kRM (the wrapper's chunk counts assume it);
// max_chunks bounds the chunk count (rows / kRM + G) and sizes the grid.
extern "C" int mit_gmm(const void* x, const void* w, const void* scale,
                       const void* gstart, const void* cchunk,
                       const void* gids, int goff, int G, int max_chunks,
                       int rows_per_chunk, int D, int Fw, int F, int kind,
                       void* out, void* stream) {
  if (rows_per_chunk != kRM || max_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.scale = static_cast<const float*>(scale);
  a.gstart = static_cast<const int32_t*>(gstart);
  a.cchunk = static_cast<const int32_t*>(cchunk);
  a.gids = static_cast<const int32_t*>(gids);
  a.G = G;
  a.goff = goff;
  a.D = D;
  a.Fw = Fw;
  a.F = F;
  a.out = static_cast<float*>(out);
  const dim3 grid((Fw + kTile - 1) / kTile, max_chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBF16:
      gmm_kernel<kBF16><<<grid, kThreads, 0, st>>>(a);
      break;
    case kINT8:
      gmm_kernel<kINT8><<<grid, kThreads, 0, st>>>(a);
      break;
    case kINT4:
      gmm_kernel<kINT4><<<grid, kThreads, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
