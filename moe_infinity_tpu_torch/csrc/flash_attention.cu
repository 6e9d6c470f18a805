// Hand-written Hopper attention kernels: head_dim 128 (K1, K2, K4) and the
// absorbed-MLA decode over a 512 + 64 wide latent cache (K5).
//
// flash_decode_kernel  replaces moe_infinity_tpu/ops/flash_attention.py
//                      _decode_kernel / flash_decode (one query token).
// flash_attend_kernel  replaces _attend_kernel / flash_attend (T >= 1, with
//                      additive bias, causal and pad masks).
// paged_decode_kernel  replaces _paged_decode_kernel / paged_flash_decode
//                      (one query token over a paged K/V pool).
// mla_decode_kernel    replaces _mla_decode_kernel / mla_flash_decode (one
//                      query token of DeepSeek's absorbed MLA; its own note
//                      stands above it).
//
// All keep the TPU kernels' arithmetic: scores and softmax in f32, online
// softmax with the finite kNeg, a row with no valid key returns 0, softcap
// before the bias. flash_attend rounds p to V's type before P.V, as the TPU
// kernel does; the decode kernels keep p in f32, as theirs do.
//
// What bounds them on the H100: at the serving paths' shapes (S <= a few
// hundred keys, B*H <= 128 heads) all are bound by launch latency and by the
// bytes of the live K/V rows; none comes near the tensor cores. So the
// design reads each live K/V row once per block, from device memory, with
// 8-byte (bf16) or 16-byte (f32) loads per lane, and never reads rows past
// the live length (kv_len, and the causal bound). Scores and P.V run on the
// CUDA cores; a tensor-core (wgmma) version is later work.
#include "common.cuh"

namespace {

constexpr int kDh = 128;  // each lane owns 4 of the 128 head dims

// ---------------------------------------------------------------------------
// Decode: grid (Hkv, B). One block serves all `rep` query heads of one kv
// head, so the cache rows of that head are read once. Each warp walks every
// kDecWarps-th live key with its own online-softmax state; the warps merge
// through shared memory at the end. The contiguous kernel (K1) and the paged
// one (K4) share this body and differ only in where key s's row lives.
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 4;

// Row of key s (kv head hk) in a contiguous [B, S, Hkv, Dh] cache.
struct ContigRows {
  size_t base;  // element offset of (b, 0, hk, 0)
  size_t srow;  // Hkv * Dh
  __device__ __forceinline__ size_t operator()(int s) const {
    return base + (size_t)s * srow;
  }
};

// Row of logical key s in a [NP, page, Hkv, Dh] pool: physical page
// table[s / page], slot s % page.
struct PagedRows {
  const int32_t* table;  // page_table row b, [P]
  size_t hoff;           // hk * Dh
  size_t srow;           // Hkv * Dh
  int page;
  __device__ __forceinline__ size_t operator()(int s) const {
    const int p = s / page;
    return ((size_t)table[p] * page + (s - p * page)) * srow + hoff;
  }
};

// Attention of the rep query heads of (b, hk) over the live keys
// [0, row_len), skipping keys whose mask byte is 0. A row with no valid key
// gives 0. Scale, then softcap, then mask, with f32 sums, as the TPU kernels.
template <typename T, int MAXR, typename Rows>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mrow, T* __restrict__ out, Rows rows, int b,
    int hk, int H, int rep, int row_len, float scale, float softcap) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float qr[MAXR][4], m[MAXR], l[MAXR], acc[MAXR][4];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    m[r] = mit::kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[r][i] = 0.f;
      qr[r][i] = 0.f;
    }
    if (r < rep)
      mit::load4(q + ((size_t)b * H + (size_t)hk * rep + r) * kDh + lane * 4,
                 qr[r]);
  }

  for (int s = warp; s < row_len; s += kDecWarps) {
    if (mrow && !mrow[s]) continue;  // uniform across the warp
    const size_t off = rows(s) + lane * 4;
    float kf[4], vf[4];
    mit::load4(k + off, kf);
    mit::load4(v + off, vf);
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r >= rep) break;
      float sc = mit::warp_sum(qr[r][0] * kf[0] + qr[r][1] * kf[1] +
                               qr[r][2] * kf[2] + qr[r][3] * kf[3]) *
                 scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      const float mn = fmaxf(m[r], sc);
      const float alpha = expf(m[r] - mn);
      const float p = expf(sc - mn);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = acc[r][i] * alpha + p * vf[i];
      m[r] = mn;
    }
  }

  __shared__ float sm_m[kDecWarps][MAXR];
  __shared__ float sm_l[kDecWarps][MAXR];
  __shared__ float sm_acc[kDecWarps][MAXR][kDh];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][r][lane * 4 + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * kDh; idx += blockDim.x) {
    const int r = idx / kDh, d = idx % kDh;
    float M = mit::kNeg;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = expf(sm_m[w][r] - M);
      L += sm_l[w][r] * c;
      A += sm_acc[w][r][d] * c;
    }
    mit::store(out + ((size_t)b * H + (size_t)hk * rep + r) * kDh + d,
               L > 0.f ? A / L : 0.f);
  }
}

template <typename T, int MAXR>
__global__ void __launch_bounds__(kDecWarps * 32) flash_decode_kernel(
    const T* __restrict__ q,            // [B, H, Dh]
    const T* __restrict__ k,            // [B, S, Hkv, Dh]
    const T* __restrict__ v,            // [B, S, Hkv, Dh]
    const int32_t* __restrict__ qpos,   // [B]
    const uint8_t* __restrict__ mask,   // [B, S] or null
    T* __restrict__ out,                // [B, H, Dh]
    int H, int Hkv, int S, int rep, int kv_len, int causal, float scale,
    float softcap) {
  const int hk = blockIdx.x, b = blockIdx.y;
  int row_len = min(kv_len, S);
  if (causal) row_len = min(row_len, qpos[b] + 1);
  const size_t srow = (size_t)Hkv * kDh;
  const ContigRows rows{(size_t)b * S * srow + (size_t)hk * kDh, srow};
  decode_block<T, MAXR>(q, k, v, mask ? mask + (size_t)b * S : nullptr, out,
                        rows, b, hk, H, rep, row_len, scale, softcap);
}

// K4: replaces moe_infinity_tpu/ops/flash_attention.py _paged_decode_kernel /
// paged_flash_decode. Pages are read in place through the page table (no
// gathered copy of the pool); the hole mask is logical, [B, P * page].
// Bound on the H100 by the live K/V bytes and, at decode batch 4, by launch
// latency; like K1 it reads no row at or past the row's live length.
template <typename T, int MAXR>
__global__ void __launch_bounds__(kDecWarps * 32) paged_decode_kernel(
    const T* __restrict__ q,              // [B, H, Dh]
    const T* __restrict__ pool_k,         // [NP, page, Hkv, Dh]
    const T* __restrict__ pool_v,         // [NP, page, Hkv, Dh]
    const int32_t* __restrict__ table,    // [B, P] physical page ids
    const int32_t* __restrict__ lengths,  // [B] live keys per row
    const uint8_t* __restrict__ mask,     // [B, P * page] or null
    T* __restrict__ out,                  // [B, H, Dh]
    int H, int Hkv, int P, int page, int rep, float scale, float softcap) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int S = P * page;
  const int row_len = max(0, min(lengths[b], S));
  const PagedRows rows{table + (size_t)b * P, (size_t)hk * kDh,
                       (size_t)Hkv * kDh, page};
  decode_block<T, MAXR>(q, pool_k, pool_v,
                        mask ? mask + (size_t)b * S : nullptr, out, rows, b,
                        hk, H, rep, row_len, scale, softcap);
}

// ---------------------------------------------------------------------------
// General attention: grid (ceil(T/kBT), H, B). A block owns kBT query rows
// of one head (each output row has exactly one owner) and walks the live key
// range in tiles of kBS keys staged in shared memory. In the score phase lane
// j owns key j of the tile; in the P.V phase lane j owns head dims
// [4j, 4j+4). Each warp carries the online-softmax state of 4 query rows.
// ---------------------------------------------------------------------------
constexpr int kBT = 16;
constexpr int kBS = 32;
constexpr int kAttWarps = 4;
constexpr int kRows = kBT / kAttWarps;

template <typename T>
__global__ void __launch_bounds__(kAttWarps * 32) flash_attend_kernel(
    const T* __restrict__ q,             // [B, T, H, Dh]
    const T* __restrict__ k,             // [B, S, Hkv, Dh]
    const T* __restrict__ v,             // [B, S, Hkv, Dh]
    const int32_t* __restrict__ qpos,    // [B, T]
    const float* __restrict__ bias,      // strided [B|1, H|1, T|1, S] or null
    long long bsb, long long bsh, long long bst,
    const uint8_t* __restrict__ mask,    // [B, S] or null
    T* __restrict__ out,                 // [B, T, H, Dh]
    int Tq, int H, int Hkv, int S, int kv_len, int causal, float scale,
    float softcap) {
  __shared__ float q_s[kBT][kDh];
  __shared__ float k_s[kBS][kDh + 1];  // +1: lane j reads row j conflict-free
  __shared__ __align__(16) float v_s[kBS][kDh];

  const int t0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qstride = (size_t)H * kDh;
  const size_t kstride = (size_t)Hkv * kDh;

  for (int i = tid; i < kBT * (kDh / 4); i += blockDim.x) {
    const int r = i / (kDh / 4), c = (i % (kDh / 4)) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t0 + r < Tq)
      mit::load4(q + ((size_t)b * Tq + t0 + r) * qstride + (size_t)h * kDh + c,
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

  float m[kRows], l[kRows], acc[kRows][4];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = mit::kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[rr][i] = 0.f;
  }

  for (int s0 = 0; s0 < kv_end; s0 += kBS) {
    __syncthreads();  // the previous tile is consumed; q_s is staged
    for (int i = tid; i < kBS * (kDh / 4); i += blockDim.x) {
      const int j = i / (kDh / 4), c = (i % (kDh / 4)) * 4;
      float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (s0 + j < kv_end) {  // rows past the live range stay zero
        const size_t off =
            ((size_t)b * S + s0 + j) * kstride + (size_t)hk * kDh + c;
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
    for (int d = 0; d < kDh; ++d) {
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
      const float pb = mit::round_as(p, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kBS; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pb, j);
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][lane * 4]);
        acc[rr][0] = fmaf(pj, vv.x, acc[rr][0]);
        acc[rr][1] = fmaf(pj, vv.y, acc[rr][1]);
        acc[rr][2] = fmaf(pj, vv.z, acc[rr][2]);
        acc[rr][3] = fmaf(pj, vv.w, acc[rr][3]);
      }
      m[rr] = mn;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (!row_ok[rr]) continue;
    const int t = t0 + warp * kRows + rr;
    T* o = out + ((size_t)b * Tq + t) * qstride + (size_t)h * kDh + lane * 4;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mit::store(o + i, l[rr] > 0.f ? acc[rr][i] * inv : 0.f);
  }
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* qpos, const void* mask, void* out, int B, int H,
                  int Hkv, int S, int kv_len, int causal, float scale,
                  float softcap, cudaStream_t stream) {
  const int rep = H / Hkv;
  const dim3 grid(Hkv, B);
  const int threads = kDecWarps * 32;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int32_t* pp = static_cast<const int32_t*>(qpos);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* op = static_cast<T*>(out);
#define MIT_DECODE(R)                                                       \
  flash_decode_kernel<T, R><<<grid, threads, 0, stream>>>(                  \
      qp, kp, vp, pp, mp, op, H, Hkv, S, rep, kv_len, causal, scale, softcap)
  if (rep <= 1)
    MIT_DECODE(1);
  else if (rep <= 2)
    MIT_DECODE(2);
  else if (rep <= 4)
    MIT_DECODE(4);
  else if (rep <= 8)
    MIT_DECODE(8);
  else
    return (int)cudaErrorInvalidValue;
#undef MIT_DECODE
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged(const void* q, const void* pool_k, const void* pool_v,
                 const void* table, const void* lengths, const void* mask,
                 void* out, int B, int H, int Hkv, int P, int page,
                 float scale, float softcap, cudaStream_t stream) {
  const int rep = H / Hkv;
  const dim3 grid(Hkv, B);
  const int threads = kDecWarps * 32;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(pool_k);
  const T* vp = static_cast<const T*>(pool_v);
  const int32_t* tp = static_cast<const int32_t*>(table);
  const int32_t* lp = static_cast<const int32_t*>(lengths);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* op = static_cast<T*>(out);
#define MIT_PAGED(R)                                                        \
  paged_decode_kernel<T, R><<<grid, threads, 0, stream>>>(                  \
      qp, kp, vp, tp, lp, mp, op, H, Hkv, P, page, rep, scale, softcap)
  if (rep <= 1)
    MIT_PAGED(1);
  else if (rep <= 2)
    MIT_PAGED(2);
  else if (rep <= 4)
    MIT_PAGED(4);
  else if (rep <= 8)
    MIT_PAGED(8);
  else
    return (int)cudaErrorInvalidValue;
#undef MIT_PAGED
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attend(const void* q, const void* k, const void* v,
                  const void* qpos, const void* bias, long long bsb,
                  long long bsh, long long bst, const void* mask, void* out,
                  int B, int Tq, int H, int Hkv, int S, int kv_len,
                  int causal, float scale, float softcap,
                  cudaStream_t stream) {
  const dim3 grid((Tq + kBT - 1) / kBT, H, B);
  flash_attend_kernel<T><<<grid, kAttWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const float*>(bias), bsb, bsh, bst,
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), Tq, H, Hkv, S,
      kv_len, causal, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5, absorbed-MLA decode: replaces moe_infinity_tpu/ops/flash_attention.py
// _mla_decode_kernel / mla_flash_decode.
//   score[h, s] = (q_lat[h] . c[s] + q_pe[h] . k_pe[s]) * scale
//   out[h]      = sum_s softmax(score)[h, s] * c[s]
// The values are the latent itself and one key stream serves every head.
// q, scores, p and the sums are f32 whatever the cache type (p is not rounded
// before p.c, as in the TPU kernel); a row with no valid key gives 0; no key
// at or past row_len = min(kv_len, qpos + 1, S) is read, nor one whose mask
// byte is 0.
//
// What bounds it on the H100: a V2-Lite decode step reads a few hundred keys
// of 1,152 bytes per batch row, about 1 MB in all, so the byte bound is well
// under a microsecond and the kernel is bound by launch latency and by how
// many SMs it reaches. The TPU kernel's grid of one program per batch row
// would fill 4 of 132 SMs. Here block (split, head group, b) owns kMlaHeads
// heads of one batch row over one contiguous range of `kc` keys, walks it in
// tiles of kMlaKeys keys staged in shared memory as f32, and writes its
// online-softmax state (m, l) and its unnormalised [heads, R] sum to scratch;
// mla_merge_kernel combines the live splits of a row. The wrapper picks kc so
// that the splits of all rows come to about two blocks per SM. The head groups
// of a row re-read the same keys, which hit L2. Both products run on the CUDA
// cores from shared memory; a tensor-core version is later work.
//
// In a block of 256 threads: score phase, thread (key s = t % 16, head
// h = t / 16) takes the 576-long dot product, and the 16 lanes of a head
// reduce max and sum by shuffles, each keeping the head's (m, l); value
// phase, thread (4 latent columns, 8 heads) accumulates p[s, h] * c[s, cols]
// in registers.
// ---------------------------------------------------------------------------
constexpr int kMlaR = 512;       // latent width (the value width)
constexpr int kMlaP = 64;        // rope key width
constexpr int kMlaW = kMlaR + kMlaP;
constexpr int kMlaHeads = 16;    // heads per block
constexpr int kMlaKeys = 16;     // keys per tile
constexpr int kMlaThreads = 256;
constexpr int kMlaKeyStride = kMlaW + 4;  // rows 4 banks apart: 16-byte reads
                                          // of 16 rows meet in pairs only
constexpr int kMlaSmemFloats = kMlaHeads * kMlaW + kMlaKeys * kMlaKeyStride +
                               kMlaKeys * kMlaHeads + kMlaHeads + kMlaKeys;

__device__ __forceinline__ int mla_row_len(const int32_t* qpos, int b, int S,
                                           int kv_len) {
  return max(0, min(min(kv_len, S), qpos[b] + 1));
}

template <typename T>
__global__ void __launch_bounds__(kMlaThreads) mla_decode_kernel(
    const float* __restrict__ q_lat,    // [B, H, R]
    const float* __restrict__ q_pe,     // [B, H, P]
    const T* __restrict__ c,            // [B, S, R]
    const T* __restrict__ kpe,          // [B, S, P]
    const int32_t* __restrict__ qpos,   // [B]
    const uint8_t* __restrict__ mask,   // [B, S] or null
    float* __restrict__ part_acc,       // [B, NS, H, R]
    float* __restrict__ part_ml,        // [B, NS, H, 2]
    int H, int S, int kv_len, int kc, int NS, float scale) {
  extern __shared__ __align__(16) float mla_smem[];
  float* q_s = mla_smem;                            // [heads][W]
  float* key_s = q_s + kMlaHeads * kMlaW;           // [keys][W + 4]
  float* p_s = key_s + kMlaKeys * kMlaKeyStride;    // [keys][heads]
  float* alpha_s = p_s + kMlaKeys * kMlaHeads;      // [heads]
  int* valid_s = reinterpret_cast<int*>(alpha_s + kMlaHeads);  // [keys]

  const int split = blockIdx.x, h0 = blockIdx.y * kMlaHeads, b = blockIdx.z;
  const int row_len = mla_row_len(qpos, b, S, kv_len);
  const int k_begin = split * kc;
  if (k_begin >= row_len) return;  // a split past the live keys owns nothing
  const int k_end = min(k_begin + kc, row_len);
  const int tid = threadIdx.x;

  // the block's queries: [q_lat | q_pe] per head, zero for a head past H
  for (int i = tid; i < kMlaHeads * (kMlaW / 4); i += kMlaThreads) {
    const int h = i / (kMlaW / 4), g = i % (kMlaW / 4);
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (h0 + h < H) {
      const size_t row = (size_t)b * H + h0 + h;
      if (g < kMlaR / 4)
        mit::load4(q_lat + row * kMlaR + g * 4, f);
      else
        mit::load4(q_pe + row * kMlaP + (g - kMlaR / 4) * 4, f);
    }
    *reinterpret_cast<float4*>(q_s + h * kMlaW + g * 4) =
        make_float4(f[0], f[1], f[2], f[3]);
  }

  const int s_own = tid & (kMlaKeys - 1), h_own = tid / kMlaKeys;  // scores
  const int cg = tid & 127, hg = tid >> 7;                         // values
  float m_run = mit::kNeg, l_run = 0.f;
  float acc[8][4];
#pragma unroll
  for (int hh = 0; hh < 8; ++hh)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[hh][j] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += kMlaKeys) {
    __syncthreads();  // the previous tile is consumed; q_s is staged
    if (tid < kMlaKeys) {
      const int ks = t0 + tid;
      valid_s[tid] =
          ks < k_end && (mask == nullptr || mask[(size_t)b * S + ks] != 0);
    }
    __syncthreads();
    // stage the tile as f32: [c | k_pe] per key, zero for a key not read
    for (int i = tid; i < kMlaKeys * (kMlaW / 4); i += kMlaThreads) {
      const int s = i / (kMlaW / 4), g = i % (kMlaW / 4);
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (valid_s[s]) {
        const size_t row = (size_t)b * S + t0 + s;
        if (g < kMlaR / 4)
          mit::load4(c + row * kMlaR + g * 4, f);
        else
          mit::load4(kpe + row * kMlaP + (g - kMlaR / 4) * 4, f);
      }
      *reinterpret_cast<float4*>(key_s + s * kMlaKeyStride + g * 4) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
    __syncthreads();

    // scores of (key s_own, head h_own), then the head's online softmax
    // among its 16 lanes
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
    sc = ok ? sc * scale : mit::kNeg;
    float mx = sc;
#pragma unroll
    for (int o = kMlaKeys / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    const float p = ok ? expf(sc - m_new) : 0.f;
    float ps = p;
#pragma unroll
    for (int o = kMlaKeys / 2; o > 0; o >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
    l_run = l_run * alpha + ps;
    m_run = m_new;
    p_s[s_own * kMlaHeads + h_own] = p;
    if (s_own == 0) alpha_s[h_own] = alpha;
    __syncthreads();

    // values: acc[h, cols] = acc * alpha[h] + sum_s p[s, h] * c[s, cols]
#pragma unroll
    for (int hh = 0; hh < 8; ++hh) {
      const float a = alpha_s[hg * 8 + hh];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hh][j] *= a;
    }
#pragma unroll 4
    for (int s = 0; s < kMlaKeys; ++s) {
      const float4 cv =
          *reinterpret_cast<const float4*>(key_s + s * kMlaKeyStride + cg * 4);
      const float4 pa =
          *reinterpret_cast<const float4*>(p_s + s * kMlaHeads + hg * 8);
      const float4 pb =
          *reinterpret_cast<const float4*>(p_s + s * kMlaHeads + hg * 8 + 4);
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

  // this split's state, one writer per element
  const size_t base = ((size_t)b * NS + split) * H;
  if (s_own == 0 && h0 + h_own < H) {
    part_ml[(base + h0 + h_own) * 2] = m_run;
    part_ml[(base + h0 + h_own) * 2 + 1] = l_run;
  }
#pragma unroll
  for (int hh = 0; hh < 8; ++hh) {
    const int h = h0 + hg * 8 + hh;
    if (h < H)
      *reinterpret_cast<float4*>(part_acc + (base + h) * kMlaR + cg * 4) =
          make_float4(acc[hh][0], acc[hh][1], acc[hh][2], acc[hh][3]);
  }
}

// Combine the live splits of (b, h): grid (H, B), thread = 4 latent columns.
__global__ void __launch_bounds__(kMlaR / 4) mla_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ qpos, float* __restrict__ out,  // [B, H, R]
    int H, int S, int kv_len, int kc, int NS) {
  const int h = blockIdx.x, b = blockIdx.y, cg = threadIdx.x;
  const int row_len = mla_row_len(qpos, b, S, kv_len);
  const int live = min(NS, (row_len + kc - 1) / kc);
  float M = mit::kNeg;
  for (int j = 0; j < live; ++j)
    M = fmaxf(M, part_ml[(((size_t)b * NS + j) * H + h) * 2]);
  float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < live; ++j) {
    const size_t row = ((size_t)b * NS + j) * H + h;
    const float w = expf(part_ml[row * 2] - M);
    L += part_ml[row * 2 + 1] * w;
    const float4 a =
        *reinterpret_cast<const float4*>(part_acc + row * kMlaR + cg * 4);
    A[0] = fmaf(a.x, w, A[0]);
    A[1] = fmaf(a.y, w, A[1]);
    A[2] = fmaf(a.z, w, A[2]);
    A[3] = fmaf(a.w, w, A[3]);
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  *reinterpret_cast<float4*>(out + ((size_t)b * H + h) * kMlaR + cg * 4) =
      make_float4(A[0] * inv, A[1] * inv, A[2] * inv, A[3] * inv);
}

template <typename T>
int launch_mla(const void* q_lat, const void* q_pe, const void* c,
               const void* kpe, const void* qpos, const void* mask,
               void* part_acc, void* part_ml, void* out, int B, int H, int S,
               int kv_len, int kc, int NS, float scale, cudaStream_t stream) {
  const int smem = kMlaSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int32_t* pp = static_cast<const int32_t*>(qpos);
  const dim3 grid(NS, (H + kMlaHeads - 1) / kMlaHeads, B);
  mla_decode_kernel<T><<<grid, kMlaThreads, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const T*>(c), static_cast<const T*>(kpe), pp,
      static_cast<const uint8_t*>(mask), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, S, kv_len, kc, NS, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_merge_kernel<<<dim3(H, B), kMlaR / 4, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      pp, static_cast<float*>(out), H, S, kv_len, kc, NS);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mit_flash_decode(const void* q, const void* k, const void* v,
                                const void* qpos, const void* mask, void* out,
                                int B, int H, int Hkv, int S, int kv_len,
                                int causal, float scale, float softcap,
                                int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_decode<__nv_bfloat16>(q, k, v, qpos, mask, out, B, H, Hkv,
                                        S, kv_len, causal, scale, softcap, st);
  return launch_decode<float>(q, k, v, qpos, mask, out, B, H, Hkv, S, kv_len,
                              causal, scale, softcap, st);
}

extern "C" int mit_flash_attend(const void* q, const void* k, const void* v,
                                const void* qpos, const void* bias,
                                long long bsb, long long bsh, long long bst,
                                const void* mask, void* out, int B, int Tq,
                                int H, int Hkv, int S, int kv_len, int causal,
                                float scale, float softcap, int is_bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_attend<__nv_bfloat16>(q, k, v, qpos, bias, bsb, bsh, bst,
                                        mask, out, B, Tq, H, Hkv, S, kv_len,
                                        causal, scale, softcap, st);
  return launch_attend<float>(q, k, v, qpos, bias, bsb, bsh, bst, mask, out,
                              B, Tq, H, Hkv, S, kv_len, causal, scale,
                              softcap, st);
}

extern "C" int mit_paged_flash_decode(const void* q, const void* pool_k,
                                      const void* pool_v, const void* table,
                                      const void* lengths, const void* mask,
                                      void* out, int B, int H, int Hkv, int P,
                                      int page, float scale, float softcap,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_paged<__nv_bfloat16>(q, pool_k, pool_v, table, lengths,
                                       mask, out, B, H, Hkv, P, page, scale,
                                       softcap, st);
  return launch_paged<float>(q, pool_k, pool_v, table, lengths, mask, out, B,
                             H, Hkv, P, page, scale, softcap, st);
}

// R and P must be 512 and 64 (every published DeepSeek MLA geometry); kc is
// the keys per split and NS >= ceil(min(kv_len, S) / kc) the scratch's split
// dimension.
extern "C" int mit_mla_flash_decode(const void* q_lat, const void* q_pe,
                                    const void* c, const void* kpe,
                                    const void* qpos, const void* mask,
                                    void* part_acc, void* part_ml, void* out,
                                    int B, int H, int S, int R, int P,
                                    int kv_len, int kc, int NS, float scale,
                                    int is_bf16, void* stream) {
  const int live_max = kv_len < S ? kv_len : S;
  if (R != kMlaR || P != kMlaP || kc <= 0 || NS <= 0 ||
      (long long)NS * kc < live_max || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mla<__nv_bfloat16>(q_lat, q_pe, c, kpe, qpos, mask, part_acc,
                                     part_ml, out, B, H, S, kv_len, kc, NS,
                                     scale, st);
  return launch_mla<float>(q_lat, q_pe, c, kpe, qpos, mask, part_acc, part_ml,
                           out, B, H, S, kv_len, kc, NS, scale, st);
}
