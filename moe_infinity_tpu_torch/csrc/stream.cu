// Hand-written gather of routed expert records from the pinned tier into
// device scratch, for stream decode (ops/stream.py::stream_gather).
//
// It replaces no Pallas kernel. The JAX package gathers with a traced-index
// dynamic_slice plus a device_put per unique routed expert
// (moe_infinity_tpu/ops/stream.py, gffn_stream), which XLA lowers to copies.
// On the card the record rows are computed on the device inside a CUDA
// graph, so neither cudaMemcpyAsync (its addresses are fixed when the graph
// is captured) nor index_select (it refuses a pinned host source with a
// device index) can do it: one launch per MoE layer copies U records of
// every role, reading each record where its row says, at a device address.
//
//   dst[r][u] = segment[r][rows[u] / seg_rows][rows[u] % seg_rows]   rows[u] >= 0
//   dst[r][u] = 0                                                   rows[u] <  0
//
// The source segments are page-locked host memory, read through the mapped
// address the wrapper has checked equals the host address (UVA), or device
// memory for a segment that PinnedExpertTier.layer_stack promoted. A row of
// -1 (a padding slot past the step's distinct experts, or an unstaged
// expert) reads nothing and writes zeros: no token's contribution comes
// from it, and zeros are finite. (JAX reads row 0 there; the grouped FFN's
// output is the same.)
//
// What bounds it: the bytes of the present records held in host memory
// over the host link (PCIe Gen5 x16: some 63 GB/s each way), beside which
// device bytes at 3.35 TB/s are small. The design keeps the link busy: a block
// owns a 16 KB chunk of one role of one record (grid: chunks of the whole
// record x U), each thread puts four 16-byte loads in flight before its first
// store, neighbouring threads on neighbouring addresses, and the card holds
// thousands of such blocks in flight. Loads are streaming (__ldcs): a
// record is read once. The stores stay in L2 for K3, which reads the
// scratch next.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRoles = 8;
constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte loads in flight per thread
constexpr long long kChunk = (long long)kThreads * kVecs * 16;

struct GatherArgs {
  const unsigned long long* table;  // [n_roles, n_seg] segment base addresses
  const int* rows;                  // [U] record rows, -1 for an absent record
  char* dst[kMaxRoles];             // [U, rec_bytes] scratch per role
  long long rec_bytes[kMaxRoles];   // bytes of one record's role, a multiple of 16
  long long chunk0[kMaxRoles + 1];  // first chunk of each role within a record
  int n_roles, n_seg, seg_rows;
};

__global__ void __launch_bounds__(kThreads) stream_gather_kernel(const GatherArgs a) {
  const int u = blockIdx.y;
  const long long c = blockIdx.x;
  int r = 0;
  while (r + 1 < a.n_roles && c >= a.chunk0[r + 1]) ++r;
  const int row = a.rows[u];
  const long long off = (c - a.chunk0[r]) * kChunk;
  const long long left = a.rec_bytes[r] - off;
  const int nv = (int)((left < kChunk ? left : kChunk) / 16);
  uint4* dst = reinterpret_cast<uint4*>(a.dst[r] + (long long)u * a.rec_bytes[r] + off);
  uint4 v[kVecs];
  if (row < 0) {  // the whole block takes this branch: nothing to read
#pragma unroll
    for (int i = 0; i < kVecs; ++i) v[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    const int s = row / a.seg_rows;
    const long long local = row - (long long)s * a.seg_rows;
    const uint4* src = reinterpret_cast<const uint4*>(
        a.table[(long long)r * a.n_seg + s] + local * a.rec_bytes[r] + off);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int j = threadIdx.x + i * kThreads;
      if (j < nv) v[i] = __ldcs(src + j);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j < nv) dst[j] = v[i];
  }
}

}  // namespace

// The device address at which the card reads ``p`` (through UVA the host
// address itself for page-locked memory), and the memory's type
// (cudaMemoryType: 0 unregistered, 1 host, 2 device, 3 managed).
extern "C" int mit_stream_device_pointer(const void* p, unsigned long long* dev_ptr,
                                         int* type) {
  cudaPointerAttributes at;
  const cudaError_t err = cudaPointerGetAttributes(&at, p);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it
    return (int)err;
  }
  *type = (int)at.type;
  *dev_ptr = (unsigned long long)(uintptr_t)at.devicePointer;
  return 0;
}

// rec_bytes and dst: host arrays of n_roles entries.
extern "C" int mit_stream_gather(const void* table, const void* rows, int U, int n_roles,
                                 int n_seg, int seg_rows, const long long* rec_bytes,
                                 void* const* dst, void* stream) {
  if (n_roles < 1 || n_roles > kMaxRoles || U < 1 || U > 65535 || n_seg < 1 || seg_rows < 1)
    return (int)cudaErrorInvalidValue;
  GatherArgs a;
  a.table = static_cast<const unsigned long long*>(table);
  a.rows = static_cast<const int*>(rows);
  a.n_roles = n_roles;
  a.n_seg = n_seg;
  a.seg_rows = seg_rows;
  a.chunk0[0] = 0;
  for (int r = 0; r < n_roles; ++r) {
    if (rec_bytes[r] <= 0 || rec_bytes[r] % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dst[r]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    a.dst[r] = static_cast<char*>(dst[r]);
    a.rec_bytes[r] = rec_bytes[r];
    a.chunk0[r + 1] = a.chunk0[r] + (rec_bytes[r] + kChunk - 1) / kChunk;
  }
  if (a.chunk0[n_roles] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.chunk0[n_roles], (unsigned)U);
  stream_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
