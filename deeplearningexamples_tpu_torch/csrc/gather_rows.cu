// Embedding row gather for Hopper (sm_90a), written by hand:
// out[n, :] = table[idx[n], :].
//
// Replaces the TPU Pallas kernel of deeplearningexamples_tpu/ops/embedding.py,
// pallas_gather_rows -> _gather_kernel, which keeps 16 row DMAs in flight per
// grid step of 1024 indices held in SMEM. None of that carries over: here any
// N is taken, each warp loads its own indices, and the many warps resident on
// every SM keep thousands of row reads in flight.
//
// Semantics at the edges are jnp.take's (the JAX model's gather): an index in
// [-V, 0) wraps to row V + idx; any other index outside [0, V) gives a row of
// NaN (0x7fc00000 in fp32, 0x7fc0 in bf16). The kernel never reads outside
// the table.
//
// What bounds it on this card: device memory. A gather moves bytes and does
// no arithmetic: the distinct rows it reads, N rows written and N indices.
// At DLRM's shape (1,703,936 indices into a 2.6M x 128 fp32 table) that is
// about 640 MB of distinct 512-byte rows in and 872 MB out. What the design
// does: one warp per row, each lane moving 16 bytes (one uint4), so a
// 128-wide fp32 row is one warp instruction (a bf16 row takes 16 lanes); each
// warp takes UNROLL consecutive output rows at a time, so its UNROLL row reads
// are in flight together and its stores fill whole lines; a grid of 8 blocks
// of 256 threads per SM strides over the rest. Output rows are stored with
// the streaming hint, as nothing reads them back before they leave L2; table
// rows keep the normal policy, so a skewed batch's hot rows stay in L2.
// A row whose byte width is not a multiple of 16, or a table or output not
// 16-byte aligned, takes the same loop in 4-byte (fp32) or 2-byte (bf16)
// units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ uint4 load(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint32_t load(const uint32_t* p) { return __ldg(p); }
__device__ __forceinline__ uint16_t load(const uint16_t* p) { return __ldg(p); }

__device__ __forceinline__ void store(uint4* p, uint4 x) { __stcs(p, x); }
__device__ __forceinline__ void store(uint32_t* p, uint32_t x) {
  __stcs(reinterpret_cast<unsigned int*>(p), x);
}
__device__ __forceinline__ void store(uint16_t* p, uint16_t x) {
  __stcs(reinterpret_cast<unsigned short*>(p), x);
}

// T: the unit a lane moves; units: a row's width in T; fill: a unit of NaNs.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                       T* __restrict__ out, long long n, long long v, int units,
                       T fill) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const long long n_warps = static_cast<long long>(gridDim.x) * WARPS;
  for (long long base = warp * UNROLL; base < n; base += n_warps * UNROLL) {
    long long src[UNROLL];  // table row, or -1 for a NaN row
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = base + u;
      long long i = r < n ? static_cast<long long>(__ldg(idx + r)) : v;
      if (i < 0) i += v;  // [-V, 0) wraps; below -V stays negative
      src[u] = (i >= 0 && i < v) ? i : -1;  // past the end: no read
    }
    for (int c = lane; c < units; c += 32) {
      T val[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        val[u] = src[u] >= 0 ? load(table + src[u] * units + c) : fill;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (base + u < n) store(out + (base + u) * units + c, val[u]);
    }
  }
}

template <typename T>
int launch(const void* table, const int* idx, void* out, long long n,
           long long v, int units, T fill, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_per_block = static_cast<long long>(WARPS) * UNROLL;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  gather_rows_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), n, v, units,
      fill);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. table (v, row_bytes) fp32 or bf16
// (is_bf16), idx int32 (n,), out (n, row_bytes) in the table's dtype; all
// contiguous, n > 0. Returns the launch's cudaError_t; runs on `stream`.
extern "C" int dlx_gather_rows(const void* table, const int* idx, void* out,
                               long long n, long long v, int row_bytes,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t nan32 = is_bf16 ? 0x7fc07fc0u : 0x7fc00000u;
  const bool aligned = (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (row_bytes % 16 == 0 && aligned)
    return launch<uint4>(table, idx, out, n, v, row_bytes / 16,
                         make_uint4(nan32, nan32, nan32, nan32), s);
  if (!is_bf16)
    return launch<uint32_t>(table, idx, out, n, v, row_bytes / 4, nan32, s);
  return launch<uint16_t>(table, idx, out, n, v, row_bytes / 2,
                          static_cast<uint16_t>(0x7fc0u), s);
}
