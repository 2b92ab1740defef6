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
//
// K6, hot_gather_kernel below, is the same gather with the source chosen per
// row. It replaces the TPU Pallas kernel of perf/dlrm_hotrow.py, hot_gather ->
// _hot_kernel, which holds the head (k_hot rows) of each of the joint table's
// tables in VMEM and DMAs only the cold rows from HBM. Row r of the joint
// table, in table t = r / rows_per_table at within = r % rows_per_table, is
// hot iff within < k_hot, and is then read from hot[t * k_hot + within],
// never from the table. Indices outside [0, V) give a row of NaN, read from
// neither. On this card the hot buffer (3.4 MB at DLRM's 26 x 256 x 128 fp32)
// cannot live in a block's 227 KB of shared memory; it stays in the 50 MB L2
// by use, as zipf's hot rows of the table itself do under K4. What bounds it:
// device memory, as K4; the bytes are the distinct cold rows and hot rows
// read, N rows written and N indices.

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

// K6: as gather_rows_kernel, each row's source chosen between the hot
// buffer and the table; indices outside [0, v) give a NaN row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    hot_gather_kernel(const T* __restrict__ table, const T* __restrict__ hot,
                      const int* __restrict__ idx, T* __restrict__ out,
                      long long n, long long v, unsigned rows_per_table,
                      unsigned k_hot, int units, T fill) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const long long n_warps = static_cast<long long>(gridDim.x) * WARPS;
  for (long long base = warp * UNROLL; base < n; base += n_warps * UNROLL) {
    const T* src[UNROLL];  // the row to copy, or nullptr for a NaN row
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = base + u;
      const int i = r < n ? __ldg(idx + r) : -1;
      src[u] = nullptr;
      if (i >= 0 && i < v) {
        const unsigned t = static_cast<unsigned>(i) / rows_per_table;
        const unsigned within = static_cast<unsigned>(i) - t * rows_per_table;
        src[u] = within < k_hot
                     ? hot + (static_cast<long long>(t) * k_hot + within) * units
                     : table + static_cast<long long>(i) * units;
      }
    }
    for (int c = lane; c < units; c += 32) {
      T val[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        val[u] = src[u] != nullptr ? load(src[u] + c) : fill;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (base + u < n) store(out + (base + u) * units + c, val[u]);
    }
  }
}

// Blocks for n rows: enough for every row, at most BLOCKS_PER_SM per SM (the
// kernels stride over the rest); 0 on an error, which *err then holds.
long long grid_for(long long n, cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  const long long rows_per_block = static_cast<long long>(WARPS) * UNROLL;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  return blocks > cap ? cap : blocks;
}

template <typename T>
int launch(const void* table, const int* idx, void* out, long long n,
           long long v, int units, T fill, cudaStream_t stream) {
  cudaError_t err;
  const long long blocks = grid_for(n, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), n, v, units,
      fill);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hot(const void* table, const void* hot, const int* idx, void* out,
               long long n, long long v, unsigned rows_per_table,
               unsigned k_hot, int units, T fill, cudaStream_t stream) {
  cudaError_t err;
  const long long blocks = grid_for(n, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  hot_gather_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const T*>(hot), idx,
      static_cast<T*>(out), n, v, rows_per_table, k_hot, units, fill);
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

// K6's plain C entry point. table (v, row_bytes) and hot (v / rows_per_table
// * k_hot, row_bytes) in one dtype (is_bf16: bf16, else fp32), idx int32 (n,),
// out (n, row_bytes); all contiguous, n > 0, rows_per_table and k_hot below
// 2^31. Returns the launch's cudaError_t; runs on `stream`.
extern "C" int dlx_hot_gather(const void* table, const void* hot,
                              const int* idx, void* out, long long n,
                              long long v, long long rows_per_table, int k_hot,
                              int row_bytes, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rpt = static_cast<unsigned>(rows_per_table);
  const unsigned kh = static_cast<unsigned>(k_hot);
  const uint32_t nan32 = is_bf16 ? 0x7fc07fc0u : 0x7fc00000u;
  const bool aligned = (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(hot) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (row_bytes % 16 == 0 && aligned)
    return launch_hot<uint4>(table, hot, idx, out, n, v, rpt, kh, row_bytes / 16,
                             make_uint4(nan32, nan32, nan32, nan32), s);
  if (!is_bf16)
    return launch_hot<uint32_t>(table, hot, idx, out, n, v, rpt, kh,
                                row_bytes / 4, nan32, s);
  return launch_hot<uint16_t>(table, hot, idx, out, n, v, rpt, kh,
                              row_bytes / 2, static_cast<uint16_t>(0x7fc0u), s);
}
