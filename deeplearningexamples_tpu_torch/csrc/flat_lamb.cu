// Fused LAMB over one flat parameter buffer for Hopper (sm_90a), written by
// hand: two passes.
//
// Replaces the TPU Pallas kernels of deeplearningexamples_tpu/core/flat.py,
// _flat_lamb_update's _moment_kernel (pass 1) and _apply_kernel (pass 2); the
// same math as ops/fused_lamb.py's _update_kernel and _apply_kernel. Every
// parameter is a segment of one (rows, 1024) fp32 buffer, padded to whole
// blocks of 64 x 1024 elements, so a block belongs to one tensor (seg_ids).
//
//   pass 1, one CUDA block per 64 x 1024 block:
//     g  = g * cs                                  cs: global-norm clip
//     m  = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2   in fp32
//     u  = (m / c1) / (sqrt(v / c2) + eps) + wd[seg] p
//     store m, v in their dtype (bf16 or fp32); write this block's
//     sum(p^2) and sum(u^2), u from the fp32 m and v before rounding
//   between the passes (plain torch, in core/flat.py): per-tensor sums of
//     the partials in a fixed order, trust ratio, scale = lr * ratio
//   pass 2: u again, from the STORED m and v, and p -= scale[seg] * u in
//     place, which saves the second 1.3 GB buffer a new p would need at
//     BERT-Large.
//
// The TPU adds each block's norms into per-tensor sums as its grid runs in
// order. Blocks on this card run in no order, and float atomics would sum in
// an order (and so to a result) that changes from run to run; pass 1 writes
// one partial pair per block instead, and the sums happen in torch.
//
// What bounds it on this card: device memory. Per element pass 1 reads g, p
// (fp32), m, v and writes m, v; pass 2 reads p, m, v and writes p: 28 bytes
// with bf16 moments, 9.4 GB a step at BERT-Large's 336M parameters, for
// about 10 flops an element. What the design does: consecutive threads touch
// consecutive elements, so every warp load is one 128-byte line, each thread
// has several independent loads in flight, and u is recomputed in pass 2
// instead of being written to and read back from memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64 * 1024;  // elements per flat block (core/flat.py)
constexpr int NTHREADS = 512;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// hyp (device, fp32): b1, b2, eps, c1 = 1 - b1^t, c2 = 1 - b2^t, cs
template <typename M>
__global__ void __launch_bounds__(NTHREADS)
    moments_kernel(const float* __restrict__ g, const float* __restrict__ p,
                   M* __restrict__ m, M* __restrict__ v,
                   const int* __restrict__ seg_ids,
                   const float* __restrict__ wd_leaf,
                   const float* __restrict__ hyp, float* __restrict__ partial) {
  const long long base = static_cast<long long>(blockIdx.x) * BLOCK;
  const float b1 = hyp[0], b2 = hyp[1], eps = hyp[2], c1 = hyp[3],
              c2 = hyp[4], cs = hyp[5];
  const float wd = wd_leaf[seg_ids[blockIdx.x]];
  float wsq = 0.0f, usq = 0.0f;
#pragma unroll 4
  for (int e = threadIdx.x; e < BLOCK; e += NTHREADS) {
    const long long i = base + e;
    const float gi = g[i] * cs;
    const float pi = p[i];
    const float mi = b1 * to_float(m[i]) + (1.0f - b1) * gi;
    const float vi = b2 * to_float(v[i]) + (1.0f - b2) * gi * gi;
    const float u = (mi / c1) / (sqrtf(vi / c2) + eps) + wd * pi;
    m[i] = from_float<M>(mi);
    v[i] = from_float<M>(vi);
    wsq += pi * pi;
    usq += u * u;
  }
  __shared__ float red[2][NTHREADS / 32];
  for (int off = 16; off > 0; off >>= 1) {
    wsq += __shfl_xor_sync(0xffffffffu, wsq, off);
    usq += __shfl_xor_sync(0xffffffffu, usq, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = wsq;
    red[1][warp] = usq;
  }
  __syncthreads();
  if (warp == 0) {
    wsq = lane < NTHREADS / 32 ? red[0][lane] : 0.0f;
    usq = lane < NTHREADS / 32 ? red[1][lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      wsq += __shfl_xor_sync(0xffffffffu, wsq, off);
      usq += __shfl_xor_sync(0xffffffffu, usq, off);
    }
    if (lane == 0) {
      partial[2 * blockIdx.x] = wsq;
      partial[2 * blockIdx.x + 1] = usq;
    }
  }
}

template <typename M>
__global__ void __launch_bounds__(NTHREADS)
    apply_kernel(float* __restrict__ p, const M* __restrict__ m,
                 const M* __restrict__ v, const int* __restrict__ seg_ids,
                 const float* __restrict__ wd_leaf,
                 const float* __restrict__ hyp,
                 const float* __restrict__ scale_leaf) {
  const long long base = static_cast<long long>(blockIdx.x) * BLOCK;
  const float eps = hyp[2], c1 = hyp[3], c2 = hyp[4];
  const int seg = seg_ids[blockIdx.x];
  const float wd = wd_leaf[seg], scale = scale_leaf[seg];
#pragma unroll 4
  for (int e = threadIdx.x; e < BLOCK; e += NTHREADS) {
    const long long i = base + e;
    const float pi = p[i];
    const float u =
        (to_float(m[i]) / c1) / (sqrtf(to_float(v[i]) / c2) + eps) + wd * pi;
    p[i] = pi - scale * u;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. n_blocks is the buffer's size over
// 64 x 1024; moments_bf16 says whether m and v hold bf16 (else fp32).
// Each returns its launch's cudaError_t; the kernel runs on `stream`.
extern "C" int dlx_flat_lamb_moments(const float* g, const float* p, void* m,
                                     void* v, const int* seg_ids,
                                     const float* wd_leaf, const float* hyp,
                                     float* partial, int n_blocks,
                                     int moments_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moments_bf16)
    moments_kernel<__nv_bfloat16><<<n_blocks, NTHREADS, 0, s>>>(
        g, p, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v),
        seg_ids, wd_leaf, hyp, partial);
  else
    moments_kernel<float><<<n_blocks, NTHREADS, 0, s>>>(
        g, p, static_cast<float*>(m), static_cast<float*>(v), seg_ids,
        wd_leaf, hyp, partial);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dlx_flat_lamb_apply(float* p, const void* m, const void* v,
                                   const int* seg_ids, const float* wd_leaf,
                                   const float* hyp, const float* scale_leaf,
                                   int n_blocks, int moments_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moments_bf16)
    apply_kernel<__nv_bfloat16><<<n_blocks, NTHREADS, 0, s>>>(
        p, static_cast<const __nv_bfloat16*>(m),
        static_cast<const __nv_bfloat16*>(v), seg_ids, wd_leaf, hyp,
        scale_leaf);
  else
    apply_kernel<float><<<n_blocks, NTHREADS, 0, s>>>(
        p, static_cast<const float*>(m), static_cast<const float*>(v), seg_ids,
        wd_leaf, hyp, scale_leaf);
  return static_cast<int>(cudaGetLastError());
}
