// Stochastic int8 quantization of activations for Hopper (sm_90a), written by
// hand: q = clip(floor(x / scale + u), -127, 127), u uniform in [0, 1).
//
// Replaces the TPU Pallas kernel of deeplearningexamples_tpu/ops/quantization.py,
// quantize_activations -> _quant_kernel, which reseeds the TPU's hardware PRNG
// with seed + program_id for every block of rows and forms
// u = (bits >> 9) * 2^-23 from each 32-bit word. The hardware's bits do not
// exist here: a Philox4x32-10 (Salmon et al., SC'11) written into the kernel
// gives them. It is keyed on the seed, and element i takes word i % 4 of
// philox(counter = i / 4), so q depends on the seed and the element's index
// alone, not on the launch shape. The plain version
// (ops/quantization.py, philox_uniform) computes the same words in int64
// torch arithmetic, and the two agree bit for bit. The scale (absmax / 127,
// fp32) is taken in torch before the launch, as JAX takes it in XLA, and is
// read here from device memory: no host sync.
//
// What bounds it on this card: device memory. Per fp32 element 4 bytes are
// read and 1 written (bf16: 2 and 1); Philox adds about 25 integer
// operations per element, which the INT32 pipes take in about the time the
// bytes need. What the design does: one thread takes 16 bytes of x (4 fp32 or
// 8 bf16 elements) in one load; one Philox call gives exactly the 4 words
// that 4 elements need; the int8 results leave in one 4- or 8-byte store.
// The division is IEEE (no fast math), as JAX's is. An x that is not 16-byte
// aligned, and the ragged end, take element-wise loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Random123's Philox4x32 round constants
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ signed char round_one(float x, float scale,
                                                 uint32_t bits) {
  // u = (bits >> 9) * 2^-23: exact in fp32, as JAX's int32 -> fp32 path
  const float u = static_cast<float>(bits >> 9) * (1.0f / 8388608.0f);
  const float f = floorf(x / scale + u);
  return static_cast<signed char>(fminf(fmaxf(f, -127.0f), 127.0f));
}

// T: fp32 or bf16. E = 16 / sizeof(T) elements per thread (4 or 8).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ scale_ptr,
                    signed char* __restrict__ q, long long n, uint2 key,
                    bool aligned) {
  constexpr int E = 16 / sizeof(T);
  const long long first =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * E;
  if (first >= n) return;
  const float scale = *scale_ptr;
  const bool full = aligned && first + E <= n;
  alignas(16) T xv[E];
  if (full) {
    *reinterpret_cast<uint4*>(xv) = __ldg(reinterpret_cast<const uint4*>(x + first));
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) xv[j] = first + j < n ? x[first + j] : T(0.0f);
  }
  alignas(8) signed char out[E];
#pragma unroll
  for (int h = 0; h < E / 4; ++h) {
    const unsigned long long g = static_cast<unsigned long long>(first >> 2) + h;
    const uint4 b = philox4x32_10(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u),
        key);
    out[4 * h + 0] = round_one(to_float(xv[4 * h + 0]), scale, b.x);
    out[4 * h + 1] = round_one(to_float(xv[4 * h + 1]), scale, b.y);
    out[4 * h + 2] = round_one(to_float(xv[4 * h + 2]), scale, b.z);
    out[4 * h + 3] = round_one(to_float(xv[4 * h + 3]), scale, b.w);
  }
  if (full) {  // q comes from torch.empty: first is a multiple of E, aligned
    if constexpr (E == 4)
      *reinterpret_cast<uint32_t*>(q + first) = *reinterpret_cast<uint32_t*>(out);
    else
      *reinterpret_cast<uint2*>(q + first) = *reinterpret_cast<uint2*>(out);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (first + j < n) q[first + j] = out[j];
  }
}

template <typename T>
int launch(const void* x, const float* scale, signed char* q, long long n,
           uint2 key, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const long long threads = (n + E - 1) / E;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % E == 0;
  quantize_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, q, n, key, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. x (n,) fp32 or bf16 (is_bf16),
// contiguous; scale one fp32 on the device; q (n,) int8; n > 0 and n / E
// below 2^31 * 256. The 64-bit seed is Philox's key. Returns the launch's
// cudaError_t; runs on `stream`.
extern "C" int dlx_quantize_int8(const void* x, const float* scale,
                                 signed char* q, long long n, int is_bf16,
                                 unsigned long long seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  if (is_bf16) return launch<__nv_bfloat16>(x, scale, q, n, key, s);
  return launch<float>(x, scale, q, n, key, s);
}
