// What the flash-attention forward (flash_fwd.cu) and backward (flash_bwd.cu)
// kernels share: the score mask value, strides, dtype conversions and the
// JAX package's dropout hash. Both kernels must regenerate the same keep mask,
// so the hash lives here once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dlx_flash {

constexpr float NEG_INF = -1e30f;  // the JAX package's NEG_INF, not -inf

// Element strides of one tensor in (batch, seq, head, dim) order, whatever
// its layout in memory: (B,S,H,D) and (B,H,S,D) are both read in place.
struct Strides {
  long long b, s, h, d;
};

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

// x rounded to T and back, as the TPU kernels round an fp32 block to the
// input dtype before it meets the next matrix product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// The JAX package's _dropout_scale hash, in uint32 so that every product
// wraps as JAX's int32 arithmetic does (signed overflow is undefined in C++).
// JAX's arithmetic right shifts are masked to the shifted-in width, which is
// exactly a logical shift here. Keep iff the result >= int(rate * 2**31).
__device__ __forceinline__ uint32_t dropout_hash(uint32_t row, uint32_t col,
                                                 uint32_t seed, uint32_t salt) {
  const uint32_t c1 = 0x9E3779B9u, c2 = 0x85EBCA6Bu, c3 = 0xC2B2AE35u;
  uint32_t h = row * c1 + col * c2 + seed + salt * c3;
  h ^= h >> 16;
  h *= c2;
  h ^= h >> 13;
  h *= c3;
  h ^= h >> 16;
  return h & 0x7FFFFFFFu;
}

}  // namespace dlx_flash
