// What the flash-attention forward (flash_fwd.cu) and backward (flash_bwd.cu)
// kernels share: the score mask value, strides, the JAX package's dropout
// hash, and the building blocks of the bf16 tensor-core kernels (warp-level
// mma.sync, ldmatrix, cp.async and tile copies, and the entry points' check
// that a tensor suits them). Both kernels must regenerate the same keep
// mask, so the hash lives here once.

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

// Sets the kernel's dynamic shared memory (above 48 KB it must be asked
// for), launches it and returns the launch's error.
template <typename P>
cudaError_t launch_kernel(void (*kernel)(const P), dim3 grid, int threads,
                          size_t smem, cudaStream_t stream, const P& p) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernels' building blocks
// ---------------------------------------------------------------------------
//
// One warp multiplies a 16 x 16 A fragment by a 16 x 8 B fragment into a
// 16 x 8 fp32 C fragment (mma.sync m16n8k16). With g = lane / 4 and
// t = lane % 4, a lane holds:
//   A: a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8, cols 2t, 2t+1),
//      a[2] = (row g, cols 2t+8, 2t+9), a[3] = (row g+8, cols 2t+8, 2t+9)
//   B: b0 = (rows 2t, 2t+1, col g), b1 = (rows 2t+8, 2t+9, col g)
//   C: c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (row g+8, same)
// Two bf16 share one 32-bit register, the lower column in the low half. So
// the C fragments of two neighbouring n8 tiles, rounded to bf16, are exactly
// the A fragment of one k16 step (a_from_c): a score block goes from one
// product into the next without touching shared memory.

using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;  // warps of a tensor-core block
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int PAD = 8;        // bf16 of padding at the end of a tile's row

// The widest copy, in bytes (16, 8, 4 or 2), that a bf16 tensor allows: its
// pointer, the element strides of its batch, seq and head dims (those longer
// than 1) and the head dim itself (a copy never crosses past D) are whole
// copies. A tensor of 16 at a head dim of 32, 64 or 128 runs the kernels'
// FULL instances (16-byte copies, no column predicate); any other D up to
// 128 runs the instance of the next tile width with copies of this size, the
// columns past D zero-filled in shared memory and never stored. 0 for a
// pointer off a 2-byte boundary, which the entry points refuse with
// kMisaligned before any launch.
constexpr int kMisaligned = cudaErrorMisalignedAddress;

inline int copy_unit(const void* ptr, const Strides& st, int B, int S, int H,
                     int D) {
  unsigned long long bits = reinterpret_cast<uintptr_t>(ptr) |
                            static_cast<unsigned long long>(2 * D);
  const auto add = [&](long long stride, int n) {
    if (n > 1) bits |= static_cast<unsigned long long>(2 * stride);
  };
  add(st.b, B);
  add(st.s, S);
  add(st.h, H);
  for (int unit = 16; unit >= 2; unit /= 2)
    if (bits % unit == 0) return unit;
  return 0;
}

// The tile width (an instantiated D) that runs head dim D, or 0 above 128.
inline int tile_width(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

// PTX wrappers.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously; when
// `valid` is false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes likewise (one fp32 of lse or delta, or two bf16).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// 8 bytes likewise (four bf16).
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// One copy of `unit` bytes (16, 8, 4 or 2), zero-filled when not valid; a
// 2-byte copy has no cp.async form and is a plain load and store.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid, int unit) {
  switch (unit) {
    case 16: cp_async_16(dst, src, valid); break;
    case 8: cp_async_8(dst, src, valid); break;
    case 4: cp_async_4(dst, src, valid); break;
    default:
      *static_cast<unsigned short*>(dst) =
          valid ? *static_cast<const unsigned short*>(src) : 0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] receives (row g, cols 2t, 2t+1) of it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: r[i] receives (rows 2t, 2t+1, col g) of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * (b0, b1): bf16 products, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e^x as 2^(x log2 e) on the SFU (ex2.approx, about 2 ulp, subnormal results
// flushed to 0): a multiply and one SFU instruction in place of expf's
// longer sequence. Exact 1 at x = 0 and 0 at x = -inf, so the dead-row rule
// (p = exp(0) = 1) and the past-Sk rule (p = 0) hold as with expf.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Fragments from shared memory.

// Two fp32 rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of rows [row0, row0+16) and cols [k0, k0+16) of a row-major
// tile with row stride ld.
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles, n in [n0, n0+16), k in [k0, k0+16), from a
// tile stored n-major (row n holds k contiguous, as K for Q K^T): b[0], b[1]
// for n0..n0+7 and b[2], b[3] for n0+8..n0+15.
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* tile,
                                       int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile stored k-major (row k holds n contiguous, as V for
// P V), through ldmatrix's transpose.
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const bf16* tile,
                                        int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// The A fragment of k16 step `s` from the fp32 C fragments of n8 tiles 2s
// and 2s+1, rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Tiles between device and shared memory.
//
// FULL: the tile's width D is the head dim and every copy is 16 bytes.
// Otherwise the head dim is dv <= D and a copy is `unit` bytes (which
// divides 2 * dv): columns at or past dv are zero-filled, so they add
// nothing to a product over the head dim, and are never stored.

// Rows [row0, row0+ROWS) of a (seq, D) bf16 matrix whose rows are `stride`
// elements apart into a [ROWS][D+PAD] shared tile, rows at or past n_rows
// zero-filled. Asynchronous: the caller commits and waits.
template <int ROWS, int D, bool FULL>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long stride, int row0,
                                          int n_rows, int dv, int unit) {
  if constexpr (FULL) {
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * CH; i += MMA_THREADS) {
      const int r = i / CH, c = i % CH;
      const bool in = row0 + r < n_rows;
      cp_async_16(tile + r * (D + PAD) + c * 8,
                  in ? src + (row0 + r) * stride + c * 8 : src, in);
    }
  } else {
    const int ue = unit / 2;  // bf16 per copy
    const int ch = D / ue;
    for (int i = threadIdx.x; i < ROWS * ch; i += MMA_THREADS) {
      const int r = i / ch, c = (i % ch) * ue;
      const bool in = row0 + r < n_rows && c < dv;
      copy_async(tile + r * (D + PAD) + c,
                 in ? src + (row0 + r) * stride + c : src, in, unit);
    }
  }
}

// The reverse, synchronously: rows of the shared tile before n_rows, and
// their columns before dv, go to device memory, `unit` bytes a store.
template <int ROWS, int D, bool FULL>
__device__ __forceinline__ void store_tile(bf16* dst, long long stride,
                                           const bf16* tile, int row0,
                                           int n_rows, int dv, int unit) {
  if constexpr (FULL) {
    constexpr int CH = D / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += MMA_THREADS) {
      const int r = i / CH, c = i % CH;
      if (row0 + r < n_rows)
        *reinterpret_cast<uint4*>(dst + (row0 + r) * stride + c * 8) =
            *reinterpret_cast<const uint4*>(tile + r * (D + PAD) + c * 8);
    }
  } else {
    const int ue = unit / 2;
    const int ch = (dv + ue - 1) / ue;
    for (int i = threadIdx.x; i < ROWS * ch; i += MMA_THREADS) {
      const int r = i / ch, c = (i % ch) * ue;
      if (row0 + r >= n_rows) continue;
      bf16* d = dst + (row0 + r) * stride + c;
      const bf16* s = tile + r * (D + PAD) + c;
      switch (unit) {
        case 16: *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s); break;
        case 8: *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s); break;
        case 4: *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s); break;
        default: *reinterpret_cast<unsigned short*>(d) = *reinterpret_cast<const unsigned short*>(s);
      }
    }
  }
}

// A warp's 16 x D fp32 C fragments (D/8 n8 tiles), divided by div0 on row
// g and div1 on row g+8, as bf16 into rows [row0, row0+16) of a [*][D+PAD]
// tile: each value is rounded once.
template <int D>
__device__ __forceinline__ void stage_c(bf16* tile, int row0,
                                        const float (&c)[D / 8][4], float div0,
                                        float div1) {
  const int lane = threadIdx.x & 31;
  bf16* r0 = tile + (row0 + (lane >> 2)) * (D + PAD) + 2 * (lane & 3);
  bf16* r1 = r0 + 8 * (D + PAD);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(r0 + 8 * j) =
        pack_bf16(c[j][0] / div0, c[j][1] / div0);
    *reinterpret_cast<uint32_t*>(r1 + 8 * j) =
        pack_bf16(c[j][2] / div1, c[j][3] / div1);
  }
}

}  // namespace dlx_flash
