// Flash-attention backward for Hopper (sm_90a), written by hand: two kernels.
//
// Replaces the TPU Pallas backward kernels of deeplearningexamples_tpu/ops/
// flash_attention.py: _bwd_bshd/_bwd_kernel_bshd (the BERT path, (B,S,H,D)),
// _bwd/_bwd_kernel (the (B,H,S,D) fallback) and _bwd_kblk with
// _bwd_kernel_kblk_dq and _bwd_kernel_kblk_dkv (the K-blocked long-context
// path). Every tensor comes with four element strides, so both layouts are
// read and written in place, and both kernels walk the other sequence in
// tiles, so shared memory does not grow with S.
//
// What it computes, per (batch b, head h), from the forward's lse:
//   s[r,c]  = (q[r] . k[c]) * scale, -1e30 where masked or causal r < c
//   p[r,c]  = exp(s[r,c] - lse[r])        (not renormalised: a row whose
//             every key is masked has lse = -1e30 and so p = 1 everywhere)
//   delta[r]= sum_d dO[r,d] * O[r,d]       fp32
//   dp[r,c] = dO[r] . v[c], times keep/(1-rate) under dropout
//   dV[c]  += round(p * keep/(1-rate)) dO[r]      p rounded to dO's dtype
//   dS[r,c] = round(p * (dp - delta[r]) * scale)  rounded to q's dtype
//   dQ[r]   = sum_c dS[r,c] k[c]     written once, in q's dtype
//   dK[c]   = sum_r dS[r,c] q[r]     fp32 sums, cast once at the end
// The dropout keep mask is the forward's hash of (row, col, seed, (b_offset + b)*H + h),
// b_offset being the global row of the batch's row 0 under the data axis.
//
// Why two kernels: the TPU runs its grid in order and adds dK/dV over the
// query blocks into one output block. Blocks on this card run in no order,
// so summing across blocks would need float atomics, whose order (and so
// whose result) changes from run to run. Instead flash_bwd_dq_kernel owns a
// tile of 64 query rows and walks the key tiles, and flash_bwd_dkv_kernel
// owns a tile of 64 keys and walks the query tiles: each output element is
// written once by one block, so the result is deterministic. The dq kernel
// also writes delta, which the dk/dv kernel (launched after it on the same
// stream) reads.
//
// Two instances, chosen by is_bf16 in the same entry points:
//
// bf16, flash_bwd_dq_mma_kernel and flash_bwd_dkv_mma_kernel, on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 sums). Blocks of 4 warps, 16
// rows of the block's 64 to a warp, built from the forward's pieces (csrc/
// flash_common.cuh): the block's own tile is copied once with cp.async and,
// at D <= 64, kept in registers as A fragments (at D = 128 they would not
// fit beside the fp32 sums, so it is read again from shared memory with
// ldmatrix); the other sequence, with its mask or its lse and delta,
// streams through double-buffered shared tiles of 64. A warp takes each
// streamed tile 32 columns at a time (16 in the dk/dv kernel at D = 128)
// so that its score and dP fragments stay in registers:
//   dq:   S = Q K^T and dP = dO V^T, P = exp(S - lse), dS on the C
//         fragments, rounded to bf16 A fragments; dQ += dS K (K through
//         ldmatrix.trans). dQ stays fp32 in registers until the end.
//   dk/dv: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T on the C fragments
//         (the hash's row is still the query index); dV += bf16(P^T keep)
//         dO and dK += dS^T Q, both through ldmatrix.trans.
// Chunks whose keys are all valid, inside Sq and below the diagonal skip
// the mask's per-element work. Outputs are cast once and stored through
// shared memory, 16 bytes a store.
// What bounds it now: 14*S*S*D flops per (b, h) against 8*S*D values, far
// above the card's ridge, yet at B=64 S=128 the two kernels take 0.078 +
// 0.110 ms, about 80 TFLOP/s, and 0.115 + 0.153 ms causal at S=2048
// (NVIDIA H100 80GB HBM3, 700 W): as in the forward, each warp's products
// wait on its own exp, mask and packing work and on the tile barriers, and
// the dk/dv kernel at 184 registers (D = 64) keeps 2 blocks on an SM.
// wgmma with TMA, and a split over keys at small grids, are next.
//
// fp32, flash_bwd_dq_kernel and flash_bwd_dkv_kernel, the FMA pipe: score
// tiles stay in shared memory, each thread keeps a 4x4 tile of s and dp and
// a 4 x D/16 tile of its outputs in registers, so every shared load feeds
// four FMAs. It stays on the FMA pipe because the fp32 path is the exact
// one: a BERT step's worst fp32 gradient reads 1.42e-6 of the largest entry
// against the CPU, and TF32 mma keeps about three decimal digits; the main
// paths run in bf16.
//
// Head dims other than 32, 64 and 128 (up to 128), and bf16 views whose
// strides are not whole 16 bytes, run the next tile width's non-FULL
// instance with narrower copies and zero columns past the head dim, as in
// the forward (flash_fwd.cu).
//
// Both instances skip, under causal masking, the tiles past the diagonal
// unless a row of the tile has every key masked (the forward's rule).

#include <algorithm>
#include <type_traits>

#include "flash_common.cuh"

namespace {

using dlx_flash::NEG_INF;
using dlx_flash::Strides;
using dlx_flash::dropout_hash;

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16 threads; each owns 4 x 4 of a tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;  // (B, H, Sq) from the forward
  const int* mask;   // (B, Sk) int32, nonzero = attend; null = no mask
  void* dq;
  void* dk;
  void* dv;
  float* delta;      // (B, H, Sq): written by the dq kernel
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, Sq, Sk;
  float scale;
  int causal;
  int dropout;
  uint32_t threshold;    // keep iff hash >= threshold (int(rate * 2**31))
  float one_minus_rate;  // fp32(1 - rate); kept values scale by 1/this
  uint32_t seed;         // the int32 seed's bits
  int b_offset;          // global row of batch row 0 (the dropout salt's b)
  int Dv;                // the head dim, <= the instance's tile width D
  int unit;              // bf16: bytes a copy (copy_unit in flash_common.cuh)
};

// p for a masked score, -1e30, is exp(-1e30 - lse): 0 unless every key of
// the row is masked (lse = -1e30 too), and then 1.
__device__ __forceinline__ bool row_is_dead(float lse) {
  return expf(NEG_INF - lse) != 0.0f;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
             (2 * BQ * (D + 1) + 2 * D * (BK + 1) + BQ * (BK + 1) + 2 * BQ) +
         sizeof(int) * BK;
}

// FULL: the head dim is D. Otherwise it is p.Dv < D: the columns past it
// load as zeros and are not stored (in every kernel of this file).
template <int D, bool FULL>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int RLD = D + 1;   // padded row stride of Qs and dOs
  constexpr int KLD = BK + 1;  // padded row stride of Kt, Vt and Ps
  constexpr int DJ = D / 16;   // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][RLD]
  float* dOs = Qs + BQ * RLD;        // [BQ][RLD]
  float* Kt = dOs + BQ * RLD;        // [D][KLD]  K transposed
  float* Vt = Kt + D * KLD;          // [D][KLD]  V transposed
  float* Ps = Vt + D * KLD;          // [BQ][KLD] dS of the current key tile
  float* lse_s = Ps + BQ * KLD;      // [BQ]
  float* delta_s = lse_s + BQ;       // [BQ]
  int* Ms = reinterpret_cast<int*>(delta_s + BQ);  // [BK] key valid, -1 past Sk

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key columns tx + 16*j; dq columns tx + 16*j
  const int ty = tid >> 4;  // query rows 4*ty + i
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;

  const float* qp = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kp = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vp = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* op = static_cast<const float*>(p.out) + b * p.so.b + h * p.so.h;
  const float* dop =
      static_cast<const float*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  float* dqp = static_cast<float*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  const uint32_t salt = static_cast<uint32_t>((b + p.b_offset) * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    const bool in = row < p.Sq && (FULL || d < p.Dv);
    Qs[r * RLD + d] = in ? qp[row * p.sq.s + d * p.sq.d] : 0.0f;
    dOs[r * RLD + d] = in ? dop[row * p.sdo.s + d * p.sdo.d] : 0.0f;
  }
  __syncthreads();

  {  // delta = rowsum(dO * O), four threads to a row
    const int r = tid >> 2, part = tid & 3;
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < p.Sq)
      for (int d = part; d < (FULL ? D : p.Dv); d += 4)
        acc += dOs[r * RLD + d] * op[row * p.so.s + d * p.so.d];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.0f;
      if (row < p.Sq) p.delta[bh * p.Sq + row] = acc;
    }
  }
  __syncthreads();

  float lse_r[4], delta_r[4];
  bool dead = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    lse_r[i] = lse_s[r];
    delta_r[i] = delta_s[r];
    dead |= (q0 + r < p.Sq) && row_is_dead(lse_r[i]);
  }
  // Causal: key tiles wholly past the diagonal of this query tile hold only
  // masked scores, whose p is 0 unless a row of the tile is dead.
  const int nk = (p.Sk + BK - 1) / BK;
  const int n_live = p.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int n_tiles = __syncthreads_or(dead) ? nk : n_live;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Kt and Ps are no longer read
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int c = i / D, d = i % D;
      const int col = k0 + c;
      const bool in = col < p.Sk && (FULL || d < p.Dv);
      Kt[d * KLD + c] = in ? kp[col * p.sk.s + d * p.sk.d] : 0.0f;
      Vt[d * KLD + c] = in ? vp[col * p.sv.s + d * p.sv.d] : 0.0f;
    }
    if (tid < BK) {
      const int col = k0 + tid;
      Ms[tid] = col >= p.Sk ? -1 : (p.mask ? (p.mask[b * p.Sk + col] != 0) : 1);
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(4 * ty + i) * RLD + d];
        gv[i] = dOs[(4 * ty + i) * RLD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Kt[d * KLD + tx + 16 * j];
        vv[j] = Vt[d * KLD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = k0 + c;
        const int valid = Ms[c];
        float ds = 0.0f;
        if (valid >= 0) {  // keys past Sk contribute nothing
          float x = s[i][j] * p.scale;  // scale first, then mask
          if (!valid || (p.causal && row < col)) x = NEG_INF;
          const float pr = expf(x - lse_r[i]);
          float dpv = dp[i][j];
          if (p.dropout) {
            const uint32_t u = dropout_hash(static_cast<uint32_t>(row),
                                            static_cast<uint32_t>(col),
                                            p.seed, salt);
            dpv = u >= p.threshold ? dpv * keep_scale : 0.0f;
          }
          ds = pr * (dpv - delta_r[i]) * p.scale;
        }
        Ps[(4 * ty + i) * KLD + c] = ds;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * KLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Kt[(tx + 16 * j) * KLD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (FULL || tx + 16 * j < p.Dv)
        dqp[row * p.sdq.s + (tx + 16 * j) * p.sdq.d] = acc[i][j];
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * D * (BQ + 1) +
                          2 * BK * (BQ + 1) + 2 * BQ) +
         sizeof(int) * BK;
}

template <int D, bool FULL>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const Params p) {
  constexpr int RLD = D + 1;   // padded row stride of Ks and Vs
  constexpr int QLD = BQ + 1;  // padded row stride of Qt, dOt, Pt and St
  constexpr int DJ = D / 16;   // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BK][RLD]
  float* Vs = Ks + BK * RLD;         // [BK][RLD]
  float* Qt = Vs + BK * RLD;         // [D][QLD]  Q transposed
  float* dOt = Qt + D * QLD;         // [D][QLD]  dO transposed
  float* Pt = dOt + D * QLD;         // [BK][QLD] dropped p, rounded
  float* St = Pt + BK * QLD;         // [BK][QLD] dS, rounded
  float* lse_s = St + BK * QLD;      // [BQ]
  float* delta_s = lse_s + BQ;       // [BQ]
  int* Ms = reinterpret_cast<int*>(delta_s + BQ);  // [BK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // query columns tx + 16*j; dk/dv columns tx + 16*j
  const int ty = tid >> 4;  // keys 4*ty + i
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;

  const float* qp = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kp = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vp = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* dop =
      static_cast<const float*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  float* dkp = static_cast<float*>(p.dk) + b * p.sdk.b + h * p.sdk.h;
  float* dvp = static_cast<float*>(p.dv) + b * p.sdv.b + h * p.sdv.h;
  const uint32_t salt = static_cast<uint32_t>((b + p.b_offset) * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;

  for (int i = tid; i < BK * D; i += NTHREADS) {
    const int c = i / D, d = i % D;
    const int col = k0 + c;
    const bool in = col < p.Sk && (FULL || d < p.Dv);
    Ks[c * RLD + d] = in ? kp[col * p.sk.s + d * p.sk.d] : 0.0f;
    Vs[c * RLD + d] = in ? vp[col * p.sv.s + d * p.sv.d] : 0.0f;
  }
  if (tid < BK) {
    const int col = k0 + tid;
    Ms[tid] = col >= p.Sk ? -1 : (p.mask ? (p.mask[b * p.Sk + col] != 0) : 1);
  }

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.0f;

  const int nq = (p.Sq + BQ - 1) / BQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Qt, dOt, Pt and St are no longer read
    if (tid < BQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.0f;
      delta_s[tid] = row < p.Sq ? p.delta[bh * p.Sq + row] : 0.0f;
    }
    if (p.causal && q0 + BQ - 1 < k0) {
      // every query of this tile is before every key of this block: all
      // scores are masked, and p is 0 unless a row of the tile is dead
      __syncthreads();
      const bool dead = tid < BQ && q0 + tid < p.Sq && row_is_dead(lse_s[tid]);
      if (!__syncthreads_or(dead)) continue;
    }
    for (int i = tid; i < BQ * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const int row = q0 + r;
      const bool in = row < p.Sq && (FULL || d < p.Dv);
      Qt[d * QLD + r] = in ? qp[row * p.sq.s + d * p.sq.d] : 0.0f;
      dOt[d * QLD + r] = in ? dop[row * p.sdo.s + d * p.sdo.d] : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(4 * ty + i) * RLD + d];
        vv[i] = Vs[(4 * ty + i) * RLD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qt[d * QLD + tx + 16 * j];
        gv[j] = dOt[d * QLD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * ty + i;
      const int col = k0 + c;
      const int valid = Ms[c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int row = q0 + r;
        float pu = 0.0f, ds = 0.0f;
        if (valid >= 0 && row < p.Sq) {
          float x = s[i][j] * p.scale;
          if (!valid || (p.causal && row < col)) x = NEG_INF;
          const float pr = expf(x - lse_s[r]);
          float dpv = dp[i][j];
          pu = pr;
          if (p.dropout) {
            const bool keep = dropout_hash(static_cast<uint32_t>(row),
                                           static_cast<uint32_t>(col),
                                           p.seed, salt) >= p.threshold;
            pu = keep ? pr * keep_scale : 0.0f;
            dpv = keep ? dpv * keep_scale : 0.0f;
          }
          ds = pr * (dpv - delta_s[r]) * p.scale;
        }
        Pt[c * QLD + r] = pu;
        St[c * QLD + r] = ds;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4], gv[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(4 * ty + i) * QLD + r];
        sv[i] = St[(4 * ty + i) * QLD + r];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = dOt[(tx + 16 * j) * QLD + r];
        qv[j] = Qt[(tx + 16 * j) * QLD + r];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + 4 * ty + i;
    if (col >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (!FULL && d >= p.Dv) continue;
      dkp[col * p.sdk.s + d * p.sdk.d] = dk[i][j];
      dvp[col * p.sdv.s + d * p.sdv.d] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using dlx_flash::MMA_THREADS;
using dlx_flash::PAD;
using dlx_flash::a_from_c;
using dlx_flash::bf16;
using dlx_flash::cp_async_4;
using dlx_flash::cp_async_commit;
using dlx_flash::cp_async_wait;
using dlx_flash::exp_approx;
using dlx_flash::ldsm_a;
using dlx_flash::ldsm_b;
using dlx_flash::ldsm_bt;
using dlx_flash::load_tile;
using dlx_flash::mma_bf16;
using dlx_flash::stage_c;
using dlx_flash::store_tile;

// keys a warp of the dq kernel holds as scores at once; a chunk's mask is
// voted on one key a lane
constexpr int KC = 32;

// Calls f(std::true_type) when `plain` (no score of the chunk needs a mask:
// every key valid, none past Sk or the diagonal), else f(std::false_type),
// so that the mask's per-element work is compiled out of the common case.
template <typename F>
__device__ __forceinline__ void with_plain(bool plain, F&& f) {
  if (plain)
    f(std::true_type{});
  else
    f(std::false_type{});
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q (later dQ), dO, two K and two V tiles, two rows of the mask, lse,
  // delta
  return sizeof(bf16) * (D + PAD) * (2 * BQ + 4 * BK) +
         sizeof(int) * 2 * BK + sizeof(float) * 2 * BQ;
}

template <int D, bool FULL>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dq_mma_kernel(const Params p) {
  constexpr bool KEEP = D <= 64;  // Q and dO stay in registers
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;  // k16 steps over the head dim
  constexpr int NC = KC / 8;  // n8 tiles of a warp's 16 x KC scores
  constexpr int DT = D / 8;   // n8 tiles of a warp's 16 x D dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD], later dQ
  bf16* dOs = Qs + BQ * LD;                      // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]
  int* Ms = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // [2][BK] key mask
  float* lse_s = reinterpret_cast<float*>(Ms + 2 * BK);  // [BQ]
  float* delta_s = lse_s + BQ;                            // [BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const bf16* op = static_cast<const bf16*>(p.out) + b * p.so.b + h * p.so.h;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  bf16* dqp = static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  const uint32_t salt = static_cast<uint32_t>((b + p.b_offset) * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    load_tile<BK, D, FULL>(Ks + buf * BK * LD, kp, p.sk.s, k0, p.Sk, p.Dv,
                           p.unit);
    load_tile<BK, D, FULL>(Vs + buf * BK * LD, vp, p.sv.s, k0, p.Sk, p.Dv,
                           p.unit);
    if (p.mask && tid < BK) {  // in the tile's group: no load stalls a warp
      const int col = k0 + tid;
      cp_async_4(Ms + buf * BK + tid, p.mask + b * p.Sk + min(col, p.Sk - 1),
                 col < p.Sk);
    }
    cp_async_commit();
  };

  load_tile<BQ, D, FULL>(Qs, qp, p.sq.s, q0, p.Sq, p.Dv, p.unit);
  load_tile<BQ, D, FULL>(dOs, dop, p.sdo.s, q0, p.Sq, p.Dv, p.unit);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_wait<1>();  // Q and dO
  __syncthreads();

  {  // delta = rowsum(dO * O) in fp32, two threads to a row
    const int r = tid >> 1, half = tid & 1;
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < p.Sq) {
      const bf16* orow = op + row * p.so.s;
      if constexpr (FULL) {
        for (int c = half * (D / 16); c < (half + 1) * (D / 16); ++c) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
          const uint4 gv = *reinterpret_cast<const uint4*>(dOs + r * LD + c * 8);
          const bf16* o8 = reinterpret_cast<const bf16*>(&ov);
          const bf16* g8 = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc += __bfloat162float(g8[e]) * __bfloat162float(o8[e]);
        }
      } else {  // out may sit on any 2-byte boundary: one bf16 at a time
        for (int d = half * (D / 2); d < min((half + 1) * (D / 2), p.Dv); ++d)
          acc += __bfloat162float(dOs[r * LD + d]) * __bfloat162float(orow[d]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.0f;
      if (row < p.Sq) p.delta[bh * p.Sq + row] = acc;
    }
  }
  __syncthreads();

  float lse_r[2], delta_r[2];
  bool dead = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = lse_s[warp * 16 + g + 8 * r];
    delta_r[r] = delta_s[warp * 16 + g + 8 * r];
    dead |= rows[r] < p.Sq && row_is_dead(lse_r[r]);
  }
  // Causal: key tiles wholly past the diagonal of this query tile hold only
  // masked scores, whose p is 0 unless a row of the tile is dead.
  const int nk = (p.Sk + BK - 1) / BK;
  const int n_live = p.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int n_tiles = __syncthreads_or(dead) ? nk : n_live;

  uint32_t qf[KEEP ? KS : 1][4], gf[KEEP ? KS : 1][4];
  if constexpr (KEEP) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_a(qf[kk], Qs, LD, warp * 16, kk * 16);
      ldsm_a(gf[kk], dOs, LD, warp * 16, kk * 16);
    }
  }
  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;
    const int* Mb = Ms + buf * BK;
    const int k0 = kt * BK;

#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += KC) {
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], ga[4];
        if constexpr (KEEP) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qa[i] = qf[kk][i];
            ga[i] = gf[kk][i];
          }
        } else {
          ldsm_a(qa, Qs, LD, warp * 16, kk * 16);
          ldsm_a(ga, dOs, LD, warp * 16, kk * 16);
        }
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t kb[4], vb[4];
          ldsm_b(kb, Kb, LD, c0 + np * 16, kk * 16);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          ldsm_b(vb, Vb, LD, c0 + np * 16, kk * 16);
          mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
        }
      }
      // dS = bf16(p * (dp - delta) * scale); keys past Sk contribute nothing
      const bool plain =
          k0 + c0 + KC <= p.Sk &&
          !(p.causal && k0 + c0 + KC - 1 > q0 + warp * 16) &&
          (!p.mask || __all_sync(0xffffffffu, Mb[c0 + lane]));
      with_plain(plain, [&](auto plain_c) {
        constexpr bool PLAIN = decltype(plain_c)::value;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + j * 8 + 2 * t + (e & 1);
            const int col = k0 + c;
            const int r = e >> 1;
            float ds = 0.0f;
            if (PLAIN || col < p.Sk) {
              float x = s[j][e] * p.scale;  // scale first, then mask
              if (!PLAIN && ((p.mask && !Mb[c]) || (p.causal && rows[r] < col)))
                x = NEG_INF;
              const float pr = exp_approx(x - lse_r[r]);
              float dpv = dp[j][e];
              if (p.dropout) {
                const uint32_t u = dropout_hash(
                    static_cast<uint32_t>(rows[r]), static_cast<uint32_t>(col),
                    p.seed, salt);
                dpv = u >= p.threshold ? dpv * keep_scale : 0.0f;
              }
              ds = pr * (dpv - delta_r[r]) * p.scale;
            }
            s[j][e] = ds;
          }
      });
      uint32_t dsf[NC / 2][4];
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk)
        a_from_c(dsf[kk], s[2 * kk], s[2 * kk + 1]);
      // dQ += dS K
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk)
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          uint32_t kb[4];
          ldsm_bt(kb, Kb, LD, c0 + kk * 16, dp2 * 16);
          mma_bf16(dq[2 * dp2], dsf[kk], kb[0], kb[1]);
          mma_bf16(dq[2 * dp2 + 1], dsf[kk], kb[2], kb[3]);
        }
    }
    __syncthreads();  // this tile's buffers may be refilled
  }

  stage_c<D>(Qs, warp * 16, dq, 1.0f, 1.0f);
  __syncthreads();
  store_tile<BQ, D, FULL>(dqp, p.sdq.s, Qs, q0, p.Sq, p.Dv, p.unit);
}

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K and V (later dK and dV), two Q and two dO tiles, two rows each of lse
  // and delta
  return sizeof(bf16) * (D + PAD) * (2 * BK + 4 * BQ) + sizeof(float) * 4 * BQ;
}

template <int D, bool FULL>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dkv_mma_kernel(const Params p) {
  constexpr bool KEEP = D <= 64;  // K and V stay in registers
  // queries a warp holds as scores at once: at D = 128 the dK and dV sums
  // take 128 registers, and 32 queries would spill
  constexpr int QC = D <= 64 ? 32 : 16;
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;
  constexpr int NC = QC / 8;  // n8 tiles of a warp's 16 keys x QC queries
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD], later dK
  bf16* Vs = Ks + BK * LD;                       // [BK][LD], later dV
  bf16* Qs = Vs + BK * LD;                       // [2][BQ][LD]
  bf16* dOs = Qs + 2 * BQ * LD;                  // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                             // [2][BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.sdk.b + h * p.sdk.h;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.sdv.b + h * p.sdv.h;
  const uint32_t salt = static_cast<uint32_t>((b + p.b_offset) * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;
  // this lane's two keys (rows of the transposed tiles) and their mask
  const int cols[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    valid[r] = cols[r] >= p.Sk
                   ? -1
                   : (p.mask ? (p.mask[b * p.Sk + cols[r]] != 0) : 1);
  const bool warp_valid =
      __all_sync(0xffffffffu, valid[0] == 1 && valid[1] == 1);

  auto load_q = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    load_tile<BQ, D, FULL>(Qs + buf * BQ * LD, qp, p.sq.s, q0, p.Sq, p.Dv,
                           p.unit);
    load_tile<BQ, D, FULL>(dOs + buf * BQ * LD, dop, p.sdo.s, q0, p.Sq, p.Dv,
                           p.unit);
    if (tid < BQ) {
      const int row = q0 + tid;
      const bool in = row < p.Sq;
      cp_async_4(lse_s + buf * BQ + tid, p.lse + (in ? bh * p.Sq + row : 0), in);
      cp_async_4(delta_s + buf * BQ + tid, p.delta + (in ? bh * p.Sq + row : 0),
                 in);
    }
    cp_async_commit();
  };

  load_tile<BK, D, FULL>(Ks, kp, p.sk.s, k0, p.Sk, p.Dv, p.unit);
  load_tile<BK, D, FULL>(Vs, vp, p.sv.s, k0, p.Sk, p.Dv, p.unit);
  cp_async_commit();

  const int nq = (p.Sq + BQ - 1) / BQ;
  int q_first = 0;
  if (p.causal) {
    // Query tiles wholly before this block's first key hold only masked
    // scores, whose p is 0 unless a row is dead (its lse is -1e30): then
    // every query tile is walked, and the others add exact zeros.
    q_first = min(nq, k0 / BQ);
    bool dead = false;
    for (int row = tid; row < min(q_first * BQ, p.Sq); row += MMA_THREADS)
      dead |= row_is_dead(p.lse[bh * p.Sq + row]);
    if (__syncthreads_or(dead)) q_first = 0;
  }
  if (q_first < nq) load_q(q_first, 0);

  uint32_t kf[KEEP ? KS : 1][4], vf[KEEP ? KS : 1][4];
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

  for (int qt = q_first; qt < nq; ++qt) {
    const int buf = (qt - q_first) & 1;
    if (qt + 1 < nq) {
      load_q(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (KEEP) {
      if (qt == q_first) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_a(kf[kk], Ks, LD, warp * 16, kk * 16);
          ldsm_a(vf[kk], Vs, LD, warp * 16, kk * 16);
        }
      }
    }
    const bf16* Qb = Qs + buf * BQ * LD;
    const bf16* dOb = dOs + buf * BQ * LD;
    const float* lb = lse_s + buf * BQ;
    const float* db = delta_s + buf * BQ;
    const int q0 = qt * BQ;

#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += QC) {
      float st[NC][4], dpt[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (KEEP) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kk][i];
            va[i] = vf[kk][i];
          }
        } else {
          ldsm_a(ka, Ks, LD, warp * 16, kk * 16);
          ldsm_a(va, Vs, LD, warp * 16, kk * 16);
        }
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t qb[4], gb[4];
          ldsm_b(qb, Qb, LD, c0 + np * 16, kk * 16);
          mma_bf16(st[2 * np], ka, qb[0], qb[1]);
          mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
          ldsm_b(gb, dOb, LD, c0 + np * 16, kk * 16);
          mma_bf16(dpt[2 * np], va, gb[0], gb[1]);
          mma_bf16(dpt[2 * np + 1], va, gb[2], gb[3]);
        }
      }
      // P^T (times keep) and dS^T; the hash's row is still the query
      const bool plain = warp_valid && q0 + c0 + QC <= p.Sq &&
                         !(p.causal && q0 + c0 < k0 + warp * 16 + 15);
      with_plain(plain, [&](auto plain_c) {
        constexpr bool PLAIN = decltype(plain_c)::value;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cq = c0 + j * 8 + 2 * t + (e & 1);
            const int row = q0 + cq;
            const int r = e >> 1;
            float pu = 0.0f, ds = 0.0f;
            if (PLAIN || (valid[r] >= 0 && row < p.Sq)) {
              float x = st[j][e] * p.scale;
              if (!PLAIN && (!valid[r] || (p.causal && row < cols[r])))
                x = NEG_INF;
              const float pr = exp_approx(x - lb[cq]);
              float dpv = dpt[j][e];
              pu = pr;
              if (p.dropout) {
                const bool keep = dropout_hash(static_cast<uint32_t>(row),
                                               static_cast<uint32_t>(cols[r]),
                                               p.seed, salt) >= p.threshold;
                pu = keep ? pr * keep_scale : 0.0f;
                dpv = keep ? dpv * keep_scale : 0.0f;
              }
              ds = pr * (dpv - db[cq]) * p.scale;
            }
            st[j][e] = pu;
            dpt[j][e] = ds;
          }
      });
      uint32_t pf[NC / 2][4], dsf[NC / 2][4];
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        a_from_c(pf[kk], st[2 * kk], st[2 * kk + 1]);
        a_from_c(dsf[kk], dpt[2 * kk], dpt[2 * kk + 1]);
      }
      // dV += bf16(P^T keep) dO, dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk)
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          uint32_t gb[4], qb[4];
          ldsm_bt(gb, dOb, LD, c0 + kk * 16, dp2 * 16);
          mma_bf16(dv[2 * dp2], pf[kk], gb[0], gb[1]);
          mma_bf16(dv[2 * dp2 + 1], pf[kk], gb[2], gb[3]);
          ldsm_bt(qb, Qb, LD, c0 + kk * 16, dp2 * 16);
          mma_bf16(dk[2 * dp2], dsf[kk], qb[0], qb[1]);
          mma_bf16(dk[2 * dp2 + 1], dsf[kk], qb[2], qb[3]);
        }
    }
    __syncthreads();  // this tile's buffers may be refilled
  }

  cp_async_wait<0>();  // K and V have landed even when no tile was walked
  __syncthreads();
  stage_c<D>(Ks, warp * 16, dk, 1.0f, 1.0f);
  stage_c<D>(Vs, warp * 16, dv, 1.0f, 1.0f);
  __syncthreads();
  store_tile<BK, D, FULL>(dkp, p.sdk.s, Ks, k0, p.Sk, p.Dv, p.unit);
  store_tile<BK, D, FULL>(dvp, p.sdv.s, Vs, k0, p.Sk, p.Dv, p.unit);
}

template <int D, bool FULL>
cudaError_t launch_d(const Params& p, bool dq, bool bf16_in,
                     cudaStream_t stream) {
  const dim3 grid(dq ? (p.Sq + BQ - 1) / BQ : (p.Sk + BK - 1) / BK, p.H, p.B);
  if (bf16_in)
    return dq ? dlx_flash::launch_kernel(flash_bwd_dq_mma_kernel<D, FULL>, grid,
                                         MMA_THREADS, dq_mma_smem_bytes<D>(),
                                         stream, p)
              : dlx_flash::launch_kernel(flash_bwd_dkv_mma_kernel<D, FULL>,
                                         grid, MMA_THREADS,
                                         dkv_mma_smem_bytes<D>(), stream, p);
  return dq ? dlx_flash::launch_kernel(flash_bwd_dq_kernel<D, FULL>, grid,
                                       NTHREADS, dq_smem_bytes<D>(), stream, p)
            : dlx_flash::launch_kernel(flash_bwd_dkv_kernel<D, FULL>, grid,
                                       NTHREADS, dkv_smem_bytes<D>(), stream,
                                       p);
}

template <int D>
cudaError_t launch_w(const Params& p, bool dq, bool bf16_in, bool full,
                     cudaStream_t stream) {
  return full ? launch_d<D, true>(p, dq, bf16_in, stream)
              : launch_d<D, false>(p, dq, bf16_in, stream);
}

int run(bool dq, const void* q, const void* k, const void* v, const void* out,
        const void* dout, const float* lse, const int* mask, void* dqp,
        void* dkp, void* dvp, float* delta, const long long* strides, int B,
        int H, int Sq, int Sk, int D, int is_bf16, float scale, int causal,
        int dropout, unsigned int threshold, float one_minus_rate,
        unsigned int seed, int b_offset, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.lse = lse;
  p.mask = mask;
  p.dq = dqp;
  p.dk = dkp;
  p.dv = dvp;
  p.delta = delta;
  Strides* st[8] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int t = 0; t < 8; ++t)
    *st[t] = {strides[4 * t], strides[4 * t + 1], strides[4 * t + 2],
              strides[4 * t + 3]};
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.threshold = threshold;
  p.one_minus_rate = one_minus_rate;
  p.seed = seed;
  p.b_offset = b_offset;
  p.Dv = D;
  p.unit = 16;
  if (is_bf16) {
    const void* ptrs[8] = {q, k, v, out, dout, dqp, dkp, dvp};
    for (int t = 0; t < 8; ++t) {
      const int S = (t == 1 || t == 2 || t >= 6) ? Sk : Sq;  // k, v, dk, dv
      p.unit = std::min(p.unit, dlx_flash::copy_unit(ptrs[t], *st[t], B, S, H, D));
    }
    if (p.unit == 0) return dlx_flash::kMisaligned;
  }
  const int width = dlx_flash::tile_width(D);
  const bool full = D == width && p.unit == 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (width) {
    case 32: err = launch_w<32>(p, dq, is_bf16, full, s); break;
    case 64: err = launch_w<64>(p, dq, is_bf16, full, s); break;
    case 128: err = launch_w<128>(p, dq, is_bf16, full, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound with ctypes; both take the same arguments.
// strides holds 32 element strides, (batch, seq, head, dim) for q, k, v, out,
// dout, dq, dk and dv in that order. dlx_flash_bwd_dq writes dq and delta;
// dlx_flash_bwd_dkv reads delta and writes dk and dv, so it is launched
// second on the same stream; D is the head dim, 1 to 128. Each returns its
// launch's cudaError_t, or kMisaligned (flash_common.cuh) without launching
// when a bf16 pointer is off a 2-byte boundary.
extern "C" int dlx_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const int* mask, void* dq, void* dk,
    void* dv, float* delta, const long long* strides, int B, int H, int Sq,
    int Sk, int D, int is_bf16, float scale, int causal, int dropout,
    unsigned int threshold, float one_minus_rate, unsigned int seed,
    int b_offset, void* stream) {
  return run(true, q, k, v, out, dout, lse, mask, dq, dk, dv, delta, strides,
             B, H, Sq, Sk, D, is_bf16, scale, causal, dropout, threshold,
             one_minus_rate, seed, b_offset, stream);
}

extern "C" int dlx_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const int* mask, void* dq, void* dk,
    void* dv, float* delta, const long long* strides, int B, int H, int Sq,
    int Sk, int D, int is_bf16, float scale, int causal, int dropout,
    unsigned int threshold, float one_minus_rate, unsigned int seed,
    int b_offset, void* stream) {
  return run(false, q, k, v, out, dout, lse, mask, dq, dk, dv, delta, strides,
             B, H, Sq, Sk, D, is_bf16, scale, causal, dropout, threshold,
             one_minus_rate, seed, b_offset, stream);
}
