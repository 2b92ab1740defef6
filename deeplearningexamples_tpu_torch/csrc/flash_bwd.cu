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
// The dropout keep mask is the forward's hash of (row, col, seed, b*H + h).
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
// What bounds it on this card: per (b, h) the two kernels do 14*S*S*D flops
// (s and dp twice, dV, dK, dQ) against 8*S*D values read or written, far
// above the card's ridge, so this first version, on the fp32 FMA pipe, is
// bound by FMA issue and shared-memory reads. What the design does about
// that: score tiles stay in shared memory; each thread keeps a 4x4 tile of
// s and dp and a 4 x D/16 tile of its outputs in registers, so every shared
// load feeds four FMAs; tiles that are staged transposed are padded so the
// inner loops are free of bank conflicts; under causal masking the tiles
// past the diagonal are skipped unless a row of the tile has every key
// masked (the forward's rule). Tensor cores are the next step.

#include "flash_common.cuh"

namespace {

using dlx_flash::NEG_INF;
using dlx_flash::Strides;
using dlx_flash::dropout_hash;
using dlx_flash::from_float;
using dlx_flash::round_to;
using dlx_flash::to_float;

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

template <typename T, int D>
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

  const T* qp = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kp = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vp = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* op = static_cast<const T*>(p.out) + b * p.so.b + h * p.so.h;
  const T* dop = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  T* dqp = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  const uint32_t salt = static_cast<uint32_t>(b * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    const bool in = row < p.Sq;
    Qs[r * RLD + d] = in ? to_float(qp[row * p.sq.s + d * p.sq.d]) : 0.0f;
    dOs[r * RLD + d] = in ? to_float(dop[row * p.sdo.s + d * p.sdo.d]) : 0.0f;
  }
  __syncthreads();

  {  // delta = rowsum(dO * O), four threads to a row
    const int r = tid >> 2, part = tid & 3;
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < p.Sq)
      for (int d = part; d < D; d += 4)
        acc += dOs[r * RLD + d] * to_float(op[row * p.so.s + d * p.so.d]);
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
      const bool in = col < p.Sk;
      Kt[d * KLD + c] = in ? to_float(kp[col * p.sk.s + d * p.sk.d]) : 0.0f;
      Vt[d * KLD + c] = in ? to_float(vp[col * p.sv.s + d * p.sv.d]) : 0.0f;
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
          ds = round_to<T>(pr * (dpv - delta_r[i]) * p.scale);
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
      dqp[row * p.sdq.s + (tx + 16 * j) * p.sdq.d] = from_float<T>(acc[i][j]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * D * (BQ + 1) +
                          2 * BK * (BQ + 1) + 2 * BQ) +
         sizeof(int) * BK;
}

template <typename T, int D>
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

  const T* qp = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kp = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vp = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* dop = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  T* dkp = static_cast<T*>(p.dk) + b * p.sdk.b + h * p.sdk.h;
  T* dvp = static_cast<T*>(p.dv) + b * p.sdv.b + h * p.sdv.h;
  const uint32_t salt = static_cast<uint32_t>(b * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;

  for (int i = tid; i < BK * D; i += NTHREADS) {
    const int c = i / D, d = i % D;
    const int col = k0 + c;
    const bool in = col < p.Sk;
    Ks[c * RLD + d] = in ? to_float(kp[col * p.sk.s + d * p.sk.d]) : 0.0f;
    Vs[c * RLD + d] = in ? to_float(vp[col * p.sv.s + d * p.sv.d]) : 0.0f;
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
      const bool in = row < p.Sq;
      Qt[d * QLD + r] = in ? to_float(qp[row * p.sq.s + d * p.sq.d]) : 0.0f;
      dOt[d * QLD + r] = in ? to_float(dop[row * p.sdo.s + d * p.sdo.d]) : 0.0f;
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
          pu = round_to<T>(pu);  // P meets dO in dO's dtype
          ds = round_to<T>(pr * (dpv - delta_s[r]) * p.scale);
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
      dkp[col * p.sdk.s + d * p.sdk.d] = from_float<T>(dk[i][j]);
      dvp[col * p.sdv.s + d * p.sdv.d] = from_float<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, bool dq, cudaStream_t stream) {
  const size_t smem = dq ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  void (*kernel)(const Params) =
      dq ? flash_bwd_dq_kernel<T, D> : flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = dq ? (p.Sq + BQ - 1) / BQ : (p.Sk + BK - 1) / BK;
  kernel<<<dim3(tiles, p.H, p.B), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, bool dq, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, dq, stream);
    case 64: return launch<T, 64>(p, dq, stream);
    case 128: return launch<T, 128>(p, dq, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dq, const void* q, const void* k, const void* v, const void* out,
        const void* dout, const float* lse, const int* mask, void* dqp,
        void* dkp, void* dvp, float* delta, const long long* strides, int B,
        int H, int Sq, int Sk, int D, int is_bf16, float scale, int causal,
        int dropout, unsigned int threshold, float one_minus_rate,
        unsigned int seed, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_d<__nv_bfloat16>(p, D, dq, s)
                                  : launch_d<float>(p, D, dq, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound with ctypes; both take the same arguments.
// strides holds 32 element strides, (batch, seq, head, dim) for q, k, v, out,
// dout, dq, dk and dv in that order. dlx_flash_bwd_dq writes dq and delta;
// dlx_flash_bwd_dkv reads delta and writes dk and dv, so it is launched
// second on the same stream. Each returns its launch's cudaError_t.
extern "C" int dlx_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const int* mask, void* dq, void* dk,
    void* dv, float* delta, const long long* strides, int B, int H, int Sq,
    int Sk, int D, int is_bf16, float scale, int causal, int dropout,
    unsigned int threshold, float one_minus_rate, unsigned int seed,
    void* stream) {
  return run(true, q, k, v, out, dout, lse, mask, dq, dk, dv, delta, strides,
             B, H, Sq, Sk, D, is_bf16, scale, causal, dropout, threshold,
             one_minus_rate, seed, stream);
}

extern "C" int dlx_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const int* mask, void* dq, void* dk,
    void* dv, float* delta, const long long* strides, int B, int H, int Sq,
    int Sk, int D, int is_bf16, float scale, int causal, int dropout,
    unsigned int threshold, float one_minus_rate, unsigned int seed,
    void* stream) {
  return run(false, q, k, v, out, dout, lse, mask, dq, dk, dv, delta, strides,
             B, H, Sq, Sk, D, is_bf16, scale, causal, dropout, threshold,
             one_minus_rate, seed, stream);
}
