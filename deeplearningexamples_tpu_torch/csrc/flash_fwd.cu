// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU Pallas forward kernels of deeplearningexamples_tpu/ops/
// flash_attention.py: _fwd_bshd/_fwd_kernel_bshd (the BERT path, (B,S,H,D)),
// _fwd/_fwd_kernel (the (B,H,S,D) fallback) and _fwd_kblk/_fwd_kernel_kblk
// (the K-blocked long-context path). One kernel covers all three: it takes
// q, k, v and out by pointer plus four element strides each, so either layout
// is read and written in place, and it always walks K/V in tiles with an
// online softmax, so its shared memory does not grow with the sequence.
//
// What it computes, per (batch b, head h, query row r):
//   s[c]  = (q[r] . k[c]) * scale              fp32 accumulation
//   s[c]  = -1e30 where key c is masked, or where causal and r < c
//   p[c]  = exp(s[c] - max(s)),  l = sum(p)    l is taken before dropout
//   p[c] *= keep(r, c) / (1 - rate)            optional, stateless hash
//   out   = (sum_c round_to_input_dtype(p[c]) * v[c]) / l
//   lse   = max(s) + log(l)                    (B, H, Sq) fp32
// A row whose every key is masked therefore averages V uniformly (as
// mha_reference does), never NaN.
//
// What bounds it on this card: per (b, h) the work is 4*S*S*D flops against
// 4*S*D bf16 values of q/k/v/out, S/2 flops per byte (192 at BERT-Large's
// S=384), so with the fp32 FMA pipe this first version uses it is bound by
// FMA issue and shared-memory reads, not by device memory. Measured at B=8,
// S=384, H=16, D=64 in bf16: 0.265 ms a call, 18 TFLOP/s (NVIDIA H100 80GB
// HBM3, 700 W power limit). What the design does about that: the (BQ x S)
// score block never reaches device memory (the plain version writes and
// re-reads it several times); each thread keeps a 4x4 score tile and a
// 4 x D/16 output tile in registers, so every shared-memory load feeds four
// FMAs; K is staged transposed and rows are padded so the inner loops are
// free of bank conflicts. Tensor cores (mma.sync, then wgmma with TMA loads)
// are the next step.

#include "flash_common.cuh"

namespace {

using dlx_flash::NEG_INF;
using dlx_flash::Strides;
using dlx_flash::dropout_hash;
using dlx_flash::from_float;
using dlx_flash::to_float;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NTHREADS = 256; // 16 x 16 threads; each owns 4 rows x 4 cols

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // (B, Sk) int32, nonzero = attend; null = no mask
  void* out;
  float* lse;       // (B, H, Sq)
  Strides sq, sk, sv, so;
  int B, H, Sq, Sk;
  float scale;
  int causal;
  int dropout;
  uint32_t threshold;    // keep iff hash >= threshold (int(rate * 2**31))
  float one_minus_rate;  // fp32(1 - rate); kept values scale by 1/this
  uint32_t seed;         // the int32 seed's bits
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
             (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1)) +
         sizeof(int) * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  constexpr int QLD = D + 1;   // padded row stride of Qs
  constexpr int KLD = BK + 1;  // padded row stride of Kt (K transposed)
  constexpr int PLD = BK + 1;  // padded row stride of Ps
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][QLD]
  float* Kt = Qs + BQ * QLD;     // [D][KLD]
  float* Vs = Kt + D * KLD;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][PLD]
  int* Ms = reinterpret_cast<int*>(Ps + BQ * PLD);  // [BK] key valid

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: cols tx + 16*j
  const int ty = tid >> 4;  // row group: rows 4*ty + i
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qp = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kp = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vp = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  T* op = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;
  const uint32_t salt = static_cast<uint32_t>(b * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * QLD + d] =
        row < p.Sq ? to_float(qp[row * p.sq.s + d * p.sq.d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (p.Sk + BK - 1) / BK;
  // causal: tiles wholly above the diagonal of this query tile are skipped
  const int n_live = p.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  for (int kt = 0; kt < nk; ++kt) {
    if (kt == n_live) {
      // Past the diagonal every score is -1e30. That only matters to a row
      // whose every key so far was masked: mha_reference then averages V
      // over ALL keys, so such a block goes on through the skipped tiles.
      bool dead = false;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dead |= (q0 + 4 * ty + i < p.Sq) && (m[i] == NEG_INF);
      if (!__syncthreads_or(dead)) break;
    }
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Vs and Ps are no longer read
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int c = i / D, d = i % D;
      const int col = k0 + c;
      const bool in = col < p.Sk;
      Kt[d * KLD + c] = in ? to_float(kp[col * p.sk.s + d * p.sk.d]) : 0.0f;
      Vs[c * D + d] = in ? to_float(vp[col * p.sv.s + d * p.sv.d]) : 0.0f;
    }
    if (tid < BK) {
      const int col = k0 + tid;
      Ms[tid] = col >= p.Sk ? -1 : (p.mask ? (p.mask[b * p.Sk + col] != 0) : 1);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * KLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int valid = Ms[c];
        float x = s[i][j] * p.scale;  // scale first, then mask
        if (valid < 0) {
          x = -INFINITY;  // past Sk: not a key at all
        } else if (!valid || (p.causal && row < k0 + c)) {
          x = NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float e = expf(s[i][j] - m_new);
        rs += e;
        if (p.dropout) {
          const uint32_t u = dropout_hash(static_cast<uint32_t>(row),
                                          static_cast<uint32_t>(k0 + c),
                                          p.seed, salt);
          e = u >= p.threshold ? e * keep_scale : 0.0f;
        }
        // P meets V in the input dtype, as on the TPU's MXU
        Ps[(4 * ty + i) * PLD + c] = to_float(from_float<T>(e));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      op[row * p.so.s + (tx + 16 * j) * p.so.d] = from_float<T>(acc[i][j] / l[i]);
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. strides holds 16 element strides:
// (batch, seq, head, dim) for q, k, v and out, in that order. Returns the
// launch's cudaError_t; the kernel runs asynchronously on `stream`.
extern "C" int dlx_flash_fwd(const void* q, const void* k, const void* v,
                             const int* mask, void* out, float* lse,
                             const long long* strides, int B, int H, int Sq,
                             int Sk, int D, int is_bf16, float scale,
                             int causal, int dropout, unsigned int threshold,
                             float one_minus_rate, unsigned int seed,
                             void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.out = out;
  p.lse = lse;
  Strides* st[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int t = 0; t < 4; ++t)
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
  const cudaError_t err = is_bf16 ? launch_d<__nv_bfloat16>(p, D, s)
                                  : launch_d<float>(p, D, s);
  return static_cast<int>(err);
}
