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
// Two instances, chosen by is_bf16 in the one entry point:
//
// bf16, flash_fwd_mma_kernel, on the tensor cores. A block of 4 warps owns
// 64 query rows, 16 a warp. Q is copied once into shared memory (cp.async,
// 16 bytes a copy) and moved with ldmatrix into A fragments that stay in
// registers for the whole key loop. K, V and the key mask come in tiles of
// 64 keys, double-buffered with cp.async, so the next tile's copy overlaps
// this tile's products and no warp waits on a load of its own; rows are
// padded by 8 bf16 so that ldmatrix is free of bank conflicts. S = Q K^T is
// mma.sync m16n8k16 (bf16 in, fp32 sums); the mask, the causal rule, the
// past-Sk rule, the online softmax and the dropout hash run on the C
// fragments in registers (a lane holds 2 rows, so row max and sum reduce
// across the 4 lanes of a quad), and a tile whose keys are all valid and
// below the diagonal skips the mask's per-element work. P is rounded to
// bf16 straight into A fragments, and O += P V takes V through
// ldmatrix.trans. The epilogue divides by l, rounds once and stores through
// shared memory so the writes are 16-byte and coalesced.
// What bounds it now: per (b, h) the work is 4*S*S*D flops against 4*S*D
// bf16 values of q/k/v/out, S/2 flops per byte (192 at S=384), far above
// the card's ridge, yet it runs at about 77 TFLOP/s at B=8 S=384 (0.063 ms,
// 8% of the bf16 peak; 88 TFLOP/s causal at S=2048; NVIDIA H100 80GB HBM3,
// 700 W): each warp issues its products, then its softmax, then its next
// products in turn, so the tensor cores wait on the exp and FMA work and
// on the two barriers of each tile. wgmma with TMA loads and warp
// specialisation, which overlap one tile's softmax with the next tile's
// products, are the next step.
//
// Head dims: each kernel is instantiated at tile widths D = 32, 64 and 128.
// A head dim of one of those, in bf16 tensors whose pointers and batch, seq
// and head strides are whole 16 bytes, runs the FULL instance (16-byte
// copies, no column predicate). Any other head dim up to 128 (BERT's
// 4l-312 student has 312 / 12 = 26), or a bf16 view with narrower
// alignment, runs the instance of the next tile width: Q, K and V load with
// the widest copy every pointer and stride allow (16, 8, 4 or 2 bytes; 52
// bytes a head at D = 26 take 4), the columns past the head dim are zero in
// shared memory, so they add nothing to Q K^T and give zero output columns,
// and only the head dim's columns are stored. The caller's scale is the true
// head dim's.
//
// fp32, flash_fwd_kernel, the FMA pipe: each thread keeps a 4x4 score tile
// and a 4 x D/16 output tile in registers, so every shared-memory load
// feeds four FMAs. It stays on the FMA pipe because the fp32 path is the
// exact one: the card's fp32 QA logits read 5.2e-6 against the CPU and a
// BERT step's worst fp32 gradient 1.42e-6 of the largest entry, while TF32
// mma keeps about three decimal digits and would lose that; the main paths
// run in bf16.

#include <algorithm>

#include "flash_common.cuh"

namespace {

using dlx_flash::NEG_INF;
using dlx_flash::Strides;
using dlx_flash::dropout_hash;

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
  int b_offset;          // global row of batch row 0 (the dropout salt's b)
  int Dv;                // the head dim, <= the instance's tile width D
  int unit;              // bf16: bytes a copy (copy_unit in flash_common.cuh)
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
             (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1)) +
         sizeof(int) * BK;
}

// FULL: the head dim is D. Otherwise it is p.Dv < D: the columns past it
// load as zeros and are not stored.
template <int D, bool FULL>
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

  const float* qp = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kp = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vp = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  float* op = static_cast<float*>(p.out) + b * p.so.b + h * p.so.h;
  const uint32_t salt = static_cast<uint32_t>((b + p.b_offset) * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * QLD + d] = row < p.Sq && (FULL || d < p.Dv)
                          ? qp[row * p.sq.s + d * p.sq.d]
                          : 0.0f;
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
      const bool in = col < p.Sk && (FULL || d < p.Dv);
      Kt[d * KLD + c] = in ? kp[col * p.sk.s + d * p.sk.d] : 0.0f;
      Vs[c * D + d] = in ? vp[col * p.sv.s + d * p.sv.d] : 0.0f;
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
        Ps[(4 * ty + i) * PLD + c] = e;
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
      if (FULL || tx + 16 * j < p.Dv)
        op[row * p.so.s + (tx + 16 * j) * p.so.d] = acc[i][j] / l[i];
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] = m[i] + logf(l[i]);
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

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q (later the output tile), two K and two V tiles, two rows of the mask
  return sizeof(bf16) * (D + PAD) * (BQ + 4 * BK) + sizeof(int) * 2 * BK;
}

template <int D, bool FULL>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;   // k16 steps over the head dim
  constexpr int NT = BK / 8;   // n8 tiles of a warp's 16 x BK scores
  constexpr int DT = D / 8;    // n8 tiles of a warp's 16 x D output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]
  int* Ms = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // [2][BK] key mask

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  bf16* op = static_cast<bf16*>(p.out) + b * p.so.b + h * p.so.h;
  const uint32_t salt = static_cast<uint32_t>((b + p.b_offset) * p.H + h);
  const float keep_scale = 1.0f / p.one_minus_rate;
  // this lane's two query rows: g and g+8 of the warp's 16
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
  load_kv(0, 0);  // one group with Q

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  uint32_t qf[KS][4];

  const int nk = (p.Sk + BK - 1) / BK;
  // causal: tiles wholly above the diagonal of this query tile are skipped
  const int n_live = p.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  int n_tiles = n_live;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_a(qf[kk], Qs, LD, warp * 16, kk * 16);
    }
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;
    const int* Mb = Ms + buf * BK;
    const int k0 = kt * BK;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_b(kb, Kb, LD, np * 16, kk * 16);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // scale first, then mask; the row max over this tile. Most tiles have
    // every key valid and none past Sk or the diagonal: they skip the mask.
    float mx[2] = {-INFINITY, -INFINITY};
    const bool plain =
        k0 + BK <= p.Sk && !(p.causal && k0 + BK - 1 > q0 + warp * 16) &&
        (!p.mask || __all_sync(0xffffffffu, Mb[lane] && Mb[lane + 32]));
    if (plain) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= p.scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          float x = s[j][e] * p.scale;
          if (k0 + c >= p.Sk) {
            x = -INFINITY;  // past Sk: not a key at all
          } else if ((p.mask && !Mb[c]) ||
                     (p.causal && rows[e >> 1] < k0 + c)) {
            x = NEG_INF;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float m_new[2], corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = exp_approx(m[r] - m_new[r]);
    }
    // p = exp(s - m); l sums it before dropout; P meets V in bf16
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp_approx(s[j][e] - m_new[e >> 1]);
        rs[e >> 1] += x;
        if (p.dropout) {
          const uint32_t u = dropout_hash(
              static_cast<uint32_t>(rows[e >> 1]),
              static_cast<uint32_t>(k0 + j * 8 + 2 * t + (e & 1)), p.seed, salt);
          x = u >= p.threshold ? x * keep_scale : 0.0f;
        }
        s[j][e] = x;
      }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) a_from_c(pf[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_bt(vb, Vb, LD, kk * 16, dp * 16);
        mma_bf16(acc[2 * dp], pf[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vb[2], vb[3]);
      }

    if (kt + 1 == n_tiles && n_tiles < nk) {
      // Past the diagonal every score is -1e30. That only matters to a row
      // whose every key so far was masked: mha_reference then averages V
      // over ALL keys, so such a block goes on through the skipped tiles.
      bool dead = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) dead |= rows[r] < p.Sq && m[r] == NEG_INF;
      if (__syncthreads_or(dead)) {
        n_tiles = nk;
        load_kv(kt + 1, buf ^ 1);  // that buffer was last read a tile ago
      }
    }
    __syncthreads();  // this tile's buffers may be refilled
  }

  // out = acc / l, rounded once, through the Q tile (Q is in registers)
  stage_c<D>(Qs, warp * 16, acc, l[0], l[1]);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < p.Sq)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + rows[r]] =
            m[r] + logf(l[r]);
  }
  __syncthreads();
  store_tile<BQ, D, FULL>(op, p.so.s, Qs, q0, p.Sq, p.Dv, p.unit);
}

template <int D, bool FULL>
cudaError_t launch_d(const Params& p, bool bf16_in, cudaStream_t stream) {
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  if (bf16_in)
    return dlx_flash::launch_kernel(flash_fwd_mma_kernel<D, FULL>, grid,
                                    MMA_THREADS, mma_smem_bytes<D>(), stream, p);
  return dlx_flash::launch_kernel(flash_fwd_kernel<D, FULL>, grid, NTHREADS,
                                  smem_bytes<D>(), stream, p);
}

template <int D>
cudaError_t launch_w(const Params& p, bool bf16_in, bool full,
                     cudaStream_t stream) {
  return full ? launch_d<D, true>(p, bf16_in, stream)
              : launch_d<D, false>(p, bf16_in, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. strides holds 16 element strides:
// (batch, seq, head, dim) for q, k, v and out, in that order; D is the head
// dim, 1 to 128. Returns the launch's cudaError_t, or kMisaligned
// (flash_common.cuh) without launching when a bf16 pointer is off a 2-byte
// boundary; the kernel runs asynchronously on `stream`.
extern "C" int dlx_flash_fwd(const void* q, const void* k, const void* v,
                             const int* mask, void* out, float* lse,
                             const long long* strides, int B, int H, int Sq,
                             int Sk, int D, int is_bf16, float scale,
                             int causal, int dropout, unsigned int threshold,
                             float one_minus_rate, unsigned int seed,
                             int b_offset, void* stream) {
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
  p.b_offset = b_offset;
  p.Dv = D;
  p.unit = 16;
  using dlx_flash::copy_unit;
  if (is_bf16) {
    p.unit = std::min({copy_unit(q, p.sq, B, Sq, H, D),
                       copy_unit(k, p.sk, B, Sk, H, D),
                       copy_unit(v, p.sv, B, Sk, H, D),
                       copy_unit(out, p.so, B, Sq, H, D)});
    if (p.unit == 0) return dlx_flash::kMisaligned;
  }
  const int width = dlx_flash::tile_width(D);
  const bool full = D == width && p.unit == 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (width) {
    case 32: err = launch_w<32>(p, is_bf16, full, s); break;
    case 64: err = launch_w<64>(p, is_bf16, full, s); break;
    case 128: err = launch_w<128>(p, is_bf16, full, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
