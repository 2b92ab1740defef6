// Crop + bilinear resize + horizontal flip + mean/std normalize of a batch of
// decoded images, for Hopper (sm_90a), written by hand.
//
// The card's half of the data plane on a host without libjpeg: nvJPEG
// (csrc/nvjpeg_decode.cu) decodes each JPEG whole on the card, and this kernel
// turns the batch into the (N, S, S, 3) fp32 NHWC tensor that the host data
// plane's resample_normalize (native/dataplane.cc, a copy of
// deeplearningexamples_tpu/native/dataplane.cc:106) writes. Its geometry is
// that function's, step for step:
//
// - libjpeg there decodes at 1/d of the image's size, d the largest power of
//   two up to 8 that leaves the image at least out_size / crop on each axis
//   (dataplane.cc:69-78); nvJPEG has no scaled decode, so d comes with each
//   image, and a pixel of the 1/d image (ceil(W / d) x ceil(H / d), libjpeg's
//   output size) is the mean of its d x d block of the full one, rounded to
//   the nearest byte. libjpeg's scaled IDCT is close to that block mean, not
//   equal to it.
// - the crop, in fractions of the image, is taken in the 1/d image's pixels;
//   output pixel (oy, ox) samples it at cy + (oy + 0.5) sy - 0.5, clamped to
//   the image, bilinearly; a flip writes column S - 1 - ox.
// - every operation is rounded as the host's fp32 code rounds it: the
//   __f*_rn intrinsics keep nvcc from contracting a product and a sum into one
//   FMA, so the kernel gives the plain PyTorch version's bits
//   (ops/resample.py, resample_normalize_reference).
//
// A grayscale image comes as one channel, replicated, as libjpeg's RGB output
// replicates it. An image whose width is 0 (one nvJPEG could not decode) is
// written as zeros, as the host plane zero-fills a failed image.
//
// What bounds it on this card: device memory. Per output pixel it reads four
// source pixels (d x d bytes each when d > 1) and writes 12 bytes, with a
// dozen fp32 operations a channel. One thread per output pixel, 256 a block,
// a grid of (pixels / 256, N): the writes of a warp are 384 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// One channel of pixel (x, y) of the 1/d image: the byte itself at d = 1,
// else the rounded mean of its block of the full W x H image.
__device__ __forceinline__ float pixel(const uint8_t* __restrict__ src, int w,
                                       int h, int c, int d, int x, int y,
                                       int ch) {
  const int k = c == 3 ? ch : 0;
  if (d == 1) return static_cast<float>(__ldg(src + (static_cast<long long>(y) * w + x) * c + k));
  const int x0 = x * d, y0 = y * d;
  const int x1 = min(x0 + d, w), y1 = min(y0 + d, h);
  int sum = 0;
  for (int yy = y0; yy < y1; ++yy)
    for (int xx = x0; xx < x1; ++xx)
      sum += __ldg(src + (static_cast<long long>(yy) * w + xx) * c + k);
  const int cnt = (x1 - x0) * (y1 - y0);
  return static_cast<float>((sum + cnt / 2) / cnt);
}

__global__ void __launch_bounds__(THREADS)
    resample_normalize_kernel(const uint8_t* __restrict__ src,
                              const long long* __restrict__ offsets,
                              const int* __restrict__ dims,
                              const float* __restrict__ crops,
                              const int* __restrict__ flips,
                              float* __restrict__ out, int out_size, float m0,
                              float m1, float m2, float s0, float s1, float s2) {
  const int i = blockIdx.y;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= out_size * out_size) return;
  const int oy = p / out_size, ox = p % out_size;
  const int w = dims[i * 4], h = dims[i * 4 + 1], c = dims[i * 4 + 2],
            d = dims[i * 4 + 3];
  const int ox_dst = flips[i] ? out_size - 1 - ox : ox;
  float* o = out + ((static_cast<long long>(i) * out_size + oy) * out_size + ox_dst) * 3;
  if (w == 0) {
    o[0] = o[1] = o[2] = 0.0f;
    return;
  }
  const int sw = (w + d - 1) / d, sh = (h + d - 1) / d;  // libjpeg's output size
  const float cx = __fmul_rn(crops[i * 4], static_cast<float>(sw));
  const float cy = __fmul_rn(crops[i * 4 + 1], static_cast<float>(sh));
  const float sx = __fdiv_rn(__fmul_rn(crops[i * 4 + 2], static_cast<float>(sw)),
                             static_cast<float>(out_size));
  const float sy = __fdiv_rn(__fmul_rn(crops[i * 4 + 3], static_cast<float>(sh)),
                             static_cast<float>(out_size));
  float fy = __fsub_rn(__fadd_rn(cy, __fmul_rn(__fadd_rn(static_cast<float>(oy), 0.5f), sy)), 0.5f);
  fy = fminf(fmaxf(fy, 0.0f), static_cast<float>(sh - 1));
  const int y0 = static_cast<int>(fy);
  const int y1 = min(y0 + 1, sh - 1);
  const float wy = __fsub_rn(fy, static_cast<float>(y0));
  float fx = __fsub_rn(__fadd_rn(cx, __fmul_rn(__fadd_rn(static_cast<float>(ox), 0.5f), sx)), 0.5f);
  fx = fminf(fmaxf(fx, 0.0f), static_cast<float>(sw - 1));
  const int x0 = static_cast<int>(fx);
  const int x1 = min(x0 + 1, sw - 1);
  const float wx = __fsub_rn(fx, static_cast<float>(x0));
  const uint8_t* img = src + offsets[i];
  const float mean[3] = {m0, m1, m2};
  const float stdev[3] = {s0, s1, s2};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float p00 = pixel(img, w, h, c, d, x0, y0, ch);
    const float p01 = pixel(img, w, h, c, d, x1, y0, ch);
    const float p10 = pixel(img, w, h, c, d, x0, y1, ch);
    const float p11 = pixel(img, w, h, c, d, x1, y1, ch);
    const float top = __fadd_rn(p00, __fmul_rn(__fsub_rn(p01, p00), wx));
    const float bot = __fadd_rn(p10, __fmul_rn(__fsub_rn(p11, p10), wx));
    const float v = __fmul_rn(__fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), wy)),
                              1.0f / 255.0f);
    o[ch] = __fmul_rn(__fsub_rn(v, mean[ch]), __fdiv_rn(1.0f, stdev[ch]));
  }
}

}  // namespace

extern "C" {

// src: the batch's decoded images, packed (image i at src + offsets[i]: h rows
// of w pixels of c bytes); dims: (N, 4) int32 w, h, c, d; crops: (N, 4) fp32
// x, y, w, h fractions; flips: (N,) int32; out: (N, out_size, out_size, 3)
// fp32. Returns the CUDA error of the launch (0 on success).
int dlx_resample_normalize(const uint8_t* src, const long long* offsets,
                           const int* dims, const float* crops,
                           const int* flips, float* out, int n, int out_size,
                           float m0, float m1, float m2, float s0, float s1,
                           float s2, cudaStream_t stream) {
  if (n <= 0 || out_size <= 0) return 0;
  const dim3 grid((out_size * out_size + THREADS - 1) / THREADS, n);
  resample_normalize_kernel<<<grid, THREADS, 0, stream>>>(
      src, offsets, dims, crops, flips, out, out_size, m0, m1, m2, s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
