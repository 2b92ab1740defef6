// JPEG decode on the card with nvJPEG, for the data plane of a host without
// libjpeg (host code: no kernel of its own).
//
// nvJPEG is the CUDA toolkit's decoder, the one behind the reference's DALI
// "mixed" pipelines (PyTorch/Classification/ConvNets/image_classification/
// dataloaders.py:80-154: ops.ImageDecoder(device="mixed")). Each image is
// decoded whole, at its own size, into a packed device buffer that the caller
// allocates: RGB interleaved (3 bytes a pixel), or one byte a pixel for a
// grayscale JPEG, which the resample kernel (csrc/resample_normalize.cu)
// replicates. nvJPEG's default backend parses and Huffman-decodes on the host
// and runs the IDCT and color conversion on the card.
//
// A batch is spread over the context's host threads, each with its own
// nvjpegJpegState and its own stream (the handle is shared, as nvJPEG
// allows). A state's buffers (the host's Huffman output and its copy on the
// card) are written again by the state's next decode, so a thread waits for
// its stream after each image before it reuses its state; the decode has
// ended on the card when the call returns, and it never waits for the
// caller's own work there. The caller allocates the output where no queued
// work of its own can still use that memory (native/__init__.py: on the
// plane's own stream). An image that fails to decode is flagged, not raised;
// the caller writes it as zeros.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <atomic>
#include <thread>
#include <vector>

namespace {

struct Context {
  nvjpegHandle_t handle = nullptr;
  std::vector<nvjpegJpegState_t> states;
  std::vector<cudaStream_t> streams;  // one a state
};

void destroy(Context* ctx) {
  for (auto s : ctx->states) nvjpegJpegStateDestroy(s);
  for (auto s : ctx->streams) cudaStreamDestroy(s);
  if (ctx->handle) nvjpegDestroy(ctx->handle);
  delete ctx;
}

}  // namespace

extern "C" {

// A context with n_threads decoder states and streams on the current
// device, or nullptr if nvJPEG or CUDA fails.
void* dlx_nvjpeg_create(int n_threads) {
  auto* ctx = new Context;
  if (nvjpegCreateSimple(&ctx->handle) != NVJPEG_STATUS_SUCCESS) {
    ctx->handle = nullptr;
    destroy(ctx);
    return nullptr;
  }
  for (int t = 0; t < (n_threads > 0 ? n_threads : 1); ++t) {
    nvjpegJpegState_t state;
    if (nvjpegJpegStateCreate(ctx->handle, &state) != NVJPEG_STATUS_SUCCESS) {
      destroy(ctx);
      return nullptr;
    }
    ctx->states.push_back(state);
    cudaStream_t stream;
    if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
        cudaSuccess) {
      destroy(ctx);
      return nullptr;
    }
    ctx->streams.push_back(stream);
  }
  return ctx;
}

void dlx_nvjpeg_destroy(void* ptr) {
  if (ptr) destroy(static_cast<Context*>(ptr));
}

// Header only: width, height and the channels the decode writes (1 for a
// grayscale JPEG, else 3). Returns 0 on success.
int dlx_nvjpeg_info(void* ptr, const uint8_t* data, size_t len, int* w, int* h,
                    int* c) {
  auto* ctx = static_cast<Context*>(ptr);
  int n_comp = 0;
  nvjpegChromaSubsampling_t ss;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(ctx->handle, data, len, &n_comp, &ss, widths,
                         heights) != NVJPEG_STATUS_SUCCESS ||
      widths[0] <= 0 || heights[0] <= 0)
    return -1;
  *w = widths[0];
  *h = heights[0];
  *c = ss == NVJPEG_CSS_GRAY ? 1 : 3;
  return 0;
}

// Decode n images into dst (image i at dst + offsets[i], w * c bytes a row,
// w, h, c as dlx_nvjpeg_info gives them, listed in dims as (n, 3) int32). An
// image whose dims hold a width of 0 is skipped. failed[i] is set to 1 for an
// image that fails, else 0. Returns the count of failures, or -1 if the
// current device cannot be read. The decode has ended on the card when the
// call returns.
int dlx_nvjpeg_decode_batch(void* ptr, int n, const uint8_t** datas,
                            const size_t* lens, const int* dims, uint8_t* dst,
                            const long long* offsets, int* failed) {
  auto* ctx = static_cast<Context*>(ptr);
  std::atomic<int> next(0), failures(0);
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  auto work = [&](nvjpegJpegState_t state, cudaStream_t stream) {
    cudaSetDevice(device);  // a new thread starts on device 0
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      const int w = dims[i * 3], c = dims[i * 3 + 2];
      int bad = 1;
      if (w > 0) {
        nvjpegImage_t img = {};
        img.channel[0] = dst + offsets[i];
        img.pitch[0] = static_cast<size_t>(w) * c;
        bad = nvjpegDecode(ctx->handle, state, datas[i], lens[i],
                           c == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &img,
                           stream) != NVJPEG_STATUS_SUCCESS;
        // the state's buffers are free again once the stream has run
        bad |= cudaStreamSynchronize(stream) != cudaSuccess;
      }
      failed[i] = bad;
      if (bad) failures.fetch_add(1);
    }
  };
  const int states = static_cast<int>(ctx->states.size());
  const int n_threads = states < n ? states : n;
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t)
    threads.emplace_back(work, ctx->states[t], ctx->streams[t]);
  if (n_threads > 0) work(ctx->states[0], ctx->streams[0]);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
