// Copy of deeplearningexamples_tpu/native/dataplane.cc: the host data plane.
//
// JPEG decode (libjpeg, JDCT_IFAST, with the DCT-domain 1/2^k downscale) +
// crop + bilinear resize + horizontal flip + mean/std normalize, fused into
// one pass per image and fanned out over a pthread pool per batch: the role
// DALI's pipelines play in the reference
// (PyTorch/Classification/ConvNets/image_classification/dataloaders.py:80-205,
// PyTorch/Detection/SSD/ssd/coco_pipeline.py:27-160). The port runs it where
// the host has libjpeg; on a host without it the card decodes with nvJPEG and
// resamples with csrc/resample_normalize.cu, whose geometry is this file's.
//
// Exposed as a C ABI for ctypes. Built at first use by native/__init__.py
// (g++ -O3 -march=native -fPIC -std=c++17 -shared -ljpeg -lpthread).
//
// Differences from the source, none in what a batch decodes to: the C ABI
// also exports resample_normalize alone (dlx_resample_normalize), which the
// tests hold the card's plain version against, and a batch's last job
// signals its end under the lock, so the caller cannot return (and free the
// lock and the condition variable) while a worker still touches them.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, with DCT-domain downscale selection)
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decodes to RGB. Picks libjpeg's 1/2^k DCT scaling so the decoded image is
// the smallest size still >= min_target on both axes (big speedup for the
// common decode-then-shrink path). Returns malloc'd buffer or nullptr.
uint8_t* decode_jpeg(const uint8_t* data, size_t len, int min_target_w,
                     int min_target_h, int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  uint8_t* buffer = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    free(buffer);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  cinfo.out_color_space = JCS_RGB;
  if (min_target_w > 0 && min_target_h > 0) {
    int denom = 1;
    while (denom < 8 && (int)cinfo.image_width / (denom * 2) >= min_target_w &&
           (int)cinfo.image_height / (denom * 2) >= min_target_h) {
      denom *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  cinfo.dct_method = JDCT_IFAST;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int stride = w * cinfo.output_components;
  buffer = static_cast<uint8_t*>(malloc(static_cast<size_t>(h) * stride));
  if (!buffer) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buffer + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  // grayscale promoted by libjpeg via out_color_space=RGB, components == 3
  jpeg_destroy_decompress(&cinfo);
  *out_w = w;
  *out_h = h;
  return buffer;
}

// ---------------------------------------------------------------------------
// Fused crop -> bilinear resize -> flip -> normalize (NHWC float32)
// ---------------------------------------------------------------------------

void resample_normalize(const uint8_t* src, int src_w, int src_h, float cx,
                        float cy, float cw, float ch, int out_size, bool hflip,
                        const float* mean, const float* stdev, float* out) {
  const float sx = cw / out_size;
  const float sy = ch / out_size;
  float inv_std[3] = {1.0f / stdev[0], 1.0f / stdev[1], 1.0f / stdev[2]};
  for (int oy = 0; oy < out_size; ++oy) {
    float fy = cy + (oy + 0.5f) * sy - 0.5f;
    fy = std::min(std::max(fy, 0.0f), static_cast<float>(src_h - 1));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, src_h - 1);
    const float wy = fy - y0;
    float* out_row = out + static_cast<size_t>(oy) * out_size * 3;
    for (int ox = 0; ox < out_size; ++ox) {
      const int ox_dst = hflip ? (out_size - 1 - ox) : ox;
      float fx = cx + (ox + 0.5f) * sx - 0.5f;
      fx = std::min(std::max(fx, 0.0f), static_cast<float>(src_w - 1));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, src_w - 1);
      const float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * src_w + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * src_w + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * src_w + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * src_w + x1) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        const float v = (top + (bot - top) * wy) * (1.0f / 255.0f);
        out_row[ox_dst * 3 + c] = (v - mean[c]) * inv_std[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Thread pool
// ---------------------------------------------------------------------------

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace

extern "C" {

// Decode header only; returns 0 on success.
int dlx_jpeg_info(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Fused single-image pipeline. crop_* are fractions of the source image
// (crop_x, crop_y = top-left; crop_w, crop_h = extent), so callers can draw
// RRC parameters without knowing pixel dims. Returns 0 on success.
int dlx_decode_rrc(const uint8_t* data, size_t len, float crop_x, float crop_y,
                   float crop_w, float crop_h, int out_size, int hflip,
                   const float* mean, const float* stdev, float* out) {
  int w = 0, h = 0;
  // decode no smaller than the crop needs
  const int min_w = static_cast<int>(out_size / std::max(crop_w, 1e-6f));
  const int min_h = static_cast<int>(out_size / std::max(crop_h, 1e-6f));
  uint8_t* img = decode_jpeg(data, len, std::min(min_w, 1 << 14),
                             std::min(min_h, 1 << 14), &w, &h);
  if (!img) return -1;
  resample_normalize(img, w, h, crop_x * w, crop_y * h, crop_w * w, crop_h * h,
                     out_size, hflip != 0, mean, stdev, out);
  free(img);
  return 0;
}

// resample_normalize alone, on an RGB image already decoded (src_w x src_h
// x 3 bytes): the crop in fractions of the image, as dlx_decode_rrc's.
void dlx_resample_normalize(const uint8_t* src, int src_w, int src_h,
                            float crop_x, float crop_y, float crop_w,
                            float crop_h, int out_size, int hflip,
                            const float* mean, const float* stdev, float* out) {
  resample_normalize(src, src_w, src_h, crop_x * src_w, crop_y * src_h,
                     crop_w * src_w, crop_h * src_h, out_size, hflip != 0,
                     mean, stdev, out);
}

void* dlx_pool_create(int n_threads) { return new ThreadPool(n_threads); }
void dlx_pool_destroy(void* pool) { delete static_cast<ThreadPool*>(pool); }

// Batch: n images -> out (n, out_size, out_size, 3) float32 NHWC.
// crops: n*4 floats (x, y, w, h fractions); flips: n ints.
// Returns number of failed images (their slots are zero-filled).
int dlx_pool_decode_batch(void* pool_ptr, int n, const uint8_t** datas,
                          const size_t* lens, const float* crops,
                          const int* flips, int out_size, const float* mean,
                          const float* stdev, float* out) {
  auto* pool = static_cast<ThreadPool*>(pool_ptr);
  std::atomic<int> failures(0);
  std::atomic<int> done(0);
  std::mutex mu;
  std::condition_variable cv;
  const size_t img_elems = static_cast<size_t>(out_size) * out_size * 3;
  for (int i = 0; i < n; ++i) {
    pool->submit([&, i] {
      int rc = dlx_decode_rrc(datas[i], lens[i], crops[i * 4], crops[i * 4 + 1],
                              crops[i * 4 + 2], crops[i * 4 + 3], out_size,
                              flips[i], mean, stdev, out + i * img_elems);
      if (rc != 0) {
        memset(out + i * img_elems, 0, img_elems * sizeof(float));
        failures.fetch_add(1);
      }
      std::lock_guard<std::mutex> lk(mu);
      if (done.fetch_add(1) + 1 == n) cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return failures.load();
}

}  // extern "C"
