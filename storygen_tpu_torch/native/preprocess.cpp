// Native host-side preprocessing for the port's input pipeline.
//
// The training loader feeds (3 refs + target + mask) x batch 512x512
// images per step; the uint8 -> float32 normalize + batch assembly is the
// host path between PIL decode and the copy to the card. This library
// fuses convert+scale+offset+pack into one multithreaded pass (and
// provides a bilinear resize).
//
// C ABI only; built by g++ at first use and loaded via ctypes
// (storygen_tpu_torch/native/__init__.py, which also holds the numpy form
// of each function). -ffp-contract=off keeps every product and sum
// rounded on its own, as numpy rounds them, so both forms agree bit for
// bit.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

void normalize_range(const uint8_t* src, float* dst, int64_t begin,
                     int64_t end, float scale, float offset) {
  for (int64_t i = begin; i < end; ++i) {
    dst[i] = static_cast<float>(src[i]) * scale + offset;
  }
}

int num_threads_for(int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  int t = static_cast<int>(std::min<int64_t>(hw ? hw : 4, n / (1 << 16)));
  return std::max(t, 1);
}

}  // namespace

extern "C" {

// Convert a contiguous uint8 buffer to float32: dst = src * scale + offset.
// Covers both conventions: scale=1/255, offset=0   -> [0, 1] (ref frames)
//                          scale=2/255, offset=-1  -> [-1, 1] (targets)
void normalize_u8_to_f32(const uint8_t* src, float* dst, int64_t n,
                         float scale, float offset) {
  int threads = num_threads_for(n);
  if (threads == 1) {
    normalize_range(src, dst, 0, n, scale, offset);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t b = t * chunk;
    int64_t e = std::min(n, b + chunk);
    if (b >= e) break;
    pool.emplace_back(normalize_range, src, dst, b, e, scale, offset);
  }
  for (auto& th : pool) th.join();
}

// Batched variant: `batch` images, each already decoded as uint8 HWC at
// (h, w, c), packed into one NHWC float32 output with normalize fused.
// srcs: array of `batch` pointers.
void assemble_batch_f32(const uint8_t* const* srcs, float* dst, int batch,
                        int64_t image_elems, float scale, float offset) {
  std::vector<std::thread> pool;
  int threads = std::max(1, std::min<int>(
      std::thread::hardware_concurrency(), batch));
  auto work = [&](int tid) {
    for (int i = tid; i < batch; i += threads) {
      normalize_range(srcs[i], dst + i * image_elems, 0, image_elems,
                      scale, offset);
    }
  };
  for (int t = 0; t < threads; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

// Bilinear resize uint8 HWC -> uint8 HWC (half-pixel centers, the
// PIL/torch convention for align_corners=False).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                        int dh, int dw, int c) {
  const float ry = static_cast<float>(sh) / dh;
  const float rx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ry - 0.5f;
    int y0 = std::max(0, std::min(sh - 1, static_cast<int>(fy)));
    int y1 = std::min(sh - 1, y0 + 1);
    float wy = std::max(0.0f, std::min(1.0f, fy - y0));
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * rx - 0.5f;
      int x0 = std::max(0, std::min(sw - 1, static_cast<int>(fx)));
      int x1 = std::min(sw - 1, x0 + 1);
      float wx = std::max(0.0f, std::min(1.0f, fx - x0));
      for (int ch = 0; ch < c; ++ch) {
        float v00 = src[(y0 * sw + x0) * c + ch];
        float v01 = src[(y0 * sw + x1) * c + ch];
        float v10 = src[(y1 * sw + x0) * c + ch];
        float v11 = src[(y1 * sw + x1) * c + ch];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * dw + x) * c + ch] =
            static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v + 0.5f)));
      }
    }
  }
}

}  // extern "C"
