// Native threaded JPEG frame-batch decoder + resize (the port's copy of
// the JAX package's native/framedec.cc).
//
// The reference's data loader decodes per-frame JPEGs with PIL inside a
// joblib process pool (crc_input_data_seq.py:186-205, 560-577); this
// decodes a batch of JPEG files into one [N, H, W, 3] uint8 array with a
// worker pool, optionally bilinear-resizing each frame to the target size
// (src_x = (x+0.5)*scale - 0.5 sampling, i.e. cv2 INTER_LINEAR semantics;
// PIL.BILINEAR applies an antialiasing triangle filter when downscaling,
// so resized pixels differ slightly — decode-only output is bit-identical
// to PIL, same libjpeg underneath).
//
// Exposed C ABI (ctypes-bound in native/__init__.py; built there with g++
// and -ljpeg at first use):
//   framedec_decode_batch(paths, n, out_h, out_w, out, statuses, n_threads)
//     -> number of failed files (statuses[i] != 0 per failure)

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <system_error>
#include <thread>
#include <vector>

// jpeglib.h uses size_t/FILE without including their headers itself
#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to tightly-packed RGB8. Returns 0 on success.
int decode_file(const char* path, std::vector<unsigned char>* pixels,
                int* width, int* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *width = static_cast<int>(cinfo.output_width);
  *height = static_cast<int>(cinfo.output_height);
  const size_t stride = cinfo.output_width * 3;
  try {
    pixels->resize(stride * cinfo.output_height);
  } catch (const std::bad_alloc&) {
    // a corrupt header may claim up to 65535x65535 (~12.9 GB RGB);
    // clean up here so nothing leaks and no exception crosses the
    // thread boundary (which would std::terminate the process)
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Bilinear resize RGB8 (half-pixel-center sampling).
void resize_bilinear(const unsigned char* src, int sh, int sw,
                     unsigned char* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float top = src[(y0 * sw + x0) * 3 + c] * (1 - wx) +
                          src[(y0 * sw + x1) * 3 + c] * wx;
        const float bot = src[(y1 * sw + x0) * 3 + c] * (1 - wx) +
                          src[(y1 * sw + x1) * 3 + c] * wx;
        const float v = top * (1 - wy) + bot * wy;
        dst[(y * dw + x) * 3 + c] =
            static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// paths: n C strings; out: [n, out_h, out_w, 3] uint8 (caller-allocated);
// statuses: n int32 (0 ok). Returns the number of failures.
int framedec_decode_batch(const char** paths, int n, int out_h, int out_w,
                          unsigned char* out, int32_t* statuses,
                          int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;

  auto worker = [&]() {
    std::vector<unsigned char> pixels;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int w = 0, h = 0;
      int rc;
      try {
        rc = decode_file(paths[i], &pixels, &w, &h);
      } catch (const std::exception&) {
        // pixels.resize can throw bad_alloc (a corrupt header may claim
        // up to 65535x65535 -> ~12.9 GB); an exception escaping a
        // std::thread calls std::terminate and kills the whole Python
        // process, so convert it into this file's failure status.
        std::vector<unsigned char>().swap(pixels);  // release any partial
        rc = 3;
      }
      if (rc == 0 && (w <= 0 || h <= 0)) rc = 4;  // defensive: empty frame
      statuses[i] = rc;
      if (rc != 0) {
        failures.fetch_add(1);
        std::memset(out + i * frame_bytes, 0, frame_bytes);
        continue;
      }
      resize_bilinear(pixels.data(), h, w, out + i * frame_bytes,
                      out_h, out_w);
    }
  };

  std::vector<std::thread> threads;
  const int spawn = n_threads < n ? n_threads : n;
  threads.reserve(spawn);
  for (int t = 0; t < spawn; ++t) {
    try {
      threads.emplace_back(worker);
    } catch (const std::system_error&) {
      // thread creation failed (resource exhaustion): letting the
      // exception cross the extern "C"/ctypes boundary would
      // std::terminate the whole Python process. The work-stealing
      // counter means any already-running workers (or, with none, the
      // fallback below) still decode every frame.
      break;
    }
  }
  if (threads.empty()) worker();  // single-threaded fallback
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
