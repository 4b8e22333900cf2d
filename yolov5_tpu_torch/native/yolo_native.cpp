// Native data-feeder kernels: JPEG decode + aspect-preserving letterbox.
//
// The reference outsources image decode/resize to OpenCV's C++ (SURVEY.md
// §0.2); this is the equivalent native component for this framework's input
// pipeline, built on libjpeg with OpenMP batch parallelism and exposed
// through a plain C ABI for ctypes (no pybind11 in the image).
//
// Layout contract: outputs are RGB uint8, HWC, letterboxed to (size, size)
// with 114-gray padding — exactly what the training step consumes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <omp.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG file to RGB. Returns true on success.
bool decode_jpeg_file(const char* path, std::vector<uint8_t>* out, int* h,
                      int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear resize (src RGB HWC) into dst of (dh, dw).
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  const float fy = float(sh) / dh;
  const float fx = float(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    int y0 = std::max(0, std::min(sh - 1, int(syf)));
    int y1 = std::min(sh - 1, y0 + 1);
    float wy = std::max(0.0f, std::min(1.0f, syf - y0));
    for (int x = 0; x < dw; ++x) {
      float sxf = (x + 0.5f) * fx - 0.5f;
      int x0 = std::max(0, std::min(sw - 1, int(sxf)));
      int x1 = std::min(sw - 1, x0 + 1);
      float wx = std::max(0.0f, std::min(1.0f, sxf - x0));
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(size_t(y0) * sw + x0) * 3 + c];
        float v01 = src[(size_t(y0) * sw + x1) * 3 + c];
        float v10 = src[(size_t(y1) * sw + x0) * 3 + c];
        float v11 = src[(size_t(y1) * sw + x1) * 3 + c];
        float top = v00 * (1 - wx) + v01 * wx;
        float bot = v10 * (1 - wx) + v11 * wx;
        dst[(size_t(y) * dw + x) * 3 + c] =
            uint8_t(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode + letterbox one JPEG into out (size*size*3, RGB, 114-padded).
// Writes original (h, w) into hw. scaleup=0 never upscales (val mode).
// Returns 0 on success, nonzero on failure (out untouched).
int decode_letterbox(const char* path, uint8_t* out, int size, int scaleup,
                     int* hw) {
  std::vector<uint8_t> img;
  int h = 0, w = 0;
  if (!decode_jpeg_file(path, &img, &h, &w)) return 1;
  hw[0] = h;
  hw[1] = w;
  float r = std::min(float(size) / h, float(size) / w);
  if (!scaleup) r = std::min(r, 1.0f);
  int nh = std::max(1, int(h * r + 0.5f));
  int nw = std::max(1, int(w * r + 0.5f));
  std::vector<uint8_t> resized(size_t(nh) * nw * 3);
  resize_bilinear(img.data(), h, w, resized.data(), nh, nw);
  int top = (size - nh) / 2;
  int left = (size - nw) / 2;
  memset(out, 114, size_t(size) * size * 3);
  for (int y = 0; y < nh; ++y) {
    memcpy(out + (size_t(top + y) * size + left) * 3,
           resized.data() + size_t(y) * nw * 3, size_t(nw) * 3);
  }
  return 0;
}

// Batched: paths is n C-strings; out is (n, size, size, 3) uint8; hws is
// (n, 2) int32; oks is (n,) int32 (1 = decoded). OpenMP-parallel.
void decode_letterbox_batch(const char** paths, int n, uint8_t* out, int size,
                            int scaleup, int* hws, int* oks) {
  const size_t stride = size_t(size) * size * 3;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    oks[i] = decode_letterbox(paths[i], out + stride * i, size, scaleup,
                              hws + 2 * i) == 0;
  }
}

int native_version() { return 1; }

}  // extern "C"
