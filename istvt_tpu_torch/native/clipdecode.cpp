// clipdecode — native frame decode + resize + normalize for the host-side
// clip pipeline (the hot loop behind istvt_tpu_torch/data/loader.py;
// a copy of istvt_tpu/native/clipdecode.cpp).
//
// The reference delegates this to torchvision/PIL inside 8 DataLoader
// worker processes (reference train_CNN.py:176-177). Here one shared
// library decodes JPEG (libjpeg) / PNG (libpng), bilinearly resizes to the
// model input size and writes normalized float32 NHWC directly into the
// caller's pinned batch buffer, fanned out over a pthread pool — no
// Python in the per-frame path, no process forks.
//
// C ABI (ctypes):
//   int decode_frames(const char** paths, int n, int out_size,
//                     float mean, float std, float* out, int n_threads);
//     out: n * out_size * out_size * 3 floats, value = (x/255 - mean)/std
//     returns number of successfully decoded frames (failures are zeroed).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cstdint>
#include <vector>
#include <thread>
#include <atomic>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> data;  // HWC RGB
  int h = 0, w = 0;
};

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, Image* im) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  im->w = cinfo.output_width;
  im->h = cinfo.output_height;
  im->data.resize(size_t(im->w) * im->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = im->data.data() + size_t(cinfo.output_scanline) * im->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* im) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize everything to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);
  im->w = int(w);
  im->h = int(h);
  im->data.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = im->data.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* im) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, im);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, im);
  }
  fclose(f);
  return ok && im->w > 0 && im->h > 0;
}

// Bilinear resize + normalize into the output slot (half-pixel centers,
// matching PIL/torch interpolate align_corners=False). Separable
// two-pass with precomputed column weights: the vertical blend runs on
// contiguous rows (SIMD-friendly), the horizontal gather reuses the
// per-column index/weight tables across all rows.
void resize_normalize(const Image& im, int out_size, float mean, float std,
                      float* out) {
  const float sy = float(im.h) / out_size;
  const float sx = float(im.w) / out_size;
  const float inv = 1.0f / (255.0f * std);
  const float bias = -mean / std;
  const int w3 = im.w * 3;

  // per-column tables (computed once, reused for every row)
  std::vector<int> x0(out_size), x1(out_size);
  std::vector<float> wx(out_size);
  for (int ox = 0; ox < out_size; ox++) {
    float fx = (ox + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    int xi = int(fx);
    x0[ox] = xi * 3;
    x1[ox] = (xi + 1 < im.w ? xi + 1 : im.w - 1) * 3;
    wx[ox] = fx - xi;
  }

  std::vector<float> row(w3);  // vertically-blended full-width row
  for (int oy = 0; oy < out_size; oy++) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = int(fy);
    int y1 = y0 + 1 < im.h ? y0 + 1 : im.h - 1;
    float wy = fy - y0;
    const uint8_t* r0 = &im.data[size_t(y0) * w3];
    const uint8_t* r1 = &im.data[size_t(y1) * w3];
    const float a = 1.0f - wy;
    for (int i = 0; i < w3; i++)            // contiguous: vectorizes
      row[i] = a * r0[i] + wy * r1[i];
    float* dst = out + size_t(oy) * out_size * 3;
    for (int ox = 0; ox < out_size; ox++) {
      const float b = wx[ox];
      const float* p0 = &row[x0[ox]];
      const float* p1 = &row[x1[ox]];
      const float c0 = 1.0f - b;
      dst[0] = (c0 * p0[0] + b * p1[0]) * inv + bias;
      dst[1] = (c0 * p0[1] + b * p1[1]) * inv + bias;
      dst[2] = (c0 * p0[2] + b * p1[2]) * inv + bias;
      dst += 3;
    }
  }
}

}  // namespace

extern "C" {

int decode_frames(const char** paths, int n, int out_size, float mean,
                  float std, float* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), ok(0);
  const size_t stride = size_t(out_size) * out_size * 3;
  auto worker = [&]() {
    Image im;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* slot = out + stride * i;
      if (decode_file(paths[i], &im)) {
        resize_normalize(im, out_size, mean, std, slot);
        ok.fetch_add(1);
      } else {
        memset(slot, 0, stride * sizeof(float));
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = n_threads < n ? n_threads : n;
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

}  // extern "C"
