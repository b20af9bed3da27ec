// Native data-loading runtime: libpng decoding with a worker thread pool.
//
// Replaces the reference's 20-process torch DataLoader decode path
// (reference train.py:137-143, config.yml:20) with an in-process C++
// pool feeding pinned numpy buffers through ctypes — no pickling, no
// process fork, no Python in the decode loop.
//
// C ABI (see dataload.py for the ctypes binding):
//   png_info       - read header only (dims / channels / bit depth)
//   png_read_u8    - decode an 8-bit image (gray/RGB/RGBA -> as stored)
//   png_read_u16   - decode a 16-bit grayscale image (depth maps, mm)
//   png_read_batch_u8 / _u16 - thread-pool batch decode into a strided
//                    caller-allocated buffer (all images same shape)
//
// Return codes: 0 ok, negative on error (-1 io, -2 not png, -3 decode,
// -4 buffer too small / shape mismatch).

#include <png.h>

#include <atomic>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct PngImage {
  std::vector<unsigned char> data;
  int w = 0, h = 0, channels = 0, bit_depth = 0;
};

int decode(const char* path, PngImage* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  unsigned char header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return -2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int color_type = png_get_color_type(png, info);
  out->bit_depth = png_get_bit_depth(png, info);
  // Normalize palette/low-depth to 8-bit samples; keep 16-bit as-is
  // (network-endian -> host little-endian swap below).
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && out->bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (out->bit_depth == 16) png_set_swap(png);
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->channels = png_get_channels(png, info);
  out->bit_depth = png_get_bit_depth(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.resize(rowbytes * out->h);

  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

template <typename T>
int read_into(const char* path, T* out, long out_elems, int expect_depth,
              int* w, int* h, int* c) {
  PngImage img;
  int rc = decode(path, &img);
  if (rc != 0) return rc;
  if (img.bit_depth != expect_depth) return -4;
  long elems = (long)img.w * img.h * img.channels;
  if (elems > out_elems) return -4;
  std::memcpy(out, img.data.data(), elems * sizeof(T));
  if (w) *w = img.w;
  if (h) *h = img.h;
  if (c) *c = img.channels;
  return 0;
}

template <typename T>
int read_batch(const char** paths, int n, T* out, long stride_elems,
               int expect_depth, int expect_w, int expect_h, int expect_c,
               int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> status(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || status.load() != 0) return;
      PngImage img;
      int rc = decode(paths[i], &img);
      if (rc == 0 && (img.bit_depth != expect_depth || img.w != expect_w ||
                      img.h != expect_h || img.channels != expect_c))
        rc = -4;
      if (rc != 0) {
        status.store(rc);
        return;
      }
      std::memcpy(out + (long)i * stride_elems, img.data.data(),
                  (long)img.w * img.h * img.channels * sizeof(T));
    }
  };
  int nt = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (nt > n) nt = n;
  if (nt < 1) nt = 1;
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return status.load();
}

}  // namespace

extern "C" {

int pngio_info(const char* path, int* w, int* h, int* c, int* depth) {
  PngImage img;  // full decode; header-only would need a second path —
  int rc = decode(path, &img);  // acceptable: used rarely (shape probe).
  if (rc != 0) return rc;
  *w = img.w;
  *h = img.h;
  *c = img.channels;
  *depth = img.bit_depth;
  return 0;
}

int pngio_read_u8(const char* path, unsigned char* out, long out_elems,
                int* w, int* h, int* c) {
  return read_into<unsigned char>(path, out, out_elems, 8, w, h, c);
}

int pngio_read_u16(const char* path, unsigned short* out, long out_elems,
                 int* w, int* h, int* c) {
  return read_into<unsigned short>(path, out, out_elems, 16, w, h, c);
}

int pngio_read_batch_u8(const char** paths, int n, unsigned char* out,
                      long stride_elems, int w, int h, int c, int n_threads) {
  return read_batch<unsigned char>(paths, n, out, stride_elems, 8, w, h, c,
                                   n_threads);
}

int pngio_read_batch_u16(const char** paths, int n, unsigned short* out,
                       long stride_elems, int w, int h, int c, int n_threads) {
  return read_batch<unsigned short>(paths, n, out, stride_elems, 16, w, h, c,
                                    n_threads);
}

}  // extern "C"
