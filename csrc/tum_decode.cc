// Native host-side TUM decode path (SURVEY.md §2b N1).
//
// Reference status: the reference's dataset reader is native C++ (OpenCV
// imread) — SURVEY.md §2a R1.  Here the only host work that can bottleneck
// the device at 60+ fps is 16-bit PNG decode and timestamp association
// (SURVEY.md §7 Stage 7), so exactly that is native: a minimal libpng
// decoder (no OpenCV dependency, releases the GIL via ctypes) and the
// greedy nearest-timestamp matcher.  Exposed through a plain C ABI for
// ctypes — no pybind11.  Optional: without it the loader decodes with
// tpuslam/data/png.py (zlib + numpy).
//
// Build (needs libpng): csrc/build.sh  →  tpuslam/data/_libtum_native.so

#include <png.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <tuple>
#include <vector>

extern "C" {

// Read the header of a PNG; returns 0 on success and fills h/w/bit_depth.
int tum_png16_header(const char* path, int* h, int* w, int* bit_depth) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  *bit_depth = png_get_bit_depth(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Decode a 16-bit grayscale PNG into `out` (row-major h*w uint16,
// native endianness).  8-bit inputs are widened.  Returns 0 on success.
int tum_png16_decode(const char* path, uint16_t* out, int h, int w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  const int width = static_cast<int>(png_get_image_width(png, info));
  const int height = static_cast<int>(png_get_image_height(png, info));
  if (width != w || height != h) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -4;
  }
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_COLOR) png_set_rgb_to_gray(png, 1, -1.0, -1.0);
  if (depth == 16) png_set_swap(png);  // PNG is big-endian; we want native LE
  png_read_update_info(png, info);

  const size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> rowbuf(rowbytes);
  const int out_depth = png_get_bit_depth(png, info);
  for (int y = 0; y < height; ++y) {
    png_read_row(png, rowbuf.data(), nullptr);
    uint16_t* dst = out + static_cast<size_t>(y) * width;
    if (out_depth == 16) {
      std::memcpy(dst, rowbuf.data(), sizeof(uint16_t) * width);
    } else {  // widen 8-bit
      for (int x = 0; x < width; ++x) dst[x] = rowbuf[x];
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Greedy nearest-timestamp association (the TUM tool algorithm): sort all
// candidate pairs with |ta - tb| < max_diff by the difference, take
// greedily while both endpoints are unused.  out_idx must hold na entries;
// out_idx[i] = matched index into tb, or -1.  Returns number of matches.
int tum_associate(const double* ta, int na, const double* tb, int nb,
                  double max_diff, int32_t* out_idx) {
  std::vector<std::tuple<double, int, int>> pairs;
  // candidate window via binary search over the (sorted) tb stream
  std::vector<int> order(nb);
  for (int j = 0; j < nb; ++j) order[j] = j;
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return tb[a] < tb[b]; });
  std::vector<double> tbs(nb);
  for (int j = 0; j < nb; ++j) tbs[j] = tb[order[j]];
  for (int i = 0; i < na; ++i) {
    auto it = std::lower_bound(tbs.begin(), tbs.end(), ta[i]);
    int pos = static_cast<int>(it - tbs.begin());
    for (int k = pos - 2; k <= pos + 2; ++k) {
      if (k < 0 || k >= nb) continue;
      double d = std::abs(ta[i] - tbs[k]);
      if (d < max_diff) pairs.emplace_back(d, i, order[k]);
    }
  }
  std::sort(pairs.begin(), pairs.end());
  std::vector<char> used_a(na, 0), used_b(nb, 0);
  for (int i = 0; i < na; ++i) out_idx[i] = -1;
  int matches = 0;
  for (const auto& [d, i, j] : pairs) {
    if (used_a[i] || used_b[j]) continue;
    used_a[i] = used_b[j] = 1;
    out_idx[i] = j;
    ++matches;
  }
  return matches;
}

}  // extern "C"
