// Host decoding of Sun raster files as OpenCV 5.0's own SunRasterDecoder
// (modules/imgcodecs/src/grfmt_sunras.cpp) reads them under cv2.imread,
// colour (BGR) or grayscale, byte for byte:
//   - the 32-byte big-endian header (magic 59 a6 6a 95, width, height,
//     depth, a data length that is not read, type, map type, map length);
//   - types 0 (old) and 1 (standard) only: the decoder tests the byte-encoded
//     (2) and RGB (3) types against its output type, which is still unset
//     when the header is read, so both are refused (None), as any other;
//   - depths 1, 8, 24 and 32; rows padded to 16 bits;
//   - no map (map type 0, length 0), or an RGB map (map type 1, a length of
//     1 to 3 * 2^depth bytes at depth 1 or 8: length / 3 entries of red, then
//     green, then blue planes; indices past them are black);
//   - 1 and 8 bits: the map's colours, or without a map black and white (1
//     bit: bit 1 is white) and grey levels; grayscale output is the map's
//     grey (CvtPaletteToGray: 1868, 9617, 4899 over 2^14, rounded), and 0
//     everywhere where the file has no map (the decoder's grey palette is
//     filled only from a map);
//   - 24 bits: B, G, R as stored; 32 bits: a pad byte, then B, G, R; grey
//     through the same fixed-point sum.
// Unreadable (imread gives None) besides: a file cut short anywhere, a width
// or height of 0 or past 2^31, another depth, a map with another depth or a
// map length the header does not allow.  One past OpenCV's limits on a side
// (2^20) or on the pixels (2^30) fails with -1, as imread raises for it.
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.  Every entry point returns 0, 1 with a
// message in `err` where imread gives None, or -1 with a message for any
// other failure (such as memory).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Unreadable : std::runtime_error {
  explicit Unreadable(const std::string& m) : std::runtime_error(m) {}
};

// OpenCV's limits on an image read (CV_IO_MAX_IMAGE_WIDTH, _HEIGHT, _PIXELS)
constexpr int64_t kMaxSide = 1 << 20;
constexpr int64_t kMaxPixels = int64_t(1) << 30;

// fixed-point BGR -> grey of OpenCV's imgcodecs (utils.cpp)
inline uint8_t grey(int b, int g, int r) { return uint8_t((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14); }

struct Header {
  int width = 0, height = 0, depth = 0;
  int64_t offset = 0;     // the first pixel row
  uint8_t pal[256][3];    // B, G, R
  bool has_map = false;
};

int32_t dword(const uint8_t* d, int64_t n, int64_t at) {
  if (at + 4 > n) throw Unreadable("the Sun raster ends inside its header (truncated)");
  return int32_t(uint32_t(d[at]) << 24 | uint32_t(d[at + 1]) << 16 | uint32_t(d[at + 2]) << 8 |
                 uint32_t(d[at + 3]));
}

Header read_header(const uint8_t* d, int64_t n) {
  Header h;
  h.width = dword(d, n, 4);
  h.height = dword(d, n, 8);
  h.depth = dword(d, n, 12);
  const int32_t type = dword(d, n, 20), maptype = dword(d, n, 24), maplength = dword(d, n, 28);
  const int palsize = h.depth > 0 && h.depth <= 8 ? (1 << h.depth) * 3 : 0;
  const bool depth_ok = h.depth == 1 || h.depth == 8 || h.depth == 24 || h.depth == 32;
  const bool map_ok = (maptype == 0 && maplength == 0) ||
                      (maptype == 1 && maplength <= palsize && maplength > 0 && h.depth <= 8);
  if (!(h.width > 0 && h.height > 0 && depth_ok && (type == 0 || type == 1) && map_ok))
    throw Unreadable("a Sun raster header OpenCV's decoder refuses (size " +
                     std::to_string(h.width) + "x" + std::to_string(h.height) + ", depth " +
                     std::to_string(h.depth) + ", type " + std::to_string(type) + ", map type " +
                     std::to_string(maptype) + ")");
  std::memset(h.pal, 0, sizeof(h.pal));
  if (maplength) {
    if (32 + int64_t(maplength) > n) throw Unreadable("the Sun raster ends inside its colour map");
    const int entries = maplength / 3;
    const uint8_t* m = d + 32;
    for (int i = 0; i < entries; i++) {
      h.pal[i][0] = m[i + 2 * entries];
      h.pal[i][1] = m[i + entries];
      h.pal[i][2] = m[i];
    }
    h.has_map = true;
  } else if (h.depth <= 8) {  // FillGrayPalette
    const int top = (1 << h.depth) - 1;
    for (int i = 0; i <= top; i++) h.pal[i][0] = h.pal[i][1] = h.pal[i][2] = uint8_t(i * 255 / top);
  }
  h.offset = 32 + maplength;
  if (h.width > kMaxSide || h.height > kMaxSide || int64_t(h.width) * h.height > kMaxPixels)
    throw std::length_error("a Sun raster past OpenCV's limits on a side or on the pixels "
                            "(cv2.imread raises)");
  return h;
}

void decode(const uint8_t* d, int64_t n, bool gray, uint8_t* out) {
  const Header h = read_header(d, n);
  const int64_t w = h.width;
  const int64_t pitch = ((w * h.depth + 7) / 8 + 1) & ~int64_t(1);
  if (h.offset + pitch * h.height > n) throw Unreadable("the Sun raster ends early (truncated)");
  uint8_t grey_pal[256];
  for (int i = 0; i < 256; i++)  // the grey palette is built from a map only
    grey_pal[i] = h.has_map ? grey(h.pal[i][0], h.pal[i][1], h.pal[i][2]) : 0;
  const int nch = gray ? 1 : 3;
  for (int64_t y = 0; y < h.height; y++) {
    const uint8_t* src = d + h.offset + y * pitch;
    uint8_t* row = out + y * w * nch;
    for (int64_t x = 0; x < w; x++) {
      if (h.depth <= 8) {
        const int idx = h.depth == 8 ? src[x] : (src[x >> 3] >> (7 - (x & 7))) & 1;
        if (gray) row[x] = grey_pal[idx];
        else std::memcpy(row + 3 * x, h.pal[idx], 3);
        continue;
      }
      const uint8_t* p = src + (h.depth == 32 ? 4 * x + 1 : 3 * x);
      if (gray) row[x] = grey(p[0], p[1], p[2]);
      else std::memcpy(row + 3 * x, p, 3);
    }
  }
}

// 1 where imread gives None, -1 for any other failure (imread raises)
int fail(char* err, int errlen, const std::exception& e, int code) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", e.what());
  return code;
}

template <typename F>
int guarded(char* err, int errlen, F&& f) {
  try {
    f();
    return 0;
  } catch (const Unreadable& e) {
    return fail(err, errlen, e, 1);
  } catch (const std::exception& e) {
    return fail(err, errlen, e, -1);
  }
}

}  // namespace

extern "C" {

// info: height, width
int fots_sunras_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Header h = read_header(data, n);
    info[0] = h.height;
    info[1] = h.width;
  });
}

// out: height * width * 3 bytes (BGR) or height * width (gray)
int fots_sunras_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, char* err,
                       int errlen) {
  return guarded(err, errlen, [&] { decode(data, n, gray != 0, out); });
}

}  // extern "C"
