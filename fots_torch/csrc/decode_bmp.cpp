// Host decoding of Windows BMP files as OpenCV 5.0's own BmpDecoder
// (modules/imgcodecs/src/grfmt_bmp.cpp) reads them under cv2.imread, colour
// (BGR) or grayscale, byte for byte:
//   - headers: BITMAPINFOHEADER and its longer V4 / V5 forms (palette after
//     the header, 4-byte entries, biClrUsed of them or 2^bpp), and the OS/2
//     BITMAPCOREHEADER (12 bytes, 3-byte entries, always 2^bpp);
//   - BI_RGB at 1, 4, 8 (palette), 16 (5-5-5), 24 and 32 bits (the fourth
//     byte dropped), BI_BITFIELDS at 16 bits with the 5-6-5 or 5-5-5 masks
//     and at 32 bits, BI_RLE8 at 8 bits and BI_RLE4 at 4 bits;
//   - 32-bit BI_BITFIELDS with a header of 56 bytes or more (V3 and later,
//     as cv2.imwrite writes a 4-channel image) and nonzero red, green and
//     blue masks inside it: each channel is (pixel & mask) >> its shift,
//     scaled to 8 bits as float(v) * (255.f / (mask >> shift)) truncated,
//     and grey is (0.299f r + 0.587f g) + 0.114f b truncated, in float; any
//     other 32-bit file is read as bytes B, G, R and a dropped fourth;
//   - 5- and 6-bit fields widened by a shift (v << 3, v << 2), without bit
//     replication (icvCvt_BGR5552BGR_8u_C2C3R, ..565..);
//   - run-length data as the decoder walks it: the escapes fill the pixels
//     they pass over with palette entry 0 (FillUniColor / FillUniGray).  In
//     RLE8 a run that ends a row moves to the next, an end of line right
//     after it is ignored, end of bitmap fills the rest of the image and a
//     delta (dx, dy) fills dx + dy * width pixels.  In RLE4 runs never move
//     to the next row, end of line and end of bitmap both fill the rest of
//     the row only, and a delta fills dx pixels (its dy is read and unused).
//     Decoding ends when the last row is passed; data that ends first, or a
//     run or absolute span past the end of its row, is Unreadable;
//   - bottom-up rows (positive height) and top-down rows (negative height),
//     each padded to 4 bytes;
//   - grayscale output through OpenCV's fixed-point BGR -> grey
//     (icvCvt_BGR2Gray_8u_C3C1R: 1868, 9617, 4899 over 2^14, rounded), on
//     the palette for the palette depths (CvtPaletteToGray).
// Unreadable (imread gives None) besides: a file cut before the last byte the
// decoder reads, a compression other than 0-3 (BI_JPEG, BI_PNG, ...), a depth /
// compression pair the decoder does not list, 16-bit masks other than 5-6-5
// and 5-5-5, biClrUsed past 256, a header size other than 12 or 36 and more,
// a width or height of 0.  One past OpenCV's limits on a side (2^20) or on
// the pixels (2^30) fails with -1, as imread raises for it.
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
constexpr int kB = 1868, kG = 9617, kR = 4899;
inline uint8_t grey(int b, int g, int r) { return uint8_t((b * kB + g * kG + r * kR + 8192) >> 14); }

enum { BI_RGB = 0, BI_RLE8 = 1, BI_RLE4 = 2, BI_BITFIELDS = 3 };

// a little-endian byte stream that fails past the end of the file
struct Stream {
  const uint8_t* d;
  int64_t n, pos = 0;
  int byte() {
    if (pos < 0 || pos >= n) throw Unreadable("the BMP ends early (truncated)");
    return d[pos++];
  }
  int word() { int a = byte(); return a | byte() << 8; }
  int32_t dword() { uint32_t a = uint32_t(word()); return int32_t(a | uint32_t(word()) << 16); }
  void bytes(uint8_t* out, int64_t count) {
    if (count < 0 || pos < 0 || pos + count > n) throw Unreadable("the BMP ends early (truncated)");
    std::memcpy(out, d + pos, size_t(count));
    pos += count;
  }
};

struct Header {
  int64_t offset = 0;
  int width = 0, height = 0, bpp = 0, rle = BI_RGB;
  bool bottom_up = true;
  uint8_t palette[256][4] = {};  // b, g, r, 0
  // 32-bit BI_BITFIELDS under a header of 56 bytes or more: the red, green
  // and blue masks inside the header (all three nonzero, else unused)
  bool masked = false;
  uint32_t mask[3] = {};
};

Header read_header(const uint8_t* data, int64_t n) {
  Header h;
  Stream s{data, n};
  if (n < 2 || data[0] != 'B' || data[1] != 'M') throw Unreadable("no BMP signature");
  s.pos = 10;
  h.offset = uint32_t(s.dword());
  int32_t size = s.dword();
  if (size <= 0) throw Unreadable("bad BMP header size");
  int64_t height;
  if (size >= 36) {
    h.width = s.dword();
    height = s.dword();
    h.bpp = uint32_t(s.dword()) >> 16;
    int32_t rle = s.dword();
    if (rle < 0 || rle > BI_BITFIELDS) throw Unreadable("BMP compression other than 0-3");
    h.rle = rle;
    s.pos += 12;
    int32_t clrused = s.dword();
    if (h.bpp <= 8) {
      if (clrused < 0 || clrused > 256) throw Unreadable("BMP biClrUsed past 256");
      s.pos += size - 36;
      int entries = clrused == 0 ? 1 << h.bpp : clrused;
      s.bytes(&h.palette[0][0], int64_t(entries) * 4);
    } else if (h.bpp == 16 && h.rle == BI_BITFIELDS) {
      s.pos += size - 36;
      uint32_t red = uint32_t(s.dword()), green = uint32_t(s.dword()), blue = uint32_t(s.dword());
      if (blue == 0x1f && green == 0x3e0 && red == 0x7c00)
        h.bpp = 15;
      else if (!(blue == 0x1f && green == 0x7e0 && red == 0xf800))
        throw Unreadable("BMP 16-bit masks other than 5-6-5 and 5-5-5");
    } else if (h.bpp == 16 && h.rle == BI_RGB) {
      h.bpp = 15;
    } else if (h.bpp == 32 && h.rle == BI_BITFIELDS && size >= 56) {
      s.pos = 14 + 40;
      for (uint32_t& m : h.mask) m = uint32_t(s.dword());
      h.masked = h.mask[0] && h.mask[1] && h.mask[2];
    }
  } else if (size == 12) {
    h.width = s.word();
    height = s.word();
    h.bpp = uint32_t(s.dword()) >> 16;
    h.rle = BI_RGB;
    if (h.bpp <= 8) {
      uint8_t entries[256 * 3];
      s.bytes(entries, int64_t(3) << h.bpp);
      for (int i = 0; i < (1 << h.bpp); i++)
        for (int c = 0; c < 3; c++) h.palette[i][c] = entries[3 * i + c];
    }
  } else {
    throw Unreadable("unknown BMP header");
  }
  h.bottom_up = height > 0;
  height = height < 0 ? -height : height;
  bool known = ((h.bpp == 1 || h.bpp == 4 || h.bpp == 8 || h.bpp == 15 || h.bpp == 24 ||
                 h.bpp == 32) && h.rle == BI_RGB) ||
               ((h.bpp == 15 || h.bpp == 16 || h.bpp == 32) && h.rle == BI_BITFIELDS) ||
               (h.bpp == 4 && h.rle == BI_RLE4) || (h.bpp == 8 && h.rle == BI_RLE8);
  if (h.width <= 0 || height <= 0 || !known)
    throw Unreadable("BMP of a size, depth or compression the decoder does not read");
  if (h.width > kMaxSide || height > kMaxSide || int64_t(h.width) * height > kMaxPixels)
    throw std::runtime_error("BMP larger than OpenCV's limits (imread raises)");
  h.height = int(height);
  return h;
}

// The rows are decoded in file order into `out` (row 0 first); the caller
// flips a bottom-up file.
struct Rle {
  uint8_t* data;      // next pixel
  uint8_t* line_end;  // end of the current row
  int width3, height, nch;
  int y = 0;

  // FillUniColor / FillUniGray: count3 bytes of `value`, wrapping rows
  void fill(int64_t count3, const uint8_t* value) {
    do {
      uint8_t* end = data + count3;
      if (end > line_end) end = line_end;
      count3 -= end - data;
      for (; data < end; data += nch) std::memcpy(data, value, size_t(nch));
      if (data >= line_end) {
        line_end += width3;
        data = line_end - width3;
        if (++y >= height) break;
      }
    } while (count3 > 0);
  }
};

void decode(const uint8_t* file, int64_t n, bool gray, uint8_t* out) {
  Header h = read_header(file, n);
  const int nch = gray ? 1 : 3, width3 = h.width * nch;
  const int64_t src_pitch = ((int64_t(h.width) * (h.bpp != 15 ? h.bpp : 16) + 7) / 8 + 3) & -4;
  // palette entry -> output pixel (BGR, or its grey)
  uint8_t lut[256][3];
  for (int i = 0; i < 256; i++) {
    const uint8_t* p = h.palette[i];
    if (gray)
      lut[i][0] = grey(p[0], p[1], p[2]);
    else
      std::memcpy(lut[i], p, 3);
  }
  std::vector<uint8_t> src(size_t(src_pitch) + 32);
  Stream s{file, n, h.offset};
  std::memset(out, 0, size_t(h.height) * size_t(width3));
  auto put_index = [&](uint8_t* px, int index) { std::memcpy(px, lut[index], size_t(nch)); };
  auto put_bgr = [&](uint8_t* px, int b, int g, int r) {
    if (gray) {
      px[0] = grey(b, g, r);
    } else {
      px[0] = uint8_t(b);
      px[1] = uint8_t(g);
      px[2] = uint8_t(r);
    }
  };
  if (h.rle == BI_RLE8 || h.rle == BI_RLE4) {
    const bool rle8 = h.rle == BI_RLE8;
    Rle r{out, out + width3, width3, h.height, nch};
    int line_end_flag = 0;  // RLE8: the last run finished a row
    for (;;) {
      int code = s.word();
      int len = code & 255;
      code >>= 8;
      if (len != 0) {  // encoded mode
        if (r.data + int64_t(len) * nch > r.line_end) throw Unreadable("a BMP run past its row");
        if (rle8) {
          int prev_y = r.y;
          r.fill(int64_t(len) * nch, lut[code]);
          line_end_flag = r.y - prev_y;
          if (r.y >= h.height) break;
        } else {
          uint8_t* end = r.data + int64_t(len) * nch;
          int t = 0;
          do {
            put_index(r.data, t ? code & 15 : code >> 4);
            t ^= 1;
          } while ((r.data += nch) < end);
        }
      } else if (code > 2) {  // absolute mode
        if (r.data + int64_t(code) * nch > r.line_end) throw Unreadable("a BMP run past its row");
        int sz = rle8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
        s.bytes(src.data(), sz);
        for (int i = 0; i < code; i++, r.data += nch)
          put_index(r.data, rle8 ? src[i] : (i & 1 ? src[i >> 1] & 15 : src[i >> 1] >> 4));
        if (rle8) line_end_flag = 0;
      } else {  // end of line (0), end of bitmap (1), delta (2)
        int64_t x_shift3 = r.line_end - r.data;
        int64_t y_shift = h.height - r.y;
        if (!rle8 || code || !line_end_flag || x_shift3 < width3) {
          if (code == 2) {
            x_shift3 = int64_t(s.byte()) * nch;
            y_shift = s.byte();
          }
          if (rle8 && code != 0) x_shift3 += y_shift * width3;  // RLE4 fills one row at most
          if (rle8 && r.y >= h.height) break;
          r.fill(x_shift3, lut[0]);
          if (r.y >= h.height) break;
        }
        line_end_flag = 0;
        if (r.y >= h.height) break;
      }
    }
  } else {
    int shift[3] = {};
    float scale[3] = {};
    for (int k = 0; h.masked && k < 3; k++) {
      while (!(h.mask[k] >> shift[k] & 1)) shift[k]++;
      scale[k] = 255.0f / float(h.mask[k] >> shift[k]);
    }
    for (int y = 0; y < h.height; y++) {
      uint8_t* row = out + int64_t(y) * width3;
      s.bytes(src.data(), src_pitch);
      const uint8_t* p = src.data();
      for (int x = 0; x < h.width; x++, row += nch) {
        switch (h.bpp) {
          case 1: put_index(row, p[x >> 3] >> (7 - (x & 7)) & 1); break;
          case 4: put_index(row, x & 1 ? p[x >> 1] & 15 : p[x >> 1] >> 4); break;
          case 8: put_index(row, p[x]); break;
          case 15: {
            int v = p[2 * x] | p[2 * x + 1] << 8;
            put_bgr(row, v << 3 & 0xf8, v >> 2 & 0xf8, v >> 7 & 0xf8);
            break;
          }
          case 16: {
            int v = p[2 * x] | p[2 * x + 1] << 8;
            put_bgr(row, v << 3 & 0xf8, v >> 3 & 0xfc, v >> 8 & 0xf8);
            break;
          }
          case 24: put_bgr(row, p[3 * x], p[3 * x + 1], p[3 * x + 2]); break;
          case 32:
            if (h.masked) {
              uint32_t v = uint32_t(p[4 * x]) | uint32_t(p[4 * x + 1]) << 8 |
                           uint32_t(p[4 * x + 2]) << 16 | uint32_t(p[4 * x + 3]) << 24;
              int c[3];  // r, g, b
              for (int k = 0; k < 3; k++) c[k] = int(float((v & h.mask[k]) >> shift[k]) * scale[k]);
              if (gray)
                row[0] = uint8_t(int(0.299f * float(c[0]) + 0.587f * float(c[1]) +
                                     0.114f * float(c[2])));
              else
                put_bgr(row, c[2], c[1], c[0]);
            } else {
              put_bgr(row, p[4 * x], p[4 * x + 1], p[4 * x + 2]);
            }
            break;
        }
      }
    }
  }
  if (h.bottom_up) {
    std::vector<uint8_t> tmp(static_cast<size_t>(width3));
    for (int y = 0, z = h.height - 1; y < z; y++, z--) {
      std::memcpy(tmp.data(), out + int64_t(y) * width3, size_t(width3));
      std::memcpy(out + int64_t(y) * width3, out + int64_t(z) * width3, size_t(width3));
      std::memcpy(out + int64_t(z) * width3, tmp.data(), size_t(width3));
    }
  }
}

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
int fots_bmp_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Header h = read_header(data, n);
    info[0] = h.height;
    info[1] = h.width;
  });
}

// out: height * width * 3 bytes (BGR) or height * width (gray)
int fots_bmp_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, char* err,
                    int errlen) {
  return guarded(err, errlen, [&] { decode(data, n, gray != 0, out); });
}

}  // extern "C"
