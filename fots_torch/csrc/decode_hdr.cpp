// Host decoding of the pixels of Radiance HDR (RGBE) files as OpenCV 5.0's
// HdrDecoder reads them under cv2.imread (modules/imgcodecs/src/rgbe.cpp,
// RGBE_ReadPixels_RLE): the caller (fots_torch/imageio.py) reads the header
// and turns the RGBE bytes into floats and then into 8-bit pixels.
//   - scanlines narrower than 8 or wider than 32767 pixels are read flat
//     (four bytes a pixel);
//   - otherwise each scanline starts with 2, 2 and its width (high byte
//     first, the high byte below 128): four channel planes follow, each a
//     sequence of runs (a count above 128: count - 128 copies of the next
//     byte) and literal spans (a count of 1-128 bytes that follow); a count
//     of 0 or 128, or one past the end of the plane, fails, as does a width
//     other than the image's;
//   - a scanline that does not start so ends the run-length data: it and
//     everything after it is read flat (old-style run-length pixels, 1 1 1
//     n, are read as the pixels they are written as);
//   - data that ends before the last pixel fails.
// Every failure is Unreadable (imread gives None).
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.  The entry point returns 0, or 1 with a
// message in `err` where imread gives None.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// the RGBE bytes of `width * height` pixels from `d[pos:]` into `out`; the
// message of a failure, or null
const char* read_pixels(const uint8_t* d, int64_t n, int64_t pos, int64_t width, int64_t height,
                        uint8_t* out) {
  int64_t left = width * height;  // pixels still to read
  auto flat = [&]() -> const char* {
    if (pos + 4 * left > n) return "the HDR ends early (truncated)";
    std::memcpy(out, d + pos, size_t(4 * left));
    return nullptr;
  };
  if (width < 8 || width > 0x7fff) return flat();
  for (int64_t y = 0; y < height; y++) {
    if (pos + 4 > n) return "the HDR ends early (truncated)";
    const uint8_t* p = d + pos;
    if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) return flat();  // not run-length encoded
    if ((int64_t(p[2]) << 8 | p[3]) != width) return "wrong HDR scanline width";
    pos += 4;
    for (int ch = 0; ch < 4; ch++) {
      int64_t x = 0;
      while (x < width) {
        if (pos + 2 > n) return "the HDR ends early (truncated)";
        int count = d[pos];
        const uint8_t value = d[pos + 1];
        pos += 2;
        if (count > 128) {
          count -= 128;
          if (count > width - x) return "bad HDR scanline data";
          for (int k = 0; k < count; k++, x++) out[4 * x + ch] = value;
        } else {
          if (count == 0 || count > width - x) return "bad HDR scanline data";
          out[4 * x++ + ch] = value;
          if (--count > 0) {
            if (pos + count > n) return "the HDR ends early (truncated)";
            for (int k = 0; k < count; k++, x++) out[4 * x + ch] = d[pos++];
          }
        }
      }
    }
    out += 4 * width;
    left -= width;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// out: height * width * 4 RGBE bytes of the pixels from data[pos:]
int fots_hdr_pixels(const uint8_t* data, int64_t n, int64_t pos, int64_t width, int64_t height,
                    uint8_t* out, char* err, int errlen) {
  const char* msg = read_pixels(data, n, pos, width, height, out);
  if (!msg) return 0;
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
  return 1;
}

}  // extern "C"
