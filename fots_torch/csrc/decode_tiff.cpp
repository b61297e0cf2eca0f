// Host decoding of the compressed strips and tiles of TIFF files as libtiff
// 4.7 (the build inside OpenCV 5.0) decodes them under cv2.imread: LZW
// (tif_lzw.c LZWDecode, and LZWDecodeCompat for old-style codes), PackBits
// (tif_packbits.c PackBitsDecode) and SGILog (tif_luv.c LogL16Decode,
// LogLuvDecode32 and LogLuvDecode24 into the 8-bit samples of the RGBA
// reader); and the
// RGBA reader's CIELab conversion (tif_getimage.c putcontig8bitCIELab8 /
// 16 through tif_color.c).  The caller (fots_torch/imageio.py) parses the
// directory, inflates Deflate strips with zlib and converts the samples.
//
// Each decoder fills `out` (`occ` bytes, zeroed by the caller) and returns 1,
// or 0 where libtiff's decoder fails: the bytes it wrote before failing stay
// in `out`, as they stay in the zeroed strip buffer that TIFFReadRGBAStrip /
// TIFFReadRGBATile go on to convert.
//   - LZW: codes MSB first, 9 to 12 bits with the early change (the width
//     grows when the next free entry reaches 2^bits - 1), the first code
//     must be a clear code, a code after a clear must be a literal, a code
//     past the table (length 0) fails, a string longer than the room left is
//     cut to the room, data that ends acts as the end-of-information code,
//     and output short of `occ` fails;
//   - old-style LZW (a strip starting 00 with bit 0 of its second byte set,
//     so its first code is a clear code): codes LSB first, the width grows
//     one code later (when the next free entry passes 2^bits - 1), else as
//     LZW;
//   - PackBits: runs and literal spans cut to the room left, data that ends
//     inside a span stops there, and output short of `occ` fails;
//   - SGILog: each row's bytes in 2 (LogL) or 4 (LogLuv) planes, high byte
//     first, each a run (a byte >= 128: that count - 126 copies of the next
//     byte) or a literal span (a byte n: the n bytes after it); a row short
//     of data fails and leaves it and every later row of the strip
//     unwritten.  LogL16toY then the square-root grey (L16toGry); LogLuv32
//     to XYZ to RGB (XYZtoRGB24), in double as libtiff computes them;
//   - SGILog24: 3 bytes a pixel, the 14-bit uv index through uvcode.h's
//     table (uv_decode, the neutral colour past its end).
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kTableSize = (1 << kBitsMax) - 1 + 1024;  // CSIZE

struct Code {
  int next;  // the entry this string extends, -1 for none
  int length;
  uint8_t value, firstchar;
};

int lzw_decode(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  std::vector<Code> tab(kTableSize);
  for (int c = 0; c < 256; c++) tab[size_t(c)] = Code{-1, 1, uint8_t(c), uint8_t(c)};
  // the state after LZWPreDecode: the first code must be a clear code
  int free_ent = -1, old = 0, nbits = kBitsMin;
  int maxcode = (1 << nbits) - 2;  // MAXCODE(nbits) - 1
  uint64_t bitsleft = uint64_t(n) * 8;
  int64_t pos = 0;
  uint32_t nextdata = 0;
  int nextbits = 0;
  auto get = [&]() -> int {
    if (bitsleft < uint64_t(nbits)) return kEoi;  // "not terminated with EOI code"
    while (nextbits < nbits) {
      nextdata = (nextdata << 8) | src[pos++];
      nextbits += 8;
    }
    int code = int((nextdata >> (nextbits - nbits)) & ((1u << nbits) - 1));
    nextbits -= nbits;
    bitsleft -= uint64_t(nbits);
    return code;
  };
  uint8_t* op = out;
  while (occ > 0) {
    int code = get();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int c = kFirst; c < kTableSize; c++) tab[size_t(c)] = Code{-1, 0, 0, 0};
        nbits = kBitsMin;
        maxcode = (1 << nbits) - 2;
        code = get();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return 0;  // "Corrupted LZW table"
      *op++ = uint8_t(code);
      occ--;
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kTableSize) return 0;
    Code& e = tab[size_t(free_ent)];
    e.next = old;
    e.firstchar = tab[size_t(old)].firstchar;
    e.length = tab[size_t(old)].length + 1;
    e.value = code < free_ent ? tab[size_t(code)].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 2;
    }
    old = code;
    if (code < 256) {
      *op++ = uint8_t(code);
      occ--;
      continue;
    }
    const Code* c = &tab[size_t(code)];
    if (c->length == 0) return 0;  // "Wrong length of decoded string"
    int skip = c->length > occ ? int(c->length - occ) : 0;  // cut to the room left
    for (; skip > 0; skip--) c = &tab[size_t(c->next)];
    const int len = c->length;
    for (uint8_t* tp = op + len; tp > op; c = c->next >= 0 ? &tab[size_t(c->next)] : c) *--tp = c->value;
    op += len;
    occ -= len;
  }
  return occ > 0 ? 0 : 1;  // "Not enough data"
}

int packbits_decode(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ) {
  while (cc > 0 && occ > 0) {
    int n = *bp++;
    cc--;
    if (n >= 128) n -= 256;
    if (n < 0) {  // the next byte -n + 1 times
      if (n == -128) continue;
      int64_t k = -n + 1;
      if (occ < k) k = occ;
      if (cc == 0) break;
      occ -= k;
      const uint8_t b = *bp++;
      cc--;
      std::memset(op, b, size_t(k));
      op += k;
    } else {  // the next n + 1 bytes
      int64_t k = n + 1;
      if (occ < k) k = occ;
      if (cc < k) break;
      std::memcpy(op, bp, size_t(k));
      op += k;
      occ -= k;
      bp += k;
      cc -= k;
    }
  }
  return occ > 0 ? 0 : 1;
}

// LZWDecodeCompat: as lzw_decode with LSB-first codes and the late width change
int lzw_decode_compat(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  std::vector<Code> tab(kTableSize);
  for (int c = 0; c < 256; c++) tab[size_t(c)] = Code{-1, 1, uint8_t(c), uint8_t(c)};
  int free_ent = kFirst, old = -1, nbits = kBitsMin;
  int maxcode = (1 << nbits) - 2;  // LZWPreDecode's dec_maxcodep before the first clear
  uint64_t bitsleft = uint64_t(n) * 8;
  int64_t pos = 0;
  uint64_t nextdata = 0;
  int nextbits = 0;
  auto byte = [&]() -> uint64_t { return pos < n ? src[pos++] : (pos++, 0); };
  auto get = [&]() -> int {
    if (bitsleft < uint64_t(nbits)) return kEoi;
    nextdata |= byte() << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= byte() << nextbits;
      nextbits += 8;
    }
    const int code = int(nextdata & ((1u << nbits) - 1));
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= uint64_t(nbits);
    return code;
  };
  uint8_t* op = out;
  while (occ > 0) {
    int code = get();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int c = kFirst; c < kTableSize; c++) tab[size_t(c)] = Code{-1, 0, 0, 0};
        nbits = kBitsMin;
        maxcode = (1 << nbits) - 1;
        code = get();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return 0;  // "Corrupted LZW table"
      *op++ = uint8_t(code);
      occ--;
      old = code;
      continue;
    }
    if (free_ent >= kTableSize || old < 0) return 0;  // "Corrupted LZW table"
    Code& e = tab[size_t(free_ent)];
    e.next = old;
    e.firstchar = tab[size_t(old)].firstchar;
    e.length = tab[size_t(old)].length + 1;
    e.value = code < free_ent ? tab[size_t(code)].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 1;
    }
    old = code;
    if (code < 256) {
      *op++ = uint8_t(code);
      occ--;
      continue;
    }
    const Code* c = &tab[size_t(code)];
    if (c->length == 0) return 0;  // "Wrong length of decoded string"
    int skip = c->length > occ ? int(c->length - occ) : 0;  // cut to the room left
    for (; skip > 0; skip--) c = &tab[size_t(c->next)];
    const int len = c->length;
    for (uint8_t* tp = op + len; tp > op; c = c->next >= 0 ? &tab[size_t(c->next)] : c) *--tp = c->value;
    op += len;
    occ -= len;
  }
  return occ > 0 ? 0 : 1;  // "Not enough data"
}

double logl16_to_y(int p16) {  // LogL16toY
  const int le = p16 & 0x7fff;
  if (!le) return 0.;
  const double y = std::exp(M_LN2 / 256. * (le + .5) - M_LN2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

inline uint8_t gamma2(double v) {  // the 2.0 gamma of L16toGry and XYZtoRGB24
  return uint8_t((v <= 0.) ? 0 : (v >= 1.) ? 255 : int(256. * std::sqrt(v)));
}

// uvcode.h's uv_row: for each row of (u', v') squares, the u' of its first
// square, its square count and the squares before it.  Recovered from
// cv2.imread's float decoding of every index (each start is a 6-decimal
// constant, within 1e-8 of the recovered value); the tests hold every 24-bit
// LogLuv24 value against cv2.imread
struct UvRow {
  float ustart;
  short nus, ncum;
};
constexpr int kUvNvs = 163, kUvNdivs = 16289;
constexpr float kUvSqsiz = 0.003500f, kUvVstart = 0.016940f;
const UvRow kUvRow[kUvNvs] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10}, {0.237874f, 9, 17},
    {0.235906f, 10, 26}, {0.232153f, 12, 36}, {0.228352f, 14, 48}, {0.226259f, 15, 62},
    {0.222371f, 17, 77}, {0.220410f, 18, 94}, {0.214710f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204}, {0.199245f, 29, 231},
    {0.195525f, 31, 260}, {0.193560f, 32, 291}, {0.189878f, 34, 323}, {0.186216f, 36, 357},
    {0.186216f, 36, 393}, {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637}, {0.168612f, 46, 683},
    {0.163575f, 49, 729}, {0.158642f, 52, 778}, {0.158642f, 52, 830}, {0.158642f, 52, 882},
    {0.153815f, 55, 934}, {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284}, {0.138270f, 65, 1346},
    {0.138270f, 65, 1411}, {0.138270f, 65, 1476}, {0.132166f, 69, 1541}, {0.132166f, 69, 1610},
    {0.126204f, 73, 1679}, {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129}, {0.112962f, 82, 2206},
    {0.112962f, 82, 2288}, {0.112962f, 82, 2370}, {0.107450f, 86, 2452}, {0.107450f, 86, 2538},
    {0.107450f, 86, 2624}, {0.107450f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164}, {0.095126f, 95, 3259},
    {0.095126f, 95, 3354}, {0.088276f, 100, 3449}, {0.088276f, 100, 3549}, {0.088276f, 100, 3649},
    {0.088276f, 100, 3749}, {0.081523f, 105, 3849}, {0.081523f, 105, 3954}, {0.081523f, 105, 4059},
    {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379}, {0.074861f, 110, 4489},
    {0.074861f, 110, 4599}, {0.068290f, 115, 4709}, {0.068290f, 115, 4824}, {0.068290f, 115, 4939},
    {0.068290f, 115, 5054}, {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407},
    {0.063573f, 119, 5526}, {0.057219f, 124, 5645}, {0.057219f, 124, 5769}, {0.057219f, 124, 5893},
    {0.057219f, 124, 6017}, {0.050985f, 129, 6141}, {0.050985f, 129, 6270}, {0.050985f, 129, 6399},
    {0.050985f, 129, 6528}, {0.050985f, 129, 6657}, {0.044859f, 134, 6786}, {0.044859f, 134, 6920},
    {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322}, {0.040571f, 138, 7460},
    {0.040571f, 138, 7598}, {0.040571f, 138, 7736}, {0.036339f, 142, 7874}, {0.036339f, 142, 8016},
    {0.036339f, 142, 8158}, {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588},
    {0.032139f, 146, 8734}, {0.032139f, 146, 8880}, {0.027947f, 150, 9026}, {0.027947f, 150, 9176},
    {0.027947f, 150, 9326}, {0.023739f, 154, 9476}, {0.023739f, 154, 9630}, {0.023739f, 154, 9784},
    {0.023739f, 154, 9938}, {0.019504f, 158, 10092}, {0.019504f, 158, 10250},
    {0.019504f, 158, 10408}, {0.016976f, 161, 10566}, {0.016976f, 161, 10727},
    {0.016976f, 161, 10888}, {0.016976f, 161, 11049}, {0.012639f, 165, 11210},
    {0.012639f, 165, 11375}, {0.012639f, 165, 11540}, {0.009991f, 168, 11705},
    {0.009991f, 168, 11873}, {0.009991f, 168, 12041}, {0.009016f, 170, 12209},
    {0.009016f, 170, 12379}, {0.009016f, 170, 12549}, {0.006217f, 173, 12719},
    {0.006217f, 173, 12892}, {0.005097f, 175, 13065}, {0.005097f, 175, 13240},
    {0.005097f, 175, 13415}, {0.003909f, 177, 13590}, {0.003909f, 177, 13767},
    {0.002340f, 177, 13944}, {0.002389f, 170, 14121}, {0.001068f, 164, 14291},
    {0.001653f, 157, 14455}, {0.000717f, 150, 14612}, {0.001614f, 143, 14762},
    {0.000270f, 136, 14905}, {0.000484f, 129, 15041}, {0.001103f, 123, 15170},
    {0.001242f, 115, 15293}, {0.001188f, 109, 15408}, {0.001011f, 103, 15517},
    {0.000709f, 97, 15620}, {0.000301f, 89, 15717}, {0.002416f, 82, 15806}, {0.003251f, 76, 15888},
    {0.003246f, 69, 15964}, {0.004141f, 62, 16033}, {0.005963f, 55, 16095}, {0.008839f, 47, 16150},
    {0.010490f, 40, 16197}, {0.016994f, 31, 16237}, {0.023659f, 21, 16268}};

// uv_decode: the (u', v') of a 14-bit index; false past the last square
bool uv_decode(double* up, double* vp, int c) {
  if (c < 0 || c >= kUvNdivs) return false;
  int lower = 0, upper = kUvNvs;
  while (upper - lower > 1) {
    const int vi = (lower + upper) >> 1;
    const int ui = c - kUvRow[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  const int vi = lower, ui = c - kUvRow[vi].ncum;
  *up = kUvRow[vi].ustart + (ui + .5) * kUvSqsiz;
  *vp = kUvVstart + (vi + .5) * kUvSqsiz;
  return true;
}

// XYZ (as floats) to the 8-bit RGB of XYZtoRGB24
void xyz_to_rgb24(double x, double y, double z, uint8_t* o) {
  o[0] = gamma2(2.690 * x + -1.276 * y + -0.414 * z);
  o[1] = gamma2(-1.022 * x + 1.978 * y + 0.044 * z);
  o[2] = gamma2(0.061 * x + -0.224 * y + 1.163 * z);
}

// LogLuv's luminance l and (u', v') to XYZ as LogLuv32toXYZ / LogLuv24toXYZ
// store them (floats), then to RGB
void luv_to_rgb24(double l, double u, double v, uint8_t* o) {
  double x = 0, y = 0, z = 0;
  if (l > 0.) {
    const double s = 1. / (6. * u - 16. * v + 12.);
    const double cx = 9. * u * s, cy = 4. * v * s;
    x = float(cx / cy * l);
    y = float(l);
    z = float((1. - cx - cy) / cy * l);
  }
  xyz_to_rgb24(x, y, z, o);
}

// SGILog24 rows (LogLuvDecode24: 3 bytes a pixel, 10-bit log luminance and
// a 14-bit uv index) into 8-bit RGB
int sgilog24_decode(const uint8_t* bp, int64_t cc, uint8_t* out, int64_t rows, int64_t width) {
  for (int64_t r = 0; r < rows; r++) {
    if (cc < 3 * width) return 0;  // "Not enough data at row"
    uint8_t* o = out + r * width * 3;
    for (int64_t i = 0; i < width; i++, bp += 3, cc -= 3) {
      const uint32_t p = uint32_t(bp[0]) << 16 | uint32_t(bp[1]) << 8 | bp[2];
      const int l10 = int(p >> 14 & 0x3ff);
      const double l = l10 == 0 ? 0. : std::exp(M_LN2 / 64. * (l10 + .5) - M_LN2 * 12.);
      double u, v;
      if (!uv_decode(&u, &v, int(p & 0x3fff))) {
        u = 0.210526316;  // U_NEU, V_NEU
        v = 0.473684211;
      }
      luv_to_rgb24(l, u, v, o + 3 * i);
    }
  }
  return 1;
}

// SGILog rows (LogL16Decode / LogLuvDecode32) into 8-bit grey or RGB
int sgilog_decode(const uint8_t* bp, int64_t cc, uint8_t* out, int64_t rows, int64_t width,
                  int luv) {
  const int nbytes = luv ? 4 : 2;
  std::vector<uint32_t> tp(static_cast<size_t>(width));
  for (int64_t r = 0; r < rows; r++) {
    std::fill(tp.begin(), tp.end(), 0u);
    for (int shft = 8 * (nbytes - 1); shft >= 0; shft -= 8) {
      int64_t i = 0;
      while (i < width && cc > 0) {
        if (*bp >= 128) {  // a run
          if (cc < 2) break;
          int rc = *bp++ + (2 - 128);
          const uint32_t b = uint32_t(*bp++) << shft;
          cc -= 2;
          while (rc-- && i < width) tp[size_t(i++)] |= b;
        } else {  // a literal span (0: nothing)
          int rc = *bp++;
          while (--cc && rc-- && i < width) tp[size_t(i++)] |= uint32_t(*bp++) << shft;
        }
      }
      if (i != width) return 0;  // "Not enough data at row"
    }
    uint8_t* o = out + r * width * (luv ? 3 : 1);
    for (int64_t i = 0; i < width; i++) {
      if (!luv) {
        o[i] = gamma2(logl16_to_y(int(int16_t(uint16_t(tp[size_t(i)])))));
        continue;
      }
      const uint32_t p = tp[size_t(i)];
      luv_to_rgb24(logl16_to_y(int32_t(p) >> 16), 1. / 410. * ((p >> 8 & 0xff) + .5),
                   1. / 410. * ((p & 0xff) + .5), o + 3 * i);  // LogLuv32toXYZ
    }
  }
  return 1;
}

// TIFFCIELabToRGBInit over display_sRGB, TIFFCIELab16ToXYZ and TIFFXYZToRGB
struct CieLab {
  static constexpr int kRange = 1500;
  float table[kRange + 1];
  float step, x0, y0, z0;
  CieLab(float wx, float wy) {
    const double gamma = 1.0 / 2.4f;
    step = (100.0f - 1.0f) / kRange;
    for (int i = 0; i <= kRange; i++) table[i] = 255 * float(std::pow(double(i) / kRange, gamma));
    y0 = 100.0f;
    x0 = wx / wy * y0;
    z0 = (1.0f - wx - wy) / wy * y0;
  }
  void rgb(uint32_t l, int32_t a, int32_t b, uint8_t* out) const {
    const float lf = float(l) * 100.0f / 65535.0f;
    float cby, tmp, X, Y, Z;
    if (lf < 8.856f) {
      Y = (lf * y0) / 903.292f;
      cby = 7.787f * (Y / y0) + 16.0f / 116.0f;
    } else {
      cby = (lf + 16.0f) / 116.0f;
      Y = y0 * cby * cby * cby;
    }
    tmp = float(a) / 256.0f / 500.0f + cby;
    X = tmp < 0.2069f ? x0 * (tmp - 0.13793f) / 7.787f : x0 * tmp * tmp * tmp;
    tmp = cby - float(b) / 256.0f / 200.0f;
    Z = tmp < 0.2069f ? z0 * (tmp - 0.13793f) / 7.787f : z0 * tmp * tmp * tmp;
    const float m[9] = {3.2410f, -1.5374f, -0.4986f, -0.9692f, 1.8760f, 0.0416f,
                        0.0556f, -0.2040f, 1.0570f};
    for (int c = 0; c < 3; c++) {
      float yc = m[3 * c] * X + m[3 * c + 1] * Y + m[3 * c + 2] * Z;
      yc = std::max(yc, 1.0f);
      yc = std::min(yc, 100.0f);
      int i = int((yc - 1.0f) / step);
      i = std::min(kRange, i);
      const float t = table[i];
      uint32_t v = uint32_t(t > 0 ? t + 0.5 : t - 0.5);  // RINT
      out[c] = uint8_t(std::min<uint32_t>(v, 255));
    }
  }
};

}  // namespace

extern "C" {

int fots_tiff_lzw_compat(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  return lzw_decode_compat(src, n, out, occ);
}

// out: rows * width grey (LogL) or RGB (LogLuv) bytes, zeroed by the caller;
// mode 0 LogL, 1 LogLuv (SGILog), 2 LogLuv24 (SGILog24)
int fots_tiff_sgilog(const uint8_t* src, int64_t n, uint8_t* out, int64_t rows, int64_t width,
                     int mode) {
  if (mode == 2) return sgilog24_decode(src, n, out, rows, width);
  return sgilog_decode(src, n, out, rows, width, mode);
}

// CIELab samples (8 bits: L unsigned, a and b signed; 16 bits: host-order
// words, the same signs) to RGB, with the white point's chromaticity
void fots_tiff_cielab(const void* samples, int64_t npix, int bits, float wx, float wy,
                      uint8_t* rgb) {
  const CieLab lab(wx, wy);
  for (int64_t i = 0; i < npix; i++) {
    if (bits == 8) {
      const uint8_t* p = static_cast<const uint8_t*>(samples) + 3 * i;
      lab.rgb(uint32_t(p[0]) * 257, int32_t(int8_t(p[1])) * 256, int32_t(int8_t(p[2])) * 256,
              rgb + 3 * i);
    } else {
      const uint16_t* p = static_cast<const uint16_t*>(samples) + 3 * i;
      lab.rgb(p[0], int16_t(p[1]), int16_t(p[2]), rgb + 3 * i);
    }
  }
}

int fots_tiff_lzw(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  return lzw_decode(src, n, out, occ);
}

int fots_tiff_packbits(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  return packbits_decode(src, n, out, occ);
}

}  // extern "C"
