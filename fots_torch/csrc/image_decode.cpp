// Host image decoding for the port's file entry points: baseline JPEG and the
// unfiltering of 8-bit PNG scanlines, with the results of OpenCV's imread.
//
// JPEG.  Reproduces libjpeg-turbo's default decompression as OpenCV's JPEG
// reader asks for it (output BGR or grayscale, islow IDCT, fancy upsampling),
// so the bytes equal cv2.imread's:
//   - sequential Huffman frames (SOF0, SOF1), 8-bit samples, 1 or 3
//     components, integral sampling ratios, restart intervals, any number of
//     scans that each code their components once;
//   - the accurate integer IDCT of jidctint.c (13-bit constants, pass-1
//     descale by 11 bits, output through the 0x3FF-masked range-limit table);
//   - the upsamplers of jdsample.c: h2v1 and h2v2 "fancy" (triangle filter
//     with alternating rounding bias; context rows clamped to the component's
//     real rows), h1v2 fancy, box replication for every other integral ratio
//     and for h2v1/h2v2 components at most 2 samples wide;
//   - jdcolor.c's YCbCr->RGB tables (16-bit fixed point, ONE_HALF rounding);
//   - grayscale output of a colour file: the Y component alone, as
//     JCS_GRAYSCALE output does; colour output of a grayscale file: Y copied
//     into three channels;
//   - the orientation tag of the first APP1 segment is reported (the caller
//     applies it as imread does).
// Anything else (progressive or arithmetic coding, lossless, 12-bit
// samples, 2 or 4 components, RGB-coded or Adobe CMYK/YCCK files, a stream
// that ends before its last block) is refused with a message.
//
// PNG.  The caller parses the chunks and inflates IDAT (zlib); this file
// undoes the five scanline filters of 8-bit non-interlaced images and
// converts as libpng does under imread's settings:
// alpha stripped, RGB -> BGR, palette expanded, gray -> BGR, and for
// grayscale output png_set_rgb_to_gray(1, 0.299, 0.587)'s truncating
// fixed-point sum (coefficients 9797, 19234, 3737 over 2^15; a pixel with
// r == g == b stays r).
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.  Every entry point returns 0, or -1 with
// a message in `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Refused : std::runtime_error {
  explicit Refused(const std::string& m) : std::runtime_error(m) {}
};

// zigzag position -> natural (row-major) position; 16 extra entries of 63
// absorb a run that overshoots in corrupt data, as jpeg_natural_order does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

struct HuffTable {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[17]; // vals index of a length's first code minus that code
  uint16_t lookup[1 << 9];  // 9-bit prefix -> (length << 8) | value; 0 = longer
};

void build_huff(HuffTable& t, const uint8_t* counts, const uint8_t* symbols, int nsym) {
  std::memcpy(t.vals, symbols, nsym);
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l - 1]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) throw Refused("corrupt Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[0] = 0;
  t.maxcode[0] = -1;
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.lookup, 0, sizeof(t.lookup));
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 0; i < counts[l - 1]; i++, p++) {
      int lo = huffcode[p] << (9 - l);
      for (int k = 0; k < (1 << (9 - l)); k++)
        t.lookup[lo + k] = static_cast<uint16_t>((l << 8) | symbols[p]);
    }
  }
  t.defined = true;
}

// Entropy-coded bits, MSB first, with FF00 unstuffing.  At a marker or at
// the end of the data it supplies zero bits; consuming one of those means
// the stream ended early, which is refused.
struct BitReader {
  const uint8_t* data;
  size_t pos, end;
  uint64_t acc = 0;
  int nbits = 0;  // valid bits in acc (real ones first, then zero padding)
  int nreal = 0;  // how many of them came from the stream
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      int c = 0;
      bool real = false;
      if (!at_marker && pos < end) {
        c = data[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < end && data[q] == 0xFF) q++;
          if (q < end && data[q] == 0x00) {
            pos = q + 1;
            real = true;
          } else {
            at_marker = true;  // pos stays on the marker's first FF
            c = 0;
          }
        } else {
          pos++;
          real = true;
        }
      }
      acc |= static_cast<uint64_t>(c) << (56 - nbits);
      nbits += 8;
      if (real) nreal += 8;
    }
  }
  void consume(int n) {
    if (n > nreal) throw Refused("the entropy-coded data ends before the last block (truncated)");
    acc <<= n;
    nbits -= n;
    nreal -= n;
  }
  int bits(int n) {  // n in 1..16
    if (nbits < n) fill();
    int v = static_cast<int>(acc >> (64 - n));
    consume(n);
    return v;
  }
  int decode(const HuffTable& t) {
    if (nbits < 16) fill();
    int e = t.lookup[acc >> (64 - 9)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int code = static_cast<int>(acc >> (64 - l));
    while (code > t.maxcode[l]) {
      l++;
      if (l > 16) throw Refused("corrupt entropy-coded data (no Huffman code of 16 bits or fewer)");
      code = static_cast<int>(acc >> (64 - l));
    }
    consume(l);
    return t.vals[(t.valoffset[l] + code) & 0xFF];
  }
  // drop buffered bits and step over the restart marker that must follow
  void restart(int expected) {
    acc = 0;
    nbits = nreal = 0;
    at_marker = false;
    while (pos + 1 < end && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF))
      pos++;
    if (pos + 1 >= end) throw Refused("the stream ends before a restart marker (truncated)");
    if (data[pos + 1] != 0xD0 + expected)
      throw Refused("restart marker out of sequence");
    pos += 2;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v; }

// ---------------------------------------------------------------- IDCT

const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jdmaster.c's sample_range_limit seen from IDCT_range_limit, indexed by the
// 10-bit masked output: x + 128 clamped for |x| < 512, wrapped beyond
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; v++) {
      int x = v + 128;  // index into sample_range_limit
      int out;
      if (x < 256) out = x;
      else if (x < 640) out = 255;
      else if (x < 1024) out = 0;
      else out = x - 1024;
      t[v] = static_cast<uint8_t>(out);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const int32_t* quant, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int32_t* q = quant + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (in[0] * q[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * q[16], z3 = in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * q[0];
    z3 = in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * q[56];
    tmp1 = in[40] * q[40];
    tmp2 = in[24] * q[24];
    tmp3 = in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t v = kRange.t[descale(w[0], PASS1_BITS + 3) & 0x3FF];
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = kRange.t[descale(tmp10 + tmp3, sh) & 0x3FF];
    o[7] = kRange.t[descale(tmp10 - tmp3, sh) & 0x3FF];
    o[1] = kRange.t[descale(tmp11 + tmp2, sh) & 0x3FF];
    o[6] = kRange.t[descale(tmp11 - tmp2, sh) & 0x3FF];
    o[2] = kRange.t[descale(tmp12 + tmp1, sh) & 0x3FF];
    o[5] = kRange.t[descale(tmp12 - tmp1, sh) & 0x3FF];
    o[3] = kRange.t[descale(tmp13 + tmp0, sh) & 0x3FF];
    o[4] = kRange.t[descale(tmp13 - tmp0, sh) & 0x3FF];
  }
}

// ---------------------------------------------------------------- EXIF

// The orientation tag of a TIFF-structured EXIF block as OpenCV's ExifReader
// finds it: byte order "II" (else Motorola order), the 42 mark, IFD0's
// entries in order; any read past the end stops the search.  1 when absent.
int exif_orientation(const uint8_t* p, size_t n) {
  bool intel;
  if (n >= 2 && p[0] != p[1]) intel = false;
  else intel = n >= 1 && p[0] == 'I';
  auto get16 = [&](size_t off, int* out) {
    if (off + 1 >= n) return false;
    *out = intel ? p[off] | (p[off + 1] << 8) : (p[off] << 8) | p[off + 1];
    return true;
  };
  auto get32 = [&](size_t off, uint32_t* out) {
    if (off + 3 >= n) return false;
    *out = intel ? (uint32_t(p[off]) | (uint32_t(p[off + 1]) << 8) |
                    (uint32_t(p[off + 2]) << 16) | (uint32_t(p[off + 3]) << 24))
                 : ((uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                    (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]));
    return true;
  };
  int mark, count;
  uint32_t ifd;
  if (!get16(2, &mark) || mark != 42 || !get32(4, &ifd) || !get16(ifd, &count)) return 1;
  size_t off = size_t(ifd) + 2;
  for (int i = 0; i < count; i++, off += 12) {
    int tag, value;
    if (!get16(off, &tag)) return 1;
    if (tag == 0x0112) return get16(off + 8, &value) ? value : 1;
  }
  return 1;
}

// ---------------------------------------------------------------- JPEG

struct Component {
  int id, h, v, tq;
  int blocks_w, blocks_h;   // blocks of the plane (the MCU grid's share)
  int width_in_blocks, height_in_blocks;  // blocks holding real samples
  int ds_w, ds_h;           // real samples
  int stride;               // plane row bytes
  std::vector<uint8_t> plane;
  int32_t quant[64];
  bool scanned = false;
  int dc_pred = 0;
  int td = 0, ta = 0;
};

struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int orientation = 1;
  bool saw_app1 = false;
  bool quant_defined[4] = {false, false, false, false};
  uint16_t quant_tables[4][64];  // natural order
  HuffTable dc[4], ac[4];
  Component comp[3];

  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) throw Refused("the file ends inside a marker segment (truncated)");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // skip anything up to an FF, then fill FFs
    while (pos < size && data[pos] != 0xFF) pos++;
    while (pos < size && data[pos] == 0xFF) pos++;
    if (pos >= size) return -1;
    return data[pos++];
  }

  void read_app1(size_t start, size_t len) {
    if (saw_app1) return;
    saw_app1 = true;
    // OpenCV hands the segment to its EXIF parser 6 bytes in ("Exif\0\0")
    if (len > 6) orientation = exif_orientation(data + start + 6, len - 6);
  }

  void read_sof(int marker) {
    if (have_frame) throw Refused("more than one frame header");
    int len = u16();
    size_t end = pos + len - 2;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8) throw Refused(std::to_string(precision) + "-bit samples (only 8-bit)");
    if (height == 0) throw Refused("the height is given by a DNL marker (not supported)");
    if (width == 0) throw Refused("zero image width");
    if (ncomp == 4) throw Refused("4 components (CMYK/YCCK are not supported)");
    if (ncomp != 1 && ncomp != 3)
      throw Refused(std::to_string(ncomp) + " components (only 1 or 3)");
    if (len != 8 + 3 * ncomp) throw Refused("bad frame header length");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Refused("bad sampling factors");
      if (c.tq > 3) throw Refused("bad quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    (void)marker;
    pos = end;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        throw Refused("non-integral sampling ratios are not supported");
    }
    if (int64_t(width) * height > (int64_t(1) << 30)) throw Refused("image too large");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.blocks_w = mcux * c.h;
      c.blocks_h = mcuy * c.v;
      c.width_in_blocks = int((int64_t(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.height_in_blocks = int((int64_t(height) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.ds_w = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.ds_h = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.stride = c.blocks_w * 8;
    }
    have_frame = true;
  }

  void read_dqt() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw Refused("bad quantization table");
      for (int k = 0; k < 64; k++) quant_tables[tq][kNatural[k]] = uint16_t(pq ? u16() : u8());
      quant_defined[tq] = true;
    }
    pos = end;
  }

  void read_dht() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Refused("bad Huffman table class or index");
      uint8_t counts[16], symbols[256];
      int n = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = uint8_t(u8());
        n += counts[i];
      }
      if (n > 256) throw Refused("corrupt Huffman table (more than 256 symbols)");
      for (int i = 0; i < n; i++) symbols[i] = uint8_t(u8());
      build_huff(tc ? ac[th] : dc[th], counts, symbols, n);
    }
    pos = end;
  }

  void read_app(int marker) {
    int len = u16();
    if (len < 2) throw Refused("bad marker segment length");
    size_t start = pos, n = len - 2;
    if (start + n > size) throw Refused("the file ends inside a marker segment (truncated)");
    if (marker == 0xE0 && n >= 5 && std::memcmp(data + start, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(data + start, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[start + 11];
    }
    if (marker == 0xE1) read_app1(start, n);
    pos = start + n;
  }

  void check_colour_space() {
    if (ncomp != 3) return;
    bool rgb = false;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    if (rgb) throw Refused("RGB-coded colour components (only YCbCr)");
  }

  // Decode one scan; `decode_all` false skips the IDCT of components other
  // than the first (grayscale output needs Y alone).
  void read_sos(bool decode_all) {
    if (!have_frame) throw Refused("scan before the frame header");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) throw Refused("bad scan header");
    Component* sc[3];
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) c = &comp[k];
      if (!c) throw Refused("scan names an unknown component");
      if (c->scanned) throw Refused("a component coded in two scans (progressive?)");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        throw Refused("scan uses an undefined Huffman table");
      if (!quant_defined[c->tq]) throw Refused("scan uses an undefined quantization table");
      for (int k = 0; k < 64; k++) c->quant[k] = quant_tables[c->tq][k];
      if (c->plane.empty()) c->plane.assign(size_t(c->stride) * c->blocks_h * 8, 0);
      c->dc_pred = 0;
      sc[i] = c;
    }
    u8();  // Ss
    u8();  // Se
    u8();  // Ah/Al
    BitReader br{data, pos, size};
    int16_t block[64];
    auto decode_block = [&](Component* c, int by, int bx) {
      std::memset(block, 0, sizeof(block));
      int s = br.decode(dc[c->td]);
      int diff = 0;
      if (s) {
        if (s > 16) throw Refused("corrupt DC coefficient");
        diff = extend(br.bits(s), s);
      }
      c->dc_pred += diff;
      block[0] = int16_t(c->dc_pred);
      const HuffTable& act = ac[c->ta];
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          block[kNatural[k]] = int16_t(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      if (decode_all || c == &comp[0])
        idct_islow(block, c->quant, c->plane.data() + size_t(by) * 8 * c->stride + bx * 8,
                   c->stride);
    };
    int64_t n_mcu;
    int mcus_per_row;
    if (ns == 1) {
      mcus_per_row = sc[0]->width_in_blocks;
      n_mcu = int64_t(mcus_per_row) * sc[0]->height_in_blocks;
    } else {
      mcus_per_row = mcux;
      n_mcu = int64_t(mcux) * mcuy;
    }
    int next_rst = 0;
    for (int64_t m = 0; m < n_mcu; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
      }
      int my = int(m / mcus_per_row), mx = int(m % mcus_per_row);
      if (ns == 1) {
        decode_block(sc[0], my, mx);
      } else {
        for (int i = 0; i < ns; i++) {
          Component* c = sc[i];
          for (int y = 0; y < c->v; y++)
            for (int x = 0; x < c->h; x++) decode_block(c, my * c->v + y, mx * c->h + x);
        }
      }
    }
    for (int i = 0; i < ns; i++) sc[i]->scanned = true;
    pos = br.pos;
  }

  // Read markers up to EOI (or the end of the data once every component
  // has been coded).  `decode` false stops at the first scan.
  void run(bool decode, bool decode_all) {
    if (size < 3 || data[0] != 0xFF || data[1] != 0xD8) throw Refused("not a JPEG file");
    pos = 2;
    while (true) {
      int m = next_marker();
      if (m < 0) {
        for (int i = 0; i < ncomp; i++)
          if (!comp[i].scanned) throw Refused("the file ends before its image data (truncated)");
        if (!have_frame) throw Refused("no frame header");
        return;
      }
      if (m == 0xD9) {
        if (!have_frame) throw Refused("no frame header");
        for (int i = 0; i < ncomp; i++)
          if (!comp[i].scanned) throw Refused("EOI before every component was coded");
        return;
      }
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        throw Refused("progressive JPEG (only baseline/sequential)");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        throw Refused("lossless JPEG (only baseline/sequential)");
      } else if (m == 0xC5) {
        throw Refused("hierarchical JPEG (only baseline/sequential)");
      } else if (m == 0xC9) {
        throw Refused("arithmetic-coded JPEG (only Huffman coding)");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        u16();
        restart_interval = u16();
      } else if (m == 0xDA) {
        check_colour_space();
        if (!decode) return;
        read_sos(decode_all);
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        // parameterless
      } else if (m == 0xD8) {
        throw Refused("second SOI marker");
      } else {
        int len = u16();  // COM, DAC, DNL, DHP, EXP, JPGn, ...
        if (len < 2) throw Refused("bad marker segment length");
        pos += len - 2;
      }
    }
  }
};

// ---------------------------------------------------------------- upsampling

// The full-resolution plane (width x height) of one component.
void upsample(const Component& c, int hmax, int vmax, int width, int height, uint8_t* out) {
  const int he = hmax / c.h, ve = vmax / c.v;
  const uint8_t* in = c.plane.data();
  const int stride = c.stride, dsw = c.ds_w, dsh = c.ds_h;
  std::vector<uint8_t> row(size_t(dsw) * he + 8);
  auto emit = [&](int y, const uint8_t* src) { std::memcpy(out + size_t(y) * width, src, width); };
  if (he == 1 && ve == 1) {
    for (int y = 0; y < height; y++) emit(y, in + size_t(y) * stride);
    return;
  }
  if (he == 2 && ve == 1 && dsw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; y++) {
      const uint8_t* ip = in + size_t(y) * stride;
      uint8_t* op = row.data();
      int v = ip[0];
      op[0] = uint8_t(v);
      op[1] = uint8_t((v * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dsw - 1; x++) {
        v = ip[x] * 3;
        op[2 * x] = uint8_t((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = uint8_t((v + ip[x + 1] + 2) >> 2);
      }
      v = ip[dsw - 1];
      op[2 * dsw - 2] = uint8_t((v * 3 + ip[dsw - 2] + 1) >> 2);
      op[2 * dsw - 1] = uint8_t(v);
      emit(y, op);
    }
    return;
  }
  if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; y++) {
      int r = y >> 1;
      int nb = (y & 1) ? std::min(r + 1, dsh - 1) : std::max(r - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* p0 = in + size_t(r) * stride;
      const uint8_t* p1 = in + size_t(nb) * stride;
      uint8_t* op = row.data();
      for (int x = 0; x < dsw; x++) op[x] = uint8_t((p0[x] * 3 + p1[x] + bias) >> 2);
      emit(y, op);
    }
    return;
  }
  if (he == 2 && ve == 2 && dsw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < height; y++) {
      int r = y >> 1;
      int nb = (y & 1) ? std::min(r + 1, dsh - 1) : std::max(r - 1, 0);
      const uint8_t* p0 = in + size_t(r) * stride;
      const uint8_t* p1 = in + size_t(nb) * stride;
      uint8_t* op = row.data();
      int this_sum = p0[0] * 3 + p1[0];
      int next_sum = p0[1] * 3 + p1[1];
      op[0] = uint8_t((this_sum * 4 + 8) >> 4);
      op[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 2; x < dsw; x++) {
        next_sum = p0[x] * 3 + p1[x];
        op[2 * x - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        op[2 * x - 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      op[2 * dsw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      op[2 * dsw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
      emit(y, op);
    }
    return;
  }
  // h2v1_upsample, h2v2_upsample, int_upsample: box replication
  for (int y = 0; y < height; y++) {
    const uint8_t* ip = in + size_t(y / ve) * stride;
    uint8_t* op = row.data();
    for (int x = 0; x < dsw; x++)
      for (int k = 0; k < he; k++) op[x * he + k] = ip[x];
    emit(y, op);
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t SCALE = 16, HALF = int64_t(1) << (SCALE - 1);
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + HALF) >> SCALE);
      cb_b[i] = int((fix(1.77200) * x + HALF) >> SCALE);
      cr_g[i] = int32_t(-fix(0.71414) * x);
      cb_g[i] = int32_t(-fix(0.34414) * x + HALF);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void jpeg_decode(const uint8_t* data, size_t n, bool gray, uint8_t* out) {
  Jpeg j(data, n);
  j.run(true, !gray);
  const int W = j.width, H = j.height;
  if (gray) {
    upsample(j.comp[0], j.hmax, j.vmax, W, H, out);
    return;
  }
  const size_t npix = size_t(W) * H;
  if (j.ncomp == 1) {
    std::vector<uint8_t> y(npix);
    upsample(j.comp[0], j.hmax, j.vmax, W, H, y.data());
    for (size_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return;
  }
  std::vector<uint8_t> planes(npix * 3);
  for (int c = 0; c < 3; c++) upsample(j.comp[c], j.hmax, j.vmax, W, H, planes.data() + c * npix);
  const uint8_t *Y = planes.data(), *Cb = Y + npix, *Cr = Cb + npix;
  for (size_t i = 0; i < npix; i++) {
    int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i + 2] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * i + 1] = clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * i] = clamp255(y + kYcc.cb_b[cb]);
  }
}

// ---------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

inline uint8_t rgb_to_gray(int r, int g, int b) {
  if (r == g && r == b) return uint8_t(r);
  return uint8_t((9797 * r + 19234 * g + 3737 * b) >> 15);
}

void png_unfilter(const uint8_t* raw, size_t n, int width, int height, int color_type,
                  const uint8_t* palette, int npal, bool gray, uint8_t* out) {
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: throw Refused("unknown PNG colour type");
  }
  const size_t row_bytes = size_t(width) * channels;
  const int bpp = channels;  // filter byte distance
  if (n < (row_bytes + 1) * size_t(height))
    throw Refused("the image data ends early (truncated)");
  std::vector<uint8_t> prev(row_bytes, 0), cur(row_bytes);
  std::vector<uint8_t> px(size_t(width) * 4);
  palette = palette ? palette : reinterpret_cast<const uint8_t*>("");
  for (int y = 0; y < height; y++) {
    const uint8_t* src = raw + size_t(y) * (row_bytes + 1);
    int filter = src[0];
    src++;
    for (size_t i = 0; i < row_bytes; i++) {
      int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
      int b = prev[i];
      int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: throw Refused("bad PNG filter type " + std::to_string(filter));
      }
      cur[i] = uint8_t(src[i] + pred);
    }
    // to 8-bit samples, per pixel
    for (int x = 0; x < width; x++) {
      int r, g, b;
      const uint8_t* p = cur.data() + size_t(x) * channels;
      if (color_type == 3) {
        int v = p[0];
        if (v < npal) {
          r = palette[3 * v]; g = palette[3 * v + 1]; b = palette[3 * v + 2];
        } else {
          r = g = b = 0;
        }
      } else if (color_type == 0 || color_type == 4) {
        r = g = b = p[0];
      } else {
        r = p[0]; g = p[1]; b = p[2];
      }
      if (gray) {
        out[size_t(y) * width + x] = rgb_to_gray(r, g, b);
      } else {
        uint8_t* o = out + (size_t(y) * width + x) * 3;
        o[0] = uint8_t(b);
        o[1] = uint8_t(g);
        o[2] = uint8_t(r);
      }
    }
    std::swap(prev, cur);
  }
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

// info: height, width, components, EXIF orientation (1 when absent)
int fots_jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    Jpeg j(data, size_t(n));
    j.run(false, false);
    info[0] = j.height;
    info[1] = j.width;
    info[2] = j.ncomp;
    info[3] = j.orientation;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// out: height * width * 3 bytes (BGR) or height * width (gray)
int fots_jpeg_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, char* err,
                     int errlen) {
  try {
    jpeg_decode(data, size_t(n), gray != 0, out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// raw: the inflated IDAT stream of an 8-bit image; palette: npal RGB triplets
int fots_png_unfilter(const uint8_t* raw, int64_t n, int width, int height, int color_type,
                      const uint8_t* palette, int npal, int gray, uint8_t* out, char* err,
                      int errlen) {
  try {
    png_unfilter(raw, size_t(n), width, height, color_type, palette, npal, gray != 0, out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
