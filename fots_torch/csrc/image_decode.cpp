// Host image decoding for the port's file entry points: JPEG, and the
// scanlines of PNG, with the results of OpenCV's imread.
//
// JPEG.  Reproduces libjpeg-turbo's default decompression as OpenCV's JPEG
// reader asks for it (output BGR or grayscale, islow IDCT, fancy upsampling),
// so the bytes equal cv2.imread's:
//   - sequential (SOF0, SOF1) and progressive (SOF2) Huffman frames, 8-bit
//     samples, 1 or 3 components, integral sampling ratios (for grayscale
//     output of YCbCr, Y's alone: the chroma is not upsampled), restart
//     intervals, and a sequential frame's Huffman tables 0 and 1 taken from
//     Annex K where no DHT defines them (jdhuff.c:std_huff_tables).  Scans
//     are read into one int16 coefficient plane per component: a file of
//     several scans (progressive, or one scan per component) keeps the
//     whole image (libjpeg's whole-image buffer) and runs the IDCT, the
//     upsampling and the colour conversion once, after EOI; a single-scan
//     file keeps one MCU row and runs its IDCT as each row is decoded
//     (jdcoefct.c:decompress_onepass).  Progressive scans decode as
//     jdphuff.c does (DC first with its Al shift, DC refine, AC first with
//     EOB runs, AC refine with correction bits); each component's
//     quantization table is latched at its first scan
//     (jdinput.c:latch_quant_tables);
//   - a stream that ends early, as jdhuff.c reads it through the stdio
//     source: past the end of the file the source supplies fake EOI markers,
//     the bits of the MCU where the data ended are padded with zeros (a
//     padded code that is no Huffman code gives symbol 0 after 17 bits), and
//     every later MCU of the restart interval is left as it is (all zero in a
//     sequential file: 128 after the level shift).  Restart markers are
//     resynchronised as jdmarker.c:jpeg_resync_to_restart does;
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
//   - the orientation tag of the first APP1 segment before the first scan is
//     reported (the caller applies it as imread does).
// Two kinds of failure.  What libjpeg or OpenCV's use of it fails on is
// Unreadable (imread gives None): a file cut before its first scan's data,
// corrupt headers, unknown markers, hierarchical frames, 2 or 5-10
// components (no colour conversion), samples of other than 8 bits (OpenCV
// reads scanlines of 8), an MCU of more than 10 blocks, non-integral
// sampling of a component the output needs, an undefined Huffman table other
// than a sequential frame's 0 and 1, a lossless frame that is arithmetic-coded
// or whose colour space the output would convert.  What libjpeg reads and
// this file does not reproduce is Refused with a message: arithmetic coding,
// lossless frames, 4 components (CMYK, YCCK), RGB-coded files, and a
// progressive file that libjpeg would block-smooth (jdcoefct.c:smoothing_ok:
// some DCT coefficient 1-9 not refined to its last bit, as in a progressive
// file cut short).  A Refused frame's scans are still walked for libjpeg's
// errors, so that a file it fails on gives None.
//
// PNG.  The caller parses the chunks and inflates IDAT (zlib); this file
// undoes the five scanline filters, pass by pass for Adam7 interlacing, of
// every bit depth (1, 2, 4, 8, 16) and converts as libpng does under
// imread's settings: alpha stripped, RGB -> BGR, palette expanded (indices
// past a short palette are black), gray of 1/2/4 bits scaled to 8
// (png_set_expand_gray_1_2_4_to_8), gray -> BGR, 16 bits cut to their high
// byte (png_set_strip_16), and for grayscale output png_set_rgb_to_gray(1,
// 0.299, 0.587): at 8 bits the truncating fixed-point sum (coefficients 9797,
// 19234, 3737 over 2^15; a pixel with r == g == b stays r), at 16 bits the
// same sum rounded (+16384), before the strip.
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.  Every entry point returns 0; 1 with a
// message in `err` where imread gives None; -1 with a message where imread
// reads what this file does not reproduce.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// imread reads the file and this decoder does not reproduce the result
struct Refused : std::runtime_error {
  explicit Refused(const std::string& m) : std::runtime_error(m) {}
};
// imread gives None (libjpeg's or libpng's error exit)
struct Unreadable : std::runtime_error {
  explicit Unreadable(const std::string& m) : std::runtime_error(m) {}
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
  bool bad = false;      // code lengths that overflow (an error where a scan uses it)
  int max_sym = 0;       // a DC table's symbols must not pass 15 (16 in a lossless frame)
  uint8_t vals[256];
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[17]; // vals index of a length's first code minus that code
  uint16_t lookup[1 << 9];  // 9-bit prefix -> (length << 8) | value; 0 = longer
};

void build_huff(HuffTable& t, const uint8_t* counts, const uint8_t* symbols, int nsym) {
  t.defined = true;
  t.bad = false;
  t.max_sym = nsym ? *std::max_element(symbols, symbols + nsym) : 0;
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
    if (code >= (1 << si)) {
      t.bad = true;  // libjpeg fails when a scan derives it
      return;
    }
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
}

// ITU T.81 Annex K.3 (jstdhuff.c): code counts by length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// The file's bytes, then what libjpeg's stdio source supplies at every
// refill past the end: a fake EOI marker (FF D9).
struct Stream {
  const uint8_t* data;
  size_t size;
  int at(size_t p) const { return p < size ? data[p] : (((p - size) & 1) ? 0xD9 : 0xFF); }
};

// Entropy-coded bits, MSB first, with FF00 unstuffing, as jdhuff.c's bit
// reader: a marker stops the data (`marker`, libjpeg's unread_marker, its
// bytes consumed) and zero bits are supplied after it; reading one of those
// sets `insufficient` until a restart marker is read.
struct BitReader {
  const Stream* s;
  size_t pos;
  uint64_t acc = 0;
  int nbits = 0;  // valid bits in acc (real ones first, then zero padding)
  int nreal = 0;  // how many of them came from the stream
  int marker = 0;
  bool insufficient = false;

  void fill() {
    while (nbits <= 56) {
      int c = 0;
      bool real = false;
      if (!marker) {
        c = s->at(pos);
        if (c == 0xFF) {
          size_t q = pos + 1;
          int m;
          while ((m = s->at(q)) == 0xFF) q++;
          pos = q + 1;
          if (m == 0) {
            real = true;  // a stuffed FF data byte
          } else {
            marker = m;
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
    if (n > nreal) {
      insufficient = true;
      nreal = 0;
    } else {
      nreal -= n;
    }
    acc <<= n;
    nbits -= n;
  }
  int bits(int n) {  // n in 1..16
    if (nbits < n) fill();
    int v = static_cast<int>(acc >> (64 - n));
    consume(n);
    return v;
  }
  // jpeg_huff_decode: a code that is none of the table's reads as symbol 0
  // after 17 bits
  int decode(const HuffTable& t) {
    if (nbits < 17) fill();
    int e = t.lookup[acc >> (64 - 9)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int code = static_cast<int>(acc >> (64 - l));
    while (code > t.maxcode[l]) {
      l++;
      code = static_cast<int>(acc >> (64 - l));
    }
    consume(l);
    return l > 16 ? 0 : t.vals[(t.valoffset[l] + code) & 0xFF];
  }
  // jdmarker.c:next_marker from `pos`: skip to an FF that starts a marker
  void find_marker() {
    for (;;) {
      int c = s->at(pos++);
      while (c != 0xFF) c = s->at(pos++);
      do c = s->at(pos++); while (c == 0xFF);
      if (c != 0) {
        marker = c;
        return;
      }
    }
  }
  // process_restart + read_restart_marker + jpeg_resync_to_restart: drop the
  // buffered bits and take restart marker `expected`
  void restart(int expected) {
    acc = 0;
    nbits = nreal = 0;
    if (!marker) find_marker();
    if (marker != 0xD0 + expected) {
      for (;;) {
        int action;
        if (marker < 0xC0) action = 2;  // not a valid marker: scan on
        else if (marker < 0xD0 || marker > 0xD7) action = 3;  // leave it for the reader
        else if (marker == 0xD0 + ((expected + 1) & 7) || marker == 0xD0 + ((expected + 2) & 7))
          action = 3;  // one of the next two: this segment is empty
        else if (marker == 0xD0 + ((expected + 7) & 7) || marker == 0xD0 + ((expected + 6) & 7))
          action = 2;  // a prior restart: advance
        else
          action = 1;  // the desired one or too far away: take it
        if (action == 1) break;
        if (action == 3) return;  // the marker stays unread and the flag as it is
        marker = 0;
        find_marker();
      }
    }
    marker = 0;
    insufficient = false;
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
  std::vector<int16_t> coef;  // blocks_h x blocks_w blocks, natural order
  std::vector<uint8_t> plane;
  int32_t quant[64] = {0};  // latched at the component's first scan
  bool latched = false;
  int coef_bits[64];        // progressive: Al of the last scan coding each coefficient, -1 none
  int dc_pred = 0;
  int td = 0, ta = 0;
  int row0 = 0;              // the first block row held: 0, or the MCU row's (single scan)
  int16_t* block(int by, int bx) { return coef.data() + (size_t(by - row0) * blocks_w + bx) * 64; }
  // the IDCT of block rows [by0, by1), of the blocks holding real samples
  // (jdcoefct.c:decompress_data)
  void idct_rows(int by0, int by1) {
    for (int by = by0; by < std::min(by1, height_in_blocks); by++)
      for (int bx = 0; bx < width_in_blocks; bx++)
        idct_islow(block(by, bx), quant, plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
  }
};

enum ScanKind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };
// jdapimin.c:default_decompress_parms's jpeg_color_space; kUnknown for 2 or
// 5-10 components
enum Space { kUnknown, kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct Jpeg {
  Stream st;
  size_t pos = 0;
  int unread_marker = 0;  // a marker the last scan's data stopped at
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int precision = 8;
  bool gray = false;  // the output: grayscale needs the IDCT of component 0 alone
  bool have_frame = false, progressive = false, arith = false, lossless = false;
  bool jfif = false, adobe = false;
  bool multi_scan = false;
  Space space = kUnknown;
  // what libjpeg reads and this file does not reproduce, set at the first
  // scan: the scans are then walked for libjpeg's errors and not decoded
  std::string refusal;
  int scans = 0;
  int adobe_transform = -1;
  int restart_interval = 0;
  int orientation = 1;
  bool saw_app1 = false;
  bool quant_defined[4] = {false, false, false, false};
  uint16_t quant_tables[4][64];  // natural order
  HuffTable dc[4], ac[4];
  Component comp[4];

  Jpeg(const uint8_t* d, size_t n) : st{d, n} {}

  int u8() { return st.at(pos++); }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {  // jdmarker.c:next_marker
    BitReader br{&st, pos};
    br.find_marker();
    pos = br.pos;
    return br.marker;
  }

  void read_app1(size_t start, size_t len) {
    if (saw_app1) return;
    saw_app1 = true;
    // OpenCV hands the segment to its EXIF parser 6 bytes in ("Exif\0\0")
    if (len <= 6) return;
    std::vector<uint8_t> seg(len - 6);
    for (size_t i = 0; i < seg.size(); i++) seg[i] = uint8_t(st.at(start + 6 + i));
    orientation = exif_orientation(seg.data(), seg.size());
  }

  // SOF0-3, SOF9-11 (the hierarchical ones never reach here)
  void read_sof(int marker) {
    if (have_frame) throw Unreadable("more than one frame header");
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker >= 0xC9;
    lossless = marker == 0xC3 || marker == 0xCB;
    if (lossless && arith)
      throw Unreadable("lossless arithmetic-coded JPEG (libjpeg-turbo has no decoder for it)");
    int len = u16();
    precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    // jdinput.c:initial_setup allows 8 and 12 bits (2-16 lossless), and
    // OpenCV's jpeg_read_scanlines reads no more than 8
    if (lossless ? precision < 2 || precision > 8 : precision != 8)
      throw Unreadable(std::to_string(precision) + "-bit samples (OpenCV reads 8-bit ones)");
    if (height == 0 || width == 0 || ncomp == 0) throw Unreadable("empty image");
    if (ncomp > 10) throw Unreadable("too many components");
    if (len != 8 + 3 * ncomp) throw Unreadable("bad frame header length");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)  // JCS_UNKNOWN: jdcolor.c converts none
      throw Unreadable(std::to_string(ncomp) + " components (libjpeg converts no colour from them)");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Unreadable("bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    if (int64_t(width) * height > (int64_t(1) << 30)) throw Unreadable("image too large");
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
    int len = u16() - 2;
    while (len > 0) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw Unreadable("bad quantization table index");
      for (int k = 0; k < 64; k++) quant_tables[tq][kNatural[k]] = uint16_t(pq ? u16() : u8());
      quant_defined[tq] = true;
      len -= 1 + 64 * (pq ? 2 : 1);
    }
    if (len != 0) throw Unreadable("bad quantization table segment length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Unreadable("bad Huffman table class or index");
      uint8_t counts[16], symbols[256];
      int n = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = uint8_t(u8());
        n += counts[i];
      }
      len -= 17;
      if (n > 256 || n > len) throw Unreadable("corrupt Huffman table");
      for (int i = 0; i < n; i++) symbols[i] = uint8_t(u8());
      len -= n;
      build_huff(tc ? ac[th] : dc[th], counts, symbols, n);
    }
    if (len != 0) throw Unreadable("bad Huffman table segment length");
  }

  void read_app(int marker) {
    int len = u16() - 2;  // a length below 2 skips nothing, as libjpeg does
    size_t start = pos, n = len > 0 ? size_t(len) : 0;
    auto starts = [&](const char* s, size_t k) {
      for (size_t i = 0; i < k; i++)
        if (st.at(start + i) != uint8_t(s[i])) return false;
      return true;
    };
    if (marker == 0xE0 && n >= 14 && starts("JFIF\0", 5)) jfif = true;
    if (marker == 0xEE && n >= 12 && starts("Adobe", 5)) {
      adobe = true;
      adobe_transform = st.at(start + 11);
    }
    if (marker == 0xE1) read_app1(start, n);
    pos = start + n;
  }

  // At the first scan: jdapimin.c:default_decompress_parms's colour space,
  // jdhuff.c's standard tables for a sequential Huffman frame's tables 0
  // and 1 that no DHT defined (std_huff_tables), and what is refused.
  void frame_setup() {
    if (ncomp == 1) {
      space = kGray;
    } else if (ncomp == 3) {
      const bool ids_rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
      if (jfif) space = kYCbCr;
      else if (adobe) space = adobe_transform == 0 ? kRGB : kYCbCr;
      else space = ids_rgb || lossless ? kRGB : kYCbCr;
    } else if (ncomp == 4) {
      space = adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    }
    if (!progressive && !arith && !lossless) {
      const uint8_t* bits[2][2] = {{kDcLumaBits, kDcChromaBits}, {kAcLumaBits, kAcChromaBits}};
      const uint8_t* vals[2][2] = {{kDcVals, kDcVals}, {kAcLumaVals, kAcChromaVals}};
      for (int tc = 0; tc < 2; tc++)
        for (int th = 0; th < 2; th++) {
          HuffTable& t = tc ? ac[th] : dc[th];
          if (!t.defined)
            build_huff(t, bits[tc][th], vals[tc][th], tc ? 162 : 12);
        }
    }
    if (lossless) refusal = "lossless JPEG (only baseline, extended and progressive Huffman)";
    else if (arith) refusal = "arithmetic-coded JPEG (only Huffman coding)";
    else if (ncomp == 4) refusal = "4 components (CMYK/YCCK are not supported)";
    else if (space == kRGB) refusal = "RGB-coded colour components (only YCbCr)";
  }

  // After the last scan, for the output OpenCV asks for (BGR, or grayscale;
  // CMYK for 4 components in both): the errors of jdcolor.c and jdsample.c.
  void check_output(bool gray) const {
    // only Y is upsampled for grayscale output of YCbCr (component_needed)
    const int needed = gray && space == kYCbCr ? 1 : ncomp;
    for (int i = 0; i < needed; i++)
      if (hmax % comp[i].h || vmax % comp[i].v)
        throw Unreadable("non-integral sampling ratios (libjpeg's fractional upsampling)");
    const Space out = ncomp == 4 ? kCMYK : gray ? kGray : kRGB;
    if (lossless && space != out)  // no colour conversion in lossless mode
      throw Unreadable("a lossless JPEG whose colour space OpenCV's output would convert");
  }

  const HuffTable& table(const HuffTable* set, int i, bool is_dc) {
    if (i > 3 || !set[i].defined) throw Unreadable("scan uses an undefined Huffman table");
    const HuffTable& t = set[i];
    if (t.bad || (is_dc && t.max_sym > (lossless ? 16 : 15)))
      throw Unreadable("corrupt Huffman table");
    return t;
  }

  // One scan (jdmarker.c:get_sos, then jdinput.c's and the entropy
  // decoder's start of pass); `decode` false returns after its header.
  void read_sos(bool decode) {
    if (!have_frame) throw Unreadable("scan before the frame header");
    int len = u16();
    int ns = u8();
    if (len != 6 + 2 * ns || ns > 4 || ns == 0) throw Unreadable("bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int k = 0; k < ncomp && !c; k++)
        if (comp[k].id == id) c = &comp[k];
      if (!c) throw Unreadable("scan names an unknown component");
      for (int k = 0; k < i; k++)
        if (sc[k] == c) throw Unreadable("scan names a component twice");
      c->td = t >> 4;
      c->ta = t & 15;
      sc[i] = c;
    }
    const int Ss = u8(), Se = u8(), ahal = u8(), Ah = ahal >> 4, Al = ahal & 15;
    if (scans == 0) {
      frame_setup();
      multi_scan = progressive || ns < ncomp;
    } else if (!multi_scan) {
      throw Unreadable("a second scan in a single-scan file (EOI expected)");
    }
    scans++;
    if (!decode) return;

    if (ns > 1) {  // jdinput.c:per_scan_setup
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) throw Unreadable("an MCU of more than 10 blocks (D_MAX_BLOCKS_IN_MCU)");
    }
    ScanKind kind = kSequential;
    if (progressive) {
      bool bad = Ss == 0 ? Se != 0 : (Ss > Se || Se > 63 || ns != 1);
      if ((Ah != 0 && Al != Ah - 1) || Al > 13) bad = true;
      if (bad) throw Unreadable("bad progression parameters");
      kind = Ss == 0 ? (Ah == 0 ? kDcFirst : kDcRefine) : (Ah == 0 ? kAcFirst : kAcRefine);
    } else if (lossless) {  // jdlossls.c: a predictor, and a point transform
      if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= precision)
        throw Unreadable("bad lossless scan parameters");
      for (int i = 0; i < ns; i++) table(dc, sc[i]->td, true);
    }
    if (!arith && !lossless)
      for (int i = 0; i < ns; i++) {
        Component* c = sc[i];
        if (kind == kSequential || kind == kDcFirst) table(dc, c->td, true);
        if (kind == kSequential || kind == kAcFirst || kind == kAcRefine) table(ac, c->ta, false);
      }
    for (int i = 0; i < ns && !lossless; i++) {  // jdinput.c:latch_quant_tables
      Component* c = sc[i];
      if (c->latched) continue;
      if (c->tq > 3 || !quant_defined[c->tq])
        throw Unreadable("scan uses an undefined quantization table");
      for (int k = 0; k < 64; k++) c->quant[k] = quant_tables[c->tq][k];
      c->latched = true;
    }
    if (!refusal.empty()) {  // not decoded: on to the next marker
      BitReader br{&st, pos};
      br.find_marker();
      pos = br.pos;
      unread_marker = br.marker;
      return;
    }
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      if (c->coef.empty()) {
        const int rows = multi_scan ? c->blocks_h : ns == 1 ? 1 : c->v;  // held
        c->coef.assign(size_t(c->blocks_w) * rows * 64, 0);
        c->plane.assign(size_t(c->stride) * c->blocks_h * 8, 128);
      }
      if (progressive)
        for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
      c->dc_pred = 0;
    }
    decode_scan(sc, ns, kind, Ss, Se, Al);
  }

  void decode_scan(Component** sc, int ns, ScanKind kind, int Ss, int Se, int Al) {
    BitReader br{&st, pos};
    unsigned eobrun = 0;
    const int p1 = 1 << Al, m1 = -(1 << Al);
    const int dc_shift = kind == kDcFirst ? Al : 0;  // a sequential scan's Al is not read
    auto correct = [&](int16_t* co) {  // an AC refine correction bit
      if (br.bits(1) && (*co & p1) == 0) *co = int16_t(*co >= 0 ? *co + p1 : *co + m1);
    };
    auto decode_block = [&](Component* c, int16_t* blk) {
      switch (kind) {
        case kSequential:
        case kDcFirst: {
          int s = br.decode(dc[c->td]);
          if (s) s = extend(br.bits(s), s);
          const int64_t dc_sum = int64_t(c->dc_pred) + s;
          if (dc_sum > INT32_MAX || dc_sum < INT32_MIN) throw Unreadable("DC coefficient overflow");
          c->dc_pred = int(dc_sum);
          blk[0] = int16_t(uint32_t(c->dc_pred) << dc_shift);
          if (kind == kDcFirst) return;
          const HuffTable& act = ac[c->ta];
          for (int k = 1; k < 64; k++) {
            int rs = br.decode(act);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = int16_t(extend(br.bits(s), s));
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
          return;
        }
        case kDcRefine:
          if (br.bits(1)) blk[0] = int16_t(blk[0] | p1);
          return;
        case kAcFirst: {
          if (eobrun > 0) {
            eobrun--;
            return;
          }
          const HuffTable& act = ac[c->ta];
          for (int k = Ss; k <= Se; k++) {
            int rs = br.decode(act);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = int16_t(uint32_t(extend(br.bits(s), s)) << Al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1u << r;
              if (r) eobrun += br.bits(r);
              eobrun--;
              break;
            }
          }
          return;
        }
        case kAcRefine: {
          const HuffTable& act = ac[c->ta];
          int k = Ss;
          if (eobrun == 0) {
            for (; k <= Se; k++) {
              int rs = br.decode(act);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                s = br.bits(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1u << r;
                if (r) eobrun += br.bits(r);
                break;
              }
              do {  // already non-zero coefficients get a correction bit
                int16_t* co = blk + kNatural[k];
                if (*co != 0) {
                  correct(co);
                } else if (--r < 0) {
                  break;
                }
                k++;
              } while (k <= Se);
              if (s) blk[kNatural[k]] = int16_t(s);
            }
          }
          if (eobrun > 0) {
            for (; k <= Se; k++) {
              int16_t* co = blk + kNatural[k];
              if (*co != 0) correct(co);
            }
            eobrun--;
          }
          return;
        }
      }
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
        eobrun = 0;
      }
      int my = int(m / mcus_per_row), mx = int(m % mcus_per_row);
      // out of data: the rest of the interval stays as it is (a DC refine
      // scan would read zero bits, which change nothing)
      if (!br.insufficient && ns == 1) {
        decode_block(sc[0], sc[0]->block(my, mx));
      } else if (!br.insufficient) {
        for (int i = 0; i < ns; i++) {
          Component* c = sc[i];
          for (int y = 0; y < c->v; y++)
            for (int x = 0; x < c->h; x++)
              decode_block(c, c->block(my * c->v + y, mx * c->h + x));
        }
      }
      // a single-scan file: the IDCT of each MCU row once it is decoded,
      // while its blocks are in cache (jdcoefct.c:decompress_onepass)
      if (!multi_scan && mx == mcus_per_row - 1)
        for (int i = 0; i < ns; i++) {
          Component* c = sc[i];
          const int rows = ns == 1 ? 1 : c->v;
          if (!gray || c == &comp[0]) c->idct_rows(my * rows, (my + 1) * rows);
          std::fill(c->coef.begin(), c->coef.end(), 0);  // the next MCU row's blocks
          c->row0 = (my + 1) * rows;
        }
    }
    pos = br.pos;
    unread_marker = br.marker;
  }

  // jdcoefct.c:smoothing_ok: libjpeg block-smooths this progressive image
  bool would_smooth() const {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k <= 9; k++)  // Q00..Q30, the first ten in zigzag order
        if (c.quant[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k <= 9; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdmarker.c:read_markers up to EOI (the stream supplies one past the
  // end of the file); `decode` false returns after the first scan header.
  void run(bool decode) {
    if (st.at(0) != 0xFF || st.at(1) != 0xD8) throw Unreadable("not a JPEG file");
    pos = 2;
    while (true) {
      int m = unread_marker ? unread_marker : next_marker();
      unread_marker = 0;
      if (m == 0xD9) {
        if (scans == 0) throw Unreadable("no image before EOI (the file ends before a scan)");
        return;
      }
      if ((m >= 0xC0 && m <= 0xC3) || (m >= 0xC9 && m <= 0xCB)) {
        read_sof(m);
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xC8 || m == 0xCD || m == 0xCE ||
                 m == 0xCF) {
        throw Unreadable("hierarchical JPEG (libjpeg reads no differential frame)");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) throw Unreadable("bad restart interval segment length");
        restart_interval = u16();
      } else if (m == 0xDA) {
        read_sos(decode);
        // a single-scan file is output from its scan: OpenCV has its image
        // before libjpeg reads on to EOI
        if (!decode || !multi_scan) return;
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        // parameterless
      } else if (m == 0xD8) {
        throw Unreadable("second SOI marker");
      } else if (m == 0xFE || m == 0xCC || m == 0xDC) {  // COM, DAC, DNL
        int len = u16() - 2;
        if (len > 0) pos += len;
      } else {
        throw Unreadable("unknown JPEG marker");
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
  j.gray = gray;
  j.run(true);
  j.check_output(gray);
  if (!j.refusal.empty()) throw Refused(j.refusal);
  if (j.would_smooth())
    throw Refused("incomplete progressive JPEG (libjpeg's block smoothing is not reproduced)");
  const int W = j.width, H = j.height;
  // a multi-scan file's IDCT, after its last scan; a component no scan coded
  // is all zero coefficients: 128
  for (int i = 0; i < (gray ? 1 : j.ncomp) && j.multi_scan; i++) {
    Component& c = j.comp[i];
    if (c.coef.empty()) c.plane.assign(size_t(c.stride) * c.blocks_h * 8, 128);
    else c.idct_rows(0, c.height_in_blocks);
  }
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

// Adam7: first column, first row, column step, row step of each pass
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

void png_unfilter(const uint8_t* raw, size_t n, int width, int height, int depth,
                  int color_type, int interlace, const uint8_t* palette, int npal, bool gray,
                  uint8_t* out) {
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: throw Unreadable("unknown PNG colour type");
  }
  const int pixel_bits = channels * depth;
  const int bpp = std::max(1, pixel_bits / 8);  // filter byte distance
  const int gray_scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;
  const bool colour = color_type == 2 || color_type == 6;
  palette = palette ? palette : reinterpret_cast<const uint8_t*>("");
  auto sample = [&](const uint8_t* row, int x, int ch) {
    if (depth == 8) return int(row[size_t(x) * channels + ch]);
    if (depth == 16) {
      const uint8_t* q = row + (size_t(x) * channels + ch) * 2;
      return (q[0] << 8) | q[1];
    }
    size_t bit = size_t(x) * depth;  // one channel, packed from the MSB
    return (row[bit >> 3] >> (8 - depth - int(bit & 7))) & ((1 << depth) - 1);
  };
  size_t off = 0;
  std::vector<uint8_t> prev, cur;
  for (int p = 0; p < (interlace ? 7 : 1); p++) {
    const int x0 = interlace ? kAdam7[p][0] : 0, y0 = interlace ? kAdam7[p][1] : 0;
    const int dx = interlace ? kAdam7[p][2] : 1, dy = interlace ? kAdam7[p][3] : 1;
    const int pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
    const int ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no scanlines
    const size_t row_bytes = (size_t(pw) * pixel_bits + 7) / 8;
    if (n < off || (n - off) / (row_bytes + 1) < size_t(ph))
      throw Unreadable("not enough image data");
    prev.assign(row_bytes, 0);  // each pass is filtered on its own
    cur.assign(row_bytes, 0);
    for (int py = 0; py < ph; py++, off += row_bytes + 1) {
      const uint8_t* src = raw + off;
      const int filter = src[0];
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
          default: throw Unreadable("bad PNG filter type " + std::to_string(filter));
        }
        cur[i] = uint8_t(src[i] + pred);
      }
      const size_t y = size_t(y0) + size_t(py) * dy;
      for (int px = 0; px < pw; px++) {
        const size_t o = y * width + x0 + size_t(px) * dx;
        int r, g, b;
        if (color_type == 3) {
          int v = sample(cur.data(), px, 0);
          if (v < npal) {
            r = palette[3 * v]; g = palette[3 * v + 1]; b = palette[3 * v + 2];
          } else {
            r = g = b = 0;
          }
        } else if (!colour) {
          r = g = b = sample(cur.data(), px, 0) * gray_scale;
        } else {
          r = sample(cur.data(), px, 0);
          g = sample(cur.data(), px, 1);
          b = sample(cur.data(), px, 2);
        }
        if (depth == 16) {  // rgb_to_gray at 16 bits, then png_set_strip_16
          if (gray) {
            out[o] = uint8_t((colour ? (9797 * r + 19234 * g + 3737 * b + 16384) >> 15 : r) >> 8);
          } else {
            out[3 * o] = uint8_t(b >> 8);
            out[3 * o + 1] = uint8_t(g >> 8);
            out[3 * o + 2] = uint8_t(r >> 8);
          }
        } else if (gray) {
          out[o] = rgb_to_gray(r, g, b);
        } else {
          out[3 * o] = uint8_t(b);
          out[3 * o + 1] = uint8_t(g);
          out[3 * o + 2] = uint8_t(r);
        }
      }
      std::swap(prev, cur);
    }
  }
}

// 1 where imread gives None, -1 where it reads what this file does not
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

// info: height, width, components, EXIF orientation (1 when absent)
int fots_jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j(data, size_t(n));
    j.run(false);
    info[0] = j.height;
    info[1] = j.width;
    info[2] = j.ncomp;
    info[3] = j.orientation;
  });
}

// out: height * width * 3 bytes (BGR) or height * width (gray)
int fots_jpeg_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, char* err,
                     int errlen) {
  return guarded(err, errlen, [&] { jpeg_decode(data, size_t(n), gray != 0, out); });
}

// raw: the inflated IDAT stream (Adam7 passes in order when `interlace`);
// palette: npal RGB triplets
int fots_png_unfilter(const uint8_t* raw, int64_t n, int width, int height, int depth,
                      int color_type, int interlace, const uint8_t* palette, int npal, int gray,
                      uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    png_unfilter(raw, size_t(n), width, height, depth, color_type, interlace, palette, npal,
                 gray != 0, out);
  });
}

// The orientation tag of a TIFF-structured EXIF block (a PNG's eXIf chunk)
int fots_exif_orientation(const uint8_t* data, int64_t n) {
  return exif_orientation(data, size_t(n));
}

}  // extern "C"
