// Host image decoding for the port's file entry points: JPEG, and the
// scanlines of PNG, with the results of OpenCV's imread.
//
// JPEG.  Reproduces libjpeg-turbo's default decompression as OpenCV's JPEG
// reader asks for it (output BGR, grayscale, or CMYK for 4 components;
// islow IDCT, fancy upsampling), so the bytes equal cv2.imread's:
//   - sequential (SOF0, SOF1, SOF9), progressive (SOF2, SOF10) and lossless
//     (SOF3) frames, Huffman or arithmetic coding, 8-bit samples (2-8 in a
//     lossless frame), 1, 3 or 4 components, integral sampling ratios (for
//     grayscale output of YCbCr, Y's alone: the chroma is not upsampled),
//     restart intervals, and a sequential Huffman frame's tables 0 and 1
//     taken from Annex K where no DHT defines them (jdhuff.c:std_huff_tables).
//     Scans are read into one int16 coefficient plane per component: a file
//     of several scans (progressive, or one scan per component) keeps the
//     whole image (libjpeg's whole-image buffer) and runs the IDCT, the
//     upsampling and the colour conversion once, after EOI; a single-scan
//     file keeps one MCU row and runs its IDCT as each row is decoded
//     (jdcoefct.c:decompress_onepass).  Progressive scans decode as jdphuff.c
//     does (DC first with its Al shift, DC refine, AC first with EOB runs, AC
//     refine with correction bits); each component's quantization table is
//     latched at its first scan (jdinput.c:latch_quant_tables);
//   - arithmetic coding as jdarith.c decodes it: the QM coder with T.81's Qe
//     table (jaricom.c), DC statistics conditioned by DAC's L and U, AC by
//     Kx, the statistics and predictions reset at each restart, a marker in
//     the data read as zero bytes, an overflowing magnitude or run ending the
//     scan's data (the rest of it stays zero);
//   - lossless frames as jdlhuff.c, jddiffct.c and jdlossls.c read them:
//     Huffman-coded differences (category 16 is 32768), predictors 1-7 with
//     the first row of the scan and of each restart interval from 1 << (P -
//     Pt - 1), the point transform, samples wrapped to 16 bits and cut to 8;
//     restart intervals of whole MCU rows only; one-sample blocks are
//     upsampled by replication, and no colour space is converted but RGB to
//     BGR (CMYK stays CMYK for OpenCV);
//   - block smoothing of a progressive image whose coefficients 1-9 are not
//     all known exactly (jdcoefct.c:smoothing_ok and decompress_smooth_data
//     of libjpeg-turbo 2.1 and later): each zero coefficient still inexact is
//     estimated from the DC values of the 5x5 blocks around its block, and
//     where no AC scan has run the DC too (a Gaussian-like kernel); iMCU rows
//     past the last one an MCU began with data in take the coefficient state
//     from before their component's last scan (the latched prev_coef_bits);
//   - a stream that ends early, as jdhuff.c reads it through the stdio
//     source: past the end of the file the source supplies fake EOI markers,
//     the bits of the MCU where the data ended are padded with zeros (a
//     padded code that is no Huffman code gives symbol 0 after 17 bits), and
//     every later MCU of the restart interval is left as it is (all zero in a
//     sequential file: 128 after the level shift).  Restart markers are
//     resynchronised as jdmarker.c:jpeg_resync_to_restart does;
//   - the accurate integer IDCT as libjpeg-turbo's SIMD code computes it
//     (jidctint-avx2.asm): jidctint.c's constants and descaling with 16-bit
//     dequantization and sums that wrap and outputs that saturate, equal to
//     jidctint.c wherever nothing overflows, as in every well-formed file;
//   - the upsamplers of jdsample.c: h2v1 and h2v2 "fancy" (triangle filter
//     with alternating rounding bias; context rows clamped to the component's
//     real rows), h1v2 fancy, box replication for every other integral ratio,
//     for h2v1/h2v2 components at most 2 samples wide and in lossless frames;
//   - jdcolor.c's YCbCr->RGB tables (16-bit fixed point, ONE_HALF rounding),
//     RGB passed through (rgb_rgb_convert) or to grey by rgb_gray_convert's
//     tables, YCCK->CMYK (ycck_cmyk_convert), and for 4 components OpenCV's
//     CMYK->BGR and CMYK->grey (icvCvt_CMYK2BGR_8u_C4C3R / ..Gray..);
//   - grayscale output of a YCbCr file: the Y component alone, as
//     JCS_GRAYSCALE output does; colour output of a grayscale file: Y copied
//     into three channels;
//   - the orientation tag of the first APP1 segment before the first scan is
//     reported (the caller applies it as imread does).
// What libjpeg or OpenCV's use of it fails on is Unreadable (imread gives
// None): a file cut before its first scan's data, corrupt headers, unknown
// markers, hierarchical frames, 2 or 5-10 components (no colour conversion),
// samples of other than 8 bits (OpenCV reads scanlines of 8), an MCU of more
// than 10 blocks, non-integral sampling of a component the output needs, an
// undefined Huffman table other than a sequential frame's 0 and 1, a
// lossless frame that is arithmetic-coded, whose colour space the output
// would convert, whose restart interval is not whole MCU rows, or of several
// scans with a component none of them wrote (cut before its scan).
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
// same sum rounded (+16384), before the strip; where the file's gAMA or sRGB
// gamma is significant, the rounded sum in linear light through the caller's
// gamma tables (png_do_rgb_to_gray: gamma_to_1, gamma_from_1, and for grey
// pixels gamma_table; at 16 bits their 16-bit versions indexed by the top
// 16 - shift bits).
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.  Every entry point returns 0, 1 with a
// message in `err` where imread gives None, or -1 with a message for any
// other failure (such as memory).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

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

// ---------------------------------------------------------------- arithmetic

// ITU T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
// (T.851) of sign and refinement bits
#define V(qe, nlps, nmps, sw) ((int32_t(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int32_t kAriTab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// jdarith.c's decoder state over the same byte source as BitReader (its
// `pos` and `marker`; a marker in the data supplies zero bytes from there
// on, which is legal in arithmetic coding)
struct ArithReader {
  BitReader* br;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read into C; -1: an error ended the scan's data
  uint8_t fixed_bin = 113;

  int byte() {
    if (br->marker) return 0;
    int d = br->s->at(br->pos++);
    if (d == 0xFF) {
      do d = br->s->at(br->pos++); while (d == 0xFF);
      if (d == 0) return 0xFF;
      br->marker = d;
      return 0;
    }
    return d;
  }
  // arith_decode: one binary decision with statistics bin *st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void reset() {
    c = a = 0;
    ct = -16;
  }
};

// ---------------------------------------------------------------- IDCT

// libjpeg-turbo's accurate integer IDCT as its SIMD code computes it
// (jidctint-avx2.asm and -sse2.asm, which OpenCV's build runs): jidctint.c's
// 13-bit constants and descaling, but the dequantized coefficients, the sums
// in0 + in4, in0 - in4, in7 + in3 and in5 + in1 are 16-bit and wrap, the
// products are pmaddwd pairs summed in 32 bits, each pass's outputs saturate
// to 16 bits, and the samples saturate to 8 bits around 128.  When no row of
// coefficients 1-7 holds a non-zero value, pass 1 is the DC shortcut (16-bit
// dequantization shifted left by 2).  Equal to jidctint.c wherever nothing
// overflows, as in every well-formed file.
inline int32_t w16(int32_t v) { return int16_t(uint16_t(uint32_t(v))); }
inline int32_t add32(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t sub32(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }
inline int16_t sat16(int32_t v) { return int16_t(std::min(32767, std::max(-32768, v))); }

// one pass over in[0], in[step], ..., in[7 * step] into out[0..7], descaled by `shift`
inline void idct_pass(const int16_t* in, int step, int shift, int16_t* out) {
  const int32_t i0 = in[0], i1 = in[step], i2 = in[2 * step], i3 = in[3 * step],
                i4 = in[4 * step], i5 = in[5 * step], i6 = in[6 * step], i7 = in[7 * step];
  const int32_t tmp3e = i2 * 10703 + i6 * 4433;    // z2 (0.541 + 0.765), z3 0.541
  const int32_t tmp2e = i2 * 4433 + i6 * -10704;   // z2 0.541, z3 (0.541 - 1.848)
  const int32_t tmp0e = w16(i0 + i4) * 8192, tmp1e = w16(i0 - i4) * 8192;
  const int32_t tmp10 = add32(tmp0e, tmp3e), tmp13 = sub32(tmp0e, tmp3e);
  const int32_t tmp11 = add32(tmp1e, tmp2e), tmp12 = sub32(tmp1e, tmp2e);
  const int32_t z3 = w16(i7 + i3), z4 = w16(i5 + i1);
  const int32_t z3p = z3 * -6436 + z4 * 9633, z4p = z3 * 9633 + z4 * 6437;
  const int32_t tmp0 = add32(i7 * -4927 + i1 * -7373, z3p);
  const int32_t tmp1 = add32(i5 * -4176 + i3 * -20995, z4p);
  const int32_t tmp3 = add32(i7 * -7373 + i1 * 4926, z4p);
  const int32_t tmp2 = add32(i5 * -20995 + i3 * 4177, z3p);
  const int32_t round = 1 << (shift - 1);
  auto d = [&](int32_t v) { return sat16(add32(v, round) >> shift); };
  out[0] = d(add32(tmp10, tmp3));
  out[7] = d(sub32(tmp10, tmp3));
  out[1] = d(add32(tmp11, tmp2));
  out[6] = d(sub32(tmp11, tmp2));
  out[2] = d(add32(tmp12, tmp1));
  out[5] = d(sub32(tmp12, tmp1));
  out[3] = d(add32(tmp13, tmp0));
  out[4] = d(sub32(tmp13, tmp0));
}

void idct_islow(const int16_t* coef, const int32_t* quant, uint8_t* out, int stride) {
  int16_t in[64], ws[64], row[8];
  bool ac_rows = false;
  for (int k = 0; k < 64; k++) {
    in[k] = int16_t(w16(coef[k] * quant[k]));  // pmullw
    ac_rows = ac_rows || (k >= 8 && coef[k] != 0);
  }
  if (!ac_rows) {  // pass 1's shortcut: each column its DC << PASS1_BITS
    for (int c = 0; c < 8; c++)
      for (int r = 0; r < 8; r++) ws[8 * r + c] = int16_t(w16(in[c] * 4));
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t col[8];
      idct_pass(in + c, 8, 11, col);  // CONST_BITS - PASS1_BITS
      for (int r = 0; r < 8; r++) ws[8 * r + c] = col[r];
    }
  }
  for (int r = 0; r < 8; r++) {
    idct_pass(ws + 8 * r, 1, 18, row);  // CONST_BITS + PASS1_BITS + 3
    for (int c = 0; c < 8; c++)
      out[r * stride + c] = uint8_t(std::min(127, std::max(-128, int(row[c]))) + 128);
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
  int blocks_w, blocks_h;   // blocks of the plane (the MCU grid's share); lossless: samples
  int width_in_blocks, height_in_blocks;  // blocks holding real samples
  int ds_w, ds_h;           // real samples
  int stride;               // plane row bytes
  std::vector<int16_t> coef;  // blocks_h x blocks_w blocks, natural order
  std::vector<uint8_t> plane;
  int32_t quant[64] = {0};  // latched at the component's first scan
  bool latched = false;
  // progressive: Al of the last scan coding each coefficient (-1 none), and
  // the same before the component's last scan (jdphuff.c's coef_bits and
  // the second half of it that libjpeg-turbo keeps since 2.1)
  int coef_bits[64];
  int prev_bits[64];
  int dc_pred = 0;
  int dc_context = 0;       // arithmetic coding's DC conditioning (Table F.4)
  int td = 0, ta = 0;
  int row0 = 0;              // the first block row held: 0, or the MCU row's (single scan)
  // lossless: each sample's difference and undifferenced value
  std::vector<int32_t> diff, undiff;
  bool first_row = true;     // the next row undifferences as a first row
  int16_t* block(int by, int bx) { return coef.data() + (size_t(by - row0) * blocks_w + bx) * 64; }
  // the IDCT of block rows [by0, by1), of the blocks holding real samples
  // (jdcoefct.c:decompress_data)
  void idct_rows(int by0, int by1) {
    for (int by = by0; by < std::min(by1, height_in_blocks); by++)
      for (int bx = 0; bx < width_in_blocks; bx++)
        idct_islow(block(by, bx), quant, plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
  }
  // the rows of the last iMCU row that hold real samples (last_row_height)
  int last_row_height() const { return height_in_blocks % v ? height_in_blocks % v : v; }
};

enum ScanKind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };
// jdapimin.c:default_decompress_parms's jpeg_color_space; kUnknown for 2 or
// 5-10 components
enum Space { kUnknown, kGray, kYCbCr, kRGB, kCMYK, kYCCK };

// A coefficient estimate of jdcoefct.c:decompress_smooth_data, at most
// (1 << al) - 1 in magnitude where al > 0
inline int16_t smooth_estimate(int64_t num, int64_t q, int al) {
  int pred = int(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return int16_t(num >= 0 ? pred : -pred);
}

struct Jpeg {
  Stream st;
  size_t pos = 0;
  int unread_marker = 0;  // a marker the last scan's data stopped at
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int du = 8;  // samples a block is wide and high: 8, or 1 in a lossless frame
  int precision = 8;
  bool gray = false;  // the output: grayscale needs the IDCT of component 0 alone
  bool have_frame = false, progressive = false, arith = false, lossless = false;
  bool jfif = false, adobe = false;
  bool multi_scan = false;
  Space space = kUnknown;
  int scans = 0;
  int adobe_transform = -1;
  int restart_interval = 0;
  int orientation = 1;
  bool saw_app1 = false;
  // jdcoefct.c:consume_data's last_good_iMCU_row: the iMCU row of the last
  // MCU that began with data left in its scan
  int last_good = 0;
  bool quant_defined[4] = {false, false, false, false};
  uint16_t quant_tables[4][64];  // natural order
  HuffTable dc[4], ac[4];
  // arithmetic conditioning (DAC; defaults L 0, U 1, Kx 5) and statistics
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  Component comp[4];

  Jpeg(const uint8_t* d, size_t n) : st{d, n} {
    std::fill(dac_l, dac_l + 16, 0);
    std::fill(dac_u, dac_u + 16, 1);
    std::fill(dac_k, dac_k + 16, 5);
  }

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

  // the output needs component i (grayscale output of YCbCr: Y alone)
  bool needed(int i) const { return !(gray && space == kYCbCr && i > 0); }

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
    du = lossless ? 1 : 8;
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
      std::fill(c.prev_bits, c.prev_bits + 64, -1);
    }
    if (int64_t(width) * height > (int64_t(1) << 30)) throw Unreadable("image too large");
    mcux = (width + du * hmax - 1) / (du * hmax);
    mcuy = (height + du * vmax - 1) / (du * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.blocks_w = mcux * c.h;
      c.blocks_h = mcuy * c.v;
      c.width_in_blocks = int((int64_t(width) * c.h + du * hmax - 1) / (du * hmax));
      c.height_in_blocks = int((int64_t(height) * c.v + du * vmax - 1) / (du * vmax));
      c.ds_w = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.ds_h = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.stride = c.blocks_w * du;
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

  void read_dac() {  // jdmarker.c:get_dac
    int len = u16() - 2;
    while (len > 0) {
      int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) throw Unreadable("bad arithmetic conditioning table index");
      if (index >= 16) {
        dac_k[index - 16] = uint8_t(val);
      } else {
        dac_l[index] = uint8_t(val & 15);
        dac_u[index] = uint8_t(val >> 4);
        if (dac_l[index] > dac_u[index]) throw Unreadable("bad arithmetic conditioning value");
      }
    }
    if (len != 0) throw Unreadable("bad arithmetic conditioning segment length");
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

  // At the first scan: jdapimin.c:default_decompress_parms's colour space
  // and jdhuff.c's standard tables for a sequential Huffman frame's tables 0
  // and 1 that no DHT defined (std_huff_tables).
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
  }

  // After the last scan, for the output OpenCV asks for (BGR, or grayscale;
  // CMYK for 4 components in both): the errors of jdcolor.c and jdsample.c.
  void check_output() const {
    for (int i = 0; i < ncomp; i++)
      if (needed(i) && (hmax % comp[i].h || vmax % comp[i].v))
        throw Unreadable("non-integral sampling ratios (libjpeg's fractional upsampling)");
    // no colour conversion in lossless mode, apart from RGB -> BGR
    const Space out = ncomp == 4 ? kCMYK : gray ? kGray : kRGB;
    if (lossless && space != out)
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
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      if (lossless && c->plane.empty()) {
        const size_t n = size_t(c->blocks_w) * c->blocks_h;
        c->diff.assign(n, 0);
        c->undiff.assign(n, 0);
        c->plane.assign(n, 0);
      } else if (!lossless && c->coef.empty()) {
        const int rows = multi_scan ? c->blocks_h : ns == 1 ? 1 : c->v;  // held
        c->coef.assign(size_t(c->blocks_w) * rows * 64, 0);
        c->plane.assign(size_t(c->stride) * c->blocks_h * 8, 128);
      }
      if (progressive) {  // jdphuff.c / jdarith.c start_pass
        for (int k = std::min(Ss, 1); k <= std::max(Se, 9); k++)
          c->prev_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
        for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
      }
      c->dc_pred = 0;
      c->dc_context = 0;
    }
    if (lossless) decode_lossless(sc, ns, Ss, Al);
    else decode_scan(sc, ns, kind, Ss, Se, Ah, Al);
  }

  // the iMCU row of MCU m of a scan of ns components
  int imcu_row(int64_t m, int mcus_per_row, Component** sc, int ns) const {
    const int row = int(m / mcus_per_row);
    return ns == 1 ? row / sc[0]->v : row;
  }

  // jdarith.c's statistics of the scan's tables, at its start and at each
  // restart (process_restart), with the DC predictions and contexts
  void reset_arith(Component** sc, int ns, int Ss, int Ah) {
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[c->td], 0, sizeof(dc_stats[0]));
        c->dc_pred = 0;
        c->dc_context = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[c->ta], 0, sizeof(ac_stats[0]));
    }
  }

  void decode_scan(Component** sc, int ns, ScanKind kind, int Ss, int Se, int Ah, int Al) {
    BitReader br{&st, pos};
    ArithReader ar{&br};
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
    // jdarith.c: Figures F.19-F.24, a DC difference (false: the magnitude
    // overflowed and the scan's data is over)
    auto arith_dc = [&](Component* c, int* v_out) {
      uint8_t* const base = dc_stats[c->td];
      uint8_t* s = base + c->dc_context;
      *v_out = 0;
      if (ar.decode(s) == 0) {
        c->dc_context = 0;
        return true;
      }
      const int sign = ar.decode(s + 1);
      s += 2 + sign;
      int m = ar.decode(s);
      if (m != 0) {
        s = base + 20;
        while (ar.decode(s)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          s++;
        }
      }
      if (m < ((1 << dac_l[c->td]) >> 1)) c->dc_context = 0;
      else if (m > ((1 << dac_u[c->td]) >> 1)) c->dc_context = 12 + sign * 4;
      else c->dc_context = 4 + sign * 4;
      int v = m;
      s += 14;
      while (m >>= 1)
        if (ar.decode(s)) v |= m;
      v += 1;
      *v_out = sign ? -v : v;
      return true;
    };
    // Figure F.20: the AC coefficients k0..k1, shifted left by `shift` (false:
    // the scan's data is over)
    auto arith_ac = [&](Component* c, int16_t* blk, int k0, int k1, int shift) {
      uint8_t* const base = ac_stats[c->ta];
      for (int k = k0; k <= k1; k++) {
        uint8_t* s = base + 3 * (k - 1);
        if (ar.decode(s)) break;  // EOB
        while (ar.decode(s + 1) == 0) {
          s += 3;
          if (++k > k1) {
            ar.ct = -1;  // spectral overflow
            return false;
          }
        }
        const int sign = ar.decode(&ar.fixed_bin);
        s += 2;
        int m = ar.decode(s);
        if (m != 0 && ar.decode(s)) {
          m <<= 1;
          s = base + (k <= dac_k[c->ta] ? 189 : 217);
          while (ar.decode(s)) {
            if ((m <<= 1) == 0x8000) {
              ar.ct = -1;  // magnitude overflow
              return false;
            }
            s++;
          }
        }
        int v = m;
        s += 14;
        while (m >>= 1)
          if (ar.decode(s)) v |= m;
        v += 1;
        blk[kNatural[k]] = int16_t(uint32_t(sign ? -v : v) << shift);
      }
      return true;
    };
    auto arith_block = [&](Component* c, int16_t* blk) {
      if (kind == kDcRefine) {  // no error check: jdarith.c decodes on
        if (ar.decode(&ar.fixed_bin)) blk[0] = int16_t(blk[0] | p1);
        return true;
      }
      if (ar.ct == -1) return false;
      if (kind == kSequential || kind == kDcFirst) {
        int v;
        if (!arith_dc(c, &v)) return false;
        if (kind == kSequential) {
          c->dc_pred = (c->dc_pred + v) & 0xFFFF;
          blk[0] = int16_t(c->dc_pred);
          return arith_ac(c, blk, 1, 63, 0);  // a sequential scan's Al is not read
        }
        c->dc_pred = (c->dc_pred + v) & 0xFFFF;
        blk[0] = int16_t(uint32_t(c->dc_pred) << Al);
        return true;
      }
      if (kind == kAcFirst) return arith_ac(c, blk, Ss, Se, Al);
      // kAcRefine: after the previous stage's last non-zero coefficient an
      // EOB decision comes first
      uint8_t* const base = ac_stats[c->ta];
      int kex = Se;
      for (; kex > 0; kex--)
        if (blk[kNatural[kex]]) break;
      for (int k = Ss; k <= Se; k++) {
        uint8_t* s = base + 3 * (k - 1);
        if (k > kex && ar.decode(s)) break;
        for (;;) {
          int16_t* co = blk + kNatural[k];
          if (*co) {
            if (ar.decode(s + 2)) *co = int16_t(*co < 0 ? *co + m1 : *co + p1);
            break;
          }
          if (ar.decode(s + 1)) {
            *co = int16_t(ar.decode(&ar.fixed_bin) ? m1 : p1);
            break;
          }
          s += 3;
          if (++k > Se) {
            ar.ct = -1;
            return false;
          }
        }
      }
      return true;
    };
    if (arith) reset_arith(sc, ns, Ss, Ah);
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
      if (!br.insufficient) last_good = imcu_row(m, mcus_per_row, sc, ns);
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
        eobrun = 0;
        if (arith) {
          reset_arith(sc, ns, Ss, Ah);
          ar.reset();
        }
      }
      int my = int(m / mcus_per_row), mx = int(m % mcus_per_row);
      // out of data: the rest of the interval stays as it is (a DC refine
      // scan would read zero bits, which change nothing)
      if (arith) {
        bool ok = true;
        for (int i = 0; i < ns && ok; i++) {
          Component* c = sc[i];
          const int bv = ns == 1 ? 1 : c->v, bh = ns == 1 ? 1 : c->h;
          for (int y = 0; y < bv && ok; y++)
            for (int x = 0; x < bh && ok; x++)
              ok = arith_block(c, ns == 1 ? c->block(my, mx)
                                          : c->block(my * c->v + y, mx * c->h + x));
        }
      } else if (!br.insufficient && ns == 1) {
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
          if (needed(int(c - comp))) c->idct_rows(my * rows, (my + 1) * rows);
          std::fill(c->coef.begin(), c->coef.end(), 0);  // the next MCU row's blocks
          c->row0 = (my + 1) * rows;
        }
    }
    pos = br.pos;
    unread_marker = br.marker;
  }

  // A lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): Huffman-coded
  // sample differences, undifferenced with predictor `psv` row by row after
  // each iMCU row and shifted left by the point transform `pt`.  A restart
  // interval is a whole number of MCU rows; a restart, and each MCU row
  // decoded without data, starts every component's next row as a first row.
  void decode_lossless(Component** sc, int ns, int psv, int pt) {
    BitReader br{&st, pos};
    const int mcus_per_row = ns == 1 ? sc[0]->width_in_blocks : mcux;
    if (restart_interval % mcus_per_row)
      throw Unreadable("a lossless restart interval that is not whole MCU rows");
    const int rows_per_interval = restart_interval / mcus_per_row;
    int rows_to_go = rows_per_interval, next_rst = 0;
    for (int i = 0; i < ncomp; i++) comp[i].first_row = true;
    const int initial = 1 << (precision - pt - 1);
    for (int row = 0; row < mcuy; row++) {
      const int mcu_rows = ns > 1 ? 1 : row < mcuy - 1 ? sc[0]->v : sc[0]->last_row_height();
      for (int yoff = 0; yoff < mcu_rows; yoff++) {
        if (restart_interval && rows_to_go == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (int i = 0; i < ncomp; i++) comp[i].first_row = true;
          rows_to_go = rows_per_interval;
        }
        const bool empty = br.insufficient;
        if (empty)
          for (int i = 0; i < ncomp; i++) comp[i].first_row = true;
        for (int mx = 0; mx < mcus_per_row; mx++)
          for (int i = 0; i < ns; i++) {
            Component* c = sc[i];
            const int bv = ns == 1 ? 1 : c->v, bh = ns == 1 ? 1 : c->h;
            const int y0 = row * c->v + (ns == 1 ? yoff : 0), x0 = mx * bh;
            for (int y = 0; y < bv; y++)
              for (int x = 0; x < bh; x++) {
                int s = 0;
                if (!empty) {
                  s = br.decode(dc[c->td]);
                  if (s == 16) s = 32768;
                  else if (s) s = extend(br.bits(s), s);
                }
                c->diff[size_t(y0 + y) * c->blocks_w + x0 + x] = s;
              }
          }
        if (restart_interval) rows_to_go--;
      }
      for (int i = 0; i < ns; i++) {
        Component* c = sc[i];
        const int rows = row == mcuy - 1 ? c->last_row_height() : c->v;
        for (int r = 0; r < rows; r++) {
          const size_t y = size_t(row) * c->v + r, w = c->blocks_w;
          const int32_t* d = c->diff.data() + y * w;
          int32_t* u = c->undiff.data() + y * w;
          const int32_t* p = y ? u - w : u;  // the row above
          const int n = c->width_in_blocks;
          if (c->first_row) {  // jpeg_undifference_first_row: predictor 1 from `initial`
            int ra = (d[0] + initial) & 0xFFFF;
            u[0] = ra;
            for (int x = 1; x < n; x++) u[x] = ra = (d[x] + ra) & 0xFFFF;
            c->first_row = false;
          } else {
            int rb = p[0], ra = (d[0] + rb) & 0xFFFF, rc;
            u[0] = ra;
            for (int x = 1; x < n; x++) {
              rc = rb;
              rb = p[x];
              int pred;
              switch (psv) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
              u[x] = ra = (d[x] + pred) & 0xFFFF;
            }
          }
          uint8_t* out = c->plane.data() + y * c->stride;
          for (int x = 0; x < n; x++) out[x] = uint8_t(u[x] << pt);
        }
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

  // jdcoefct.c:decompress_smooth_data (libjpeg-turbo 2.1 and later): the
  // IDCT of a component whose coefficients 1-9 (zigzag) are not all known
  // exactly.  Each zero coefficient not known exactly is estimated from the
  // DC values of the 5x5 blocks around its block, and where no AC scan has
  // run at all (every coef_bits[1..9] -1) the DC too, with a Gaussian-like
  // kernel.  iMCU rows past `last_good` take the coefficient state before
  // their component's last scan.  The row indices follow libjpeg's,
  // including its image_block_row of the last iMCU row.
  void smooth_idct(Component& c) const {
    int prev[10];
    for (int k = 0; k < 10; k++) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
    const int64_t q00 = c.quant[0];
    const int64_t q[10] = {q00,        c.quant[1],  c.quant[8],  c.quant[16], c.quant[9],
                           c.quant[2], c.quant[3], c.quant[10], c.quant[17], c.quant[24]};
    const int T = mcuy, last_col = c.width_in_blocks - 1;
    int16_t ws[64];
    auto blk = [&](int by, int bx) { return c.coef.data() + (size_t(by) * c.blocks_w + bx) * 64; };
    for (int row = 0; row < T; row++) {
      const int* bits = row > last_good ? prev : c.coef_bits;
      bool change_dc = true;
      for (int k = 1; k <= 9; k++) change_dc = change_dc && bits[k] == -1;
      const int block_rows = row < T - 1 ? c.v : c.last_row_height();
      const int image_rows = block_rows * T;
      for (int br = 0; br < block_rows; br++) {
        const int ibr = row * block_rows + br, by = row * c.v + br;
        int rows5[5];
        rows5[2] = by;
        rows5[1] = ibr > 0 ? by - 1 : by;
        rows5[0] = ibr > 1 ? by - 2 : rows5[1];
        rows5[3] = ibr < image_rows - 1 ? by + 1 : by;
        rows5[4] = ibr < image_rows - 2 ? by + 2 : rows5[3];
        int D[26];  // D[5 * r + col + 1]: the DC of row r, column col of the window
        for (int r = 0; r < 5; r++)
          for (int k = 1; k <= 5; k++) D[5 * r + k] = blk(rows5[r], 0)[0];
        for (int bx = 0; bx <= last_col; bx++) {
          std::memcpy(ws, blk(by, bx), sizeof(ws));
          if (bx == 0 && bx < last_col)
            for (int r = 0; r < 5; r++) D[5 * r + 4] = D[5 * r + 5] = blk(rows5[r], 1)[0];
          if (bx + 1 < last_col)
            for (int r = 0; r < 5; r++) D[5 * r + 5] = blk(rows5[r], bx + 2)[0];
          auto est = [&](int k, int pos, int64_t sum) {
            if (bits[k] != 0 && ws[pos] == 0) ws[pos] = smooth_estimate(q00 * sum, q[k], bits[k]);
          };
          est(1, 1, change_dc ? -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] +
                                    3 * D[10] - 3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] -
                                    3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] -
                                    D[22] + D[24] + D[25]
                              : -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
          est(2, 8, change_dc ? -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] +
                                    38 * D[8] + 13 * D[9] - D[10] + D[16] - 13 * D[17] -
                                    38 * D[18] - 13 * D[19] + D[20] + D[21] + 3 * D[22] +
                                    3 * D[23] + 3 * D[24] + D[25]
                              : -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
          est(3, 16, change_dc ? D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] -
                                     5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]
                               : -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
          est(4, 9, change_dc ? -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] +
                                    D[21] - D[25]
                              : D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] -
                                    D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9]);
          est(5, 2, change_dc ? 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] +
                                    7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]
                              : -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
          if (change_dc) {
            est(6, 3, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
            est(7, 10, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
            est(8, 17, D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
            est(9, 24, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
            const int64_t dc = -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] +
                               6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] +
                               42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16] +
                               6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21] -
                               6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25];
            ws[0] = smooth_estimate(q00 * dc, q00, 0);
          }
          idct_islow(ws, c.quant, c.plane.data() + size_t(by) * 8 * c.stride + bx * 8, c.stride);
          for (int r = 0; r < 5; r++)
            for (int k = 1; k <= 4; k++) D[5 * r + k] = D[5 * r + k + 1];
        }
      }
    }
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
      } else if (m == 0xCC) {
        read_dac();
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
      } else if (m == 0xFE || m == 0xDC) {  // COM, DNL
        int len = u16() - 2;
        if (len > 0) pos += len;
      } else {
        throw Unreadable("unknown JPEG marker");
      }
    }
  }
};

// ---------------------------------------------------------------- upsampling

// The full-resolution plane (width x height) of one component; `fancy`
// false (a lossless frame: jdsample.c fancy-upsamples only DCT blocks of more
// than one sample) replicates.
void upsample(const Component& c, int hmax, int vmax, int width, int height, bool fancy,
              uint8_t* out) {
  const int he = hmax / c.h, ve = vmax / c.v;
  const uint8_t* in = c.plane.data();
  const int stride = c.stride, dsw = c.ds_w, dsh = c.ds_h;
  std::vector<uint8_t> row(size_t(dsw) * he + 8);
  auto emit = [&](int y, const uint8_t* src) { std::memcpy(out + size_t(y) * width, src, width); };
  if (he == 1 && ve == 1) {
    for (int y = 0; y < height; y++) emit(y, in + size_t(y) * stride);
    return;
  }
  if (fancy && he == 2 && ve == 1 && dsw > 2) {  // h2v1_fancy_upsample
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
  if (fancy && he == 1 && ve == 2) {  // h1v2_fancy_upsample
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
  if (fancy && he == 2 && ve == 2 && dsw > 2) {  // h2v2_fancy_upsample
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

// OpenCV's conversions of libjpeg's CMYK output (icvCvt_CMYK2BGR_8u_C4C3R,
// icvCvt_CMYK2Gray_8u_C4C1R): each ink scaled by K, then BGR or the
// 14-bit fixed-point grey of it
const int kGrayR = 4899, kGrayG = 9617, kGrayB = 16384 - kGrayR - kGrayG;

// A decoded file's planes, complete: a multi-scan file's IDCT, after its
// last scan, block-smoothed where libjpeg smooths; a component no scan coded
// is all zero coefficients: 128
void finish_planes(Jpeg& j) {
  const bool smooth = j.would_smooth();
  for (int i = 0; i < j.ncomp && j.multi_scan && !j.lossless; i++) {
    Component& c = j.comp[i];
    if (!j.needed(i)) continue;
    if (c.coef.empty()) c.plane.assign(size_t(c.stride) * c.blocks_h * 8, 128);
    else if (smooth) j.smooth_idct(c);
    else c.idct_rows(0, c.height_in_blocks);
  }
  // a lossless frame's samples live in virtual arrays that are not
  // pre-zeroed: output of a component no scan wrote (a multi-scan file cut
  // before its scan) is libjpeg's JERR_BAD_VIRTUAL_ACCESS
  for (int i = 0; i < j.ncomp && j.lossless; i++)
    if (j.comp[i].plane.empty())
      throw Unreadable("a lossless component that no scan wrote (the file ends before its scan)");
}

void jpeg_decode(const uint8_t* data, size_t n, bool gray, uint8_t* out) {
  Jpeg j(data, n);
  j.gray = gray;
  j.run(true);
  j.check_output();
  const int W = j.width, H = j.height;
  finish_planes(j);
  const bool fancy = !j.lossless;
  if (gray && (j.ncomp == 1 || j.space == kYCbCr)) {
    upsample(j.comp[0], j.hmax, j.vmax, W, H, fancy, out);
    return;
  }
  const size_t npix = size_t(W) * H;
  if (j.ncomp == 1) {
    std::vector<uint8_t> y(npix);
    upsample(j.comp[0], j.hmax, j.vmax, W, H, fancy, y.data());
    for (size_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return;
  }
  std::vector<uint8_t> planes(npix * j.ncomp);
  for (int c = 0; c < j.ncomp; c++)
    upsample(j.comp[c], j.hmax, j.vmax, W, H, fancy, planes.data() + c * npix);
  const uint8_t *P0 = planes.data(), *P1 = P0 + npix, *P2 = P1 + npix, *P3 = P2 + npix;
  if (j.ncomp == 4) {  // JCS_CMYK output: YCCK -> CMYK (jdcolor.c:ycck_cmyk_convert), then OpenCV's
    for (size_t i = 0; i < npix; i++) {
      int c = P0[i], m = P1[i], y = P2[i];
      const int k = P3[i];
      if (j.space == kYCCK) {
        const int luma = P0[i], cb = P1[i], cr = P2[i];
        c = 255 - clamp255(luma + kYcc.cr_r[cr]);
        m = 255 - clamp255(luma + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        y = 255 - clamp255(luma + kYcc.cb_b[cb]);
      }
      c = k - ((255 - c) * k >> 8);
      m = k - ((255 - m) * k >> 8);
      y = k - ((255 - y) * k >> 8);
      if (gray) {
        out[i] = uint8_t((y * kGrayB + m * kGrayG + c * kGrayR + (1 << 13)) >> 14);
      } else {
        out[3 * i] = uint8_t(y);
        out[3 * i + 1] = uint8_t(m);
        out[3 * i + 2] = uint8_t(c);
      }
    }
    return;
  }
  if (j.space == kRGB) {  // rgb_rgb_convert, or rgb_gray_convert's 16-bit tables
    for (size_t i = 0; i < npix; i++) {
      if (gray) {
        out[i] = uint8_t((19595 * P0[i] + 38470 * P1[i] + 7471 * P2[i] + 32768) >> 16);
      } else {
        out[3 * i] = P2[i];
        out[3 * i + 1] = P1[i];
        out[3 * i + 2] = P0[i];
      }
    }
    return;
  }
  const uint8_t *Y = P0, *Cb = P1, *Cr = P2;
  for (size_t i = 0; i < npix; i++) {
    int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i + 2] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * i + 1] = clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * i] = clamp255(y + kYcc.cb_b[cb]);
  }
}

// ---------------------------------------------------------------- JPEG in TIFF

// The JPEGTables tag of a TIFF in compression 7 (an abbreviated table
// specification: SOI, DQT / DHT segments, EOI), read as libtiff's
// JPEGSetupDecode reads it with jpeg_read_header(FALSE): tables only; a scan
// in it is "Bogus JPEGTables" (the strip read fails).  Its quantization and
// Huffman tables are loaded into `j`, as they stay in libjpeg's
// decompressor for every strip's abbreviated stream.
void load_tables(const uint8_t* tables, size_t n, Jpeg& j) {
  Jpeg t(tables, n);
  if (t.st.at(0) != 0xFF || t.st.at(1) != 0xD8) throw Unreadable("JPEGTables without SOI");
  t.pos = 2;
  for (int m = t.next_marker(); m != 0xD9; m = t.next_marker()) {
    if (m == 0xC4) {
      t.read_dht();
    } else if (m == 0xDB) {
      t.read_dqt();
    } else if (m == 0xCC) {
      t.read_dac();
    } else if (m == 0xDD) {
      if (t.u16() != 4) throw Unreadable("bad restart interval segment length");
      t.u16();
    } else if (m >= 0xE0 && m <= 0xEF) {
      t.read_app(m);
    } else if ((m >= 0xC0 && m <= 0xC3) || (m >= 0xC9 && m <= 0xCB) || m == 0xFE || m == 0xDC) {
      const int len = t.u16() - 2;  // a frame header before EOI is dropped with the tables
      if (len > 0) t.pos += size_t(len);
    } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
    } else {
      throw Unreadable("bogus JPEGTables (a scan, a second SOI or an unknown marker)");
    }
  }
  std::memcpy(j.quant_tables, t.quant_tables, sizeof(j.quant_tables));
  std::memcpy(j.quant_defined, t.quant_defined, sizeof(j.quant_defined));
  for (int k = 0; k < 4; k++) {
    j.dc[k] = t.dc[k];
    j.ac[k] = t.ac[k];
  }
}

// What libtiff asks of one strip or tile (tif_jpeg.c:JPEGPreDecode):
// p[0], p[1] the segment's width and height, p[2] 1 where a taller stream
// is allowed (the last strip, whose stream may keep the full strip height),
// p[3] the components (samples a pixel), p[4], p[5] the sampling component 0
// must have (YCbCrSubsampling for a YCbCr TIFF, else 1, 1), p[6] the bits
// per sample, p[7] 1 to convert YCbCr to RGB (JPEGCOLORMODE_RGB, which
// TIFFRGBAImageBegin sets for a contiguous YCbCr TIFF), else no colour
// conversion (JCS_UNKNOWN: the components as decoded).
// The decoded rows, R, G, B or the components interleaved, are written at
// `rowbytes` apart: min(segment height, stream height) rows of the stream's
// width (a narrower stream leaves the rest of each row as it was).  Returns
// the rows written.
int tiff_jpeg_decode(const uint8_t* tables, size_t ntables, const uint8_t* data, size_t n,
                     const int32_t* p, uint8_t* out, int64_t rowbytes) {
  Jpeg j(data, n);
  if (ntables) load_tables(tables, ntables, j);
  j.run(true);
  const int seg_w = p[0], seg_h = p[1], ncomp = p[3], hs = p[4], vs = p[5];
  const bool to_rgb = p[7] != 0;
  const int W = j.width, H = j.height;
  const bool taller_last = W == seg_w && H > seg_h && p[2];
  if (!taller_last && (W > seg_w || H > seg_h))
    throw Unreadable("JPEG strip/tile size exceeds expected dimensions");
  if (j.ncomp != ncomp) throw Unreadable("improper JPEG component count");
  if (j.precision != p[6]) throw Unreadable("improper JPEG data precision");
  if (j.comp[0].h != hs || j.comp[0].v != vs) throw Unreadable("improper JPEG sampling factors");
  for (int i = 1; i < j.ncomp; i++)
    if (j.comp[i].h != 1 || j.comp[i].v != 1) throw Unreadable("improper JPEG sampling factors");
  if (to_rgb && ncomp != 3) throw Unreadable("YCbCr to RGB of other than 3 components");
  finish_planes(j);
  const int rows = std::min(seg_h, H);
  const size_t npix = size_t(W) * H;
  std::vector<uint8_t> planes(npix * ncomp);
  for (int c = 0; c < ncomp; c++)
    upsample(j.comp[c], j.hmax, j.vmax, W, H, !j.lossless, planes.data() + c * npix);
  for (int y = 0; y < rows; y++) {
    uint8_t* o = out + y * rowbytes;
    const size_t at = size_t(y) * W;
    for (int x = 0; x < W; x++) {
      if (to_rgb) {
        const int luma = planes[at + x], cb = planes[npix + at + x], cr = planes[2 * npix + at + x];
        o[3 * x] = clamp255(luma + kYcc.cr_r[cr]);
        o[3 * x + 1] = clamp255(luma + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(luma + kYcc.cb_b[cb]);
      } else {
        for (int c = 0; c < ncomp; c++) o[ncomp * x + c] = planes[c * npix + at + x];
      }
    }
  }
  return rows;
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

// libpng's gamma tables for png_set_rgb_to_gray of a gamma-tagged file
// (png_build_gamma_table; null when the file's gamma is not significant):
// 8-bit gamma_to_1, gamma_from_1 and gamma_table (768 bytes), or at 16 bits
// gamma_16_to_1, gamma_16_from_1 and gamma_16_table (the 16-to-8 one), each
// (256 >> shift) x 256 entries indexed [(v & 0xFF) >> shift][v >> 8]
struct PngGamma {
  const uint8_t* t8;
  const uint16_t* t16;
  int shift;
  int lookup16(int table, int v) const {
    return t16[(size_t(table) * (256 >> shift) + ((v & 0xFF) >> shift)) * 256 + (v >> 8)];
  }
};

void png_unfilter(const uint8_t* raw, size_t n, int width, int height, int depth,
                  int color_type, int interlace, const uint8_t* palette, int npal, bool gray,
                  const PngGamma& gamma, uint8_t* out) {
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
          if (gray && colour && gamma.t16) {  // png_do_rgb_to_gray's linear sum, rounded
            int w;
            if (r == g && r == b) {
              w = gamma.lookup16(2, r);
            } else {
              const int sum = (9797 * gamma.lookup16(0, r) + 19234 * gamma.lookup16(0, g) +
                               3737 * gamma.lookup16(0, b) + 16384) >> 15;
              w = gamma.lookup16(1, sum);
            }
            out[o] = uint8_t(w >> 8);
          } else if (gray) {
            out[o] = uint8_t((colour ? (9797 * r + 19234 * g + 3737 * b + 16384) >> 15 : r) >> 8);
          } else {
            out[3 * o] = uint8_t(b >> 8);
            out[3 * o + 1] = uint8_t(g >> 8);
            out[3 * o + 2] = uint8_t(r >> 8);
          }
        } else if (gray && gamma.t8 && (colour || color_type == 3)) {
          const uint8_t *to_1 = gamma.t8, *from_1 = to_1 + 256, *table = from_1 + 256;
          out[o] = r == g && r == b ? table[r]
                                    : from_1[(9797 * to_1[r] + 19234 * to_1[g] + 3737 * to_1[b] +
                                              16384) >> 15];
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

// 1 where imread gives None, -1 for any other failure (out of memory)
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
// palette: npal RGB triplets; gamma8 / gamma16 / gamma_shift: PngGamma's
// tables (null where the file carries no significant gamma)
int fots_png_unfilter(const uint8_t* raw, int64_t n, int width, int height, int depth,
                      int color_type, int interlace, const uint8_t* palette, int npal, int gray,
                      const uint8_t* gamma8, const uint16_t* gamma16, int gamma_shift,
                      uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    png_unfilter(raw, size_t(n), width, height, depth, color_type, interlace, palette, npal,
                 gray != 0, PngGamma{gamma8, gamma16, gamma_shift}, out);
  });
}

// One strip or tile of a JPEG-compressed TIFF (tiff_jpeg_decode): `info` gets
// the rows written
int fots_tiff_jpeg(const uint8_t* tables, int64_t ntables, const uint8_t* data, int64_t n,
                   const int32_t* params, uint8_t* out, int64_t rowbytes, int32_t* info,
                   char* err, int errlen) {
  return guarded(err, errlen, [&] {
    info[0] = tiff_jpeg_decode(tables, size_t(ntables), data, size_t(n), params, out, rowbytes);
  });
}

// The orientation tag of a TIFF-structured EXIF block (a PNG's eXIf chunk)
int fots_exif_orientation(const uint8_t* data, int64_t n) {
  return exif_orientation(data, size_t(n));
}

}  // extern "C"
