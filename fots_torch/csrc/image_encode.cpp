// Baseline JPEG encoder on the host: the bytes that libjpeg-turbo writes
// under cv2.imwrite's defaults (quality 95, 4:2:0 for three channels, one
// component for grey, sequential Huffman coding with the standard tables, no
// optimisation, a JFIF APP0 segment, no restart markers), so the port's
// imencode_jpg equals cv2.imencode(".jpg", im) byte for byte.
//
// What decides the bytes, each as libjpeg-turbo computes it:
// - jccolor.c: BGR -> YCbCr through 16-bit fixed-point tables (Cb and Cr
//   round with 0.5 - epsilon);
// - jcprepct.c / jcsample.c: each plane is edge-replicated right to the MCU
//   grid and down to whole row pairs; h2v2 downsampling averages 2x2 with a
//   bias alternating 1, 2 along the row, and its last row is repeated down to
//   the MCU grid;
// - jccoefct.c: a luma block wholly past the image's edge inside the last
//   MCU column or row is a "dummy" block, all AC zero and its DC copied from
//   the block before it;
// - jfdctint.c: the islow forward DCT (CONST_BITS 13, PASS1_BITS 2), output
//   scaled by 8, of the samples less 128;
// - jcdctmgr.c: quantisation by the 16-bit reciprocal of 8 q (the SIMD
//   build's compute_reciprocal): |x| + c times the reciprocal, shifted;
// - jcparam.c: the Annex K tables scaled by jpeg_quality_scaling, clamped to
//   1..255 (baseline);
// - jchuff.c: DC differences per component, AC run lengths with ZRL and
//   EOB, 0xFF stuffed with 0x00, the last byte padded with 1-bits.
//
// Plain C interface (ctypes); no OpenCV or libjpeg on either machine.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// natural index of each zigzag position (jpeg_natural_order)
const int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ITU T.81 Annex K.1, natural order
const int kLumaQuant[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                            14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                            18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                            49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ITU T.81 Annex K.3: code counts by length 1..16, then the symbols
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

struct HuffSpec {
  const uint8_t* bits;
  const uint8_t* vals;
  int n_vals;
};

// canonical codes (jpeg_make_c_derived_tbl)
struct HuffTable {
  uint32_t code[256];
  int size[256];
  explicit HuffTable(const HuffSpec& spec) {
    std::memset(size, 0, sizeof(size));
    std::memset(code, 0, sizeof(code));
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < spec.bits[len - 1]; i++, k++) {
        code[spec.vals[k]] = c++;
        size[spec.vals[k]] = len;
      }
      c <<= 1;
    }
  }
};

// the bit writer of jchuff.c: bytes MSB first, 0xFF followed by 0x00
struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int len) {
    for (int i = len - 1; i >= 0; i--) {
      acc = (acc << 1) | ((bits >> i) & 1u);
      if (++n == 8) {
        out.push_back((uint8_t)acc);
        if (acc == 0xFF) out.push_back(0);
        acc = 0;
        n = 0;
      }
    }
  }
  void flush() {  // pad with 1-bits
    if (n > 0) put(0x7F, 8 - n);
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)(v & 0xFF));
}

void marker(std::vector<uint8_t>& o, uint8_t m) {
  o.push_back(0xFF);
  o.push_back(m);
}

// jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
void scaled_table(const int* base, int quality, int* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long v = ((long)base[i] * scale + 50L) / 100L;
    if (v <= 0) v = 1;
    if (v > 255) v = 255;
    out[i] = (int)v;
  }
}

// compute_reciprocal of jcdctmgr.c with 16-bit DCTELEM (the SIMD build):
// x / d rounded becomes ((x + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t d) {
  int b = 0;
  while ((d >> (b + 1)) != 0) b++;  // floor(log2(d))
  int r = 16 + b;
  uint32_t fq = (1u << r) / d;
  const uint32_t fr = (1u << r) % d;
  uint32_t c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= d / 2u) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

// jfdctint.c's jpeg_fdct_islow, in place on 64 values (natural order)
void fdct_islow(int32_t* data) {
  const int CONST_BITS = 13, PASS1_BITS = 2;
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) -> int32_t {
    return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
  };
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;     // along a row, then down a column
    const int next = pass == 0 ? 8 : 1;
    const int odd_shift = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
    for (int line = 0; line < 8; line++) {
      int32_t* p = data + line * next;
      int64_t tmp0 = p[0 * step] + p[7 * step], tmp7 = p[0 * step] - p[7 * step];
      int64_t tmp1 = p[1 * step] + p[6 * step], tmp6 = p[1 * step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0 * step] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
      } else {
        p[0 * step] = descale(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = descale(tmp10 - tmp11, PASS1_BITS);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, odd_shift);
      p[6 * step] = descale(z1 + tmp12 * -F1847, odd_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      p[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      p[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      p[1 * step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

// one plane, edge-replicated to pw x ph
struct Plane {
  int w, h;
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[(size_t)y * w + x]; }
};

// forward DCT and quantisation of the 8x8 block at (by, bx) of a plane
void quantized_block(const Plane& pl, int by, int bx, const Divisor* div, int16_t* out) {
  int32_t ws[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) ws[y * 8 + x] = (int32_t)pl.at(by * 8 + y, bx * 8 + x) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    const int32_t t = ws[i];
    const uint32_t a = (uint32_t)(t < 0 ? -t : t);
    const int32_t q = (int32_t)(((uint64_t)(a + div[i].corr) * div[i].recip) >> div[i].shift);
    out[i] = (int16_t)(t < 0 ? -q : q);
  }
}

int bit_length(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const HuffTable& dc,
                  const HuffTable& ac) {
  int diff = blk[0] - last_dc;
  last_dc = blk[0];
  int mag = diff < 0 ? -diff : diff;
  int nbits = bit_length(mag);
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff) & ((1u << nbits) - 1), nbits);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    const int v = blk[kNatural[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    mag = v < 0 ? -v : v;
    nbits = bit_length(mag);
    const int sym = (run << 4) + nbits;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)(v < 0 ? v - 1 : v) & ((1u << nbits) - 1), nbits);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void write_dqt(std::vector<uint8_t>& o, int id, const int* q) {
  marker(o, 0xDB);
  put16(o, 67);
  o.push_back((uint8_t)id);
  for (int k = 0; k < 64; k++) o.push_back((uint8_t)q[kNatural[k]]);
}

void write_dht(std::vector<uint8_t>& o, int cls_id, const HuffSpec& s) {
  marker(o, 0xC4);
  put16(o, 2 + 1 + 16 + s.n_vals);
  o.push_back((uint8_t)cls_id);
  for (int i = 0; i < 16; i++) o.push_back(s.bits[i]);
  for (int i = 0; i < s.n_vals; i++) o.push_back(s.vals[i]);
}

// BGR -> Y, Cb, Cr planes (jccolor.c's tables), edge-replicated to pw x ph
void color_planes(const uint8_t* im, int h, int w, int pw, int ph, Plane* planes) {
  const int32_t SCALE = 16, HALF = 1 << 15, OFFSET = 128 << 16;
  auto fix = [](double v) { return (int32_t)(v * 65536.0 + 0.5); };
  const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
  const int32_t rcb = -fix(0.16874), gcb = -fix(0.33126), half = fix(0.50000);
  const int32_t gcr = -fix(0.41869), bcr = -fix(0.08131);
  for (int c = 0; c < 3; c++) {
    planes[c].w = pw;
    planes[c].h = ph;
    planes[c].px.assign((size_t)pw * ph, 0);
  }
  for (int y = 0; y < ph; y++) {
    const uint8_t* row = im + (size_t)(y < h ? y : h - 1) * w * 3;
    for (int x = 0; x < pw; x++) {
      const uint8_t* p = row + (size_t)(x < w ? x : w - 1) * 3;
      const int32_t b = p[0], g = p[1], r = p[2];
      const size_t i = (size_t)y * pw + x;
      planes[0].px[i] = (uint8_t)((ry * r + gy * g + by * b + HALF) >> SCALE);
      planes[1].px[i] = (uint8_t)((rcb * r + gcb * g + half * b + OFFSET + HALF - 1) >> SCALE);
      planes[2].px[i] = (uint8_t)((half * r + gcr * g + bcr * b + OFFSET + HALF - 1) >> SCALE);
    }
  }
}

// jcsample.c's h2v2_downsample: 2x2 means with the alternating 1, 2 bias,
// over the image's row pairs (an odd last row paired with itself); below
// them the last downsampled row is repeated, as jcprepct.c pads the output
Plane downsample_h2v2(const Plane& full, int image_h) {
  Plane out;
  out.w = full.w / 2;
  out.h = full.h / 2;
  out.px.resize((size_t)out.w * out.h);
  const int rows = (image_h + 1) / 2;
  for (int y = 0; y < out.h; y++) {
    if (y >= rows) {
      std::memcpy(&out.px[(size_t)y * out.w], &out.px[(size_t)(rows - 1) * out.w], out.w);
      continue;
    }
    int bias = 1;
    for (int x = 0; x < out.w; x++) {
      const int s = full.at(2 * y, 2 * x) + full.at(2 * y, 2 * x + 1) +
                    full.at(2 * y + 1, 2 * x) + full.at(2 * y + 1, 2 * x + 1);
      out.px[(size_t)y * out.w + x] = (uint8_t)((s + bias) >> 2);
      bias ^= 3;
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Encode a u8 image [h, w, channels] (channels 1: grey; 3: BGR) as a
// baseline JPEG of ``quality`` into out[0:cap].  Returns the byte count, -1
// for bad arguments, or -(bytes needed) when cap is too small.
long long fots_jpeg_encode(const uint8_t* im, int h, int w, int channels, int quality,
                           uint8_t* out, long long cap) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (channels != 1 && channels != 3))
    return -1;
  std::vector<uint8_t> o;
  o.reserve((size_t)h * w * channels / 2 + 1024);
  int qt[2][64];
  scaled_table(kLumaQuant, quality, qt[0]);
  scaled_table(kChromaQuant, quality, qt[1]);
  const HuffSpec dc_spec[2] = {{kDcLumaBits, kDcVals, 12}, {kDcChromaBits, kDcVals, 12}};
  const HuffSpec ac_spec[2] = {{kAcLumaBits, kAcLumaVals, 162},
                               {kAcChromaBits, kAcChromaVals, 162}};
  const int n_tables = channels == 3 ? 2 : 1;

  marker(o, 0xD8);
  marker(o, 0xE0);  // JFIF 1.01, no density unit, 1:1
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  put16(o, 16);
  o.insert(o.end(), jfif, jfif + 14);
  for (int t = 0; t < n_tables; t++) write_dqt(o, t, qt[t]);
  marker(o, 0xC0);
  put16(o, 8 + 3 * channels);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back((uint8_t)channels);
  for (int c = 0; c < channels; c++) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(channels == 3 && c == 0 ? 0x22 : 0x11);
    o.push_back(c == 0 ? 0 : 1);
  }
  for (int t = 0; t < n_tables; t++) {
    write_dht(o, 0x00 | t, dc_spec[t]);
    write_dht(o, 0x10 | t, ac_spec[t]);
  }
  marker(o, 0xDA);
  put16(o, 6 + 2 * channels);
  o.push_back((uint8_t)channels);
  for (int c = 0; c < channels; c++) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(c == 0 ? 0x00 : 0x11);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  Divisor div[2][64];
  for (int t = 0; t < n_tables; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal((uint32_t)qt[t][i] << 3);
  const HuffTable dc[2] = {HuffTable(dc_spec[0]), HuffTable(dc_spec[1])};
  const HuffTable ac[2] = {HuffTable(ac_spec[0]), HuffTable(ac_spec[1])};
  BitWriter bw(o);
  int16_t blk[64];

  if (channels == 1) {
    // one component, non-interleaved: every 8x8 block of the replicated plane
    const int bw_ = (w + 7) / 8, bh = (h + 7) / 8;
    Plane pl;
    pl.w = bw_ * 8;
    pl.h = bh * 8;
    pl.px.resize((size_t)pl.w * pl.h);
    for (int y = 0; y < pl.h; y++)
      for (int x = 0; x < pl.w; x++)
        pl.px[(size_t)y * pl.w + x] = im[(size_t)(y < h ? y : h - 1) * w + (x < w ? x : w - 1)];
    int last = 0;
    for (int by = 0; by < bh; by++)
      for (int bx = 0; bx < bw_; bx++) {
        quantized_block(pl, by, bx, div[0], blk);
        encode_block(bw, blk, last, dc[0], ac[0]);
      }
  } else {
    // 4:2:0 interleaved: per 16x16 MCU four Y blocks, one Cb, one Cr
    const int mcu_x = (w + 15) / 16, mcu_y = (h + 15) / 16;
    const int luma_bx = (w + 7) / 8, luma_by = (h + 7) / 8;  // real luma blocks
    Plane full[3];
    color_planes(im, h, w, mcu_x * 16, mcu_y * 16, full);
    const Plane cb = downsample_h2v2(full[1], h), cr = downsample_h2v2(full[2], h);
    int last[3] = {0, 0, 0};
    int16_t ys[4][64];
    for (int my = 0; my < mcu_y; my++)
      for (int mx = 0; mx < mcu_x; mx++) {
        for (int k = 0; k < 4; k++) {
          const int by = my * 2 + k / 2, bx = mx * 2 + k % 2;
          if (by < luma_by && bx < luma_bx) {
            quantized_block(full[0], by, bx, div[0], ys[k]);
          } else {
            // a dummy block: zero AC, the DC of the block before it in the
            // MCU (for the bottom row, block 1, the top row's last)
            std::memset(ys[k], 0, sizeof(ys[k]));
            ys[k][0] = by < luma_by ? ys[k - 1][0] : ys[k < 2 ? k - 1 : 1][0];
          }
        }
        for (int k = 0; k < 4; k++) encode_block(bw, ys[k], last[0], dc[0], ac[0]);
        quantized_block(cb, my, mx, div[1], blk);
        encode_block(bw, blk, last[1], dc[1], ac[1]);
        quantized_block(cr, my, mx, div[1], blk);
        encode_block(bw, blk, last[2], dc[1], ac[1]);
      }
  }
  bw.flush();
  marker(o, 0xD9);
  if ((long long)o.size() > cap) return -(long long)o.size();
  std::memcpy(out, o.data(), o.size());
  return (long long)o.size();
}

}  // extern "C"
