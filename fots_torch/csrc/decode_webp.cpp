// Host decoding of WebP files as cv2.imread reads them under OpenCV 5.0,
// whose WebPDecoder runs libwebp 1.5 (decoder ABI 0x0210, demux 0x0107):
// colour (BGR) or grayscale, byte for byte.  Written from the formats'
// specifications (RFC 9649 for the container and VP8L, RFC 6386 for VP8),
// following libwebp's decoder where the specifications leave a choice:
//   - the container as WebPDecode parses it: RIFF size rules, odd chunks
//     padded, simple "VP8 " and "VP8L" files, raw VP8 / VP8L streams, VP8X
//     with any chunks before the image (the last ALPH before it is its
//     alpha); the image's bit stream runs to the end of the file, as in
//     libwebp (trailing chunks are part of its last partition);
//   - VP8L: simple and normal prefix codes (complete, or of one symbol),
//     the meta prefix image, LZ77 references with the 120-entry distance
//     map, the colour cache, the predictor (14 modes), cross-colour,
//     subtract-green and colour-indexing transforms (pixel bundling at 1, 2
//     and 4 bits), and libwebp's end-of-stream rule (a stream that needs a
//     bit past its end fails; alpha planes coded with only a palette and no
//     colour cache may end inside their last symbol);
//   - VP8 key frames: the boolean decoder (its end-of-data flag fails a
//     macroblock row of partition 0 or a macroblock of a token partition
//     that reads past its end), segments, quantiser tables, token
//     probabilities with their updates, 16x16, 4x4 (ten modes) and 8x8
//     chroma intra prediction with libwebp's borders (127 above, 129 to the
//     left), the inverse WHT and DCT on 16-bit coefficients (a block of
//     more than three coefficients through libwebp's x86-64 Transform_SSE2
//     arithmetic, whose 16-bit lanes wrap), the normal and simple loop
//     filters with sharpness, per-segment levels and mode / ref deltas;
//   - YUV 4:2:0 to BGR as WebPDecodeBGRInto does it by default: the "fancy"
//     upsampler (9-3-3-1, edges mirrored) and VP8YUVToR / G / B in 14-bit
//     fixed point;
//   - ALPH: raw or VP8L-coded, the four filters, checked in full (a damaged
//     alpha plane fails the image) though the colour and grey outputs drop
//     alpha;
//   - animated files (ANIM / ANMF): the first frame, as WebPAnimDecoder
//     composes it for cv2.imread: on a canvas of zeros (the ANIM background
//     colour is not used), at its offset; the file must pass WebPDemux's
//     checks;
//   - grey output: cvtColor(BGR2GRAY) of the colour image (15-bit fixed
//     point).
// The first EXIF chunk of a VP8X file whose EXIF flag is set, in a file
// WebPDemux accepts, is returned for its orientation (OpenCV reads it
// through the demuxer).  fots_webp_decode_bgra also gives the decoded alpha
// plane, which the tests hold against cv2.IMREAD_UNCHANGED's.
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.  Every entry point returns 0, 1 with a
// message in `err` where imread gives None, or -1 with a message for any
// other failure (such as memory).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Unreadable : std::runtime_error {
  explicit Unreadable(const std::string& m) : std::runtime_error(m) {}
};

inline uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t le24(const uint8_t* p) { return le16(p) | uint32_t(p[2]) << 16; }
inline uint32_t le32(const uint8_t* p) { return le24(p) | uint32_t(p[3]) << 24; }

// cvtColor(BGR2GRAY) of 8-bit pixels: 15-bit fixed point, rounded
inline uint8_t grey(int b, int g, int r) { return uint8_t((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15); }

// ============================================================== VP8L

constexpr int kLBits = 64;
constexpr int kHuffTableBits = 8;
constexpr int kMaxCodeLength = 15;
constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kAlphabet[5] = {kNumLiteral + kNumLength, 256, 256, 256, kNumDistance};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
// (dy << 4) | (8 - dx) of the 120 short distance codes
constexpr uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};

// libwebp's VP8LBitReader: 64 bits of look-ahead, least significant first.
// A stream of fewer than 8 bytes reads zeros up to 64 bits.
struct LBits {
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  uint64_t val = 0;
  int bit_pos = 0;
  bool eos = false;

  void init(const uint8_t* start, size_t length) {
    buf = start;
    len = length;
    val = 0;
    bit_pos = 0;
    eos = false;
    size_t n = std::min<size_t>(length, 8);
    for (size_t i = 0; i < n; i++) val |= uint64_t(start[i]) << (8 * i);
    pos = n;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > kLBits); }
  void set_eos() {
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= uint64_t(buf[pos]) << (kLBits - 8);
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_eos();
  }
  uint32_t prefetch() const { return uint32_t(val >> (bit_pos & (kLBits - 1))); }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_eos();
    return 0;
  }
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: appends the tables of a code to `out` and
// returns their size, or 0 for a code that is neither complete nor of a
// single symbol.
int build_huffman(std::vector<HCode>& out, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; s++) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(static_cast<size_t>(n));
  for (int s = 0; s < n; s++)
    if (lengths[s] > 0) sorted[size_t(offset[lengths[s]]++)] = uint16_t(s);
  int total_size = 1 << root_bits;
  size_t base = out.size();
  if (offset[kMaxCodeLength] == 1) {  // one symbol: a code of no bits
    out.resize(base + size_t(total_size));
    replicate(out.data() + base, 1, total_size, HCode{0, sorted[0]});
    return total_size;
  }
  // first pass: validity and the total size
  {
    int c[kMaxCodeLength + 1];
    std::memcpy(c, count, sizeof(c));
    int num_open = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      num_open <<= 1;
      num_open -= c[len];
      if (num_open < 0) return 0;
    }
    if (num_open != 0) return 0;
    uint32_t key = 0, mask = uint32_t(total_size - 1), low = 0xffffffffu;
    int size = total_size;
    for (int len = 1; len <= root_bits; ++len)
      for (; c[len] > 0; --c[len]) key = next_key(key, len);
    for (int len = root_bits + 1; len <= kMaxCodeLength; ++len)
      for (; c[len] > 0; --c[len]) {
        if ((key & mask) != low) {
          size += 1 << next_table_bits(c, len, root_bits);
          low = key & mask;
        }
        key = next_key(key, len);
      }
    out.resize(base + size_t(size));
  }
  HCode* root = out.data() + base;
  HCode* table = root;
  int table_bits = root_bits, table_size = 1 << table_bits;
  uint32_t key = 0, mask = uint32_t(total_size - 1), low = 0xffffffffu;
  int symbol = 0;
  for (int len = 1, step = 2; len <= root_bits; ++len, step <<= 1)
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, HCode{uint8_t(len), sorted[size_t(symbol++)]});
      key = next_key(key, len);
    }
  for (int len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1)
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        root[low].bits = uint8_t(table_bits + root_bits);
        root[low].value = uint16_t((table - root) - low);
      }
      replicate(&table[key >> root_bits], step, table_size,
                HCode{uint8_t(len - root_bits), sorted[size_t(symbol++)]});
      key = next_key(key, len);
    }
  return total_size;
}

int read_symbol(const HCode* table, LBits& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kHuffTableBits) - 1);
  int nbits = table->bits - kHuffTableBits;
  if (nbits > 0) {
    br.bit_pos += kHuffTableBits;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

struct HGroup {
  size_t offs[5];
};

// the prefix codes of one image: groups, meta image, colour cache
struct LMeta {
  std::vector<HCode> tables;
  std::vector<HGroup> groups;
  std::vector<uint32_t> meta;  // group of each tile, or empty
  int meta_bits = 0, meta_xsize = 0;
  int cache_bits = 0;
  bool trivial_rba = true;  // every group's red, blue and alpha codes have no bits

  const HCode* tree(int g, int t) const { return tables.data() + groups[size_t(g)].offs[t]; }
  int group_at(int x, int y) const {
    if (meta.empty()) return 0;
    return int(meta[size_t(meta_xsize * (y >> meta_bits) + (x >> meta_bits))]);
  }
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct VP8L {
  LBits br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  // pixels after the last symbol but one: set by decode_data (for alpha)
  bool eos_before_last = false;

  [[noreturn]] void fail(const char* what) { throw Unreadable(std::string("VP8L: ") + what); }

  bool read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    std::vector<HCode> t;
    if (!build_huffman(t, 7, cl_lengths, 19)) return false;
    int max_symbol;
    if (br.read(1)) {
      int nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(nbits));
      if (max_symbol > num_symbols) return false;
    } else {
      max_symbol = num_symbols;
    }
    int prev = 8, symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br.fill();
      const HCode& p = t[br.prefetch() & 127];
      br.bit_pos += p.bits;
      int code = p.value;
      if (code < 16) {
        lengths[symbol++] = code;
        if (code) prev = code;
      } else {
        static const int extra[3] = {2, 3, 7}, off[3] = {3, 3, 11};
        int slot = code - 16;
        int repeat = int(br.read(extra[slot])) + off[slot];
        if (symbol + repeat > num_symbols) return false;
        int v = code == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = v;
      }
    }
    return true;
  }

  // one prefix code into `tables`; returns its size (0: invalid)
  int read_code(int alphabet, std::vector<HCode>& tables, int* lengths) {
    std::memset(lengths, 0, sizeof(int) * size_t(alphabet));
    bool ok;
    if (br.read(1)) {  // simple code
      int num = int(br.read(1)) + 1;
      int first_bits = int(br.read(1));
      int s = int(br.read(first_bits ? 8 : 1));
      lengths[s] = 1;
      if (num == 2) lengths[br.read(8)] = 1;
      ok = true;
    } else {
      int cl[19] = {0};
      int num = int(br.read(4)) + 4;
      for (int i = 0; i < num; i++) cl[kCodeLengthOrder[i]] = int(br.read(3));
      ok = read_code_lengths(cl, alphabet, lengths);
    }
    if (!ok || br.eos) return 0;
    return build_huffman(tables, kHuffTableBits, lengths, alphabet);
  }

  void read_codes(int xsize, int ysize, int cache_bits, bool allow_meta, LMeta& m) {
    int num_groups = 1;
    if (allow_meta && br.read(1)) {
      int bits = 2 + int(br.read(3));
      int mx = subsample(xsize, bits), my = subsample(ysize, bits);
      m.meta = decode_stream(mx, my, false);
      m.meta_bits = bits;
      m.meta_xsize = mx;
      for (uint32_t& v : m.meta) {
        v = (v >> 8) & 0xffff;
        num_groups = std::max(num_groups, int(v) + 1);
      }
    }
    if (br.eos) fail("the stream ends inside its prefix codes");
    std::vector<int> lengths(size_t(kNumLiteral + kNumLength + (1 << kMaxCacheBits)));
    // libwebp stores (and checks for the alpha decoder's 8-bit path) only the
    // groups the meta image uses when there are over 1000 or more than pixels
    const bool mapped = num_groups > 1000 || num_groups > xsize * ysize;
    std::vector<bool> used(size_t(num_groups), !mapped);
    for (uint32_t v : m.meta) used[v] = true;
    m.groups.resize(size_t(num_groups));
    m.cache_bits = cache_bits;
    std::vector<HCode> scratch;
    for (int g = 0; g < num_groups; g++) {
      for (int j = 0; j < 5; j++) {
        int alphabet = kAlphabet[j] + (j == 0 && cache_bits > 0 ? 1 << cache_bits : 0);
        std::vector<HCode>& dst = used[size_t(g)] ? m.tables : scratch;
        size_t at = dst.size();
        if (!read_code(alphabet, dst, lengths.data())) fail("an invalid prefix code");
        m.groups[size_t(g)].offs[j] = at;
        if (!used[size_t(g)]) scratch.clear();
        else if ((j == RED || j == BLUE || j == ALPHA) && m.tables[at].bits > 0)
          m.trivial_rba = false;
      }
    }
  }

  // DecodeImageStream: the transforms (level 0 only), the colour cache and
  // the codes, then (below level 0) the pixels
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0, LMeta* level0_meta = nullptr,
                                      int* level0_xsize = nullptr) {
    int txsize = xsize;
    if (level0) {
      while (br.read(1)) read_transform(txsize, ysize);
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = int(br.read(4));
      if (cache_bits < 1 || cache_bits > kMaxCacheBits) fail("a colour cache of a bad size");
    }
    LMeta local;
    LMeta& m = level0 ? *level0_meta : local;
    read_codes(txsize, ysize, cache_bits, level0, m);
    if (level0) {
      *level0_xsize = txsize;
      return {};
    }
    std::vector<uint32_t> data(size_t(txsize) * size_t(ysize));
    decode_data(data.data(), txsize, ysize, m);
    if (br.eos) fail("the stream ends early");
    return data;
  }

  void read_transform(int& xsize, int ysize) {
    int type = int(br.read(2));
    if (seen & (1u << type)) fail("a transform used twice");
    seen |= 1u << type;
    Transform t{type, 0, xsize, ysize, {}};
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = int(br.read(3)) + 2;
      t.data = decode_stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false);
    } else if (type == 3) {  // colour indexing
      int num_colors = int(br.read(8)) + 1;
      int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      // ExpandColorMap: deltas summed bytewise; the rest transparent black
      int final_num = 1 << (8 >> bits);
      t.data.assign(size_t(final_num), 0);
      t.data[0] = pal[0];
      const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
      uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
      for (int i = 4; i < 4 * num_colors; i++) dst[i] = uint8_t(src[i] + dst[i - 4]);
    }
    transforms.push_back(std::move(t));
  }

  int copy_distance(int symbol) {
    if (symbol < 4) return symbol + 1;
    int extra = (symbol - 2) >> 1;
    int offset = (2 + (symbol & 1)) << extra;
    return offset + int(br.read(extra)) + 1;
  }

  static int plane_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    int d = kCodeToPlane[code - 1];
    int dist = (d >> 4) * xsize + 8 - (d & 0xf);
    return dist >= 1 ? dist : 1;
  }

  // DecodeImageData over the whole image; a reference past either end of
  // the image or an invalid symbol fails; end of stream stops decoding
  // (the callers decide what it means)
  void decode_data(uint32_t* data, int width, int height, const LMeta& m) {
    const int64_t end = int64_t(width) * height;
    int64_t pos = 0, last_cached = 0;
    int col = 0, row = 0;
    const int len_limit = kNumLiteral + kNumLength;
    const int cache_size = m.cache_bits ? 1 << m.cache_bits : 0;
    std::vector<uint32_t> cache(size_t(cache_size), 0);
    const int cache_shift = 32 - m.cache_bits;
    auto cache_upto = [&](int64_t upto) {
      for (; last_cached < upto; last_cached++)
        cache[(0x1e35a7bdu * data[last_cached]) >> cache_shift] = data[last_cached];
    };
    eos_before_last = false;
    // the current group's codes; red, blue and alpha codes of no bits are
    // read without the bit reader (as libwebp's trivial literals)
    int g_cur = -1;
    const HCode *t_green = nullptr, *t_red = nullptr, *t_blue = nullptr, *t_alpha = nullptr,
                *t_dist = nullptr;
    bool trivial = false;
    uint32_t rba = 0;
    while (pos < end) {
      const int g = m.group_at(col, row);
      if (g != g_cur) {
        g_cur = g;
        t_green = m.tree(g, GREEN);
        t_red = m.tree(g, RED);
        t_blue = m.tree(g, BLUE);
        t_alpha = m.tree(g, ALPHA);
        t_dist = m.tree(g, DIST);
        trivial = t_red->bits == 0 && t_blue->bits == 0 && t_alpha->bits == 0;
        rba = uint32_t(t_alpha->value) << 24 | uint32_t(t_red->value) << 16 | t_blue->value;
      }
      br.fill();
      int code = read_symbol(t_green, br);
      if (code < kNumLiteral) {
        if (trivial) {
          data[pos++] = rba | uint32_t(code) << 8;
        } else {
          int red = read_symbol(t_red, br);
          br.fill();
          int blue = read_symbol(t_blue, br);
          int alpha = read_symbol(t_alpha, br);
          data[pos++] =
              uint32_t(alpha) << 24 | uint32_t(red) << 16 | uint32_t(code) << 8 | uint32_t(blue);
        }
        if (++col >= width) {
          col = 0;
          ++row;
          if (cache_size) cache_upto(pos);
        }
      } else if (code < len_limit) {
        int length = copy_distance(code - kNumLiteral);
        int dist_symbol = read_symbol(t_dist, br);
        br.fill();
        int dist = plane_to_distance(width, copy_distance(dist_symbol));
        if (pos < dist || end - pos < length) fail("a backward reference past the image");
        for (int i = 0; i < length; i++) data[pos + i] = data[pos + i - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (cache_size) cache_upto(pos);
      } else if (code < len_limit + cache_size) {
        cache_upto(pos);
        data[pos++] = cache[size_t(code - len_limit)];
        if (++col >= width) {
          col = 0;
          ++row;
          if (cache_size) cache_upto(pos);
        }
      } else {
        fail("an invalid symbol");
      }
      if (br.at_end()) {
        br.eos = true;
        if (pos < end) eos_before_last = true;
        return;
      }
    }
  }

  // level 0: header-less (alpha) or after the 5-byte header
  std::vector<uint32_t> decode_image(int width, int height, bool alpha_plane) {
    LMeta m;
    int xsize = 0;
    decode_stream(width, height, true, &m, &xsize);
    std::vector<uint32_t> data(size_t(xsize) * size_t(height));
    decode_data(data.data(), xsize, height, m);
    // the alpha decoder's 8-bit path (only a colour-indexing transform, no
    // colour cache, one-symbol red, blue and alpha codes) may end inside
    // its last symbol; every other image fails at the end of its stream
    bool eight_bit = alpha_plane && transforms.size() == 1 && transforms[0].type == 3 &&
                     m.cache_bits == 0 && m.trivial_rba;
    if (eight_bit ? eos_before_last : br.eos) fail("the stream ends early");
    for (size_t i = transforms.size(); i-- > 0;) inverse(transforms[i], data, height);
    return data;
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
  static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
    int s = 0;
    for (int sh = 0; sh < 32; sh += 8) {
      int av = int(a >> sh & 0xff), bv = int(b >> sh & 0xff), cv = int(c >> sh & 0xff);
      s += std::abs(bv - cv) - std::abs(av - cv);
    }
    return s <= 0 ? a : b;
  }
  static uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int sh = 0; sh < 32; sh += 8)
      out |= uint32_t(clip255(int(a >> sh & 0xff) + int(b >> sh & 0xff) - int(c >> sh & 0xff))) << sh;
    return out;
  }
  static uint32_t add_sub_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int sh = 0; sh < 32; sh += 8) {
      int av = int(a >> sh & 0xff), bv = int(b >> sh & 0xff);
      out |= uint32_t(clip255(av + (av - bv) / 2)) << sh;
    }
    return out;
  }
  template <int M>
  static uint32_t predict(const uint32_t* row, int x, int width) {
    const uint32_t* top = row - width;
    const uint32_t L = row[x - 1], T = top[x], TL = top[x - 1], TR = top[x + 1];
    switch (M) {
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return avg2(avg2(L, TR), T);
      case 6: return avg2(L, TL);
      case 7: return avg2(L, T);
      case 8: return avg2(TL, T);
      case 9: return avg2(T, TR);
      case 10: return avg2(avg2(L, TL), avg2(T, TR));
      case 11: return select(T, L, TL);
      case 12: return add_sub_full(L, T, TL);
      case 13: return add_sub_half(avg2(L, T), TL);
      default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
    }
  }
  template <int M>
  static void predict_run(uint32_t* row, int x, int x_end, int width) {
    for (; x < x_end; ++x) row[x] = add(row[x], predict<M>(row, x, width));
  }
  static void predict_run(int mode, uint32_t* row, int x, int x_end, int width) {
    switch (mode) {
      case 1: return predict_run<1>(row, x, x_end, width);
      case 2: return predict_run<2>(row, x, x_end, width);
      case 3: return predict_run<3>(row, x, x_end, width);
      case 4: return predict_run<4>(row, x, x_end, width);
      case 5: return predict_run<5>(row, x, x_end, width);
      case 6: return predict_run<6>(row, x, x_end, width);
      case 7: return predict_run<7>(row, x, x_end, width);
      case 8: return predict_run<8>(row, x, x_end, width);
      case 9: return predict_run<9>(row, x, x_end, width);
      case 10: return predict_run<10>(row, x, x_end, width);
      case 11: return predict_run<11>(row, x, x_end, width);
      case 12: return predict_run<12>(row, x, x_end, width);
      case 13: return predict_run<13>(row, x, x_end, width);
      default: return predict_run<0>(row, x, x_end, width);
    }
  }

  // the inverse of one transform, in place (colour indexing widens rows)
  static void inverse(const Transform& t, std::vector<uint32_t>& data, int height) {
    const int width = t.xsize;
    if (t.type == 0) {
      uint32_t* out = data.data();
      out[0] = add(out[0], 0xff000000u);
      for (int x = 1; x < width; x++) out[x] = add(out[x], out[x - 1]);
      const int tiles = subsample(width, t.bits);
      for (int y = 1; y < height; y++) {
        uint32_t* row = out + int64_t(y) * width;
        const uint32_t* modes = t.data.data() + int64_t(y >> t.bits) * tiles;
        row[0] = add(row[0], row[-width]);
        for (int x = 1; x < width;) {
          const int x_end = std::min(((x >> t.bits) + 1) << t.bits, width);
          predict_run(int(modes[x >> t.bits] >> 8 & 0xf), row, x, x_end, width);
          x = x_end;
        }
      }
    } else if (t.type == 1) {
      const int tiles = subsample(width, t.bits);
      for (int y = 0; y < height; y++) {
        uint32_t* row = data.data() + int64_t(y) * width;
        const uint32_t* codes = t.data.data() + int64_t(y >> t.bits) * tiles;
        for (int x = 0; x < width; x++) {
          uint32_t c = codes[x >> t.bits];
          int8_t g2r = int8_t(c & 0xff), g2b = int8_t(c >> 8 & 0xff), r2b = int8_t(c >> 16 & 0xff);
          uint32_t argb = row[x];
          int8_t green = int8_t(argb >> 8);
          int r = int(argb >> 16 & 0xff), b = int(argb & 0xff);
          r = (r + ((int(g2r) * green) >> 5)) & 0xff;
          b += (int(g2b) * green) >> 5;
          b += (int(r2b) * int8_t(r)) >> 5;
          b &= 0xff;
          row[x] = (argb & 0xff00ff00u) | uint32_t(r) << 16 | uint32_t(b);
        }
      }
    } else if (t.type == 2) {
      for (uint32_t& v : data) {
        uint32_t g = v >> 8 & 0xff;
        uint32_t r = ((v >> 16) + g) & 0xff, b = (v + g) & 0xff;
        v = (v & 0xff00ff00u) | r << 16 | b;
      }
    } else {
      const uint32_t* map = t.data.data();
      if (t.bits == 0) {
        for (uint32_t& v : data) v = map[v >> 8 & 0xff];
        return;
      }
      const int packed = subsample(width, t.bits);
      const int bpp = 8 >> t.bits;
      const int count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bpp) - 1;
      std::vector<uint32_t> out(size_t(width) * size_t(height));
      for (int y = 0; y < height; y++) {
        const uint32_t* src = data.data() + int64_t(y) * packed;
        uint32_t* dst = out.data() + int64_t(y) * width;
        uint32_t bundle = 0;
        for (int x = 0; x < width; x++) {
          if ((x & count_mask) == 0) bundle = *src++ >> 8 & 0xff;
          dst[x] = map[bundle & bit_mask];
          bundle >>= bpp;
        }
      }
      data.swap(out);
    }
  }
};

// the 5-byte header of a VP8L stream: (width, height, alpha), or false
bool vp8l_info(const uint8_t* d, size_t n, int* w, int* h, int* alpha) {
  if (n < 5 || d[0] != 0x2f || (d[4] >> 5) != 0) return false;
  LBits br;
  br.init(d, n);
  if (br.read(8) != 0x2f) return false;
  *w = int(br.read(14)) + 1;
  *h = int(br.read(14)) + 1;
  *alpha = int(br.read(1));
  if (br.read(3) != 0) return false;
  return !br.eos;
}

// a VP8L stream (with its header) to ARGB
std::vector<uint32_t> decode_vp8l(const uint8_t* d, size_t n, int* w, int* h) {
  int alpha;
  if (!vp8l_info(d, n, w, h, &alpha)) throw Unreadable("VP8L: bad header");
  VP8L dec;
  dec.br.init(d, n);
  dec.br.read(8);
  dec.br.read(14);
  dec.br.read(14);
  dec.br.read(1);
  dec.br.read(3);
  return dec.decode_image(*w, *h, false);
}

// ============================================================== VP8

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
// the token probabilities: RFC 6386 13.4 (updates) and 13.5 (defaults), then
// the 4x4 mode probabilities [top][left][9] (11.5) in libwebp's mode order
const uint8_t kCoeffsUpdateProba[1056] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kCoeffsProba0[1056] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kBModesProba[900] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's mode numbers (4x4 modes; the 16x16 and chroma modes share the
// first four)
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED, DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

// the boolean decoder of libwebp (bit_t of 64 bits); eof is set when a bit
// is read past the end of the data, after which it reads zeros
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 255 - 1;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    range = 255 - 1;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    int pos = bits;
    uint32_t split = (r * uint32_t(prob)) >> 8;
    uint32_t v = uint32_t(value >> pos);
    int bit = v > split;
    if (bit) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {
    if (bits < 0) load();
    int pos = bits;
    uint32_t split = range >> 1;
    uint32_t val = uint32_t(value >> pos);
    int32_t mask = int32_t(split - val) >> 31;
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get_bit(0x80)) << n;
    return v;
  }
  int get_signed_value(int n) {
    int v = int(get_value(n));
    return get_value(1) ? -v : v;
  }
};

constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCTs, as libwebp's decoder runs them on x86-64: a block with
// more than three coefficients (and every chroma block of a macroblock with
// an AC coefficient) through Transform_SSE2, in 16-bit lanes that wrap and
// a sum that saturates; up to three (AC3) and DC-only blocks through the C
// code in int.  They agree wherever the 16-bit sums do not wrap.
inline int16_t w16(int v) { return int16_t(uint16_t(v)); }
inline int16_t mulhi(int16_t x, int k) { return int16_t((int32_t(x) * k) >> 16); }

void idct_add_sse2(const int16_t* in, uint8_t* dst) {
  int16_t col[4][4];  // [column][output]
  for (int j = 0; j < 4; ++j) {
    const int16_t i0 = in[j], i1 = in[4 + j], i2 = in[8 + j], i3 = in[12 + j];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
    col[j][0] = w16(a + d);
    col[j][1] = w16(b + c);
    col[j][2] = w16(b - c);
    col[j][3] = w16(a - d);
  }
  for (int i = 0; i < 4; ++i) {
    const int16_t t0 = col[0][i], t1 = col[1][i], t2 = col[2][i], t3 = col[3][i];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t c = w16(w16(t1 - t3) + w16(mulhi(t1, -30068) - mulhi(t3, 20091)));
    const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, 20091) + mulhi(t3, -30068)));
    const int16_t out[4] = {int16_t(w16(a + d) >> 3), int16_t(w16(b + c) >> 3),
                            int16_t(w16(b - c) >> 3), int16_t(w16(a - d) >> 3)};
    for (int k = 0; k < 4; ++k) dst[k] = clip8(w16(dst[k] + out[k]));
    dst += BPS;
  }
}

// TransformAC3_C: coefficients 0, 1 and 4 only
void idct_add_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    const int DC = rows[y];
    dst[0] = clip8(dst[0] + ((DC + d1) >> 3));
    dst[1] = clip8(dst[1] + ((DC + c1) >> 3));
    dst[2] = clip8(dst[2] + ((DC - c1) >> 3));
    dst[3] = clip8(dst[3] + ((DC - d1) >> 3));
    dst += BPS;
  }
}

// TransformDC_C
void idct_add_dc(const int16_t* in, uint8_t* dst) {
  const int DC = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(dst[x + y * BPS] + (DC >> 3));
}

// DoTransform: by the block's two non-zero bits (3: more than three
// coefficients, 2: two or three, 1: the DC alone)
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: idct_add_sse2(src, dst); break;
    case 2: idct_add_ac3(src, dst); break;
    case 1: idct_add_dc(src, dst); break;
    default: break;
  }
}

// DoUVTransform over the four blocks of one chroma plane
void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (bits & 0xaa) idct_add_sse2(src + n * 16, d);
    else if (src[n * 16]) idct_add_dc(src + n * 16, d);
  }
}

void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// intra predictors on the BPS work buffer
void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size_t(size));
}

void pred_luma16(int mode, uint8_t* dst) {
  switch (mode) {
    case DC_PRED: {
      int dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, 16, dc >> 5);
      break;
    }
    case TM_PRED: true_motion(dst, 16); break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, 16, dc >> 4);
      break;
    }
    case DC_NOLEFT: {
      int dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill(dst, 16, dc >> 4);
      break;
    }
    default: fill(dst, 16, 0x80); break;
  }
}

void pred_chroma8(int mode, uint8_t* dst) {
  switch (mode) {
    case DC_PRED: {
      int dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 8, dc >> 4);
      break;
    }
    case TM_PRED: true_motion(dst, 8); break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_NOTOP: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill(dst, 8, dc >> 3);
      break;
    }
    case DC_NOLEFT: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill(dst, 8, dc >> 3);
      break;
    }
    default: fill(dst, 8, 0x80); break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void pred_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS], I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {uint8_t(avg3(X, A, B)), uint8_t(avg3(A, B, C)),
                               uint8_t(avg3(B, C, D)), uint8_t(avg3(C, D, E))};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = uint8_t(avg3(J, K, L));
      DST(1, 3) = DST(0, 2) = uint8_t(avg3(I, J, K));
      DST(2, 3) = DST(1, 2) = DST(0, 1) = uint8_t(avg3(X, I, J));
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = uint8_t(avg3(A, X, I));
      DST(3, 2) = DST(2, 1) = DST(1, 0) = uint8_t(avg3(B, A, X));
      DST(3, 1) = DST(2, 0) = uint8_t(avg3(C, B, A));
      DST(3, 0) = uint8_t(avg3(D, C, B));
      break;
    case B_LD_PRED:
      DST(0, 0) = uint8_t(avg3(A, B, C));
      DST(1, 0) = DST(0, 1) = uint8_t(avg3(B, C, D));
      DST(2, 0) = DST(1, 1) = DST(0, 2) = uint8_t(avg3(C, D, E));
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = uint8_t(avg3(D, E, F));
      DST(3, 1) = DST(2, 2) = DST(1, 3) = uint8_t(avg3(E, F, G));
      DST(3, 2) = DST(2, 3) = uint8_t(avg3(F, G, H));
      DST(3, 3) = uint8_t(avg3(G, H, H));
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = uint8_t(avg2(X, A));
      DST(1, 0) = DST(2, 2) = uint8_t(avg2(A, B));
      DST(2, 0) = DST(3, 2) = uint8_t(avg2(B, C));
      DST(3, 0) = uint8_t(avg2(C, D));
      DST(0, 3) = uint8_t(avg3(K, J, I));
      DST(0, 2) = uint8_t(avg3(J, I, X));
      DST(0, 1) = DST(1, 3) = uint8_t(avg3(I, X, A));
      DST(1, 1) = DST(2, 3) = uint8_t(avg3(X, A, B));
      DST(2, 1) = DST(3, 3) = uint8_t(avg3(A, B, C));
      DST(3, 1) = uint8_t(avg3(B, C, D));
      break;
    case B_VL_PRED:
      DST(0, 0) = uint8_t(avg2(A, B));
      DST(1, 0) = DST(0, 2) = uint8_t(avg2(B, C));
      DST(2, 0) = DST(1, 2) = uint8_t(avg2(C, D));
      DST(3, 0) = DST(2, 2) = uint8_t(avg2(D, E));
      DST(0, 1) = uint8_t(avg3(A, B, C));
      DST(1, 1) = DST(0, 3) = uint8_t(avg3(B, C, D));
      DST(2, 1) = DST(1, 3) = uint8_t(avg3(C, D, E));
      DST(3, 1) = DST(2, 3) = uint8_t(avg3(D, E, F));
      DST(3, 2) = uint8_t(avg3(E, F, G));
      DST(3, 3) = uint8_t(avg3(F, G, H));
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = uint8_t(avg2(I, X));
      DST(0, 1) = DST(2, 2) = uint8_t(avg2(J, I));
      DST(0, 2) = DST(2, 3) = uint8_t(avg2(K, J));
      DST(0, 3) = uint8_t(avg2(L, K));
      DST(3, 0) = uint8_t(avg3(A, B, C));
      DST(2, 0) = uint8_t(avg3(X, A, B));
      DST(1, 0) = DST(3, 1) = uint8_t(avg3(I, X, A));
      DST(1, 1) = DST(3, 2) = uint8_t(avg3(J, I, X));
      DST(1, 2) = DST(3, 3) = uint8_t(avg3(K, J, I));
      DST(1, 3) = uint8_t(avg3(L, K, J));
      break;
    default:  // B_HU_PRED
      DST(0, 0) = uint8_t(avg2(I, J));
      DST(2, 0) = DST(0, 1) = uint8_t(avg2(J, K));
      DST(2, 1) = DST(0, 2) = uint8_t(avg2(K, L));
      DST(1, 0) = uint8_t(avg3(I, J, K));
      DST(3, 0) = DST(1, 1) = uint8_t(avg3(J, K, L));
      DST(3, 1) = DST(1, 2) = uint8_t(avg3(K, L, L));
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
  }
}
#undef DST

// ---- loop filters (dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int step, int across, int thresh) {  // 16 positions
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * across, step, t2)) do_filter2(p + i * across, step);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
      else if (edge) do_filter6(p, hstride);
      else do_filter4(p, hstride);
    }
    p += vstride;
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;  // two bits a block (DoTransform's)
};

struct VP8Frame {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y, u, v;  // mb_w * 16 by mb_h * 16, and half of that
  int y_stride = 0, uv_stride = 0;
};

struct VP8Dec {
  BoolReader br;
  std::vector<BoolReader> parts;
  int num_parts_minus_one = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  // quantisers [segment] -> y1 (dc, ac), y2, uv
  int y1[4][2], y2[4][2], uv[4][2];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  [[noreturn]] void fail(const char* what) { throw Unreadable(std::string("VP8: ") + what); }

  void parse_segment_header() {
    use_segment = br.get_value(1);
    if (use_segment) {
      update_map = br.get_value(1);
      if (br.get_value(1)) {
        absolute_delta = br.get_value(1);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) segment_proba[s] = uint8_t(br.get_value(1) ? br.get_value(8) : 255u);
    } else {
      update_map = false;
    }
    if (br.eof) fail("cannot parse segment header");
  }

  void parse_filter_header() {
    simple = br.get_value(1);
    level = int(br.get_value(6));
    sharpness = int(br.get_value(3));
    use_lf_delta = br.get_value(1);
    if (use_lf_delta && br.get_value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail("cannot parse filter header");
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    num_parts_minus_one = (1 << br.get_value(2)) - 1;
    const size_t last = size_t(num_parts_minus_one);
    if (size < 3 * last) fail("cannot parse partitions");
    const uint8_t* sz = buf;
    const uint8_t* part_start = buf + last * 3;
    size_t left = size - last * 3;
    parts.assign(last + 1, BoolReader());
    for (size_t p = 0; p < last; ++p) {
      size_t psize = size_t(sz[0]) | size_t(sz[1]) << 8 | size_t(sz[2]) << 16;
      if (psize > left) psize = left;
      parts[p].init(part_start, psize);
      part_start += psize;
      left -= psize;
      sz += 3;
    }
    parts[last].init(part_start, left);
    if (part_start >= buf + size) fail("cannot parse partitions (the last one is empty)");
  }

  void parse_quant() {
    const int base_q0 = int(br.get_value(7));
    const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else if (i > 0) {
        std::memcpy(y1[i], y1[0], sizeof(y1[0]));
        std::memcpy(y2[i], y2[0], sizeof(y2[0]));
        std::memcpy(uv[i], uv[0], sizeof(uv[0]));
        continue;
      } else {
        q = base_q0;
      }
      y1[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
      y1[i][1] = kAcTable[clip(q, 127)];
      y2[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      y2[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (y2[i][1] < 8) y2[i][1] = 8;
      uv[i][0] = kDcTable[clip(q + dquv_dc, 117)];
      uv[i][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = uint8_t(br.get_bit(kCoeffsUpdateProba[i]) ? br.get_value(8)
                                                                        : kCoeffsProba0[i]);
          }
    use_skip_proba = br.get_value(1);
    if (use_skip_proba) skip_p = int(br.get_value(8));
  }

  void precompute_filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int lv = base_level;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4x4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int ilevel = lv;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lv + ilevel;
          info.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  // ---- per macroblock parsing
  std::vector<uint8_t> intra_t;  // 4 per macroblock column
  uint8_t intra_l[4];

  void parse_intra_mode(MBData& block, int mb_x) {
    uint8_t* top = intra_t.data() + 4 * mb_x;
    uint8_t* left = intra_l;
    if (update_map) {
      block.segment = uint8_t(!br.get_bit(segment_proba[0]) ? br.get_bit(segment_proba[1])
                                                            : br.get_bit(segment_proba[2]) + 2);
    } else {
      block.segment = 0;
    }
    block.skip = use_skip_proba ? uint8_t(br.get_bit(skip_p)) : 0;
    block.is_i4x4 = !br.get_bit(145);
    if (!block.is_i4x4) {
      const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                        : (br.get_bit(163) ? V_PRED : DC_PRED);
      block.imodes[0] = uint8_t(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          ymode = !br.get_bit(prob[0])   ? B_DC_PRED
                  : !br.get_bit(prob[1]) ? B_TM_PRED
                  : !br.get_bit(prob[2]) ? B_VE_PRED
                  : !br.get_bit(prob[3])
                      ? (!br.get_bit(prob[4]) ? B_HE_PRED
                                              : (!br.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                      : (!br.get_bit(prob[6])
                             ? B_LD_PRED
                             : (!br.get_bit(prob[7]) ? B_VL_PRED
                                                     : (!br.get_bit(prob[8]) ? B_HD_PRED
                                                                             : B_HU_PRED)));
          top[x] = uint8_t(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = uint8_t(ymode);
      }
    }
    block.uvmode = uint8_t(!br.get_bit(142)   ? DC_PRED
                           : !br.get_bit(114) ? V_PRED
                           : br.get_bit(183)  ? TM_PRED
                                              : H_PRED);
  }

  static int large_value(BoolReader& tb, const uint8_t* p) {
    int v;
    if (!tb.get_bit(p[3])) {
      v = !tb.get_bit(p[4]) ? 2 : 3 + tb.get_bit(p[5]);
    } else if (!tb.get_bit(p[6])) {
      if (!tb.get_bit(p[7])) {
        v = 5 + tb.get_bit(159);
      } else {
        v = 7 + 2 * tb.get_bit(165);
        v += tb.get_bit(145);
      }
    } else {
      const int bit1 = tb.get_bit(p[8]);
      const int bit0 = tb.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb.get_bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // GetCoeffs: the index after the last non-zero coefficient
  int get_coeffs(BoolReader& tb, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tb.get_bit(p[0])) return n;
      while (!tb.get_bit(p[1])) {
        ++n;
        p = proba[type][kBands[n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!tb.get_bit(p[2])) {
        v = 1;
        p = proba[type][kBands[n + 1]][1];
      } else {
        v = large_value(tb, p);
        p = proba[type][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = int16_t(tb.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  // nz flags: bits 0-3 luma columns (top) / rows (left), 4-5 u, 6-7 v
  struct NZ {
    uint8_t nz = 0, nz_dc = 0;
  };
  std::vector<NZ> top_nz;
  NZ left_nz;

  // returns true when the macroblock has no non-zero coefficient
  bool parse_residuals(BoolReader& tb, MBData& block, NZ& mb, NZ& left) {
    const int s = block.segment;
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof(block.coeffs));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left.nz_dc;
      const int nz = get_coeffs(tb, 1, ctx, y2[s], 0, dc);
      mb.nz_dc = left.nz_dc = nz > 0;
      if (nz > 1) {
        inverse_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    auto nz_code = [](uint32_t nzc, int nz, bool dc_nz) {
      nzc <<= 2;
      return nzc | uint32_t(nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
    };
    uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nzc = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tb, ac_type, ctx, y1[s], first, dst);
        l = nz > first;
        tnz = uint8_t((tnz >> 1) | (l << 7));
        nzc = nz_code(nzc, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = uint8_t((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nzc;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nzc = 0;
      tnz = uint8_t(mb.nz >> (4 + ch));
      lnz = uint8_t(left.nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(tb, 2, ctx, uv[s], 0, dst);
          l = nz > 0;
          tnz = uint8_t((tnz >> 1) | (l << 3));
          nzc = nz_code(nzc, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = uint8_t((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nzc << (4 * ch);
      out_t_nz |= uint32_t(tnz << 4) << ch;
      out_l_nz |= uint32_t(lnz & 0xf0) << ch;
    }
    mb.nz = uint8_t(out_t_nz);
    left.nz = uint8_t(out_l_nz);
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  // ---- reconstruction (ReconstructRow on libwebp's work buffer)
  uint8_t yuv_b[YUV_SIZE];
  struct Top {
    uint8_t y[16], u[8], v[8];
  };
  std::vector<Top> yuv_t;

  void reconstruct_row(int mb_y, std::vector<MBData>& row, VP8Frame& f) {
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      const MBData& block = row[size_t(mb_x)];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      Top* top_yuv = yuv_t.data() + mb_x;
      const int16_t* coeffs = block.coeffs;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_yuv[0].y, 16);
        std::memcpy(u_dst - BPS, top_yuv[0].u, 8);
        std::memcpy(v_dst - BPS, top_yuv[0].v, 8);
      }
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= f.mb_w - 1) std::memset(top_right, top_yuv[0].y[15], 4);
          else std::memcpy(top_right, top_yuv[1].y, 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        uint32_t bits = block.non_zero_y;
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          pred_luma4(block.imodes[n], dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        pred_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        uint32_t bits = block.non_zero_y;
        for (int n = 0; n < 16; ++n, bits <<= 2)
          do_transform(bits, coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
      pred_chroma8(uvmode, u_dst);
      pred_chroma8(uvmode, v_dst);
      do_uv_transform(block.non_zero_uv, coeffs + 256, u_dst);
      do_uv_transform(block.non_zero_uv >> 8, coeffs + 320, v_dst);
      if (mb_y < f.mb_h - 1) {
        std::memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
        std::memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
        std::memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&f.y[size_t((mb_y * 16 + j) * f.y_stride + mb_x * 16)], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&f.u[size_t((mb_y * 8 + j) * f.uv_stride + mb_x * 8)], u_dst + j * BPS, 8);
        std::memcpy(&f.v[size_t((mb_y * 8 + j) * f.uv_stride + mb_x * 8)], v_dst + j * BPS, 8);
      }
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? DC_NOTOP : DC_PRED;
    }
    return mode;
  }

  void filter_mb(VP8Frame& f, int mb_x, int mb_y, const FInfo& fi) {
    const int limit = fi.limit;
    if (limit == 0) return;
    const int ys = f.y_stride, uvs = f.uv_stride;
    uint8_t* y_dst = f.y.data() + (mb_y * 16) * ys + mb_x * 16;
    if (filter_type == 1) {
      if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
      if (fi.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
      if (fi.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* u_dst = f.u.data() + (mb_y * 8) * uvs + mb_x * 8;
    uint8_t* v_dst = f.v.data() + (mb_y * 8) * uvs + mb_x * 8;
    const int il = fi.ilevel, ht = fi.hev_thresh;
    if (mb_x > 0) {
      filter_loop(y_dst, 1, ys, 16, limit + 4, il, ht, true);
      filter_loop(u_dst, 1, uvs, 8, limit + 4, il, ht, true);
      filter_loop(v_dst, 1, uvs, 8, limit + 4, il, ht, true);
    }
    if (fi.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k, 1, ys, 16, limit, il, ht, false);
      filter_loop(u_dst + 4, 1, uvs, 8, limit, il, ht, false);
      filter_loop(v_dst + 4, 1, uvs, 8, limit, il, ht, false);
    }
    if (mb_y > 0) {
      filter_loop(y_dst, ys, 1, 16, limit + 4, il, ht, true);
      filter_loop(u_dst, uvs, 1, 8, limit + 4, il, ht, true);
      filter_loop(v_dst, uvs, 1, 8, limit + 4, il, ht, true);
    }
    if (fi.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
      filter_loop(u_dst + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
      filter_loop(v_dst + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    }
  }

  // VP8GetHeaders then VP8Decode over `data` (the image chunk's payload to
  // the end of the data); the frame's planes after the loop filter
  VP8Frame decode(const uint8_t* data, size_t size) {
    VP8Frame f;
    if (size < 4) fail("truncated header");
    const uint32_t bits = uint32_t(data[0]) | uint32_t(data[1]) << 8 | uint32_t(data[2]) << 16;
    const bool key_frame = !(bits & 1);
    const uint32_t profile = (bits >> 1) & 7, show = (bits >> 4) & 1, part_len = bits >> 5;
    if (profile > 3) fail("incorrect keyframe parameters");
    if (!show) fail("frame not displayable");
    const uint8_t* buf = data + 3;
    size_t buf_size = size - 3;
    if (key_frame) {
      if (buf_size < 7) fail("cannot parse picture header");
      if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) fail("bad code word");
      f.width = int(((buf[4] << 8) | buf[3]) & 0x3fff);
      f.height = int(((buf[6] << 8) | buf[5]) & 0x3fff);
      buf += 7;
      buf_size -= 7;
      f.mb_w = (f.width + 15) >> 4;
      f.mb_h = (f.height + 15) >> 4;
    }
    if (part_len > buf_size) fail("bad partition length");
    br.init(buf, part_len);
    buf += part_len;
    buf_size -= part_len;
    if (key_frame) {
      br.get_value(1);  // colour space
      br.get_value(1);  // clamping type
    }
    parse_segment_header();
    parse_filter_header();
    parse_partitions(buf, buf_size);
    parse_quant();
    if (!key_frame) fail("not a key frame");
    br.get_value(1);  // update_proba, ignored
    parse_proba();
    if (f.width == 0 || f.height == 0) fail("a frame of no pixels");

    precompute_filter_strengths();
    f.y_stride = f.mb_w * 16;
    f.uv_stride = f.mb_w * 8;
    f.y.assign(size_t(f.y_stride) * size_t(f.mb_h * 16), 0);
    f.u.assign(size_t(f.uv_stride) * size_t(f.mb_h * 8), 0);
    f.v.assign(size_t(f.uv_stride) * size_t(f.mb_h * 8), 0);
    intra_t.assign(size_t(4 * f.mb_w), B_DC_PRED);
    top_nz.assign(size_t(f.mb_w), NZ());
    yuv_t.assign(size_t(f.mb_w), Top());
    std::memset(yuv_b, 0, sizeof(yuv_b));
    std::vector<MBData> row(size_t(f.mb_w));
    std::vector<FInfo> finfo(size_t(f.mb_w) * size_t(f.mb_h));
    std::memset(intra_l, B_DC_PRED, 4);
    left_nz = NZ();
    for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
      BoolReader& tb = parts[size_t(mb_y & num_parts_minus_one)];
      for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) parse_intra_mode(row[size_t(mb_x)], mb_x);
      if (br.eof) fail("premature end of partition 0");
      for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
        MBData& block = row[size_t(mb_x)];
        NZ& mb = top_nz[size_t(mb_x)];
        bool skip = use_skip_proba ? block.skip : false;
        if (!skip) {
          skip = parse_residuals(tb, block, mb, left_nz);
        } else {
          left_nz.nz = mb.nz = 0;
          if (!block.is_i4x4) left_nz.nz_dc = mb.nz_dc = 0;
          block.non_zero_y = block.non_zero_uv = 0;
        }
        if (filter_type > 0) {
          FInfo fi = fstrengths[block.segment][block.is_i4x4];
          fi.inner |= !skip;
          finfo[size_t(mb_y * f.mb_w + mb_x)] = fi;
        }
        if (tb.eof) fail("premature end of file");
      }
      left_nz = NZ();
      std::memset(intra_l, B_DC_PRED, 4);
      reconstruct_row(mb_y, row, f);
    }
    if (filter_type > 0)
      for (int mb_y = 0; mb_y < f.mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < f.mb_w; ++mb_x)
          filter_mb(f, mb_x, mb_y, finfo[size_t(mb_y * f.mb_w + mb_x)]);
    return f;
  }
};

// VP8GetInfo: the frame tag and size of a VP8 stream's first 10 bytes
bool vp8_info(const uint8_t* d, size_t n, size_t chunk_size, int* w, int* h) {
  if (n < 10) return false;
  if (!(d[3] == 0x9d && d[4] == 0x01 && d[5] == 0x2a)) return false;
  const uint32_t bits = uint32_t(d[0]) | uint32_t(d[1]) << 8 | uint32_t(d[2]) << 16;
  if (bits & 1) return false;
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size) return false;
  *w = ((d[7] << 8) | d[6]) & 0x3fff;
  *h = ((d[9] << 8) | d[8]) & 0x3fff;
  return *w != 0 && *h != 0;
}

// ---- YUV 4:2:0 -> BGR (libwebp's yuv.h and the fancy upsampler)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return uint8_t((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  bgr[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  bgr[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  bgr[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleBgrLinePair on one chroma channel pair at a time
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_bgr(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_bgr(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_bgr(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + (2 * x - 1) * 3);
    yuv_to_bgr(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + (2 * x) * 3);
    if (bottom_y) {
      yuv_to_bgr(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_bgr(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + (2 * x) * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_bgr(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + (len - 1) * 3);
    if (bottom_y)
      yuv_to_bgr(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + (len - 1) * 3);
  }
}

// the frame's BGR, `stride` bytes a row
void vp8_to_bgr(const VP8Frame& f, uint8_t* out, int64_t stride) {
  const int w = f.width, h = f.height;
  const uint8_t* Y = f.y.data();
  const uint8_t* U = f.u.data();
  const uint8_t* V = f.v.data();
  const int ys = f.y_stride, uvs = f.uv_stride;
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const uint8_t* tu = U + (y / 2) * uvs;
    const uint8_t* tv = V + (y / 2) * uvs;
    upsample_pair(Y + (y + 1) * ys, Y + (y + 2) * ys, tu, tv, tu + uvs, tv + uvs,
                  out + (y + 1) * stride, out + (y + 2) * stride, w);
  }
  if (!(h & 1)) {
    const uint8_t* cu = U + (y / 2) * uvs;
    const uint8_t* cv = V + (y / 2) * uvs;
    upsample_pair(Y + (y + 1) * ys, nullptr, cu, cv, cu, cv, out + (y + 1) * stride, nullptr, w);
  }
}

// ============================================================== ALPH

// an ALPH chunk's plane (width * height), or Unreadable where libwebp fails
std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t size, int width, int height) {
  if (size <= 1) throw Unreadable("ALPH: empty");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) throw Unreadable("ALPH: bad header");
  const size_t n = size_t(width) * size_t(height);
  std::vector<uint8_t> deltas(n);
  if (method == 0) {
    if (size - 1 < n) throw Unreadable("ALPH: raw plane too short");
    std::memcpy(deltas.data(), data + 1, n);
  } else {
    VP8L dec;
    dec.br.init(data + 1, size - 1);
    std::vector<uint32_t> argb = dec.decode_image(width, height, true);
    for (size_t i = 0; i < n; i++) deltas[i] = uint8_t(argb[i] >> 8);
  }
  // unfilter (none, horizontal, vertical, gradient)
  std::vector<uint8_t> out(n);
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = deltas.data() + size_t(y) * size_t(width);
    uint8_t* o = out.data() + size_t(y) * size_t(width);
    const uint8_t* prev = y ? o - width : nullptr;
    if (filter == 0) {
      std::memcpy(o, in, size_t(width));
    } else if (filter == 1 || !prev) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int i = 0; i < width; ++i) pred = o[i] = uint8_t(pred + in[i]);
    } else if (filter == 2) {
      for (int i = 0; i < width; ++i) o[i] = uint8_t(prev[i] + in[i]);
    } else {
      int top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        left = uint8_t(in[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        o[i] = uint8_t(left);
      }
    }
  }
  return out;
}

// ============================================================== container

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
enum { FLAG_ANIM = 0x02, FLAG_XMP = 0x04, FLAG_EXIF = 0x08, FLAG_ALPHA = 0x10, FLAG_ICCP = 0x20 };

enum Status { OK, NOT_ENOUGH_DATA, BITSTREAM_ERROR, UNSUPPORTED };

struct Headers {
  int width = 0, height = 0, has_alpha = 0, has_animation = 0;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  size_t offset = 0;  // of the image's bit stream
  bool lossless = false;
};

// ParseHeadersInternal (webp_dec.c); `full` is have_all_data with headers
Status parse_headers(const uint8_t* data, size_t data_size, bool full, Headers& hd) {
  const uint8_t* const start = data;
  if (data_size < 12) return NOT_ENOUGH_DATA;
  size_t riff_size = 0;
  bool found_riff = false, found_vp8x = false;
  int canvas_w = 0, canvas_h = 0, image_w = 0, image_h = 0;
  bool animation = false;
  Status status = OK;
  // ParseRIFF
  if (!std::memcmp(data, "RIFF", 4)) {
    if (std::memcmp(data + 8, "WEBP", 4)) return BITSTREAM_ERROR;
    const uint32_t size = le32(data + 4);
    if (size < 4 + 8 || size > kMaxChunkPayload) return BITSTREAM_ERROR;
    if (full && size > data_size - 8) return NOT_ENOUGH_DATA;
    riff_size = size;
    found_riff = true;
    data += 12;
    data_size -= 12;
  }
  // ParseVP8X
  {
    if (data_size < 8) return NOT_ENOUGH_DATA;
    if (!std::memcmp(data, "VP8X", 4)) {
      if (le32(data + 4) != 10) return BITSTREAM_ERROR;
      if (data_size < 18) return NOT_ENOUGH_DATA;
      const uint32_t flags = le32(data + 8);
      canvas_w = int(1 + le24(data + 12));
      canvas_h = int(1 + le24(data + 15));
      if (uint64_t(canvas_w) * uint64_t(canvas_h) >= (uint64_t(1) << 32)) return BITSTREAM_ERROR;
      data += 18;
      data_size -= 18;
      found_vp8x = true;
      animation = flags & FLAG_ANIM;
      hd.has_alpha = !!(flags & FLAG_ALPHA);
      hd.has_animation = animation;
    }
    if (!found_riff && found_vp8x) return BITSTREAM_ERROR;
    image_w = canvas_w;
    image_h = canvas_h;
    if (found_vp8x && animation && !full) goto done;
  }
  if (data_size < 4) {
    status = NOT_ENOUGH_DATA;
    goto done;
  }
  // ParseOptionalChunks
  if ((found_riff && found_vp8x) || (!found_riff && !found_vp8x && !std::memcmp(data, "ALPH", 4))) {
    uint64_t total = 4 + 8 + 10;
    for (;;) {
      if (data_size < 8) {
        status = NOT_ENOUGH_DATA;
        goto done;
      }
      const uint32_t chunk_size = le32(data + 4);
      if (chunk_size > kMaxChunkPayload) return BITSTREAM_ERROR;
      const uint64_t disk = (uint64_t(8) + chunk_size + 1) & ~uint64_t(1);
      total += disk;
      if (riff_size > 0 && total > riff_size) return BITSTREAM_ERROR;
      if (!std::memcmp(data, "VP8 ", 4) || !std::memcmp(data, "VP8L", 4)) break;
      if (data_size < disk) {
        status = NOT_ENOUGH_DATA;
        goto done;
      }
      if (!std::memcmp(data, "ALPH", 4)) {
        hd.alpha = data + 8;
        hd.alpha_size = chunk_size;
      }
      data += disk;
      data_size -= size_t(disk);
    }
  }
  // ParseVP8Header
  {
    if (data_size < 8) {
      status = NOT_ENOUGH_DATA;
      goto done;
    }
    const bool is_vp8 = !std::memcmp(data, "VP8 ", 4), is_vp8l = !std::memcmp(data, "VP8L", 4);
    size_t compressed;
    if (is_vp8 || is_vp8l) {
      const uint32_t size = le32(data + 4);
      if (riff_size >= 12 && size > riff_size - 12) return BITSTREAM_ERROR;
      if (full && size > data_size - 8) return NOT_ENOUGH_DATA;
      compressed = size;
      data += 8;
      data_size -= 8;
      hd.lossless = is_vp8l;
    } else {
      hd.lossless = data_size >= 5 && data[0] == 0x2f && (data[4] >> 5) == 0;
      compressed = data_size;
    }
    if (compressed > kMaxChunkPayload) return BITSTREAM_ERROR;
    if (!hd.lossless) {
      if (data_size < 10) {
        status = NOT_ENOUGH_DATA;
        goto done;
      }
      if (!vp8_info(data, data_size, compressed, &image_w, &image_h)) return BITSTREAM_ERROR;
    } else {
      if (data_size < 5) {
        status = NOT_ENOUGH_DATA;
        goto done;
      }
      int alpha;
      if (!vp8l_info(data, data_size, &image_w, &image_h, &alpha)) return BITSTREAM_ERROR;
      hd.has_alpha = alpha;
    }
    if (found_vp8x && (canvas_w != image_w || canvas_h != image_h)) return BITSTREAM_ERROR;
    hd.offset = size_t(data - start);
  }
done:
  if (status == OK || (status == NOT_ENOUGH_DATA && found_vp8x && !full)) {
    hd.has_alpha |= hd.alpha != nullptr;
    hd.width = image_w;
    hd.height = image_h;
    return OK;
  }
  return status;
}

// DecodeInto of a still image (WebPDecodeBGRInto / BGRAInto): BGR, and the
// alpha plane when asked for
void decode_still(const uint8_t* data, size_t size, std::vector<uint8_t>& bgr, int& w, int& h,
                  std::vector<uint8_t>* alpha) {
  Headers hd;
  Status st = parse_headers(data, size, true, hd);
  if (st != OK && st != NOT_ENOUGH_DATA) throw Unreadable("bad WebP headers");
  if (st != OK || hd.has_animation) throw Unreadable("bad WebP headers (or an animation)");
  const uint8_t* img = data + hd.offset;
  const size_t img_size = size - hd.offset;
  if (hd.lossless) {
    std::vector<uint32_t> argb = decode_vp8l(img, img_size, &w, &h);
    bgr.resize(size_t(w) * size_t(h) * 3);
    for (size_t i = 0; i < argb.size(); i++) {
      bgr[3 * i] = uint8_t(argb[i]);
      bgr[3 * i + 1] = uint8_t(argb[i] >> 8);
      bgr[3 * i + 2] = uint8_t(argb[i] >> 16);
    }
    if (alpha) {
      alpha->resize(argb.size());
      for (size_t i = 0; i < argb.size(); i++) (*alpha)[i] = uint8_t(argb[i] >> 24);
    }
    return;
  }
  VP8Dec dec;
  VP8Frame f = dec.decode(img, img_size);
  w = f.width;
  h = f.height;
  std::vector<uint8_t> a;
  if (hd.alpha) a = decode_alpha(hd.alpha, hd.alpha_size, w, h);
  bgr.resize(size_t(w) * size_t(h) * 3);
  vp8_to_bgr(f, bgr.data(), int64_t(w) * 3);
  if (alpha) {
    if (hd.alpha) *alpha = std::move(a);
    else alpha->assign(size_t(w) * size_t(h), 255);
  }
}

// ---- the demuxer (demux.c), for animations and the EXIF chunk
struct Frame {
  int x_offset = 0, y_offset = 0, width = 0, height = 0, frame_num = 0;
  bool complete = false, has_alpha = false;
  size_t img_off = 0, img_size = 0, alpha_off = 0, alpha_size = 0;
};

struct Demux {
  const uint8_t* buf;
  size_t start = 0, end = 0, riff_end = 0;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  bool is_ext = false;
  int anim_chunks = 0;
  std::vector<Frame> frames;
  size_t exif_off = 0, exif_size = 0;
  bool have_exif = false;
  enum { PARSE_OK, NEED_MORE, PARSE_ERROR };

  size_t avail() const { return end - start; }
  bool size_invalid(size_t n) const { return n > riff_end - start; }
  uint32_t rd32() {
    uint32_t v = le32(buf + start);
    start += 4;
    return v;
  }

  int store_frame(int frame_num, uint32_t min_size, Frame& fr) {
    int alpha_chunks = 0, image_chunks = 0;
    bool done = avail() < 8 || avail() < min_size;
    int status = PARSE_OK;
    if (done) return NEED_MORE;
    do {
      const size_t chunk_start = start;
      start += 4;
      const uint32_t payload = rd32();
      if (payload > kMaxChunkPayload) return PARSE_ERROR;
      const uint32_t padded = payload + (payload & 1);
      const size_t available = padded > avail() ? avail() : padded;
      const size_t chunk_size = 8 + available;
      if (size_invalid(padded)) return PARSE_ERROR;
      if (padded > avail()) status = NEED_MORE;
      const uint8_t* tag = buf + chunk_start;
      if (!std::memcmp(tag, "ALPH", 4) && alpha_chunks == 0) {
        ++alpha_chunks;
        fr.alpha_off = chunk_start;
        fr.alpha_size = chunk_size;
        fr.has_alpha = true;
        fr.frame_num = frame_num;
        start += available;
      } else if (!std::memcmp(tag, "VP8L", 4) && alpha_chunks > 0) {
        return PARSE_ERROR;  // VP8L has its own alpha
      } else if ((!std::memcmp(tag, "VP8L", 4) || !std::memcmp(tag, "VP8 ", 4)) && image_chunks == 0) {
        Headers hd;
        const Status st = parse_headers(buf + chunk_start, chunk_size, false, hd);
        if (status == NEED_MORE && st == NOT_ENOUGH_DATA) return NEED_MORE;
        if (st != OK) return PARSE_ERROR;
        ++image_chunks;
        fr.img_off = chunk_start;
        fr.img_size = chunk_size;
        fr.width = hd.width;
        fr.height = hd.height;
        fr.has_alpha |= hd.has_alpha;
        fr.frame_num = frame_num;
        fr.complete = status == PARSE_OK;
        start += available;
      } else {
        start -= 8;
        done = true;
      }
      if (start == riff_end) done = true;
      else if (avail() < 8) status = NEED_MORE;
    } while (!done && status == PARSE_OK);
    return status;
  }

  bool add_frame(const Frame& fr) {
    if (!frames.empty() && !frames.back().complete) return false;
    frames.push_back(fr);
    return true;
  }

  int parse_single_image() {
    if (!frames.empty()) return PARSE_ERROR;
    if (size_invalid(8)) return PARSE_ERROR;
    if (avail() < 8) return NEED_MORE;
    Frame fr;
    int status = store_frame(1, 0, fr);
    if (status != PARSE_ERROR) {
      if (!(flags & FLAG_ALPHA) && fr.alpha_size > 0) {
        fr.alpha_off = fr.alpha_size = 0;
        fr.has_alpha = false;
      }
      if (!is_ext && fr.width > 0 && fr.height > 0) {
        canvas_w = fr.width;
        canvas_h = fr.height;
        flags |= fr.has_alpha ? FLAG_ALPHA : 0;
      }
      if (!add_frame(fr)) status = PARSE_ERROR;
    }
    return status;
  }

  int parse_animation_frame(uint32_t frame_chunk_size) {
    const bool is_animation = flags & FLAG_ANIM;
    if (size_invalid(16)) return PARSE_ERROR;
    if (frame_chunk_size < 16) return PARSE_ERROR;
    if (avail() < 16) return NEED_MORE;
    const uint32_t anmf_payload = frame_chunk_size - 16;
    Frame fr;
    fr.x_offset = 2 * int(le24(buf + start));
    fr.y_offset = 2 * int(le24(buf + start + 3));
    fr.width = 1 + int(le24(buf + start + 6));
    fr.height = 1 + int(le24(buf + start + 9));
    start += 16;
    if (uint64_t(fr.width) * uint64_t(fr.height) >= (uint64_t(1) << 32)) return PARSE_ERROR;
    const size_t at = start;
    int status = store_frame(int(frames.size()) + 1, anmf_payload, fr);
    if (status != PARSE_ERROR && start - at > anmf_payload) status = PARSE_ERROR;
    if (status != PARSE_ERROR && is_animation && fr.frame_num > 0) {
      if (!add_frame(fr)) status = PARSE_ERROR;
    }
    return status;
  }

  int parse_vp8x_chunks() {
    const bool is_animation = flags & FLAG_ANIM;
    int status = PARSE_OK;
    do {
      const size_t chunk_start = start;
      const uint8_t* tag = buf + start;
      start += 4;
      const uint32_t chunk_size = rd32();
      if (chunk_size > kMaxChunkPayload) return PARSE_ERROR;
      const uint32_t padded = chunk_size + (chunk_size & 1);
      if (size_invalid(padded)) return PARSE_ERROR;
      bool store = true, skip = false;
      if (!std::memcmp(tag, "VP8X", 4)) {
        return PARSE_ERROR;
      } else if (!std::memcmp(tag, "ALPH", 4) || !std::memcmp(tag, "VP8 ", 4) ||
                 !std::memcmp(tag, "VP8L", 4)) {
        if (anim_chunks > 0 || is_animation) return PARSE_ERROR;
        start -= 8;
        status = parse_single_image();
      } else if (!std::memcmp(tag, "ANIM", 4)) {
        if (padded < 6) return PARSE_ERROR;
        if (avail() < padded) {
          status = NEED_MORE;
        } else if (anim_chunks == 0) {
          ++anim_chunks;
          start += padded;
        } else {
          store = false;
          skip = true;
        }
      } else if (!std::memcmp(tag, "ANMF", 4)) {
        if (anim_chunks == 0) return PARSE_ERROR;
        status = parse_animation_frame(padded);
      } else {
        if (!std::memcmp(tag, "ICCP", 4)) store = flags & FLAG_ICCP;
        else if (!std::memcmp(tag, "EXIF", 4)) store = flags & FLAG_EXIF;
        else if (!std::memcmp(tag, "XMP ", 4)) store = flags & FLAG_XMP;
        skip = true;
      }
      if (skip) {
        if (padded <= avail()) {
          if (store && !std::memcmp(tag, "EXIF", 4) && !have_exif) {
            have_exif = true;
            exif_off = chunk_start + 8;
            exif_size = chunk_size;
          }
          start += padded;
        } else {
          status = NEED_MORE;
        }
      }
      if (start == riff_end) break;
      if (avail() < 8) status = NEED_MORE;
    } while (status == PARSE_OK);
    return status;
  }

  bool valid_extended() const {
    const bool is_animation = flags & FLAG_ANIM;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (frames.empty()) return false;
    if (flags & ~uint32_t(0x3e)) return false;
    for (const Frame& f : frames) {
      if (!is_animation && f.frame_num > 1) return false;
      if (f.complete) {
        if (f.alpha_size == 0 && f.img_size == 0) return false;
        if (f.alpha_size > 0 && f.alpha_off > f.img_off) return false;
        if (f.width <= 0 || f.height <= 0) return false;
      } else {
        return false;  // no partial frame in a complete file
      }
      if (f.width > 0 && f.height > 0) {
        if (!is_animation) {
          if (f.x_offset != 0 || f.y_offset != 0 || f.width != canvas_w || f.height != canvas_h)
            return false;
        } else if (f.x_offset < 0 || f.y_offset < 0 || f.width + f.x_offset > canvas_w ||
                   f.height + f.y_offset > canvas_h) {
          return false;
        }
      }
    }
    return true;
  }

  // WebPDemux (whole file): true when it accepts the file
  bool run(const uint8_t* data, size_t size) {
    buf = data;
    end = size;
    if (size < 20) return false;
    if (std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4)) return false;
    const uint32_t riff_size = le32(data + 4);
    if (riff_size < 8 || riff_size > kMaxChunkPayload) return false;
    riff_end = size_t(riff_size) + 8;
    if (end > riff_end) end = riff_end;
    if (end < riff_end) return false;  // partial
    start = 12;
    const uint8_t* tag = data + start;
    int status;
    if (!std::memcmp(tag, "VP8 ", 4) || !std::memcmp(tag, "VP8L", 4)) {
      status = parse_single_image();
      if (status == NEED_MORE) status = PARSE_ERROR;
      if (status != PARSE_ERROR) {
        if (canvas_w <= 0 || canvas_h <= 0 || frames.empty() || frames[0].width <= 0 ||
            frames[0].height <= 0)
          status = PARSE_ERROR;
      }
    } else if (!std::memcmp(tag, "VP8X", 4)) {
      status = parse_vp8x();
      if (status == NEED_MORE) status = PARSE_ERROR;
      if (status != PARSE_ERROR && !valid_extended()) status = PARSE_ERROR;
    } else {
      return false;
    }
    return status != PARSE_ERROR;
  }

  int parse_vp8x() {
    if (avail() < 8) return NEED_MORE;
    is_ext = true;
    start += 4;
    uint32_t vp8x_size = rd32();
    if (vp8x_size > kMaxChunkPayload || vp8x_size < 10) return PARSE_ERROR;
    vp8x_size += vp8x_size & 1;
    if (size_invalid(vp8x_size)) return PARSE_ERROR;
    if (avail() < vp8x_size) return NEED_MORE;
    flags = buf[start];
    canvas_w = 1 + int(le24(buf + start + 4));
    canvas_h = 1 + int(le24(buf + start + 7));
    if (uint64_t(canvas_w) * uint64_t(canvas_h) >= (uint64_t(1) << 32)) return PARSE_ERROR;
    start += vp8x_size;
    if (size_invalid(8)) return PARSE_ERROR;
    if (avail() < 8) return NEED_MORE;
    return parse_vp8x_chunks();
  }
};

// the first frame of an animation as WebPAnimDecoder composes it: BGR on
// the canvas (zeros outside the frame)
void decode_first_frame(const uint8_t* data, const Demux& dm, std::vector<uint8_t>& bgr,
                        std::vector<uint8_t>* alpha) {
  const Frame& fr = dm.frames[0];
  size_t off = fr.img_off, n = fr.img_size;
  if (fr.alpha_size > 0) {
    const size_t inter = fr.img_off > 0 ? fr.img_off - (fr.alpha_off + fr.alpha_size) : 0;
    off = fr.alpha_off;
    n += fr.alpha_size + inter;
  }
  // WebPDecode of the frame's chunks: not-enough-data is an error
  Headers probe;
  if (parse_headers(data + off, n, false, probe) != OK) throw Unreadable("bad animation frame");
  std::vector<uint8_t> fbgr, fa;
  int w = 0, h = 0;
  decode_still(data + off, n, fbgr, w, h, alpha ? &fa : nullptr);
  if (w != fr.width || h != fr.height) throw Unreadable("animation frame of the wrong size");
  const int cw = dm.canvas_w, ch = dm.canvas_h;
  bgr.assign(size_t(cw) * size_t(ch) * 3, 0);
  if (alpha) alpha->assign(size_t(cw) * size_t(ch), 0);
  for (int y = 0; y < h; y++) {
    std::memcpy(&bgr[(size_t(fr.y_offset + y) * size_t(cw) + size_t(fr.x_offset)) * 3],
                &fbgr[size_t(y) * size_t(w) * 3], size_t(w) * 3);
    if (alpha)
      std::memcpy(&(*alpha)[size_t(fr.y_offset + y) * size_t(cw) + size_t(fr.x_offset)],
                  &fa[size_t(y) * size_t(w)], size_t(w));
  }
}

struct Features {
  int width = 0, height = 0, animated = 0;
};

bool demux_accepts(const uint8_t* data, size_t size);

// OpenCV's WebPDecoder::readHeader: WebPGetFeatures on the first 32 bytes,
// and for an animation WebPAnimDecoderNew over the whole file; then
// imread's limits on the size
Features features(const uint8_t* data, size_t size) {
  if (size < 32) throw Unreadable("a WebP file of fewer than 32 bytes");
  Headers hd;
  if (parse_headers(data, 32, false, hd) != OK) throw Unreadable("bad WebP header");
  if (hd.has_animation && !demux_accepts(data, size))
    throw Unreadable("WebPDemux rejects the animation");
  // OpenCV's limits on an image read (imread raises past them)
  if (hd.width > (1 << 20) || hd.height > (1 << 20) ||
      int64_t(hd.width) * hd.height > (int64_t(1) << 30))
    throw std::runtime_error("a WebP image larger than OpenCV's limits (cv2.imread raises)");
  return Features{hd.width, hd.height, hd.has_animation};
}

// WebPAnimDecoderNew's checks: WebPGetFeatures over the file, then WebPDemux
bool demux_accepts(const uint8_t* data, size_t size) {
  Headers whole;
  Demux dm;
  return parse_headers(data, size, false, whole) == OK && dm.run(data, size);
}

// the whole decode: BGR (and alpha) of a still image or of an animation's
// first frame
void decode_webp(const uint8_t* data, size_t size, std::vector<uint8_t>& bgr, int& w, int& h,
                 std::vector<uint8_t>* alpha) {
  const Features ft = features(data, size);
  w = ft.width;
  h = ft.height;
  if (ft.animated) {
    Demux dm;
    if (!dm.run(data, size)) throw Unreadable("WebPDemux rejects the animation");
    if (dm.canvas_w != w || dm.canvas_h != h) throw Unreadable("animation canvas mismatch");
    decode_first_frame(data, dm, bgr, alpha);
    return;
  }
  int dw = 0, dh = 0;
  decode_still(data, size, bgr, dw, dh, alpha);
  if (dw != w || dh != h) throw Unreadable("WebP image size differs from its header's");
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

// 1 where the first 32 bytes are a WebP file's as OpenCV's signature check
// reads them (RIFF or a raw VP8 / VP8L stream), else 0
int fots_webp_signature(const uint8_t* data, int64_t n) {
  if (n < 32) return 0;
  Headers hd;
  return parse_headers(data, 32, false, hd) == OK ? 1 : 0;
}

// info: height, width, offset and size of the EXIF chunk OpenCV reads its
// orientation from (size 0: none)
int fots_webp_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    const Features ft = features(data, size_t(n));
    info[0] = ft.height;
    info[1] = ft.width;
    info[2] = info[3] = 0;
    Demux dm;
    if (dm.run(data, size_t(n)) && (dm.flags & FLAG_EXIF) && dm.have_exif) {
      info[2] = int32_t(dm.exif_off);
      info[3] = int32_t(dm.exif_size);
    }
  });
}

// out: height * width * 3 bytes (BGR) or height * width (grey)
int fots_webp_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    std::vector<uint8_t> bgr;
    int w = 0, h = 0;
    decode_webp(data, size_t(n), bgr, w, h, nullptr);
    const size_t px = size_t(w) * size_t(h);
    if (gray) {
      for (size_t i = 0; i < px; i++) out[i] = grey(bgr[3 * i], bgr[3 * i + 1], bgr[3 * i + 2]);
    } else {
      std::memcpy(out, bgr.data(), px * 3);
    }
  });
}

// out: height * width * 4 bytes, BGRA (the alpha plane as decoded; 255
// where the image has none, 0 outside an animation's first frame)
int fots_webp_decode_bgra(const uint8_t* data, int64_t n, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    std::vector<uint8_t> bgr, a;
    int w = 0, h = 0;
    decode_webp(data, size_t(n), bgr, w, h, &a);
    const size_t px = size_t(w) * size_t(h);
    for (size_t i = 0; i < px; i++) {
      std::memcpy(out + 4 * i, &bgr[3 * i], 3);
      out[4 * i + 3] = a.empty() ? 255 : a[i];
    }
  });
}

}  // extern "C"
