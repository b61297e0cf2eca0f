// Host decoding of GIF files as OpenCV 5.0's own GifDecoder
// (modules/imgcodecs/src/grfmt_gif.cpp) reads them under cv2.imread: the
// first frame, colour (BGR) or grayscale, byte for byte:
//   - GIF87a and GIF89a; the header's scan of the whole file (every block up
//     to the trailer must be well formed: a file cut anywhere, or without its
//     trailer, is Unreadable);
//   - global and local colour tables in one 256-entry table: a local table
//     overwrites the first entries of the global one, so an index past the
//     local table reads the global entry beneath it; an index drawn that is
//     past both tables is Unreadable;
//   - the first frame on a canvas of the logical screen's size, filled with
//     the global table's background colour (black without a global table; a
//     background index past the table is Unreadable), the frame at its offset
//     (it must lie inside the screen) and its transparent index (the last
//     Graphic Control Extension before it; a GCE whose size is not 4, or whose
//     disposal method is past 3, is Unreadable) left as the canvas;
//   - LZW at minimum code sizes 2 to 11: codes grow to 12 bits, a full table
//     takes no more entries until the next clear code (the deferred clear),
//     a code whose string would pass the frame's last pixel, data that ends
//     before it (or an end-of-information code), and a code past the next
//     free one are Unreadable.  After the last pixel the codes are read up to
//     an end-of-information code (clear codes reset the table as before); a
//     data code there must lie within the next byte, as must the end of the
//     data when no end code comes.  (OpenCV's decoder goes on past a frame's end in ways that
//     depend on memory it does not own; this rule agrees with it on every
//     file an encoder writes: the last pixel, the end code, the padding.);
//   - interlaced rows in the four passes (every 8th from 0, every 8th from 4,
//     every 4th from 2, every 2nd from 1);
//   - grayscale output by OpenCV's fixed-point BGR -> grey (4899, 9617, 1868
//     over 2^14, rounded).
// A file with neither a global nor a local table reads uninitialised memory
// in OpenCV; here its colours are black.
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

constexpr int64_t kMaxSide = 1 << 20;
constexpr int64_t kMaxPixels = int64_t(1) << 30;

// cvtColor(BGR(A)2GRAY) of 8-bit pixels: 15-bit fixed point, rounded
inline uint8_t grey(int b, int g, int r) { return uint8_t((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15); }

struct Stream {
  const uint8_t* d;
  int64_t n, pos = 0;
  int byte() {
    if (pos >= n) throw Unreadable("the GIF ends early (truncated)");
    return d[pos++];
  }
  int word() { int a = byte(); return a | byte() << 8; }
  void skip(int64_t k) {
    if (pos + k > n) throw Unreadable("the GIF ends early (truncated)");
    pos += k;
  }
  void skip_sub_blocks() {
    for (int len = byte(); len; len = byte()) skip(len);
  }
};

struct Gif {
  int width = 0, height = 0;   // the logical screen
  int global_size = 0, bg = 0;
  uint8_t table[256][3] = {};  // r, g, b
  uint8_t background[3] = {};  // the global table's background entry
  int64_t first_block = 0;     // after the global table
};

Gif read_header(const uint8_t* data, int64_t n) {
  Gif g;
  Stream s{data, n};
  if (n < 6 || (std::memcmp(data, "GIF87a", 6) && std::memcmp(data, "GIF89a", 6)))
    throw Unreadable("no GIF87a / GIF89a signature");
  s.pos = 6;
  g.width = s.word();
  g.height = s.word();
  if (g.width <= 0 || g.height <= 0) throw Unreadable("GIF screen of zero size");
  int flags = s.byte();
  g.bg = s.byte();
  s.byte();  // aspect ratio
  if (flags & 0x80) {
    g.global_size = 1 << ((flags & 7) + 1);
    for (int i = 0; i < g.global_size; i++)
      for (int c = 0; c < 3; c++) g.table[i][c] = uint8_t(s.byte());
    if (g.bg >= g.global_size) throw Unreadable("GIF background index past the global table");
    std::memcpy(g.background, g.table[g.bg], 3);
  }
  g.first_block = s.pos;
  // the frame count: every block up to the trailer
  for (;;) {
    int b = s.byte();
    if (b == 0x3b) break;
    if (b == 0x21) {
      int label = s.byte();
      if (label == 0xf9) {
        if (s.byte() != 4) throw Unreadable("GIF graphic control extension of a size other than 4");
        s.skip(4);
      }
      s.skip_sub_blocks();
    } else if (b == 0x2c) {
      s.skip(8);
      int f = s.byte();
      if (f & 0x80) s.skip(3 << ((f & 7) + 1));
      s.byte();  // LZW minimum code size
      s.skip_sub_blocks();
    } else {
      throw Unreadable("unknown GIF block");
    }
  }
  if (g.width > kMaxSide || g.height > kMaxSide || int64_t(g.width) * g.height > kMaxPixels)
    throw std::runtime_error("GIF larger than OpenCV's limits (imread raises)");
  return g;
}

// The LZW data of one frame -> its colour indices (exactly `count` of them)
std::vector<uint8_t> lzw(Stream& s, int min_size, int64_t count) {
  if (min_size < 2 || min_size > 11) throw Unreadable("GIF LZW minimum code size outside 2-11");
  std::vector<uint8_t> raw;  // the data of the sub-blocks
  for (int len = s.byte(); len; len = s.byte()) {
    s.skip(len);
    raw.insert(raw.end(), s.d + s.pos - len, s.d + s.pos);
  }
  const int clear = 1 << min_size, eoi = clear + 1;
  std::vector<uint8_t> out(static_cast<size_t>(count));
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<int> length(4096);
  for (int i = 0; i < clear; i++) {
    suffix[i] = first[i] = uint8_t(i);
    length[i] = 1;
  }
  int width = min_size + 1, next = eoi + 1, prev = -1;
  int64_t idx = 0, last = -1;  // last: the byte that completed the frame
  uint32_t bits = 0;
  int nbits = 0;
  for (size_t at = 0; at < raw.size(); at++) {
    bits |= uint32_t(raw[at]) << nbits;
    nbits += 8;
    while (nbits >= width) {
      int code = int(bits & ((1u << width) - 1));
      bits >>= width;
      nbits -= width;
      if (code == clear) {
        width = min_size + 1;
        next = eoi + 1;
        prev = -1;
        continue;
      }
      if (code == eoi) {
        if (idx != count) throw Unreadable("GIF LZW data shorter than its frame");
        return out;
      }
      if (last >= 0) {  // a code after the frame's last pixel
        if (int64_t(at) > last + 1) throw Unreadable("GIF LZW data past its frame");
        continue;
      }
      if (code > next || (prev < 0 && code >= clear))
        throw Unreadable("GIF LZW code past the table");
      const int cur = code == next ? prev : code;  // KwKwK: prev + first(prev)
      const int64_t total = length[cur] + (code == next ? 1 : 0);
      if (idx + total > count) throw Unreadable("GIF LZW data longer than its frame");
      int64_t end = idx + total;
      if (code == next) out[size_t(--end)] = first[prev];
      for (int c = cur;; c = prefix[c]) {
        out[size_t(--end)] = suffix[c];
        if (length[c] == 1) break;
      }
      if (prev >= 0 && next < 4096) {  // the string of prev and this string's first index
        prefix[next] = uint16_t(prev);
        suffix[next] = out[size_t(idx)];
        first[next] = first[prev];
        length[next] = length[prev] + 1;
        next++;
        if (next == (1 << width) && width < 12) width++;
      }
      idx += total;
      prev = code;
      if (idx == count) last = int64_t(at);
    }
  }
  if (idx != count) throw Unreadable("GIF LZW data shorter than its frame");
  if (int64_t(raw.size()) > last + 2) throw Unreadable("GIF LZW data past its frame");
  return out;
}

void decode(const uint8_t* data, int64_t n, bool gray, uint8_t* out) {
  Gif g = read_header(data, n);
  Stream s{data, n, g.first_block};
  int transparent = -1;
  for (;;) {
    int b = s.byte();
    if (b == 0x2c) break;
    if (b != 0x21) throw Unreadable("no image in the GIF");
    if (s.byte() == 0xf9) {
      s.byte();
      int flags = s.byte();
      s.skip(2);
      int index = s.byte();
      if ((flags >> 2 & 7) > 3) throw Unreadable("GIF disposal method past 3");
      transparent = flags & 1 ? index : -1;
    }
    s.skip_sub_blocks();
  }
  const int left = s.word(), top = s.word(), w = s.word(), h = s.word();
  if (w <= 0 || h <= 0 || left + w > g.width || top + h > g.height)
    throw Unreadable("GIF frame outside its screen");
  int flags = s.byte();
  int local_size = 0;
  if (flags & 0x80) {
    local_size = 1 << ((flags & 7) + 1);
    for (int i = 0; i < local_size; i++)
      for (int c = 0; c < 3; c++) g.table[i][c] = uint8_t(s.byte());
  }
  const int table_size = local_size > g.global_size ? local_size : g.global_size;
  std::vector<uint8_t> index = lzw(s, s.byte(), int64_t(w) * h);
  // the canvas
  const int nch = gray ? 1 : 3;
  uint8_t bg[3] = {0, 0, 0};
  if (g.global_size) {
    const uint8_t* rgb = g.background;
    if (gray) {
      bg[0] = grey(rgb[2], rgb[1], rgb[0]);
    } else {
      bg[0] = rgb[2];
      bg[1] = rgb[1];
      bg[2] = rgb[0];
    }
  }
  const int64_t row_bytes = int64_t(g.width) * nch;
  for (int64_t y = 0; y < g.height; y++)
    for (int64_t x = 0; x < g.width; x++) std::memcpy(out + y * row_bytes + x * nch, bg, size_t(nch));
  std::vector<int> rows;
  if (flags & 0x40) {
    for (int y = 0; y < h; y += 8) rows.push_back(y);
    for (int y = 4; y < h; y += 8) rows.push_back(y);
    for (int y = 2; y < h; y += 4) rows.push_back(y);
    for (int y = 1; y < h; y += 2) rows.push_back(y);
  } else {
    for (int y = 0; y < h; y++) rows.push_back(y);
  }
  for (int r = 0; r < h; r++) {
    uint8_t* row = out + (top + int64_t(rows[size_t(r)])) * row_bytes + int64_t(left) * nch;
    const uint8_t* src = index.data() + int64_t(r) * w;
    for (int x = 0; x < w; x++, row += nch) {
      int k = src[x];
      if (k == transparent) continue;
      if (k >= table_size && table_size) throw Unreadable("GIF colour index past its tables");
      const uint8_t* c = g.table[k];
      if (gray) {
        row[0] = grey(c[2], c[1], c[0]);
      } else {
        row[0] = c[2];
        row[1] = c[1];
        row[2] = c[0];
      }
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

// info: height, width (of the logical screen)
int fots_gif_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Gif g = read_header(data, n);
    info[0] = g.height;
    info[1] = g.width;
  });
}

// out: height * width * 3 bytes (BGR) or height * width (gray)
int fots_gif_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, char* err,
                    int errlen) {
  return guarded(err, errlen, [&] { decode(data, n, gray != 0, out); });
}

}  // extern "C"
