// Host decoding of the compressed strips and tiles of TIFF files as libtiff
// 4.7 (the build inside OpenCV 5.0) decodes them under cv2.imread: LZW
// (tif_lzw.c LZWDecode) and PackBits (tif_packbits.c PackBitsDecode).  The
// caller (fots_torch/imageio.py) parses the directory, inflates Deflate
// strips with zlib and converts the samples.
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
//   - PackBits: runs and literal spans cut to the room left, data that ends
//     inside a span stops there, and output short of `occ` fails.
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.

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

}  // namespace

extern "C" {

int fots_tiff_lzw(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  return lzw_decode(src, n, out, occ);
}

int fots_tiff_packbits(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  return packbits_decode(src, n, out, occ);
}

}  // extern "C"
