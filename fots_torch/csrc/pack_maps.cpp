// Packs a training batch's three upload buffers in one host pass.
//
// The bytes are those of fots_torch.train.pack_host_maps, written straight
// into the caller's buffers (pinned memory on a CUDA trainer):
//   images_out [B, H*W*3] u8   clip(rint((x + 1) * 128), 0, 255) in f32
//   maps_u8    [B, 2n]    u8   score map, then training mask
//   maps_f16   [B, 5n]    f16  geometry channels 0-3 per pixel, then channel 4
// with n = H/4 * W/4.  rint rounds half to even (numpy's np.rint); the f16
// conversion rounds to nearest even with subnormals and overflow to inf, as
// numpy's astype(np.float16) does.
//
// A value whose numpy result this pass does not reproduce is counted, and
// the count is returned: a non-finite image value, a score or mask value
// that is not a whole number in [0, 255], a NaN in the geometry.  A caller
// that gets a non-zero count discards the buffers and packs with NumPy.
//
// Two implementations give the same bytes: AVX2 + F16C, chosen at run time
// from the CPU, and a portable scalar one.  No FP contraction, no fast-math
// (the build passes -ffp-contract=off): each f32 operation rounds as NumPy's.
// Rows of the batch are split over a few std::threads; the caller picks the
// count.  Built with g++ by fots_torch/kernels/build.py at first use and
// loaded via ctypes, which releases the GIL for the call.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define FOTS_PACK_X86 1
#endif

namespace {

struct Job {
  const float* images;  // [B, img_row]
  long long img_row;
  const void* score;    // [B, n], u8 or f32
  int score_f32;
  const void* mask;     // [B, n], u8 or f32
  int mask_f32;
  const float* geo;     // [B, n, 5]
  long long n;
  uint8_t* images_out;
  uint8_t* maps_u8;
  uint16_t* maps_f16;
};

inline uint32_t bits(float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}

inline bool finite(float x) { return (bits(x) & 0x7f800000u) != 0x7f800000u; }

// clip(rint(y), 0, 255) for finite y = (x + 1) * 128: below 0.5 rint gives
// at most 0, from 255 on it gives at least 255; in between y + 2^23 rounds
// to the nearest integer, ties to even, under the default rounding mode.
inline uint8_t image_u8(float x) {
  float y = (x + 1.0f) * 128.0f;
  if (!(y > 0.0f)) return 0;
  if (y >= 255.0f) return 255;
  return static_cast<uint8_t>((y + 8388608.0f) - 8388608.0f);
}

inline bool whole_u8(float v) {
  return v >= 0.0f && v <= 255.0f && v == static_cast<float>(static_cast<int>(v));
}

// IEEE binary32 -> binary16, round to nearest even (NaN is the caller's).
inline uint16_t half_bits(float x) {
  uint32_t f = bits(x);
  uint16_t sign = static_cast<uint16_t>((f >> 16) & 0x8000u);
  uint32_t a = f & 0x7fffffffu;
  if (a >= 0x47800000u) return sign | 0x7c00u;  // 65536 and up, inf: inf
  if (a < 0x38800000u) {                         // below 2^-14: subnormal or 0
    if (a < 0x33000000u) return sign;            // below 2^-25: 0
    uint32_t e = a >> 23, m = (a & 0x7fffffu) | 0x800000u;
    uint32_t shift = 126 - e;  // units of 2^-24
    uint32_t q = m >> shift, rem = m & ((1u << shift) - 1), half = 1u << (shift - 1);
    if (rem > half || (rem == half && (q & 1u))) q++;
    return sign | static_cast<uint16_t>(q);
  }
  uint32_t r = a - 0x38000000u;  // exponent rebiased from 127 to 15
  uint32_t q = r >> 13, rem = r & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (q & 1u))) q++;  // may carry to inf
  return sign | static_cast<uint16_t>(q);
}

long long images_scalar(const float* x, uint8_t* out, long long count) {
  long long bad = 0;
  for (long long i = 0; i < count; i++) {
    bad += !finite(x[i]);
    out[i] = finite(x[i]) ? image_u8(x[i]) : 0;
  }
  return bad;
}

long long map_scalar(const void* src, int f32, uint8_t* out, long long count) {
  if (!f32) {
    std::memcpy(out, src, static_cast<size_t>(count));
    return 0;
  }
  const float* s = static_cast<const float*>(src);
  long long bad = 0;
  for (long long i = 0; i < count; i++) {
    bool ok = whole_u8(s[i]);
    bad += !ok;
    out[i] = ok ? static_cast<uint8_t>(static_cast<int>(s[i])) : 0;
  }
  return bad;
}

long long geo_scalar(const float* g, uint16_t* o4, uint16_t* o1, long long from, long long to) {
  long long bad = 0;
  for (long long p = from; p < to; p++) {
    for (int c = 0; c < 5; c++) {
      float v = g[5 * p + c];
      bad += std::isnan(v);
      uint16_t h = std::isnan(v) ? 0 : half_bits(v);
      if (c < 4) o4[4 * p + c] = h; else o1[p] = h;
    }
  }
  return bad;
}

#ifdef FOTS_PACK_X86

__attribute__((target("avx2,f16c"))) long long hsum(__m256i v) {
  alignas(32) int32_t lanes[8];
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes), v);
  long long s = 0;
  for (int k = 0; k < 8; k++) s += lanes[k];
  return s;
}

// 32 packed i32 in [0, 255] (four vectors) -> 32 bytes in order
__attribute__((target("avx2,f16c"))) __m256i to_bytes(__m256i a, __m256i b, __m256i c,
                                                      __m256i d) {
  __m256i p = _mm256_packus_epi16(_mm256_packs_epi32(a, b), _mm256_packs_epi32(c, d));
  return _mm256_permutevar8x32_epi32(p, _mm256_setr_epi32(0, 4, 1, 5, 2, 6, 3, 7));
}

__attribute__((target("avx2,f16c"))) long long images_avx2(const float* x, uint8_t* out,
                                                           long long count) {
  const __m256 one = _mm256_set1_ps(1.0f), scale = _mm256_set1_ps(128.0f);
  const __m256 lo = _mm256_setzero_ps(), hi = _mm256_set1_ps(255.0f);
  const __m256i expo = _mm256_set1_epi32(0x7f800000);
  __m256i bad = _mm256_setzero_si256();
  long long i = 0;
  for (; i + 32 <= count; i += 32) {
    __m256i q[4];
    for (int k = 0; k < 4; k++) {
      __m256 v = _mm256_loadu_ps(x + i + 8 * k);
      __m256i e = _mm256_and_si256(_mm256_castps_si256(v), expo);
      bad = _mm256_sub_epi32(bad, _mm256_cmpeq_epi32(e, expo));
      __m256 y = _mm256_mul_ps(_mm256_add_ps(v, one), scale);
      y = _mm256_round_ps(y, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
      q[k] = _mm256_cvtps_epi32(_mm256_min_ps(_mm256_max_ps(y, lo), hi));
    }
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i), to_bytes(q[0], q[1], q[2], q[3]));
  }
  return hsum(bad) + images_scalar(x + i, out + i, count - i);
}

__attribute__((target("avx2,f16c"))) long long map_avx2(const void* src, int f32, uint8_t* out,
                                                        long long count) {
  if (!f32) return map_scalar(src, f32, out, count);
  const float* s = static_cast<const float*>(src);
  const __m256 lo = _mm256_setzero_ps(), hi = _mm256_set1_ps(255.0f);
  __m256i ok = _mm256_setzero_si256();
  long long i = 0;
  for (; i + 32 <= count; i += 32) {
    __m256i q[4];
    for (int k = 0; k < 4; k++) {
      __m256 v = _mm256_loadu_ps(s + i + 8 * k);
      __m256 whole = _mm256_and_ps(
          _mm256_and_ps(_mm256_cmp_ps(v, lo, _CMP_GE_OQ), _mm256_cmp_ps(v, hi, _CMP_LE_OQ)),
          _mm256_cmp_ps(_mm256_round_ps(v, _MM_FROUND_TO_ZERO | _MM_FROUND_NO_EXC), v,
                        _CMP_EQ_OQ));
      ok = _mm256_sub_epi32(ok, _mm256_castps_si256(whole));
      q[k] = _mm256_and_si256(_mm256_cvttps_epi32(v), _mm256_castps_si256(whole));
    }
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i), to_bytes(q[0], q[1], q[2], q[3]));
  }
  return (i - hsum(ok)) + map_scalar(s + i, f32, out + i, count - i);
}

__attribute__((target("avx2,f16c"))) long long geo_avx2(const float* g, uint16_t* o4,
                                                        uint16_t* o1, long long count) {
  const __m256i stride = _mm256_setr_epi32(0, 5, 10, 15, 20, 25, 30, 35);
  long long bad = 0, p = 0;
  for (; p + 8 <= count; p += 8) {
    for (int k = 0; k < 8; k += 2) {
      // channels 0-3 of pixels p + k and p + k + 1
      __m256 v = _mm256_set_m128(_mm_loadu_ps(g + 5 * (p + k + 1)), _mm_loadu_ps(g + 5 * (p + k)));
      bad += __builtin_popcount(_mm256_movemask_ps(_mm256_cmp_ps(v, v, _CMP_UNORD_Q)));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(o4 + 4 * (p + k)),
                       _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT));
    }
    __m256 a = _mm256_i32gather_ps(g + 5 * p + 4, stride, 4);  // channel 4
    bad += __builtin_popcount(_mm256_movemask_ps(_mm256_cmp_ps(a, a, _CMP_UNORD_Q)));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(o1 + p), _mm256_cvtps_ph(a, _MM_FROUND_TO_NEAREST_INT));
  }
  return bad + geo_scalar(g, o4, o1, p, count);
}

bool have_avx2_f16c() {
  __builtin_cpu_init();
  return __builtin_cpu_supports("avx2") && __builtin_cpu_supports("f16c");
}

#else

bool have_avx2_f16c() { return false; }

#endif

long long pack_rows(const Job& j, long long r0, long long r1, bool vec) {
  long long bad = 0, n = j.n;
  long long count = (r1 - r0) * j.img_row;
  const float* img = j.images + r0 * j.img_row;
  uint8_t* img_out = j.images_out + r0 * j.img_row;
#ifdef FOTS_PACK_X86
  if (vec) bad += images_avx2(img, img_out, count);
  else
#endif
    bad += images_scalar(img, img_out, count);
  for (long long r = r0; r < r1; r++) {
    for (int which = 0; which < 2; which++) {
      const void* src = which ? j.mask : j.score;
      int f32 = which ? j.mask_f32 : j.score_f32;
      const void* row = static_cast<const char*>(src) + r * n * (f32 ? 4 : 1);
      uint8_t* out = j.maps_u8 + r * 2 * n + which * n;
#ifdef FOTS_PACK_X86
      if (vec) bad += map_avx2(row, f32, out, n);
      else
#endif
        bad += map_scalar(row, f32, out, n);
    }
    const float* g = j.geo + r * 5 * n;
    uint16_t* o4 = j.maps_f16 + r * 5 * n;
#ifdef FOTS_PACK_X86
    if (vec) bad += geo_avx2(g, o4, o4 + 4 * n, n);
    else
#endif
      bad += geo_scalar(g, o4, o4 + 4 * n, 0, n);
  }
  return bad;
}

}  // namespace

extern "C" {

// Packs rows [0, b) on ``threads`` threads (the calling one among them);
// ``simd`` 0 forces the scalar implementation.  Returns the count of values
// whose NumPy result the pass does not reproduce (0: the buffers are exact).
long long fots_pack_maps(const float* images, long long b, long long img_row,
                         const void* score, int score_f32, const void* mask, int mask_f32,
                         const float* geo, long long n, uint8_t* images_out, uint8_t* maps_u8,
                         uint16_t* maps_f16, int threads, int simd) {
  if (b <= 0) return 0;
  Job job{images, img_row, score, score_f32, mask, mask_f32, geo, n,
          images_out, maps_u8, maps_f16};
  bool vec = simd && have_avx2_f16c();
  long long t = threads < 1 ? 1 : (threads > b ? b : threads);
  std::vector<long long> bad(static_cast<size_t>(t), 0);
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(t));
  for (long long k = 1; k < t; k++) {
    long long r0 = b * k / t, r1 = b * (k + 1) / t;
    try {
      pool.emplace_back([&job, &bad, k, r0, r1, vec] { bad[k] = pack_rows(job, r0, r1, vec); });
    } catch (const std::system_error&) {  // no thread to be had: do the rows here
      bad[k] = pack_rows(job, r0, r1, vec);
    }
  }
  bad[0] = pack_rows(job, 0, b / t, vec);
  long long total = 0;
  for (auto& th : pool) th.join();
  for (long long v : bad) total += v;
  return total;
}

}  // extern "C"
