// RoIRotate neighbour pack: for flat row i of a [B, H, W, C] map (N = B*H*W
// rows of C values), quads[i] = [f[i], f[i+1], f[i+W], f[i+W+1]], a row of
// 4C values, with zeros where the source row is >= N.
//
// Replaces fots/ops/rroi_align.py:_pack_neighbors_pallas (a double-buffered
// DMA window copy over the row-pair view, built for the TPU's row-costed
// gathers).  It matches that kernel on every row, out-of-map rows included.
//
// What bounds it on an H100: bytes.  It reads the map once (through L2: the
// four slots of a row read neighbouring rows) and writes four times its size,
// with no arithmetic.  Two kernels, one for each kind of row:
//
// - pack_neighbors_kernel, for rows of a multiple of 16 bytes on 16-byte
//   aligned pointers (the 64-channel focr maps of serving and training): a
//   streaming copy, each thread moving one 16-byte vector at a time,
//   neighbouring threads on neighbouring addresses on both sides, a
//   grid-stride loop keeping every SM busy.
// - pack_neighbors_kernel_narrow, for every other row (the 3-channel images
//   of the CRNN crops and of the RoIRotate demo: 12-byte f32 rows, 6-byte
//   bf16 rows; any C; a source that is not 16-byte aligned).  Copied pixel
//   by pixel, such rows cost instructions, not bytes: 4- or 2-byte vectors,
//   a 64-bit division per vector.  So a block owns a span of T output rows
//   [i0, i0 + T) and stages its two contiguous source spans, x rows
//   [i0, i0 + T + 1) and [i0 + W, i0 + W + T + 1), in shared memory with
//   16-byte loads from the 16-byte boundary below each span (byte loads only
//   for the two ragged chunks at a span's ends and past the map, which read
//   as zeros).  Then it writes its output slab, T * 4 * row_bytes contiguous
//   bytes, with 16-byte stores: T is even, so every slab starts on 16 bytes.
//   Each 16-byte store gathers eight 2-byte units from shared memory (rows
//   are whole 2-byte units for f32 and bf16); one 32-bit multiply-shift
//   division a store finds its first unit's (row, slot, offset), and the
//   rest step from there.  Block bases are 64-bit, offsets inside a block
//   32-bit.  The second span was read W rows earlier by another block and
//   comes from L2.
// Both write the same bytes to the same places as the plain version.
//
// Its backward (K4'-bwd) replaces the VJP of
// fots/ops/rroi_align.py:_pack_pallas_diff (_pack_pallas_diff_bwd, jnp
// shifted sums on the TPU): the pack is linear, so the cotangent of row i is
//   df[i] = g[i, 0] + g[i-1, 1] + g[i-W, 2] + g[i-W-1, 3]
// (a term is zero where its row index is < 0), summed in that order, so the
// result is deterministic and bit-identical to the plain version's
// left-to-right sum.  It is a gather: each output element is written by one
// thread, no atomics.  Bytes bound it too: it reads g (4x the map) once and
// writes the map once.  Again two kernels:
//
// - pack_neighbors_bwd_kernel, for C a multiple of 4 on 16-byte aligned
//   pointers (the 64-channel focr maps of training): each thread owns one
//   4-float vector of df and reads the four 4-float slots that copied it.
// - pack_neighbors_bwd_kernel_narrow, for any other C (the RoIRotate demo's
//   3-channel image): one float of df a thread, its four slots gathered
//   from g and summed in the fixed order (a row below 0 adds zero, as in the
//   plain version).  A block takes spans of 2048 floats of df: 64-bit bases
//   a span, 32-bit offsets and one multiply-shift division a float inside
//   it, where the 1-float kernel it replaces took a 64-bit division and
//   64-bit offsets a float.  A warp's four loads cover the same g rows, so
//   L1 serves all but the first.  Staging the two spans of g rows in
//   shared memory, as the forward does, was measured slower here (the
//   spans' whole rows double what crosses L2: 0.0116 ms against this
//   design's predecessor's 0.0088 at [2, 512, 512, 3] on an H100).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks of the narrow kernels resident on one SM (2048 threads)
constexpr int kNarrowBlocksPerSm = 8;
// output bytes a narrow block aims to write per span
constexpr int kNarrowSlabBytes = 16384;
// df floats a narrow backward block takes at a time
constexpr int kNarrowBwdFloats = 2048;
// shared memory a block may use on sm_90
constexpr size_t kMaxSmem = 232448;

// n / d for 0 <= n < 2^31 by a multiply and a shift (d > 0 fixed per launch)
struct FastDiv {
  uint32_t mul, shift;
};

FastDiv make_fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) s++;
  return {(uint32_t)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

__device__ __forceinline__ int fast_div(int n, FastDiv f) {
  return (int)((__umulhi((uint32_t)n, f.mul) + (uint32_t)n) >> f.shift);
}

// rows of a multiple of 16 bytes on 16-byte aligned pointers: one 16-byte
// vector per thread iteration
__global__ void pack_neighbors_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                                      long long n_rows, long long width, int vecs_per_row) {
  const long long per_out_row = 4LL * vecs_per_row;
  const long long total = n_rows * per_out_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total; v += stride) {
    const long long i = v / per_out_row;
    const int rem = (int)(v - i * per_out_row);
    const int slot = rem / vecs_per_row;
    const int k = rem - slot * vecs_per_row;
    const long long src = i + (slot & 1) + (slot >> 1) * width;
    out[v] = src < n_rows ? x[src * vecs_per_row + k] : uint4{};
  }
}

// Stage bytes [lo, lo + len) of the buffer [buf, buf + size) (lo may be
// negative or past the end: those bytes read as zeros) into dst, from the
// 16-byte boundary below buf + lo, with 16-byte loads where a chunk lies
// wholly inside the buffer.  Returns where byte lo landed (0..15).
__device__ __forceinline__ int stage_span(const uint8_t* __restrict__ buf, long long size,
                                          long long lo, int len, uint8_t* dst) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(buf) + lo;  // wraps below buf
  const int head = (int)(start & 15);
  const long long first = lo - head;  // buffer offset of chunk 0 (16-byte aligned address)
  const int chunks = (head + len + 15) >> 4;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const long long off = first + 16LL * c;
    union {
      uint4 v;
      uint8_t b[16];
    } w;
    if (off >= 0 && off + 16 <= size) {
      w.v = *reinterpret_cast<const uint4*>(buf + off);
    } else {
#pragma unroll
      for (int j = 0; j < 16; j++) w.b[j] = (off + j >= 0 && off + j < size) ? buf[off + j] : 0;
    }
    *reinterpret_cast<uint4*>(dst + 16 * c) = w.v;
  }
  return head;
}

// any even row_bytes on 2-byte aligned pointers; out 16-byte aligned.  A
// block takes spans of `tile` (even) output rows in a grid-stride loop.
__global__ void __launch_bounds__(kThreads) pack_neighbors_kernel_narrow(
    const uint8_t* __restrict__ x, uint8_t* __restrict__ out, long long n_rows,
    long long width, int row_bytes, int tile, int span_stride, FastDiv out_row_div) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long size = n_rows * row_bytes;
  const int out_row = 4 * row_bytes;
  const long long n_tiles = (n_rows + tile - 1) / tile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long i0 = t * tile;
    const int rows = (int)min((long long)tile, n_rows - i0);
    const int len = (rows + 1) * row_bytes;
    // slots 0 and 1 from x rows i0.., slots 2 and 3 from rows i0 + W..
    const int h0 = stage_span(x, size, i0 * row_bytes, len, smem);
    const int h1 = stage_span(x, size, (i0 + width) * row_bytes, len, smem + span_stride);
    __syncthreads();
    const uint8_t* s0 = smem + h0;
    const uint8_t* s1 = smem + span_stride + h1;
    uint8_t* slab = out + i0 * out_row;
    const int slab_bytes = rows * out_row;
    for (int ob = 16 * threadIdx.x; ob < slab_bytes; ob += 16 * blockDim.x) {
      int p = fast_div(ob, out_row_div);
      int r = ob - p * out_row;
      int slot = (r >= row_bytes) + (r >= 2 * row_bytes) + (r >= 3 * row_bytes);
      int k = r - slot * row_bytes;
      union {
        uint4 v;
        uint16_t u[8];
      } w;
#pragma unroll
      for (int j = 0; j < 8; j++) {
        // past the slab's end (its last store only) this reads staged bytes
        // of row rows + 1 at most, which the span buffers hold
        w.u[j] = *reinterpret_cast<const uint16_t*>((slot < 2 ? s0 : s1) +
                                                     (p + (slot & 1)) * row_bytes + k);
        k += 2;
        if (k == row_bytes) {
          k = 0;
          if (++slot == 4) {
            slot = 0;
            ++p;
          }
        }
      }
      if (ob + 16 <= slab_bytes) {
        *reinterpret_cast<uint4*>(slab + ob) = w.v;
      } else {  // the slab's last, short store
#pragma unroll
        for (int j = 0; j < 8; j++)
          if (2 * j < slab_bytes - ob) reinterpret_cast<uint16_t*>(slab + ob)[j] = w.u[j];
      }
    }
    __syncthreads();
  }
}

// C a multiple of 4 on 16-byte aligned pointers: grid-stride over the
// n_rows * C / 4 float4 vectors of df
__global__ void pack_neighbors_bwd_kernel(const float4* __restrict__ g, float4* __restrict__ df,
                                          long long n_rows, long long width, int vecs_per_row) {
  const long long total = n_rows * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long grow = 4LL * vecs_per_row;  // vectors per row of g
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total; v += stride) {
    const long long i = v / vecs_per_row;
    const int k = (int)(v - i * vecs_per_row);
    // slot s of row i - off[s] read row i: off = {0, 1, W, W + 1}
    float4 acc = g[i * grow + k];
    const long long src[3] = {i - 1, i - width, i - width - 1};
#pragma unroll
    for (int s = 1; s < 4; s++) {
      const long long r = src[s - 1];
      if (r >= 0) {
        const float4 t = g[r * grow + s * vecs_per_row + k];
        acc.x += t.x;
        acc.y += t.y;
        acc.z += t.z;
        acc.w += t.w;
      }
    }
    df[v] = acc;
  }
}

// any C on 4-byte aligned g and df: one float of df a thread, gathered from
// the four slots that copied it.  A block takes spans of `tile` df rows in a
// grid-stride loop: 64-bit bases a span, 32-bit offsets inside it.
__global__ void __launch_bounds__(kThreads) pack_neighbors_bwd_kernel_narrow(
    const float* __restrict__ g, float* __restrict__ df, long long n_rows, long long width,
    int channels, int tile, FastDiv row_div) {
  const int grow = 4 * channels;  // floats per row of g
  const long long n_tiles = (n_rows + tile - 1) / tile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long i0 = t * tile;
    const int n = (int)min((long long)tile, n_rows - i0) * channels;
    // slot s of g row i0 + p - off[s] at offset p * grow + k from g_s,
    // off = {0, 1, W, W + 1}; a row below 0 adds zero, as the plain version
    const float* g0 = g + i0 * grow;
    const float* g1 = g0 - grow + channels;
    const float* g2 = g0 - width * grow + 2 * channels;
    const float* g3 = g2 - grow + channels;
    float* d = df + i0 * channels;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const int p = fast_div(q, row_div);
      const int o = p * grow + (q - p * channels);
      const long long i = i0 + p;
      float v = g0[o] + (i >= 1 ? g1[o] : 0.f);
      v = v + (i >= width ? g2[o] : 0.f);
      d[q] = v + (i > width ? g3[o] : 0.f);
    }
  }
}

}  // namespace

extern "C" {

// x: [n_rows, row_bytes] contiguous, out: [n_rows, 4 * row_bytes]; rows of
// a multiple of 16 bytes on 16-byte aligned x and out take the 16-byte
// kernel, any other even row_bytes (x 2-byte aligned, out 16-byte aligned)
// the narrow kernel, as long as two spans of four rows fit in shared memory
// (rows up to 29,048 bytes).
// Returns a cudaError_t code.
int fots_pack_neighbors(const void* x, void* out, long long n_rows, long long width,
                        int row_bytes, int num_sms, void* stream) {
  if (row_bytes <= 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && (xa | oa) % 16 == 0) {
    const int vecs = row_bytes / 16;
    const long long total = n_rows * 4LL * vecs;
    long long blocks = (total + kThreads - 1) / kThreads;
    const long long cap = (long long)num_sms * 16;
    if (blocks > cap) blocks = cap;
    pack_neighbors_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), n_rows, width, vecs);
    return (int)cudaGetLastError();
  }
  if (row_bytes % 2 != 0 || xa % 2 != 0 || oa % 16 != 0) return (int)cudaErrorInvalidValue;
  // an even tile of about kNarrowSlabBytes of output (so offsets in a slab
  // fit 31 bits for any row that fits shared memory)
  int tile = kNarrowSlabBytes / (4 * row_bytes);
  tile = tile < 2 ? 2 : tile & ~1;
  // two span buffers of tile + 2 rows, 16 bytes of head room and 16 of
  // tail each, 16-byte aligned; above 48 KB only by the attribute
  const int stride = (int)((((long long)(tile + 2) * row_bytes + 32) + 15) & ~15LL);
  const size_t smem = 2 * (size_t)stride;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_neighbors_kernel_narrow, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_tiles = (n_rows + tile - 1) / tile;
  long long blocks = (long long)num_sms * kNarrowBlocksPerSm;
  if (blocks > n_tiles) blocks = n_tiles;
  pack_neighbors_kernel_narrow<<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), n_rows, width, row_bytes,
      tile, stride, make_fast_div(4 * row_bytes));
  return (int)cudaGetLastError();
}

// f32 only.  g: [n_rows, 4 * C] contiguous, df: [n_rows, C]; C a multiple
// of 4 on 16-byte aligned g and df takes the 4-float kernel, any other C
// (g and df 4-byte aligned) the narrow kernel.  Returns a cudaError_t code.
int fots_pack_neighbors_bwd(const float* g, float* df, long long n_rows, long long width,
                            int channels, int num_sms, void* stream) {
  if (channels <= 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g), da = reinterpret_cast<uintptr_t>(df);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels % 4 == 0 && (ga | da) % 16 == 0) {
    const int vecs = channels / 4;
    const long long total = n_rows * vecs;
    long long blocks = (total + kThreads - 1) / kThreads;
    const long long cap = (long long)num_sms * 16;
    if (blocks > cap) blocks = cap;
    pack_neighbors_bwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(df), n_rows, width, vecs);
    return (int)cudaGetLastError();
  }
  if ((ga | da) % 4 != 0) return (int)cudaErrorInvalidValue;
  // a tile of about kNarrowBwdFloats floats of df
  int tile = kNarrowBwdFloats / channels;
  if (tile < 1) tile = 1;
  const long long n_tiles = (n_rows + tile - 1) / tile;
  long long blocks = (long long)num_sms * kNarrowBlocksPerSm;
  if (blocks > n_tiles) blocks = n_tiles;
  pack_neighbors_bwd_kernel_narrow<<<(unsigned)blocks, kThreads, 0, s>>>(
      g, df, n_rows, width, channels, tile, make_fast_div(channels));
  return (int)cudaGetLastError();
}

}  // extern "C"
