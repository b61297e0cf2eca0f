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
// with no arithmetic.  So it is a streaming copy: each thread moves one
// vector of V bytes at a time, neighbouring threads touch neighbouring
// addresses on both the read and the write side, and a grid-stride loop
// keeps every SM busy.  It is dtype-agnostic and takes a row of any number
// of bytes: the launcher picks V, the largest of 16, 8, 4, 2 and 1 that
// divides the row and both pointers, and instantiates the one kernel at that
// width (the 64-channel focr rows take 16; the 3-channel f32 images of the
// CRNN crops, 12-byte rows, take 4; 3-channel bf16, 6-byte rows, take 2).
// Every width copies the same bytes to the same places.
//
// Its backward (K4'-bwd, pack_neighbors_bwd_kernel) replaces the VJP of
// fots/ops/rroi_align.py:_pack_pallas_diff (_pack_pallas_diff_bwd, jnp
// shifted sums on the TPU): the pack is linear, so the cotangent of row i is
//   df[i] = g[i, 0] + g[i-1, 1] + g[i-W, 2] + g[i-W-1, 3]
// (a term is zero where its row index is < 0).  It is written as a gather:
// each thread owns one vector of df and reads the four slots that copied
// it, so no two threads write one address and no atomics are needed; the
// sum order is fixed, so the result is deterministic (and, in f32,
// bit-identical to the plain version's left-to-right sum).  Bytes bound it
// too: it reads g (4x the map) once and writes the map once.  Like the
// forward it takes rows of any C: the vector is 4, 2 or 1 floats, the
// widest that divides C and both pointers (the 64-channel focr rows take 4;
// the 3-channel f32 image of the RoIRotate gradient demo takes 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a V-byte vector: the copy moves these whole
template <int V> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<1> { using T = uint8_t; };

template <int V>
__global__ void pack_neighbors_kernel(const typename Vec<V>::T* __restrict__ x,
                                      typename Vec<V>::T* __restrict__ out,
                                      long long n_rows, long long width, int vecs_per_row) {
  using T = typename Vec<V>::T;
  const long long per_out_row = 4LL * vecs_per_row;
  const long long total = n_rows * per_out_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total; v += stride) {
    const long long i = v / per_out_row;
    const int rem = (int)(v - i * per_out_row);
    const int slot = rem / vecs_per_row;
    const int k = rem - slot * vecs_per_row;
    const long long src = i + (slot & 1) + (slot >> 1) * width;
    out[v] = src < n_rows ? x[src * vecs_per_row + k] : T{};
  }
}

// L f32 lanes, aligned so that a load or store of one is one vector access
template <int L> struct alignas(4 * L) FVec { float v[L]; };

// grid-stride over the n_rows * vecs_per_row L-float vectors of df
template <int L>
__global__ void pack_neighbors_bwd_kernel(const FVec<L>* __restrict__ g,
                                          FVec<L>* __restrict__ df, long long n_rows,
                                          long long width, int vecs_per_row) {
  const long long total = n_rows * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long grow = 4LL * vecs_per_row;  // vectors per row of g
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total; v += stride) {
    const long long i = v / vecs_per_row;
    const int k = (int)(v - i * vecs_per_row);
    // slot s of row i - off[s] read row i: off = {0, 1, W, W + 1}
    FVec<L> acc = g[i * grow + k];
    const long long src[3] = {i - 1, i - width, i - width - 1};
#pragma unroll
    for (int s = 1; s < 4; s++) {
      const long long r = src[s - 1];
      if (r >= 0) {
        const FVec<L> t = g[r * grow + s * vecs_per_row + k];
#pragma unroll
        for (int j = 0; j < L; j++) acc.v[j] += t.v[j];
      }
    }
    df[v] = acc;
  }
}

}  // namespace

extern "C" {

// x: [n_rows, row_bytes] contiguous, out: [n_rows, 4 * row_bytes], any
// row_bytes > 0.  Returns a cudaError_t code.
int fots_pack_neighbors(const void* x, void* out, long long n_rows, long long width,
                        int row_bytes, int num_sms, void* stream) {
  if (row_bytes <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  int v = 16;
  while (v > 1 && (row_bytes % v != 0 || align % v != 0)) v /= 2;
  const int vecs = row_bytes / v;
  const long long total = n_rows * 4LL * vecs;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
#define FOTS_PACK_LAUNCH(V)                                                                 \
  case V:                                                                                   \
    pack_neighbors_kernel<V><<<(unsigned)blocks, threads, 0, s>>>(                          \
        static_cast<const Vec<V>::T*>(x), static_cast<Vec<V>::T*>(out), n_rows, width, vecs); \
    break;
    FOTS_PACK_LAUNCH(16)
    FOTS_PACK_LAUNCH(8)
    FOTS_PACK_LAUNCH(4)
    FOTS_PACK_LAUNCH(2)
    FOTS_PACK_LAUNCH(1)
#undef FOTS_PACK_LAUNCH
  }
  return (int)cudaGetLastError();
}

// f32 only.  g: [n_rows, 4 * C] contiguous, df: [n_rows, C]; any C > 0.
// Returns a cudaError_t code.
int fots_pack_neighbors_bwd(const float* g, float* df, long long n_rows, long long width,
                            int channels, int num_sms, void* stream) {
  if (channels <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(df);
  int lanes = 4;
  while (lanes > 1 && (channels % lanes != 0 || align % (4 * lanes) != 0)) lanes /= 2;
  const int vecs = channels / lanes;
  const long long total = n_rows * vecs;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
#define FOTS_PACK_BWD_LAUNCH(L)                                                           \
  case L:                                                                                 \
    pack_neighbors_bwd_kernel<L><<<(unsigned)blocks, threads, 0, s>>>(                    \
        reinterpret_cast<const FVec<L>*>(g), reinterpret_cast<FVec<L>*>(df), n_rows, width, \
        vecs);                                                                            \
    break;
    FOTS_PACK_BWD_LAUNCH(4)
    FOTS_PACK_BWD_LAUNCH(2)
    FOTS_PACK_BWD_LAUNCH(1)
#undef FOTS_PACK_BWD_LAUNCH
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
