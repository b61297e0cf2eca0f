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
// with no arithmetic.  So it is a streaming copy: each thread moves 16-byte
// vectors, neighbouring threads touch neighbouring addresses on both the
// read and the write side, and a grid-stride loop keeps every SM busy.  It
// is dtype-agnostic: any C with C * itemsize % 16 == 0.
//
// Its backward (K4'-bwd, pack_neighbors_bwd_kernel) replaces the VJP of
// fots/ops/rroi_align.py:_pack_pallas_diff (_pack_pallas_diff_bwd, jnp
// shifted sums on the TPU): the pack is linear, so the cotangent of row i is
//   df[i] = g[i, 0] + g[i-1, 1] + g[i-W, 2] + g[i-W-1, 3]
// (a term is zero where its row index is < 0).  It is written as a gather:
// each thread owns one 16-byte vector of df and reads the four slots that
// copied it, so no two threads write one address and no atomics are needed;
// the sum order is fixed, so the result is deterministic (and, in f32,
// bit-identical to the plain version's left-to-right sum).  Bytes bound it
// too: it reads g (4x the map) once and writes the map once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    out[v] = src < n_rows ? x[src * vecs_per_row + k] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// grid-stride over the n_rows * vecs_per_row float4 vectors of df
__global__ void pack_neighbors_bwd_kernel(const float4* __restrict__ g, float4* __restrict__ df,
                                          long long n_rows, long long width, int vecs_per_row) {
  const long long total = n_rows * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long grow = 4LL * vecs_per_row;  // float4s per row of g
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

}  // namespace

extern "C" {

// x: [n_rows, row_bytes] contiguous, out: [n_rows, 4 * row_bytes]; both
// 16-byte aligned and row_bytes % 16 == 0.  Returns a cudaError_t code.
int fots_pack_neighbors(const void* x, void* out, long long n_rows, long long width,
                        int row_bytes, int num_sms, void* stream) {
  if (row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int vecs = row_bytes / 16;
  const long long total = n_rows * 4LL * vecs;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  pack_neighbors_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n_rows, width, vecs);
  return (int)cudaGetLastError();
}

// f32 only.  g: [n_rows, 4 * C] contiguous, df: [n_rows, C]; both 16-byte
// aligned and C % 4 == 0.  Returns a cudaError_t code.
int fots_pack_neighbors_bwd(const float* g, float* df, long long n_rows, long long width,
                            int channels, int num_sms, void* stream) {
  if (channels % 4 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(df) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int vecs = channels / 4;
  const long long total = n_rows * vecs;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = (long long)num_sms * 16;
  if (blocks > cap) blocks = cap;
  pack_neighbors_bwd_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(df), n_rows, width, vecs);
  return (int)cudaGetLastError();
}

}  // extern "C"
