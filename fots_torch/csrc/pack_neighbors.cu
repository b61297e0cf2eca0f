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

}  // extern "C"
