// Helpers shared by the port's normalisation kernels (instance_norm.cu,
// instance_norm_bwd.cu, spatial_norm.cu): vector packs for 16-byte loads,
// f32 <-> storage-type conversion, the masked column count, and the
// deterministic "last block folds the partials" ticket.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fots {

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float& o) { o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16& o) { o = __float2bfloat16_rn(x); }

// columns of sample n that count: valid_w[n] clamped to [0, W], or W
__device__ __forceinline__ int clamp_width(const int* valid_w, int n, int W) {
  if (valid_w == nullptr) return W;
  return min(max(valid_w[n], 0), W);
}

// flat pixel index of the q-th counted pixel of a sample whose first vw
// columns count (row-major over H x vw)
__device__ __forceinline__ long long counted_pixel(long long q, int vw, int W) {
  return (vw == W) ? q : (q / vw) * W + q % vw;
}

// Called by every thread of a block after it wrote its partial: true in
// exactly one block per ticket (the last to arrive), which may then read
// every block's partial.  Deterministic: the partials are folded by the
// caller in a fixed order, never with float atomics.
__device__ __forceinline__ bool last_block_of(int* counter, int expected) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = (atomicAdd(counter, 1) == expected - 1);
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

constexpr int kBlockThreads = 256;
constexpr int kPixPerThread = 8;

// threads per block for `lanes` threads across a pixel's channels: whole
// rows of lanes, about kBlockThreads in all
inline int rows_for_lanes(int lanes) {
  return lanes >= kBlockThreads ? 1 : kBlockThreads / lanes;
}

}  // namespace fots
