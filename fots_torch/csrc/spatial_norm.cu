// The spatially tiled two-pass instance norm, as two kernels with the
// per-(b, c) fold between them left to the caller (it is a few [B, C]
// vectors): K2' statistics and K3' normalise.  The port's CReLU-IN
// (fots_torch/ops/instance_norm.py:crelu_instance_norm) runs K2', folds
// (a+, c+, a-, c-), and runs K3' in its CReLU mode.
//
// K2' spatial_stats_kernel replaces fots/ops/instance_norm.py:_spatial_stats:
//   x [B, H, W, C] (f32 or bf16) -> [B, 2, C] f32 (sum, sum of squares).
//   The TPU kernel carries the sums across a sequential grid of row tiles;
//   here blocks over (pixel chunk, sample) write partials [B, S, 2, C] and
//   the last block of each sample (atomic ticket) folds them in a fixed
//   order: deterministic, no float atomics.
// K3' spatial_norm_kernel replaces fots/ops/instance_norm.py:_spatial_norm:
//   out_mul = 1: y = x * a + c (+ leaky), vecs [B, 2, C] (a, c);
//   out_mul = 2: the CReLU variant, y[..., :C] = x * a+ + c+ and
//   y[..., C:] = x * a- + c- (+ leaky each), vecs [B, 4, C], output
//   [B, H, W, 2C] in x's dtype: the [+x | -x] halves without a concat.
//
// K3' rounds each multiply and add on its own, as the plain version does, so
// it is bit-identical to it.
//
// What bounds them on an H100: bytes.  K2' reads x once (two flops per
// element); K3' reads x once and writes out_mul times its size.  Threads run
// along the contiguous channel axis with 16-byte loads and stores; the
// per-thread vectors stay in registers.

#include "common.cuh"

namespace {

using fots::from_f32;
using fots::kPixPerThread;
using fots::Pack;
using fots::to_f32;

// grid (S, B); block = rows * lanes threads, lanes = C / V.
// smem: 2 * blockDim.x * V floats.
template <typename T, int V>
__global__ void spatial_stats_kernel(const T* __restrict__ x, float* __restrict__ out,
                                     float* __restrict__ partial, int* __restrict__ counter,
                                     int H, int W, int C, int S) {
  extern __shared__ float sm[];
  const int n = blockIdx.y, s = blockIdx.x;
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  const long long npix = (long long)H * W;
  const long long chunk = (npix + S - 1) / S;
  const long long p0 = (long long)s * chunk;
  const long long p1 = min(npix, p0 + chunk);
  const T* xs = x + (long long)n * npix * C + lane * V;

  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; i++) s1[i] = s2[i] = 0.f;
  for (long long q = p0 + row; q < p1; q += rows) {
    const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(xs + q * C);
#pragma unroll
    for (int i = 0; i < V; i++) {
      const float f = to_f32(pk.v[i]);
      s1[i] += f;
      s2[i] += f * f;
    }
  }
  float* sm1 = sm;
  float* sm2 = sm + blockDim.x * V;
#pragma unroll
  for (int i = 0; i < V; i++) {
    sm1[row * C + lane * V + i] = s1[i];
    sm2[row * C + lane * V + i] = s2[i];
  }
  __syncthreads();
  float* part = partial + ((long long)n * S + s) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rows; r++) {
      a += sm1[r * C + c];
      b += sm2[r * C + c];
    }
    part[c] = a;
    part[C + c] = b;
  }
  if (!fots::last_block_of(counter + n, S)) return;
  const float* pn = partial + (long long)n * S * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < S; k++) {
      a += __ldcg(pn + (long long)k * 2 * C + c);
      b += __ldcg(pn + (long long)k * 2 * C + C + c);
    }
    out[(long long)n * 2 * C + c] = a;
    out[(long long)n * 2 * C + C + c] = b;
  }
}

// grid (ceil(H*W / chunk_pix), B); block = rows * lanes threads.
template <typename T, int V, int OUT_MUL>
__global__ void spatial_norm_kernel(const T* __restrict__ x, const float* __restrict__ vecs,
                                    T* __restrict__ y, int H, int W, int C, int chunk_pix,
                                    float slope, int has_slope) {
  const int n = blockIdx.y;
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  float a[OUT_MUL][V], b[OUT_MUL][V];
  const float* vn = vecs + (long long)n * 2 * OUT_MUL * C;
#pragma unroll
  for (int h = 0; h < OUT_MUL; h++)
#pragma unroll
    for (int i = 0; i < V; i++) {
      a[h][i] = vn[(2 * h) * C + lane * V + i];
      b[h][i] = vn[(2 * h + 1) * C + lane * V + i];
    }
  const long long hw = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * chunk_pix;
  const long long p1 = min(hw, p0 + chunk_pix);
  const T* xs = x + (long long)n * hw * C + lane * V;
  T* ys = y + (long long)n * hw * OUT_MUL * C + lane * V;
  for (long long p = p0 + row; p < p1; p += rows) {
    const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(xs + p * C);
#pragma unroll
    for (int h = 0; h < OUT_MUL; h++) {
      Pack<T, V> out;
#pragma unroll
      for (int i = 0; i < V; i++) {
        // separate roundings (no fused multiply-add): the plain version's
        // arithmetic, so the result is bit-identical to it
        float f = __fadd_rn(__fmul_rn(to_f32(pk.v[i]), a[h][i]), b[h][i]);
        if (has_slope && f < 0.f) f = __fmul_rn(f, slope);
        from_f32(f, out.v[i]);
      }
      *reinterpret_cast<Pack<T, V>*>(ys + p * OUT_MUL * C + h * C) = out;
    }
  }
}

template <typename T, int V>
int launch_stats(const void* x, float* out, int B, int H, int W, int C, float* partial,
                 int* counter, int S, cudaStream_t stream) {
  const int lanes = C / V;
  const int threads = lanes * fots::rows_for_lanes(lanes);
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = 2 * (size_t)threads * V * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidConfiguration;
  spatial_stats_kernel<T, V><<<dim3(S, B), threads, smem, stream>>>(
      static_cast<const T*>(x), out, partial, counter, H, W, C, S);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_norm(const void* x, const float* vecs, void* y, int B, int H, int W, int C,
                int out_mul, float slope, int has_slope, cudaStream_t stream) {
  const int lanes = C / V;
  const int rows = fots::rows_for_lanes(lanes);
  const int threads = lanes * rows;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const int chunk_pix = rows * kPixPerThread;
  const long long blocks = ((long long)H * W + chunk_pix - 1) / chunk_pix;
  const dim3 grid((unsigned)blocks, B);
  if (out_mul == 1)
    spatial_norm_kernel<T, V, 1><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), vecs, static_cast<T*>(y), H, W, C, chunk_pix, slope,
        has_slope);
  else
    spatial_norm_kernel<T, V, 2><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), vecs, static_cast<T*>(y), H, W, C, chunk_pix, slope,
        has_slope);
  return (int)cudaGetLastError();
}

bool vectorizable(int C, size_t itemsize, const void* p, const void* q) {
  return (C * itemsize) % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0);
}

}  // namespace

extern "C" {

// K2'.  dtype: 0 = float32, 1 = bfloat16.  x [B, H, W, C] contiguous ->
// out f32 [B, 2, C] (sum, sum of squares).  Workspaces: partial f32
// [B, S, 2, C], counter int32 [B] zeroed.  Returns a cudaError_t code.
int fots_spatial_stats(const void* x, float* out, int dtype, int B, int H, int W, int C,
                       float* partial, int* counter, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vectorizable(C, 4, x, nullptr)
               ? launch_stats<float, 4>(x, out, B, H, W, C, partial, counter, S, st)
               : launch_stats<float, 1>(x, out, B, H, W, C, partial, counter, S, st);
  if (dtype == 1)
    return vectorizable(C, 2, x, nullptr)
               ? launch_stats<__nv_bfloat16, 8>(x, out, B, H, W, C, partial, counter, S, st)
               : launch_stats<__nv_bfloat16, 1>(x, out, B, H, W, C, partial, counter, S, st);
  return (int)cudaErrorInvalidValue;
}

// K3'.  x [B, H, W, C]; vecs f32 [B, 2 * out_mul, C] ((a, c) per output
// half); y [B, H, W, out_mul * C] in x's dtype.  Returns a cudaError_t code.
int fots_spatial_norm(const void* x, const float* vecs, void* y, int dtype, int B, int H,
                      int W, int C, int out_mul, float slope, int has_slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_mul != 1 && out_mul != 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return vectorizable(C, 4, x, y)
               ? launch_norm<float, 4>(x, vecs, y, B, H, W, C, out_mul, slope, has_slope, st)
               : launch_norm<float, 1>(x, vecs, y, B, H, W, C, out_mul, slope, has_slope, st);
  if (dtype == 1)
    return vectorizable(C, 2, x, y)
               ? launch_norm<__nv_bfloat16, 8>(x, vecs, y, B, H, W, C, out_mul, slope,
                                               has_slope, st)
               : launch_norm<__nv_bfloat16, 1>(x, vecs, y, B, H, W, C, out_mul, slope,
                                               has_slope, st);
  return (int)cudaErrorInvalidValue;
}

// rows of the K2' block for this (dtype, C): the wrapper sizes S with it
int fots_spatial_stats_rows(int dtype, int C) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int v = (C * itemsize) % 16 == 0 ? 16 / itemsize : 1;
  return fots::rows_for_lanes(C / v);
}

}  // extern "C"
