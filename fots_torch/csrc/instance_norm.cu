// Fused instance norm (+ affine + optional leaky-relu) over channels-last
// activations x [B, H, W, C], optionally with per-sample column masks.
//
// Replaces fots/ops/instance_norm.py:_instance_norm_pallas (the TPU kernel
// keeps a whole (H, W, channel-tile) block in VMEM and does statistics and
// normalisation in one read).  It also serves masked_instance_norm_jnp
// (statistics over columns < valid_w[n], output zero past them), which is
// XLA in the JAX package.
//
// What bounds it on an H100: bytes.  About five flops per element against 2
// to 8 bytes moved, far below the card's ~295 flops per byte.  Two routes,
// chosen from the shape alone by the Python plan (ops/instance_norm.py:
// in_plan), never by whether a launch failed:
//
// "cluster" (in_cluster_kernel): one read and one write of x.  One block
// cannot hold an (H, W) plane in its 227 KB of shared memory, but a
// thread-block cluster can: one cluster per (sample, channel group), a
// group being whole 32-byte sectors of a pixel, so that clusters never share
// one: two of them (64 bytes: 32 bf16 or 16 f32 channels) wherever C
// allows, because the card's memory moves 64 bytes at a time and 32-byte
// pieces were measured a quarter slower.  The cluster's blocks split the plane's pixels; each
// copies its share into shared memory with 16-byte cp.async (all of them in
// flight at once) and sums x and x^2 in f32 in a sweep over it; the sums are
// folded over the warp, the block and
// then the cluster's ranks in a fixed order through distributed shared
// memory (cluster.cuh), every block computes (mean, a) itself, normalises
// its share out of shared memory and writes y with 16-byte stores.  No
// workspace, no ticket, no memset.
//
// "two_pass" (in_stats_kernel + in_apply_kernel): for planes no cluster can
// hold, channel counts that are not a multiple of the group, and unaligned
// pointers.
//   (a) in_stats_kernel: blocks over (pixel chunk, sample).  Threads run
//       along C (contiguous in channels-last), 16-byte loads, f32 sum and
//       sum of squares per channel, reduced over the block's rows in shared
//       memory and written as a per-block partial [B, S, 2, C].  The last
//       block of each sample to finish (atomic ticket) folds the S partials
//       in a fixed order into per-(b, c) (a, mean) [B, 2, C]: results are
//       identical from run to run.  Under training it also writes the
//       per-(b, c) mean and rstd that instance_norm_bwd.cu reads.
//   (b) in_apply_kernel: y = (x - mean) * a + bias, optional leaky, zero
//       past valid_w (subtracting the mean first avoids the cancellation of
//       x * a + (bias - mean * a) when the variance is tiny),
//       16-byte loads and stores, f32 math, output in the input's dtype.
// Two reads and one write of x.
//
// Statistics follow instance_norm_jnp exactly (not Welford), on both routes:
//   mean = s1 / n, var = max(s2 / n - mean^2, 0), a = rsqrt(var + eps) * scale,
//   with n = H * valid_w[n] (H * W unmasked).  mean^2 is rounded before the
//   subtraction (no fused multiply-add), as the plain version rounds it: on
//   a two-pixel masked strip whose values nearly agree, the variance is the
//   few last bits of that difference.

#include "cluster.cuh"
#include "common.cuh"

namespace {

using fots::clamp_width;
using fots::counted_pixel;
using fots::from_f32;
using fots::kPixPerThread;
using fots::Pack;
using fots::to_f32;

// grid (S, B); block = rows * lanes threads, lanes = C / V.
// smem: 2 * blockDim.x * V floats.
template <typename T, int V>
__global__ void in_stats_kernel(const T* __restrict__ x, const int* __restrict__ valid_w,
                                const float* __restrict__ scale, const float* __restrict__ bias,
                                float* __restrict__ partial, float* __restrict__ coef,
                                float* __restrict__ stats, int* __restrict__ counter, int H,
                                int W, int C, int S, float eps) {
  extern __shared__ float sm[];
  const int n = blockIdx.y, s = blockIdx.x;
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  const int vw = clamp_width(valid_w, n, W);
  const long long npix = (long long)H * vw;
  const long long chunk = (npix + S - 1) / S;
  const long long p0 = (long long)s * chunk;
  const long long p1 = min(npix, p0 + chunk);
  const T* xs = x + (long long)n * H * W * C + lane * V;

  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; i++) s1[i] = s2[i] = 0.f;
  for (long long q = p0 + row; q < p1; q += rows) {
    const long long pix = counted_pixel(q, vw, W);
    const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(xs + pix * C);
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

  // the last block of sample n folds the S partials, in order s = 0..S-1
  if (!fots::last_block_of(counter + n, S)) return;
  const float cnt = (float)npix;
  const float* pn = partial + (long long)n * S * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < S; k++) {
      a += __ldcg(pn + (long long)k * 2 * C + c);
      b += __ldcg(pn + (long long)k * 2 * C + C + c);
    }
    const float mean = a / cnt;
    const float var = fmaxf(__fsub_rn(b / cnt, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(var + eps);
    const float mul = rstd * scale[c];
    coef[(long long)n * 2 * C + c] = mul;
    coef[(long long)n * 2 * C + C + c] = mean;
    if (stats != nullptr) {  // kept for the backward pass
      stats[(long long)n * 2 * C + c] = mean;
      stats[(long long)n * 2 * C + C + c] = rstd;
    }
  }
}

// grid (ceil(H*W / chunk_pix), B); block = rows * lanes threads.
// smem: 3 * C floats.
template <typename T, int V>
__global__ void in_apply_kernel(const T* __restrict__ x, const int* __restrict__ valid_w,
                                const float* __restrict__ coef, const float* __restrict__ bias,
                                T* __restrict__ y, int H, int W, int C, int chunk_pix,
                                float slope, int has_slope) {
  extern __shared__ float cs[];
  const int n = blockIdx.y;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) cs[c] = coef[(long long)n * 2 * C + c];
  for (int c = threadIdx.x; c < C; c += blockDim.x) cs[2 * C + c] = bias[c];
  __syncthreads();
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  if (row >= rows) return;
  const int vw = clamp_width(valid_w, n, W);
  const long long hw = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * chunk_pix;
  const long long p1 = min(hw, p0 + chunk_pix);
  const long long base = (long long)n * hw * C + lane * V;
  float a[V], m[V], b[V];
#pragma unroll
  for (int i = 0; i < V; i++) {
    a[i] = cs[lane * V + i];
    m[i] = cs[C + lane * V + i];
    b[i] = cs[2 * C + lane * V + i];
  }
  for (long long p = p0 + row; p < p1; p += rows) {
    Pack<T, V> out;
    if ((int)(p % W) < vw) {
      const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(x + base + p * C);
#pragma unroll
      for (int i = 0; i < V; i++) {
        float f = (to_f32(pk.v[i]) - m[i]) * a[i] + b[i];
        if (has_slope && f < 0.f) f *= slope;
        from_f32(f, out.v[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; i++) from_f32(0.f, out.v[i]);
    }
    *reinterpret_cast<Pack<T, V>*>(y + base + p * C) = out;
  }
}

// The cluster route.  grid (cluster * C / channels, B), clusters of `cluster`
// blocks along x: cluster blockIdx.x / cluster owns channels [c0, c0 +
// channels) of sample blockIdx.y, rank r of it pixels [r * chunk, (r + 1) *
// chunk).  Thread (row, lane) owns the 16-byte vector `lane` of pixels row,
// row + rows, ...: it reads back only what it stored itself.
// smem: chunk * channels values, then fold_scratch_floats() floats.
template <typename T, int V>
__global__ void __launch_bounds__(1024)
in_cluster_kernel(const T* __restrict__ x, T* __restrict__ y, const int* __restrict__ valid_w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  float* __restrict__ stats, int H, int W, int C, int channels, int chunk,
                  float eps, float slope, int has_slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  fots::cg::cluster_group cluster = fots::cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y;
  const int c0 = (blockIdx.x / cs) * channels;
  const int lanes = channels / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  const int vw = clamp_width(valid_w, n, W);
  const bool full = vw == W;
  const int hw = H * W;
  const int p0 = min(hw, rank * chunk);
  const int p1 = min(hw, p0 + chunk);
  Pack<T, V>* data = reinterpret_cast<Pack<T, V>*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + (size_t)chunk * channels * sizeof(T));
  const long long base = (long long)n * hw * C + c0 + lane * V;

  // every 16-byte copy of the share in flight at once (cp.async: no
  // registers wait on them), then a sweep over what this thread copied
  // itself, which needs no block barrier
  for (int p = p0 + row; p < p1; p += rows)
    if (full || p % W < vw)
      fots::cp_async_16(&data[(p - p0) * lanes + lane], x + base + (long long)p * C);
  fots::cp_async_wait_all();
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; i++) s1[i] = s2[i] = 0.f;
#pragma unroll 4
  for (int p = p0 + row; p < p1; p += rows) {
    if (!(full || p % W < vw)) continue;
    const Pack<T, V> pk = data[(p - p0) * lanes + lane];
#pragma unroll
    for (int i = 0; i < V; i++) {
      const float f = to_f32(pk.v[i]);
      s1[i] += f;
      s2[i] += f * f;
    }
  }
  const float* total = fots::cluster_fold<V>(s1, s2, lanes, lane, scratch);

  const float cnt = (float)((long long)H * vw);
  float a[V], m[V], b[V];
#pragma unroll
  for (int i = 0; i < V; i++) {
    const int k = lane * V + i;
    const float mean = total[k] / cnt;
    const float var = fmaxf(__fsub_rn(total[channels + k] / cnt, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(var + eps);
    a[i] = rstd * scale[c0 + k];
    m[i] = mean;
    b[i] = bias[c0 + k];
    if (stats != nullptr && rank == 0 && row == 0) {  // kept for the backward pass
      stats[(long long)n * 2 * C + c0 + k] = mean;
      stats[(long long)n * 2 * C + C + c0 + k] = rstd;
    }
  }
#pragma unroll 4
  for (int p = p0 + row; p < p1; p += rows) {
    Pack<T, V> out;
    if (full || p % W < vw) {
      const Pack<T, V> pk = data[(p - p0) * lanes + lane];
#pragma unroll
      for (int i = 0; i < V; i++) {
        float f = (to_f32(pk.v[i]) - m[i]) * a[i] + b[i];
        if (has_slope && f < 0.f) f *= slope;
        from_f32(f, out.v[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; i++) from_f32(0.f, out.v[i]);
    }
    *reinterpret_cast<Pack<T, V>*>(y + base + (long long)p * C) = out;
  }
  fots::cluster_fold_done();
}

template <typename T, int V>
int launch_cluster_route(const void* x, void* y, int B, int H, int W, int C, const int* valid_w,
                         const float* scale, const float* bias, float eps, float slope,
                         int has_slope, float* stats, const fots::ClusterShape& shape,
                         cudaStream_t stream) {
  const int lanes = shape.channels / V;
  if (shape.channels % V != 0 || C % shape.channels != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int chunk = (H * W + shape.cluster - 1) / shape.cluster;
  const size_t need = (size_t)chunk * shape.channels * sizeof(T) +
                      fots::fold_scratch_floats(shape.threads, shape.channels) * sizeof(float);
  if (need > (size_t)shape.smem) return (int)cudaErrorInvalidValue;
  return fots::launch_cluster(in_cluster_kernel<T, V>, shape,
                              dim3(shape.cluster * (C / shape.channels), B), stream,
                              static_cast<const T*>(x), static_cast<T*>(y), valid_w, scale, bias,
                              stats, H, W, C, shape.channels, chunk, eps, slope, has_slope);
}

template <typename T, int V>
int launch(const void* x, void* y, int B, int H, int W, int C, const int* valid_w,
           const float* scale, const float* bias, float eps, float slope, int has_slope,
           float* partial, float* coef, float* stats, int* counter, int S,
           cudaStream_t stream) {
  const int lanes = C / V;
  const int rows = fots::rows_for_lanes(lanes);
  const int threads = lanes * rows;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem_stats = 2 * (size_t)threads * V * sizeof(float);
  const size_t smem_apply = 3 * (size_t)C * sizeof(float);
  if (smem_stats > 48 * 1024 || smem_apply > 48 * 1024) return (int)cudaErrorInvalidConfiguration;
  in_stats_kernel<T, V><<<dim3(S, B), threads, smem_stats, stream>>>(
      static_cast<const T*>(x), valid_w, scale, bias, partial, coef, stats, counter, H, W, C, S,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunk_pix = rows * kPixPerThread;
  const long long blocks = ((long long)H * W + chunk_pix - 1) / chunk_pix;
  in_apply_kernel<T, V><<<dim3((unsigned)blocks, B), threads, smem_apply, stream>>>(
      static_cast<const T*>(x), valid_w, coef, bias, static_cast<T*>(y), H, W, C, chunk_pix,
      slope, has_slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: [B, H, W, C] contiguous.
// valid_w: int32 [B] device pointer or null.  scale, bias: f32 [C].
// The two-pass route.  Workspaces: partial f32 [B, S, 2, C], coef f32 [B, 2, C], counter int32
// [B] zeroed.  stats: f32 [B, 2, C] (mean, rstd) for the backward pass, or
// null.  Returns a cudaError_t code (0 = launched).
int fots_instance_norm(const void* x, void* y, int dtype, int B, int H, int W, int C,
                       const int* valid_w, const float* scale, const float* bias, float eps,
                       float slope, int has_slope, float* partial, float* coef, float* stats,
                       int* counter, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t itemsize = dtype == 0 ? 4 : 2;
  const bool vec = (C * itemsize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (dtype == 0) {
    if (vec)
      return launch<float, 4>(x, y, B, H, W, C, valid_w, scale, bias, eps, slope, has_slope,
                              partial, coef, stats, counter, S, st);
    return launch<float, 1>(x, y, B, H, W, C, valid_w, scale, bias, eps, slope, has_slope,
                            partial, coef, stats, counter, S, st);
  }
  if (dtype == 1) {
    if (vec)
      return launch<__nv_bfloat16, 8>(x, y, B, H, W, C, valid_w, scale, bias, eps, slope,
                                      has_slope, partial, coef, stats, counter, S, st);
    return launch<__nv_bfloat16, 1>(x, y, B, H, W, C, valid_w, scale, bias, eps, slope,
                                    has_slope, partial, coef, stats, counter, S, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The cluster route: same tensors, no workspace.  channels per cluster (a
// multiple of 32 bytes' worth, a power-of-two count of 16-byte vectors up to
// 32), blocks per cluster, threads per block (a multiple of 32) and dynamic
// shared memory per block come from the Python plan.  x and y must be
// 16-byte aligned and C a multiple of `channels`.  Returns a cudaError_t
// code (0 = launched), or -2 when the card cannot schedule such a cluster.
int fots_instance_norm_cluster(const void* x, void* y, int dtype, int B, int H, int W, int C,
                               const int* valid_w, const float* scale, const float* bias,
                               float eps, float slope, int has_slope, float* stats,
                               int channels, int cluster, int threads, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const fots::ClusterShape shape{channels, cluster, threads, smem};
  if (dtype == 0)
    return launch_cluster_route<float, 4>(x, y, B, H, W, C, valid_w, scale, bias, eps, slope,
                                          has_slope, stats, shape, st);
  if (dtype == 1)
    return launch_cluster_route<__nv_bfloat16, 8>(x, y, B, H, W, C, valid_w, scale, bias, eps,
                                                  slope, has_slope, stats, shape, st);
  return (int)cudaErrorInvalidValue;
}

// rows of the stats block for this (dtype, C): the wrapper sizes S with it
int fots_instance_norm_rows(int dtype, int C) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int v = (C * itemsize) % 16 == 0 ? 16 / itemsize : 1;
  return fots::rows_for_lanes(C / v);
}

}  // extern "C"
