// Fused conv3x3 (SAME) + instance norm + affine (+ residual) + ReLU / leaky
// over channels-last activations: out = act(IN(conv(x, w)) * scale + bias [+ r]),
// x, r, out [N, H, W, C], w [3, 3, C_in, C_out] (HWIO, C_in = C_out = C).
//
// Replaces fots/ops/fused_block.py:_conv_in_act_pallas.  The TPU kernel walks
// row tiles in grid order, carries the per-channel sums in VMEM from tile to
// tile, keeps the whole weight tensor in VMEM and computes the convolution
// twice (statistics pass, then normalise pass) so that the convolution's
// output never reaches device memory: on that chip the matrix unit idles and
// bytes are what costs.
//
// What bounds it on an H100: operations.  At 16x88x160x128 bf16 one
// convolution is 66.4 GFLOP (0.067 ms at 989 TFLOP/s) and one activation
// tensor 57.7 MB (0.017 ms at 3.35 TB/s).  Convolving twice costs 0.134 ms of
// tensor-core time against 0.069 ms for its four tensors; convolving once and
// keeping the pre-norm output costs 0.067 ms of tensor-core time and five
// tensors (x, y written, y read, r, out), 0.086 ms.  A kernel that does not
// reach the tensor cores' peak loses twice as much by recomputing, so this
// port convolves ONCE:
//   (1) conv_stats_*_kernel: blocks over (column tile, row tile, sample), in no
//       order.  A block stages its rows of x with a one-pixel halo, zero
//       outside the map (SAME padding), in shared memory, streams the nine
//       [C_in, C_out] taps of w through shared memory (all nine do not fit in
//       227 KB; they stay in L2), accumulates in f32, takes the per-channel sum
//       and sum of squares of the f32 accumulator over the pixels inside the
//       map, and writes the accumulator as y in x's type.  The per-block sums
//       go to a partial buffer; the last block of each sample to finish (an
//       atomic ticket) folds them in block order, never with float atomics, so
//       results repeat from run to run, into per-(n, c) a = rsqrt(var + eps) *
//       scale and c = bias - mean * a.
//   (2) apply_kernel: out = act(y * a + c [+ r]) in f32, one cast at the end.
// bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix; a warp owns
// 32 pixels of one row and all C output channels, taps double-buffered with
// cp.async.  f32: plain FMA on the CUDA cores (no TF32), so the result is f32
// up to summation order.  The statistics are those of the f32 accumulator, as
// on the TPU; what is normalised is that accumulator rounded to x's type (for
// bf16, what the plain version normalises too).
//
// Any H and W (ragged tiles are masked); C a multiple of 16 up to 128.

#include "common.cuh"

namespace {

using fots::from_f32;
using fots::Pack;
using fots::to_f32;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32;    // output columns per block, both kernels
constexpr int kMmaTileH = 8;  // output rows per block: one per warp
constexpr int kFmaTileH = 4;
constexpr int kFmaGroups = 16;  // pixel groups (and channel groups) of the FMA block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Every thread calls this after the block's per-channel sums lie in shared
// memory as red[2][R][C] (sum, then sum of squares; R partial rows, folded here
// in order) and a __syncthreads().  Writes the block's partial; the last block
// of the sample folds all partials in block order into coef[n] = (a, c).
__device__ void fold_block(const float* red, int R, int C, float* __restrict__ partial,
                           float* __restrict__ coef, int* __restrict__ counter,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           float npix, float eps) {
  const int n = blockIdx.z;
  const int nblk = gridDim.x * gridDim.y;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  float* part = partial + ((long long)n * nblk + blk) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    const int which = c / C, ch = c % C;
    float s = 0.f;
    for (int r = 0; r < R; r++) s += red[(which * R + r) * C + ch];
    part[c] = s;
  }
  if (!fots::last_block_of(counter + n, nblk)) return;
  const float* pn = partial + (long long)n * nblk * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < nblk; k++) {
      s1 += __ldcg(pn + (long long)k * 2 * C + c);
      s2 += __ldcg(pn + (long long)k * 2 * C + C + c);
    }
    const float mean = s1 / npix;
    const float var = fmaxf(s2 / npix - mean * mean, 0.f);
    const float a = rsqrtf(var + eps) * scale[c];
    coef[(long long)n * 2 * C + c] = a;
    coef[(long long)n * 2 * C + C + c] = bias[c] - mean * a;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.  grid (ceil(W / 32), ceil(H / 8), N), 256 threads.
// Shared memory: x tile [10][34][C + 8], two weight taps [C][C + 8] (the + 8
// keeps ldmatrix's eight 16-byte rows on distinct banks), red [2][8][C] f32.
// ---------------------------------------------------------------------------
template <int C>
constexpr size_t mma_smem_bytes() {
  return (size_t)((kMmaTileH + 2) * (kTileW + 2) + 2 * C) * (C + 8) * sizeof(bf16) +
         (size_t)2 * kWarps * C * sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    conv_stats_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          bf16* __restrict__ y, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* __restrict__ partial,
                          float* __restrict__ coef, int* __restrict__ counter, int H, int W,
                          float eps) {
  constexpr int CP = C + 8;          // padded channel stride, elements
  constexpr int XW = kTileW + 2;     // tile columns with the halo
  constexpr int XP = (kMmaTileH + 2) * XW;
  constexpr int CH = C / 8;          // 16-byte chunks per pixel / per weight row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = xs + XP * CP;
  float* red = reinterpret_cast<float*>(ws + 2 * C * CP);

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int n = blockIdx.z, h0 = blockIdx.y * kMmaTileH, w0 = blockIdx.x * kTileW;
  const bf16* xn = x + (long long)n * H * W * C;

  for (int idx = tid; idx < XP * CH; idx += kThreads) {
    const int p = idx / CH, ch = idx % CH;
    const int hh = h0 - 1 + p / XW, ww = w0 - 1 + p % XW;
    bf16* dst = xs + p * CP + ch * 8;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      cp_async16(dst, xn + ((long long)hh * W + ww) * C + ch * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  auto load_tap = [&](int t) {
    const bf16* wt = w + (long long)t * C * C;
    bf16* dst = ws + (t & 1) * C * CP;
    for (int idx = tid; idx < C * CH; idx += kThreads) {
      const int k = idx / CH, ch = idx % CH;
      cp_async16(dst + k * CP + ch * 8, wt + k * C + ch * 8);
    }
  };
  load_tap(0);
  cp_async_commit();

  // acc[i][jt][r]: pixel column i * 16 + lane / 4 + 8 * (r / 2) of row wid,
  // channel jt * 8 + 2 * (lane % 4) + r % 2
  float acc[2][C / 8][4];
#pragma unroll
  for (int i = 0; i < 2; i++)
#pragma unroll
    for (int jt = 0; jt < C / 8; jt++)
#pragma unroll
      for (int r = 0; r < 4; r++) acc[i][jt][r] = 0.f;

#pragma unroll 1
  for (int t = 0; t < 9; t++) {
    if (t + 1 < 9) {  // tap t + 1 arrives while tap t is multiplied
      load_tap(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int ky = t / 3, kx = t % 3;
    // ldmatrix x4: lane l points at row l % 16, columns (l / 16) * 8 .. + 7
    const uint32_t a_base =
        smem_u32(xs + ((wid + ky) * XW + kx + (lane & 15)) * CP + (lane >> 4) * 8);
    const uint32_t b_base = smem_u32(ws + (t & 1) * C * CP + (lane & 15) * CP + (lane >> 4) * 8);
#pragma unroll 2
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t a[2][4];
      ldmatrix_x4(a[0], a_base + k0 * 2);
      ldmatrix_x4(a[1], a_base + (16 * CP + k0) * 2);
#pragma unroll
      for (int jn = 0; jn < C / 16; jn++) {
        uint32_t b[4];  // (b0, b1) of channels jn * 16 .. + 7, then of + 8 .. + 15
        ldmatrix_x4_trans(b, b_base + (k0 * CP + jn * 16) * 2);
#pragma unroll
        for (int i = 0; i < 2; i++) {
          mma_bf16(acc[i][2 * jn], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jn + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this tap's buffer is free for tap t + 2
  }

  const int g = lane >> 2, tq = lane & 3;
  const int hh = h0 + wid;
  bf16* yn = y + (long long)n * H * W * C;
  float* red1 = red;
  float* red2 = red + kWarps * C;
#pragma unroll
  for (int jt = 0; jt < C / 8; jt++) {
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; i++) {
#pragma unroll
      for (int half = 0; half < 2; half++) {
        const int ww = w0 + i * 16 + g + 8 * half;
        if (hh < H && ww < W) {
          const float v0 = acc[i][jt][2 * half], v1 = acc[i][jt][2 * half + 1];
          s1[0] += v0;
          s1[1] += v1;
          s2[0] += v0 * v0;
          s2[1] += v1 * v1;
          *reinterpret_cast<__nv_bfloat162*>(yn + ((long long)hh * W + ww) * C + jt * 8 + 2 * tq) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // over the 8 pixel rows of the fragment
#pragma unroll
      for (int e = 0; e < 2; e++) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; e++) {
        red1[wid * C + jt * 8 + 2 * tq + e] = s1[e];
        red2[wid * C + jt * 8 + 2 * tq + e] = s2[e];
      }
    }
  }
  __syncthreads();
  fold_block(red, kWarps, C, partial, coef, counter, scale, bias, (float)H * (float)W, eps);
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores.  grid (ceil(W / 32), ceil(H / 4), N), 256
// threads = 16 pixel groups (8 columns of one row each) x 16 channel groups
// (channels cg, cg + 16, ...).  Shared memory: x tile [6][34][C + 1], one
// weight tap [C][C], red [2][16][C].
// ---------------------------------------------------------------------------
template <int C>
constexpr size_t fma_smem_bytes() {
  return ((size_t)(kFmaTileH + 2) * (kTileW + 2) * (C + 1) + (size_t)C * C +
          (size_t)2 * kFmaGroups * C) * sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    conv_stats_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ y, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* __restrict__ partial,
                          float* __restrict__ coef, int* __restrict__ counter, int H, int W,
                          float eps) {
  constexpr int CP = C + 1;
  constexpr int XW = kTileW + 2;
  constexpr int XP = (kFmaTileH + 2) * XW;
  constexpr int J = C / kFmaGroups;  // channels per thread
  constexpr int PP = 8;              // pixels per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ws = xs + XP * CP;
  float* red = ws + C * C;

  const int tid = threadIdx.x;
  const int cg = tid % kFmaGroups, pg = tid / kFmaGroups;
  const int row = pg / 4, colb = (pg % 4) * PP;
  const int n = blockIdx.z, h0 = blockIdx.y * kFmaTileH, w0 = blockIdx.x * kTileW;
  const float* xn = x + (long long)n * H * W * C;

  for (int idx = tid; idx < XP * C; idx += kThreads) {
    const int p = idx / C, c = idx % C;
    const int hh = h0 - 1 + p / XW, ww = w0 - 1 + p % XW;
    const bool inside = hh >= 0 && hh < H && ww >= 0 && ww < W;
    xs[p * CP + c] = inside ? xn[((long long)hh * W + ww) * C + c] : 0.f;
  }

  float acc[PP][J];
#pragma unroll
  for (int p = 0; p < PP; p++)
#pragma unroll
    for (int j = 0; j < J; j++) acc[p][j] = 0.f;

#pragma unroll 1
  for (int t = 0; t < 9; t++) {
    __syncthreads();  // the tile is staged / the last tap is consumed
    const float* wt = w + (long long)t * C * C;
    for (int idx = tid; idx < C * C; idx += kThreads) ws[idx] = wt[idx];
    __syncthreads();
    const int ky = t / 3, kx = t % 3;
    const float* xr = xs + ((row + ky) * XW + colb + kx) * CP;
#pragma unroll 4
    for (int k = 0; k < C; k++) {
      float xv[PP];
#pragma unroll
      for (int p = 0; p < PP; p++) xv[p] = xr[p * CP + k];
#pragma unroll
      for (int j = 0; j < J; j++) {
        const float wv = ws[k * C + cg + kFmaGroups * j];
#pragma unroll
        for (int p = 0; p < PP; p++) acc[p][j] = fmaf(xv[p], wv, acc[p][j]);
      }
    }
  }

  const int hh = h0 + row;
  float* yn = y + (long long)n * H * W * C;
  float* red1 = red;
  float* red2 = red + kFmaGroups * C;
#pragma unroll
  for (int j = 0; j < J; j++) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int p = 0; p < PP; p++) {
      const int ww = w0 + colb + p;
      if (hh < H && ww < W) {
        const float v = acc[p][j];
        s1 += v;
        s2 += v * v;
        yn[((long long)hh * W + ww) * C + cg + kFmaGroups * j] = v;
      }
    }
    red1[pg * C + cg + kFmaGroups * j] = s1;
    red2[pg * C + cg + kFmaGroups * j] = s2;
  }
  __syncthreads();
  fold_block(red, kFmaGroups, C, partial, coef, counter, scale, bias, (float)H * (float)W, eps);
}

// out = act(y * a + c [+ r]).  grid (ceil(H * W / chunk_pix), N); block = rows *
// lanes threads, lanes = C / V.  smem: 2 * C floats.
template <typename T, int V>
__global__ void apply_kernel(const T* __restrict__ y, const T* __restrict__ r,
                             const float* __restrict__ coef, T* __restrict__ out, long long HW,
                             int C, int chunk_pix, float slope, int has_slope) {
  extern __shared__ float cs[];
  const int n = blockIdx.y;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) cs[c] = coef[(long long)n * 2 * C + c];
  __syncthreads();
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  const long long p0 = (long long)blockIdx.x * chunk_pix;
  const long long p1 = min(HW, p0 + chunk_pix);
  const long long base = (long long)n * HW * C + lane * V;
  float a[V], c[V];
#pragma unroll
  for (int i = 0; i < V; i++) {
    a[i] = cs[lane * V + i];
    c[i] = cs[C + lane * V + i];
  }
  for (long long p = p0 + row; p < p1; p += rows) {
    const Pack<T, V> yv = *reinterpret_cast<const Pack<T, V>*>(y + base + p * C);
    Pack<T, V> rv, ov;
    if (r != nullptr) rv = *reinterpret_cast<const Pack<T, V>*>(r + base + p * C);
#pragma unroll
    for (int i = 0; i < V; i++) {
      float z = to_f32(yv.v[i]) * a[i] + c[i];
      if (r != nullptr) z += to_f32(rv.v[i]);
      z = has_slope ? (z >= 0.f ? z : z * slope) : fmaxf(z, 0.f);
      from_f32(z, ov.v[i]);
    }
    *reinterpret_cast<Pack<T, V>*>(out + base + p * C) = ov;
  }
}

template <typename T, int V>
int launch_apply(const void* y, const void* r, const float* coef, void* out, int N, int H, int W,
                 int C, float slope, int has_slope, cudaStream_t stream) {
  const int lanes = C / V;
  const int rows = fots::rows_for_lanes(lanes);
  const int chunk_pix = rows * fots::kPixPerThread;
  const long long hw = (long long)H * W;
  const long long blocks = (hw + chunk_pix - 1) / chunk_pix;
  apply_kernel<T, V><<<dim3((unsigned)blocks, N), lanes * rows, 2 * C * sizeof(float), stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(r), coef, static_cast<T*>(out), hw, C,
      chunk_pix, slope, has_slope);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bf16(const void* x, const void* w, const void* r, void* y, void* out, int N, int H,
                int W, const float* scale, const float* bias, float eps, float slope,
                int has_slope, float* partial, float* coef, int* counter, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_stats_mma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)mma_smem_bytes<C>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kMmaTileH - 1) / kMmaTileH, N);
  conv_stats_mma_kernel<C><<<grid, kThreads, mma_smem_bytes<C>(), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), scale, bias,
      partial, coef, counter, H, W, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_apply<bf16, 8>(y, r, coef, out, N, H, W, C, slope, has_slope, stream);
}

template <int C>
int launch_f32(const void* x, const void* w, const void* r, void* y, void* out, int N, int H,
               int W, const float* scale, const float* bias, float eps, float slope, int has_slope,
               float* partial, float* coef, int* counter, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_stats_fma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)fma_smem_bytes<C>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kFmaTileH - 1) / kFmaTileH, N);
  conv_stats_fma_kernel<C><<<grid, kThreads, fma_smem_bytes<C>(), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), scale,
      bias, partial, coef, counter, H, W, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_apply<float, 4>(y, r, coef, out, N, H, W, C, slope, has_slope, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, residual (or null), y (scratch: the
// pre-norm convolution), out: [N, H, W, C] contiguous, 16-byte aligned.  w:
// [3, 3, C, C] HWIO in x's type.  scale, bias: f32 [C].  Workspaces: partial f32
// [N, fots_conv_in_act_blocks(dtype, H, W), 2, C], coef f32 [N, 2, C], counter
// int32 [N] zeroed.  C: a multiple of 16 up to 128.  Returns a cudaError_t
// code (0 = launched).
int fots_conv_in_act(const void* x, const void* w, const void* residual, void* y, void* out,
                     int dtype, int N, int H, int W, int C, const float* scale, const float* bias,
                     float eps, float slope, int has_slope, float* partial, float* coef,
                     int* counter, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FOTS_K5_CASE(CC)                                                                       \
  case CC:                                                                                     \
    return dtype == 1 ? launch_bf16<CC>(x, w, residual, y, out, N, H, W, scale, bias, eps,     \
                                        slope, has_slope, partial, coef, counter, st)          \
                      : launch_f32<CC>(x, w, residual, y, out, N, H, W, scale, bias, eps,      \
                                       slope, has_slope, partial, coef, counter, st);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    FOTS_K5_CASE(16)
    FOTS_K5_CASE(32)
    FOTS_K5_CASE(48)
    FOTS_K5_CASE(64)
    FOTS_K5_CASE(80)
    FOTS_K5_CASE(96)
    FOTS_K5_CASE(112)
    FOTS_K5_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FOTS_K5_CASE
}

// statistics blocks per sample for this (dtype, H, W): sizes `partial`
int fots_conv_in_act_blocks(int dtype, int H, int W) {
  const int th = dtype == 1 ? kMmaTileH : kFmaTileH;
  return ((W + kTileW - 1) / kTileW) * ((H + th - 1) / th);
}

}  // extern "C"
