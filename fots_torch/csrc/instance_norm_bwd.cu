// Backward of the fused instance norm (K1'-bwd): dx, and per-sample sums for
// dscale and dbias, of y = act(((u - mean) * rstd) * scale + bias) over
// channels-last u [B, H, W, Cu], with optional per-sample column masks.
//
// Replaces the VJP of fots/ops/instance_norm.py:_fused_in (jax.vjp of
// instance_norm_jnp, :151-157; XLA on the TPU) and of masked_instance_norm_jnp.
// A second mode computes the VJP of the CReLU-IN (fots/models/layers.py:
// CReLUIN, fots/ops/instance_norm.py:_crelu_half_jnp): u = cat(x, -x) over
// Cu = 2C channels, read from x once, with dx = du[:C] - du[C:] written
// directly, so the concat is never materialised; `groups` folds the
// statistics of an S2D tensor's sub-positions as the forward does.
//
// Math (mean and rstd saved by the forward, n counted pixels per sample):
//   z = (u - mean) * rstd, pre = z * scale + bias,
//   gp = g * act'(pre) (1 where pre >= 0, slope below; mask 0 past valid_w),
//   du = rstd * scale * (gp - sum(gp) / n - z * sum(gp * z) / n)
//      = gp * k1 + u * k2 + k3 per (b, channel),
//   dscale = sum over b, pixels of gp * z, dbias = sum of gp.
//
// What bounds it on an H100: bytes (about 12 flops per element, 12 bytes
// moved).  Two routes, as in the forward (instance_norm.cu), chosen from the
// shape alone by the Python plan:
//
// "cluster" (in_bwd_cluster_kernel; plain and masked IN, not the CReLU
// mode): one cluster per (sample, channel group of 32 or 64 bytes a pixel),
// its blocks split the pixels.  Each block copies its share of x and g into
// shared memory with 16-byte cp.async, leaves gp in g's place while it sums
// gp and gp * z; the sums are folded over warp, block and the cluster's ranks in a fixed order through
// distributed shared memory (cluster.cuh), every block computes (k1, k2, k3)
// and writes dx from shared memory; rank 0 writes the per-sample sums.
// Three tensor crossings, no workspace.
//
// "two_pass", for everything else (five crossings), layer1's training shape
// included: x and g of a 64-byte group of 8x160x240x64 exceed 16 blocks'
// shared memory, and with 32-byte groups the cluster route was measured
// slower than these two streaming passes:
//   (a) in_bwd_reduce_kernel: blocks over (pixel chunk, sample) read x and
//       g once and write per-block partials of sum(gp) and sum(gp * z)
//       [B, S, 2, Cu]; the last block of each sample (atomic ticket) folds
//       them in a fixed order into (k1, k2, k3) [B, 3, Cu] and the
//       per-sample sums [B, 2, Cu].  No float atomics: run-to-run identical.
//   (b) in_bwd_apply_kernel: reads x and g again and writes dx.
// Threads run along the contiguous channel axis with 16-byte loads.

#include "cluster.cuh"
#include "common.cuh"

namespace {

using fots::clamp_width;
using fots::counted_pixel;
using fots::kPixPerThread;
using fots::Pack;

struct BwdArgs {
  const float* x;        // [B, H, W, C]
  const float* g;        // [B, H, W, Cu]
  float* dx;             // [B, H, W, C]
  const int* valid_w;    // [B] or null
  const float* stats;    // [B, 2, Cu] (mean, rstd)
  const float* scale;    // [Cu]
  const float* bias;     // [Cu]
  float* partial;        // [B, S, 2, Cu]
  float* coef;           // [B, 3, Cu]
  float* dsb;            // [B, 2, Cu] (sum gp * z, sum gp)
  int* counter;          // [B], zeroed
  int H, W, C, groups, S;
  float slope;
  int has_slope;
};

template <int V, int HALVES>
struct Lane {
  float mean[HALVES][V], rstd[HALVES][V], sc[HALVES][V], bi[HALVES][V];

  __device__ void load(const BwdArgs& a, int n, int lane) {
    const int Cu = HALVES * a.C;
    const float* st = a.stats + (long long)n * 2 * Cu;
#pragma unroll
    for (int h = 0; h < HALVES; h++)
#pragma unroll
      for (int i = 0; i < V; i++) {
        const int k = h * a.C + lane * V + i;
        mean[h][i] = st[k];
        rstd[h][i] = st[Cu + k];
        sc[h][i] = a.scale[k];
        bi[h][i] = a.bias[k];
      }
  }

  // u, z and gp of channel (h, i) at one pixel.  z and pre round like the
  // plain version's separate operations (no fused multiply-add), so the
  // activation's gate agrees with it bit for bit.
  __device__ __forceinline__ void at(const BwdArgs& a, int h, int i, float xv, float gv, float& u,
                                     float& z, float& gp) const {
    u = h ? -xv : xv;
    z = __fmul_rn(__fsub_rn(u, mean[h][i]), rstd[h][i]);
    const float pre = __fadd_rn(__fmul_rn(z, sc[h][i]), bi[h][i]);
    gp = (a.has_slope && pre < 0.f) ? __fmul_rn(gv, a.slope) : gv;
  }
};

// grid (S, B); block = rows * lanes threads, lanes = C / V.
// smem: 2 * rows * Cu floats.
template <int V, int HALVES>
__global__ void in_bwd_reduce_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  const int n = blockIdx.y, s = blockIdx.x;
  const int C = a.C, W = a.W, S = a.S;
  const int Cu = HALVES * C;
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  const int vw = clamp_width(a.valid_w, n, W);
  const long long npix = (long long)a.H * vw;
  const long long chunk = (npix + S - 1) / S;
  const long long p0 = (long long)s * chunk;
  const long long p1 = min(npix, p0 + chunk);
  const float* xs = a.x + (long long)n * a.H * W * C + lane * V;
  const float* gs = a.g + (long long)n * a.H * W * Cu + lane * V;

  Lane<V, HALVES> L;
  L.load(a, n, lane);
  float sg[HALVES][V], sgz[HALVES][V];
#pragma unroll
  for (int h = 0; h < HALVES; h++)
#pragma unroll
    for (int i = 0; i < V; i++) sg[h][i] = sgz[h][i] = 0.f;
  for (long long q = p0 + row; q < p1; q += rows) {
    const long long pix = counted_pixel(q, vw, W);
    const Pack<float, V> xv = *reinterpret_cast<const Pack<float, V>*>(xs + pix * C);
#pragma unroll
    for (int h = 0; h < HALVES; h++) {
      const Pack<float, V> gv =
          *reinterpret_cast<const Pack<float, V>*>(gs + pix * Cu + h * C);
#pragma unroll
      for (int i = 0; i < V; i++) {
        float u, z, gp;
        L.at(a, h, i, xv.v[i], gv.v[i], u, z, gp);
        sg[h][i] += gp;
        sgz[h][i] += gp * z;
      }
    }
  }
  float* sm1 = sm;
  float* sm2 = sm + rows * Cu;
#pragma unroll
  for (int h = 0; h < HALVES; h++)
#pragma unroll
    for (int i = 0; i < V; i++) {
      sm1[row * Cu + h * C + lane * V + i] = sg[h][i];
      sm2[row * Cu + h * C + lane * V + i] = sgz[h][i];
    }
  __syncthreads();
  float* part = a.partial + ((long long)n * S + s) * 2 * Cu;
  for (int k = threadIdx.x; k < Cu; k += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < rows; r++) {
      t1 += sm1[r * Cu + k];
      t2 += sm2[r * Cu + k];
    }
    part[k] = t1;
    part[Cu + k] = t2;
  }

  // the last block of sample n folds the partials, s = 0..S-1 in order
  if (!fots::last_block_of(a.counter + n, S)) return;
  const float* pn = a.partial + (long long)n * S * 2 * Cu;
  const int cg = C / a.groups;
  const float cnt = (float)(npix * a.groups);
  const float* st = a.stats + (long long)n * 2 * Cu;
  for (int k = threadIdx.x; k < Cu; k += blockDim.x) {
    float own_g = 0.f, own_gz = 0.f;
    for (int j = 0; j < S; j++) {
      own_g += __ldcg(pn + (long long)j * 2 * Cu + k);
      own_gz += __ldcg(pn + (long long)j * 2 * Cu + Cu + k);
    }
    a.dsb[(long long)n * 2 * Cu + k] = own_gz;
    a.dsb[(long long)n * 2 * Cu + Cu + k] = own_g;
    float tg = own_g, tgz = own_gz;
    if (a.groups > 1) {  // statistics are per (half, channel within group)
      const int h = k / C, c0 = (k % C) % cg;
      tg = tgz = 0.f;
      for (int grp = 0; grp < a.groups; grp++) {
        const int kk = h * C + grp * cg + c0;
        for (int j = 0; j < S; j++) {
          tg += __ldcg(pn + (long long)j * 2 * Cu + kk);
          tgz += __ldcg(pn + (long long)j * 2 * Cu + Cu + kk);
        }
      }
    }
    const float m = st[k], r = st[Cu + k], sck = a.scale[k];
    const float mdz = sck * tg / cnt;    // mean of dz = gp * scale
    const float mdzz = sck * tgz / cnt;  // mean of dz * z
    float* cf = a.coef + (long long)n * 3 * Cu;
    cf[k] = r * sck;
    cf[Cu + k] = -r * r * mdzz;
    cf[2 * Cu + k] = r * (r * m * mdzz - mdz);
  }
}

// grid (ceil(H*W / chunk_pix), B); block = rows * lanes threads.
template <int V, int HALVES>
__global__ void in_bwd_apply_kernel(BwdArgs a, int chunk_pix) {
  const int n = blockIdx.y;
  const int C = a.C, W = a.W;
  const int Cu = HALVES * C;
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  Lane<V, HALVES> L;
  L.load(a, n, lane);
  float k1[HALVES][V], k2[HALVES][V], k3[HALVES][V];
  const float* cf = a.coef + (long long)n * 3 * Cu;
#pragma unroll
  for (int h = 0; h < HALVES; h++)
#pragma unroll
    for (int i = 0; i < V; i++) {
      const int k = h * C + lane * V + i;
      k1[h][i] = cf[k];
      k2[h][i] = cf[Cu + k];
      k3[h][i] = cf[2 * Cu + k];
    }
  const int vw = clamp_width(a.valid_w, n, W);
  const long long hw = (long long)a.H * W;
  const long long p0 = (long long)blockIdx.x * chunk_pix;
  const long long p1 = min(hw, p0 + chunk_pix);
  const float* xs = a.x + (long long)n * hw * C + lane * V;
  const float* gs = a.g + (long long)n * hw * Cu + lane * V;
  float* ds = a.dx + (long long)n * hw * C + lane * V;
  for (long long p = p0 + row; p < p1; p += rows) {
    Pack<float, V> out;
#pragma unroll
    for (int i = 0; i < V; i++) out.v[i] = 0.f;
    if ((int)(p % W) < vw) {
      const Pack<float, V> xv = *reinterpret_cast<const Pack<float, V>*>(xs + p * C);
#pragma unroll
      for (int h = 0; h < HALVES; h++) {
        const Pack<float, V> gv =
            *reinterpret_cast<const Pack<float, V>*>(gs + p * Cu + h * C);
#pragma unroll
        for (int i = 0; i < V; i++) {
          float u, z, gp;
          L.at(a, h, i, xv.v[i], gv.v[i], u, z, gp);
          const float du = gp * k1[h][i] + u * k2[h][i] + k3[h][i];
          out.v[i] += h ? -du : du;
        }
      }
    }
    *reinterpret_cast<Pack<float, V>*>(ds + p * C) = out;
  }
}

// The cluster route (halves == 1).  Grid, ranks and thread ownership as in
// in_cluster_kernel (instance_norm.cu).  smem: chunk * channels floats of gp,
// the same of x, then fold_scratch_floats() floats.
__global__ void __launch_bounds__(1024) in_bwd_cluster_kernel(BwdArgs a, int channels,
                                                              int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 4;
  fots::cg::cluster_group cluster = fots::cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y;
  const int C = a.C, W = a.W;
  const int c0 = (blockIdx.x / cs) * channels;
  const int lanes = channels / V;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int rows = blockDim.x / lanes;
  const int vw = clamp_width(a.valid_w, n, W);
  const bool full = vw == W;
  const int hw = a.H * W;
  const int p0 = min(hw, rank * chunk);
  const int p1 = min(hw, p0 + chunk);
  Pack<float, V>* gps = reinterpret_cast<Pack<float, V>*>(smem);
  Pack<float, V>* xs = gps + (size_t)chunk * lanes;
  float* scratch = reinterpret_cast<float*>(smem) + (size_t)chunk * channels * 2;
  const long long base = (long long)n * hw * C + c0 + lane * V;

  Lane<V, 1> L;
  L.load(a, n, c0 / V + lane);
  // every 16-byte copy of x and g in flight at once, then a sweep over this
  // thread's own vectors that leaves gp in g's place
  for (int p = p0 + row; p < p1; p += rows) {
    if (!(full || p % W < vw)) continue;
    const int slot = (p - p0) * lanes + lane;
    fots::cp_async_16(&gps[slot], a.g + base + (long long)p * C);
    fots::cp_async_16(&xs[slot], a.x + base + (long long)p * C);
  }
  fots::cp_async_wait_all();
  float sg[V], sgz[V];
#pragma unroll
  for (int i = 0; i < V; i++) sg[i] = sgz[i] = 0.f;
#pragma unroll 2
  for (int p = p0 + row; p < p1; p += rows) {
    if (!(full || p % W < vw)) continue;
    const int slot = (p - p0) * lanes + lane;
    const Pack<float, V> xv = xs[slot], gv = gps[slot];
    Pack<float, V> gp;
#pragma unroll
    for (int i = 0; i < V; i++) {
      float u, z;
      L.at(a, 0, i, xv.v[i], gv.v[i], u, z, gp.v[i]);
      sg[i] += gp.v[i];
      sgz[i] += gp.v[i] * z;
    }
    gps[slot] = gp;
  }
  const float* total = fots::cluster_fold<V>(sg, sgz, lanes, lane, scratch);

  const float cnt = (float)((long long)a.H * vw);
  float k1[V], k2[V], k3[V];
#pragma unroll
  for (int i = 0; i < V; i++) {
    const int k = lane * V + i;
    const float tg = total[k], tgz = total[channels + k];
    const float m = L.mean[0][i], r = L.rstd[0][i], sck = L.sc[0][i];
    const float mdz = sck * tg / cnt;    // mean of dz = gp * scale
    const float mdzz = sck * tgz / cnt;  // mean of dz * z
    k1[i] = r * sck;
    k2[i] = -r * r * mdzz;
    k3[i] = r * (r * m * mdzz - mdz);
    if (rank == 0 && row == 0) {
      a.dsb[(long long)n * 2 * C + c0 + k] = tgz;
      a.dsb[(long long)n * 2 * C + C + c0 + k] = tg;
    }
  }
#pragma unroll 4
  for (int p = p0 + row; p < p1; p += rows) {
    Pack<float, V> out;
#pragma unroll
    for (int i = 0; i < V; i++) out.v[i] = 0.f;
    if (full || p % W < vw) {
      const int slot = (p - p0) * lanes + lane;
      const Pack<float, V> gp = gps[slot], xv = xs[slot];
#pragma unroll
      for (int i = 0; i < V; i++) out.v[i] = gp.v[i] * k1[i] + xv.v[i] * k2[i] + k3[i];
    }
    *reinterpret_cast<Pack<float, V>*>(a.dx + base + (long long)p * C) = out;
  }
  fots::cluster_fold_done();
}

int launch_cluster_route(const BwdArgs& a, int B, const fots::ClusterShape& shape,
                         cudaStream_t stream) {
  const int chunk = (a.H * a.W + shape.cluster - 1) / shape.cluster;
  const size_t need = ((size_t)chunk * shape.channels * 2 +
                       fots::fold_scratch_floats(shape.threads, shape.channels)) *
                      sizeof(float);
  if (need > (size_t)shape.smem) return (int)cudaErrorInvalidValue;
  return fots::launch_cluster(in_bwd_cluster_kernel, shape,
                              dim3(shape.cluster * (a.C / shape.channels), B), stream, a,
                              shape.channels, chunk);
}

template <int V, int HALVES>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const int lanes = a.C / V;
  const int rows = fots::rows_for_lanes(lanes);
  const int threads = lanes * rows;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = 2 * (size_t)rows * HALVES * a.C * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidConfiguration;
  in_bwd_reduce_kernel<V, HALVES><<<dim3(a.S, B), threads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunk_pix = rows * kPixPerThread;
  const long long blocks = ((long long)a.H * a.W + chunk_pix - 1) / chunk_pix;
  in_bwd_apply_kernel<V, HALVES><<<dim3((unsigned)blocks, B), threads, 0, stream>>>(a,
                                                                                    chunk_pix);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 only.  x, dx: [B, H, W, C]; g: [B, H, W, halves * C], all contiguous.
// halves: 1 = plain IN of x, 2 = CReLU-IN (u = cat(x, -x)).  groups > 1
// (halves == 2 only) folds statistics over C / groups channel groups.
// stats [B, 2, Cu] (mean, rstd) and scale/bias [Cu] are per u channel
// (tiled over groups).  The two-pass route.  Workspaces: partial [B, S, 2, Cu], coef [B, 3, Cu],
// counter int32 [B] zeroed.  Output dsb [B, 2, Cu]: per-sample sums of
// gp * z and gp (dscale and dbias before the sum over the batch).
// Returns a cudaError_t code (0 = launched).
int fots_instance_norm_bwd(const float* x, const float* g, float* dx, int B, int H, int W,
                           int C, int halves, int groups, const int* valid_w,
                           const float* stats, const float* scale, const float* bias,
                           float slope, int has_slope, float* partial, float* coef, float* dsb,
                           int* counter, int S, void* stream) {
  if ((halves != 1 && halves != 2) || groups < 1 || C % groups != 0 ||
      (groups > 1 && halves != 2))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{x, g, dx, valid_w, stats, scale, bias, partial, coef, dsb, counter,
            H, W, C, groups, S, slope, has_slope};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (halves == 1) return vec ? launch<4, 1>(a, B, st) : launch<1, 1>(a, B, st);
  return vec ? launch<4, 2>(a, B, st) : launch<1, 2>(a, B, st);
}

// The cluster route of the plain and masked IN (halves 1, groups 1): same
// tensors, no workspace.  channels, cluster, threads and smem come from the
// Python plan, as for fots_instance_norm_cluster.  Returns a cudaError_t
// code (0 = launched), or -2 when the card cannot schedule such a cluster.
int fots_instance_norm_bwd_cluster(const float* x, const float* g, float* dx, int B, int H,
                                   int W, int C, const int* valid_w, const float* stats,
                                   const float* scale, const float* bias, float slope,
                                   int has_slope, float* dsb, int channels,
                                   int cluster, int threads, int smem, void* stream) {
  const int lanes = channels / 4;
  if (channels % 4 != 0 || C % channels != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  BwdArgs a{x, g, dx, valid_w, stats, scale, bias, nullptr, nullptr, dsb, nullptr,
            H, W, C, 1, 0, slope, has_slope};
  const fots::ClusterShape shape{channels, cluster, threads, smem};
  return launch_cluster_route(a, B, shape, static_cast<cudaStream_t>(stream));
}

// rows of the reduce block for this C: the wrapper sizes S with it
int fots_instance_norm_bwd_rows(int C) {
  return fots::rows_for_lanes(C % 4 == 0 ? C / 4 : C);
}

}  // extern "C"
