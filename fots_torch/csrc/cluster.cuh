// Helpers of the single-pass ("cluster") route of the instance-norm kernels
// (instance_norm.cu, instance_norm_bwd.cu): a thread-block cluster keeps one
// (H, W, channel-group) plane in its blocks' shared memory between the
// statistics and the apply step, so every tensor crosses device memory once.
//
// - lane_sum / cluster_fold: per-channel sums over a thread's pixels, then
//   over the warp (a fixed xor butterfly), the block's warps in warp order
//   and the cluster's blocks in rank order through distributed shared
//   memory.  Every block folds the same numbers in the same order: results
//   are identical from run to run, with no float atomics, no ticket and no
//   workspace in device memory.
// - launch_cluster: cudaLaunchKernelEx with the cluster dimension, after
//   raising the kernel's dynamic shared memory limit and asking
//   cudaOccupancyMaxActiveClusters once per configuration whether such a
//   cluster can be scheduled at all.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace fots {

namespace cg = cooperative_groups;

// dynamic shared memory one block may ask for on sm_90 (227 KB)
constexpr int kMaxDynamicSmem = 232448;
// returned by launch_cluster (no cudaError_t is negative): the card cannot
// co-schedule one cluster of this size and shared memory
constexpr int kClusterUnschedulable = -2;

// how the launcher cut the plane: `channels` per cluster (a multiple of the
// 32-byte group), `cluster` blocks per cluster, `threads` per block and the
// dynamic shared memory per block (the block's share of the plane + the
// fold's scratch), all from the Python plan
struct ClusterShape {
  int channels, cluster, threads, smem;
};

// Sum of v over the threads of a warp that share threadIdx.x % lanes
// (lanes a power of two <= 32).  Every thread returns the same total.
__device__ __forceinline__ float lane_sum(float v, int lanes) {
  for (int off = lanes; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes from device memory straight into shared memory (through L2
// only), asynchronously; cp_async_wait_all makes this thread's copies
// visible to it
__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// floats of scratch after the block's share: warp partials, the block's
// partial (read by the peers), the cluster's totals
__host__ __device__ inline int fold_scratch_floats(int threads, int channels) {
  return ((threads >> 5) + 2) * 2 * channels;
}

// Called by every thread of every block of the cluster with its two
// per-channel sums (V channels of lane `lane`).  On return total[k],
// k < 2 * channels (first sums, then second sums), holds the cluster's sums
// in this block's shared memory.  scratch: fold_scratch_floats() floats.
// Every thread calls cluster_fold_done() once before the kernel returns.
template <int V>
__device__ __forceinline__ float* cluster_fold(float (&s1)[V], float (&s2)[V], int lanes,
                                               int lane, float* scratch) {
  cg::cluster_group cluster = cg::this_cluster();
  const int channels = lanes * V;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  float* wpart = scratch;                       // [nwarps][2][channels]
  float* bpart = wpart + nwarps * 2 * channels;  // [2][channels]
  float* total = bpart + 2 * channels;           // [2][channels]
#pragma unroll
  for (int i = 0; i < V; i++) {
    s1[i] = lane_sum(s1[i], lanes);
    s2[i] = lane_sum(s2[i], lanes);
  }
  if ((threadIdx.x & 31) < lanes) {
#pragma unroll
    for (int i = 0; i < V; i++) {
      wpart[(warp * 2 + 0) * channels + lane * V + i] = s1[i];
      wpart[(warp * 2 + 1) * channels + lane * V + i] = s2[i];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * channels; k += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < nwarps; w++) t += wpart[w * 2 * channels + k];
    bpart[k] = t;
  }
  cluster.sync();
  const int cs = (int)cluster.num_blocks();
  for (int k = threadIdx.x; k < 2 * channels; k += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < cs; r++) t += cluster.map_shared_rank(bpart, r)[k];
    total[k] = t;
  }
  // this block has read its peers: arrive now, wait in cluster_fold_done()
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  return total;
}

// Before the kernel returns: no block may leave while a peer still reads its
// partial sums.  By then every block has long arrived, so this rarely waits.
__device__ __forceinline__ void cluster_fold_done() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Launch `kernel` with clusters of shape.cluster blocks along x.  Returns a
// cudaError_t code, or kClusterUnschedulable.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), const ClusterShape& shape, dim3 grid,
                   cudaStream_t stream, Args... args) {
  if (shape.smem > kMaxDynamicSmem || shape.threads > 1024 || shape.threads % 32 != 0 ||
      shape.cluster < 1 || grid.x % shape.cluster != 0)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shape.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(shape.threads);
  cfg.dynamicSmemBytes = shape.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // per kernel and configuration, once: the attributes and the occupancy
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> clusters_that_fit;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int fit;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(fn, shape.cluster, shape.threads, shape.smem);
    auto it = clusters_that_fit.find(key);
    if (it == clusters_that_fit.end()) {
      cudaError_t err =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
      if (err == cudaSuccess && shape.cluster > 8)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      int n = 0;
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
      if (err != cudaSuccess) {
        cudaGetLastError();  // clear it: the caller raises with the code
        return (int)err;
      }
      it = clusters_that_fit.emplace(key, n).first;
    }
    fit = it->second;
  }
  if (fit < 1) return kClusterUnschedulable;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace fots
