// Device code shared by the cluster design of the blocked and bucketed row
// scatters (scatter_rows_blocked.cu, scatter_rows_bucketed.cu):
//     out = zeros(n_rows, width); out[idx[i], :] += vals[i, :]   (fp32 sums)
//
// A thread-block cluster of cl blocks owns a bucket of cl * tile_rows
// consecutive rows of the table. The rows are dealt out to the ranks in
// turn: bucket row r lives in rank r % cl, as local row r / cl, in that
// rank's dynamic shared memory, as zeroed fp32 (so a hot run of rows is
// shared by every rank, not held by one). Any block of the cluster adds a
// row's sum into the rank that owns the row, through distributed shared
// memory (`cluster.map_shared_rank` and an fp32 atomicAdd on the mapped
// address; local when the block owns the row). After the walk each rank
// stores its rows once, zeros included, in the dtype of vals, one row per
// warp instruction. So the table needs no zero fill, takes no global
// atomic, and every row is written exactly once; a bucket's updates are
// found and added by the cl * kWarps warps of cl SMs, not by one block.
// Rows of the last bucket past n_rows are pad: added into, never stored.
//
// Synchronisation: `cluster.sync()` after the zeroing (no rank adds into
// memory another rank has not zeroed yet) and after the walk (no rank
// stores and exits while another still adds into its shared memory).
//
// Every warp-level step (ballot, shuffle, the loads ahead, the merged
// flush) runs on full warps: the loops that hold them are warp-uniform.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scatter_cluster {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kColsPerLane = 4;          // a warp pass covers 128 columns
constexpr int kPass = kWarp * kColsPerLane;
constexpr int kAhead = 4;                // rows a warp loads before it adds
constexpr int64_t kMaxSmemBytes = 232448;   // 227 KB, a block's most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct __align__(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

// four consecutive outputs, streamed past the caches (the table is written
// once and not read back by this kernel)
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const Bf16x4 b{__floats2bfloat162_rn(v.x, v.y),
                 __floats2bfloat162_rn(v.z, v.w)};
  __stcs(reinterpret_cast<uint2*>(p), *reinterpret_cast<const uint2*>(&b));
}

// this block's tile_rows x width fp32 to zero
__device__ __forceinline__ void zero_rows(float* smem, int n) {
  if ((n & 3) == 0) {
    float4* s4 = reinterpret_cast<float4*>(smem);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x) s4[k] = z;
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) smem[k] = 0.f;
  }
}

// This rank's rows of the bucket that starts at table row row0 (local row
// t is table row row0 + t * cl + rank; those below n_rows), once, in T's
// dtype: warp by warp, a row per warp and step.
template <typename T>
__device__ __forceinline__ void store_rows(const float* smem, T* out,
                                           int64_t row0, int rank, int cl,
                                           int64_t n_rows, int tile_rows,
                                           int width) {
  const int lane = threadIdx.x % kWarp;
  for (int t = threadIdx.x / kWarp; t < tile_rows; t += kWarps) {
    const int64_t g = row0 + (int64_t)t * cl + rank;
    if (g >= n_rows) break;                 // the same for the whole warp
    const float* src = smem + t * width;
    T* dst = out + g * width;
    if ((width & 3) == 0) {   // 16-byte aligned rows: four outputs a lane
      const float4* s4 = reinterpret_cast<const float4*>(src);
      for (int c = lane; c < width / 4; c += kWarp) store4(dst + 4 * c, s4[c]);
    } else {
      for (int c = lane; c < width; c += kWarp) store1(dst + c, src[c]);
    }
  }
}

// The bucket row (0 .. bucket_rows - 1) of update i, or -1 where i is past
// end or its row lies outside the bucket (another bucket's, or out of
// range: dropped).
template <typename I>
__device__ __forceinline__ int bucket_row(const I* __restrict__ idx,
                                          int64_t i, int64_t end,
                                          int64_t row0, int bucket_rows) {
  if (i >= end) return -1;
  const int64_t r = (int64_t)idx[i] - row0;
  return r >= 0 && r < bucket_rows ? (int)r : -1;
}

// This lane's columns of pass col0 of kAhead rows of vals (rows whose
// bucket row is -1 read nothing): every load is issued before any is used.
template <typename T>
__device__ __forceinline__ void load_rows(
    const T* __restrict__ vals, const int64_t (&src)[kAhead],
    const int (&row)[kAhead], int width, int col0, int lane,
    float (&v)[kAhead][kColsPerLane]) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = col0 + lane + k * kWarp;
      v[u][k] = row[u] >= 0 && c < width ? to_float(vals[src[u] * width + c])
                                         : 0.f;
    }
  }
}

// acc (this lane's columns of pass col0) into bucket row `row`, in the
// shared memory of the rank that owns it (rank row % cl, local row
// row / cl; cl = 1 << cl_shift). This card has no native fp32 add in
// shared memory: the atomicAdd compiles to a generic atomic that fails
// over to a compare-and-swap loop (ATOMS.CAST.SPIN locally,
// ATOM.E.CAST.SPIN in another rank), one column after another. An
// explicit `atom.shared::cluster.cas` with every column in flight measured
// slower on the mapping path's index stream (PERF.md).
__device__ __forceinline__ void flush(cg::cluster_group& cluster,
                                      float* smem, int row, int cl_shift,
                                      int width, int col0, int lane,
                                      const float (&acc)[kColsPerLane]) {
  float* dst = cluster.map_shared_rank(smem, row & ((1 << cl_shift) - 1)) +
               (row >> cl_shift) * width;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = col0 + lane + k * kWarp;
    if (c < width) atomicAdd(dst + c, acc[k]);
  }
}

// kAhead loaded rows into the running sum: consecutive updates of one row
// are merged in registers, and the sum is flushed when the row changes
// (kernel 1's rule). cur == -1: nothing held yet.
__device__ __forceinline__ void merge_rows(
    cg::cluster_group& cluster, float* smem, int cl_shift, int width,
    int col0, int lane, const int (&row)[kAhead],
    const float (&v)[kAhead][kColsPerLane], int& cur,
    float (&acc)[kColsPerLane]) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (row[u] < 0) continue;              // the same for the whole warp
    if (row[u] != cur) {
      if (cur >= 0) {
        flush(cluster, smem, cur, cl_shift, width, col0, lane, acc);
      }
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
      cur = row[u];
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) acc[k] += v[u][k];
  }
}

__host__ inline bool valid_shape(int64_t width, int64_t tile_rows,
                                 int64_t cl) {
  // any power of two from 2: the launch refuses a cluster the card cannot
  // schedule (above 8 only with the non-portable attribute, above 16 never)
  return tile_rows >= 1 && width >= 0 && cl >= 2 && cl <= 1024 &&
         (cl & (cl - 1)) == 0 &&
         tile_rows * width * (int64_t)sizeof(float) <= kMaxSmemBytes;
}

__host__ inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                                  int64_t blocks, size_t smem,
                                                  int cl,
                                                  cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The kernel's attributes, set before any launch or occupancy query: the
// dynamic shared memory, and non-portable cluster sizes above 8.
template <typename Kernel>
__host__ cudaError_t set_attributes(Kernel kernel, size_t smem, int cl) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cl > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// Launch `blocks` blocks (a multiple of cl) in clusters of cl on `stream`;
// -> the launch's cudaError_t (a cluster the card cannot schedule is
// refused here, never run another way).
template <typename... Params, typename... Args>
__host__ cudaError_t launch(void (*kernel)(Params...), int64_t blocks,
                            size_t smem, int cl, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = set_attributes(kernel, smem, cl);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_config(attr, blocks, smem, cl, stream);
  err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for the kernel at (smem, cl): the clusters
// the card can hold at once, or -cudaError_t on an error.
template <typename... Params>
__host__ int max_active_clusters(void (*kernel)(Params...), size_t smem,
                                 int cl) {
  cudaError_t err = set_attributes(kernel, smem, cl);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(attr, cl, smem, cl, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &config);
  if (err != cudaSuccess) {
    cudaGetLastError();          // not sticky: clear it for the caller
    return -(int)err;
  }
  return n;
}

}  // namespace scatter_cluster
