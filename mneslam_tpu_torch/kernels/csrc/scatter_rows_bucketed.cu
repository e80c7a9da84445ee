// Row scatter-add of updates sorted by row, bucket by bucket:
//     out = zeros(n_rows, width); out[idx_s[i], :] += vals[perm[i], :]
//                                                            (fp32 sums)
//
// Replaces the Pallas kernel of the TPU probe
// tools/prof_scatter_bucketed.py (`make_bucketed`, pallas_call :107): the
// updates are sorted by row outside the kernel, `searchsorted` gives each
// row-range bucket its update range, and each grid step zeroes its bucket
// in the TPU's on-chip memory and walks only that range. The buckets there
// are tens of thousands of rows (megabytes); a Hopper block has at most
// 227 KB of shared memory, and blocks run in parallel in no order.
//
// Cluster design (`scatter_rows_bucketed_cluster`, the wrapper
// `scatter_add_rows_bucketed`): a thread-block cluster of cl blocks owns a
// bucket of cl * tile_rows rows, each rank tile_rows of them in shared
// memory, zeroed; the adds go to the owning rank through distributed
// shared memory and each rank stores its rows once (scatter_cluster.cuh).
// The bucket's sorted range [off[b], off[b + 1]) is split evenly by count
// over the cluster's cl * 16 warps, each a contiguous run. A warp reads 32
// sorted rows and their sources (perm, or the identity for presorted
// input) in one coalesced load, the next 32 already in flight, then takes
// them four at a time: the four rows of vals are loaded first, then added
// into a running sum that merges each row's contiguous run in registers
// and is flushed when the row changes, about once per row. vals is read
// where it lies (vals[perm[i]]): the route permutes only the indices. So a
// hot bucket's updates are shared by cl SMs, not walked by one block.
//
// Tile design (`scatter_rows_bucketed`, the wrapper
// `scatter_add_rows_bucketed_tiles`; the first port, kept unchanged so
// that one run can time both): one block per tile of tile_rows rows over
// vals permuted by the caller; each warp takes contiguous runs of kRun
// sorted updates, merges consecutive updates of one row in registers and
// adds the sum into shared memory (fp32 atomics: the runs of two warps can
// share their boundary row); then the block writes its whole tile once.
//
// Both: no atomics across blocks' global memory, no separate zero fill,
// no re-walk of other buckets' updates; bf16 values are added in fp32 and
// rounded once, at the store. An index outside [0, n_rows) lies outside
// every bucket's range (negative indices sort to the front, before the
// first bucket) or in the last bucket's pad rows, which are never stored:
// it is dropped. A row outside the block's bucket (unsorted input) is
// dropped too, never written outside it.
//
// Bound on the card: bytes. The function writes the table once and reads
// vals and idx once (at width 128, fp32, 160801 rows and 11567 updates:
// 88 MB, 0.026 ms at 3.35 TB/s); the route's sort, its permutation and
// the offsets add their own passes (and, for the tile design, the permuted
// copy of vals).
//
// Interface: plain C, for ctypes. The caller owns every buffer, passes
// PyTorch's current stream, and gets a cudaError_t back
// (cudaErrorInvalidValue for a tile that does not fit or a cluster size
// that is no power of two; the launch's own error for a cluster the card
// cannot schedule). `scatter_rows_bucketed_cluster_occupancy` gives
// cudaOccupancyMaxActiveClusters for a configuration.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scatter_cluster.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kColsPerLane = 4;              // a warp pass covers 128 columns
constexpr int kRun = 32;                     // sorted updates per warp run
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int64_t kMaxSmemBytes = 232448;   // 227 KB, a block's most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void flush(float* tile, int64_t row,
                                      int tile_rows, int width, int col0,
                                      int lane,
                                      const float (&acc)[kColsPerLane]) {
  if (row < 0 || row >= tile_rows) return;     // not this tile's: dropped
  float* dst = tile + row * width;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = col0 + lane + k * kWarp;
    if (c < width) atomicAdd(dst + c, acc[k]);
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
scatter_rows_bucketed_kernel(const int64_t* __restrict__ off,
                             const I* __restrict__ idx,
                             const T* __restrict__ vals, T* __restrict__ out,
                             int width, int64_t n_rows, int tile_rows) {
  extern __shared__ float tile[];               // [tile_rows][width]
  const int64_t row0 = (int64_t)blockIdx.x * tile_rows;
  const int n_tile = tile_rows * width;
  for (int k = threadIdx.x; k < n_tile; k += kThreads) tile[k] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t begin = off[blockIdx.x];
  const int64_t end = off[blockIdx.x + 1];
  for (int64_t run0 = begin + (int64_t)warp * kRun; run0 < end;
       run0 += (int64_t)kWarps * kRun) {
    const int64_t run1 = run0 + kRun < end ? run0 + kRun : end;
    for (int col0 = 0; col0 < width; col0 += kWarp * kColsPerLane) {
      float acc[kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
      int64_t cur = (int64_t)idx[run0] - row0;
      for (int64_t i = run0; i < run1; ++i) {
        const int64_t r = (int64_t)idx[i] - row0;   // the same for the warp
        if (r != cur) {
          flush(tile, cur, tile_rows, width, col0, lane, acc);
#pragma unroll
          for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
          cur = r;
        }
        const T* src = vals + i * width;
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = col0 + lane + k * kWarp;
          if (c < width) acc[k] += to_float(src[c]);
        }
      }
      flush(tile, cur, tile_rows, width, col0, lane, acc);
    }
  }
  __syncthreads();

  // the tile once, zeros included; the last tile's rows past n_rows are pad
  const int64_t rows = n_rows - row0 < tile_rows ? n_rows - row0 : tile_rows;
  const int n_out = (int)rows * width;
  T* dst = out + row0 * width;
  for (int k = threadIdx.x; k < n_out; k += kThreads) store(dst + k, tile[k]);
}

template <typename T, typename I>
int launch(const void* off, const void* idx, const void* vals, void* out,
           int64_t width, int64_t n_rows, int64_t tile_rows, void* stream) {
  if (tile_rows < 1 || width < 0 ||
      tile_rows * width * (int64_t)sizeof(float) > kMaxSmemBytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0 && width > 0) {
    const size_t smem = (size_t)(tile_rows * width) * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_rows_bucketed_kernel<T, I>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t tiles = (n_rows + tile_rows - 1) / tile_rows;
    scatter_rows_bucketed_kernel<T, I><<<(unsigned int)tiles, kThreads, smem,
                                         (cudaStream_t)stream>>>(
        (const int64_t*)off, (const I*)idx, (const T*)vals, (T*)out,
        (int)width, n_rows, (int)tile_rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// off int64 [n_tiles + 1] (tile b walks sorted updates off[b] .. off[b+1]),
// idx int32 (idx64 == 0) or int64 sorted, vals and out float32 (bf16 == 0)
// or bfloat16, out [n_rows, width]. Returns a cudaError_t.
extern "C" int scatter_rows_bucketed(const void* off, const void* idx,
                                     const void* vals, void* out,
                                     int64_t width, int64_t n_rows,
                                     int64_t tile_rows, int64_t bf16,
                                     int64_t idx64, void* stream) {
  if (bf16) {
    return idx64 ? launch<__nv_bfloat16, int64_t>(off, idx, vals, out, width,
                                                  n_rows, tile_rows, stream)
                 : launch<__nv_bfloat16, int32_t>(off, idx, vals, out, width,
                                                  n_rows, tile_rows, stream);
  }
  return idx64 ? launch<float, int64_t>(off, idx, vals, out, width, n_rows,
                                        tile_rows, stream)
               : launch<float, int32_t>(off, idx, vals, out, width, n_rows,
                                        tile_rows, stream);
}

namespace {

namespace cg = cooperative_groups;
namespace sc = scatter_cluster;

// the position in vals of sorted update i (0 past end)
__device__ __forceinline__ int64_t source(const int64_t* __restrict__ perm,
                                          int64_t i, int64_t end) {
  if (i >= end) return 0;
  return perm != nullptr ? perm[i] : i;
}

template <typename T, typename I>
__global__ void __launch_bounds__(sc::kThreads)
scatter_rows_bucketed_cluster_kernel(const int64_t* __restrict__ off,
                                     const I* __restrict__ idx,
                                     const int64_t* __restrict__ perm,
                                     const T* __restrict__ vals,
                                     T* __restrict__ out, int width,
                                     int64_t n_rows, int tile_rows) {
  // [tile_rows][width]: local row t is bucket row t * cl + rank
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cl_shift = __ffs(cl) - 1;          // cl is a power of two
  const int bucket_rows = cl * tile_rows;
  const int64_t bucket = blockIdx.x / cl;
  const int64_t row0 = bucket * bucket_rows;

  // the bucket's sorted range, split evenly by count over the cluster's
  // warps: rank by rank, each warp a contiguous run
  const int lane = threadIdx.x % sc::kWarp;
  const int64_t lo = off[bucket];
  const int64_t n = off[bucket + 1] - lo;
  const int64_t w = (int64_t)rank * sc::kWarps + threadIdx.x / sc::kWarp;
  const int64_t total = (int64_t)cl * sc::kWarps;
  const int64_t w0 = lo + n * w / total;
  const int64_t w1 = lo + n * (w + 1) / total;
  // the warp's first 32 rows and sources in flight while the block zeroes
  const int r_first = sc::bucket_row(idx, w0 + lane, w1, row0, bucket_rows);
  const int64_t s_first = source(perm, w0 + lane, w1);
  sc::zero_rows(smem, tile_rows * width);
  cluster.sync();                 // every rank zeroed before any add

  for (int col0 = 0; col0 < width; col0 += sc::kPass) {
    float acc[sc::kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
    int cur = -1;
    int r_next = r_first;
    int64_t s_next = s_first;
    for (int64_t i0 = w0; i0 < w1; i0 += sc::kWarp) {   // warp-uniform
      const int r = r_next;
      const int64_t s = s_next;
      r_next = sc::bucket_row(idx, i0 + sc::kWarp + lane, w1, row0,
                              bucket_rows);
      s_next = source(perm, i0 + sc::kWarp + lane, w1);
      const int n_here = w1 - i0 < sc::kWarp ? (int)(w1 - i0) : sc::kWarp;
      for (int j0 = 0; j0 < n_here; j0 += sc::kAhead) {
        int row[sc::kAhead];
        int64_t src[sc::kAhead];
#pragma unroll
        for (int u = 0; u < sc::kAhead; ++u) {
          const int j = j0 + u;
          const int rj = __shfl_sync(sc::kFull, r, j & (sc::kWarp - 1));
          src[u] = __shfl_sync(sc::kFull, s, j & (sc::kWarp - 1));
          row[u] = j < n_here ? rj : -1;
        }
        float v[sc::kAhead][sc::kColsPerLane];
        sc::load_rows(vals, src, row, width, col0, lane, v);
        sc::merge_rows(cluster, smem, cl_shift, width, col0, lane, row, v,
                       cur, acc);
      }
    }
    if (cur >= 0) {
      sc::flush(cluster, smem, cur, cl_shift, width, col0, lane, acc);
    }
  }
  cluster.sync();                 // every add landed before any store

  sc::store_rows(smem, out, row0, rank, cl, n_rows, tile_rows, width);
}

template <typename T, typename I>
int launch_cluster(const void* off, const void* idx, const void* perm,
                   const void* vals, void* out, int64_t width, int64_t n_rows,
                   int64_t tile_rows, int64_t cl, void* stream) {
  if (!sc::valid_shape(width, tile_rows, cl)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0 && width > 0) {
    const size_t smem = (size_t)(tile_rows * width) * sizeof(float);
    const int64_t bucket_rows = tile_rows * cl;
    const int64_t buckets = (n_rows + bucket_rows - 1) / bucket_rows;
    return (int)sc::launch(scatter_rows_bucketed_cluster_kernel<T, I>,
                           buckets * cl, smem, (int)cl, (cudaStream_t)stream,
                           (const int64_t*)off, (const I*)idx,
                           (const int64_t*)perm, (const T*)vals, (T*)out,
                           (int)width, n_rows, (int)tile_rows);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int occupancy(int64_t width, int64_t tile_rows, int64_t cl) {
  if (!sc::valid_shape(width, tile_rows, cl) || width < 1) {
    return -(int)cudaErrorInvalidValue;
  }
  return sc::max_active_clusters(
      scatter_rows_bucketed_cluster_kernel<T, I>,
      (size_t)(tile_rows * width) * sizeof(float), (int)cl);
}

}  // namespace

// The cluster design: off int64 [n_buckets + 1] with n_buckets =
// ceil(n_rows / (cl * tile_rows)) (bucket b walks sorted updates off[b] ..
// off[b + 1]), idx int32 (idx64 == 0) or int64 sorted, perm int64 (the
// position in vals of each sorted update) or NULL for vals in idx's order,
// vals and out float32 (bf16 == 0) or bfloat16, out [n_rows, width].
// Returns a cudaError_t.
extern "C" int scatter_rows_bucketed_cluster(
    const void* off, const void* idx, const void* perm, const void* vals,
    void* out, int64_t width, int64_t n_rows, int64_t tile_rows, int64_t cl,
    int64_t bf16, int64_t idx64, void* stream) {
  if (bf16) {
    return idx64 ? launch_cluster<__nv_bfloat16, int64_t>(
                       off, idx, perm, vals, out, width, n_rows, tile_rows,
                       cl, stream)
                 : launch_cluster<__nv_bfloat16, int32_t>(
                       off, idx, perm, vals, out, width, n_rows, tile_rows,
                       cl, stream);
  }
  return idx64 ? launch_cluster<float, int64_t>(off, idx, perm, vals, out,
                                                width, n_rows, tile_rows, cl,
                                                stream)
               : launch_cluster<float, int32_t>(off, idx, perm, vals, out,
                                                width, n_rows, tile_rows, cl,
                                                stream);
}

// cudaOccupancyMaxActiveClusters of the cluster design at (width,
// tile_rows, cl): clusters the card holds at once, or -cudaError_t.
extern "C" int scatter_rows_bucketed_cluster_occupancy(int64_t width,
                                                       int64_t tile_rows,
                                                       int64_t cl,
                                                       int64_t bf16,
                                                       int64_t idx64) {
  if (bf16) {
    return idx64 ? occupancy<__nv_bfloat16, int64_t>(width, tile_rows, cl)
                 : occupancy<__nv_bfloat16, int32_t>(width, tile_rows, cl);
  }
  return idx64 ? occupancy<float, int64_t>(width, tile_rows, cl)
               : occupancy<float, int32_t>(width, tile_rows, cl);
}
