// Row scatter-add into a table built bucket by bucket in shared memory:
//     out = zeros(n_rows, width); out[idx[i], :] += vals[i, :]   (fp32 sums)
//
// Replaces the Pallas kernel of the TPU probe tools/prof_pallas_scatter.py
// (`make_pallas_scatter`, pallas_call :116), which covers the output table
// in `n_blocks` row blocks held in the TPU's on-chip memory, every grid step
// zeroing its block and re-walking the whole update list with predicated
// read-modify-writes. The multi-megabyte blocks do not carry over: a Hopper
// block has at most 227 KB of shared memory, and blocks run in parallel in
// no order.
//
// Cluster design (`scatter_rows_blocked_cluster`, the wrapper
// `scatter_add_rows_blocked`): a thread-block cluster of cl blocks owns a
// bucket of cl * tile_rows rows (the stand-in for the TPU probe's
// n_blocks), each rank tile_rows of them in shared memory, zeroed; the
// adds go to the owning rank through distributed shared memory and each
// rank stores its rows once (scatter_cluster.cuh). The cluster walks idx
// once, split cl ways: warp w of the cluster reads 32 indices in a
// coalesced load (the next 32 already in flight), ballots which fall in
// the bucket, and takes the hits four at a time: their rows of vals are
// loaded first, then added into a running sum that merges consecutive hits
// on one row in registers (kernel 1's rule) and is flushed when the row
// changes. So idx is read once per bucket, not once per tile, and a hot
// bucket's hits are found and added by cl * 16 warps on cl SMs.
//
// Tile design (`scatter_rows_blocked`, the wrapper
// `scatter_add_rows_blocked_tiles`; the first port, kept unchanged so that
// one run can time both): one block per tile of tile_rows rows,
// tile_rows * width fp32 in dynamic shared memory, zeroed. The block reads
// the whole idx list in coalesced strides of 32 per warp; each warp ballots
// which of its 32 indices fall in the tile and, hit by hit, adds that
// update's row of vals into shared memory (lane l takes columns l, l + 32,
// ...; shared-memory fp32 atomics, since two warps can hit one row). Then
// the block writes its whole tile with coalesced stores, zeros included.
//
// Both: the output needs no separate zero fill, every row is written
// exactly once, and there are no global atomics. bf16 values are added in
// fp32 and rounded once, at the store. An index outside [0, n_rows) lies in
// no bucket or tile, or in the last one's pad rows, which are never stored:
// it is dropped.
//
// Bound on the card: bytes. The function writes the table once and reads
// vals and idx once (at width 128, fp32, 160801 rows and 11567 updates:
// 88 MB, 0.026 ms at 3.35 TB/s). The designs' known cost is that every
// bucket (tile) re-reads idx, from L2: n_buckets * nu * sizeof(idx). The
// cluster design divides it by cl against tiles of the same height.
//
// Interface: plain C, for ctypes. The caller owns every buffer (the output
// needs no zero fill), passes PyTorch's current stream, and gets a
// cudaError_t back (cudaErrorInvalidValue for a tile that does not fit or
// a cluster size that is no power of two; the launch's own error for a
// cluster the card cannot schedule). `scatter_rows_blocked_cluster_
// occupancy` gives cudaOccupancyMaxActiveClusters for a configuration.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scatter_cluster.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int64_t kMaxSmemBytes = 232448;   // 227 KB, a block's most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
scatter_rows_blocked_kernel(const I* __restrict__ idx,
                            const T* __restrict__ vals, T* __restrict__ out,
                            int64_t nu, int width, int64_t n_rows,
                            int tile_rows) {
  extern __shared__ float tile[];               // [tile_rows][width]
  const int64_t row0 = (int64_t)blockIdx.x * tile_rows;
  const int n_tile = tile_rows * width;
  for (int k = threadIdx.x; k < n_tile; k += kThreads) tile[k] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  // every lane of a warp runs the same iterations: the ballot and the
  // shuffle see a full warp
  for (int64_t base = (int64_t)warp * kWarp; base < nu; base += kThreads) {
    const int64_t i = base + lane;
    const int64_t r = i < nu ? (int64_t)idx[i] - row0 : -1;
    unsigned hits = __ballot_sync(0xffffffffu, r >= 0 && r < tile_rows);
    const int r32 = (int)(r >= 0 && r < tile_rows ? r : 0);
    while (hits) {
      const int src = __ffs(hits) - 1;
      hits &= hits - 1;
      const int row = __shfl_sync(0xffffffffu, r32, src);
      const T* v = vals + (base + src) * width;
      float* dst = tile + row * width;
      for (int c = lane; c < width; c += kWarp) atomicAdd(dst + c, to_float(v[c]));
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
int launch(const void* idx, const void* vals, void* out, int64_t nu,
           int64_t width, int64_t n_rows, int64_t tile_rows, void* stream) {
  if (tile_rows < 1 || width < 0 ||
      tile_rows * width * (int64_t)sizeof(float) > kMaxSmemBytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0 && width > 0) {
    const size_t smem = (size_t)(tile_rows * width) * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_rows_blocked_kernel<T, I>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t tiles = (n_rows + tile_rows - 1) / tile_rows;
    scatter_rows_blocked_kernel<T, I><<<(unsigned int)tiles, kThreads, smem,
                                        (cudaStream_t)stream>>>(
        (const I*)idx, (const T*)vals, (T*)out, nu, (int)width, n_rows,
        (int)tile_rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// idx int32 (idx64 == 0) or int64, vals and out float32 (bf16 == 0) or
// bfloat16, out [n_rows, width]. Returns a cudaError_t.
extern "C" int scatter_rows_blocked(const void* idx, const void* vals,
                                    void* out, int64_t nu, int64_t width,
                                    int64_t n_rows, int64_t tile_rows,
                                    int64_t bf16, int64_t idx64,
                                    void* stream) {
  if (bf16) {
    return idx64 ? launch<__nv_bfloat16, int64_t>(idx, vals, out, nu, width,
                                                  n_rows, tile_rows, stream)
                 : launch<__nv_bfloat16, int32_t>(idx, vals, out, nu, width,
                                                  n_rows, tile_rows, stream);
  }
  return idx64 ? launch<float, int64_t>(idx, vals, out, nu, width, n_rows,
                                        tile_rows, stream)
               : launch<float, int32_t>(idx, vals, out, nu, width, n_rows,
                                        tile_rows, stream);
}

namespace {

namespace cg = cooperative_groups;
namespace sc = scatter_cluster;

template <typename T, typename I>
__global__ void __launch_bounds__(sc::kThreads)
scatter_rows_blocked_cluster_kernel(const I* __restrict__ idx,
                                    const T* __restrict__ vals,
                                    T* __restrict__ out, int64_t nu,
                                    int width, int64_t n_rows,
                                    int tile_rows) {
  // [tile_rows][width]: local row t is bucket row t * cl + rank
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cl_shift = __ffs(cl) - 1;          // cl is a power of two
  const int bucket_rows = cl * tile_rows;
  const int64_t row0 = (int64_t)(blockIdx.x / cl) * bucket_rows;
  const int lane = threadIdx.x % sc::kWarp;
  const int64_t stride = (int64_t)cl * sc::kThreads;
  const int64_t first =
      ((int64_t)rank * sc::kWarps + threadIdx.x / sc::kWarp) * sc::kWarp;
  // the warp's first 32 indices in flight while the block zeroes
  const int r_first = sc::bucket_row(idx, first + lane, nu, row0,
                                     bucket_rows);
  sc::zero_rows(smem, tile_rows * width);
  cluster.sync();                 // every rank zeroed before any add

  for (int col0 = 0; col0 < width; col0 += sc::kPass) {
    float acc[sc::kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
    int cur = -1;
    int r_next = r_first;
    // every lane of a warp runs the same iterations: the ballot, the
    // shuffles and the merged flush see a full warp
    for (int64_t base = first; base < nu; base += stride) {
      const int r = r_next;
      r_next = sc::bucket_row(idx, base + stride + lane, nu, row0,
                              bucket_rows);
      unsigned hits = __ballot_sync(sc::kFull, r >= 0);
      while (hits) {
        int row[sc::kAhead];
        int64_t src[sc::kAhead];
#pragma unroll
        for (int u = 0; u < sc::kAhead; ++u) {
          const int s = hits ? __ffs(hits) - 1 : 0;
          const int rs = __shfl_sync(sc::kFull, r, s);
          row[u] = hits ? rs : -1;
          src[u] = base + s;
          hits &= hits - 1;
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
int launch_cluster(const void* idx, const void* vals, void* out, int64_t nu,
                   int64_t width, int64_t n_rows, int64_t tile_rows,
                   int64_t cl, void* stream) {
  if (!sc::valid_shape(width, tile_rows, cl)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0 && width > 0) {
    const size_t smem = (size_t)(tile_rows * width) * sizeof(float);
    const int64_t bucket_rows = tile_rows * cl;
    const int64_t buckets = (n_rows + bucket_rows - 1) / bucket_rows;
    return (int)sc::launch(scatter_rows_blocked_cluster_kernel<T, I>,
                           buckets * cl, smem, (int)cl, (cudaStream_t)stream,
                           (const I*)idx, (const T*)vals, (T*)out, nu,
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
      scatter_rows_blocked_cluster_kernel<T, I>,
      (size_t)(tile_rows * width) * sizeof(float), (int)cl);
}

}  // namespace

// The cluster design: clusters of cl blocks (a power of two), tile_rows
// rows per block; idx int32 (idx64 == 0) or int64, vals and out float32
// (bf16 == 0) or bfloat16, out [n_rows, width]. Returns a cudaError_t.
extern "C" int scatter_rows_blocked_cluster(const void* idx, const void* vals,
                                            void* out, int64_t nu,
                                            int64_t width, int64_t n_rows,
                                            int64_t tile_rows, int64_t cl,
                                            int64_t bf16, int64_t idx64,
                                            void* stream) {
  if (bf16) {
    return idx64 ? launch_cluster<__nv_bfloat16, int64_t>(
                       idx, vals, out, nu, width, n_rows, tile_rows, cl,
                       stream)
                 : launch_cluster<__nv_bfloat16, int32_t>(
                       idx, vals, out, nu, width, n_rows, tile_rows, cl,
                       stream);
  }
  return idx64 ? launch_cluster<float, int64_t>(idx, vals, out, nu, width,
                                                n_rows, tile_rows, cl, stream)
               : launch_cluster<float, int32_t>(idx, vals, out, nu, width,
                                                n_rows, tile_rows, cl, stream);
}

// cudaOccupancyMaxActiveClusters of the cluster design at (width,
// tile_rows, cl): clusters the card holds at once, or -cudaError_t.
extern "C" int scatter_rows_blocked_cluster_occupancy(int64_t width,
                                                      int64_t tile_rows,
                                                      int64_t cl, int64_t bf16,
                                                      int64_t idx64) {
  if (bf16) {
    return idx64 ? occupancy<__nv_bfloat16, int64_t>(width, tile_rows, cl)
                 : occupancy<__nv_bfloat16, int32_t>(width, tile_rows, cl);
  }
  return idx64 ? occupancy<float, int64_t>(width, tile_rows, cl)
               : occupancy<float, int32_t>(width, tile_rows, cl);
}
