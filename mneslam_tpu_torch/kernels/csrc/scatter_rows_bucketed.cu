// Row scatter-add of updates sorted by row, one row tile per block:
//     out = zeros(n_rows, width); out[idx_s[i], :] += vals_s[i, :]  (fp32 sums)
//
// Replaces the Pallas kernel of the TPU probe
// tools/prof_scatter_bucketed.py (`make_bucketed`, pallas_call :107): the
// updates are sorted by row outside the kernel, `searchsorted` gives each
// row-range bucket its update range, and each grid step zeroes its bucket
// in the TPU's on-chip memory and walks only that range. The buckets there
// are tens of thousands of rows (megabytes); a Hopper block has at most
// 227 KB of shared memory, and blocks run in parallel in no order.
//
// Design: one block per tile of tile_rows rows, tile_rows * width fp32 in
// dynamic shared memory, zeroed. The block walks only its range
// [off[b], off[b + 1]) of the sorted updates: each warp takes contiguous
// runs of kRun updates, keeps a running sum in registers while consecutive
// updates hit one row (lane l owns columns l, l + 32, ...), and adds the sum
// into shared memory when the row changes (fp32 atomics: the runs of two
// warps can share their boundary row). Then the block writes its whole tile
// once, zeros included, in the dtype of vals. No atomics across blocks, no
// separate zero fill, no re-walk of other tiles' updates. The route (sort,
// permute, offsets) is the caller's. An index outside [0, n_rows) lies
// outside every tile's range or in the last tile's pad rows, which are
// never stored: it is dropped. A row outside the block's tile (unsorted
// input) is dropped too, never written outside the tile.
//
// Bound on the card: bytes. The function writes the table once and reads
// vals and idx once (at width 128, fp32, 160801 rows and 11567 updates:
// 88 MB, 0.026 ms at 3.35 TB/s); with the route, the sort and the permuted
// copy of vals add their own passes.
//
// Interface: plain C, for ctypes. The caller owns every buffer, passes
// PyTorch's current stream, and gets a cudaError_t back
// (cudaErrorInvalidValue for a tile that does not fit).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
