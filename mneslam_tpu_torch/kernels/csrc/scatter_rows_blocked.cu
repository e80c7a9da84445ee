// Row scatter-add into a table built tile by tile in shared memory:
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
// Design: one block per tile of tile_rows rows (the stand-in for the TPU
// probe's n_blocks), tile_rows * width fp32 in dynamic shared memory,
// zeroed. The block reads the whole idx list in coalesced strides of 32 per
// warp; each warp ballots which of its 32 indices fall in the tile and, hit
// by hit, adds that update's row of vals into shared memory (lane l takes
// columns l, l + 32, ...; shared-memory fp32 atomics, since two warps can
// hit one row). Then the block writes its whole tile with coalesced stores,
// zeros included, in the dtype of vals. So the output needs no separate
// zero fill, every row is written exactly once, and there are no global
// atomics. bf16 values are added in fp32 and rounded once, at the store.
// An index outside [0, n_rows) lies in no tile, or in the last tile's pad
// rows, which are never stored: it is dropped.
//
// Bound on the card: bytes. The function writes the table once and reads
// vals and idx once (at width 128, fp32, 160801 rows and 11567 updates:
// 88 MB, 0.026 ms at 3.35 TB/s). The design's known cost is that every
// tile re-reads idx, from L2: n_tiles * nu * sizeof(idx), about 155 MB at
// 92k updates and 419 tiles of 384 rows. Larger tiles cut it; the shared
// memory of a block caps them (454 rows at width 128).
//
// Interface: plain C, for ctypes. The caller owns every buffer (the output
// needs no zero fill), passes PyTorch's current stream, and gets a
// cudaError_t back (cudaErrorInvalidValue for a tile that does not fit).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
