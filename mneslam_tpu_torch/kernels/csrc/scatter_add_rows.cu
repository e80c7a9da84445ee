// Row scatter-add for the tri-plane sampler's backward pass:
//     out = zeros(n_rows, width); out[idx[i], :] += vals[i, :]   (fp32 sums)
//
// Replaces the Pallas kernel `_scatter_rows_kernel` /
// `scatter_add_rows_pallas` in mneslam_tpu/ops/pallas_kernels.py, which
// walks the update list serially over an output table held whole in the
// TPU's on-chip memory. That design does not carry over: a Hopper block has
// at most 227 KB of shared memory, far below a plane table (hundreds of MB
// at room0 widths), and blocks run in parallel in no order.
//
// Design: one warp per run of kRowsPerWarp consecutive updates (8 in the
// production entries; the `scatter_add_rows_per_warp` entry also builds 16
// and 32, the counterparts of the TPU probe's unroll depths in
// tools/prof_scatter_bucketed.py `make_serial`). Lane l
// owns columns l, l + 32, l + 64, ... of the row, so every load and every
// atomic of the warp covers 32 consecutive floats (one 128-byte line). The
// warp keeps a running sum in registers while consecutive updates hit the
// same row, and adds it to the zero-filled table with fp32 atomicAdd only
// when the row changes. The sampler's updates come ray by ray, sample by
// sample, so neighbouring updates often fall in the same texel: merging
// those runs cuts the atomics that collide on one row. bf16 values are
// accumulated in fp32. Out-of-range rows are dropped (the XLA
// `.at[idx].add` rule), never clamped.
//
// Bound on the card: bytes. The work writes the zeroed table
// (n_rows * width * 4 bytes) and reads the update values and indices once;
// its arithmetic is one add per value.
//
// Interface: plain C, for ctypes. The caller owns every buffer (the output
// must already be zero-filled), passes PyTorch's current stream, and gets
// cudaGetLastError() back (cudaErrorInvalidValue for a run length the
// per-warp entry does not build).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kColsPerLane = 4;              // a warp pass covers 128 columns
constexpr int kProductionRowsPerWarp = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void flush(float* __restrict__ out, int64_t row,
                                      int64_t n_rows, int64_t width,
                                      int64_t col0, int lane,
                                      const float (&acc)[kColsPerLane]) {
  if (row < 0 || row >= n_rows) return;     // dropped, as XLA drops it
  float* dst = out + row * width;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int64_t c = col0 + lane + k * kWarp;
    if (c < width) atomicAdd(dst + c, acc[k]);
  }
}

template <typename T, int kRowsPerWarp>
__global__ void scatter_add_rows_kernel(const int64_t* __restrict__ idx,
                                        const T* __restrict__ vals,
                                        float* __restrict__ out, int64_t nu,
                                        int64_t width, int64_t n_rows) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int64_t begin = warp * kRowsPerWarp;
  if (begin >= nu) return;
  const int64_t end = begin + kRowsPerWarp < nu ? begin + kRowsPerWarp : nu;

  for (int64_t col0 = 0; col0 < width; col0 += kWarp * kColsPerLane) {
    float acc[kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
    int64_t cur = idx[begin];
    for (int64_t i = begin; i < end; ++i) {
      const int64_t r = idx[i];               // the same for the whole warp
      if (r != cur) {
        flush(out, cur, n_rows, width, col0, lane, acc);
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
        cur = r;
      }
      const T* src = vals + i * width;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int64_t c = col0 + lane + k * kWarp;
        if (c < width) acc[k] += to_float(src[c]);
      }
    }
    flush(out, cur, n_rows, width, col0, lane, acc);
  }
}

template <typename T, int kRowsPerWarp>
int launch(const void* idx, const void* vals, void* out, int64_t nu,
           int64_t width, int64_t n_rows, void* stream) {
  if (nu > 0 && width > 0) {
    const int64_t warps = (nu + kRowsPerWarp - 1) / kRowsPerWarp;
    const int64_t blocks = (warps * kWarp + kThreads - 1) / kThreads;
    scatter_add_rows_kernel<T, kRowsPerWarp><<<(unsigned int)blocks,
                                               kThreads, 0,
                                               (cudaStream_t)stream>>>(
        (const int64_t*)idx, (const T*)vals, (float*)out, nu, width, n_rows);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_per_warp(const void* idx, const void* vals, void* out, int64_t nu,
                    int64_t width, int64_t n_rows, int64_t per_warp,
                    void* stream) {
  switch (per_warp) {
    case 8: return launch<T, 8>(idx, vals, out, nu, width, n_rows, stream);
    case 16: return launch<T, 16>(idx, vals, out, nu, width, n_rows, stream);
    case 32: return launch<T, 32>(idx, vals, out, nu, width, n_rows, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int scatter_add_rows_f32(const void* idx, const void* vals,
                                    void* out, int64_t nu, int64_t width,
                                    int64_t n_rows, void* stream) {
  return launch<float, kProductionRowsPerWarp>(idx, vals, out, nu, width,
                                              n_rows, stream);
}

extern "C" int scatter_add_rows_bf16(const void* idx, const void* vals,
                                     void* out, int64_t nu, int64_t width,
                                     int64_t n_rows, void* stream) {
  return launch<__nv_bfloat16, kProductionRowsPerWarp>(idx, vals, out, nu,
                                                      width, n_rows, stream);
}

// The same kernel with per_warp (8, 16 or 32) consecutive updates per warp;
// bf16 != 0 for bfloat16 values.
extern "C" int scatter_add_rows_per_warp(const void* idx, const void* vals,
                                         void* out, int64_t nu, int64_t width,
                                         int64_t n_rows, int64_t per_warp,
                                         int64_t bf16, void* stream) {
  return bf16 ? launch_per_warp<__nv_bfloat16>(idx, vals, out, nu, width,
                                               n_rows, per_warp, stream)
              : launch_per_warp<float>(idx, vals, out, nu, width, n_rows,
                                       per_warp, stream);
}
