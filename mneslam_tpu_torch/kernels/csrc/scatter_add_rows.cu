// Row scatter-add for the tri-plane sampler's backward pass:
//     out = zeros(n_rows, width); out[idx[i], :] += vals[i, :]   (fp32 sums;
//     rounded once to bf16 for bf16 values)
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
// bf16 values (`scatter_add_rows_bf16_once`, the bf16 render's backward):
// the result is a bf16 table, so the bound writes 2 bytes per output, and
// staging through a full fp32 table (zero fill, atomics, cast: 6 bytes of
// table traffic per output on top of 2) cost 3x the bound's table bytes.
// Instead the caller keeps an fp32 workspace and a 32-bit flag per row that
// are all zero between calls, and the route makes two launches:
//   A. the kernel above with the workspace as its table (in a float4 form
//      where the width allows, accumulate_warp_vec4), flagging each row
//      it adds to (plain stores: every writer stores 1); after its blocks,
//      further blocks of the same launch write the bf16 output as zeros
//      with evict-first stores (`__stcs`), so that the output stream does
//      not push the workspace rows the atomics just touched out of L2.
//   B. one group of lanes per update: the group whose atomicExch takes the
//      row's flag from 1 to 0 writes the row's fp32 sums rounded once to
//      bf16 (round to nearest even) and stores its workspace row back to
//      zero. Every touched row is written once more (at most nu rows); the
//      untouched ones only by A.
// So the output is written once (touched rows twice), the workspace is read
// and cleared only where it was touched, and nothing walks or casts a full
// fp32 table. No memset, no host synchronisation. Where the time goes on
// the H100 (tools/scatter_bf16_ablation.py; PERF.md): with plain stores the
// output stream pushes the touched workspace rows out of L2 before launch
// B reads them; otherwise launch A's atomics and the output stream take
// nearly all of it.
//
// Interface: plain C, for ctypes. The caller owns every buffer (the fp32
// output must already be zero-filled; the bf16 route's workspace and flags
// must be zero, its bf16 output 16-byte aligned and may be uninitialised),
// passes PyTorch's current stream, and gets cudaGetLastError() back
// (cudaErrorInvalidValue for a run length the per-warp entry does not
// build).

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

template <bool kFlag>
__device__ __forceinline__ void flush(float* __restrict__ out,
                                      unsigned int* __restrict__ flags,
                                      int64_t row, int64_t n_rows,
                                      int64_t width, int64_t col0, int lane,
                                      const float (&acc)[kColsPerLane]) {
  if (row < 0 || row >= n_rows) return;     // dropped, as XLA drops it
  if (kFlag && lane == 0) flags[row] = 1;   // the bf16 route's touched row
  float* dst = out + row * width;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int64_t c = col0 + lane + k * kWarp;
    if (c < width) atomicAdd(dst + c, acc[k]);
  }
}

// One warp's run of kRowsPerWarp updates from `begin`; kFlag: also flag
// every row added to (launch A of the bf16 route).
template <typename I, typename T, int kRowsPerWarp, bool kFlag>
__device__ __forceinline__ void accumulate_warp(
    const I* __restrict__ idx, const T* __restrict__ vals,
    float* __restrict__ out, unsigned int* __restrict__ flags,
    int64_t begin, int lane, int64_t nu, int64_t width, int64_t n_rows) {
  if (begin >= nu) return;
  const int64_t end = begin + kRowsPerWarp < nu ? begin + kRowsPerWarp : nu;

  for (int64_t col0 = 0; col0 < width; col0 += kWarp * kColsPerLane) {
    float acc[kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
    int64_t cur = idx[begin];
    for (int64_t i = begin; i < end; ++i) {
      const int64_t r = idx[i];               // the same for the whole warp
      if (r != cur) {
        flush<kFlag>(out, flags, cur, n_rows, width, col0, lane, acc);
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
    flush<kFlag>(out, flags, cur, n_rows, width, col0, lane, acc);
  }
}

// Launch A's accumulate where the width is a multiple of 4 and the bf16
// values are 8-byte aligned: lane l owns columns 4l .. 4l + 3 of each
// 128-column pass, the warp loads its 8 indices and all 8 rows' values
// before adding, and adds a run with one float4 atomicAdd a lane (sm_90).
// The same atomic bytes as accumulate_warp in a quarter of the
// instructions (the ablation's scalar_acc variant times the difference).
__device__ __forceinline__ void flush_vec4(float* __restrict__ ws,
                                           unsigned int* __restrict__ flags,
                                           int64_t row, int64_t n_rows,
                                           int64_t width, int64_t c, bool live,
                                           int lane, float4 acc) {
  if (row < 0 || row >= n_rows) return;     // dropped, as XLA drops it
  if (lane == 0) flags[row] = 1;
  if (live) atomicAdd(reinterpret_cast<float4*>(ws + row * width + c), acc);
}

template <typename I>
__device__ __forceinline__ void accumulate_warp_vec4(
    const I* __restrict__ idx, const __nv_bfloat16* __restrict__ vals,
    float* __restrict__ ws, unsigned int* __restrict__ flags, int64_t begin,
    int lane, int64_t nu, int64_t width, int64_t n_rows) {
  constexpr int kRows = kProductionRowsPerWarp;
  if (begin >= nu) return;
  const int n = nu - begin < kRows ? (int)(nu - begin) : kRows;
  const int64_t mine = lane < n ? (int64_t)idx[begin + lane] : -1;
  for (int64_t col0 = 0; col0 < width; col0 += kWarp * 4) {
    const int64_t c = col0 + 4 * lane;
    const bool live = c < width;
    uint2 v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      v[i] = (i < n && live) ? *reinterpret_cast<const uint2*>(
                                   vals + (begin + i) * width + c)
                             : make_uint2(0u, 0u);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int64_t cur = __shfl_sync(0xffffffffu, mine, 0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t r = __shfl_sync(0xffffffffu, mine, i);
      if (i < n) {
        if (r != cur) {
          flush_vec4(ws, flags, cur, n_rows, width, c, live, lane, acc);
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
          cur = r;
        }
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v[i].x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v[i].y));
        acc.x += lo.x;
        acc.y += lo.y;
        acc.z += hi.x;
        acc.w += hi.y;
      }
    }
    flush_vec4(ws, flags, cur, n_rows, width, c, live, lane, acc);
  }
}

template <typename I, typename T, int kRowsPerWarp>
__global__ void scatter_add_rows_kernel(const I* __restrict__ idx,
                                        const T* __restrict__ vals,
                                        float* __restrict__ out, int64_t nu,
                                        int64_t width, int64_t n_rows) {
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  accumulate_warp<I, T, kRowsPerWarp, false>(
      idx, vals, out, nullptr, warp * kRowsPerWarp, threadIdx.x % kWarp, nu,
      width, n_rows);
}

template <int kRowsPerWarp>
int64_t accumulate_blocks(int64_t nu) {
  const int64_t warps = (nu + kRowsPerWarp - 1) / kRowsPerWarp;
  return (warps * kWarp + kThreads - 1) / kThreads;
}

template <typename T, int kRowsPerWarp>
int launch(const void* idx, const void* vals, void* out, int64_t nu,
           int64_t width, int64_t n_rows, void* stream) {
  if (nu > 0 && width > 0) {
    scatter_add_rows_kernel<int64_t, T, kRowsPerWarp>
        <<<(unsigned int)accumulate_blocks<kRowsPerWarp>(nu), kThreads, 0,
           (cudaStream_t)stream>>>((const int64_t*)idx, (const T*)vals,
                                   (float*)out, nu, width, n_rows);
  }
  return (int)cudaGetLastError();
}

constexpr int kZeroVecs = 4;   // 16-byte zero stores per thread in launch A

// Launch A of the bf16 route: blocks [0, acc_blocks) accumulate into the
// workspace and flag rows (kVec4: accumulate_warp_vec4); the rest write the
// bf16 output as zeros.
template <typename I, bool kVec4>
__global__ void accumulate_bf16_kernel(const I* __restrict__ idx,
                                       const __nv_bfloat16* __restrict__ vals,
                                       float* __restrict__ ws,
                                       unsigned int* __restrict__ flags,
                                       __nv_bfloat16* __restrict__ out,
                                       int64_t nu, int64_t width,
                                       int64_t n_rows, int64_t acc_blocks) {
  if (blockIdx.x < acc_blocks) {
    const int64_t warp =
        ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
    const int64_t begin = warp * kProductionRowsPerWarp;
    if (kVec4)
      accumulate_warp_vec4<I>(idx, vals, ws, flags, begin,
                              threadIdx.x % kWarp, nu, width, n_rows);
    else
      accumulate_warp<I, __nv_bfloat16, kProductionRowsPerWarp, true>(
          idx, vals, ws, flags, begin, threadIdx.x % kWarp, nu, width,
          n_rows);
    return;
  }
  const int64_t b = blockIdx.x - acc_blocks;
  const int64_t total = n_rows * width;
  const int64_t n16 = total / 8;               // whole 16-byte vectors
  uint4* o = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int u = 0; u < kZeroVecs; ++u) {
    const int64_t i = (b * kZeroVecs + u) * blockDim.x + threadIdx.x;
    if (i < n16) __stcs(o + i, make_uint4(0u, 0u, 0u, 0u));
  }
  if (b == 0 && threadIdx.x < total - n16 * 8)  // the last values, if any
    out[n16 * 8 + threadIdx.x] = __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo at .x
  return *reinterpret_cast<const unsigned int*>(&h);
}

// Launch B of the bf16 route: a group of 2^lanes_log2 lanes per update,
// each lane walking kVec outputs at a time (8: two float4 loads and one
// 16-byte bf16 store, for widths that are a multiple of 8; 1 otherwise).
template <typename I, int kVec>
__global__ void emit_bf16_kernel(const I* __restrict__ idx,
                                 float* __restrict__ ws,
                                 unsigned int* __restrict__ flags,
                                 __nv_bfloat16* __restrict__ out, int64_t nu,
                                 int64_t width, int64_t n_rows,
                                 int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int64_t i =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  int64_t row = -1;
  unsigned int won = 0;
  if (i < nu) {
    row = idx[i];
    if (sub == 0 && row >= 0 && row < n_rows)
      won = atomicExch(flags + row, 0u);     // 1 for one group of the row
  }
  won = __shfl_sync(0xffffffffu, won, 0, lanes);
  if (!won) return;
  float* src = ws + row * width;
  __nv_bfloat16* dst = out + row * width;
  for (int64_t v = sub; v < width / kVec; v += lanes) {
    if constexpr (kVec == 8) {
      float4* s = reinterpret_cast<float4*>(src) + 2 * v;
      const float4 a = s[0], b = s[1];
      reinterpret_cast<uint4*>(dst)[v] =
          make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                     pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
      s[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      s[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      dst[v] = __float2bfloat16_rn(src[v]);
      src[v] = 0.f;
    }
  }
}

template <typename I>
int launch_bf16_once(const void* idx, const void* vals, void* ws,
                     void* flags, void* out, int64_t nu, int64_t width,
                     int64_t n_rows, cudaStream_t stream) {
  const int64_t acc_blocks =
      nu > 0 ? accumulate_blocks<kProductionRowsPerWarp>(nu) : 0;
  const int64_t per_block = (int64_t)kZeroVecs * kThreads * 8;
  const int64_t zero_blocks = (n_rows * width + per_block - 1) / per_block;
  const unsigned int grid = (unsigned int)(acc_blocks + zero_blocks);
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 8 == 0)
    accumulate_bf16_kernel<I, true><<<grid, kThreads, 0, stream>>>(
        (const I*)idx, (const __nv_bfloat16*)vals, (float*)ws,
        (unsigned int*)flags, (__nv_bfloat16*)out, nu, width, n_rows,
        acc_blocks);
  else
    accumulate_bf16_kernel<I, false><<<grid, kThreads, 0, stream>>>(
        (const I*)idx, (const __nv_bfloat16*)vals, (float*)ws,
        (unsigned int*)flags, (__nv_bfloat16*)out, nu, width, n_rows,
        acc_blocks);
  int err = (int)cudaGetLastError();
  if (err != 0 || nu == 0) return err;
  const int kVec = width % 8 == 0 ? 8 : 1;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < width / kVec && lanes_log2 < 5) ++lanes_log2;
  const int64_t blocks = ((nu << lanes_log2) + kThreads - 1) / kThreads;
  if (kVec == 8)
    emit_bf16_kernel<I, 8><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        (const I*)idx, (float*)ws, (unsigned int*)flags, (__nv_bfloat16*)out,
        nu, width, n_rows, lanes_log2);
  else
    emit_bf16_kernel<I, 1><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        (const I*)idx, (float*)ws, (unsigned int*)flags, (__nv_bfloat16*)out,
        nu, width, n_rows, lanes_log2);
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

// The bf16 route: launch A into the zero workspace `ws` [n_rows, width]
// (fp32, row stride width) and its zero flags [n_rows] (32-bit) plus the
// zero stream of the bf16 output, then launch B; leaves ws and flags zero.
// idx64 != 0 for int64 indices, else int32.
extern "C" int scatter_add_rows_bf16_once(const void* idx, int64_t idx64,
                                          const void* vals, void* ws,
                                          void* flags, void* out, int64_t nu,
                                          int64_t width, int64_t n_rows,
                                          void* stream) {
  if (n_rows <= 0 || width <= 0) return (int)cudaGetLastError();
  return idx64 ? launch_bf16_once<int64_t>(idx, vals, ws, flags, out, nu,
                                           width, n_rows,
                                           (cudaStream_t)stream)
               : launch_bf16_once<int32_t>(idx, vals, ws, flags, out, nu,
                                           width, n_rows,
                                           (cudaStream_t)stream);
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
