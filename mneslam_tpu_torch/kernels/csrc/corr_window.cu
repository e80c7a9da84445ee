// Integer-offset correlation windows for the tracker's correlation lookup:
//
//   out[e, p, l, j*8 + i] = dot(f1[ii[e], p, :], f2_l[jj[e], xs[e, p, l] + j*w2p_l + i, :])
//
// for every edge e with mask[e] != 0, pixel p of frame ii[e] and pyramid
// level l (8 x 8 window, j-major; f1 is level 0 pre-scaled by 1/4, f2_l the
// zero-padded level l in row layout with padded width w2p_l). Each window
// row's start is clamped to [0, R_l - 8], whatever xs holds. Edges with
// mask[e] == 0 get zeros. With one level this is the per-level kernel.
//
// Replaces the Pallas kernels `_corr_window_kernel_ml` /
// `corr_window_int_multilevel` (mneslam_tpu/ops/pallas_kernels.py:55,
// :176) and `_corr_window_kernel` / `corr_window_int` (:25, :241). Those
// keep the target frame's whole padded level in the TPU's on-chip memory,
// run one edge per grid step and walk the pixels serially. That does not
// carry over: a padded level-0 frame at tracking resolution is 2.9 MB (all
// four levels 4.4 MB), far above the 227 KB of shared memory of a block,
// and Hopper runs blocks in parallel in no order.
//
// Two designs, two entries.
//
// `corr_window` (the box design, corr_box.cuh): one block of 128 threads
// per (edge, 4 x 4 pixel tile), walking the levels inside, so the tile
// stores 16 x 4 x 64 floats. The block stages the box of its pixels'
// windows of every level in shared memory, one stream of cp.async chunks
// of 32 channels through two buffers (corr_box.cuh), and takes the dots of
// its 16 pixels with every box row as a register-blocked fp32 product:
// warps 2 ks and 2 ks + 1 sum channels [16 ks, 16 ks + 16) of each chunk,
// and lane (pg, rg) keeps 8 pixels x 5 box rows of sums, so each float4 of
// f1 it reads from shared memory feeds 20 FMAs and each float4 of f2 32.
// The two slices' sums go to shared memory; each pixel's 64 window entries
// are picked from them, the slices added, and stored, 128 bytes per warp
// store. The sum over C stays a plain fp32 sum (no TF32). A tile whose box
// does not fit (see corr_box.cuh) computes that level with the row design
// below, inside the same kernel, while the first box chunk is in flight.
//
// `corr_window_rows` (the design of the first port): one block per (edge,
// 16 consecutive pixels), L * 64 threads. Eight lanes form a group that
// owns one window row (level l, row j): for each pixel the group reads the
// row's 8 contiguous f2 rows (4 KB) with float4 loads along C, lane s
// taking channels 4s + 32k; the eight partial dots of a lane are reduced
// across the group by a reduce-scatter of 7 shuffles, after which lane s
// holds window column i = s. `corr_window_unrolled` builds it with the
// pixel loop unrolled U-fold (U in 1, 2, 4, 8, 16; the counterparts of the
// TPU probe tools/prof_corr6.py); every output keeps its FMA sequence, so
// they equal `corr_window_rows` bit for bit.
//
// Bound on the card: fp32 operations (2 C flops per output, about 0.23 ms
// for a room0 frontend lookup of 75 real edges at the 67 TFLOP/s of the
// CUDA cores); the bytes it must move (the output, f1 and the f2 frames
// once) take less than that. The row design reads each f2 row once per
// output that uses it, from L1 / L2: about 31 GB through the load path
// per frontend lookup at 4 FMAs per 16-byte load, so the load path, not
// the FMAs, limits it. The box design reads each box row once per tile and
// level, about 2.7 GB from L2 for smooth centres, and pays for it with
// redundant FMAs (the box holds up to 1.9x the rows a pixel's window needs
// at level 0, 1.1-1.3x at levels 1-3, and the product runs in steps of 32
// rows). What bounds it now is the latency of the chunk copies, each a
// round trip to L2 that four blocks per SM hide only in part: a deeper
// stream or more blocks per SM is the next step (PERF.md, ROADMAP).
//
// Interface: plain C, for ctypes. The caller owns every buffer, passes
// PyTorch's current stream, and gets cudaGetLastError() back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "corr_box.cuh"

namespace {

using corr_box::Box;
using corr_box::kBoxRows;
using corr_box::kBufFloats;
using corr_box::kChunk;
using corr_box::kChunkStride;
using corr_box::kDStride;
using corr_box::kMaxLevels;
using corr_box::kNx;
using corr_box::kThreads;
using corr_box::kTilePix;
using corr_box::Levels;
using corr_box::make_levels;

constexpr int kGroup = 8;       // lanes per window row
constexpr int kTile = 16;       // pixels per block of the row design
// the box product: channel slices of a chunk, each summed by two warps
constexpr int kSlices = 2;
constexpr int kSliceWidth = corr_box::kChunk / kSlices;
constexpr int kPixPerThread = kTilePix / 2;
constexpr int kRowsPerThread = kBoxRows / 32;

// The row design's work for one (pixel, window row) and one 8-lane group:
// f1t the pixel's C channels as float4, f2 the target frame's level, start
// the row's unclamped slab start. Every lane of the warp must call it (the
// shuffles). -> lane s's window column i = s.
__device__ __forceinline__ float row_dot(const float4* f1t,
                                         const float* __restrict__ f2,
                                         int64_t start, int64_t rows, int c,
                                         int s) {
  const int c4 = c / 4;
  start = start < 0 ? 0 : (start > rows - kNx ? rows - kNx : start);
  const float4* row0 = reinterpret_cast<const float4*>(f2 + start * c);
  float acc[kNx];
#pragma unroll
  for (int i = 0; i < kNx; ++i) acc[i] = 0.f;
  for (int k = 0; k < c / 32; ++k) {
    const float4 a = f1t[s + kGroup * k];
#pragma unroll
    for (int i = 0; i < kNx; ++i) {
      const float4 b = __ldg(row0 + i * c4 + s + kGroup * k);
      acc[i] = fmaf(a.x, b.x, acc[i]);
      acc[i] = fmaf(a.y, b.y, acc[i]);
      acc[i] = fmaf(a.z, b.z, acc[i]);
      acc[i] = fmaf(a.w, b.w, acc[i]);
    }
  }

  // reduce-scatter over the group's 8 lanes: after the three steps lane
  // s holds the full dot of window column i = s
  float h4[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const bool hi = s & 4;
    const float send = hi ? acc[m] : acc[m + 4];
    const float keep = hi ? acc[m + 4] : acc[m];
    h4[m] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  float h2[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const bool hi = s & 2;
    const float send = hi ? h4[m] : h4[m + 2];
    const float keep = hi ? h4[m + 2] : h4[m];
    h2[m] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const bool hi = s & 1;
  const float send = hi ? h2[0] : h2[1];
  const float keep = hi ? h2[1] : h2[0];
  return keep + __shfl_xor_sync(0xffffffffu, send, 1);
}

// ---- the row design (`corr_window_rows`, `corr_window_unrolled`) --------

// kUnroll 0: the compiler's choice (the `corr_window_rows` entry);
// otherwise the pixel loop carries `#pragma unroll (kUnroll)`
template <int kUnroll>
__global__ void corr_window_rows_kernel(const float* __restrict__ f1,
                                        const Levels lv,
                                        const int* __restrict__ ii,
                                        const int* __restrict__ jj,
                                        const int* __restrict__ mask,
                                        const int* __restrict__ xs,
                                        float* __restrict__ out, int hw,
                                        int c, int n_levels) {
  extern __shared__ float4 sh_f1[];             // [kTile][c / 4]
  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int per_pixel = n_levels * kNx * kNx;   // outputs per pixel
  float* out_e = out + (int64_t)e * hw * per_pixel;

  if (mask[e] == 0) {
    const int n = kTile * per_pixel;
    for (int k = tid; k < n; k += blockDim.x) {
      if (p0 + k / per_pixel < hw) out_e[(int64_t)p0 * per_pixel + k] = 0.f;
    }
    return;
  }

  const int c4 = c / 4;
  const float4* f1_src =
      reinterpret_cast<const float4*>(f1 + ((int64_t)ii[e] * hw + p0) * c);
  for (int k = tid; k < kTile * c4; k += blockDim.x) {
    sh_f1[k] = (p0 + k / c4 < hw) ? f1_src[k] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int group = tid / kGroup;               // (level, window row)
  const int s = tid % kGroup;
  const int l = group / kNx;
  const int j = group % kNx;
  const int64_t rows = lv.rows[l];
  const int64_t w2p = lv.w2p[l];
  const float* f2 = lv.f2[l] + (int64_t)jj[e] * rows * c;

  auto pixel = [&](int t) {
    const int p = p0 + t;
    // every lane runs every pixel, so the shuffles see a full warp
    const int pc = p < hw ? p : hw - 1;
    const int64_t start =
        (int64_t)xs[((int64_t)e * hw + pc) * n_levels + l] + j * w2p;
    const float r = row_dot(sh_f1 + t * c4, f2, start, rows, c, s);
    if (p < hw) out_e[(int64_t)p * per_pixel + l * kNx * kNx + j * kNx + s] = r;
  };

  if constexpr (kUnroll == 0) {
    for (int t = 0; t < kTile; ++t) pixel(t);
  } else {
#pragma unroll (kUnroll)
    for (int t = 0; t < kTile; ++t) pixel(t);
  }
}

// ---- the box design (`corr_window`) -------------------------------------

// four blocks of 55 KB (C = 128) per SM: at most 128 registers
__global__ void __launch_bounds__(kThreads, 4)
corr_window_box_kernel(const float* __restrict__ f1, const Levels lv,
                       const int* __restrict__ ii, const int* __restrict__ jj,
                       const int* __restrict__ mask,
                       const int* __restrict__ xs, float* __restrict__ out,
                       int hw, int width, int c, int n_levels) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // 2 [kBoxRows][kChunkStride]
  float4* sf1 = smem4 + 2 * kBufFloats / 4;      // [kTilePix][c / 4 + 1]
  __shared__ int pix[kTilePix];
  __shared__ Box boxes[kMaxLevels];
  const int e = blockIdx.y;
  const int tid = threadIdx.x;
  const int per_pixel = n_levels * kNx * kNx;
  float* out_e = out + (int64_t)e * hw * per_pixel;

  corr_box::tile_pixels(pix, hw, width, tid);
  __syncthreads();
  if (mask[e] == 0) {
    corr_box::store_zeros(pix, out_e, per_pixel, tid);
    return;
  }

  // the tile's f1 rows, one float4 of padding per row
  const int c4 = c / 4;
  const int fs4 = c4 + 1;
  const float4* f1_e =
      reinterpret_cast<const float4*>(f1 + (int64_t)ii[e] * hw * c);
  for (int k = tid; k < kTilePix * c4; k += kThreads) {
    const int t = k / c4;
    const int p = pix[t];
    sf1[t * fs4 + k % c4] = p >= 0 ? f1_e[(int64_t)p * c4 + k % c4]
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int* xs_e = xs + (int64_t)e * hw * n_levels;
  corr_box::tile_boxes(xs_e, lv, n_levels, pix, boxes, tid);
  auto f2_of = [&](int l) {
    return lv.f2[l] + (int64_t)jj[e] * lv.rows[l] * c;
  };

  // the levels whose box does not fit: the row design. Group g of 8 lanes
  // owns window row g % 8 of pixels 2u + g / 8 (one pixel per warp at a
  // time)
  auto rows_first = [&]() {
    const int g = tid / kGroup;
    const int s = tid % kGroup;
    const int j = g % kNx;
    for (int l = 0; l < n_levels; ++l) {
      if (boxes[l].ok) continue;
      for (int u = 0; u < kTilePix / 2; ++u) {
        const int t = 2 * u + g / kNx;
        const int p = pix[t];
        const int pc = p >= 0 ? p : pix[0];
        const int64_t start =
            (int64_t)xs_e[(int64_t)pc * n_levels + l] + j * lv.w2p[l];
        const float r = row_dot(sf1 + t * fs4, f2_of(l), start, lv.rows[l],
                                c, s);
        if (p >= 0) {
          out_e[(int64_t)p * per_pixel + l * kNx * kNx + j * kNx + s] = r;
        }
      }
    }
  };

  // the box levels: warp pairs ks = 0, 1 sum channels [16 ks, 16 ks + 16)
  // of each chunk; thread (ks, pg, rg) keeps pixels 8 pg .. 8 pg + 7 x box
  // rows rg, rg + 32, ... of its slice's sums
  const int ks = tid / 64;
  const int pg = (tid / 32) % 2;
  const int rg = tid % 32;
  float acc[kPixPerThread][kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kPixPerThread; ++m) {
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[m][q] = 0.f;
  }
  auto compute = [&](int l, const float* bs, int k0) {
    const int n_rows = boxes[l].n;
#pragma unroll
    for (int h = 0; h < kSliceWidth; h += 4) {
      const int k = ks * kSliceWidth + h;         // channel in the chunk
      float4 a[kPixPerThread];
#pragma unroll
      for (int m = 0; m < kPixPerThread; ++m) {
        a[m] = sf1[(kPixPerThread * pg + m) * fs4 + (k0 + k) / 4];
      }
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        if (32 * q < n_rows) {
          const float4 b = *reinterpret_cast<const float4*>(
              bs + (rg + 32 * q) * kChunkStride + k);
#pragma unroll
          for (int m = 0; m < kPixPerThread; ++m) {
            acc[m][q] = fmaf(a[m].x, b.x, acc[m][q]);
            acc[m][q] = fmaf(a[m].y, b.y, acc[m][q]);
            acc[m][q] = fmaf(a[m].z, b.z, acc[m][q]);
            acc[m][q] = fmaf(a[m].w, b.w, acc[m][q]);
          }
        }
      }
    }
  };
  // the slices' dots [kSlices][kTilePix][kDStride] in the free buffer, then
  // the pick adds them
  auto finish = [&](int l, float* d) {
    const int n_rows = boxes[l].n;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
#pragma unroll
      for (int m = 0; m < kPixPerThread; ++m) {
        if (32 * q < n_rows) {
          d[(ks * kTilePix + kPixPerThread * pg + m) * kDStride + rg +
            32 * q] = acc[m][q];
        }
        acc[m][q] = 0.f;
      }
    }
    __syncthreads();
    corr_box::store_picked<kSlices>(d, boxes[l], pix, out_e, per_pixel, l,
                                    tid);
    __syncthreads();
  };
  corr_box::stream_boxes(buf, boxes, n_levels, c, tid, f2_of, rows_first,
                         compute, finish);
}

template <int kUnroll>
int launch_rows(const void* f1, const void* const* f2, const int64_t* rows,
                const int64_t* w2p, const void* ii, const void* jj,
                const void* mask, const void* xs, void* out, int64_t n_edges,
                int64_t hw, int64_t c, int64_t n_levels, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || c % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = make_levels(f2, rows, w2p, n_levels);
  if (n_edges > 0 && hw > 0) {
    const dim3 grid((unsigned int)((hw + kTile - 1) / kTile),
                    (unsigned int)n_edges);
    const int threads = (int)n_levels * kNx * kGroup;
    const size_t smem = (size_t)kTile * c * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(corr_window_rows_kernel<kUnroll>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    corr_window_rows_kernel<kUnroll><<<grid, threads, smem,
                                       (cudaStream_t)stream>>>(
        (const float*)f1, lv, (const int*)ii, (const int*)jj,
        (const int*)mask, (const int*)xs, (float*)out, (int)hw, (int)c,
        (int)n_levels);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The box design. f2 / rows / w2p: arrays of n_levels entries; width: the
// pixel grid's W (hw = H * W). Returns a cudaError_t.
extern "C" int corr_window(const void* f1, const void* const* f2,
                           const int64_t* rows, const int64_t* w2p,
                           const void* ii, const void* jj, const void* mask,
                           const void* xs, void* out, int64_t n_edges,
                           int64_t hw, int64_t width, int64_t c,
                           int64_t n_levels, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || c % kChunk != 0 || c <= 0 ||
      width < 1 || hw % width != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = make_levels(f2, rows, w2p, n_levels);
  if (n_edges > 0 && hw > 0) {
    const int64_t tiles = ((hw / width + corr_box::kTileH - 1) /
                           corr_box::kTileH) *
                          ((width + corr_box::kTileW - 1) / corr_box::kTileW);
    const dim3 grid((unsigned int)tiles, (unsigned int)n_edges);
    const size_t smem = (2 * (size_t)kBufFloats +
                         (size_t)kTilePix * (c + 4)) * sizeof(float);
    static size_t smem_set = 0;                // above 48 KB: opt in once
    if (smem > smem_set) {
      cudaFuncSetAttribute(corr_window_box_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      smem_set = smem;
    }
    corr_window_box_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)f1, lv, (const int*)ii, (const int*)jj,
        (const int*)mask, (const int*)xs, (float*)out, (int)hw, (int)width,
        (int)c, (int)n_levels);
  }
  return (int)cudaGetLastError();
}

// The row design of the first port (no width argument).
extern "C" int corr_window_rows(const void* f1, const void* const* f2,
                                const int64_t* rows, const int64_t* w2p,
                                const void* ii, const void* jj,
                                const void* mask, const void* xs, void* out,
                                int64_t n_edges, int64_t hw, int64_t c,
                                int64_t n_levels, void* stream) {
  return launch_rows<0>(f1, f2, rows, w2p, ii, jj, mask, xs, out, n_edges, hw,
                        c, n_levels, stream);
}

// The row design with the pixel loop unrolled `unroll`-fold (1, 2, 4, 8 or
// 16).
extern "C" int corr_window_unrolled(const void* f1, const void* const* f2,
                                    const int64_t* rows, const int64_t* w2p,
                                    const void* ii, const void* jj,
                                    const void* mask, const void* xs,
                                    void* out, int64_t n_edges, int64_t hw,
                                    int64_t c, int64_t n_levels,
                                    int64_t unroll, void* stream) {
#define CORR_ARGS f1, f2, rows, w2p, ii, jj, mask, xs, out, n_edges, hw, c, \
                  n_levels, stream
  switch (unroll) {
    case 1: return launch_rows<1>(CORR_ARGS);
    case 2: return launch_rows<2>(CORR_ARGS);
    case 4: return launch_rows<4>(CORR_ARGS);
    case 8: return launch_rows<8>(CORR_ARGS);
    case 16: return launch_rows<16>(CORR_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CORR_ARGS
}
