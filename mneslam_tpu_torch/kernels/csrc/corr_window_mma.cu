// Integer-offset correlation windows on the tensor cores:
//
//   out[e, p, l, j*8 + i] = dot(f1[ii[e], p, :], f2_l[jj[e], xs[e, p, l] + j*w2p_l + i, :])
//
// the same function as `corr_window.cu` (same arguments, same j-major
// [E, HW, L, 64] fp32 output, zeros for an edge with mask[e] == 0, each
// window row's start clamped to [0, R_l - 8]), with the dots taken by
// `mma.sync` TF32 tensor-core instructions.
//
// Replaces the Pallas kernel `_corr_window_kernel_ml_mxu`
// (mneslam_tpu/ops/pallas_kernels.py:114, reached through
// `corr_window_int_multilevel(..., mxu=True)`, :176). That kernel assembles,
// per block of U = 16 pixels and level, the pixels' window rows of the
// VMEM-resident padded level as S [U*64, C], multiplies S @ f1_block^T on
// the MXU and keeps each pixel's own column. Hopper holds neither a padded
// level (2.9 MB at level 0) nor 16 pixels' window rows (512 KB) in a
// block's 227 KB of shared memory.
//
// Two designs, two entries.
//
// `corr_window_mma` (the box design, corr_box.cuh): one block of four
// warps per (edge, 4 x 4 pixel tile), walking the levels inside. The block
// stages the box of its pixels' windows of every level in shared memory,
// one stream of cp.async chunks of 32 channels through two buffers
// (corr_box.cuh), and multiplies on the tensor cores with
// mma.sync.m16n8k8: M = the tile's 16 pixels (A: their f1 rows, resident
// in shared memory as TF32 high and low parts), N = 8 box rows at a time
// (B, from the staged chunk, split as it is read; warp w takes the n-tiles
// w, w + 4, ...), K = C. Every product computes dots that the tile uses,
// up to the box's redundancy, in place of the row design's 8-fold waste.
// The dots go to shared memory and each pixel's 64 window entries are
// picked from them. A tile whose box does not fit computes that level with
// the row design below, inside the same kernel (warp w: pixels 8 (w / 2)
// .. + 7 of the tile, window rows 4 (w % 2) .. + 3). The box product splits
// its operands with integer operations (`split_bits`, the same rounding as
// `cvt.rna.tf32.f32`, which the compiler expands into a longer sequence).
//
// `corr_window_mma_rows` (the design of the first port): one warp per
// (edge, group of 8 consecutive pixels, level). A = 16 window rows (two
// window rows j of one pixel, 8 entries i each) straight from L1 / L2 by 8
// channels, B = those 8 channels of the 8 pixels' f1 (the N = 8 minimum of
// mma.sync), held in registers, so each product computes 8 pixels' dots of
// which the warp keeps one column: 8-fold redundant work. The K order is
// permuted so that each lane loads 4 consecutive channels of a row as one
// float4 (two k-steps), the same permutation on A and B.
//
// Precision: the repository keeps correlation in true fp32, so each product
// is 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi); the
// accumulator gets a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the lo*lo term, at
// 2^-22 of the product, is dropped), summed in fp32 by the tensor core.
//
// Bound on the card: the useful work is kernel 2's (2 C flops per output)
// at the TF32 rate (495 TFLOP/s), so the bytes (output, f1 and the f2
// frames once) bound it. The row design reads each f2 row once per output
// that uses it (about 31 GB per frontend lookup from L1 / L2) and issues 24
// times the useful flops; the box design reads each box row once per tile
// and level (about 2.7 GB from L2 for smooth centres) and issues 3 times
// the box's dots. As for kernel 2, the latency of the chunk copies bounds
// it now, not the mma.sync issue rate: its box path takes about as long as
// kernel 2's fp32 product on the same input (PERF.md), so `wgmma` would not
// pay before the staging does.
//
// Interface: plain C, for ctypes, as corr_window.cu. The caller owns every
// buffer, passes PyTorch's current stream, and gets cudaGetLastError() back.

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

constexpr int kPix = 8;         // pixels per warp of the row design: the mma's N
constexpr int kNTiles = kBoxRows / 8 / 4;   // n-tiles per warp of the box design

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo), x ~= hi + lo with both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// split() in integer ALU operations, for the box product's operands: the
// same rounding as cvt.rna.tf32.f32 (to nearest, ties away from zero: add
// half a TF32 ulp to the magnitude's bits, clear the 13 bits below)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_bits(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 3xTF32: A fragment from the (x, y) or (z, w) halves of the
// two float4 rows, B fragment pre-split.
__device__ __forceinline__ void step3(float (&d)[4], float r0a, float r0b,
                                      float r1a, float r1b, uint32_t bh0,
                                      uint32_t bh1, uint32_t bl0,
                                      uint32_t bl1) {
  uint32_t ah[4], al[4];
  // a0: (row g, k q), a1: (row g+8, k q), a2: (row g, k q+4), a3: (row g+8, k q+4)
  split(r0a, ah[0], al[0]);
  split(r1a, ah[1], al[1]);
  split(r0b, ah[2], al[2]);
  split(r1b, ah[3], al[3]);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The row design's work for one warp: 8 pixels (pixel(u) -> index into the
// H x W grid, or -1 for none), window-row pairs t in [t0, t1), one level.
// f1_e: frame ii[e]'s rows; f2: frame jj[e]'s padded level; xs_e: this
// edge's [HW, L] slab starts; out_e: this edge's outputs.
template <int C, class Pixel>
__device__ __forceinline__ void rows_mma(const float* __restrict__ f1_e,
                                         const float* __restrict__ f2,
                                         const int* __restrict__ xs_e,
                                         float* __restrict__ out_e,
                                         int64_t rows, int64_t w2p, int l,
                                         int n_levels, int t0, int t1,
                                         int lane, Pixel pixel) {
  constexpr int kM = C / 16;                  // float4 k-pairs per row
  const int g = lane / 4;                     // mma groupID
  const int q = lane % 4;                     // mma threadID_in_group
  const int per_pixel = n_levels * kNx * kNx;

  // B fragments: b0 = (k q, n g), b1 = (k q+4, n g), n = pixel g of the
  // group. k-step 2m+h, k-column kk <-> channel 16m + 4(kk&3) + 2h + (kk>>2),
  // so lane (g, q) holds channels 16m + 4q + {0..3} of pixel g.
  uint32_t bh[kM][4], bl[kM][4];
  {
    // a column past the ragged edge reads pixel 0 (it is never stored)
    const int pg = pixel(g) >= 0 ? pixel(g) : 0;
    const float4* f1p = reinterpret_cast<const float4*>(f1_e + (int64_t)pg * C);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float4 v = __ldg(f1p + 4 * m + q);
      split(v.x, bh[m][0], bl[m][0]);
      split(v.y, bh[m][1], bl[m][1]);
      split(v.z, bh[m][2], bl[m][2]);
      split(v.w, bh[m][3], bl[m][3]);
    }
  }

  for (int u = 0; u < kPix; ++u) {
    const int p = pixel(u);
    if (p < 0) continue;                        // warp-uniform
    const int64_t x0 = xs_e[(int64_t)p * n_levels + l];
    for (int t = t0; t < t1; ++t) {             // m-tile: window rows 2t, 2t+1
      int64_t b0 = x0 + (2 * t) * w2p;
      int64_t b1 = b0 + w2p;
      b0 = b0 < 0 ? 0 : (b0 > rows - kNx ? rows - kNx : b0);
      b1 = b1 < 0 ? 0 : (b1 > rows - kNx ? rows - kNx : b1);
      // A rows: g -> (j 2t, i g), g + 8 -> (j 2t+1, i g)
      const float4* r0 = reinterpret_cast<const float4*>(f2 + (b0 + g) * C);
      const float4* r1 = reinterpret_cast<const float4*>(f2 + (b1 + g) * C);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float4 a0 = __ldg(r0 + 4 * m + q);
        const float4 a1 = __ldg(r1 + 4 * m + q);
        step3(d, a0.x, a0.y, a1.x, a1.y, bh[m][0], bh[m][1], bl[m][0],
              bl[m][1]);
        step3(d, a0.z, a0.w, a1.z, a1.w, bh[m][2], bh[m][3], bl[m][2],
              bl[m][3]);
      }
      // pixel u's column 2q + (u & 1) is held by the lanes with q = u / 2:
      // d[u & 1] at row g, d[2 + (u & 1)] at row g + 8
      // (selects, not d[u & 1]: a run-time index would put d in local memory)
      if (q == (u >> 1)) {
        float* o = out_e + (int64_t)p * per_pixel + l * kNx * kNx + 16 * t;
        o[g] = (u & 1) ? d[1] : d[0];
        o[8 + g] = (u & 1) ? d[3] : d[2];
      }
    }
  }
}

// ---- the row design (`corr_window_mma_rows`) ----------------------------

template <int C>
__global__ void __launch_bounds__(32 * kMaxLevels)
corr_window_mma_rows_kernel(const float* __restrict__ f1, const Levels lv,
                            const int* __restrict__ ii,
                            const int* __restrict__ jj,
                            const int* __restrict__ mask,
                            const int* __restrict__ xs,
                            float* __restrict__ out, int hw, int n_levels) {
  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kPix;
  const int l = threadIdx.x / 32;             // one warp per level
  const int lane = threadIdx.x % 32;
  const int per_pixel = n_levels * kNx * kNx;
  float* out_e = out + (int64_t)e * hw * per_pixel;

  if (mask[e] == 0) {
    for (int k = lane; k < kPix * kNx * kNx; k += 32) {
      const int p = p0 + k / (kNx * kNx);
      if (p < hw) {
        out_e[(int64_t)p * per_pixel + l * kNx * kNx + k % (kNx * kNx)] = 0.f;
      }
    }
    return;
  }

  const int64_t rows = lv.rows[l];
  rows_mma<C>(f1 + (int64_t)ii[e] * hw * C,
              lv.f2[l] + (int64_t)jj[e] * rows * C,
              xs + (int64_t)e * hw * n_levels, out_e, rows, lv.w2p[l], l,
              n_levels, 0, kNx / 2, lane,
              [&](int u) { return p0 + u < hw ? p0 + u : -1; });
}

// ---- the box design (`corr_window_mma`) ---------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads, 3)
corr_window_mma_box_kernel(const float* __restrict__ f1, const Levels lv,
                           const int* __restrict__ ii,
                           const int* __restrict__ jj,
                           const int* __restrict__ mask,
                           const int* __restrict__ xs,
                           float* __restrict__ out, int hw, int width,
                           int n_levels) {
  constexpr int kFs = C + 4;                  // words per f1 row in shared memory
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);   // 2 x [kBoxRows][kChunkStride]
  uint32_t* a_hi = reinterpret_cast<uint32_t*>(buf + 2 * kBufFloats);
  uint32_t* a_lo = a_hi + kTilePix * kFs;         // [kTilePix][C + 4] each
  __shared__ int pix[kTilePix];
  __shared__ Box boxes[kMaxLevels];
  const int e = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int per_pixel = n_levels * kNx * kNx;
  float* out_e = out + (int64_t)e * hw * per_pixel;

  corr_box::tile_pixels(pix, hw, width, tid);
  __syncthreads();
  if (mask[e] == 0) {
    corr_box::store_zeros(pix, out_e, per_pixel, tid);
    return;
  }

  // the tile's f1 rows as TF32 high and low parts
  const float* f1_e = f1 + (int64_t)ii[e] * hw * C;
  for (int k = tid; k < kTilePix * C; k += kThreads) {
    const int t = k / C;
    const int p = pix[t];
    uint32_t hi, lo;
    split_bits(p >= 0 ? f1_e[(int64_t)p * C + k % C] : 0.f, hi, lo);
    a_hi[t * kFs + k % C] = hi;
    a_lo[t * kFs + k % C] = lo;
  }
  const int* xs_e = xs + (int64_t)e * hw * n_levels;
  corr_box::tile_boxes(xs_e, lv, n_levels, pix, boxes, tid);
  auto f2_of = [&](int l) {
    return lv.f2[l] + (int64_t)jj[e] * lv.rows[l] * C;
  };

  // the levels whose box does not fit: the row design (warp w: pixels
  // 8 (w / 2) .. + 7 of the tile, window rows 4 (w % 2) .. + 3)
  auto rows_first = [&]() {
    const int u0 = kPix * (warp / 2);
    const int t0 = 2 * (warp % 2);
    for (int l = 0; l < n_levels; ++l) {
      if (boxes[l].ok) continue;
      rows_mma<C>(f1_e, f2_of(l), xs_e, out_e, lv.rows[l], lv.w2p[l], l,
                  n_levels, t0, t0 + 2, lane,
                  [&](int u) { return pix[u0 + u]; });
    }
  };

  // the box levels: M = the 16 pixels, N = 8 box rows (warp w takes the
  // n-tiles w, w + 4, ...), K = the chunk's channels
  float d[kNTiles][4];
#pragma unroll
  for (int u = 0; u < kNTiles; ++u) d[u][0] = d[u][1] = d[u][2] = d[u][3] = 0.f;
  auto compute = [&](int l, const float* bs, int k0) {
    const int n_rows = boxes[l].n;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 8) {
      const int k = k0 + kk + q;
      const uint32_t ah[4] = {a_hi[g * kFs + k], a_hi[(g + 8) * kFs + k],
                              a_hi[g * kFs + k + 4],
                              a_hi[(g + 8) * kFs + k + 4]};
      const uint32_t al[4] = {a_lo[g * kFs + k], a_lo[(g + 8) * kFs + k],
                              a_lo[g * kFs + k + 4],
                              a_lo[(g + 8) * kFs + k + 4]};
#pragma unroll
      for (int u = 0; u < kNTiles; ++u) {
        const int n0 = 8 * (warp + 4 * u);
        if (n0 < n_rows) {
          const float* r = bs + (n0 + g) * kChunkStride + kk + q;
          uint32_t bh0, bl0, bh1, bl1;
          split_bits(r[0], bh0, bl0);
          split_bits(r[4], bh1, bl1);
          mma_tf32(d[u], al, bh0, bh1);
          mma_tf32(d[u], ah, bl0, bl1);
          mma_tf32(d[u], ah, bh0, bh1);
        }
      }
    }
  };
  // the dots [kTilePix][kDStride] in the free buffer, then the pick:
  // d0 (pixel g, row n0 + 2q), d1 (g, n0 + 2q + 1), d2 / d3 pixel g + 8
  auto finish = [&](int l, float* dots) {
    const int n_rows = boxes[l].n;
#pragma unroll
    for (int u = 0; u < kNTiles; ++u) {
      const int n0 = 8 * (warp + 4 * u);
      if (n0 < n_rows) {
        *reinterpret_cast<float2*>(dots + g * kDStride + n0 + 2 * q) =
            make_float2(d[u][0], d[u][1]);
        *reinterpret_cast<float2*>(dots + (g + 8) * kDStride + n0 + 2 * q) =
            make_float2(d[u][2], d[u][3]);
      }
      d[u][0] = d[u][1] = d[u][2] = d[u][3] = 0.f;
    }
    __syncthreads();
    corr_box::store_picked<1>(dots, boxes[l], pix, out_e, per_pixel, l, tid);
    __syncthreads();
  };
  corr_box::stream_boxes(buf, boxes, n_levels, C, tid, f2_of, rows_first,
                         compute, finish);
}

template <int C>
void launch_box(const float* f1, const Levels& lv, const int* ii,
                const int* jj, const int* mask, const int* xs, float* out,
                int64_t n_edges, int64_t hw, int64_t width, int64_t n_levels,
                cudaStream_t stream) {
  const int64_t tiles =
      ((hw / width + corr_box::kTileH - 1) / corr_box::kTileH) *
      ((width + corr_box::kTileW - 1) / corr_box::kTileW);
  const dim3 grid((unsigned int)tiles, (unsigned int)n_edges);
  const size_t smem = (2 * (size_t)kBufFloats + 2 * (size_t)kTilePix * (C + 4)) *
                      sizeof(float);
  static size_t smem_set = 0;                 // above 48 KB: opt in once
  if (smem > smem_set) {
    cudaFuncSetAttribute(corr_window_mma_box_kernel<C>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    smem_set = smem;
  }
  corr_window_mma_box_kernel<C><<<grid, kThreads, smem, stream>>>(
      f1, lv, ii, jj, mask, xs, out, (int)hw, (int)width, (int)n_levels);
}

template <int C>
void launch_rows(const float* f1, const Levels& lv, const int* ii,
                 const int* jj, const int* mask, const int* xs, float* out,
                 int64_t n_edges, int64_t hw, int64_t n_levels,
                 cudaStream_t stream) {
  const dim3 grid((unsigned int)((hw + kPix - 1) / kPix),
                  (unsigned int)n_edges);
  corr_window_mma_rows_kernel<C><<<grid, 32 * (int)n_levels, 0, stream>>>(
      f1, lv, ii, jj, mask, xs, out, (int)hw, (int)n_levels);
}

// width 0: the row design; otherwise the box design on an H x width grid
int dispatch(const void* f1, const void* const* f2, const int64_t* rows,
             const int64_t* w2p, const void* ii, const void* jj,
             const void* mask, const void* xs, void* out, int64_t n_edges,
             int64_t hw, int64_t width, int64_t c, int64_t n_levels,
             void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels ||
      (c != 32 && c != 64 && c != 128) || width < 0 ||
      (width > 0 && hw % width != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = make_levels(f2, rows, w2p, n_levels);
  if (n_edges > 0 && hw > 0) {
    const float* f1p = (const float*)f1;
    const int* iip = (const int*)ii;
    const int* jjp = (const int*)jj;
    const int* mp = (const int*)mask;
    const int* xsp = (const int*)xs;
    float* op = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
#define BOX_ARGS f1p, lv, iip, jjp, mp, xsp, op, n_edges, hw, width, n_levels, s
#define ROWS_ARGS f1p, lv, iip, jjp, mp, xsp, op, n_edges, hw, n_levels, s
    if (width > 0) {
      if (c == 32) launch_box<32>(BOX_ARGS);
      if (c == 64) launch_box<64>(BOX_ARGS);
      if (c == 128) launch_box<128>(BOX_ARGS);
    } else {
      if (c == 32) launch_rows<32>(ROWS_ARGS);
      if (c == 64) launch_rows<64>(ROWS_ARGS);
      if (c == 128) launch_rows<128>(ROWS_ARGS);
    }
#undef BOX_ARGS
#undef ROWS_ARGS
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The box design. f2 / rows / w2p: arrays of n_levels entries; width: the
// pixel grid's W (hw = H * W); c must be 32, 64 or 128. Returns a
// cudaError_t.
extern "C" int corr_window_mma(const void* f1, const void* const* f2,
                               const int64_t* rows, const int64_t* w2p,
                               const void* ii, const void* jj,
                               const void* mask, const void* xs, void* out,
                               int64_t n_edges, int64_t hw, int64_t width,
                               int64_t c, int64_t n_levels, void* stream) {
  if (width < 1) return (int)cudaErrorInvalidValue;
  return dispatch(f1, f2, rows, w2p, ii, jj, mask, xs, out, n_edges, hw,
                  width, c, n_levels, stream);
}

// The row design of the first port (no width argument).
extern "C" int corr_window_mma_rows(const void* f1, const void* const* f2,
                                    const int64_t* rows, const int64_t* w2p,
                                    const void* ii, const void* jj,
                                    const void* mask, const void* xs,
                                    void* out, int64_t n_edges, int64_t hw,
                                    int64_t c, int64_t n_levels,
                                    void* stream) {
  return dispatch(f1, f2, rows, w2p, ii, jj, mask, xs, out, n_edges, hw, 0,
                  c, n_levels, stream);
}
