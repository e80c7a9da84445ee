// Integer-offset correlation windows on the tensor cores:
//
//   out[e, p, l, j*8 + i] = dot(f1[ii[e], p, :], f2_l[jj[e], xs[e, p, l] + j*w2p_l + i, :])
//
// the same function as `corr_window.cu` (same arguments, same j-major
// [E, HW, L, 64] fp32 output, zeros for an edge with mask[e] == 0), with the
// dots taken by `mma.sync` TF32 tensor-core instructions.
//
// Replaces the Pallas kernel `_corr_window_kernel_ml_mxu`
// (mneslam_tpu/ops/pallas_kernels.py:114, reached through
// `corr_window_int_multilevel(..., mxu=True)`, :176). That kernel assembles,
// per block of U = 16 pixels and level, the pixels' window rows of the
// VMEM-resident padded level as S [U*64, C], multiplies S @ f1_block^T on
// the MXU and keeps each pixel's own column. Hopper holds neither a padded
// level (2.9 MB at level 0) nor 16 pixels' window rows (512 KB) in a
// block's 227 KB of shared memory, so here the A fragments come straight
// from L1 / L2 and only the f1 operand stays resident, in registers.
//
// Design: one warp per (edge, group of 8 pixels, level); a block holds the
// L level-warps of one pixel group. mma.sync.m16n8k8 takes A = 16 window
// rows (two window rows j of one pixel, 8 entries i each) by 8 channels and
// B = those 8 channels of the 8 pixels' f1 (the N = 8 minimum width of
// mma.sync), so each product computes 8 pixels' dots of which the warp
// keeps the one column that belongs to the pixel of the window: 8-fold
// redundant work, as the TPU kernel's 16-fold. The K order is permuted so
// that each lane loads 4 consecutive channels of a row as one float4 (two
// k-steps), the same permutation on A and B; a sum over K does not depend on
// the order. B, the 8 pixels' f1 split into a TF32 high and low part, stays
// in registers for the whole warp (C / 2 registers).
//
// Precision: the repository keeps correlation in true fp32, so each product
// is 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi); the
// accumulator gets a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the lo*lo term, at
// 2^-22 of the product, is dropped), summed in fp32 by the tensor core.
//
// Bound on the card: the useful work is the same as kernel 2's (2 C flops
// per output); at the 8-fold redundancy and 3 passes the tensor cores do 24
// times that, which at the TF32 rate (495 TFLOP/s) is about 3x kernel 2's
// fp32 bound. Like kernel 2 it reads each f2 row once per output that uses
// it (512 B per 64 outputs) from L1 / L2, so it is bound by the load path
// first; reusing window rows across neighbouring pixels (TMA into shared
// memory, wgmma) is the work of the PR that makes kernels 2 / 2b fast.
//
// Interface: plain C, for ctypes, as corr_window.cu. The caller owns every
// buffer, passes PyTorch's current stream, and gets cudaGetLastError() back.
// Slab starts are clamped so that no read leaves its frame.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNx = 8;          // window side: 2 * radius + 2, radius 3
constexpr int kPix = 8;         // pixels per warp: the mma's N
constexpr int kMaxLevels = 4;

struct Levels {
  const float* f2[kMaxLevels];
  int64_t rows[kMaxLevels];     // padded rows per frame, H2p * w2p
  int64_t w2p[kMaxLevels];      // padded row width
};

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

template <int C>
__global__ void __launch_bounds__(32 * kMaxLevels)
corr_window_mma_kernel(const float* __restrict__ f1, const Levels lv,
                       const int* __restrict__ ii, const int* __restrict__ jj,
                       const int* __restrict__ mask,
                       const int* __restrict__ xs, float* __restrict__ out,
                       int hw, int n_levels) {
  constexpr int kM = C / 16;                  // float4 k-pairs per row
  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kPix;
  const int l = threadIdx.x / 32;             // one warp per level
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                     // mma groupID
  const int q = lane % 4;                     // mma threadID_in_group
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

  // B fragments: b0 = (k q, n g), b1 = (k q+4, n g), n = pixel g of the
  // group. k-step 2m+h, k-column kk <-> channel 16m + 4(kk&3) + 2h + (kk>>2),
  // so lane (g, q) holds channels 16m + 4q + {0..3} of pixel g.
  uint32_t bh[kM][4], bl[kM][4];
  {
    const int pg = min(p0 + g, hw - 1);
    const float4* f1p =
        reinterpret_cast<const float4*>(f1 + ((int64_t)ii[e] * hw + pg) * C);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float4 v = __ldg(f1p + 4 * m + q);
      split(v.x, bh[m][0], bl[m][0]);
      split(v.y, bh[m][1], bl[m][1]);
      split(v.z, bh[m][2], bl[m][2]);
      split(v.w, bh[m][3], bl[m][3]);
    }
  }

  const int64_t rows = lv.rows[l];
  const int64_t w2p = lv.w2p[l];
  const float* f2 = lv.f2[l] + (int64_t)jj[e] * rows * C;

  for (int u = 0; u < kPix; ++u) {
    const int p = p0 + u;
    if (p >= hw) break;                         // warp-uniform
    const int64_t x0 = xs[((int64_t)e * hw + p) * n_levels + l];
#pragma unroll 1
    for (int t = 0; t < kNx / 2; ++t) {         // m-tile: window rows 2t, 2t+1
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

template <int C>
int launch(const float* f1, const Levels& lv, const int* ii, const int* jj,
           const int* mask, const int* xs, float* out, int64_t n_edges,
           int64_t hw, int64_t n_levels, cudaStream_t stream) {
  const dim3 grid((unsigned int)((hw + kPix - 1) / kPix),
                  (unsigned int)n_edges);
  corr_window_mma_kernel<C><<<grid, 32 * (int)n_levels, 0, stream>>>(
      f1, lv, ii, jj, mask, xs, out, (int)hw, (int)n_levels);
  return 0;
}

}  // namespace

// f2 / rows / w2p: arrays of n_levels entries. c must be 32, 64 or 128.
// Returns a cudaError_t.
extern "C" int corr_window_mma(const void* f1, const void* const* f2,
                               const int64_t* rows, const int64_t* w2p,
                               const void* ii, const void* jj,
                               const void* mask, const void* xs, void* out,
                               int64_t n_edges, int64_t hw, int64_t c,
                               int64_t n_levels, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels ||
      (c != 32 && c != 64 && c != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : 0;
    lv.f2[l] = (const float*)f2[k];
    lv.rows[l] = rows[k];
    lv.w2p[l] = w2p[k];
  }
  if (n_edges > 0 && hw > 0) {
    const float* f1p = (const float*)f1;
    const int* iip = (const int*)ii;
    const int* jjp = (const int*)jj;
    const int* mp = (const int*)mask;
    const int* xsp = (const int*)xs;
    float* op = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (c == 32) launch<32>(f1p, lv, iip, jjp, mp, xsp, op, n_edges, hw, n_levels, s);
    if (c == 64) launch<64>(f1p, lv, iip, jjp, mp, xsp, op, n_edges, hw, n_levels, s);
    if (c == 128) launch<128>(f1p, lv, iip, jjp, mp, xsp, op, n_edges, hw, n_levels, s);
  }
  return (int)cudaGetLastError();
}
