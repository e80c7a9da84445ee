// Integer-offset correlation windows for the tracker's correlation lookup:
//
//   out[e, p, l, j*8 + i] = dot(f1[ii[e], p, :], f2_l[jj[e], xs[e, p, l] + j*w2p_l + i, :])
//
// for every edge e with mask[e] != 0, pixel p of frame ii[e] and pyramid
// level l (8 x 8 window, j-major; f1 is level 0 pre-scaled by 1/4, f2_l the
// zero-padded level l in row layout with padded width w2p_l). Edges with
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
// Design: one block per (edge, tile of kTile pixels), L * 64 threads. The
// block reads ii / jj / mask itself; a masked edge writes zeros and
// returns. The tile's f1 rows (C fp32 each, 512 B at C = 128) are staged in
// shared memory. Eight lanes form a group that owns one window row (level
// l, row j): for each pixel the group reads the row's 8 contiguous f2 rows
// (4 KB) with float4 loads along C, lane s taking channels 4s + 32k, so
// each load instruction of a warp covers four full 128-byte lines. The
// eight partial dots of a lane are reduced across the group by a
// reduce-scatter of 7 shuffles, after which lane s holds window column
// i = s and the warp stores 32 consecutive floats. f2 comes through L2
// (50 MB): the frames one frontend update touches (25 or so, 4.4 MB each)
// fit, shared memory does not hold them.
//
// Bound on the card: fp32 operations (2 * C flops per output, about 0.3 ms
// for a room0 frontend update at the 67 TFLOP/s of the CUDA cores); the
// bytes it must move (the output, f1 and the f2 frames once) take less than
// half of that. This design reads each f2 row once per output that uses
// it, from L1 / L2, so it is limited by the load path, not by the FMAs
// (4 FMAs per 16-byte load); reusing rows across neighbouring pixels from
// shared memory, or tensor cores, is the work of a later version.
//
// The entry `corr_window_unrolled` builds the same kernel with the pixel
// loop unrolled U-fold (U in 1, 2, 4, 8, 16): the counterparts of the TPU
// probe's pixel-loop unroll (tools/prof_corr6.py). Every output keeps its
// FMA sequence, so they equal the production entry bit for bit; the
// production entry `corr_window` leaves the unroll to the compiler.
//
// Interface: plain C, for ctypes. The caller owns every buffer, passes
// PyTorch's current stream, and gets cudaGetLastError() back. Slab starts
// are clamped so that no read leaves its frame, whatever xs holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNx = 8;          // window side: 2 * radius + 2, radius 3
constexpr int kGroup = 8;       // lanes per window row
constexpr int kTile = 16;       // pixels per block
constexpr int kMaxLevels = 4;

struct Levels {
  const float* f2[kMaxLevels];
  int64_t rows[kMaxLevels];     // padded rows per frame, H2p * w2p
  int64_t w2p[kMaxLevels];      // padded row width
};

// kUnroll 0: the compiler's choice (the production entry); otherwise the
// pixel loop carries `#pragma unroll (kUnroll)`
template <int kUnroll>
__global__ void corr_window_kernel(const float* __restrict__ f1,
                                   const Levels lv,
                                   const int* __restrict__ ii,
                                   const int* __restrict__ jj,
                                   const int* __restrict__ mask,
                                   const int* __restrict__ xs,
                                   float* __restrict__ out, int hw, int c,
                                   int n_levels) {
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
  const int nk = c / 32;

  auto pixel = [&](int t) {
    const int p = p0 + t;
    // every lane runs every pixel, so the shuffles below see a full warp
    const int pc = p < hw ? p : hw - 1;
    int64_t base = (int64_t)xs[((int64_t)e * hw + pc) * n_levels + l] + j * w2p;
    base = base < 0 ? 0 : (base > rows - kNx ? rows - kNx : base);
    const float4* row0 = reinterpret_cast<const float4*>(f2 + base * c);

    float acc[kNx];
#pragma unroll
    for (int i = 0; i < kNx; ++i) acc[i] = 0.f;
    for (int k = 0; k < nk; ++k) {
      const float4 a = sh_f1[t * c4 + s + kGroup * k];
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
    const float r = keep + __shfl_xor_sync(0xffffffffu, send, 1);

    if (p < hw) out_e[(int64_t)p * per_pixel + l * kNx * kNx + j * kNx + s] = r;
  };

  if constexpr (kUnroll == 0) {
    for (int t = 0; t < kTile; ++t) pixel(t);
  } else {
#pragma unroll (kUnroll)
    for (int t = 0; t < kTile; ++t) pixel(t);
  }
}

template <int kUnroll>
int launch(const void* f1, const void* const* f2, const int64_t* rows,
           const int64_t* w2p, const void* ii, const void* jj,
           const void* mask, const void* xs, void* out, int64_t n_edges,
           int64_t hw, int64_t c, int64_t n_levels, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || c % 32 != 0) {
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
    const dim3 grid((unsigned int)((hw + kTile - 1) / kTile),
                    (unsigned int)n_edges);
    const int threads = (int)n_levels * kNx * kGroup;
    const size_t smem = (size_t)kTile * c * sizeof(float);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(corr_window_kernel<kUnroll>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    corr_window_kernel<kUnroll><<<grid, threads, smem,
                                  (cudaStream_t)stream>>>(
        (const float*)f1, lv, (const int*)ii, (const int*)jj,
        (const int*)mask, (const int*)xs, (float*)out, (int)hw, (int)c,
        (int)n_levels);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f2 / rows / w2p: arrays of n_levels entries. Returns a cudaError_t.
extern "C" int corr_window(const void* f1, const void* const* f2,
                           const int64_t* rows, const int64_t* w2p,
                           const void* ii, const void* jj, const void* mask,
                           const void* xs, void* out, int64_t n_edges,
                           int64_t hw, int64_t c, int64_t n_levels,
                           void* stream) {
  return launch<0>(f1, f2, rows, w2p, ii, jj, mask, xs, out, n_edges, hw, c,
                   n_levels, stream);
}

// The same with the pixel loop unrolled `unroll`-fold (1, 2, 4, 8 or 16).
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
    case 1: return launch<1>(CORR_ARGS);
    case 2: return launch<2>(CORR_ARGS);
    case 4: return launch<4>(CORR_ARGS);
    case 8: return launch<8>(CORR_ARGS);
    case 16: return launch<16>(CORR_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CORR_ARGS
}
