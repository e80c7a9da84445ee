// Box staging shared by the correlation-window kernels `corr_window.cu`
// (kernels 2 and 3) and `corr_window_mma.cu` (kernel 2b).
//
// A block owns one edge and one 4 x 4 tile of the H x W pixel grid. The
// lookup centres of neighbouring pixels lie close together, so the 8 x 8
// windows of a tile overlap, and their union in the padded level (the
// box: the rectangle from the smallest to the largest window origin, plus
// 7 rows and columns) is little larger than one window: 11 x 11 = 121 f2
// rows at level 0 for a smooth flow, 8 x 8 to 10 x 10 at levels 1-3,
// against the 16 x 64 = 1024 window rows the tile's outputs read. At the
// start the block finds every level's box (warp l: level l); then one
// stream of cp.async copies, kChunk channels of every box row at a time,
// runs through two buffers over all the levels that take the box path,
// the next chunk (of this level or the next) in flight while the block
// works on the current one, so neither a level's start nor its end waits
// for a copy. The block takes the dots of its 16 pixels with every box row
// as a small dense product and picks each pixel's 64 window entries from
// them.
//
// A tile takes the box path at a level when every one of its pixels has a
// slab start that no row of its window clamps (xs >= 0 and xs + 7 w2p <=
// R - 8) and whose window rows do not wrap past their padded image row
// (xs mod w2p + 8 <= w2p), and the box holds at most kBoxRows rows. Any
// other tile (centres scattered by a depth edge or by random weights,
// clamped or wrapping starts) computes that level with the row design of
// its kernel instead, while the first box chunk is in flight.
// `kernels/corr_window.py` `box_path_share` applies the same rules in
// Python.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace corr_box {

constexpr int kNx = 8;                       // window side: 2 r + 2, r = 3
constexpr int kMaxLevels = 4;
constexpr int kTileH = 4;                    // pixel tile: 4 x 4
constexpr int kTileW = 4;
constexpr int kTilePix = kTileH * kTileW;
constexpr int kThreads = 128;                // four warps per block
constexpr int kBoxRows = 160;                // box budget: f2 rows
constexpr int kChunk = 32;                   // channels per staged chunk
constexpr int kChunkStride = kChunk + 4;     // floats per staged row: the
                                             // 16-byte shift per row keeps
                                             // reads free of bank conflicts
constexpr int kBufFloats = kBoxRows * kChunkStride;
constexpr int kDStride = kBoxRows + 8;       // floats per row of the dots
static_assert(kBoxRows % 32 == 0, "a warp's row groups cover 32 rows");
static_assert(kThreads / 32 >= kMaxLevels, "a warp per level's box");
static_assert(kBoxRows <= 256, "r * ceil(2^16 / bx) >> 16 == r / bx for "
                               "r, bx < 256");

struct Levels {
  const float* f2[kMaxLevels];
  int64_t rows[kMaxLevels];                  // padded rows per frame, H2p * w2p
  int64_t w2p[kMaxLevels];                   // padded row width
};

// The host side's level table: n_levels entries, the rest copies of the
// first (never read).
inline Levels make_levels(const void* const* f2, const int64_t* rows,
                          const int64_t* w2p, int64_t n_levels) {
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : 0;
    lv.f2[l] = (const float*)f2[k];
    lv.rows[l] = rows[k];
    lv.w2p[l] = w2p[k];
  }
  return lv;
}

// The box of one tile at one level.
struct Box {
  int base;                                  // f2 row of the box's origin
  int bx;                                    // box width in f2 rows
  int inv_bx;                                // ceil(2^16 / bx): r / bx below
  int w2p;                                   // the level's padded row width
  int n;                                     // box rows, by * bx
  int ok;                                    // 1: this level takes the box path
  int off[kTilePix];                         // each pixel's window origin in the box
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The tile's pixel indices into the H x W grid (-1 past the ragged edge),
// written by the first kTilePix threads.
__device__ __forceinline__ void tile_pixels(int* pix, int hw, int width,
                                            int tid) {
  if (tid < kTilePix) {
    const int tiles_x = (width + kTileW - 1) / kTileW;
    const int py = (blockIdx.x / tiles_x) * kTileH + tid / kTileW;
    const int px = (blockIdx.x % tiles_x) * kTileW + tid % kTileW;
    pix[tid] = (py < hw / width && px < width) ? py * width + px : -1;
  }
}

// Run by one whole warp: the box of level l from the tile's slab starts
// (xs_e: this edge's [HW, L] starts) into `box`.
__device__ __forceinline__ void tile_box(const int* __restrict__ xs_e, int l,
                                         int n_levels, int64_t rows, int w2p,
                                         const int* pix, Box* box, int lane) {
  const bool mine = lane < kTilePix && pix[lane] >= 0;
  int ok = 1;
  int y = 0, x = 0;
  if (mine) {
    const int s = xs_e[(int64_t)pix[lane] * n_levels + l];
    if (s >= 0 && (int64_t)s + (kNx - 1) * w2p <= rows - kNx) {
      y = s / w2p;
      x = s - y * w2p;
      ok = x + kNx <= w2p;
    } else {
      ok = 0;
    }
  }
  int ymin = mine ? y : 0x7fffffff, xmin = mine ? x : 0x7fffffff;
  int ymax = mine ? y : -1, xmax = mine ? x : -1;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    ok &= __shfl_xor_sync(0xffffffffu, ok, m);
    ymin = min(ymin, __shfl_xor_sync(0xffffffffu, ymin, m));
    xmin = min(xmin, __shfl_xor_sync(0xffffffffu, xmin, m));
    ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, m));
    xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, m));
  }
  const int64_t by = (int64_t)ymax - ymin + kNx;
  const int64_t bx = (int64_t)xmax - xmin + kNx;
  ok = ok && by * bx <= kBoxRows;
  if (lane == 0) {
    box->ok = ok;
    box->base = ok ? ymin * w2p + xmin : 0;
    box->bx = ok ? (int)bx : 1;
    box->inv_bx = (65536 + box->bx - 1) / box->bx;
    box->w2p = w2p;
    box->n = ok ? (int)(by * bx) : 0;
  }
  if (mine && ok) box->off[lane] = (y - ymin) * (int)bx + (x - xmin);
}

// Every level's box, warp l finding level l's. Every thread of the block
// calls it (kMaxLevels <= the block's warps).
__device__ __forceinline__ void tile_boxes(const int* __restrict__ xs_e,
                                           const Levels& lv, int n_levels,
                                           const int* pix, Box* boxes,
                                           int tid) {
  const int warp = tid / 32;
  if (warp < n_levels) {
    tile_box(xs_e, warp, n_levels, lv.rows[warp], (int)lv.w2p[warp], pix,
             &boxes[warp], tid % 32);
  }
  __syncthreads();
}

// Issue the cp.async copies of channels [k0, k0 + kChunk) of every row of
// box b into dst [kBoxRows][kChunkStride]. f2: the target frame's level.
__device__ __forceinline__ void load_box_chunk(float* dst,
                                               const float* __restrict__ f2,
                                               const Box& b, int c, int k0,
                                               int tid) {
  constexpr int kSeg = kChunk / 4;           // 16-byte pieces per row
  for (int i = tid; i < b.n * kSeg; i += kThreads) {
    const int r = i / kSeg;
    const int s = i % kSeg;
    const int ry = (r * b.inv_bx) >> 16;     // r / bx
    const int row = b.base + ry * b.w2p + (r - ry * b.bx);
    cp_async16(dst + r * kChunkStride + 4 * s,
               f2 + (int64_t)row * c + k0 + 4 * s);
  }
}

// One stream of chunks over the levels that take the box path, through
// two buffers, the next chunk (of this level or the next box level) in
// flight while the block works on the current one. rows_first() runs once
// the first copy is issued (the levels on the row path, which use no
// buffer); compute(l, chunk, k0) for each chunk of level l; finish(l, buf)
// after level l's last chunk, with that chunk's buffer free for the dots;
// finish must end with __syncthreads(). f2_of(l): the target frame's level
// l. Every thread of the block calls it.
template <class F2, class RowsFirst, class Compute, class Finish>
__device__ __forceinline__ void stream_boxes(float* buf, const Box* boxes,
                                             int n_levels, int c, int tid,
                                             F2 f2_of, RowsFirst rows_first,
                                             Compute compute, Finish finish) {
  const int n_chunks = c / kChunk;
  auto next_box_level = [&](int l) {
    for (++l; l < n_levels && !boxes[l].ok; ++l) {
    }
    return l;
  };
  int l = next_box_level(-1);
  int ch = 0;
  if (l < n_levels) load_box_chunk(buf, f2_of(l), boxes[l], c, 0, tid);
  cp_async_commit();
  rows_first();
  for (int g = 0; l < n_levels; ++g) {
    int nl = l, nch = ch + 1;
    if (nch == n_chunks) {
      nl = next_box_level(l);
      nch = 0;
    }
    if (nl < n_levels) {
      load_box_chunk(buf + ((g + 1) & 1) * kBufFloats, f2_of(nl), boxes[nl],
                     c, nch * kChunk, tid);
    }
    cp_async_commit();                       // empty after the last chunk
    cp_async_wait_one();                     // chunk g has landed
    __syncthreads();
    float* cur = buf + (g & 1) * kBufFloats;
    compute(l, cur, ch * kChunk);
    __syncthreads();                         // before cur is reused
    if (nch == 0) finish(l, cur);
    l = nl;
    ch = nch;
  }
}

// Each tile pixel's 64 window entries of level l, picked from the dots
// d [kParts][kTilePix][kDStride] (kParts partial sums over channel slices,
// added here), stored j-major; a warp stores 32 consecutive floats of one
// pixel.
template <int kParts>
__device__ __forceinline__ void store_picked(const float* d, const Box& b,
                                             const int* pix,
                                             float* __restrict__ out_e,
                                             int per_pixel, int l, int tid) {
  static_assert(kParts * kTilePix * kDStride <= kBufFloats,
                "the dots reuse one chunk buffer");
  for (int o = tid; o < kTilePix * kNx * kNx; o += kThreads) {
    const int t = o / (kNx * kNx);
    const int w = o % (kNx * kNx);
    const int p = pix[t];
    if (p >= 0) {
      const int i = t * kDStride + b.off[t] + (w / kNx) * b.bx + w % kNx;
      float v = d[i];
#pragma unroll
      for (int s = 1; s < kParts; ++s) v += d[s * kTilePix * kDStride + i];
      out_e[(int64_t)p * per_pixel + l * kNx * kNx + w] = v;
    }
  }
}

// Zeros for every output of the tile (a masked edge).
__device__ __forceinline__ void store_zeros(const int* pix,
                                            float* __restrict__ out_e,
                                            int per_pixel, int tid) {
  for (int o = tid; o < kTilePix * per_pixel; o += kThreads) {
    const int p = pix[o / per_pixel];
    if (p >= 0) out_e[(int64_t)p * per_pixel + o % per_pixel] = 0.f;
  }
}

}  // namespace corr_box
