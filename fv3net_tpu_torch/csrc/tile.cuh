// Shared-memory tile loaders of the stencil kernels K1 (tp2d.cu) and K6
// (tp2d_multi5.cu): copy an H x W region at (r0, c0) of one N x N slab
// into shared memory with asynchronous copies (cp.async), every copy of a
// phase in flight at once, taking the indices modulo N (wrap_near, no
// division) only when the region reaches past the lattice edge, so a tile
// reproduces the roll() wrap-around of the plain versions on the whole
// padded lattice.  The thread that started an element's copy waits for it
// (__pipeline_wait_prior) before a barrier; the caller commits.
//
// The Tensor Memory Accelerator cannot take these slabs: its global
// strides must be multiples of 16 bytes, and the rows are 216 B (N = 54)
// and 792 B (N = 198).

#pragma once

#include <cuda_pipeline.h>

#include "tp2d_core.cuh"

namespace {

// 4-byte copies: dst[r * S + c] = src[(r0 + r) mod N][(c0 + c) mod N]
// for an H x W region, rows S apart in shared memory.
template <int H, int W, int THREADS, int S = W>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int c0, int N) {
  const bool inside = r0 >= 0 && c0 >= 0 && r0 + H <= N && c0 + W <= N;
  for (int t = threadIdx.x; t < H * W; t += THREADS) {
    const int rr = t / W, cc = t % W;
    int r = r0 + rr, c = c0 + cc;
    if (!inside) {
      r = wrap_near(r, N);
      c = wrap_near(c, N);
    }
    __pipeline_memcpy_async(dst + rr * S + cc, src + r * N + c,
                            sizeof(float));
  }
}

// Row stride in shared memory of a region W wide in load_tile_pairs's
// layout: room for one more column in front, even, so rows stay 8-byte
// aligned.
__host__ __device__ constexpr int pair_stride(int W) { return (W + 2) & ~1; }

// Where element (r, c) of a region whose columns start at c0 lands in
// its row: at c + pair_off(c0, pairs).
__device__ __forceinline__ int pair_off(int c0, bool pairs) {
  return pairs ? (c0 & 1) : 0;
}

// Element (r, c) of the H x W region at (r0, c0), modulo N, into
// dst[r * pair_stride(W) + pair_off(c0, pairs) + c].  With `pairs` (N
// even and the slab 8-byte aligned, so an even column starts an aligned
// pair that never straddles the wrap) the copies are 8-byte pairs from
// the even column at or before c0; otherwise 4-byte elements.
template <int H, int W, int THREADS>
__device__ __forceinline__ void load_tile_pairs(float* dst, const float* src,
                                                int r0, int c0, int N,
                                                bool pairs) {
  constexpr int S = pair_stride(W);
  if (pairs) {
    constexpr int P = S / 2;  // pairs a row: covers W + 1 columns
    const int cs = c0 - (c0 & 1);
    const bool inside = r0 >= 0 && cs >= 0 && r0 + H <= N && cs + S <= N;
    for (int t = threadIdx.x; t < H * P; t += THREADS) {
      const int rr = t / P, pp = t % P;
      int r = r0 + rr, c = cs + 2 * pp;
      if (!inside) {
        r = wrap_near(r, N);
        c = wrap_near(c, N);
      }
      __pipeline_memcpy_async(dst + rr * S + 2 * pp, src + r * N + c,
                              2 * sizeof(float));
    }
  } else {
    load_tile<H, W, THREADS, S>(dst, src, r0, c0, N);
  }
}

}  // namespace
