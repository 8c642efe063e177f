// Column-slab tiles of the column kernels K2 (sim1.cu) and K4 (column.cu).
//
// A block takes a tile of TC consecutive columns and all their levels.
// The columns are those of F faces of `plane` columns each, flattened as
// (face, position in the face), so a tile may run over rows and faces,
// and the last tile is ragged: `cols` < TC.  A field is read or written
// through each column's face and position: element (f, k, p) of a field
// of `levels` levels and `plane` positions a face lies at
// ((f * levels + k) * plane + p).  A field whose n x n columns are the
// interior of N x N faces (N = n + 2h, as the halo-padded fields of the
// dycore are) is read at the padded position (j + h) * N + i + h, which
// the tile keeps beside the plain one, j * n + i.
//
// In shared memory a slab of one field holds slab[k * TC + c] for column c
// at level k.  Level-parallel loops give thread t the item (k, c) =
// (t / TC, t % TC), so the threads of a warp take consecutive columns of
// one level: consecutive addresses in device memory (coalesced, a row
// break aside) and distinct banks in shared memory.  A recurrence gives
// thread c < cols the column c and walks slab[k * TC + c] over k, again
// on distinct banks.  Slabs are loaded with 4-byte asynchronous copies
// (cp.async), every copy of the tile issued before the first wait; the
// interior of a padded row starts at column h, so wider copies would not
// be aligned there.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

template <int TC>
struct ColumnTile {
  int cols;         // columns of this tile: TC, fewer in the last one
  int face[TC];     // face of column c
  int pos[TC];      // its position j * n + i in an n x n face
  int pos_pad[TC];  // ... and (j + h) * (n + 2h) + i + h in a padded face
};

// The columns of block blockIdx.x's tile, over F faces of `plane`
// columns; n and h give the padded positions (h = 0: pos_pad = pos, any
// n).  Ends with a barrier.
template <int TC>
__device__ __forceinline__ void tile_columns(ColumnTile<TC>& tile, int F,
                                             int plane, int n, int h) {
  const long long c0 = (long long)blockIdx.x * TC;
  const long long all = (long long)F * plane;
  if (threadIdx.x == 0) tile.cols = (int)(all - c0 < TC ? all - c0 : TC);
  for (int c = threadIdx.x; c < TC; c += blockDim.x) {
    const long long col = c0 + c;
    const int p = (int)(col % plane);
    tile.face[c] = (int)(col / plane);
    tile.pos[c] = p;
    tile.pos_pad[c] = h == 0 ? p : (p / n + h) * (n + 2 * h) + p % n + h;
  }
  __syncthreads();
}

// Offset of element (face, k, pos) of a field of `levels` levels.
__device__ __forceinline__ long long column_at(int face, int levels, int k,
                                               int plane, int pos) {
  return ((long long)face * levels + k) * plane + pos;
}

// Copy levels [first, first + count) of the tile's columns of `src`, a
// field of `levels` levels on faces of `plane` positions (the tile's
// columns at pos[c]), into dst[(k - first) * TC + c], asynchronously; the
// caller commits, waits and synchronises.  Slots of the columns a ragged
// tile lacks are not written.
template <int TC, int THREADS>
__device__ __forceinline__ void load_levels(float* dst, const float* src,
                                            int levels, int first,
                                            int count, int plane,
                                            const ColumnTile<TC>& tile,
                                            const int* pos) {
  for (int t = threadIdx.x; t < count * TC; t += THREADS) {
    const int k = t / TC, c = t % TC;
    if (c < tile.cols)
      __pipeline_memcpy_async(
          dst + t,
          src + column_at(tile.face[c], levels, first + k, plane, pos[c]),
          sizeof(float));
  }
}

// ... all `levels` levels: dst[k * TC + c].
template <int TC, int THREADS>
__device__ __forceinline__ void load_slab(float* dst, const float* src,
                                          int levels, int plane,
                                          const ColumnTile<TC>& tile,
                                          const int* pos) {
  load_levels<TC, THREADS>(dst, src, levels, 0, levels, plane, tile, pos);
}

// Per device: whether a kernel's shared memory was set up, and the most
// dynamic shared memory its blocks may have.
struct SlabSmem {
  unsigned long long ready = 0;  // bit d: device d
  int limit[64] = {};
};

// Allow `kernel` the largest dynamic shared memory a block may have on
// the current device (the opt-in maximum less the kernel's static shared
// memory) and the largest shared-memory carveout, once per device; then 0
// if `bytes` fit, -1 if not, else the CUDA error.
template <typename Kernel>
int allow_slab_smem(Kernel kernel, size_t bytes, SlabSmem* s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if (!(s->ready >> dev & 1)) {
    cudaFuncAttributes fa;
    int optin = 0;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const int limit = optin - (int)fa.sharedSizeBytes;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    s->limit[dev] = limit;
    s->ready |= 1ull << dev;
  }
  return bytes <= (size_t)s->limit[dev] ? 0 : -1;
}

}  // namespace
