// K4: columnar pressure / Exner chain for Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_column.py::
// column_pressures_pallas (body _column_kernel) and computes what the plain
// fv3net_tpu_torch/ops/cuda_column.py::column_pressures_plain computes from
// the layer thicknesses dp [F, nz, Y, X]: the interface pressures
// pe = ptop + prefix sum of dp, the layer-mean Exner function
// pi = (pik+ pe+ - pik- pe-) / ((1 + kappa) dp) with pik = (pe/p00)^kappa,
// and the log-mean layer pressure pm = dp / (ln pe+ - ln pe-).
//
// Bound on the card: bytes (one value read and three written a level,
// 16 B) and nearly as much the operations of one powf and one logf at
// each interface.  A block takes a column slab (column_slab.cuh): TC
// consecutive columns of the F * Y * X and all their levels.
//   1. The tile's dp slab is copied into shared memory, every copy in
//      flight at once.
//   2. One thread a column runs the prefix sum acc = acc + dp in the
//      plain order (not a parallel scan, which would round otherwise) and
//      keeps pe = acc + ptop in shared memory.
//   3. kThreads / TC threads a column each take a run of consecutive
//      levels: powf and logf at the run's top interface, then once at
//      each interface below, carried down the run (one extra pair a run,
//      and no slab for them); pe, pi and pm are written as they come, a
//      coalesced row of the tile's columns a level.
// The two products of pi are rounded on their own (__fmul_rn), as the
// plain version rounds them, so nvcc contracts nothing into an FMA and the
// results do not depend on how the runs are cut.
// A column takes 2 nz + 1 floats: at nz = 63 and TC = 32, 16 KB a block,
// so some 13 blocks an SM overlap their copies with other blocks' powf.
// Halo-corner columns of the padded fields may hold garbage or NaN (the C
// half-stage feeds the padded delpc); they flow through the arithmetic
// without trapping and without an early exit, and are never consumed.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "column_slab.cuh"

namespace {

constexpr int TC = 32;         // columns a tile (a block)
constexpr int kThreads = 128;  // threads a block: kThreads / TC a column
// Design experiments (fv3net_tpu_torch/kernel_variants.py) turn one off:
// kMemory false fills the dp slab with a plausible column instead of
// copying it and stores nothing (the phases alone); kCompute false skips
// the prefix sum, powf and logf and stores the dp slab as each output
// (the copies alone).
constexpr bool kMemory = true;
constexpr bool kCompute = true;

// Shared memory of a block: dp's slab and pe's.
size_t smem_bytes(int nz) { return (2 * (size_t)nz + 1) * TC * sizeof(float); }

__device__ __forceinline__ void put(float* p, float v) {
  if (kMemory || v == 1.0e-30f) *p = v;
}

__global__ void __launch_bounds__(kThreads)
    column_kernel(const float* __restrict__ dp, float* __restrict__ pe,
                  float* __restrict__ pi_lay, float* __restrict__ pm, int F,
                  int nz, int yx, float ptop, float p00, float kappa) {
  extern __shared__ float smem[];
  __shared__ ColumnTile<TC> tile;
  const int L = nz * TC;  // floats of a layer slab
  float* dp_s = smem;
  float* pe_s = dp_s + L;  // nz + 1 levels
  tile_columns(tile, F, yx, 0, 0);
  const int cols = tile.cols;

  // 1. the tile's dp -----------------------------------------------------
  if (kMemory) {
    load_slab<TC, kThreads>(dp_s, dp, nz, yx, tile, tile.pos);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int t = threadIdx.x; t < L; t += kThreads) dp_s[t] = 1000.f;
  }
  __syncthreads();

  // 2. the prefix sum, one thread a column ------------------------------
  if (kCompute && threadIdx.x < cols) {
    float acc = 0.f;
    int t = threadIdx.x;
    pe_s[t] = acc + ptop;
    for (; t < L; t += TC) {
      acc = acc + dp_s[t];
      pe_s[t + TC] = acc + ptop;
    }
  }
  __syncthreads();

  // 3. runs of levels: Exner and log at the interfaces, the layers -------
  constexpr int kRuns = kThreads / TC;
  const int col = threadIdx.x % TC, run = threadIdx.x / TC;
  const int len = (nz + kRuns - 1) / kRuns;
  const int k0 = run * len, k1 = min(nz, k0 + len);
  if (col >= cols) return;
  const int f = tile.face[col], p = tile.pos[col];
  if (run == 0) put(pe + column_at(f, nz + 1, 0, yx, p), pe_s[col]);
  if (k0 >= k1) return;
  if (!kCompute) {
    for (int k = k0; k < k1; ++k) {
      const float v = dp_s[k * TC + col];
      put(pe + column_at(f, nz + 1, k + 1, yx, p), v);
      put(pi_lay + column_at(f, nz, k, yx, p), v);
      put(pm + column_at(f, nz, k, yx, p), v);
    }
    return;
  }
  float pe_lo = pe_s[k0 * TC + col];
  float pik_lo = powf(pe_lo / p00, kappa);
  float ln_lo = logf(pe_lo);
  for (int k = k0; k < k1; ++k) {
    const float d = dp_s[k * TC + col];
    const float pe_hi = pe_s[(k + 1) * TC + col];
    const float pik_hi = powf(pe_hi / p00, kappa);
    const float ln_hi = logf(pe_hi);
    put(pe + column_at(f, nz + 1, k + 1, yx, p), pe_hi);
    put(pi_lay + column_at(f, nz, k, yx, p),
        (__fmul_rn(pik_hi, pe_hi) - __fmul_rn(pik_lo, pe_lo)) /
            ((1.f + kappa) * d));
    put(pm + column_at(f, nz, k, yx, p), d / (ln_hi - ln_lo));
    pe_lo = pe_hi;
    pik_lo = pik_hi;
    ln_lo = ln_hi;
  }
}

}  // namespace

// dp [F, nz, Y, X] -> pe [F, nz+1, Y, X], pi_lay and pm [F, nz, Y, X];
// float32, contiguous.  Returns cudaGetLastError() after the launch (0 on
// success), -1 when a tile's slabs exceed a block's shared memory (nz >
// 905).
extern "C" int fv3_column(const float* dp, float* pe, float* pi_lay,
                          float* pm, int F, int nz, int yx, float ptop,
                          float p00, float kappa, void* stream) {
  const size_t bytes = smem_bytes(nz);
  static SlabSmem smem;
  const int err = allow_slab_smem(column_kernel, bytes, &smem);
  if (err != 0) return err;
  const long long columns = (long long)F * yx;
  if (columns == 0) return 0;
  column_kernel<<<(unsigned)((columns + TC - 1) / TC), kThreads, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      dp, pe, pi_lay, pm, F, nz, yx, ptop, p00, kappa);
  return (int)cudaGetLastError();
}
