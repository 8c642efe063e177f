// K2: semi-implicit vertical acoustic solve (SIM1) for Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_sim1.py::sim1_solver_pallas
// (body _sim1_kernel) and computes what the plain
// fv3net_tpu_torch/dycore/riemann.py::sim1_solver computes: per column,
// the gas-law layer pressure perturbation, the bidiagonal forward sweep for
// the interface perturbation pp, a Thomas solve for w, the ppe prefix sum
// and the new layer thickness dz2.
//
// Bound on the card: the bytes of 7 inputs and 3 outputs (9 field passes)
// and the latency of three level recurrences of ~60 operations a level.  A
// block takes a column slab (column_slab.cuh): TC consecutive columns and
// all their levels, so the inputs are read from device memory once (pm
// twice) and every output written once, and the recurrences read shared
// memory only.  Phases of a block, separated by barriers:
//   (a) copy dm, pt, dz, w, pm and ws of the tile into shared memory,
//       every copy issued before the first wait;
//   (b) level-parallel: the gas-law perturbation pe', then the row
//       coefficients g = dm[k] / dm[k+1] and dd of the pp rows; then the
//       copies of pem, in flight during
//   (c) one thread a column: the pp sweep (bb = 2 (1 + g) in the loop);
//   (d) level-parallel: the stiffnesses a_dn (aa and p1) and the
//       right-hand sides r;
//   (e) one thread a column: Thomas forward and back, then
//   (f) the ppe prefix sum;
//   (g) level-parallel: dz2 (pm read once more from device memory), and
//       w2, dz2 and ppe written once each.
// Every value is the plain version's expression, computed where its
// phase puts it: the results do not depend on the tile.  The resident
// columns bound the recurrences (one warp of a block runs them), so slabs
// are reused as values die: x1 holds pm, pe' (in place), pem[k + 1]
// (copied after (b)), a_dn and the Thomas factors (in place); x2 holds g,
// r, then the forward and back-substituted w; x3 holds dd, pp[k + 1] (the
// sweep overwrites dd[k] in place), then ppe[k + 1].  A column takes
// 7 nz + 1 floats: at nz = 63 and TC = 32, 57 KB a block, four blocks an
// SM.
//
// pem, pm and ws may be the halo-padded fields [F, nz(+1), N, N] (N = n +
// 2h) of which the solve reads the interior, so the step passes them
// without a copy; dm, pt, dz, w and the outputs are [F, nz(+1), n, n].

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "column_slab.cuh"

namespace {

constexpr int TC = 32;         // columns a tile (a block)
constexpr int kThreads = 512;  // threads a block: 16 warps for the phases
// four tiles an SM fit its shared memory: keep their 2048 threads in its
// registers (32 a thread)
constexpr int kMinBlocks = 2048 / kThreads;
// Design experiments (fv3net_tpu_torch/kernel_variants.py) switch off
// parts of the work: kMemory false fills the slabs with one plausible
// column instead of copying them and stores nothing; kPhases false skips
// the level-parallel arithmetic of (b), (d) and (g); kRecurrences false
// skips (c), (e) and (f).  With both off the copies alone remain: w, dz
// and pem's slabs are stored as the outputs.
constexpr bool kMemory = true;
constexpr bool kPhases = true;
constexpr bool kRecurrences = true;

struct Consts {
  float rdgas, p00, gamma, dz_exp;  // dz_exp = -cv/cp
};

// Shared memory of a block: 7 slabs of nz levels and ws.
size_t smem_bytes(int nz) { return (7 * (size_t)nz + 1) * TC * sizeof(float); }

// Store v at p (without kMemory, a store no column takes keeps the
// arithmetic in the program).
__device__ __forceinline__ void put(float* p, float v) {
  if (kMemory || v == 1.0e-30f) *p = v;
}

// Every product that meets a sum is rounded on its own (__fmul_rn), as the
// plain version rounds it: nvcc then contracts nothing into an FMA, and the
// results depend neither on the tile nor on how the code is arranged.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sim1_kernel(const float* __restrict__ dm, const float* __restrict__ pt,
                const float* __restrict__ dz, const float* __restrict__ w,
                const float* __restrict__ pem, const float* __restrict__ pm,
                const float* __restrict__ ws, float* __restrict__ w2,
                float* __restrict__ dz2, float* __restrict__ ppe, int F,
                int nz, int n, int h, float dt, float p_fac, Consts c) {
  extern __shared__ float smem[];
  __shared__ ColumnTile<TC> tile;
  const int L = nz * TC;  // floats of a layer slab
  float* dm_s = smem;
  float* pt_s = dm_s + L;
  float* dz_s = pt_s + L;
  float* w_s = dz_s + L;
  float* x1 = w_s + L;  // pm, pe', pem[k + 1], a_dn, the Thomas factors
  float* x2 = x1 + L;   // g_rat, r, w
  float* x3 = x2 + L;   // dd, pp[k + 1], ppe[k + 1]
  float* ws_s = x3 + L;  // one level
  const int nn = n * n, NN = (n + 2 * h) * (n + 2 * h);
  tile_columns(tile, F, nn, n, h);
  const int cols = tile.cols;

  // (a) the tile's inputs ------------------------------------------------
  if (kMemory) {
    load_slab<TC, kThreads>(dm_s, dm, nz, nn, tile, tile.pos);
    load_slab<TC, kThreads>(pt_s, pt, nz, nn, tile, tile.pos);
    load_slab<TC, kThreads>(dz_s, dz, nz, nn, tile, tile.pos);
    load_slab<TC, kThreads>(w_s, w, nz, nn, tile, tile.pos);
    load_slab<TC, kThreads>(x1, pm, nz, NN, tile, tile.pos_pad);
    load_slab<TC, kThreads>(ws_s, ws, 1, NN, tile, tile.pos_pad);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {  // a plausible column, and plausible scratch for lone phases
    for (int t = threadIdx.x; t < L + TC; t += kThreads) {
      if (t < L) {
        dm_s[t] = 100.f;
        pt_s[t] = 300.f;
        dz_s[t] = -100.f;
        w_s[t] = 1.f;
        x1[t] = -1.0e6f;
        x2[t] = 1.f;
        x3[t] = 1.0e3f + (float)(t / TC);
      } else {
        ws_s[t - L] = 0.f;
      }
    }
  }
  __syncthreads();

  const float t1g = 2.f * c.gamma * dt * dt;
  if (kPhases) {
    // (b) gas-law layer pressure perturbation (riemann.full_pressure - pm)
    for (int t = threadIdx.x; t < L; t += kThreads) {
      if (t % TC >= cols) continue;
      const float rr = -dm_s[t] * c.rdgas * pt_s[t] / dz_s[t];
      x1[t] = __fmul_rn(c.p00, powf(rr / c.p00, c.gamma)) - x1[t];  // - pm
    }
    __syncthreads();
    // ... and the rows of the pp sweep: g_rat and dd
    for (int t = threadIdx.x; t < L; t += kThreads) {
      if (t % TC >= cols) continue;
      if (t < L - TC) {
        const float g = dm_s[t] / dm_s[t + TC];
        x2[t] = g;
        x3[t] = 3.f * (x1[t] + __fmul_rn(g, x1[t + TC]));
      } else {
        x3[t] = 3.f * x1[t];
      }
    }
  }
  __syncthreads();
  // pem[k + 1] into x1[k] (pe' is dead), in flight during the pp sweep
  if (kMemory) {
    load_levels<TC, kThreads>(x1, pem, nz + 1, 1, nz, NN, tile,
                              tile.pos_pad);
    __pipeline_commit();
  }

  // (c) bidiagonal forward sweep for pp (interface perturbation) ---------
  if (kRecurrences && threadIdx.x < cols) {
    float bet = 1.f;
    float pp_k = 0.f;
    for (int k = 0, t = threadIdx.x; k < nz; ++k, t += TC) {
      const float bb = (k < nz - 1) ? 2.f * (1.f + x2[t]) : 2.f;
      const float gm = (k == 0) ? 0.f : x2[t - TC] / bet;
      bet = bb - gm;
      pp_k = (x3[t] - pp_k) / bet;
      x3[t] = pp_k;  // pp[k + 1]
    }
  }
  if (kMemory) __pipeline_wait_prior(0);
  __syncthreads();

  // (d) stiffnesses and right-hand sides of the Thomas solve -------------
  if (kPhases) {
    for (int t = threadIdx.x; t < L; t += kThreads) {
      const int k = t / TC, col = t % TC;
      if (col >= cols) continue;
      const float pp_hi = x3[t];
      const float pp_lo = (k == 0) ? 0.f : x3[t - TC];
      float a_dn,
          r = __fmul_rn(dm_s[t], w_s[t]) + __fmul_rn(dt, pp_hi - pp_lo);
      if (k < nz - 1) {
        a_dn = t1g / (dz_s[t] + dz_s[t + TC]) * (x1[t] + pp_hi);
      } else {
        const float p1 = t1g / dz_s[t] * (x1[t] + pp_hi);
        a_dn = p1;
        r = r - __fmul_rn(p1, ws_s[col]);
      }
      x1[t] = a_dn;
      x2[t] = r;
    }
  }
  __syncthreads();

  // (e) Thomas solve for w, (f) the ppe prefix sum -----------------------
  if (kRecurrences && threadIdx.x < cols) {
    float a_up = 0.f;  // stiffness at the interface above level k
    float wp = 0.f;
    float bet = 1.f;
    int t = threadIdx.x;
    for (int k = 0; k < nz; ++k, t += TC) {
      const float a_dn = x1[t];
      const float dmk = dm_s[t];
      float g;
      if (k == 0) {
        g = 0.f;
        bet = dmk - a_dn;
      } else {
        g = a_up / bet;
        bet = dmk - (a_up + a_dn + __fmul_rn(a_up, g));
      }
      wp = (x2[t] - __fmul_rn(a_up, wp)) / bet;
      x1[t] = g;
      x2[t] = wp;
      a_up = a_dn;
    }
    float w_next = wp;
    for (t -= 2 * TC; t >= 0; t -= TC) {
      w_next = x2[t] - __fmul_rn(x1[t + TC], w_next);
      x2[t] = w_next;
    }
    float acc = 0.f;
    for (t = threadIdx.x; t < L; t += TC) {
      acc = acc + dm_s[t] * (x2[t] - w_s[t]) / dt;
      x3[t] = acc;  // ppe[k + 1]
    }
  }
  __syncthreads();

  // (g) the new layer thickness; w2, dz2 and ppe, each written once ------
  constexpr bool kCopies = !kPhases && !kRecurrences;  // the copies alone
  for (int t = threadIdx.x; t < L + TC; t += kThreads) {
    const int k = t / TC, col = t % TC;
    if (col >= cols) continue;
    const int f = tile.face[col], p = tile.pos[col];
    const float prev = (k == 0) ? 0.f : (kCopies ? x1 : x3)[t - TC];
    put(ppe + column_at(f, nz + 1, k, nn, p), prev);
    if (k == nz) continue;
    const long long at = column_at(f, nz, k, nn, p);
    // pm once more from device memory: its slab went to pe'
    const float pmk =
        kMemory ? pm[column_at(f, nz, k, NN, tile.pos_pad[col])] : 5.0e4f;
    if (kCopies) {
      put(w2 + at, w_s[t]);
      put(dz2 + at, dz_s[t] + pmk);
      continue;
    }
    float out = dz_s[t];
    if (kPhases) {
      float p_lay = pmk + (prev + __fmul_rn(2.f, x3[t])) / 3.f;
      p_lay = fmaxf(p_lay, p_fac * pmk);
      out = -(dm_s[t] * c.rdgas * pt_s[t] / c.p00) *
            powf(p_lay / c.p00, c.dz_exp);
    }
    put(dz2 + at, out);
    put(w2 + at, x2[t]);
  }
}

}  // namespace

// dm, pt, dz, w, w2, dz2 [F, nz, n, n], ppe [F, nz+1, n, n]; pem
// [F, nz+1, N, N], pm [F, nz, N, N] and ws [F, N, N] with N = n + 2h, of
// which the solve reads the n x n interior (h = 0: the fields themselves);
// float32, contiguous.  Returns cudaGetLastError() after the launch (0 on
// success), -1 when a tile's slabs exceed a block's shared memory (nz >
// 258).
extern "C" int fv3_sim1(const float* dm, const float* pt, const float* dz,
                        const float* w, const float* pem, const float* pm,
                        const float* ws, float* w2, float* dz2, float* ppe,
                        int F, int nz, int n, int h, float dt, float p_fac,
                        float rdgas, float p00, float gamma, float dz_exp,
                        void* stream) {
  const size_t bytes = smem_bytes(nz);
  static SlabSmem smem;
  const int err = allow_slab_smem(sim1_kernel, bytes, &smem);
  if (err != 0) return err;
  const long long columns = (long long)F * n * n;
  if (columns == 0 || nz == 0) return 0;
  Consts c{rdgas, p00, gamma, dz_exp};
  sim1_kernel<<<(unsigned)((columns + TC - 1) / TC), kThreads, bytes,
                static_cast<cudaStream_t>(stream)>>>(
      dm, pt, dz, w, pem, pm, ws, w2, dz2, ppe, F, nz, n, h, dt, p_fac, c);
  return (int)cudaGetLastError();
}
