// K1: Lin-Rood 2D flux-form transport (fv_tp_2d) for Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_tp.py::fv_tp_2d_pallas
// (body _tp2d_kernel) and computes what the plain
// fv3net_tpu_torch/ops/advection.py::fv_tp_2d computes: PPM edge values
// with the hord 1/5/6/8 limiters, upwind face averages, the inner
// transverse half-update and the outer x/y fluxes, on padded
// [F, nz, N, N] float32 fields with plain areas [F, 1, N, N] (level stride
// 0) or mass-weighted ones [F, nz, N, N].
//
// Bound on the card: bytes.  Per cell the operator does ~150 flops and
// must read 8 inputs (6 with plain areas, which are level-invariant) and
// write 2 outputs, far below the H100's ~20 flop/B balance point, so its
// floor is one pass over memory.  The Pallas kernel kept a whole (face,
// z-block) slab in VMEM.  Here, in ONE launch with no scratch in device
// memory, each block owns a TY x TX tile of one face and a run of `lv`
// levels (blockIdx: tile column, tile row, face * runs + run):
//   * per level it copies each input once into shared memory with the
//     stencil halo of tp2d_core.cuh (the inner input 3 cells up and 3
//     down the transported direction, the half-updates 3 up and 2 down,
//     the Courant numbers and mass fluxes at the tile's faces plus the
//     halo's), through the loaders of tile.cuh: 8-byte cp.async pairs
//     where N is even (N = 54 and 198; rows of an even column start are
//     8-byte aligned), 4-byte copies otherwise; indices wrap (wrap_near)
//     only for a tile at the lattice edge, so every face of the padded
//     N x N slab gets what the roll() of the plain version gives;
//   * the copies go into a two-stage ring: level k+1's are in flight
//     while level k computes, and plain-area tiles are copied for the
//     first two levels of the run only;
//   * each inner face flux of the tile and its halo is computed once, the
//     half-updates from them (written in place over the input tile, whose
//     other cells no longer need it), and the outer fluxes from the
//     half-updates, all in shared memory.
// The tile is K6's, 18 x 33: it fits the C192 width, 198, exactly (11 x
// 6 tiles) and the C48 width, 54, in rows (3 x 2 tiles); it copies 8.5
// elements per output cell a level for the 6 inputs with plain areas (11.0
// with mass-weighted ones).  Two stages of 25.6 KB and the face fluxes
// make 57 KB of dynamic shared memory, three blocks of 256 threads an SM.
// Larger tiles copy less halo (33 x 33: 7.8 elements) but fit two blocks
// of 384 threads an SM, and measured slower at both widths
// (kernel_variants.py): the halo copies are not what limits.  What holds
// it back: the copies alone and the shared-memory phases alone (hord 1
// nearly as long as hord 5) each take over half of its time, and the ring
// overlaps them only in part.  The per-cell arithmetic is tp2d_core.cuh's,
// unchanged (each flux product rounded on its own), so the results are
// those of the one-thread-a-cell K1 it replaces, and K6 still equals five
// K1 calls.

#include <cuda_pipeline.h>

#include <initializer_list>

#include "tile.cuh"
#include "tp2d_core.cuh"

namespace {

constexpr int TX = 33;  // tile width (x, the fast axis)
constexpr int TY = 18;  // tile height (y)
constexpr int kThreads = 256;

// Regions (rows x columns) around the tile origin (j0, i0), from the
// stencil reach in tp2d_core.cuh, as in tp2d_multi5.cu.
constexpr int QY_H = TY, QY_W = TX + 5;    // q_y, ay: rows j0.., cols i0-3..
constexpr int IY_H = TY + 6, IY_W = QY_W;  // qy:  rows j0-3..
constexpr int CY_H = TY + 1, CY_W = QY_W;  // cry, yfx: rows j0..
constexpr int QX_H = TY + 5, QX_W = TX;    // q_x, ax: rows j0-3.., cols i0..
constexpr int IX_H = QX_H, IX_W = TX + 6;  // qx:  cols i0-3..
constexpr int CX_H = QX_H, CX_W = TX + 1;  // crx, xfx: cols i0..

// Row strides in shared memory (tile.cuh's pair layout).
constexpr int IX_S = pair_stride(IX_W), IY_S = pair_stride(IY_W);
constexpr int CX_S = pair_stride(CX_W), CY_S = pair_stride(CY_W);
constexpr int AX_S = pair_stride(QX_W), AY_S = pair_stride(QY_W);

// Layout of the dynamic shared memory, in floats, each buffer 16-byte
// aligned: two ring stages of the inputs, then the inner face fluxes.
constexpr int align4(int x) { return (x + 3) & ~3; }
constexpr int O_IX = 0;
constexpr int O_IY = O_IX + align4(IX_H * IX_S);
constexpr int O_CX = O_IY + align4(IY_H * IY_S);
constexpr int O_MX = O_CX + align4(CX_H * CX_S);
constexpr int O_CY = O_MX + align4(CX_H * CX_S);
constexpr int O_MY = O_CY + align4(CY_H * CY_S);
constexpr int O_AX = O_MY + align4(CY_H * CY_S);
constexpr int O_AY = O_AX + align4(QX_H * AX_S);
constexpr int STAGE = O_AY + align4(QY_H * AY_S);
constexpr int O_FX = 2 * STAGE;
constexpr int O_FY = O_FX + align4(CX_H * CX_W);
constexpr int SMEM_FLOATS = O_FY + align4(CY_H * CY_W);
constexpr int kSmemBytes = SMEM_FLOATS * (int)sizeof(float);

struct Args {
  const float *qx, *qy, *crx, *cry, *xfx, *yfx, *apx, *apy;
  float *fx, *fy;
  int a_fstride, a_kstride, nz, N, lv, runs;
  bool pairs;
};

// Start copying level k of face f's inputs into ring stage `st` (the
// areas only if `areas`).
__device__ __forceinline__ void issue(float* st, const Args& a, int f, int k,
                                      int j0, int i0, bool areas) {
  const int N = a.N, off = (f * a.nz + k) * N * N;
  load_tile_pairs<IX_H, IX_W, kThreads>(st + O_IX, a.qx + off, j0 - 3,
                                        i0 - 3, N, a.pairs);
  load_tile_pairs<IY_H, IY_W, kThreads>(st + O_IY, a.qy + off, j0 - 3,
                                        i0 - 3, N, a.pairs);
  load_tile_pairs<CX_H, CX_W, kThreads>(st + O_CX, a.crx + off, j0 - 3, i0,
                                        N, a.pairs);
  load_tile_pairs<CX_H, CX_W, kThreads>(st + O_MX, a.xfx + off, j0 - 3, i0,
                                        N, a.pairs);
  load_tile_pairs<CY_H, CY_W, kThreads>(st + O_CY, a.cry + off, j0, i0 - 3,
                                        N, a.pairs);
  load_tile_pairs<CY_H, CY_W, kThreads>(st + O_MY, a.yfx + off, j0, i0 - 3,
                                        N, a.pairs);
  if (areas) {
    const int aoff = f * a.a_fstride + k * a.a_kstride;
    load_tile_pairs<QX_H, QX_W, kThreads>(st + O_AX, a.apx + aoff, j0 - 3,
                                          i0, N, a.pairs);
    load_tile_pairs<QY_H, QY_W, kThreads>(st + O_AY, a.apy + aoff, j0,
                                          i0 - 3, N, a.pairs);
  }
  __pipeline_commit();
}

template <int HORD>
__global__ void __launch_bounds__(kThreads, 3) tp2d(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int f = blockIdx.z / a.runs;
  const int k0 = (blockIdx.z - f * a.runs) * a.lv;
  const int k1 = min(k0 + a.lv, a.nz);
  if (k0 >= k1) return;
  // where column 0 of a region starting at i0 - 3 (oa) or i0 (ob) lies
  const int oa = pair_off(i0 - 3, a.pairs), ob = pair_off(i0, a.pairs);
  float* fx2 = smem + O_FX;  // inner x face fluxes, CX_H x CX_W
  float* fy2 = smem + O_FY;  // inner y face fluxes, CY_H x CY_W
  issue(smem, a, f, k0, j0, i0, true);
  for (int k = k0; k < k1; ++k) {
    const int s = (k - k0) & 1;
    float* st = smem + s * STAGE;
    __pipeline_wait_prior(0);
    __syncthreads();  // level k is in; level k-1 is done with the other
                      // stage and the face fluxes
    if (k + 1 < k1)
      issue(smem + (s ^ 1) * STAGE, a, f, k + 1, j0, i0,
            a.a_kstride != 0 || k + 1 - k0 < 2);
    float* ix = st + O_IX + oa;  // qx, then q_x in its columns 3 ..
    float* iy = st + O_IY + oa;  // qy, then q_y in its rows 3 ..
    const float* cx = st + O_CX + ob;
    const float* mx = st + O_MX + ob;
    const float* ax = st + O_AX + ob;
    const float* cy = st + O_CY + oa;
    const float* my = st + O_MY + oa;
    const float* ay = st + O_AY + oa;
    // the inner face fluxes, each face once: y face (j0 + r, i0 - 3 + c)
    // is qy row r + 3; x face (j0 - 3 + r, i0 + c) is qx column c + 3
    for (int t = threadIdx.x; t < CY_H * CY_W; t += kThreads) {
      const int r = t / CY_W, c = t % CY_W;
      fy2[t] = face_flux<HORD>(SLine{iy + c, IY_S}, r + 3, cy[r * CY_S + c],
                               my[r * CY_S + c]);
    }
    for (int t = threadIdx.x; t < CX_H * CX_W; t += kThreads) {
      const int r = t / CX_W, c = t % CX_W;
      fx2[t] = face_flux<HORD>(SLine{ix + r * IX_S, 1}, c + 3,
                               cx[r * CX_S + c], mx[r * CX_S + c]);
    }
    __syncthreads();
    // the half-updates from the fluxes on either side, each written over
    // its own input cell (the only reader of that cell from here on)
    for (int t = threadIdx.x; t < QY_H * QY_W; t += kThreads) {
      const int r = t / QY_W, c = t % QY_W;
      const int e = r * CY_W + c;
      float* q = iy + (r + 3) * IY_S + c;
      *q = inner_update(*q, ay[r * AY_S + c], fy2[e], fy2[e + CY_W],
                        my[r * CY_S + c], my[(r + 1) * CY_S + c]);
    }
    for (int t = threadIdx.x; t < QX_H * QX_W; t += kThreads) {
      const int r = t / QX_W, c = t % QX_W;
      const int e = r * CX_W + c;
      float* q = ix + r * IX_S + c + 3;
      *q = inner_update(*q, ax[r * AX_S + c], fx2[e], fx2[e + 1],
                        mx[r * CX_S + c], mx[r * CX_S + c + 1]);
    }
    __syncthreads();
    // the outer fluxes of the tile's faces: x from q_y of row r (iy row
    // r + 3), y from q_x of column c (ix column c + 3); the cells of a
    // ragged last tile beyond N are not stored
    const int off = (f * a.nz + k) * N * N;
    float* fx = a.fx + off;
    float* fy = a.fy + off;
    for (int t = threadIdx.x; t < TY * TX; t += kThreads) {
      const int r = t / TX, c = t % TX;
      const int j = j0 + r, i = i0 + c;
      if (j >= N || i >= N) continue;
      const int ex = (r + 3) * CX_S + c, ey = r * CY_S + c + 3;
      fx[j * N + i] = face_flux<HORD>(SLine{iy + (r + 3) * IY_S, 1}, c + 3,
                                      cx[ex], mx[ex]);
      fy[j * N + i] = face_flux<HORD>(SLine{ix + c + 3, IX_S}, r + 3, cy[ey],
                                      my[ey]);
    }
  }
}

template <int HORD>
int launch(const Args& a, int F, cudaStream_t stream) {
  // the dynamic shared memory above 48 KB, allowed once per device
  static unsigned long long ready = 0;  // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(
        tp2d<HORD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          tp2d<HORD>, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready |= 1ull << dev;
  }
  const dim3 grid((a.N + TX - 1) / TX, (a.N + TY - 1) / TY, F * a.runs);
  tp2d<HORD><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned8(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 7) == 0;
}

}  // namespace

// qx, qy, crx, cry, xfx, yfx [F, nz, N, N]; apx, apy with face stride
// a_fstride and level stride a_kstride (0 for plain areas); fx, fy
// [F, nz, N, N]; float32, contiguous, F * nz * N * N < 2^31.  Each block
// transports `lv` levels.  Returns cudaGetLastError() after the launch (0
// on success); -1 for an unsupported hord, lv < 1 or more than 65535
// (face, run) pairs.
extern "C" int fv3_tp2d(const float* qx, const float* qy, const float* crx,
                        const float* cry, const float* xfx, const float* yfx,
                        const float* apx, const float* apy, int a_fstride,
                        int a_kstride, float* fx, float* fy, int F, int nz,
                        int N, int hord, int lv, void* stream) {
  if (lv < 1) return -1;
  const int runs = (nz + lv - 1) / lv;
  if ((long long)F * runs > 65535) return -1;
  bool pairs = N % 2 == 0;
  for (const float* p : {qx, qy, crx, cry, xfx, yfx, apx, apy})
    pairs = pairs && aligned8(p);
  Args a{qx, qy, crx, cry, xfx, yfx, apx, apy, fx, fy,
         a_fstride, a_kstride, nz, N, lv, runs, pairs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hord) {
    case 1: return launch<1>(a, F, s);
    case 5: return launch<5>(a, F, s);
    case 6: return launch<6>(a, F, s);
    case 8: return launch<8>(a, F, s);
    default: return -1;
  }
}
