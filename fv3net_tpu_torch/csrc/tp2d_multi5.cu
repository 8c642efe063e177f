// K6: the D stage's five Lin-Rood transports fused (fv_tp_2d_multi5) for
// Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_tp.py::fv_tp_2d_multi5
// (body _tp2d_multi_kernel) and computes what the plain
// fv3net_tpu_torch/ops/advection.py::fv_tp_2d_multi5_plain computes: the
// fv_tp_2d fluxes of delp and delz with (xfx, yfx, area), of pt and w with
// the delp fluxes (fxd, fyd) and the air mass area * delp, and of the
// vorticity with (sfx, sfy, area), on padded [F, nz, N, N] float32 fields
// and [F, N, N] areas.
//
// Bound on the card: bytes.  The call must read 16 fields and write 10
// (1.54 GB at C192, 0.46 ms at 3.35 TB/s); its ~150 flops per field and
// cell are far below the H100's balance point.  The Pallas kernel kept a
// (face, z-block) slab in VMEM; a design with one thread per cell that
// reads its stencil from device memory (taking every neighbour index
// modulo N) and passes the half-updates between launches through scratch
// fields moves ~3.7 GB a call.  Here each block owns one TY x TX tile of
// one (face, level) slab (blockIdx: tile column, tile row, slab, so no
// thread divides 64-bit indices; 18 x 33 tiles fit the C192 width, 198,
// exactly):
//   * it copies the tiles it needs into shared memory with asynchronous
//     copies (cp.async), every copy of a phase in flight at once, with
//     the stencil halo of tp2d_core.cuh: the inner input 3 cells up and 3
//     down the transported direction, the half-updates 3 up and 2 down,
//     the Courant numbers and fluxes at the tile's faces plus the halo's;
//   * the indices are taken modulo N only when a tile at the lattice edge
//     loads (once per element), so every face of the padded N x N slab
//     gets the value five K1 calls give, not only the consumed [2, N-2);
//   * the inner face fluxes of the tile and its halo are computed once
//     each, the half-updates from them, and the outer fluxes from the
//     half-updates, all in shared memory: no scratch in device memory;
//   * two launches.  A: delp, delz and the vorticity, which share crx/cry
//     (delp and delz also xfx/yfx), each loaded once per tile.  B: pt and
//     w, whose mass fluxes are A's delp fluxes -- including the +1
//     neighbour in ra = a + (mf - roll(mf)), so they wait for A -- and
//     whose air mass area * delp is rounded on its own (__fmul_rn) as the
//     plain version rounds it.  Traffic: ~32 field passes, 1.9 GB at C192.
// Within a launch the fields take turns through the same tiles; the next
// field's copies overlap the current field's outer fluxes.  What holds it
// back now is not the stencil arithmetic (hord 1, which has none, takes
// nearly as long as hord 5) but the tile copies (35 elements per output
// cell against 24 inputs, the rest halo) and the barrier-separated
// phases between them.  The per-cell
// arithmetic is K1's (tp2d_core.cuh), so K6 reproduces five K1 calls.

#include <cuda_pipeline.h>

#include "tp2d_core.cuh"

namespace {

constexpr int TX = 33;  // tile width (x, the fast axis)
constexpr int TY = 18;  // tile height (y)
constexpr int kThreads = 256;

// Regions (rows x columns) around the tile origin (j0, i0), from the
// stencil reach in tp2d_core.cuh.  The outer x flux of face (j, i) reads
// the y half-updates q_y of row j, cells i-3 .. i+2; q_y of a cell reads
// the y-filled field 3 rows up and 3 down and the y faces j, j+1.  The
// outer y flux reads q_x of column i, cells j-3 .. j+2, and so on.
constexpr int QY_H = TY, QY_W = TX + 5;    // q_y: rows j0.., cols i0-3..
constexpr int IY_H = TY + 6, IY_W = QY_W;  // qy:  rows j0-3..
constexpr int CY_H = TY + 1, CY_W = QY_W;  // cry, y fluxes: rows j0..
constexpr int QX_H = TY + 5, QX_W = TX;    // q_x: rows j0-3.., cols i0..
constexpr int IX_H = QX_H, IX_W = TX + 6;  // qx:  cols i0-3..
constexpr int CX_H = QX_H, CX_W = TX + 1;  // crx, x fluxes: cols i0..

// The shared-memory tiles of one block; NM pairs of mass fluxes.
template <int NM>
struct Tile {
  float cx[CX_H * CX_W], cy[CY_H * CY_W];        // Courant numbers
  float mx[NM][CX_H * CX_W], my[NM][CY_H * CY_W];  // mass fluxes
  float ax[QX_H * QX_W], ay[QY_H * QY_W];        // areas (or air mass)
  float ix[IX_H * IX_W], iy[IY_H * IY_W];        // x- and y-filled field
  float fx[CX_H * CX_W], fy[CY_H * CY_W];        // their face fluxes
  float qx[QX_H * QX_W], qy[QY_H * QY_W];        // the half-updates
};

struct Args {
  const float *dpx, *dpy, *ptx, *pty, *wx, *wy, *dzx, *dzy, *ox, *oy;
  const float *crx, *cry, *xfx, *yfx, *sfx, *sfy, *apx, *apy;
  float *fxd, *fyd, *fxt, *fyt, *fxw, *fyw, *fxz, *fyz, *fxo, *fyo;
  int nz, N;
};

// Start copying src[(r0 + r) mod N][(c0 + c) mod N] into dst[r][c] for
// an H x W region of one N x N slab: asynchronous copies (cp.async), so
// every load of a phase is in flight at once; the thread that started an
// element's copy waits for it (__pipeline_wait_prior) before a barrier.
template <int H, int W>
__device__ __forceinline__ void load(float* dst, const float* src, int r0,
                                     int c0, int N) {
  const bool inside = r0 >= 0 && c0 >= 0 && r0 + H <= N && c0 + W <= N;
  for (int t = threadIdx.x; t < H * W; t += kThreads) {
    int r = r0 + t / W, c = c0 + t % W;
    if (!inside) {
      r = wrap_near(r, N);
      c = wrap_near(c, N);
    }
    __pipeline_memcpy_async(dst + t, src + r * N + c, sizeof(float));
  }
}

// The field's x- and y-filled tiles.
__device__ __forceinline__ void load_field(float* ix, float* iy,
                                           const float* qx, const float* qy,
                                           int j0, int i0, int N) {
  load<IX_H, IX_W>(ix, qx, j0 - 3, i0 - 3, N);
  load<IY_H, IY_W>(iy, qy, j0 - 3, i0 - 3, N);
  __pipeline_commit();
}

// Courant numbers (or mass fluxes) at the faces the tile reads.
__device__ __forceinline__ void load_faces(float* cx, float* cy,
                                           const float* x, const float* y,
                                           int j0, int i0, int N) {
  load<CX_H, CX_W>(cx, x, j0 - 3, i0, N);
  load<CY_H, CY_W>(cy, y, j0, i0 - 3, N);
}

// The areas at the cells whose half-updates the tile computes.
__device__ __forceinline__ void load_areas(float* ax, float* ay,
                                           const float* x, const float* y,
                                           int j0, int i0, int N) {
  load<QX_H, QX_W>(ax, x, j0 - 3, i0, N);
  load<QY_H, QY_W>(ay, y, j0, i0 - 3, N);
}

// The face fluxes of the inner half-updates, each face once, with mass
// fluxes pair m: face (j, i) of the y-filled field for the y faces of the
// tile and its halo, likewise along x.
template <int HORD, int NM>
__device__ __forceinline__ void inner_faces(Tile<NM>& s, int m) {
  const float* mx = s.mx[m];
  const float* my = s.my[m];
  for (int t = threadIdx.x; t < CY_H * CY_W; t += kThreads) {
    const int r = t / CY_W, c = t % CY_W;  // iy row r + 3
    s.fy[t] = face_flux<HORD>(SLine{s.iy + c, IY_W}, r + 3, s.cy[t], my[t]);
  }
  for (int t = threadIdx.x; t < CX_H * CX_W; t += kThreads) {
    const int r = t / CX_W, c = t % CX_W;  // ix column c + 3
    s.fx[t] =
        face_flux<HORD>(SLine{s.ix + r * IX_W, 1}, c + 3, s.cx[t], mx[t]);
  }
}

// The inner half-updates q_x, q_y of the tile and its halo from the face
// fluxes on either side.
template <int NM>
__device__ __forceinline__ void inner_cells(Tile<NM>& s, int m) {
  const float* mx = s.mx[m];
  const float* my = s.my[m];
  for (int t = threadIdx.x; t < QY_H * QY_W; t += kThreads) {
    const int r = t / QY_W, c = t % QY_W;  // iy row r + 3, faces r, r + 1
    const int k0 = r * CY_W + c, k1 = k0 + CY_W;
    s.qy[t] = inner_update(s.iy[(r + 3) * IY_W + c], s.ay[t], s.fy[k0],
                           s.fy[k1], my[k0], my[k1]);
  }
  for (int t = threadIdx.x; t < QX_H * QX_W; t += kThreads) {
    const int r = t / QX_W, c = t % QX_W;  // ix column c + 3, faces c, c + 1
    const int k0 = r * CX_W + c, k1 = k0 + 1;
    s.qx[t] = inner_update(s.ix[r * IX_W + c + 3], s.ax[t], s.fx[k0],
                           s.fx[k1], mx[k0], mx[k1]);
  }
}

// The outer fluxes of the tile's faces into the slabs fx, fy (the cells
// of a ragged last tile beyond N are not stored).
template <int HORD, int NM>
__device__ __forceinline__ void outer(const Tile<NM>& s, int m, float* fx,
                                      float* fy, int j0, int i0, int N) {
  for (int t = threadIdx.x; t < TY * TX; t += kThreads) {
    const int r = t / TX, c = t % TX;
    const int j = j0 + r, i = i0 + c;
    if (j >= N || i >= N) continue;
    const int kx = (r + 3) * CX_W + c;  // q_y column c + 3
    const int ky = r * CY_W + c + 3;    // q_x row r + 3
    fx[j * N + i] = face_flux<HORD>(SLine{s.qy + r * QY_W, 1}, c + 3,
                                    s.cx[kx], s.mx[m][kx]);
    fy[j * N + i] = face_flux<HORD>(SLine{s.qx + c, QX_W}, r + 3, s.cy[ky],
                                    s.my[m][ky]);
  }
}

// Launch A: delp and delz with (xfx, yfx), the vorticity with (sfx, sfy).
template <int HORD>
__global__ void __launch_bounds__(kThreads) transport3(Args a) {
  __shared__ Tile<2> s;
  const int N = a.N, i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const long long off = (long long)blockIdx.z * N * N;
  const long long aoff = (long long)(blockIdx.z / a.nz) * N * N;
  load_faces(s.cx, s.cy, a.crx + off, a.cry + off, j0, i0, N);
  load_faces(s.mx[0], s.my[0], a.xfx + off, a.yfx + off, j0, i0, N);
  load_faces(s.mx[1], s.my[1], a.sfx + off, a.sfy + off, j0, i0, N);
  load_areas(s.ax, s.ay, a.apx + aoff, a.apy + aoff, j0, i0, N);
  const float* qx[3] = {a.dpx + off, a.dzx + off, a.ox + off};
  const float* qy[3] = {a.dpy + off, a.dzy + off, a.oy + off};
  float* fx[3] = {a.fxd + off, a.fxz + off, a.fxo + off};
  float* fy[3] = {a.fyd + off, a.fyz + off, a.fyo + off};
  load_field(s.ix, s.iy, qx[0], qy[0], j0, i0, N);
  __pipeline_wait_prior(0);
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const int m = f == 2 ? 1 : 0;
    __syncthreads();  // the field's tiles are in (and q_x/q_y free)
    inner_faces<HORD>(s, m);
    __syncthreads();  // the face fluxes are in
    inner_cells(s, m);
    __syncthreads();  // q_x/q_y are in (and ix/iy free)
    if (f < 2) load_field(s.ix, s.iy, qx[f + 1], qy[f + 1], j0, i0, N);
    outer<HORD>(s, m, fx[f], fy[f], j0, i0, N);
    __pipeline_wait_prior(0);
  }
}

// Launch B: pt and w with A's delp fluxes and the air mass area * delp.
template <int HORD>
__global__ void __launch_bounds__(kThreads) transport2(Args a) {
  __shared__ Tile<1> s;
  const int N = a.N, i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const long long off = (long long)blockIdx.z * N * N;
  const long long aoff = (long long)(blockIdx.z / a.nz) * N * N;
  load_faces(s.cx, s.cy, a.crx + off, a.cry + off, j0, i0, N);
  load_faces(s.mx[0], s.my[0], a.fxd + off, a.fyd + off, j0, i0, N);
  load_areas(s.ax, s.ay, a.apx + aoff, a.apy + aoff, j0, i0, N);
  load_areas(s.qx, s.qy, a.dpx + off, a.dpy + off, j0, i0, N);  // delp
  const float* qx[2] = {a.ptx + off, a.wx + off};
  const float* qy[2] = {a.pty + off, a.wy + off};
  float* fx[2] = {a.fxt + off, a.fxw + off};
  float* fy[2] = {a.fyt + off, a.fyw + off};
  load_field(s.ix, s.iy, qx[0], qy[0], j0, i0, N);
  __pipeline_wait_prior(0);
  // the air mass area * delp, rounded on its own, each element by the
  // thread that copied both factors
  for (int t = threadIdx.x; t < QX_H * QX_W; t += kThreads)
    s.ax[t] = __fmul_rn(s.ax[t], s.qx[t]);
  for (int t = threadIdx.x; t < QY_H * QY_W; t += kThreads)
    s.ay[t] = __fmul_rn(s.ay[t], s.qy[t]);
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    __syncthreads();
    inner_faces<HORD>(s, 0);
    __syncthreads();
    inner_cells(s, 0);
    __syncthreads();
    if (f < 1) load_field(s.ix, s.iy, qx[f + 1], qy[f + 1], j0, i0, N);
    outer<HORD>(s, 0, fx[f], fy[f], j0, i0, N);
    __pipeline_wait_prior(0);
  }
}

template <int HORD>
int launch(const Args& a, int slabs, cudaStream_t stream) {
  const dim3 grid((a.N + TX - 1) / TX, (a.N + TY - 1) / TY, slabs);
  transport3<HORD><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  transport2<HORD><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// in: the 16 fields dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy, crx, cry,
// xfx, yfx, sfx, sfy and the 2 areas; out: the 10 fluxes fxd, fyd, fxt,
// fyt, fxw, fyw, fxz, fyz, fxo, fyo.  Returns the CUDA error of the two
// launches (0 on success); -1 for an unsupported hord or more than 65535
// slabs.
extern "C" int fv3_tp2d_multi5(const float* const* in, float* const* out,
                               int F, int nz, int N, int hord,
                               void* stream) {
  const int slabs = F * nz;
  if (slabs < 1 || slabs > 65535) return -1;
  Args a{in[0],  in[1],  in[2],  in[3],  in[4],  in[5],  in[6],
         in[7],  in[8],  in[9],  in[10], in[11], in[12], in[13],
         in[14], in[15], in[16], in[17], out[0], out[1], out[2],
         out[3], out[4], out[5], out[6], out[7], out[8], out[9],
         nz,     N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hord) {
    case 1: return launch<1>(a, slabs, s);
    case 5: return launch<5>(a, slabs, s);
    case 6: return launch<6>(a, slabs, s);
    case 8: return launch<8>(a, slabs, s);
    default: return -1;
  }
}
