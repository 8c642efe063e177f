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
// Bound on the card: bytes.  Five separate K1 calls read the Courant
// numbers and flux widths five times, materialise area * delp twice and
// re-read the delp fluxes from memory; the per-cell arithmetic (~150
// flops per field and cell) is far below the H100's balance point.  What
// the Pallas kernel kept in VMEM this kernel saves as follows, in four
// launches of one thread per (face, level, j, i) cell:
//   1. inner half-updates of delp, delz and vorticity: crx/cry/xfx/yfx
//      are read once for all three, into a wrapper-allocated scratch;
//   2. outer fluxes of the same three (fxd, fyd, fxz, fyz, fxo, fyo);
//   3. inner half-updates of pt and w, whose mass fluxes are fxd/fyd from
//      step 2 -- including the +-1 neighbour in ra = a + (mf - roll(mf)),
//      so they cannot start before step 2 has finished (hence the launch
//      boundary) -- and whose air mass area * delp is formed in registers;
//   4. outer fluxes of pt and w.
// The per-cell arithmetic is K1's (tp2d_core.cuh) and the air mass is
// rounded as the plain version rounds it, so K6 reproduces five K1 calls.

#include "tp2d_core.cuh"

namespace {

struct Args {
  const float *dpx, *dpy, *ptx, *pty, *wx, *wy, *dzx, *dzy, *ox, *oy;
  const float *crx, *cry, *xfx, *yfx, *sfx, *sfy, *apx, *apy;
  float *fxd, *fyd, *fxt, *fyt, *fxw, *fyw, *fxz, *fyz, *fxo, *fyo;
  float* sx[3];  // scratch: x half-updates (q_x) of up to three fields
  float* sy[3];  // scratch: y half-updates (q_y)
  int F, nz, N;
};

// Cell coordinates of thread t: (j, i), the slab offset s0 = (f*nz+k)*N*N
// and the area index f*N*N + j*N + i.
struct Cell {
  long long t, s0, ai;
  int j, i;
};

__device__ __forceinline__ bool locate(const Args& a, Cell& c) {
  const long long N = a.N, NN = N * N;
  c.t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c.t >= (long long)a.F * a.nz * NN) return false;
  c.i = (int)(c.t % N);
  c.j = (int)((c.t / N) % N);
  const long long slab = c.t / NN;
  c.s0 = slab * NN;
  c.ai = (slab / a.nz) * NN + (long long)c.j * N + c.i;
  return true;
}

template <int HORD>
__global__ void inner3(Args a) {
  Cell c;
  if (!locate(a, c)) return;
  const long long s0 = c.s0;
  const int N = a.N;
  const float ay = a.apy[c.ai], ax = a.apx[c.ai];
  a.sy[0][c.t] = inner_y<HORD>(a.dpy + s0, a.cry + s0, a.yfx + s0, ay, c.j,
                               c.i, N);
  a.sx[0][c.t] = inner_x<HORD>(a.dpx + s0, a.crx + s0, a.xfx + s0, ax, c.j,
                               c.i, N);
  a.sy[1][c.t] = inner_y<HORD>(a.dzy + s0, a.cry + s0, a.yfx + s0, ay, c.j,
                               c.i, N);
  a.sx[1][c.t] = inner_x<HORD>(a.dzx + s0, a.crx + s0, a.xfx + s0, ax, c.j,
                               c.i, N);
  a.sy[2][c.t] = inner_y<HORD>(a.oy + s0, a.cry + s0, a.sfy + s0, ay, c.j,
                               c.i, N);
  a.sx[2][c.t] = inner_x<HORD>(a.ox + s0, a.crx + s0, a.sfx + s0, ax, c.j,
                               c.i, N);
}

template <int HORD>
__global__ void outer3(Args a) {
  Cell c;
  if (!locate(a, c)) return;
  const long long s0 = c.s0;
  const int N = a.N, j = c.j, i = c.i;
  a.fxd[c.t] = outer_x<HORD>(a.sy[0] + s0, a.crx + s0, a.xfx + s0, j, i, N);
  a.fyd[c.t] = outer_y<HORD>(a.sx[0] + s0, a.cry + s0, a.yfx + s0, j, i, N);
  a.fxz[c.t] = outer_x<HORD>(a.sy[1] + s0, a.crx + s0, a.xfx + s0, j, i, N);
  a.fyz[c.t] = outer_y<HORD>(a.sx[1] + s0, a.cry + s0, a.yfx + s0, j, i, N);
  a.fxo[c.t] = outer_x<HORD>(a.sy[2] + s0, a.crx + s0, a.sfx + s0, j, i, N);
  a.fyo[c.t] = outer_y<HORD>(a.sx[2] + s0, a.cry + s0, a.sfy + s0, j, i, N);
}

template <int HORD>
__global__ void inner2(Args a) {
  Cell c;
  if (!locate(a, c)) return;
  const long long s0 = c.s0;
  const int N = a.N;
  // the air mass, rounded on its own as the plain area * delp is
  const float my = __fmul_rn(a.apy[c.ai], a.dpy[c.t]);
  const float mx = __fmul_rn(a.apx[c.ai], a.dpx[c.t]);
  a.sy[0][c.t] = inner_y<HORD>(a.pty + s0, a.cry + s0, a.fyd + s0, my, c.j,
                               c.i, N);
  a.sx[0][c.t] = inner_x<HORD>(a.ptx + s0, a.crx + s0, a.fxd + s0, mx, c.j,
                               c.i, N);
  a.sy[1][c.t] = inner_y<HORD>(a.wy + s0, a.cry + s0, a.fyd + s0, my, c.j,
                               c.i, N);
  a.sx[1][c.t] = inner_x<HORD>(a.wx + s0, a.crx + s0, a.fxd + s0, mx, c.j,
                               c.i, N);
}

template <int HORD>
__global__ void outer2(Args a) {
  Cell c;
  if (!locate(a, c)) return;
  const long long s0 = c.s0;
  const int N = a.N, j = c.j, i = c.i;
  a.fxt[c.t] = outer_x<HORD>(a.sy[0] + s0, a.crx + s0, a.fxd + s0, j, i, N);
  a.fyt[c.t] = outer_y<HORD>(a.sx[0] + s0, a.cry + s0, a.fyd + s0, j, i, N);
  a.fxw[c.t] = outer_x<HORD>(a.sy[1] + s0, a.crx + s0, a.fxd + s0, j, i, N);
  a.fyw[c.t] = outer_y<HORD>(a.sx[1] + s0, a.cry + s0, a.fyd + s0, j, i, N);
}

template <int HORD>
void launch(const Args& a, cudaStream_t stream) {
  const long long total = (long long)a.F * a.nz * a.N * a.N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  inner3<HORD><<<blocks, threads, 0, stream>>>(a);
  outer3<HORD><<<blocks, threads, 0, stream>>>(a);
  inner2<HORD><<<blocks, threads, 0, stream>>>(a);
  outer2<HORD><<<blocks, threads, 0, stream>>>(a);
}

}  // namespace

// in: the 16 fields dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy, crx, cry,
// xfx, yfx, sfx, sfy and the 2 areas; out: the 10 fluxes fxd, fyd, fxt,
// fyt, fxw, fyw, fxz, fyz, fxo, fyo; scratch: 6 fields.  Returns
// cudaGetLastError() after the four launches (0 on success); -1 for an
// unsupported hord.
extern "C" int fv3_tp2d_multi5(const float* const* in, float* const* out,
                               float* const* scratch, int F, int nz, int N,
                               int hord, void* stream) {
  Args a{in[0],  in[1],  in[2],  in[3],  in[4],  in[5],  in[6],
         in[7],  in[8],  in[9],  in[10], in[11], in[12], in[13],
         in[14], in[15], in[16], in[17], out[0], out[1], out[2],
         out[3], out[4], out[5], out[6], out[7], out[8], out[9],
         {scratch[0], scratch[1], scratch[2]},
         {scratch[3], scratch[4], scratch[5]},
         F,      nz,     N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hord) {
    case 1: launch<1>(a, s); break;
    case 5: launch<5>(a, s); break;
    case 6: launch<6>(a, s); break;
    case 8: launch<8>(a, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
