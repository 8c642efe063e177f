// The C-grid half-stage of the dycore substep (FV3's c_sw) for Hopper.
//
// Computes what the plain torch chain of fv3net_tpu_torch/dycore/hydro.py::
// _c_sw_half_3d computes from the substep's shared exchanges (the D winds
// up [6, nz, N+1, N], vp [6, nz, N, N+1]; delp and pt with x- and y-fill
// corners [6, nz, N, N]; N = n + 2h): the time-centred advective C winds
// (uc fill x, vc fill y) on the padded lattices, after one C-grid half
// step of length dt2.  Three launches on the caller's stream:
//
//   1. csw_cwinds: the contravariant C winds on this face's own C faces
//      (sw.py::c_grid_winds: the 4-point covariant average and the cosa /
//      rsin2 conversion inside a face, the chart-free patches of the
//      xbw_* / ybw_* weights on its four edges), written straight into
//      the four padded lattices the chain's canonicalisation and two
//      C-grid exchanges give (uc and vc in fills x and y).  No exchanged
//      copy is gathered: slot (f, J, I) of each lattice reads the table
//      grid/halo.py::cgrid_canon_gather_flat, which names the own C face
//      (kind, face g, padded J', I') whose wind lands there and the
//      coefficient (+-1, or 0 for a slot no chart reaches) it lands with,
//      and computes that wind.
//   2. csw_half_columns: one column slab (column_slab.cuh) of TC columns a
//      block over the padded box [h-1, h+n]^2 that step 3 reads.  Level
//      by level in parallel: the upwind (hord 1) fluxes of delp and pt
//      through the four faces of the cell, delpc, ptc and the cell KE.
//      One thread a column: the interface pressures pe from ptop (the
//      plain order of the prefix sum).  In parallel: the layer-mean Exner
//      pi = (pik+ pe+ - pik- pe-) / ((1 + kappa) delpc) with pik = (pe /
//      p00)^kappa (K4's arithmetic, csrc/column.cu), then dphi = cp ptc
//      (pik+ - pik-) with pik = (max(pe, 1e-30) (1/p00))^kappa (the
//      chain's: torch multiplies by the rounded reciprocal of a number it
//      divides by); accurate powf, two an interface.
//      One thread a column, up from the surface: the interface
//      geopotential phis + the sum of dphi below.  In parallel: kphi = KE
//      + the layer's mean geopotential.  ptc, pi and kphi go to device
//      memory (three fields of the padded lattice, the box alone written).
//   3. csw_wind_update: uc + duc and vc + dvc (absolute vorticity of the D
//      winds times the tangential C wind, less the gradients of kphi and
//      of pi times the face-mean ptc), on the two padded lattices the
//      chain's second canonicalisation and exchanges give (uc fill x, vc
//      fill y), through the same tables: slot (f, J, I) computes the
//      update of the own face the table names.
//
// It replaces no TPU kernel: the JAX package leaves c_sw to XLA's fusion,
// and the port's chain of ~350 torch calls a substep took ~1.6 ms of the
// card's time a C48 substep, ~65 times what it must move.  Bound on the
// card: bytes (the six exchanged fields read once and the two results
// written once, ~36 MB a C48 x 63 call; the operations, ~124 a cell and
// level, take a fifth of that time).  The design keeps what crosses faces
// out of device memory (no canonicalised or exchanged copy is gathered:
// the tables name where each slot's wind comes from) and stages only the
// four first-stage lattices and the three column fields, each written
// once and read from L2 by the next launch.
//
// The arithmetic is the chain's, operation by operation and in its order
// of summation (the sums over a column in the plain sequential order; pik
// once as K4 computes it for pi, once as torch does for dphi: pe times
// the rounded 1/p00).  A product that meets a sum is rounded on its own
// (mul, __fmul_rn), so nvcc contracts nothing into an FMA: with FMAs the
// C48 winds read 2.0-2.2e-5 of their magnitude from the chain's (one
// rounding less in the winds or the fluxes moves the prefix sum pe by an
// ulp now and then, and the geopotential, built from differences of pik
// across thin layers, carries it to the wind update); without, they equal
// the chain's bit for bit on the H100 (torch 2.11, CUDA 12.8).
// Reach: the box's stencils read rows and columns h-2 .. h+n+1 of the
// padded lattice, inside [0, N) for h >= 2 (the wrapper refuses h < 2);
// the chain's roll()s wrap only at its edges, whose values nothing here
// consumes.  Slots of the box's corners (outside the cells step 3 reads)
// may hold garbage or NaN, as the chain's padded delpc does; they never
// trap and are never consumed.

#include <cuda_runtime.h>

#include "column_slab.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block, every kernel
constexpr int TC = 32;         // columns a slab of csw_half_columns
constexpr int kLevels = 8;     // levels a thread of csw_cwinds runs

struct Args {
  // the substep's exchanges
  const float *up, *vp, *dpx, *dpy, *ptx, *pty;
  // metrics [6, N, N], except xbw_w, xbw_e, ybw_s, ybw_n [6, n, 4], dx_u
  // [6, N+1, N] and dy_v [6, N, N+1]
  const float *cosa_u, *rsin2_u, *cosa_v, *rsin2_v;
  const float *xbw_w, *xbw_e, *ybw_s, *ybw_n;
  const float *dy_fs, *dx_fs, *area_px;
  const float *dx_u, *dy_v, *f_px, *dxc_f, *dyc_f;
  // the C-grid tables [4, 6, N, N] (uc fill x, vc fill y, vc fill x, uc
  // fill y); phis [6, n, n] through its x-fill table [6, N, N], or null
  const int* src;
  const float* coef;
  const int* phis_tab;
  const float* phis;
  // the first stage's four lattices, the columns' three fields, and the
  // two results, each [6, nz, N, N]
  float *ucx, *vcy, *vcx, *ucy;
  float *kphi, *pi_lay, *ptc;
  float *uc_out, *vc_out;
  int nz, n, h, N;
  float dt2, ptop, p00, kappa, cp;
};

// A product rounded on its own: never contracted into an FMA with a sum.
__device__ __forceinline__ float mul(float x, float y) {
  return __fmul_rn(x, y);
}

__device__ __forceinline__ size_t lattice(const Args& a, int f, int k) {
  return ((size_t)f * a.nz + k) * a.N * a.N;
}

// A table's own face: kind 0 an x-face (uc), 1 a y-face (vc).
struct Own {
  int kind, g, J, I;
};

__device__ __forceinline__ Own decode(int code, int N) {
  const int NN = N * N, p = code % NN, kg = code / NN;
  return {kg / 6, kg % 6, p / N, p % N};
}

// The level-independent part of an own C face's wind (c_grid_winds): the
// face, whether it lies on the face's edge, and its metric (cosa and
// rsin2 inside the face, the four chart-free weights on its edge).
struct Face {
  Own s;
  bool edge;
  float w[4];
};

__device__ Face face_of(const Args& a, int code) {
  const int h = a.h, n = a.n, N = a.N;
  Face F{decode(code, N), false, {0.f, 0.f, 0.f, 0.f}};
  const Own& s = F.s;
  F.edge = s.kind == 0 ? (s.I == h || s.I == h + n)
                       : (s.J == h || s.J == h + n);
  if (F.edge) {
    const float* w =
        s.kind == 0 ? (s.I == h ? a.xbw_w : a.xbw_e) + (s.g * n + s.J - h) * 4
                    : (s.J == h ? a.ybw_s : a.ybw_n) + (s.g * n + s.I - h) * 4;
    for (int q = 0; q < 4; ++q) F.w[q] = w[q];
  } else {
    const int m = (s.g * N + s.J) * N + s.I;
    F.w[0] = s.kind == 0 ? a.cosa_u[m] : a.cosa_v[m];
    F.w[1] = s.kind == 0 ? a.rsin2_u[m] : a.rsin2_v[m];
  }
  return F;
}

// The wind of face F at level k: an x-face at padded (J, I), J in [h,
// h+n), I in [h, h+n], or a y-face, J in [h, h+n], I in [h, h+n).
__device__ float wind(const Args& a, const Face& F, int k) {
  const int N = a.N, J = F.s.J, I = F.s.I;
  const float* U = a.up + ((size_t)F.s.g * a.nz + k) * (N + 1) * N;
  const float* V = a.vp + ((size_t)F.s.g * a.nz + k) * N * (N + 1);
  const float* w = F.w;
  if (F.s.kind == 0) {
    if (F.edge) {
      const float u1l = 0.5f * (U[J * N + I - 1] + U[(J + 1) * N + I - 1]);
      const float u2l =
          0.5f * (V[J * (N + 1) + I - 1] + V[J * (N + 1) + I]);
      const float u1r = 0.5f * (U[J * N + I] + U[(J + 1) * N + I]);
      const float u2r =
          0.5f * (V[J * (N + 1) + I] + V[J * (N + 1) + I + 1]);
      return mul(w[0], u1l) + mul(w[1], u2l) + mul(w[2], u1r) +
             mul(w[3], u2r);
    }
    const float cov = 0.25f * (U[J * N + I - 1] + U[J * N + I] +
                               U[(J + 1) * N + I - 1] + U[(J + 1) * N + I]);
    return (cov - mul(w[0], V[J * (N + 1) + I])) * w[1];
  }
  if (F.edge) {
    const float u1l = 0.5f * (U[(J - 1) * N + I] + U[J * N + I]);
    const float u2l =
        0.5f * (V[(J - 1) * (N + 1) + I] + V[(J - 1) * (N + 1) + I + 1]);
    const float u1r = 0.5f * (U[J * N + I] + U[(J + 1) * N + I]);
    const float u2r = 0.5f * (V[J * (N + 1) + I] + V[J * (N + 1) + I + 1]);
    return mul(w[0], u1l) + mul(w[1], u2l) + mul(w[2], u1r) +
           mul(w[3], u2r);
  }
  const float cov =
      0.25f * (V[(J - 1) * (N + 1) + I] + V[J * (N + 1) + I] +
               V[(J - 1) * (N + 1) + I + 1] + V[J * (N + 1) + I + 1]);
  return (cov - mul(w[0], U[J * N + I])) * w[1];
}

// 1. the C winds, into the four lattices.  Grid: (positions, runs of
// kLevels levels, 4 * 6); a thread decodes its slot's table entry and
// loads the face's metric once for its run.
__global__ void __launch_bounds__(kThreads) csw_cwinds(Args a) {
  const int NN = a.N * a.N;
  const int pos = blockIdx.x * kThreads + threadIdx.x;
  if (pos >= NN) return;
  const int o = blockIdx.z / 6, f = blockIdx.z % 6;
  const int t = blockIdx.z * NN + pos;
  const Face F = face_of(a, a.src[t]);
  const float c = a.coef[t];
  float* out = (o == 0 ? a.ucx : o == 1 ? a.vcy : o == 2 ? a.vcx : a.ucy) +
               lattice(a, f, 0) + pos;
  const int k0 = blockIdx.y * kLevels, k1 = min(a.nz, k0 + kLevels);
  for (int k = k0; k < k1; ++k) out[(size_t)k * NN] = wind(a, F, k) * c;
}

// The upwind (hord 1) face value of ops/advection.py::ppm_flux: the cell
// behind the face for c > 0, the cell ahead of it otherwise.
__device__ __forceinline__ float upwind(float c, float behind, float ahead) {
  return c > 0.f ? behind : ahead;
}

// Shared memory of a csw_half_columns block: delpc, ptc (then dphi) and
// KE slabs of nz levels, pe (then the interface geopotential) and pik of
// nz + 1.
size_t smem_bytes(int nz) {
  return (5 * (size_t)nz + 2) * TC * sizeof(float);
}

// 2. the half step and the columns.  Grid: the slabs of the 6 (n+2)^2
// box columns.
__global__ void __launch_bounds__(kThreads) csw_half_columns(Args a) {
  extern __shared__ float smem[];
  __shared__ ColumnTile<TC> tile;
  const int nz = a.nz, N = a.N, L = nz * TC;
  float* s_dp = smem;
  float* s_pt = s_dp + L;
  float* s_ke = s_pt + L;
  float* s_pe = s_ke + L;         // nz + 1 levels
  float* s_pk = s_pe + L + TC;    // nz + 1 levels
  const int box = a.n + 2;
  tile_columns(tile, 6, box * box, box, a.h - 1);
  const int cols = tile.cols;

  // level by level: fluxes, delpc, ptc, KE --------------------------------
  for (int t = threadIdx.x; t < L; t += kThreads) {
    const int k = t / TC, c = t % TC;
    if (c >= cols) continue;
    const int f = tile.face[c], P = tile.pos_pad[c];
    const size_t b = lattice(a, f, k) + P;
    const int m = f * N * N + P;
    const float u0 = a.ucx[b], u1 = a.ucx[b + 1];
    const float v0 = a.vcy[b], v1 = a.vcy[b + N];
    const float dxm = a.dpx[b - 1], dx0 = a.dpx[b], dxp = a.dpx[b + 1];
    const float dym = a.dpy[b - N], dy0 = a.dpy[b], dyp = a.dpy[b + N];
    const float fx0 = mul(upwind(u0, dxm, dx0), u0 * a.dt2 * a.dy_fs[m]);
    const float fx1 = mul(upwind(u1, dx0, dxp), u1 * a.dt2 * a.dy_fs[m + 1]);
    const float fy0 = mul(upwind(v0, dym, dy0), v0 * a.dt2 * a.dx_fs[m]);
    const float fy1 = mul(upwind(v1, dy0, dyp), v1 * a.dt2 * a.dx_fs[m + N]);
    const float ra = 1.f / a.area_px[m];
    const float delpc = dx0 + mul((fx0 - fx1) + (fy0 - fy1), ra);
    const float fxt0 = mul(upwind(u0, a.ptx[b - 1], a.ptx[b]), fx0);
    const float fxt1 = mul(upwind(u1, a.ptx[b], a.ptx[b + 1]), fx1);
    const float fyt0 = mul(upwind(v0, a.pty[b - N], a.pty[b]), fy0);
    const float fyt1 = mul(upwind(v1, a.pty[b], a.pty[b + N]), fy1);
    const float ptc =
        (mul(a.ptx[b], dx0) + mul((fxt0 - fxt1) + (fyt0 - fyt1), ra)) / delpc;
    const float ub = 0.5f * (u0 + u1), vb = 0.5f * (v0 + v1);
    s_dp[t] = delpc;
    s_pt[t] = ptc;
    s_ke[t] = 0.5f * (mul(ub, ub) + mul(vb, vb));
    a.ptc[b] = ptc;
  }
  __syncthreads();

  // one thread a column: pe from ptop -------------------------------------
  if (threadIdx.x < cols) {
    float acc = 0.f;
    int t = threadIdx.x;
    s_pe[t] = acc + a.ptop;
    for (; t < L; t += TC) {
      acc = acc + s_dp[t];
      s_pe[t + TC] = acc + a.ptop;
    }
  }
  __syncthreads();
  // the layer-mean Exner function, as K4 computes it -------------------
  for (int t = threadIdx.x; t < L + TC; t += kThreads)
    if (t % TC < cols) s_pk[t] = powf(s_pe[t] / a.p00, a.kappa);
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += kThreads) {
    const int k = t / TC, c = t % TC;
    if (c >= cols) continue;
    a.pi_lay[lattice(a, tile.face[c], k) + tile.pos_pad[c]] =
        (mul(s_pk[t + TC], s_pe[t + TC]) - mul(s_pk[t], s_pe[t])) /
        ((1.f + a.kappa) * s_dp[t]);
  }
  __syncthreads();

  // dphi from pik of the clamped pe, as the chain computes it: pe times the
  // rounded 1/p00, as torch divides by a number -------------------------
  const float inv_p00 = 1.f / a.p00;
  for (int t = threadIdx.x; t < L + TC; t += kThreads)
    if (t % TC < cols)
      s_pk[t] = powf(fmaxf(s_pe[t], 1e-30f) * inv_p00, a.kappa);
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += kThreads)
    if (t % TC < cols) s_pt[t] = mul(a.cp * s_pt[t], s_pk[t + TC] - s_pk[t]);
  __syncthreads();

  // one thread a column, up from the surface: the interface geopotential --
  if (threadIdx.x < cols) {
    const int c = threadIdx.x;
    const float phis =
        a.phis == nullptr
            ? 0.f
            : a.phis[a.phis_tab[tile.face[c] * N * N + tile.pos_pad[c]]];
    float acc = 0.f;
    s_pe[L + c] = acc + phis;
    for (int t = L - TC + c; t >= 0; t -= TC) {
      acc = acc + s_pt[t];
      s_pe[t] = acc + phis;
    }
  }
  __syncthreads();

  // kphi = KE + the layer's mean geopotential -----------------------------
  for (int t = threadIdx.x; t < L; t += kThreads) {
    const int k = t / TC, c = t % TC;
    if (c >= cols) continue;
    a.kphi[lattice(a, tile.face[c], k) + tile.pos_pad[c]] =
        s_ke[t] + mul(0.5f, s_pe[t + TC] + s_pe[t]);
  }
}

// Absolute vorticity of the D winds at cell (J, I) of face g, level k.
__device__ float zeta(const Args& a, int g, int k, int J, int I) {
  const int N = a.N;
  const size_t lu = ((size_t)g * a.nz + k) * (N + 1) * N;
  const size_t lv = ((size_t)g * a.nz + k) * N * (N + 1);
  const float* U = a.up + lu;
  const float* V = a.vp + lv;
  const float* DX = a.dx_u + (size_t)g * (N + 1) * N;
  const float* DY = a.dy_v + (size_t)g * N * (N + 1);
  const int u0 = J * N + I, v0 = J * (N + 1) + I;
  const float vort = mul(U[u0], DX[u0]) - mul(U[u0 + N], DX[u0 + N]) +
                     mul(V[v0 + 1], DY[v0 + 1]) - mul(V[v0], DY[v0]);
  const int m = (g * N + J) * N + I;
  return mul(vort, 1.f / a.area_px[m]) + a.f_px[m];
}

// 3. the wind update, into the two result lattices.  Grid: (positions,
// nz, 2 * 6).
__global__ void __launch_bounds__(kThreads) csw_wind_update(Args a) {
  const int N = a.N, NN = N * N;
  const int pos = blockIdx.x * kThreads + threadIdx.x;
  if (pos >= NN) return;
  const int k = blockIdx.y, o = blockIdx.z / 6, f = blockIdx.z % 6;
  const int t = blockIdx.z * NN + pos;
  const Own s = decode(a.src[t], N);
  const size_t b = lattice(a, s.g, k) + s.J * N + s.I;
  const int m = (s.g * N + s.J) * N + s.I;
  // the neighbour across the face: the cell behind it in x or in y
  const int d = s.kind == 0 ? 1 : N;
  const float zf = 0.5f * (zeta(a, s.g, k, s.J, s.I) +
                           (s.kind == 0 ? zeta(a, s.g, k, s.J, s.I - 1)
                                        : zeta(a, s.g, k, s.J - 1, s.I)));
  const float ptf = 0.5f * (a.ptc[b] + a.ptc[b - d]);
  const float grad = (a.kphi[b] - a.kphi[b - d]) +
                     mul(a.cp * ptf, a.pi_lay[b] - a.pi_lay[b - d]);
  float v;
  if (s.kind == 0) {
    const float* T = a.vcx;  // vbar_u: vc of fill x at (J, I), (J+1, I),
                             // (J, I-1), (J+1, I-1)
    const float vbar = 0.25f * (T[b] + T[b + N] + T[b - 1] + T[b + N - 1]);
    v = a.ucx[b] + mul(a.dt2, mul(zf, vbar) - grad / a.dxc_f[m]);
  } else {
    const float* T = a.ucy;  // ubar_v: uc of fill y at (J, I), (J, I+1),
                             // (J-1, I), (J-1, I+1)
    const float ubar = 0.25f * (T[b] + T[b + 1] + T[b - N] + T[b - N + 1]);
    v = a.vcy[b] + mul(a.dt2, mul(-zf, ubar) - grad / a.dyc_f[m]);
  }
  (o == 0 ? a.uc_out : a.vc_out)[lattice(a, f, k) + pos] = v * a.coef[t];
}

}  // namespace

// in: up, vp, dpx, dpy, ptx, pty, cosa_u, rsin2_u, cosa_v, rsin2_v, xbw_w,
// xbw_e, ybw_s, ybw_n, dy_fs, dx_fs, area_px, dx_u, dy_v, f_px, dxc_f,
// dyc_f, src, coef, phis_tab, phis (null: no surface geopotential);
// out: ucx, vcy, vcx, ucy, kphi, pi_lay, ptc, uc, vc; float32 (the tables
// int32), contiguous.  Returns cudaGetLastError() after the three launches
// (0 on success), -1 when h < 2, nz > 65535 or a slab exceeds a block's
// shared memory.
extern "C" int fv3_c_sw_half(const void* const* in, void* const* out,
                             int nz, int n, int h, float dt2, float ptop,
                             float p00, float kappa, float cp,
                             void* stream) {
  if (h < 2 || nz > 65535) return -1;
  const float* const* i = reinterpret_cast<const float* const*>(in);
  float* const* o = reinterpret_cast<float* const*>(out);
  Args a{i[0],  i[1],  i[2],  i[3],  i[4],  i[5],  i[6],  i[7],
         i[8],  i[9],  i[10], i[11], i[12], i[13], i[14], i[15],
         i[16], i[17], i[18], i[19], i[20], i[21],
         reinterpret_cast<const int*>(in[22]), i[23],
         reinterpret_cast<const int*>(in[24]), i[25],
         o[0],  o[1],  o[2],  o[3],  o[4],  o[5],  o[6],  o[7],  o[8],
         nz,    n,     h,     n + 2 * h,
         dt2,   ptop,  p00,   kappa, cp};
  if (nz == 0) return 0;
  const size_t bytes = smem_bytes(nz);
  static SlabSmem smem;
  const int err = allow_slab_smem(csw_half_columns, bytes, &smem);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NN = a.N * a.N, box = n + 2;
  const unsigned blocks = (unsigned)((NN + kThreads - 1) / kThreads);
  const unsigned runs = (unsigned)((nz + kLevels - 1) / kLevels);
  csw_cwinds<<<dim3(blocks, runs, 24), kThreads, 0, s>>>(a);
  csw_half_columns<<<(unsigned)((6 * box * box + TC - 1) / TC), kThreads,
                     bytes, s>>>(a);
  csw_wind_update<<<dim3(blocks, nz, 12), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
