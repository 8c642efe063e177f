// Per-cell arithmetic of the Lin-Rood 2D transport, shared by K1
// (tp2d.cu, one fv_tp_2d) and K6 (tp2d_multi5.cu, the D stage's five):
// PPM edge values with the hord 1/5/6/8 limiters, the upwind face average
// of ops/advection.py::ppm_flux, the inner transverse half-update and the
// outer flux of ops/advection.py::fv_tp_2d_plain.  Neighbours are indexed
// modulo N, which reproduces the roll() wrap-around of the plain version
// on the whole padded [N, N] slab (the caller consumes only [2, N-2)).

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// One row or column of a slab: element stride `stride`, length n, cells
// indexed modulo n.
struct Line {
  const float* base;
  int stride;
  int n;
  __device__ __forceinline__ float at(int i) const {
    return base[wrap(i, n) * stride];
  }
};

// 4th-order edge between cells i-1 and i (the unlimited al of cell i).
__device__ __forceinline__ float edge4(const Line& q, int i) {
  return (7.f / 12.f) * (q.at(i - 1) + q.at(i)) -
         (1.f / 12.f) * (q.at(i - 2) + q.at(i + 1));
}

// (al, ar, a6) of cell i: ops/advection.py::_ppm_edges.
template <int HORD>
__device__ __forceinline__ void ppm_edges(const Line& q, int i, float& al,
                                          float& ar, float& a6) {
  const float q0 = q.at(i);
  if (HORD == 1) {
    al = q0;
    ar = q0;
    a6 = 0.f;
    return;
  }
  float l = edge4(q, i);
  float r = edge4(q, i + 1);
  if (HORD == 5) {
    al = l;
    ar = r;
    a6 = 3.f * (2.f * q0 - (l + r));
    return;
  }
  const float qm1 = q.at(i - 1), qp1 = q.at(i + 1);
  const float lo = fminf(fminf(qm1, q0), qp1);
  const float hi = fmaxf(fmaxf(qm1, q0), qp1);
  if (HORD == 8) {
    const float df2 = 0.25f * (qp1 - qm1);
    const float dm = sgn(df2) * fminf(fabsf(2.f * df2),
                                      fminf(fabsf(hi - q0), fabsf(q0 - lo)));
    const float bl = -sgn(dm) * fminf(fabsf(2.f * dm), fabsf(l - q0));
    const float br = sgn(dm) * fminf(fabsf(2.f * dm), fabsf(r - q0));
    l = q0 + bl;
    r = q0 + br;
  } else {  // HORD == 6
    l = clip(l, lo, hi);
    r = clip(r, lo, hi);
  }
  al = l;
  ar = r;
  a6 = 3.f * (2.f * q0 - (l + r));
}

// Upwind PPM face average at face i (between cells i-1 and i) for the
// Courant number c: ops/advection.py::ppm_flux.
template <int HORD>
__device__ __forceinline__ float ppm_face(const Line& q, int i, float c) {
  float al, ar, a6;
  if (c > 0.f) {
    ppm_edges<HORD>(q, i - 1, al, ar, a6);
    return ar - 0.5f * c * ((ar - al) - a6 * (1.f - (2.f / 3.f) * c));
  }
  ppm_edges<HORD>(q, i, al, ar, a6);
  const float b = -c;
  return al + 0.5f * b * ((ar - al) + a6 * (1.f - (2.f / 3.f) * b));
}

// Inner half-update along y of cell (j, i) of one [N, N] slab: q the
// y-filled field, cr the y Courant numbers, mf the y mass fluxes, area
// the cell's (plain or mass-weighted) area.
template <int HORD>
__device__ __forceinline__ float inner_y(const float* q, const float* cr,
                                         const float* mf, float area, int j,
                                         int i, int N) {
  const Line ql{q + i, N, N};
  const int jp = wrap(j + 1, N);
  const float m0 = mf[j * N + i];
  const float m1 = mf[jp * N + i];
  const float f0 = ppm_face<HORD>(ql, j, cr[j * N + i]) * m0;
  const float f1 = ppm_face<HORD>(ql, j + 1, cr[jp * N + i]) * m1;
  const float ra = area + (m0 - m1);
  const float q0 = ql.at(j);
  return 0.5f * (q0 + (q0 * area + (f0 - f1)) / ra);
}

// Inner half-update along x of cell (j, i): as inner_y with the x-filled
// field, x Courant numbers and x mass fluxes.
template <int HORD>
__device__ __forceinline__ float inner_x(const float* q, const float* cr,
                                         const float* mf, float area, int j,
                                         int i, int N) {
  const Line ql{q + j * N, 1, N};
  const int ip = wrap(i + 1, N);
  const float m0 = mf[j * N + i];
  const float m1 = mf[j * N + ip];
  const float f0 = ppm_face<HORD>(ql, i, cr[j * N + i]) * m0;
  const float f1 = ppm_face<HORD>(ql, i + 1, cr[j * N + ip]) * m1;
  const float ra = area + (m0 - m1);
  const float q0 = ql.at(i);
  return 0.5f * (q0 + (q0 * area + (f0 - f1)) / ra);
}

// Outer x flux at face (j, i) from the y half-updated slab q_y.
template <int HORD>
__device__ __forceinline__ float outer_x(const float* q_y, const float* cr,
                                         const float* mf, int j, int i,
                                         int N) {
  const Line ql{q_y + j * N, 1, N};
  return ppm_face<HORD>(ql, i, cr[j * N + i]) * mf[j * N + i];
}

// Outer y flux at face (j, i) from the x half-updated slab q_x.
template <int HORD>
__device__ __forceinline__ float outer_y(const float* q_x, const float* cr,
                                         const float* mf, int j, int i,
                                         int N) {
  const Line ql{q_x + i, N, N};
  return ppm_face<HORD>(ql, j, cr[j * N + i]) * mf[j * N + i];
}

}  // namespace
