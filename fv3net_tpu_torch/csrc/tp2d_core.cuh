// Per-cell arithmetic of the Lin-Rood 2D transport, shared by K1
// (tp2d.cu, one fv_tp_2d) and K6 (tp2d_multi5.cu, the D stage's five):
// PPM edge values with the hord 1/5/6/8 limiters, the upwind face average
// of ops/advection.py::ppm_flux, the face flux and the inner transverse
// half-update of ops/advection.py::fv_tp_2d_plain.  The edge and face
// functions read their cells through a line type; both kernels pass an
// SLine over a shared-memory tile whose loads have already taken the
// indices modulo N (tile.cuh), which reproduces the roll() wrap-around of
// the plain version on the whole padded [N, N] slab.
//
// Stencil reach: the face average at face i reads cells i-3 .. i+2 (the
// edges of the upwind cell, i-1 or i, each an edge4 of two cells either
// side); the inner half-update of cell i reads its faces i and i+1, so
// cells i-3 .. i+3 and the Courant numbers and fluxes at i and i+1.

#pragma once

#include <cuda_runtime.h>

namespace {

// i modulo n for i within a few lattices of [0, n): no division
__device__ __forceinline__ int wrap_near(int i, int n) {
  while (i < 0) i += n;
  while (i >= n) i -= n;
  return i;
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// One row or column of a shared-memory tile: element stride `stride`,
// no wrap-around (the tile's loads took the indices modulo N).
struct SLine {
  const float* base;
  int stride;
  __device__ __forceinline__ float at(int i) const {
    return base[i * stride];
  }
};

// 4th-order edge between cells i-1 and i (the unlimited al of cell i).
template <class L>
__device__ __forceinline__ float edge4(const L& q, int i) {
  return (7.f / 12.f) * (q.at(i - 1) + q.at(i)) -
         (1.f / 12.f) * (q.at(i - 2) + q.at(i + 1));
}

// (al, ar, a6) of cell i: ops/advection.py::_ppm_edges.
template <int HORD, class L>
__device__ __forceinline__ void ppm_edges(const L& q, int i, float& al,
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
// Courant number c: ops/advection.py::ppm_flux.  The upwind cell is
// chosen before its edges are computed, so the threads of a warp whose
// faces see flows of both signs run the edge arithmetic together.
template <int HORD, class L>
__device__ __forceinline__ float ppm_face(const L& q, int i, float c) {
  float al, ar, a6;
  const bool up = c > 0.f;
  ppm_edges<HORD>(q, up ? i - 1 : i, al, ar, a6);
  if (up) return ar - 0.5f * c * ((ar - al) - a6 * (1.f - (2.f / 3.f) * c));
  const float b = -c;
  return al + 0.5f * b * ((ar - al) + a6 * (1.f - (2.f / 3.f) * b));
}

// The flux through face i: the face average times the mass flux m,
// rounded on its own as the plain version's product is (never contracted
// into the update that takes it, so a flux computed once and kept equals
// one computed where it is used).
template <int HORD, class L>
__device__ __forceinline__ float face_flux(const L& q, int i, float c,
                                           float m) {
  return __fmul_rn(ppm_face<HORD>(q, i, c), m);
}

// The inner half-update of a cell of mean q0 and area `area` from its two
// face fluxes f0 = face(i) * m0 and f1 = face(i+1) * m1 (mass fluxes m0,
// m1): 0.5 (q0 + (q0 area + f0 - f1) / (area + m0 - m1)).
__device__ __forceinline__ float inner_update(float q0, float area, float f0,
                                              float f1, float m0, float m1) {
  const float ra = area + (m0 - m1);
  return 0.5f * (q0 + (q0 * area + (f0 - f1)) / ra);
}

}  // namespace
