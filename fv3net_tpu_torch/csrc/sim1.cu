// K2: semi-implicit vertical acoustic solve (SIM1) for Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_sim1.py::sim1_solver_pallas
// (body _sim1_kernel) and computes what the plain
// fv3net_tpu_torch/dycore/riemann.py::sim1_solver computes: per column,
// the gas-law layer pressure perturbation, the bidiagonal forward sweep for
// the interface perturbation pp, a Thomas solve for w, the ppe prefix sum
// and the new layer thickness dz2.
//
// Bound on the card: latency of the level recurrences.  A column is a
// chain of three nz-long recurrences (~60 flops per level) over 9 input
// and output values per level; the Pallas kernel batched (BY, n) rows in
// VMEM per loop step.  Here one thread owns one column (face, j, i):
// neighbouring threads take neighbouring i, so every per-level load or
// store is one coalesced row access with level stride n*n, and the
// recurrence state stays in registers.  The two per-column arrays the
// back-substitutions need (pp over nz+1 interfaces, the Thomas factors
// gam over nz levels) live in a wrapper-allocated global scratch laid out
// like the fields; the forward Thomas values are kept in the w2 output and
// overwritten in place by the back substitution.  At C48 there are only
// 6*48*48 = 13824 columns, fewer threads than the card can hold, so the
// kernel is bound by the dependent-load latency of each level, not by
// bandwidth.

#include <cuda_runtime.h>

namespace {

struct Consts {
  float rdgas, p00, gamma, dz_exp;  // dz_exp = -cv/cp
};

__global__ void sim1_kernel(const float* __restrict__ dm,
                            const float* __restrict__ pt,
                            const float* __restrict__ dz,
                            const float* __restrict__ w,
                            const float* __restrict__ pem,
                            const float* __restrict__ pm,
                            const float* __restrict__ ws,
                            float* __restrict__ w2, float* __restrict__ dz2,
                            float* __restrict__ ppe, float* __restrict__ pp,
                            float* __restrict__ gam, int F, int nz, int nn,
                            float dt, float p_fac, Consts c) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= F * nn) return;
  const int f = col / nn;
  const int p = col % nn;
  const long long L0 = (long long)f * nz * nn + p;        // layer fields
  const long long I0 = (long long)f * (nz + 1) * nn + p;  // interface fields
#define LAY(a, k) a[L0 + (long long)(k) * nn]
#define IFC(a, k) a[I0 + (long long)(k) * nn]

  // gas-law layer pressure perturbation (riemann.full_pressure - pm)
  auto pe_of = [&](int k) {
    const float rr = -LAY(dm, k) * c.rdgas * LAY(pt, k) / LAY(dz, k);
    return c.p00 * powf(rr / c.p00, c.gamma) - LAY(pm, k);
  };

  // --- bidiagonal forward sweep for pp (interface perturbation) --------
  IFC(pp, 0) = 0.f;
  float dm0 = LAY(dm, 0);
  float pe0 = pe_of(0);
  float g_prev = 0.f;  // g_rat[k-1]
  float bet = 1.f;
  float pp_k = 0.f;
  for (int k = 0; k < nz; ++k) {
    float bb, dd, g = 0.f;
    float dm1 = 0.f, pe1 = 0.f;
    if (k < nz - 1) {
      dm1 = LAY(dm, k + 1);
      pe1 = pe_of(k + 1);
      g = dm0 / dm1;
      bb = 2.f * (1.f + g);
      dd = 3.f * (pe0 + g * pe1);
    } else {
      bb = 2.f;
      dd = 3.f * pe0;
    }
    const float gm = (k == 0) ? 0.f : g_prev / bet;
    bet = bb - gm;
    pp_k = (dd - pp_k) / bet;
    IFC(pp, k + 1) = pp_k;
    g_prev = g;
    dm0 = dm1;
    pe0 = pe1;
  }

  // --- Thomas solve for w ---------------------------------------------
  const float t1g = 2.f * c.gamma * dt * dt;
  const float p1 =
      t1g / LAY(dz, nz - 1) * (IFC(pem, nz) + IFC(pp, nz));
  float a_up = 0.f;  // stiffness at the interface above level k
  float wp = 0.f;
  bet = 1.f;
  for (int k = 0; k < nz; ++k) {
    const float a_dn =
        (k < nz - 1)
            ? t1g / (LAY(dz, k) + LAY(dz, k + 1)) *
                  (IFC(pem, k + 1) + IFC(pp, k + 1))
            : p1;
    float r = LAY(dm, k) * LAY(w, k) + dt * (IFC(pp, k + 1) - IFC(pp, k));
    if (k == nz - 1) r = r - p1 * ws[col];
    const float dmk = LAY(dm, k);
    float g;
    if (k == 0) {
      g = 0.f;
      bet = dmk - a_dn;
    } else {
      g = a_up / bet;
      bet = dmk - (a_up + a_dn + a_up * g);
    }
    wp = (r - a_up * wp) / bet;
    LAY(gam, k) = g;
    LAY(w2, k) = wp;
    a_up = a_dn;
  }
  float w_next = wp;
  for (int k = nz - 2; k >= 0; --k) {
    w_next = LAY(w2, k) - LAY(gam, k + 1) * w_next;
    LAY(w2, k) = w_next;
  }

  // --- ppe prefix sum and the new layer thickness ----------------------
  float acc = 0.f;
  IFC(ppe, 0) = 0.f;
  for (int k = 0; k < nz; ++k) {
    const float dmk = LAY(dm, k);
    const float pmk = LAY(pm, k);
    const float prev = acc;
    acc = acc + dmk * (LAY(w2, k) - LAY(w, k)) / dt;
    IFC(ppe, k + 1) = acc;
    float p_lay = pmk + (prev + 2.f * acc) / 3.f;
    p_lay = fmaxf(p_lay, p_fac * pmk);
    LAY(dz2, k) = -(dmk * c.rdgas * LAY(pt, k) / c.p00) *
                  powf(p_lay / c.p00, c.dz_exp);
  }
#undef LAY
#undef IFC
}

}  // namespace

// Arrays [F, nz, n, n] (pem, ppe, pp: [F, nz+1, n, n]; ws: [F, n, n]),
// float32, contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int fv3_sim1(const float* dm, const float* pt, const float* dz,
                        const float* w, const float* pem, const float* pm,
                        const float* ws, float* w2, float* dz2, float* ppe,
                        float* pp, float* gam, int F, int nz, int nn,
                        float dt, float p_fac, float rdgas, float p00,
                        float gamma, float dz_exp, void* stream) {
  const int threads = 128;
  const int blocks = (F * nn + threads - 1) / threads;
  Consts c{rdgas, p00, gamma, dz_exp};
  sim1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      dm, pt, dz, w, pem, pm, ws, w2, dz2, ppe, pp, gam, F, nz, nn, dt,
      p_fac, c);
  return (int)cudaGetLastError();
}
