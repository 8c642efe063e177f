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
// Bound on the card: bytes.  Per level it reads one value and writes three
// (16 B) for two powf and two logf; one thread per column (f, y, x) walks
// the levels, so the prefix sum is a register recurrence, the values at
// the upper interface are carried to the next level instead of recomputed
// (one powf and one logf per interface), and every load and store is a
// coalesced row with level stride Y*X.  Halo-corner columns of the padded
// fields may hold garbage or NaN (the C half-stage feeds the padded
// delpc); they flow through the arithmetic without trapping and are never
// consumed.

#include <cuda_runtime.h>

namespace {

__global__ void column_kernel(const float* __restrict__ dp,
                              float* __restrict__ pe,
                              float* __restrict__ pi_lay,
                              float* __restrict__ pm, int F, int nz, int yx,
                              float ptop, float p00, float kappa) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= F * yx) return;
  const int f = col / yx;
  const int p = col % yx;
  const long long L0 = (long long)f * nz * yx + p;
  const long long I0 = (long long)f * (nz + 1) * yx + p;

  float acc = 0.f;
  float pe_lo = acc + ptop;
  pe[I0] = pe_lo;
  float pik_lo = powf(pe_lo / p00, kappa);
  float ln_lo = logf(pe_lo);
  for (int k = 0; k < nz; ++k) {
    const float d = dp[L0 + (long long)k * yx];
    acc = acc + d;
    const float pe_hi = acc + ptop;
    const float pik_hi = powf(pe_hi / p00, kappa);
    const float ln_hi = logf(pe_hi);
    pe[I0 + (long long)(k + 1) * yx] = pe_hi;
    pi_lay[L0 + (long long)k * yx] =
        (pik_hi * pe_hi - pik_lo * pe_lo) / ((1.f + kappa) * d);
    pm[L0 + (long long)k * yx] = d / (ln_hi - ln_lo);
    pe_lo = pe_hi;
    pik_lo = pik_hi;
    ln_lo = ln_hi;
  }
}

}  // namespace

// dp [F, nz, Y, X] -> pe [F, nz+1, Y, X], pi_lay and pm [F, nz, Y, X];
// float32, contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int fv3_column(const float* dp, float* pe, float* pi_lay,
                          float* pm, int F, int nz, int yx, float ptop,
                          float p00, float kappa, void* stream) {
  const int threads = 128;
  const int blocks = (F * yx + threads - 1) / threads;
  column_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      dp, pe, pi_lay, pm, F, nz, yx, ptop, p00, kappa);
  return (int)cudaGetLastError();
}
