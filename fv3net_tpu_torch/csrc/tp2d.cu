// K1: Lin-Rood 2D flux-form transport (fv_tp_2d) for Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_tp.py::fv_tp_2d_pallas
// (body _tp2d_kernel) and computes what the plain
// fv3net_tpu_torch/ops/advection.py::fv_tp_2d computes: PPM edge values
// with the hord 1/5/6/8 limiters, upwind face averages, the inner
// transverse half-update and the outer x/y fluxes, on padded
// [F, nz, N, N] float32 fields.
//
// Bound on the card: bytes.  Per cell the operator does ~150 flops and
// must read 8 inputs and write 2 outputs (40 B), far below the H100's
// ~20 flop/B balance point, so its floor is one pass over memory.  The
// Pallas kernel kept a whole (face, z-block) slab in VMEM; here one thread
// owns one (face, level, j, i) cell and re-reads its +/-3 stencil from
// L1/L2 (neighbouring threads share those lines), in two launches:
//   1. tp2d_inner: the inner half-updates q_y (from qp_y along y) and q_x
//      (from qp_x along x) into a wrapper-allocated scratch pair;
//   2. tp2d_outer: fx from q_y along x and fy from q_x along y.
// The scratch pair is the only traffic beyond one read of the inputs and
// one write of the outputs.  The per-cell arithmetic lives in
// tp2d_core.cuh, shared with K6 (tp2d_multi5.cu).

#include "tp2d_core.cuh"

namespace {

struct Args {
  const float *qx, *qy, *crx, *cry, *xfx, *yfx, *apx, *apy;
  float *q_x, *q_y, *fx, *fy;
  long long a_fstride, a_kstride;
  int F, nz, N;
};

template <int HORD>
__global__ void tp2d_inner(Args a) {
  const long long N = a.N, NN = N * N;
  const long long total = (long long)a.F * a.nz * NN;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int i = (int)(t % N);
  const int j = (int)((t / N) % N);
  const long long slab = t / NN;  // f * nz + k
  const int k = (int)(slab % a.nz);
  const int f = (int)(slab / a.nz);
  const long long s0 = slab * NN;
  const long long ai =
      f * a.a_fstride + k * a.a_kstride + (long long)j * N + i;

  a.q_y[t] = inner_y<HORD>(a.qy + s0, a.cry + s0, a.yfx + s0, a.apy[ai], j,
                           i, (int)N);
  a.q_x[t] = inner_x<HORD>(a.qx + s0, a.crx + s0, a.xfx + s0, a.apx[ai], j,
                           i, (int)N);
}

template <int HORD>
__global__ void tp2d_outer(Args a) {
  const long long N = a.N, NN = N * N;
  const long long total = (long long)a.F * a.nz * NN;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int i = (int)(t % N);
  const int j = (int)((t / N) % N);
  const long long s0 = (t / NN) * NN;
  a.fx[t] = outer_x<HORD>(a.q_y + s0, a.crx + s0, a.xfx + s0, j, i, (int)N);
  a.fy[t] = outer_y<HORD>(a.q_x + s0, a.cry + s0, a.yfx + s0, j, i, (int)N);
}

template <int HORD>
void launch(const Args& a, cudaStream_t stream) {
  const long long total = (long long)a.F * a.nz * a.N * a.N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  tp2d_inner<HORD><<<blocks, threads, 0, stream>>>(a);
  tp2d_outer<HORD><<<blocks, threads, 0, stream>>>(a);
}

}  // namespace

// Returns cudaGetLastError() after the two launches (0 on success);
// -1 for an unsupported hord.
extern "C" int fv3_tp2d(const float* qx, const float* qy, const float* crx,
                        const float* cry, const float* xfx, const float* yfx,
                        const float* apx, const float* apy,
                        long long a_fstride, long long a_kstride, float* q_x,
                        float* q_y, float* fx, float* fy, int F, int nz,
                        int N, int hord, void* stream) {
  Args a{qx, qy, crx, cry, xfx, yfx, apx, apy, q_x, q_y, fx, fy,
         a_fstride, a_kstride, F, nz, N};
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
