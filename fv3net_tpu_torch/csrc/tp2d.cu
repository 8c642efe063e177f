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
// one write of the outputs.  Neighbours are indexed modulo N, which
// reproduces the roll() wrap-around of the plain version on the whole
// padded array (the caller consumes only [2, N-2)).

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

  // inner half-update along y of qp_y
  {
    const Line q{a.qy + s0 + i, (int)N, (int)N};
    const int jp = wrap(j + 1, (int)N);
    const float yf0 = a.yfx[s0 + (long long)j * N + i];
    const float yf1 = a.yfx[s0 + (long long)jp * N + i];
    const float c0 = a.cry[s0 + (long long)j * N + i];
    const float c1 = a.cry[s0 + (long long)jp * N + i];
    const float f0 = ppm_face<HORD>(q, j, c0) * yf0;
    const float f1 = ppm_face<HORD>(q, j + 1, c1) * yf1;
    const float ar = a.apy[ai];
    const float ra = ar + (yf0 - yf1);
    const float q0 = q.at(j);
    a.q_y[t] = 0.5f * (q0 + (q0 * ar + (f0 - f1)) / ra);
  }
  // inner half-update along x of qp_x
  {
    const Line q{a.qx + s0 + (long long)j * N, 1, (int)N};
    const int ip = wrap(i + 1, (int)N);
    const float xf0 = a.xfx[s0 + (long long)j * N + i];
    const float xf1 = a.xfx[s0 + (long long)j * N + ip];
    const float c0 = a.crx[s0 + (long long)j * N + i];
    const float c1 = a.crx[s0 + (long long)j * N + ip];
    const float f0 = ppm_face<HORD>(q, i, c0) * xf0;
    const float f1 = ppm_face<HORD>(q, i + 1, c1) * xf1;
    const float ar = a.apx[ai];
    const float ra = ar + (xf0 - xf1);
    const float q0 = q.at(i);
    a.q_x[t] = 0.5f * (q0 + (q0 * ar + (f0 - f1)) / ra);
  }
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
  const Line qyx{a.q_y + s0 + (long long)j * N, 1, (int)N};
  a.fx[t] = ppm_face<HORD>(qyx, i, a.crx[t]) * a.xfx[t];
  const Line qxy{a.q_x + s0 + i, (int)N, (int)N};
  a.fy[t] = ppm_face<HORD>(qxy, j, a.cry[t]) * a.yfx[t];
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
