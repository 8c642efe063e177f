// K3: del-4 conservative filter q - (c/8) L(L(q)) for Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_filter.py::
// del4_filter_pallas (body _filter_kernel).  L is the flux-form Laplacian
// of fv3net_tpu_torch/dycore/sw.py::scalar_filter (its plain L_local
// form): face fluxes t = w * (q_i - q_{i-1}) with w the mean adjacent cell
// area, doubled on the inter-face boundary faces (index h and h+n), and
// L(q)_i = (t_i - t_{i+1} + t_j - t_{j+1}) / area.
//
// Bound on the card: bytes.  The plain form pays, per application of L, an
// x-fill and a y-fill halo exchange and a chain of full-field stencils.
// Here both applications come from ONE pre-exchanged (x-fill, y-fill)
// pair, as in the Pallas kernel: the halo band of L(q) is computed locally
// instead of re-exchanged (exact, because every input the band stencil
// touches is canonical halo data).  Two launches, one thread per cell:
//   1. del4_lap1: L(q) over the whole padded N x N lattice (neighbours
//      indexed modulo N, the roll() wrap of the Pallas kernel) into a
//      wrapper-allocated scratch;
//   2. del4_out: L(L(q)) and the filtered interior [F, nz, n, n].
// Face weights and 1/area are formed in registers from the padded areas,
// so the traffic is the two field reads, the scratch round trip and the
// interior write.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

struct Args {
  const float *qx, *qy, *apx, *apy;
  float *l1, *out;
  int F, nz, N, h;
  float c8;
};

// weight of the x-face at (j, i) (between cells i-1 and i) and of the
// y-face at (j, i) (between rows j-1 and j), on face f
__device__ __forceinline__ float wx(const Args& a, const float* apx, int j,
                                   int i) {
  const int n = a.N - 2 * a.h;
  const float dbl = (i == a.h || i == a.h + n) ? 2.f : 1.f;
  return 0.5f * (apx[j * a.N + i] + apx[j * a.N + wrap(i - 1, a.N)]) * dbl;
}

__device__ __forceinline__ float wy(const Args& a, const float* apy, int j,
                                   int i) {
  const int n = a.N - 2 * a.h;
  const float dbl = (j == a.h || j == a.h + n) ? 2.f : 1.f;
  return 0.5f * (apy[j * a.N + i] + apy[wrap(j - 1, a.N) * a.N + i]) * dbl;
}

// L at padded cell (j, i) of one (f, k) slab: qa supplies the x-direction
// differences and qb the y-direction ones.
__device__ __forceinline__ float lap(const Args& a, const float* qa,
                                     const float* qb, const float* apx,
                                     const float* apy, int j, int i) {
  const int N = a.N;
  const int im = wrap(i - 1, N), ip = wrap(i + 1, N);
  const int jm = wrap(j - 1, N), jp = wrap(j + 1, N);
  const float tx0 = wx(a, apx, j, i) * (qa[j * N + i] - qa[j * N + im]);
  const float tx1 = wx(a, apx, j, ip) * (qa[j * N + ip] - qa[j * N + i]);
  const float ty0 = wy(a, apy, j, i) * (qb[j * N + i] - qb[jm * N + i]);
  const float ty1 = wy(a, apy, jp, i) * (qb[jp * N + i] - qb[j * N + i]);
  return (1.f / apx[j * N + i]) * ((tx0 - tx1) + (ty0 - ty1));
}

__global__ void del4_lap1(Args a) {
  const long long NN = (long long)a.N * a.N;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)a.F * a.nz * NN) return;
  const int i = (int)(t % a.N);
  const int j = (int)((t / a.N) % a.N);
  const long long slab = t / NN;
  const int f = (int)(slab / a.nz);
  a.l1[t] = lap(a, a.qx + slab * NN, a.qy + slab * NN, a.apx + f * NN,
                a.apy + f * NN, j, i);
}

__global__ void del4_out(Args a) {
  const int n = a.N - 2 * a.h;
  const long long nn = (long long)n * n, NN = (long long)a.N * a.N;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)a.F * a.nz * nn) return;
  const int i = (int)(t % n) + a.h;
  const int j = (int)((t / n) % n) + a.h;
  const long long slab = t / nn;
  const int f = (int)(slab / a.nz);
  const float* l1 = a.l1 + slab * NN;
  const float l2 = lap(a, l1, l1, a.apx + f * NN, a.apy + f * NN, j, i);
  a.out[t] = a.qx[slab * NN + (long long)j * a.N + i] - a.c8 * l2;
}

}  // namespace

// qx, qy [F, nz, N, N] (x-fill / y-fill exchanges), apx, apy [F, N, N],
// l1 scratch [F, nz, N, N], out [F, nz, n, n]; float32, contiguous.
// Returns cudaGetLastError() after the two launches.
extern "C" int fv3_del4(const float* qx, const float* qy, const float* apx,
                        const float* apy, float* l1, float* out, int F,
                        int nz, int N, int h, float c8, void* stream) {
  Args a{qx, qy, apx, apy, l1, out, F, nz, N, h, c8};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long n = N - 2 * h;
  const long long all = (long long)F * nz * N * N;
  const long long inner = (long long)F * nz * n * n;
  del4_lap1<<<(unsigned)((all + threads - 1) / threads), threads, 0, s>>>(a);
  del4_out<<<(unsigned)((inner + threads - 1) / threads), threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
