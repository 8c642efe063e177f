// K3: del-4 conservative filter q - (c/8) L(L(q)) for Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_filter.py::
// del4_filter_pallas (body _filter_kernel).  L is the flux-form Laplacian
// of fv3net_tpu_torch/dycore/sw.py::scalar_filter (its plain L_local
// form): face fluxes t = w * (q_i - q_{i-1}) with w the mean adjacent cell
// area, doubled on the inter-face boundary faces (index h and h+n), and
// L(q)_i = (t_i - t_{i+1} + t_j - t_{j+1}) / area.
//
// Bound on the card: bytes.  The call must read q [F, nz, n, n] once and
// write the filtered interior once; the gather tables and padded areas
// (~3.8 MB at C192) are level-invariant.  As in the Pallas kernel, both
// applications of L come from the x-fill and y-fill exchanges of q: the
// halo band of L(q) is computed locally instead of re-exchanged (exact,
// because every input the band stencil touches is canonical halo data).
// But no exchanged copy exists: the kernel reads each slot of its "qx"
// and "qy" operands through the exchange's own gather table
// (grid/halo.py::scalar_gather_flat, int32 flat positions into q at level
// 0; the kernel adds k * n * n).  The two fills differ only at cube-corner
// halo slots, and those are consumed (L(q) at (h, h-1) reads qy at
// (h-1, h-1)), so the qx tile comes through the x table and the qy tile
// through the y table, slot by slot.
//
// The exchanged-pair entry (fv3_del4_pair) is the TPU kernel's own
// contract: it takes the x-fill and y-fill exchanges qx, qy [F, nz, N, N]
// themselves, for any number of faces F (a rank of the face mesh holds
// one), and reads slot (r, c) of face f at level k at
// ((f * nz + k) * N + r) * N + c, where the table entry reads it through
// the table.  Both are one kernel template (kPair): the same tiles, ring,
// weights and arithmetic in the same order.
//
// One launch.  Each block owns a TY x TX tile of interior outputs of one
// face and a run of `lv` levels (blockIdx: tile column, tile row,
// face * runs + run; no per-element division).  Once per block it loads
// the tables of its tiles (or, for a tile whose whole load region lies in
// [h, h+n)^2, where the tables are the identity, computes the positions),
// the face weights and 1/area into shared memory.  Per level it gathers
//   qx: rows J0-1 .. J0+TY, columns I0-2 .. I0+TX+1 (x-fill),
//   qy: rows J0-2 .. J0+TY+1, columns I0-1 .. I0+TX (y-fill)
// (J0, I0 the tile origin on the padded lattice) with cp.async into a
// two-stage ring, so level k+1's gathers are in flight while level k
// computes L(q) on the tile and its one-cell ring into shared memory, then
// L(L(q)) and the update.  L(q) never goes to device memory.
//
// Reach: an interior output reads L(q) at +-1, which reads q at +-2, so
// every slot read lies in [h-2, h+n+2) on each axis, inside [0, N) for
// h >= 2 (the wrapper refuses h < 2): nothing wraps, unlike the roll() of
// the Pallas kernel, whose wrapped values are never consumed.  Rows and
// columns of a ragged last tile beyond the lattice are clamped to N-1
// when loaded; they feed only outputs that are not stored.  The face
// weights keep the parent kernel's arithmetic order: 0.5 (a_i + a_{i-1})
// times the doubling, then w * (q_i - q_{i-1}), then
// (1/area) ((tx0 - tx1) + (ty0 - ty1)).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 48;  // tile width (x, the fast axis)
constexpr int TY = 16;  // tile height (y)
constexpr int kThreads = 256;

// Regions (rows x columns) around the tile origin (J0, I0).
constexpr int QX_H = TY + 2, QX_W = TX + 4;  // qx: rows J0-1.., cols I0-2..
constexpr int QY_H = TY + 4, QY_W = TX + 2;  // qy: rows J0-2.., cols I0-1..
constexpr int L_H = TY + 2, L_W = TX + 2;    // L(q), 1/area: J0-1.., I0-1..
constexpr int WX_H = L_H, WX_W = TX + 3;     // x faces: rows J0-1.., I0-1..
constexpr int WY_H = TY + 3, WY_W = L_W;     // y faces: J0-1.., cols I0-1..

struct Smem {
  float qx[2][QX_H * QX_W], qy[2][QY_H * QY_W];  // the two-stage ring
  int ix[QX_H * QX_W], iy[QY_H * QY_W];          // their positions in q
  float wx[WX_H * WX_W], wy[WY_H * WY_W];        // face weights
  float ra[L_H * L_W];                           // 1 / area
  float l1[L_H * L_W];                           // L(q)
};

struct Args {
  const float *q, *qy, *apx, *apy;  // qy: the y-fill operand (pair only)
  const int *tabx, *taby;
  float* out;
  int nz, n, h, lv, runs;
  float c8;
};

// Positions in q (level 0) of an H x W region at padded (r0, c0) of face
// f, through the table, or computed where the region is interior; for
// the pair, positions in the padded operand.
template <int H, int W, bool kPair>
__device__ __forceinline__ void positions(int* dst, const int* tab,
                                          bool interior, int r0, int c0,
                                          int f, const Args& a) {
  const int N = a.n + 2 * a.h;
  if (kPair) {
    const int base = f * a.nz * N * N;
    for (int t = threadIdx.x; t < H * W; t += kThreads) {
      const int r = r0 + t / W, c = c0 + t % W;
      dst[t] = base + min(r, N - 1) * N + min(c, N - 1);
    }
    return;
  }
  const int base = f * a.nz * a.n * a.n;
  for (int t = threadIdx.x; t < H * W; t += kThreads) {
    const int r = r0 + t / W, c = c0 + t % W;
    dst[t] = interior ? base + (r - a.h) * a.n + (c - a.h)
                      : tab[f * N * N + min(r, N - 1) * N + min(c, N - 1)];
  }
}

// Start gathering level k of the qx and qy regions into ring stage s.
template <bool kPair>
__device__ __forceinline__ void gather(Smem& s, int st, int k,
                                       const Args& a) {
  const int N = a.n + 2 * a.h;
  const int plane = kPair ? N * N : a.n * a.n;
  const float* qx = a.q + k * plane;
  const float* qy = (kPair ? a.qy : a.q) + k * plane;
  for (int t = threadIdx.x; t < QX_H * QX_W; t += kThreads)
    __pipeline_memcpy_async(&s.qx[st][t], qx + s.ix[t], sizeof(float));
  for (int t = threadIdx.x; t < QY_H * QY_W; t += kThreads)
    __pipeline_memcpy_async(&s.qy[st][t], qy + s.iy[t], sizeof(float));
  __pipeline_commit();
}

template <bool kPair>
__global__ void __launch_bounds__(kThreads) del4(Args a) {
  __shared__ Smem s;
  const int n = a.n, h = a.h, N = n + 2 * h;
  const int j0 = blockIdx.y * TY, i0 = blockIdx.x * TX;  // interior origin
  const int J0 = j0 + h, I0 = i0 + h;                    // padded origin
  const int f = blockIdx.z / a.runs;
  const int k0 = (blockIdx.z - f * a.runs) * a.lv;
  const int k1 = min(k0 + a.lv, a.nz);
  if (k0 >= k1) return;
  const bool interior = j0 >= 2 && i0 >= 2 && j0 + TY + 2 <= n &&
                        i0 + TX + 2 <= n;
  // each thread computes the positions it later gathers: no barrier
  positions<QX_H, QX_W, kPair>(s.ix, a.tabx, interior, J0 - 1, I0 - 2, f,
                               a);
  positions<QY_H, QY_W, kPair>(s.iy, a.taby, interior, J0 - 2, I0 - 1, f,
                               a);
  gather<kPair>(s, 0, k0, a);
  const float* apx = a.apx + f * N * N;
  const float* apy = a.apy + f * N * N;
  for (int t = threadIdx.x; t < WX_H * WX_W; t += kThreads) {
    const int J = min(J0 - 1 + t / WX_W, N - 1);
    const int I = I0 - 1 + t % WX_W, Ic = min(I, N - 1);
    const float dbl = (I == h || I == h + n) ? 2.f : 1.f;
    s.wx[t] = 0.5f * (apx[J * N + Ic] + apx[J * N + Ic - 1]) * dbl;
  }
  for (int t = threadIdx.x; t < WY_H * WY_W; t += kThreads) {
    const int J = J0 - 1 + t / WY_W, Jc = min(J, N - 1);
    const int I = min(I0 - 1 + t % WY_W, N - 1);
    const float dbl = (J == h || J == h + n) ? 2.f : 1.f;
    s.wy[t] = 0.5f * (apy[Jc * N + I] + apy[(Jc - 1) * N + I]) * dbl;
  }
  for (int t = threadIdx.x; t < L_H * L_W; t += kThreads) {
    const int J = min(J0 - 1 + t / L_W, N - 1);
    const int I = min(I0 - 1 + t % L_W, N - 1);
    s.ra[t] = 1.f / apx[J * N + I];
  }

  for (int k = k0; k < k1; ++k) {
    const int st = (k - k0) & 1;
    __pipeline_wait_prior(0);
    __syncthreads();  // level k is in; level k-1's reads of the other
                      // stage and of l1 are done
    if (k + 1 < k1) gather<kPair>(s, st ^ 1, k + 1, a);
    const float* qa = s.qx[st];
    const float* qb = s.qy[st];
    // L(q) on the tile and its ring: cell (J0-1+r, I0-1+c) is qx (r, c+1)
    // and qy (r+1, c)
    for (int t = threadIdx.x; t < L_H * L_W; t += kThreads) {
      const int r = t / L_W, c = t % L_W;
      const float* x = qa + r * QX_W + c + 1;
      const float* y = qb + (r + 1) * QY_W + c;
      const float tx0 = s.wx[r * WX_W + c] * (x[0] - x[-1]);
      const float tx1 = s.wx[r * WX_W + c + 1] * (x[1] - x[0]);
      const float ty0 = s.wy[r * WY_W + c] * (y[0] - y[-QY_W]);
      const float ty1 = s.wy[(r + 1) * WY_W + c] * (y[QY_W] - y[0]);
      s.l1[t] = s.ra[t] * ((tx0 - tx1) + (ty0 - ty1));
    }
    __syncthreads();
    // L(L(q)) and the update on the tile: cell (J0+r, I0+c) is l1
    // (r+1, c+1) and qx (r+1, c+2)
    float* out = a.out + (f * a.nz + k) * n * n;
    for (int t = threadIdx.x; t < TY * TX; t += kThreads) {
      const int r = t / TX, c = t % TX;
      if (j0 + r >= n || i0 + c >= n) continue;
      const int p = (r + 1) * L_W + c + 1;
      const float* l = s.l1 + p;
      const float tx0 = s.wx[(r + 1) * WX_W + c + 1] * (l[0] - l[-1]);
      const float tx1 = s.wx[(r + 1) * WX_W + c + 2] * (l[1] - l[0]);
      const float ty0 = s.wy[(r + 1) * WY_W + c + 1] * (l[0] - l[-L_W]);
      const float ty1 = s.wy[(r + 2) * WY_W + c + 1] * (l[L_W] - l[0]);
      const float l2 = s.ra[p] * ((tx0 - tx1) + (ty0 - ty1));
      out[(j0 + r) * n + i0 + c] = qa[(r + 1) * QX_W + c + 2] - a.c8 * l2;
    }
  }
}

}  // namespace

// q [F, nz, n, n]; tabx, taby [F, N, N] int32 (scalar_gather_flat, fill x
// and y); apx, apy [F, N, N]; out [F, nz, n, n]; float32, contiguous.
// Each block filters `lv` levels.  Returns cudaGetLastError() after the
// launch; -1 for h < 2 or more than 65535 (face, run) pairs.
extern "C" int fv3_del4(const float* q, const int* tabx, const int* taby,
                        const float* apx, const float* apy, float* out,
                        int F, int nz, int n, int h, int lv, float c8,
                        void* stream) {
  if (h < 2 || lv < 1) return -1;
  const int runs = (nz + lv - 1) / lv;
  if ((long long)F * runs > 65535) return -1;
  Args a{q, nullptr, apx, apy, tabx, taby, out, nz, n, h, lv, runs, c8};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, F * runs);
  del4<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// qx, qy [F, nz, N, N] (N = n + 2h): the x-fill and y-fill exchanges of
// q; apx, apy [F, N, N]; out [F, nz, n, n]; float32, contiguous.  Same
// return codes as fv3_del4.
extern "C" int fv3_del4_pair(const float* qx, const float* qy,
                             const float* apx, const float* apy, float* out,
                             int F, int nz, int n, int h, int lv, float c8,
                             void* stream) {
  if (h < 2 || lv < 1) return -1;
  const int runs = (nz + lv - 1) / lv;
  if ((long long)F * runs > 65535) return -1;
  Args a{qx, qy, apx, apy, nullptr, nullptr, out, nz, n, h, lv, runs, c8};
  const dim3 grid((n + TX - 1) / TX, (n + TY - 1) / TY, F * runs);
  del4<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
