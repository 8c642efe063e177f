// K5: conservative cubic-spline PPM vertical remap (mappm) for Hopper.
//
// Replaces the TPU kernel fv3net_tpu/ops/pallas_remap.py::ppm_remap_pallas
// (bodies _remap_kernel, _edge_spline_kernel, _cs_profile_block) and
// computes what the plain fv3net_tpu_torch/ops/remap.py::remap_levels_plain
// computes (ppm_remap with exact_boundaries=True): per column, the
// standard tridiagonal edge spline, the cs_profile edge constraints and
// limiters for kord 9, 10 or the unlimited kord > 16 with iv 1, 0 or
// -1, and the integral of the parabolas over every (source layer, target
// layer) overlap, summed into the target layer means.  Layout:
// q1 [F, km, Y, X], pe1 [Fp, km+1, Y, X], pe2 [Fp, kn+1, Y, X] ->
// q2 [F, kn, Y, X], f32, where field f uses pressure face f % Fp (a stack
// of tracers is one launch against one pressure grid).
//
// Bound on the card: latency and occupancy, not bytes.  At C192 (Y, X =
// 192..193) one call moves ~56 MB per operand (4 operands, ~70 us at
// 3.35 TB/s), but each column is a chain of dependent level steps (two
// spline sweeps, the limiter walk) and a dense km x kn overlap test
// (63 x 63 per column over ~221k columns).  The Pallas kernel held a
// (face, 8-row) block in VMEM; here one thread owns one column
// (neighbouring threads take neighbouring x, so every per-level access is
// one coalesced row):
//   1. forward sweep of the edge spline, its values and factors into a
//      wrapper-allocated global scratch (qe, gam) laid out like the
//      fields, then the back substitution in place;
//   2. one walk down the column with a sliding window of three cells'
//      pre-limiter state (a, al, ar, extremum flags) applying the edge
//      constraints, the kord 9/10 interior constraint and the boundary
//      limiters, writing (al, ar-al, a6) to shared memory;
//   3. for every target layer, the dense walk over all source layers of
//      the TPU kernel, from shared memory (per-thread columns, level-major,
//      so bank-conflict free); a layer without overlap adds nothing and
//      is skipped.  One read of pe2 and one write of q2.
// Every product is rounded on its own (mul() below, never fused into an
// FMA), in the plain torch form's order of operations: the limiters then
// take the same branches as the plain version on the card (they compare
// values that clamping often makes exactly equal), and the integration's
// terms are the plain version's -- without a limiter (kord > 16) the
// parabolas of a noisy column reach ~1e4 times the layer means, and any
// other rounding of their cancelling terms shows in the result.
// Tiling for occupancy and an O(km+kn) merge walk are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnlimited = 17;  // kord > 16: no constraints at all
// ops/remap.py::THIRD
constexpr float kThird = 1.f / 3.f;

// a * b rounded on its own (never contracted into an FMA)
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float mono(float q, float a, float b) {
  return clampf(q, fminf(a, b), fmaxf(a, b));
}

struct Args {
  const float *q1, *pe1, *pe2;
  float *q2, *qe, *gam;
  int F, Fp, km, kn, ncol;
};

// One column's strided views.
struct Col {
  const float* q;    // q1 + f*km*ncol + col
  const float* p1;   // pe1 + fp*(km+1)*ncol + col
  const float* p2;   // pe2 + fp*(kn+1)*ncol + col
  float* out;        // q2 + f*kn*ncol + col
  float* qe;         // scratch [F, km+1, ncol]
  float* gam;        // scratch [F, km, ncol]
  int ncol;
  __device__ __forceinline__ float a(int k) const {
    return q[(long long)k * ncol];
  }
};

// (a, al, ar) of one cell and its extremum flags before the limiters.
struct Cell {
  float a, al, ar;
  bool extm, ext5, ext6;
};

// (al, ar, a6) of one cell.
struct Par {
  float al, ar, a6;
};

__device__ __forceinline__ Par flatten(float a) { return {a, a, 0.f}; }

// 3 (2a - (al + ar))
__device__ __forceinline__ float a6_of(float a, float al, float ar) {
  return mul(3.f, mul(2.f, a) - (al + ar));
}

// ops/remap.py::_standard_ppm_constraint
__device__ __forceinline__ Par standard_ppm(float a, Par p) {
  const float da1 = p.ar - p.al;
  const float da2 = mul(da1, da1);
  const float a6da = mul(p.a6, da1);
  if (a6da < -da2) {
    const float a6 = mul(3.f, p.al - a);
    return {p.al, p.al - a6, a6};
  }
  if (a6da > da2) {
    const float a6 = mul(3.f, p.ar - a);
    return {p.ar - a6, p.ar, a6};
  }
  return p;
}

// ops/remap.py::cs_limiters, modes 0 (positive), 1 (monotone), 2 (extm)
template <int MODE>
__device__ __forceinline__ Par cs_limiters(float a, Par p, bool extm) {
  if (MODE == 1) {
    if (mul(a - p.al, a - p.ar) >= 0.f) return flatten(a);
    return standard_ppm(a, p);
  }
  if (MODE == 2) {
    if (extm) return flatten(a);
    return standard_ppm(a, p);
  }
  // MODE 0
  if (a <= 0.f) return flatten(a);
  const float da1 = p.ar - p.al;
  const bool has_min = fabsf(da1) < -p.a6;
  const float safe_a6 = p.a6 == 0.f ? 1.f : p.a6;
  const float fmin = a + mul(mul(0.25f, da1), da1) / safe_a6 +
                     mul(p.a6, (float)(1.0 / 12.0));
  if (!(has_min && fmin < 0.f)) return p;
  if (a < p.ar && a < p.al) return flatten(a);
  if (p.ar > p.al) {
    const float a6 = mul(3.f, p.al - a);
    return {p.al, p.al - a6, a6};
  }
  const float a6 = mul(3.f, p.ar - a);
  return {p.ar - a6, p.ar, a6};
}

// Edge e after the large-scale constraints (ops/remap.py::cs_profile).
template <int IV>
__device__ float edge(const Col& c, int e, int km) {
  const float raw = c.qe[(long long)e * c.ncol];
  if (e == 1) return mono(raw, c.a(0), c.a(1));
  if (e >= 2 && e <= km - 2) {
    const float lo = c.a(e - 1), hi = c.a(e);
    const float dAm = lo - c.a(e - 2);  // dA[e-1]
    const float dAp = c.a(e + 1) - hi;  // dA[e+1]
    if (mul(dAm, dAp) > 0.f) return mono(raw, lo, hi);
    if (dAm > 0.f) return fmaxf(raw, fminf(lo, hi));
    const float m = fminf(raw, fmaxf(lo, hi));
    return IV == 0 ? fmaxf(m, 0.f) : m;
  }
  if (e == km - 1) return mono(raw, c.a(km - 2), c.a(km - 1));
  return raw;
}

template <int IV>
__device__ Cell cell(const Col& c, int k, int km) {
  Cell s;
  s.a = c.a(k);
  s.al = edge<IV>(c, k, km);
  s.ar = edge<IV>(c, k + 1, km);
  if (k == 0 || k == km - 1) {
    s.extm = mul(s.al - s.a, s.ar - s.a) > 0.f;
  } else {
    s.extm = mul(s.a - c.a(k - 1), c.a(k + 1) - s.a) < 0.f;
  }
  const float x0 = mul(2.f, s.a) - (s.al + s.ar);
  const float x1 = fabsf(s.al - s.ar);
  s.ext5 = fabsf(x0) > x1;
  s.ext6 = fabsf(mul(3.f, x0)) > x1;
  return s;
}

// kord 9 / 10 constraint of an interior cell k (2 <= k <= km-3).
template <int KORD>
__device__ Par interior(const Col& c, int k, const Cell& m, const Cell& s,
                        const Cell& p) {
  const float a = s.a, al = s.al, ar = s.ar;
  const float dA = a - c.a(k - 1);
  const float dA_m1 = c.a(k - 1) - c.a(k - 2);
  const float dA_p1 = c.a(k + 1) - a;
  const float dA_p2 = c.a(k + 2) - c.a(k + 1);
  // ops/remap.py::_huynh_edges
  const float pmp_1 = a - mul(2.f, dA_p1);
  const float lac_1 = pmp_1 + mul(1.5f, dA_p2);
  const float hal = clampf(al, fminf(fminf(a, pmp_1), lac_1),
                           fmaxf(fmaxf(a, pmp_1), lac_1));
  const float pmp_2 = a + mul(2.f, dA);
  const float lac_2 = pmp_2 - mul(1.5f, dA_m1);
  const float har = clampf(ar, fminf(fminf(a, pmp_2), lac_2),
                           fmaxf(fmaxf(a, pmp_2), lac_2));
  if (KORD == 9) {
    if ((s.extm && m.extm) || (s.extm && p.extm)) return flatten(a);
    const float a6_g = mul(6.f, a) - mul(3.f, al + ar);
    const bool nonmono = fabsf(a6_g) > fabsf(al - ar);
    const float l = nonmono ? hal : al;
    const float r = nonmono ? har : ar;
    return {l, r, mul(6.f, a) - mul(3.f, l + r)};
  }
  // KORD == 10
  const bool nb5 = m.ext5 || p.ext5;
  const bool nb6 = m.ext6 || p.ext6;
  float l = al, r = ar;
  if (s.ext5 && nb5) {
    l = a;
    r = a;
  } else if ((s.ext5 && nb6) || (s.ext6 && nb5)) {
    l = hal;
    r = har;
  }
  return {l, r, a6_of(a, l, r)};
}

template <int IV, int KORD>
__global__ void remap_kernel(Args g) {
  extern __shared__ float sm[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.F * g.ncol) return;
  const int km = g.km, kn = g.kn, B = blockDim.x, tid = threadIdx.x;
  const int f = t / g.ncol, col = t % g.ncol, fp = f % g.Fp;
  const long long nc = g.ncol;
  Col c{g.q1 + (long long)f * km * nc + col,
        g.pe1 + (long long)fp * (km + 1) * nc + col,
        g.pe2 + (long long)fp * (kn + 1) * nc + col,
        g.q2 + (long long)f * kn * nc + col,
        g.qe + (long long)f * (km + 1) * nc + col,
        g.gam + (long long)f * km * nc + col,
        g.ncol};
  // per-thread shared columns: pe1 [km+1], al [km], ar-al [km], a6 [km]
  float* s_pe = sm + tid;
  float* s_al = sm + (km + 1) * B + tid;
  float* s_dal = s_al + km * B;
  float* s_a6 = s_dal + km * B;
#define SPE(k) s_pe[(k) * B]

  // --- 1. edge spline (ops/remap.py::_edge_spline, standard variant) --
  for (int k = 0; k <= km; ++k) SPE(k) = c.p1[(long long)k * nc];
  {
    const float dp0 = SPE(1) - SPE(0), dp1 = SPE(2) - SPE(1);
    const float grat = dp1 / dp0;
    const float bet0 = mul(grat, grat + 0.5f);
    float q = (mul(mul(grat + grat, grat + 1.f), c.a(0)) + c.a(1)) / bet0;
    float gm = (1.f + mul(grat, grat + 1.5f)) / bet0;
    c.qe[0] = q;
    c.gam[0] = gm;
    float dp_prev = dp0, a_prev = c.a(0);
    for (int e = 1; e < km; ++e) {
      const float dpe = SPE(e + 1) - SPE(e);
      const float ae = c.a(e);
      const float d4 = dp_prev / dpe;
      const float bet = 2.f + d4 + d4 - gm;
      q = (mul(3.f, a_prev + mul(d4, ae)) - q) / bet;
      gm = d4 / bet;
      c.qe[(long long)e * nc] = q;
      c.gam[(long long)e * nc] = gm;
      dp_prev = dpe;
      a_prev = ae;
    }
    const float d4b = (SPE(km - 1) - SPE(km - 2)) / (SPE(km) - SPE(km - 1));
    const float a_bot = 1.f + mul(d4b, d4b + 1.5f);
    float qn = (mul(mul(mul(2.f, d4b), d4b + 1.f), c.a(km - 1)) +
                c.a(km - 2) - mul(a_bot, q)) /
               (mul(d4b, d4b + 0.5f) - mul(a_bot, gm));
    c.qe[(long long)km * nc] = qn;
    for (int e = km - 1; e >= 0; --e) {
      qn = c.qe[(long long)e * nc] - mul(c.gam[(long long)e * nc], qn);
      c.qe[(long long)e * nc] = qn;
    }
  }

  // --- 2. cs_profile (ops/remap.py::cs_profile) ------------------------
  if (KORD == kUnlimited) {
    for (int k = 0; k < km; ++k) {
      const float al = c.qe[(long long)k * nc];
      const float ar = c.qe[(long long)(k + 1) * nc];
      s_al[k * B] = al;
      s_dal[k * B] = ar - al;
      s_a6[k * B] = a6_of(c.a(k), al, ar);
    }
  } else {
    Cell cm, c0 = cell<IV>(c, 0, km), cp = cell<IV>(c, 1, km);
    for (int k = 0; k < km; ++k) {
      if (k > 0) {
        cm = c0;
        c0 = cp;
        if (k + 1 < km) cp = cell<IV>(c, k + 1, km);
      }
      const float a = c0.a;
      Par p;
      if (k == 0) {
        float al = c0.al;
        if (IV == 0) al = fmaxf(al, 0.f);
        if (IV == -1 && mul(al, a) <= 0.f) al = 0.f;
        p = cs_limiters<1>(a, Par{al, c0.ar, a6_of(a, al, c0.ar)}, c0.extm);
      } else if (k == 1 || k == km - 2) {
        p = cs_limiters<2>(a, Par{c0.al, c0.ar, a6_of(a, c0.al, c0.ar)},
                           c0.extm);
      } else if (k == km - 1) {
        float ar = c0.ar;
        if (IV == 0) ar = fmaxf(ar, 0.f);
        if (IV == -1 && mul(ar, a) <= 0.f) ar = 0.f;
        p = cs_limiters<1>(a, Par{c0.al, ar, a6_of(a, c0.al, ar)}, c0.extm);
      } else {
        p = interior<KORD>(c, k, cm, c0, cp);
        if (IV == 0) p = cs_limiters<0>(a, p, c0.extm);
      }
      s_al[k * B] = p.al;
      s_dal[k * B] = p.ar - p.al;
      s_a6[k * B] = p.a6;
    }
  }

  // --- 3. the parabolas integrated over every layer overlap ------------
  // (ops/remap.py::ppm_remap; s at both edges of the overlap, and the
  // constant extensions above top and below bot)
  const float top = SPE(0), bot = SPE(km);
  const float q_top = c.a(0), q_bot = c.a(km - 1);
  float pa = c.p2[0];
  float pca = clampf(pa, top, bot);
  for (int j = 0; j < kn; ++j) {
    const float pb = c.p2[(long long)(j + 1) * nc];
    const float pcb = clampf(pb, top, bot);
    float m = 0.f;
    for (int k = 0; k < km; ++k) {
      const float pk = SPE(k), pk1 = SPE(k + 1);
      const float ov = fminf(pcb, pk1) - fmaxf(pca, pk);
      if (!(ov > 0.f)) continue;  // no overlap: the plain form adds 0
      const float dp = pk1 - pk;
      const float dps = dp > 0.f ? dp : 1.f;
      const float sa = clampf((pca - pk) / dps, 0.f, 1.f);
      const float sb = clampf((pcb - pk) / dps, 0.f, 1.f);
      const float ss = sa + sb;
      const float sq = mul(sa, sa) + mul(sa, sb) + mul(sb, sb);
      const float mean =
          s_al[k * B] + mul(mul(0.5f, s_dal[k * B]), ss) +
          mul(s_a6[k * B], mul(0.5f, ss) - mul(sq, kThird));
      m += mul(ov, mean);
    }
    m += mul(q_top, fminf(pb, top) - fminf(pa, top));
    m += mul(q_bot, fmaxf(pb, bot) - fmaxf(pa, bot));
    c.out[(long long)j * nc] = m / (pb - pa);
    pa = pb;
    pca = pcb;
  }
#undef SPE
}

template <int IV, int KORD>
int launch(const Args& g, cudaStream_t stream) {
  const size_t smem = (size_t)(4 * g.km + 1) * kThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      remap_kernel<IV, KORD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)g.F * g.ncol;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  remap_kernel<IV, KORD><<<blocks, kThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int IV>
int launch_kord(const Args& g, int kord, cudaStream_t s) {
  if (kord == 9) return launch<IV, 9>(g, s);
  if (kord == 10) return launch<IV, 10>(g, s);
  if (kord > 16) return launch<IV, kUnlimited>(g, s);
  return -1;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); -1 for an
// unsupported (iv, kord) or fewer than 4 source levels.
extern "C" int fv3_remap(const float* q1, const float* pe1, const float* pe2,
                         float* q2, float* qe, float* gam, int F, int Fp,
                         int km, int kn, int ncol, int iv, int kord,
                         void* stream) {
  if (km < 4) return -1;
  Args g{q1, pe1, pe2, q2, qe, gam, F, Fp, km, kn, ncol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (iv) {
    case 1: return launch_kord<1>(g, kord, s);
    case 0: return launch_kord<0>(g, kord, s);
    case -1: return launch_kord<-1>(g, kord, s);
    default: return -1;
  }
}
