// K7 and K8: the toolchain probes, for Hopper.
//
// Replace the TPU kernels of tools/probe_pallas.py: K7 `f` (body `kern`),
// y = x * 2 + 1, and K8 `g` (body `stenc`), the periodic 3-point lane
// stencil y = x + roll(x, 1, axis=1) + roll(x, -1, axis=1), on a
// [rows, cols] float32 array ([256, 256] in the probe).  They compute what
// the plain fv3net_tpu_torch/probe.py::affine_plain and ::stencil_plain
// compute, bit for bit: x * 2 is exact, so the fused x * 2 + 1 rounds as
// the plain two operations do, and the stencil adds in the plain order
// (x + left) + right.
//
// Bound on the card: the bytes (each element read once and written once;
// 2 GiB at [16384, 16384], 0.64 ms at 3.35 TB/s), and below ~1 MB the
// launch.  The Pallas kernels held the array in VMEM as one block; here
// the array streams through registers, 16-byte vectors (float4) where
// the alignment allows, with streaming cache hints (each element is
// touched once):
// - K7: a grid-stride loop over tiles of kUnroll x kThreads float4 of the
//   aligned body of the array, kUnroll vectors in flight a thread; the
//   scalar head before the first 16-byte boundary of x and the tail after
//   the last whole vector go through a scalar grid-stride loop.  The
//   wrapper gives y the alignment of x (mod 16 bytes), so both are
//   vectors.
// - K8: warps walk (row, group) pairs, a row offset in 64 bits and a
//   column in 32, so no element needs a 64-bit division.  A lane holds
//   one chunk of V consecutive columns (a float4 where the rows start on
//   16-byte boundaries, else one float) in each of a group's kUnroll
//   segments of 32 chunks; a chunk's left and right neighbours come from
//   the adjacent lanes' registers (__shfl_up_sync / __shfl_down_sync), and
//   only a segment's edge lanes, and the chunk at the row's wrap, load one
//   more element, issued with the group's other loads.  Shuffles rather
//   than a shared-memory row tile: the warp is the unit, so nothing is
//   shared between warps and no __syncthreads is needed, and the edge
//   loads hit the lines the neighbouring lanes read.
// The launch plans (head, vectors, warps a row, blocks) are computed by
// probe.py::affine_plan and ::stencil_plan, which the CPU tests walk
// thread by thread (tests/test_torch_probe_plan.py): the grid covers the
// work, up to a cap of waves of the blocks the card holds at once
// (fv3_probe_resident), beyond which the grid-stride loops take the rest.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block, both kernels
constexpr int kUnroll = 4;     // vectors (K7) or segments (K8) a thread
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 affine4(float4 v) {
  return make_float4(v.x * 2.f + 1.f, v.y * 2.f + 1.f, v.z * 2.f + 1.f,
                     v.w * 2.f + 1.f);
}

// y[e] = x[e] * 2 + 1: the float4 body [head, head + 4 nvec), 16-byte
// aligned in x and y, in tiles of kUnroll x kThreads vectors, block b
// taking tiles b, b + gridDim.x, ... (the last, partial tile by its
// block's threads in turn); then the scalar rest [0, head) and
// [head + 4 nvec, n)
__global__ void __launch_bounds__(kThreads)
affine_kernel(const float* __restrict__ x, float* __restrict__ y,
              long long n, long long head, long long nvec) {
  constexpr int kTile = kUnroll * kThreads;
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
  float4* __restrict__ yv = reinterpret_cast<float4*>(y + head);
  long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  for (; i - threadIdx.x + kTile <= nvec; i += (long long)gridDim.x * kTile) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(xv + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      __stcs(yv + i + u * kThreads, affine4(v[u]));
    }
  }
  for (; i < nvec; i += kThreads) __stcs(yv + i, affine4(__ldcs(xv + i)));
  const long long body = 4 * nvec;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < n - body; r += stride) {
    const long long e = r < head ? r : r + body;
    y[e] = x[e] * 2.f + 1.f;
  }
}

template <int V>
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void store_chunk(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// y = (x + left) + right along each row, periodic.  Warp w of the grid
// takes rows w / k, w / k + W / k, ... (W warps, k = warps_per_row) and,
// in each, the groups of kUnroll x 32 chunks w % k, w % k + k, ...; warps
// past (W / k) k idle.  V = 4 needs cols % 4 == 0 and x, y 16-byte aligned.
template <int V>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ x, float* __restrict__ y,
               long long rows, int cols, int warps_per_row) {
  constexpr int kSpan = kUnroll * kWarp;  // chunks a group
  const int lane = threadIdx.x % kWarp;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int row_warps = gridDim.x * (kThreads / kWarp) / warps_per_row;
  if (warp >= row_warps * warps_per_row) return;  // whole warps
  const int nch = cols / V;
  for (long long r = warp / warps_per_row; r < rows; r += row_warps) {
    const float* __restrict__ xr = x + r * cols;
    float* __restrict__ yr = y + r * cols;
    for (long long g = (long long)(warp % warps_per_row) * kSpan; g < nch;
         g += (long long)warps_per_row * kSpan) {
      // every load of the group first (the edge lanes' with the rest)
      float v[kUnroll][V], edge_l[kUnroll], edge_r[kUnroll];
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        const long long ch = g + s * kWarp + lane;
        if (ch < nch) {
          const int c = (int)ch * V;  // the chunk's first column
          load_chunk<V>(xr + c, v[s]);
          if (lane == 0) edge_l[s] = xr[c == 0 ? cols - 1 : c - 1];
          if (lane == kWarp - 1 || c + V == cols) {
            edge_r[s] = xr[c + V == cols ? 0 : c + V];
          }
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[s][j] = 0.f;
        }
      }
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        const long long ch = g + s * kWarp + lane;
        float left = __shfl_up_sync(kFull, v[s][V - 1], 1);
        float right = __shfl_down_sync(kFull, v[s][0], 1);
        if (ch < nch) {
          const int c = (int)ch * V;
          if (lane == 0) left = edge_l[s];
          if (lane == kWarp - 1 || c + V == cols) right = edge_r[s];
          float out[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float l = j == 0 ? left : v[s][j - 1];
            const float rt = j == V - 1 ? right : v[s][j + 1];
            out[j] = (v[s][j] + l) + rt;
          }
          store_chunk<V>(yr + c, out);
        }
      }
    }
  }
}

}  // namespace

// Blocks of one kernel the card holds at once on the current device
// (SMs x resident blocks): 0 K7, 1 K8 on float4 chunks, 2 K8 on single
// columns; a negative CUDA error code on failure.
extern "C" int fv3_probe_resident(int which) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = which == 0
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, affine_kernel,
                                                      kThreads, 0)
      : which == 1
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, stencil_kernel<4>, kThreads, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, stencil_kernel<1>, kThreads, 0);
  }
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

// Each returns cudaGetLastError() after its launch (0 on success); the
// plan comes from probe.py (affine_plan, stencil_plan).
extern "C" int fv3_probe_affine(const float* x, float* y, long long n,
                                long long head, long long nvec, int blocks,
                                void* stream) {
  affine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n, head, nvec);
  return (int)cudaGetLastError();
}

extern "C" int fv3_probe_stencil(const float* x, float* y, long long rows,
                                 int cols, int vec, int warps_per_row,
                                 int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    stencil_kernel<4><<<blocks, kThreads, 0, s>>>(x, y, rows, cols,
                                                  warps_per_row);
  } else {
    stencil_kernel<1><<<blocks, kThreads, 0, s>>>(x, y, rows, cols,
                                                  warps_per_row);
  }
  return (int)cudaGetLastError();
}
