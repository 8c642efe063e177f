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
// Bound on the card: launch latency.  A [256, 256] array is 256 KB, read
// and written in well under a microsecond at 3.35 TB/s.  The Pallas
// kernels held the array in VMEM as one block; here one thread owns one
// element (the stencil reads its two lane neighbours, modulo cols, from
// L1), so each probe is one launch with no shared state, which is what a
// toolchain probe should exercise: build, launch, read back.

#include <cuda_runtime.h>

namespace {

__global__ void affine_kernel(const float* __restrict__ x,
                              float* __restrict__ y, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) y[t] = x[t] * 2.f + 1.f;
}

__global__ void stencil_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int rows, int cols) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * cols) return;
  const int i = (int)(t % cols);
  const float* row = x + (t - i);
  const float left = row[i == 0 ? cols - 1 : i - 1];   // roll(x, 1)
  const float right = row[i == cols - 1 ? 0 : i + 1];  // roll(x, -1)
  y[t] = (x[t] + left) + right;
}

constexpr int kThreads = 256;

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success).
extern "C" int fv3_probe_affine(const float* x, float* y, long long n,
                                void* stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  affine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return (int)cudaGetLastError();
}

extern "C" int fv3_probe_stencil(const float* x, float* y, int rows,
                                 int cols, void* stream) {
  const long long n = (long long)rows * cols;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  stencil_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, rows, cols);
  return (int)cudaGetLastError();
}
