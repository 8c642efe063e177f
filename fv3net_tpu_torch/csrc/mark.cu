// The device marks of fv3net_tpu_torch/tracing.py: FV3's routine clocks
// (mpp_clock around c_sw, d_sw, Riem_Solver, tracer_2d, the remap) inside
// a replayed CUDA graph.
//
// Replaces no TPU kernel: the JAX package's dt is one XLA program that
// names no stage on the device.  A mark is one thread that appends (id,
// %globaltimer) to a log on the card: the cursor log[0] is taken with
// atomicAdd, and entry k (modulo the capacity) is log[2 + 2k] (the id)
// and log[3 + 2k] (ns).  Launched on the stream of the work it brackets,
// it runs after that stream's earlier kernels end and before its later
// ones start, so a graph that captured it stamps every replay.  Bound:
// the launch (a graph node, ~1-2 us of the card's time); it moves 16
// bytes.  The kernel is a template on the id (0..kIds-1), so a profiler
// trace names each mark, `fv3_mark<7>`, and tracing.attribute can place
// every other op of the trace between the marks.

#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kIds = 64;  // 2 ids a span of tracing.SPANS, 32 spans

namespace marks {

template <int Id>
__global__ void fv3_mark(unsigned long long* log,
                         unsigned long long capacity) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long k = atomicAdd(log, 1ull) % capacity;
  log[2 + 2 * k] = static_cast<unsigned long long>(Id);
  log[3 + 2 * k] = t;
}

}  // namespace marks

using Mark = void (*)(unsigned long long*, unsigned long long);

template <int... I>
Mark pick(int id, std::integer_sequence<int, I...>) {
  static const Mark table[] = {&marks::fv3_mark<I>...};
  return table[id];
}

}  // namespace

// One mark `id` on `stream`: log is the tracing log ([capacity + 1, 2]
// int64: the cursor, then the entries).  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fv3_mark(int id, void* log, long long capacity,
                        void* stream) {
  if (id < 0 || id >= kIds || capacity <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long* entries = static_cast<unsigned long long*>(log);
  unsigned long long cap = static_cast<unsigned long long>(capacity);
  void* args[] = {&entries, &cap};
  cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(
          pick(id, std::make_integer_sequence<int, kIds>{})),
      dim3(1), dim3(1), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
