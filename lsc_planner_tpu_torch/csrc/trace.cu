// The tracer's stage stamp (trace.py): one thread writes the device's global
// nanosecond timer (%globaltimer) into its own int64 slot.  Launched on the
// stream between two stages, it runs once the kernels before it are done,
// so consecutive stamps bound a stage's device time.  A stamp launched
// while a stream captures a CUDA graph is a node of that graph, and every
// replay rewrites its slot.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace

extern "C" int lsc_trace_stamp(void* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slot));
  return static_cast<int>(cudaGetLastError());
}
