// launch_floor — an empty kernel, launched through the same ctypes path as
// the port's kernels. It computes nothing and replaces no TPU kernel: its
// time under chip_smoke.py's timer is the floor below which no launch of a
// wrapper in kernels/ops.py can go, the yardstick for the kernels whose
// bytes take less time than their launch (embed_gather on the main path and
// at a decode step).
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int repro_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
