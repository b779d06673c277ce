// launch_floor: an empty kernel, built and bound like K1-K13 and launched
// through the same ctypes path, so that its time on the card is the least a
// launch of any of them can take (kernels.launch_floor; chip_smoke.py's
// [launch-floor] line).  It replaces no TPU kernel and no path runs it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One block of one warp on the given stream.  Returns the launch's
// cudaGetLastError() code.
extern "C" int ltr_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
