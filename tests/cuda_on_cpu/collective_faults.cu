// Kernels that hold the CPU stand-in (cuda_runtime.h) to its contract on
// faults: tests/test_torch_kernels.py compiles this file against it and
// launches each case of one_warp_launch on one warp of 32 threads.
//   case 0: every lane calls the collective: the launch succeeds and out[0]
//           holds the ballot of all 32 lanes;
//   case 1: lane 0 alone calls the collective, which the other 31 lanes
//           never reach: the launch must fail within the stand-in's
//           barrier timeout, not hang;
//   case 2: lane 0 returns early and the other lanes meet at
//           __syncthreads: an exited thread holds no barrier up, so the
//           launch succeeds and out[0] counts the 31 lanes.

#include <cuda_runtime.h>

namespace {

__global__ void one_warp_kernel(int which, int* out) {
  const int lane = threadIdx.x & 31;
  if (which == 0) {
    const unsigned bits = __ballot_sync(0xffffffffu, 1);
    if (lane == 0) out[0] = static_cast<int>(bits);
  } else if (which == 1) {
    if (lane == 0) out[0] = static_cast<int>(__ballot_sync(0xffffffffu, 1));
  } else {
    if (lane == 0) return;
    atomicAdd(out, 1);
    __syncthreads();
  }
}

}  // namespace

extern "C" int one_warp_launch(int which, int* out) {
  one_warp_kernel<<<dim3(1), dim3(32), 0, nullptr>>>(which, out);
  return static_cast<int>(cudaGetLastError());
}
