// The depth fold and its backward for NVIDIA Hopper, sm_90a.
//
// A depth-sharded frame marches each depth chunk of the grid into a partial
// image of premultiplied (rgb, alpha), one per rank, and folds the n
// partials per ray in the ray's march order with the over-operator
//   front OVER back = (rgb_f + (1 - a_f) * rgb_b, 1 - (1 - a_f) * (1 - a_b)):
// ascending chunk index where the ray's direction along the split axis is
// >= 0, descending where it is < 0.  The JAX package folds with
// volumetric_renderer_tpu/parallel/depth.py:68 composite_chunks, which XLA
// fuses (no Pallas kernel); the port's plain versions are
// kernels/fold.py:fold_forward_plain and fold_backward_plain.
//
// fold_fwd_kernel: the fold, with the operations of fold_forward_plain in
// its order.  The library is built with -fmad=false, so the result is the
// plain version's bit for bit.
//
// fold_bwd_kernel: the gradient of sum(fold * g) in chunk r's partial alone,
// the closed form of fold_backward_plain.  With T the product of (1 - a) of
// the chunks before r in the ray's march order and B the fold of those
// after it (transparent where none):
//   d rgb_r = T * g_rgb,   d a_r = T * ((1 - B_a) * g_a - g_rgb . B_rgb).
// It needs neither chunk r's own partial nor anything of another ray.
//
// Design on the card: the work is element-wise per ray over n <= 4
// partials, so both kernels are bound by memory, by the bytes each ray
// reads and writes (PERF.md §6).  One thread per ray, 256 to a block, one
// 16-byte float4 load per partial, with neighbouring threads on
// neighbouring rays; no shared memory: nothing is read twice.  The
// direction's one component along the split axis is the only irregular
// read (a 12-byte stride).  Measured on an H100 80GB HBM3 at 700 W: 0.487
// ms each on the device for the 4 chunks of an 8-view 1920x1080 frame
// (16.6 M rays), against 0.456 ms for their 92 bytes a ray at 3.35 TB/s.
//
// Layout: parts is (n, rays, 4) f32, contiguous, chunk c at c * rays; dirs
// is (rays, 3); out, g and grad are (rays, 4).  comp = 2 - axis picks the
// direction's component along array axis `axis` (0 z, 1 y, 2 x).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 over(const float4 f, const float4 b) {
  const float t = 1.0f - f.w;
  return make_float4(f.x + t * b.x, f.y + t * b.y, f.z + t * b.z,
                     1.0f - t * (1.0f - b.w));
}

__global__ void __launch_bounds__(kThreads)
    fold_fwd_kernel(const float4* __restrict__ parts, int n, long long rays,
                    const float* __restrict__ dirs, int comp,
                    float4* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rays) return;
  const bool reverse = dirs[3 * i + comp] < 0.0f;
  float4 acc = parts[(reverse ? n - 1 : 0) * rays + i];
  for (int k = 1; k < n; ++k) {
    acc = over(acc, parts[(reverse ? n - 1 - k : k) * rays + i]);
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
    fold_bwd_kernel(const float4* __restrict__ parts, int n, long long rays,
                    const float* __restrict__ dirs, int comp,
                    const float4* __restrict__ g, int r,
                    float4* __restrict__ grad) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rays) return;
  const bool reverse = dirs[3 * i + comp] < 0.0f;
  const int step = reverse ? -1 : 1;
  const int end = reverse ? -1 : n;
  // the chunks before r in march order: their transmittance
  float tr = 1.0f;
  for (int c = reverse ? n - 1 : 0; c != r; c += step) {
    tr = tr * (1.0f - parts[c * rays + i].w);
  }
  // the chunks after r, folded in march order
  float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int c = r + step;
  if (c != end) {
    b = parts[c * rays + i];
    for (c += step; c != end; c += step) b = over(b, parts[c * rays + i]);
  }
  const float4 gi = g[i];
  const float dot = gi.x * b.x + gi.y * b.y + gi.z * b.z;
  grad[i] = make_float4(tr * gi.x, tr * gi.y, tr * gi.z,
                        tr * ((1.0f - b.w) * gi.w - dot));
}

int blocks_for(long long rays) {
  return static_cast<int>((rays + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the fold on `stream` and returns cudaGetLastError().  All
// pointers are device pointers, 16-byte aligned; rays >= 1 and at most
// 2^31 - 1 blocks of 256.
int fold_fwd_launch(int device, const float* parts, int n, long long rays,
                    const float* dirs, int axis, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = blocks_for(rays);
  fold_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(parts), n, rays, dirs, 2 - axis,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward for chunk r (0 <= r < n) on `stream` and returns
// cudaGetLastError(); grad receives chunk r's (rays, 4) gradient.
int fold_bwd_launch(int device, const float* parts, int n, long long rays,
                    const float* dirs, int axis, const float* g, int r,
                    float* grad, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = blocks_for(rays);
  fold_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(parts), n, rays, dirs, 2 - axis,
      reinterpret_cast<const float4*>(g), r, reinterpret_cast<float4*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
