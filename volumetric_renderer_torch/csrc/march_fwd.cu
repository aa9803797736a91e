// Forward ray march (K1) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel `_make_kernel` in
// volumetric_renderer_tpu/kernels/slab.py (launched by make_slab_renderer).
// The TPU kernel streamed the grid through VMEM in z-slabs and turned every
// trilinear and TF fetch into one-hot matmuls, because a TPU has no gather
// unit.  A GPU thread can load any voxel, so this kernel is ray-major: one
// thread marches one ray from its box entry to its exit.
//
// What it computes, per ray, for k = 0 .. num_steps-1 (the contract of
// core/fused.py:march_prepared, which is this kernel's plain version):
//   sample step k as march_common.cuh:sample_step does (position, box and
//   slicing tests, the depth-chunk ownership test, trilinear, window, TF
//   lerp); a step another chunk owns is skipped like one outside the
//   slicing window;
//   a = min(rgba.a, amax);  rgb += T*a*rgba.rgb;  T *= 1 - a;
//   with early termination, stop once T <= eps.
// Output: (rgb, 1 - T) on hit rays, (0, 0, 0, 0) on misses.
//
// Both early exits are exact.  Each coordinate of pos is monotone in k
// under round-to-nearest, so a ray that has left the box never re-enters,
// and T never grows.  Masked steps of the plain version add exactly 0.
//
// The operations are those of the plain version, in the same order, and the
// library is built with -fmad=false: no multiply-add is contracted, so the
// strict inside/slicing comparisons and the floor() bins match the plain
// version bit for bit.  Never build with --use_fast_math.
//
// Design on the card:
//   * 16x16-pixel blocks, one thread per ray: neighbouring rays terminate
//     at similar steps, which keeps the warps coherent; the image edge is
//     masked.  Rays are independent, so nothing carries between blocks.
//   * The TF table (ntf x 4 floats, 4 KB at ntf = 256) sits in shared
//     memory.  Voxels are read straight from global memory in f32 with
//     __ldg and 64-bit offsets.  tex3D's hardware filter is not used: its
//     weights carry 8 fractional bits, far outside a 1e-5 bar.
//   * What bounds it: the 8 dependent global gathers per step.  A 256^3
//     f32 grid is 64 MiB, more than the 50 MB L2, so a step's gathers
//     miss L2 where neighbouring rays do not share voxels.
//   * Later work: a z-order or brick layout for gather locality, a bf16
//     grid, bricks staged in shared memory.

#include "march_common.cuh"

namespace {

using march::kTile;

__global__ void __launch_bounds__(kTile * kTile)
    march_fwd_kernel(const float* __restrict__ pos0,
                     const float* __restrict__ dirs,
                     const unsigned char* __restrict__ hit,
                     const float* __restrict__ vol, march::Grid grid,
                     const float* __restrict__ tf, int ntf,
                     float* __restrict__ out, int height, int width,
                     march::Window win, int num_steps, float dt,
                     int early_termination, float eps, float amax) {
  extern __shared__ float tf_s[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < ntf * 4; i += blockDim.x * blockDim.y) {
    tf_s[i] = tf[i];
  }
  __syncthreads();

  const int px = blockIdx.x * kTile + threadIdx.x;
  const int py = blockIdx.y * kTile + threadIdx.y;
  if (px >= width || py >= height) return;
  const int64_t ray = static_cast<int64_t>(py) * width + px;

  float r = 0.0f, g = 0.0f, b = 0.0f, tr = 1.0f;
  if (hit[ray]) {
    const march::Ray rr = march::load_ray(pos0, dirs, ray);
    march::Sample s;
    for (int k = 0; k < num_steps; ++k) {
      if (early_termination && !(tr > eps)) break;
      const int kind =
          march::sample_step(vol, grid, tf_s, ntf, rr, win, k, dt, s);
      if (kind == march::kLeftBox) break;
      if (kind != march::kSampled) continue;
      const float a = march::clamp_alpha(s.a, amax);
      const float ta = tr * a;
      r = r + ta * s.r;
      g = g + ta * s.g;
      b = b + ta * s.b;
      tr = tr * (1.0f - a);
    }
    reinterpret_cast<float4*>(out)[ray] = make_float4(r, g, b, 1.0f - tr);
  } else {
    reinterpret_cast<float4*>(out)[ray] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of `device` may opt in to.
int march_fwd_max_dynamic_smem(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* march_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the march on `stream` and returns cudaGetLastError().  All
// pointers are device pointers; pos0 and dirs are (height*width, 3), hit is
// (height*width,) of 0/1 bytes, vol is (nz, ny, nx), tf is (ntf, 4) and out
// is (height, width, 4), all contiguous and 16-byte aligned where float4.
// own_axis < 0 marches the whole volume; else vol is the depth chunk that
// march_common.cuh:make_grid describes (own_start, own_body, own_total).
int march_fwd_launch(int device, const float* pos0, const float* dirs,
                     const unsigned char* hit, const float* vol, int nz,
                     int ny, int nx, int own_axis, int own_start,
                     int own_body, int own_total, const float* tf, int ntf,
                     float* out, int height, int width, float dmin,
                     float inv_w, float sx0, float sy0, float sz0, float sx1,
                     float sy1, float sz1, int num_steps, float dt,
                     int early_termination, float eps, float amax,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(ntf) * 4 * sizeof(float);
  err = march::allow_dynamic_smem(march_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const march::Window win{dmin, inv_w, sx0, sy0, sz0, sx1, sy1, sz1};
  const march::Grid vgrid = march::make_grid(nz, ny, nx, own_axis, own_start,
                                             own_body, own_total);
  const dim3 block(kTile, kTile);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  march_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos0, dirs, hit, vol, vgrid, tf, ntf, out, height, width, win,
      num_steps, dt, early_termination, eps, amax);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
