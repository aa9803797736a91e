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
//   pos = pos0 + (float(k)*dt)*dir; stop once pos leaves [0,1]^3;
//   skip the step unless smin < pos < smax (strict, every axis);
//   d = CLAMP_TO_BORDER trilinear sample of vol at pos (texel centres at
//       (i+0.5)/N, transparent-black border);
//   t = (d - dmin) * inv_w;  rgba = CLAMP_TO_EDGE lerp of tf at t*ntf-0.5;
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;

__device__ __forceinline__ float voxel(const float* __restrict__ vol, int ix,
                                       int iy, int iz, int nx, int ny,
                                       int nz) {
  // CLAMP_TO_BORDER: a corner outside the grid reads transparent black.
  if (ix < 0 || ix >= nx || iy < 0 || iy >= ny || iz < 0 || iz >= nz) {
    return 0.0f;
  }
  const int64_t off =
      (static_cast<int64_t>(iz) * ny + iy) * static_cast<int64_t>(nx) + ix;
  return __ldg(vol + off);
}

__global__ void __launch_bounds__(kTile * kTile)
    march_fwd_kernel(const float* __restrict__ pos0,
                     const float* __restrict__ dirs,
                     const unsigned char* __restrict__ hit,
                     const float* __restrict__ vol, int nz, int ny, int nx,
                     const float* __restrict__ tf, int ntf,
                     float* __restrict__ out, int height, int width,
                     float dmin, float inv_w, float sx0, float sy0, float sz0,
                     float sx1, float sy1, float sz1, int num_steps, float dt,
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
    const float ox = pos0[ray * 3 + 0], oy = pos0[ray * 3 + 1],
                oz = pos0[ray * 3 + 2];
    const float dx = dirs[ray * 3 + 0], dy = dirs[ray * 3 + 1],
                dz = dirs[ray * 3 + 2];
    const float fnx = static_cast<float>(nx), fny = static_cast<float>(ny),
                fnz = static_cast<float>(nz), fntf = static_cast<float>(ntf);
    for (int k = 0; k < num_steps; ++k) {
      if (early_termination && !(tr > eps)) break;
      const float kdt = static_cast<float>(k) * dt;
      const float x = ox + kdt * dx, y = oy + kdt * dy, z = oz + kdt * dz;
      if (!(x >= 0.0f && x <= 1.0f && y >= 0.0f && y <= 1.0f && z >= 0.0f &&
            z <= 1.0f)) {
        break;  // left the unit cube: never re-enters
      }
      if (!(x < sx1 && x > sx0 && y < sy1 && y > sy0 && z < sz1 &&
            z > sz0)) {
        continue;  // outside the slicing window
      }

      // Trilinear, corners summed in the plain version's order (z, y, x).
      const float fx = x * fnx - 0.5f, fy = y * fny - 0.5f,
                  fz = z * fnz - 0.5f;
      const float x0f = floorf(fx), y0f = floorf(fy), z0f = floorf(fz);
      const float wx = fx - x0f, wy = fy - y0f, wz = fz - z0f;
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f),
                z0 = static_cast<int>(z0f);
      float density = 0.0f;
#pragma unroll
      for (int cz = 0; cz < 2; ++cz) {
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
          for (int cx = 0; cx < 2; ++cx) {
            const float v = voxel(vol, x0 + cx, y0 + cy, z0 + cz, nx, ny, nz);
            const float weight = (cx ? wx : 1.0f - wx) *
                                 (cy ? wy : 1.0f - wy) *
                                 (cz ? wz : 1.0f - wz);
            density = density + v * weight;
          }
        }
      }

      // CLAMP_TO_EDGE TF lerp.  The float clamp to [-1, ntf] before the
      // int conversion changes no bin and keeps a huge t in range.
      const float t = (density - dmin) * inv_w;
      const float tx = t * fntf - 0.5f;
      const float i0f = floorf(tx);
      const float w = tx - i0f;
      const int i0 = static_cast<int>(fminf(fmaxf(i0f, -1.0f), fntf));
      const int lo = min(max(i0, 0), ntf - 1);
      const int hi = min(max(i0 + 1, 0), ntf - 1);
      const float* tlo = tf_s + lo * 4;
      const float* thi = tf_s + hi * 4;
      const float cr = tlo[0] * (1.0f - w) + thi[0] * w;
      const float cg = tlo[1] * (1.0f - w) + thi[1] * w;
      const float cb = tlo[2] * (1.0f - w) + thi[2] * w;
      const float ca = tlo[3] * (1.0f - w) + thi[3] * w;
      const float a = (ca > amax) ? amax : ca;  // NaN propagates, as clamp
      const float ta = tr * a;
      r = r + ta * cr;
      g = g + ta * cg;
      b = b + ta * cb;
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
int march_fwd_launch(int device, const float* pos0, const float* dirs,
                     const unsigned char* hit, const float* vol, int nz,
                     int ny, int nx, const float* tf, int ntf, float* out,
                     int height, int width, float dmin, float inv_w, float sx0,
                     float sy0, float sz0, float sx1, float sy1, float sz1,
                     int num_steps, float dt, int early_termination,
                     float eps, float amax, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(ntf) * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(march_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kTile, kTile);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  march_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos0, dirs, hit, vol, nz, ny, nx, tf, ntf, out, height, width, dmin,
      inv_w, sx0, sy0, sz0, sx1, sy1, sz1, num_steps, dt, early_termination,
      eps, amax);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
