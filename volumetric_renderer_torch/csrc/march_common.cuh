// The per-step sample shared by the forward (K1, march_fwd.cu) and the
// backward re-march (K2, march_bwd.cu) ray-march kernels.
//
// K2 recomputes every sample of the forward.  Its transmittance, TF bins
// and lerp weights must equal K1's bit for bit: a recomputed density one
// ulp off can land in another TF bin, which changes the lerp slope and
// gives an O(1) gradient error at that voxel (on the TPU this drift broke
// the 1e-4 bar, docs/PARITY.md).  So both kernels call this one function,
// and both libraries are built with the same flags (-fmad=false: no
// multiply-add is contracted, every operation rounds as in the plain
// PyTorch version, core/fused.py).
//
// The operations are those of the plain version, in its order:
//   pos = pos0 + (float(k)*dt)*dir;  stop once pos leaves [0,1]^3;
//   skip the step unless smin < pos < smax (strict, every axis);
//   trilinear fetch at pos*N - 0.5, corners summed in the order z, y, x,
//   CLAMP_TO_BORDER (a corner outside the grid reads 0);
//   t = (d - dmin) * inv_w;  TF lerp at t*ntf - 0.5, CLAMP_TO_EDGE.
//
// Depth chunks (parallel/depth.py): the grid may be one chunk of a larger
// volume, split along one array axis.  The chunk holds `body` rows of the
// whole volume from row `a_start` on, plus one halo row (the next chunk's
// first row, zeros after the last chunk).  The texel coordinate along that
// axis is taken with the whole volume's extent, exactly as for the whole
// volume, and only the integer corner index is shifted into the chunk, so
// every sample a chunk takes is bit-identical to the whole-volume sample.
// A chunk takes only the samples whose lower corner along the axis lies in
// [a_start, a_start + body); the chunk with a_start == 0 also takes corner
// -1 (the transparent-black border before row 0).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace march {

// One thread per ray, 16x16-pixel blocks.
constexpr int kTile = 16;

enum StepKind { kLeftBox = 0, kOutsideSlice = 1, kSampled = 2, kNotOwned = 3 };

// The grid a kernel reads: the whole volume (own_axis < 0) or one depth
// chunk of it.
struct Grid {
  int nz, ny, nx;       // extents of the array in memory
  int gz, gy, gx;       // extents of the whole volume (texel coordinates)
  int own_axis;         // -1, or the array axis of the chunks: 0 z, 1 y, 2 x
  int own_lo, own_hi;   // lower corners taken along own_axis: [lo, hi)
  int a_start;          // whole-volume index of the chunk's row 0
};

// A grid of extents (nz, ny, nx).  own_axis < 0: the whole volume.  Else
// the array is a chunk of `own_body` + 1 rows along own_axis, starting at
// row `own_start` of a volume of `own_total` rows along that axis.
inline Grid make_grid(int nz, int ny, int nx, int own_axis, int own_start,
                      int own_body, int own_total) {
  Grid g{nz, ny, nx, nz, ny, nx, -1, 0, 0, 0};
  if (own_axis >= 0) {
    (own_axis == 0 ? g.gz : own_axis == 1 ? g.gy : g.gx) = own_total;
    g.own_axis = own_axis;
    g.own_lo = own_start == 0 ? -1 : own_start;
    g.own_hi = own_start + own_body;
    g.a_start = own_start;
  }
  return g;
}

struct Ray {
  float ox, oy, oz;  // box entry point pos0
  float dx, dy, dz;  // unit direction
};

struct Window {
  float dmin, inv_w;           // density window: t = (d - dmin) * inv_w
  float sx0, sy0, sz0;         // slicing window, strict bounds
  float sx1, sy1, sz1;
};

// The window from the 8 floats a launch passes in device memory.
__device__ __forceinline__ Window load_window(const float* __restrict__ w) {
  return Window{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7]};
}

struct Sample {
  int x0, y0, z0;     // lower trilinear corner in the array (may lie
                      // outside it)
  float wx, wy, wz;   // lerp weights toward the +1 corner
  float t;            // normalised density
  int lo, hi;         // TF texels of the lerp
  float w;            // TF lerp weight toward hi
  float r, g, b, a;   // TF colour and opacity, before the opacity clamp
};

__device__ __forceinline__ bool in_grid(int ix, int iy, int iz, int nx, int ny,
                                        int nz) {
  return ix >= 0 && ix < nx && iy >= 0 && iy < ny && iz >= 0 && iz < nz;
}

__device__ __forceinline__ int64_t voxel_offset(int ix, int iy, int iz,
                                                int nx, int ny) {
  return (static_cast<int64_t>(iz) * ny + iy) * static_cast<int64_t>(nx) + ix;
}

// Weight of corner (cx, cy, cz) of a trilinear fetch, multiplied in the
// plain version's order (x, then y, then z).
__device__ __forceinline__ float corner_weight(const Sample& s, int cx,
                                               int cy, int cz) {
  return (cx ? s.wx : 1.0f - s.wx) * (cy ? s.wy : 1.0f - s.wy) *
         (cz ? s.wz : 1.0f - s.wz);
}

// Samples step k of `ray`.  Returns kLeftBox once the position has left
// the unit cube (it never re-enters: each coordinate is monotone in k under
// round-to-nearest), kOutsideSlice outside the slicing window, kNotOwned
// where another depth chunk takes the sample, and kSampled with `s` filled
// in otherwise.  `tf_s` is the (ntf, 4) table.
__device__ __forceinline__ int sample_step(
    const float* __restrict__ vol, const Grid& grid, const float* tf_s,
    int ntf, const Ray& ray, const Window& win, int k, float dt, Sample& s) {
  const float kdt = static_cast<float>(k) * dt;
  const float x = ray.ox + kdt * ray.dx, y = ray.oy + kdt * ray.dy,
              z = ray.oz + kdt * ray.dz;
  if (!(x >= 0.0f && x <= 1.0f && y >= 0.0f && y <= 1.0f && z >= 0.0f &&
        z <= 1.0f)) {
    return kLeftBox;
  }
  if (!(x < win.sx1 && x > win.sx0 && y < win.sy1 && y > win.sy0 &&
        z < win.sz1 && z > win.sz0)) {
    return kOutsideSlice;
  }

  const float fx = x * static_cast<float>(grid.gx) - 0.5f,
              fy = y * static_cast<float>(grid.gy) - 0.5f,
              fz = z * static_cast<float>(grid.gz) - 0.5f;
  const float x0f = floorf(fx), y0f = floorf(fy), z0f = floorf(fz);
  s.wx = fx - x0f;
  s.wy = fy - y0f;
  s.wz = fz - z0f;
  s.x0 = static_cast<int>(x0f);
  s.y0 = static_cast<int>(y0f);
  s.z0 = static_cast<int>(z0f);
  if (grid.own_axis >= 0) {
    int& c = grid.own_axis == 0 ? s.z0 : grid.own_axis == 1 ? s.y0 : s.x0;
    if (c < grid.own_lo || c >= grid.own_hi) return kNotOwned;
    c -= grid.a_start;
  }
  float density = 0.0f;
#pragma unroll
  for (int cz = 0; cz < 2; ++cz) {
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int ix = s.x0 + cx, iy = s.y0 + cy, iz = s.z0 + cz;
        const float v =
            in_grid(ix, iy, iz, grid.nx, grid.ny, grid.nz)
                ? __ldg(vol + voxel_offset(ix, iy, iz, grid.nx, grid.ny))
                : 0.0f;
        density = density + v * corner_weight(s, cx, cy, cz);
      }
    }
  }

  // CLAMP_TO_EDGE TF lerp.  The float clamp to [-1, ntf] before the int
  // conversion changes no bin and keeps a huge t in range.
  const float fntf = static_cast<float>(ntf);
  s.t = (density - win.dmin) * win.inv_w;
  const float tx = s.t * fntf - 0.5f;
  const float i0f = floorf(tx);
  s.w = tx - i0f;
  const int i0 = static_cast<int>(fminf(fmaxf(i0f, -1.0f), fntf));
  s.lo = min(max(i0, 0), ntf - 1);
  s.hi = min(max(i0 + 1, 0), ntf - 1);
  const float* tlo = tf_s + s.lo * 4;
  const float* thi = tf_s + s.hi * 4;
  s.r = tlo[0] * (1.0f - s.w) + thi[0] * s.w;
  s.g = tlo[1] * (1.0f - s.w) + thi[1] * s.w;
  s.b = tlo[2] * (1.0f - s.w) + thi[2] * s.w;
  s.a = tlo[3] * (1.0f - s.w) + thi[3] * s.w;
  return kSampled;
}

// The opacity clamp a <= amax of the plain version; NaN propagates, as
// torch.clamp does.
__device__ __forceinline__ float clamp_alpha(float a, float amax) {
  return (a > amax) ? amax : a;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ pos0,
                                        const float* __restrict__ dirs,
                                        int64_t ray) {
  return Ray{pos0[ray * 3 + 0], pos0[ray * 3 + 1], pos0[ray * 3 + 2],
             dirs[ray * 3 + 0], dirs[ray * 3 + 1], dirs[ray * 3 + 2]};
}

// Opts a kernel in to `smem` bytes of dynamic shared memory where that
// exceeds the 48 KB a launch gets without asking.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace march
