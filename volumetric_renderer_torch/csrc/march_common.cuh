// The per-step sample shared by the forward (K1, march_fwd.cu) and the
// backward re-march (K2, march_bwd.cu) ray-march kernels.
//
// K2 recomputes every sample of the forward.  Its transmittance, TF bins
// and lerp weights must equal K1's bit for bit: a recomputed density one
// ulp off can land in another TF bin, which changes the lerp slope and
// gives an O(1) gradient error at that voxel (on the TPU this drift broke
// the 1e-4 bar, docs/PARITY.md).  So both kernels locate and shade a
// sample with the same functions (locate_step, shade), both read the same
// f32 voxel values (K2 with __ldg, fetch_corners; K1 through a texture of
// the grid with point filtering, march_fwd.cu), and both libraries are
// built with the same flags (-fmad=false: no multiply-add is contracted,
// every operation rounds as in the plain PyTorch version, core/fused.py).
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

// A sample is taken in three parts, so that the two kernels can fetch the
// voxels each in its own way: locate_step (position, box, slicing and
// ownership tests, the trilinear corner and weights), the fetch of the 8
// voxels (fetch_corners for K2; K1 reads a texture, march_fwd.cu) and
// shade (trilinear sum, window, TF lerp).  sample_step runs the three in
// order with fetch_corners.

// Locates step k of `ray`.  Returns kLeftBox once the position has left the
// unit cube (it never re-enters: each coordinate is monotone in k under
// round-to-nearest), kOutsideSlice outside the slicing window, kNotOwned
// where another depth chunk takes the sample, and kSampled with the corner
// (in the array) and the weights of `s` filled in otherwise.
__device__ __forceinline__ int locate_step(const Grid& grid, const Ray& ray,
                                           const Window& win, int k, float dt,
                                           Sample& s) {
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
    // selects, not a reference to the member: a reference chosen at run
    // time would keep the corner in local memory
    const int c = grid.own_axis == 0   ? s.z0
                  : grid.own_axis == 1 ? s.y0
                                       : s.x0;
    if (c < grid.own_lo || c >= grid.own_hi) return kNotOwned;
    s.z0 -= grid.own_axis == 0 ? grid.a_start : 0;
    s.y0 -= grid.own_axis == 1 ? grid.a_start : 0;
    s.x0 -= grid.own_axis == 2 ? grid.a_start : 0;
  }
  return kSampled;
}

// Whether all 8 corners of the trilinear fetch at (s.x0, s.y0, s.z0) lie
// inside the array (most steps): one unsigned compare per axis.
__device__ __forceinline__ bool interior(const Grid& grid, const Sample& s) {
  return static_cast<unsigned>(s.x0) < static_cast<unsigned>(grid.nx - 1) &&
         static_cast<unsigned>(s.y0) < static_cast<unsigned>(grid.ny - 1) &&
         static_cast<unsigned>(s.z0) < static_cast<unsigned>(grid.nz - 1);
}

// The 8 voxels of the trilinear fetch at corner (s.x0, s.y0, s.z0), in the
// order z, y, x (v[cz*4 + cy*2 + cx]), 0 for a corner outside the array
// (CLAMP_TO_BORDER).
//   * Interior: one base offset, and the other 7 corners at the constant
//     strides 1, nx and nx*ny.
//   * Border: each corner tested and loaded on its own.
// 32-bit offsets where the array allows them were measured and not kept:
// K2 took the same time with them (PERF.md §6, PR 6).
__device__ __forceinline__ void fetch_corners(const float* __restrict__ vol,
                                              const Grid& grid,
                                              const Sample& s,
                                              float (&v)[8]) {
  if (interior(grid, s)) {
    const int64_t sy = grid.nx;
    const int64_t sz = sy * grid.ny;
    const float* p0 = vol + voxel_offset(s.x0, s.y0, s.z0, grid.nx, grid.ny);
    const float* p1 = p0 + sz;
    v[0] = __ldg(p0);
    v[1] = __ldg(p0 + 1);
    v[2] = __ldg(p0 + sy);
    v[3] = __ldg(p0 + sy + 1);
    v[4] = __ldg(p1);
    v[5] = __ldg(p1 + 1);
    v[6] = __ldg(p1 + sy);
    v[7] = __ldg(p1 + sy + 1);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ix = s.x0 + (i & 1), iy = s.y0 + ((i >> 1) & 1),
              iz = s.z0 + (i >> 2);
    v[i] = in_grid(ix, iy, iz, grid.nx, grid.ny, grid.nz)
               ? __ldg(vol + voxel_offset(ix, iy, iz, grid.nx, grid.ny))
               : 0.0f;
  }
}

// Trilinear sum of the fetched voxels (corners in the order z, y, x, as the
// plain version adds them), window, and the CLAMP_TO_EDGE TF lerp: fills in
// the rest of `s`.  `tf_s` is the (ntf, 4) table, 16-byte aligned.
__device__ __forceinline__ void shade(const float (&v)[8],
                                      const float* tf_s, int ntf,
                                      const Window& win, Sample& s) {
  float density = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    density = density + v[i] * corner_weight(s, i & 1, (i >> 1) & 1, i >> 2);
  }

  // The float clamp to [-1, ntf] before the int conversion changes no bin
  // and keeps a huge t in range.
  const float fntf = static_cast<float>(ntf);
  s.t = (density - win.dmin) * win.inv_w;
  const float tx = s.t * fntf - 0.5f;
  const float i0f = floorf(tx);
  s.w = tx - i0f;
  const int i0 = static_cast<int>(fminf(fmaxf(i0f, -1.0f), fntf));
  s.lo = min(max(i0, 0), ntf - 1);
  s.hi = min(max(i0 + 1, 0), ntf - 1);
  const float4 tlo = reinterpret_cast<const float4*>(tf_s)[s.lo];
  const float4 thi = reinterpret_cast<const float4*>(tf_s)[s.hi];
  s.r = tlo.x * (1.0f - s.w) + thi.x * s.w;
  s.g = tlo.y * (1.0f - s.w) + thi.y * s.w;
  s.b = tlo.z * (1.0f - s.w) + thi.z * s.w;
  s.a = tlo.w * (1.0f - s.w) + thi.w * s.w;
}

// Samples step k of `ray`: locate_step's kinds, and for kSampled `s` filled
// in completely.
__device__ __forceinline__ int sample_step(
    const float* __restrict__ vol, const Grid& grid, const float* tf_s,
    int ntf, const Ray& ray, const Window& win, int k, float dt, Sample& s) {
  const int kind = locate_step(grid, ray, win, k, dt, s);
  if (kind != kSampled) return kind;
  float v[8];
  fetch_corners(vol, grid, s, v);
  shade(v, tf_s, ntf, win, s);
  return kSampled;
}

// The steps [k_begin, k_end) of `ray` that can hold a sample the depth
// chunk of `grid` owns; [0, num_steps) for the whole volume.  A sample is
// owned where its lower corner c along own_axis lies in [own_lo, own_hi),
// that is where the coordinate u lies in [(own_lo + 0.5)/n, (own_hi +
// 0.5)/n) with n the whole volume's extent.  That slab, widened by 1e-5 (a
// few ulp of the coordinates in [0, 1], against the rounding of u and of
// this computation) and then by one step on each side, is turned into
// steps.  locate_step's exact test still runs on every step inside, so
// each sample is the one the plain version takes; the steps outside own
// nothing and add exactly 0, and since T is 1 until the first owned
// sample, early termination cannot end a ray before k_begin.
__device__ __forceinline__ void owned_steps(const Grid& grid, const Ray& ray,
                                            float dt, int num_steps,
                                            int& k_begin, int& k_end) {
  k_begin = 0;
  k_end = num_steps;
  if (grid.own_axis < 0) return;
  const int axis = grid.own_axis;
  const float o = axis == 0 ? ray.oz : axis == 1 ? ray.oy : ray.ox;
  const float d = axis == 0 ? ray.dz : axis == 1 ? ray.dy : ray.dx;
  const float n =
      static_cast<float>(axis == 0 ? grid.gz : axis == 1 ? grid.gy : grid.gx);
  const float u0 = (static_cast<float>(grid.own_lo) + 0.5f) / n - 1e-5f;
  const float u1 = (static_cast<float>(grid.own_hi) + 0.5f) / n + 1e-5f;
  const float per_step = d * dt;
  const float ka = (u0 - o) / per_step, kb = (u1 - o) / per_step;
  // a ray parallel to the slab (or a NaN) keeps every step
  if (!(fabsf(per_step) > 0.0f) || ka != ka || kb != kb) return;
  const float top = static_cast<float>(num_steps);
  const float lo = fminf(fmaxf(floorf(fminf(ka, kb)) - 1.0f, 0.0f), top);
  const float hi = fminf(fmaxf(ceilf(fmaxf(ka, kb)) + 1.0f, 0.0f), top);
  k_begin = static_cast<int>(lo);
  k_end = max(static_cast<int>(hi), k_begin);
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

constexpr unsigned kFullWarp = 0xffffffffu;

// The counted instantiations of K1 and K2 (kCount) add what each thread
// counted into `counts`, N u64 in device memory that the wrapper zeroes and
// reads (kernels/march.py): a warp sums its lanes with shuffles, the block
// its warps in shared memory, and thread 0 adds the block's sums, one
// atomicAdd a count.  Every thread of the block calls it, with every lane of
// its warp.
template <int N>
__device__ __forceinline__ void add_block_counts(
    unsigned long long* counts, const unsigned long long (&c)[N]) {
  constexpr int kWarps = kTile * kTile / 32;
  __shared__ unsigned long long part[N][kWarps];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    unsigned long long v = c[i];
    for (int offset = 16; offset > 0; offset >>= 1) {
      v += __shfl_down_sync(kFullWarp, v, offset);
    }
    if ((tid & 31) == 0) part[i][tid >> 5] = v;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < N; ++i) {
      unsigned long long sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += part[i][w];
      atomicAdd(counts + i, sum);
    }
  }
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
