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
// Design on the card (measured on an H100 80GB HBM3 at 700 W, PERF.md §6):
//   * 16x16-pixel blocks, one thread per ray: neighbouring rays terminate
//     at similar steps, which keeps the warps coherent; the image edge is
//     masked.  Rays are independent, so nothing carries between blocks.
//   * The TF table (ntf x 4 floats, 4 KB at ntf = 256) sits in shared
//     memory and is read as float4.
//   * What bounds it: the 8 gathers of a step more than its instructions.
//     At the reference frame the earlier kernel (8 guarded __ldg gathers,
//     int64 offsets) took 0.87 ms on the device; with 1 gather per step in
//     place of 8, 0.45 ms; without the per-corner grid tests and with
//     32-bit offsets, 0.70 ms.
//   * So the voxels are read through a texture object of the grid: a 3D
//     cudaArray that the wrapper fills from the (Z, Y, X) tensor, point
//     filtering, unnormalized coordinates, cudaAddressModeBorder.  A point
//     fetch at a texel's centre returns that voxel's f32 value exactly, and
//     the border mode returns 0 outside the array, which is CLAMP_TO_BORDER:
//     no corner is tested in the kernel.  The array's layout keeps a
//     trilinear footprint, and the footprints of neighbouring rays, in few
//     cache lines.  The hardware filter stays off: its weights carry 8
//     fractional bits, far outside a 1e-5 bar; the 8 values are weighted
//     and summed here in the plain version's order.
//   * Each step fetches, shades and composites in order.  Issuing step k+1's
//     fetches before shading step k (bit-exact: the position is linear in k
//     and does not depend on T) was measured and not kept: its second set
//     of registers cost occupancy (89 registers, 2 blocks per SM; capped at
//     64, spills), and it was slower than this loop on every case but the
//     512^3 chunks (0.68 against 0.61 ms at the reference frame).  The
//     texture fetches of the warps in flight already cover each other's
//     latency.
//   * A depth chunk (own_axis >= 0) walks only the steps whose samples the
//     chunk can own (march_common.cuh:owned_steps), each still under the
//     exact ownership test: the steps of the other chunks are not walked.
//   * A counted instantiation (kCount) counts the samples and the steps the
//     warps pay for, for utils/metrics.py:counting.  A launch without a
//     counter buffer runs the other, which counts nothing.

#include "march_common.cuh"

namespace {

using march::kTile;

// The 8 voxels of the trilinear fetch at the corner of `s`, in the order
// z, y, x (v[cz*4 + cy*2 + cx]), through the grid's texture: the centre of
// texel (i, j, l) is at (i + 0.5, j + 0.5, l + 0.5), and a texel outside
// the array reads 0.
__device__ __forceinline__ void fetch_texels(cudaTextureObject_t tex,
                                             const march::Sample& s,
                                             float (&v)[8]) {
  const float x = static_cast<float>(s.x0) + 0.5f;
  const float y = static_cast<float>(s.y0) + 0.5f;
  const float z = static_cast<float>(s.z0) + 0.5f;
  v[0] = tex3D<float>(tex, x, y, z);
  v[1] = tex3D<float>(tex, x + 1.0f, y, z);
  v[2] = tex3D<float>(tex, x, y + 1.0f, z);
  v[3] = tex3D<float>(tex, x + 1.0f, y + 1.0f, z);
  v[4] = tex3D<float>(tex, x, y, z + 1.0f);
  v[5] = tex3D<float>(tex, x + 1.0f, y, z + 1.0f);
  v[6] = tex3D<float>(tex, x, y + 1.0f, z + 1.0f);
  v[7] = tex3D<float>(tex, x + 1.0f, y + 1.0f, z + 1.0f);
}

// Marches the ray of pixel (px, py), on the image, and writes its RGBA;
// with kCount, adds the steps its loop entered to `walked` and its samples
// to `sampled`.
template <bool kCount>
__device__ __forceinline__ void march_pixel(
    const float* __restrict__ pos0, const float* __restrict__ dirs,
    const unsigned char* __restrict__ hit, cudaTextureObject_t tex,
    const march::Grid& grid, const float* tf_s, int ntf,
    const march::Window& win, float* __restrict__ out, int width,
    int num_steps, float dt, int early_termination, float eps, float amax,
    int px, int py, int& walked, int& sampled) {
  const int64_t ray = static_cast<int64_t>(py) * width + px;
  if (!hit[ray]) {
    reinterpret_cast<float4*>(out)[ray] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }

  const march::Ray rr = march::load_ray(pos0, dirs, ray);
  int k, k_end;
  march::owned_steps(grid, rr, dt, num_steps, k, k_end);
  float r = 0.0f, g = 0.0f, b = 0.0f, tr = 1.0f;
  march::Sample s;
  float v[8];
  for (; k < k_end; ++k) {
    if (kCount) ++walked;
    if (early_termination && !(tr > eps)) break;
    const int kind = march::locate_step(grid, rr, win, k, dt, s);
    if (kind == march::kLeftBox) break;
    if (kind != march::kSampled) continue;
    if (kCount) ++sampled;
    fetch_texels(tex, s, v);
    march::shade(v, tf_s, ntf, win, s);
    const float a = march::clamp_alpha(s.a, amax);
    const float ta = tr * a;
    r = r + ta * s.r;
    g = g + ta * s.g;
    b = b + ta * s.b;
    tr = tr * (1.0f - a);
  }
  reinterpret_cast<float4*>(out)[ray] = make_float4(r, g, b, 1.0f - tr);
}

// kCount: the counted instantiation, which adds the block's samples and
// lane steps to `counts` (march_common.cuh:add_block_counts); the other
// takes counts == nullptr and counts nothing.
template <bool kCount>
__global__ void __launch_bounds__(kTile * kTile)
    march_fwd_kernel(const float* __restrict__ pos0,
                     const float* __restrict__ dirs,
                     const unsigned char* __restrict__ hit,
                     cudaTextureObject_t tex, march::Grid grid,
                     const float* __restrict__ tf, int ntf,
                     float* __restrict__ out, int height, int width,
                     const float* __restrict__ window, int num_steps,
                     float dt, int early_termination, float eps,
                     float amax, unsigned long long* __restrict__ counts) {
  extern __shared__ float4 tf_s4[];
  float* tf_s = reinterpret_cast<float*>(tf_s4);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < ntf * 4; i += blockDim.x * blockDim.y) {
    tf_s[i] = tf[i];
  }
  __syncthreads();
  const march::Window win = march::load_window(window);

  const int px = blockIdx.x * kTile + threadIdx.x;
  const int py = blockIdx.y * kTile + threadIdx.y;
  const bool on_image = px < width && py < height;
  int walked = 0, sampled = 0;
  if (!kCount) {
    if (on_image) {
      march_pixel<false>(pos0, dirs, hit, tex, grid, tf_s, ntf, win, out,
                         width, num_steps, dt, early_termination, eps, amax,
                         px, py, walked, sampled);
    }
    return;
  }
  // Every thread of the counted instantiation stays to the end, for the
  // warp's and the block's sums.  A warp pays for the longest walk among
  // its lanes: its lane steps are 32 times that walk.
  if (on_image) {
    march_pixel<true>(pos0, dirs, hit, tex, grid, tf_s, ntf, win, out, width,
                      num_steps, dt, early_termination, eps, amax, px, py,
                      walked, sampled);
  }
  int longest = walked;
  for (int offset = 16; offset > 0; offset >>= 1) {
    longest = max(longest, __shfl_down_sync(march::kFullWarp, longest,
                                            offset));
  }
  const unsigned long long c[2] = {
      static_cast<unsigned long long>(sampled),
      (tid & 31) == 0 ? 32ull * static_cast<unsigned long long>(longest)
                      : 0ull};
  march::add_block_counts(counts, c);
}

// A grid's texture: the 3D array that holds a copy of the voxels, and the
// texture object that reads it.
struct GridTexture {
  cudaArray_t array;
  cudaTextureObject_t tex;
  int nz, ny, nx;
};

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

// Allocates a texture for an (nz, ny, nx) f32 grid on `device`: a 3D array
// and a texture object reading it with point filtering, unnormalized
// coordinates and the border address mode (0 outside).  Sets *handle (for
// march_fwd_texture_fill and _free) and *tex (for march_fwd_launch).
int march_fwd_texture_alloc(int device, int nz, int ny, int nx,
                            void** handle, unsigned long long* tex) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  GridTexture* t = new GridTexture{nullptr, 0, nz, ny, nx};
  const cudaChannelFormatDesc desc = cudaCreateChannelDesc<float>();
  err = cudaMalloc3DArray(&t->array, &desc, make_cudaExtent(nx, ny, nz));
  if (err != cudaSuccess) {
    delete t;
    return static_cast<int>(err);
  }
  cudaResourceDesc res = {};
  res.resType = cudaResourceTypeArray;
  res.res.array.array = t->array;
  cudaTextureDesc td = {};
  td.addressMode[0] = td.addressMode[1] = td.addressMode[2] =
      cudaAddressModeBorder;   // the border colour is 0
  td.filterMode = cudaFilterModePoint;
  td.readMode = cudaReadModeElementType;
  td.normalizedCoords = 0;
  err = cudaCreateTextureObject(&t->tex, &res, &td, nullptr);
  if (err != cudaSuccess) {
    cudaFreeArray(t->array);
    delete t;
    return static_cast<int>(err);
  }
  *handle = t;
  *tex = static_cast<unsigned long long>(t->tex);
  return 0;
}

// Copies the contiguous (nz, ny, nx) f32 grid `vol` (device memory) into
// the texture's array on `stream`.
int march_fwd_texture_fill(void* handle, const float* vol, void* stream) {
  const GridTexture* t = static_cast<const GridTexture*>(handle);
  cudaMemcpy3DParms p = {};
  p.srcPtr = make_cudaPitchedPtr(const_cast<float*>(vol),
                                 static_cast<size_t>(t->nx) * sizeof(float),
                                 t->nx, t->ny);
  p.dstArray = t->array;
  p.extent = make_cudaExtent(t->nx, t->ny, t->nz);
  p.kind = cudaMemcpyDeviceToDevice;
  return static_cast<int>(
      cudaMemcpy3DAsync(&p, static_cast<cudaStream_t>(stream)));
}

// Frees a texture of march_fwd_texture_alloc; no launch may still read it.
int march_fwd_texture_free(void* handle) {
  GridTexture* t = static_cast<GridTexture*>(handle);
  cudaError_t err = cudaDestroyTextureObject(t->tex);
  const cudaError_t err2 = cudaFreeArray(t->array);
  delete t;
  return static_cast<int>(err != cudaSuccess ? err : err2);
}

// Launches the march on `stream` and returns cudaGetLastError().  All
// pointers are device pointers; pos0 and dirs are (height*width, 3), hit is
// (height*width,) of 0/1 bytes, tf is (ntf, 4) and out is (height, width,
// 4), all contiguous and 16-byte aligned where float4.  tex is the texture
// of the (nz, ny, nx) grid (march_fwd_texture_alloc), filled with its
// current voxels.  window holds 8 floats, (dmin, inv_w, smin xyz, smax
// xyz): the kernel reads them on the card, so a launch needs no value on
// the host.  own_axis < 0 marches the whole volume; else the grid is the
// depth chunk that march_common.cuh:make_grid describes (own_start,
// own_body, own_total).  counts, where not null, launches the counted
// instantiation, which adds (samples, lane steps) to counts[0..2).
int march_fwd_launch(int device, const float* pos0, const float* dirs,
                     const unsigned char* hit, unsigned long long tex,
                     int nz, int ny, int nx, int own_axis, int own_start,
                     int own_body, int own_total, const float* tf, int ntf,
                     float* out, int height, int width, const float* window,
                     int num_steps, float dt, int early_termination,
                     float eps, float amax, unsigned long long* counts,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel =
      counts ? march_fwd_kernel<true> : march_fwd_kernel<false>;
  const size_t smem = static_cast<size_t>(ntf) * 4 * sizeof(float);
  err = march::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const march::Grid vgrid = march::make_grid(nz, ny, nx, own_axis, own_start,
                                             own_body, own_total);
  const dim3 block(kTile, kTile);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos0, dirs, hit, static_cast<cudaTextureObject_t>(tex), vgrid, tf, ntf,
      out, height, width, window, num_steps, dt, early_termination, eps,
      amax, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
