// Backward ray re-march (K2) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel `_make_bwd_kernel` in
// volumetric_renderer_tpu/kernels/slab.py (launched by make_slab_bwd, tied
// to the forward by the custom VJP of make_slab_marcher).  The TPU kernel
// re-marched slab by slab and turned the voxel scatter into transposed
// one-hot matmuls into a VMEM-resident gradient slab.  Here the march is
// ray-major, as in K1 (march_fwd.cu): one thread re-marches one ray front to
// back and scatters its gradients with atomics.
//
// What it computes, per hit ray, for every step k that K1 composited
// (core/fused.py:march_backward_prepared is its plain version):
//   recompute the sample (march_common.cuh:sample_step, shared with K1, so
//   T, the TF bins and the lerp weights equal the forward's bit for bit);
//   a = min(a_raw, amax);  P += T*a*(g_rgb.c);  S = G - P;
//   dL/dc = T*a*g_rgb;
//   dL/da = T*(g_rgb.c) + (g_alpha*T_fin - S) / max(1 - a, ALPHA_EPS),
//           0 where the opacity clamped;
//   tf_g[lo] += dL/drgba*(1-w);  tf_g[hi] += dL/drgba*w;
//   dL/dt = sum_c dL/drgba_c * (tf[hi]_c - tf[lo]_c) * ntf;
//   dmin_g += dL/dt*(t-1)*inv_w;  dmax_g += dL/dt*(-t)*inv_w;
//   vol_g[corner] += dL/dt*inv_w*weight for the 8 in-grid corners;
//   T *= 1 - a.
// with G = g_rgb.rgb_out and T_fin = 1 - alpha_out from the forward's
// output.  The early exits are K1's (box exit, T <= eps with early
// termination, the slicing window, a step another depth chunk owns); all
// are exact, because the plain version adds exactly 0 on those steps.
//
// Design on the card:
//   * 16x16-pixel blocks, one thread per ray, the TF table in shared memory
//     (as K1).
//   * The TF gradient and dmin_g / dmax_g are sums over every ray and step
//     (~1e6 terms in one TF texel at 96x96 pixels and 128 steps), where f32
//     in an arbitrary order loses ~1e-4 relative.  So they are accumulated
//     in f64, as the plain version does: each thread sums its run of steps
//     that share the same two TF texels in f64 registers and flushes the
//     run into a per-block (ntf, 4) f64 accumulator in shared memory (f64
//     shared atomicAdd) when the texels change; the block flushes once into
//     a global (ntf, 4) f64 array, which the wrapper rounds to f32.  The
//     runs also spare empty space, where every ray of a warp sits in texel
//     0, a 32-way conflict on one shared address per step.  Shared memory:
//     ntf*16 bytes of table + ntf*32 of accumulator = ntf*48 bytes.
//   * dmin_g and dmax_g are per-thread f64 sums, reduced per block (warp
//     shuffles, then shared memory) into one global f64 atomicAdd each.
//   * The voxel gradient is a zeroed (Z, Y, X) f32 grid in global memory;
//     each active step adds to its 8 corners with f32 atomicAdd (skipped
//     where the density gradient is exactly 0, e.g. in empty space where
//     the TF is flat, which changes nothing).  A voxel receives few terms,
//     so f32 suffices there.
//   * What bounds it: the scattered f32 atomics onto the grid (64 MiB at
//     256^3, more than the 50 MB L2), up to 8 per active step, contended
//     where neighbouring rays share voxels; plus K1's 8 dependent gathers
//     per step for the recompute.
//   * Later work: warp-aggregated atomics, or accumulation per brick in
//     shared memory with one flush per brick.
//
// Atomics add in an order that changes from run to run, so the gradients
// are not bitwise repeatable; they are held to the plain version with a
// tolerance (atol 1e-4, rtol 1e-5), not exactly.

#include "march_common.cuh"

namespace {

using march::kTile;
constexpr int kWarps = kTile * kTile / 32;

// Adds a finished run of one TF texel's gradient to the block accumulator.
__device__ __forceinline__ void flush_run(double* tfg_s, int texel,
                                         double (&acc)[4]) {
  if (texel < 0) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (acc[c] != 0.0) atomicAdd(tfg_s + texel * 4 + c, acc[c]);
    acc[c] = 0.0;
  }
}

__global__ void __launch_bounds__(kTile * kTile)
    march_bwd_kernel(const float* __restrict__ pos0,
                     const float* __restrict__ dirs,
                     const unsigned char* __restrict__ hit,
                     const float* __restrict__ vol, march::Grid grid,
                     const float* __restrict__ tf, int ntf,
                     const float* __restrict__ out,
                     const float* __restrict__ grad,
                     float* __restrict__ vol_g, double* __restrict__ tf_g,
                     double* __restrict__ win_g, int height, int width,
                     march::Window win, int num_steps, float dt,
                     int early_termination, float eps, float amax,
                     float alpha_eps) {
  // Dynamic shared memory: the (ntf, 4) f64 gradient accumulator first (8-
  // byte aligned), then the (ntf, 4) f32 table.
  extern __shared__ double smem_d[];
  double* tfg_s = smem_d;
  float* tf_s = reinterpret_cast<float*>(smem_d + ntf * 4);
  __shared__ double red_s[2][kWarps];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < ntf * 4; i += blockDim.x * blockDim.y) {
    tf_s[i] = tf[i];
    tfg_s[i] = 0.0;
  }
  __syncthreads();

  const int px = blockIdx.x * kTile + threadIdx.x;
  const int py = blockIdx.y * kTile + threadIdx.y;
  double dmin_acc = 0.0, dmax_acc = 0.0;
  // No early return: every thread reaches the block reductions below.
  if (px < width && py < height) {
    const int64_t ray = static_cast<int64_t>(py) * width + px;
    if (hit[ray]) {
      const march::Ray rr = march::load_ray(pos0, dirs, ray);
      const float4 o = reinterpret_cast<const float4*>(out)[ray];
      const float4 g = reinterpret_cast<const float4*>(grad)[ray];
      const float big_g = g.x * o.x + g.y * o.y + g.z * o.z;
      const float ga_tfin = g.w * (1.0f - o.w);
      const float fntf = static_cast<float>(ntf);
      float tr = 1.0f, p = 0.0f;
      // the current run: its two texels and their f64 gradient sums
      int run_lo = -1, run_hi = -1;
      double acc_lo[4] = {0.0, 0.0, 0.0, 0.0};
      double acc_hi[4] = {0.0, 0.0, 0.0, 0.0};
      march::Sample s;
      for (int k = 0; k < num_steps; ++k) {
        if (early_termination && !(tr > eps)) break;
        const int kind =
            march::sample_step(vol, grid, tf_s, ntf, rr, win, k, dt, s);
        if (kind == march::kLeftBox) break;
        if (kind != march::kSampled) continue;

        const bool clamped = s.a > amax;
        const float a = march::clamp_alpha(s.a, amax);
        const float gc = g.x * s.r + g.y * s.g + g.z * s.b;
        const float ta = tr * a;
        p = p + ta * gc;
        const float suffix = big_g - p;
        const float one_minus_a = 1.0f - a;
        // max(1 - a, ALPHA_EPS), NaN propagating as torch.clamp does
        const float denom = (one_minus_a < alpha_eps) ? alpha_eps
                                                      : one_minus_a;
        const float dr = ta * g.x, dg = ta * g.y, db = ta * g.z;
        const float da = clamped ? 0.0f : tr * gc + (ga_tfin - suffix) / denom;

        // TF-table gradient: the transpose of the 2-bin lerp.
        if (s.lo != run_lo || s.hi != run_hi) {
          flush_run(tfg_s, run_lo, acc_lo);
          flush_run(tfg_s, run_hi, acc_hi);
          run_lo = s.lo;
          run_hi = s.hi;
        }
        const float w1 = s.w, w0 = 1.0f - s.w;
        acc_lo[0] += static_cast<double>(dr * w0);
        acc_lo[1] += static_cast<double>(dg * w0);
        acc_lo[2] += static_cast<double>(db * w0);
        acc_lo[3] += static_cast<double>(da * w0);
        acc_hi[0] += static_cast<double>(dr * w1);
        acc_hi[1] += static_cast<double>(dg * w1);
        acc_hi[2] += static_cast<double>(db * w1);
        acc_hi[3] += static_cast<double>(da * w1);

        // Density gradient through the lerp slope (tf[hi] - tf[lo]) * ntf.
        const float* tlo = tf_s + s.lo * 4;
        const float* thi = tf_s + s.hi * 4;
        const float dl_dt = dr * ((thi[0] - tlo[0]) * fntf) +
                            dg * ((thi[1] - tlo[1]) * fntf) +
                            db * ((thi[2] - tlo[2]) * fntf) +
                            da * ((thi[3] - tlo[3]) * fntf);
        dmin_acc += static_cast<double>(dl_dt * (s.t - 1.0f) * win.inv_w);
        dmax_acc += static_cast<double>(dl_dt * (-s.t) * win.inv_w);
        const float dl_dd = dl_dt * win.inv_w;

        // Voxel gradient: the transpose of the 8-corner gather.
        if (dl_dd != 0.0f) {
#pragma unroll
          for (int cz = 0; cz < 2; ++cz) {
#pragma unroll
            for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
              for (int cx = 0; cx < 2; ++cx) {
                const int ix = s.x0 + cx, iy = s.y0 + cy, iz = s.z0 + cz;
                if (march::in_grid(ix, iy, iz, grid.nx, grid.ny, grid.nz)) {
                  atomicAdd(vol_g + march::voxel_offset(ix, iy, iz, grid.nx,
                                                        grid.ny),
                            dl_dd * march::corner_weight(s, cx, cy, cz));
                }
              }
            }
          }
        }
        tr = tr * (1.0f - a);
      }
      flush_run(tfg_s, run_lo, acc_lo);
      flush_run(tfg_s, run_hi, acc_hi);
    }
  }

  // dmin_g / dmax_g: warp shuffles, then one partial per warp.
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    dmin_acc += __shfl_down_sync(0xffffffffu, dmin_acc, offset);
    dmax_acc += __shfl_down_sync(0xffffffffu, dmax_acc, offset);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red_s[0][warp] = dmin_acc;
    red_s[1][warp] = dmax_acc;
  }
  __syncthreads();   // also orders every tfg_s update before the flush
  if (tid == 0) {
    double a0 = 0.0, a1 = 0.0;
    for (int i = 0; i < kWarps; ++i) {
      a0 += red_s[0][i];
      a1 += red_s[1][i];
    }
    atomicAdd(win_g + 0, a0);
    atomicAdd(win_g + 1, a1);
  }
  for (int i = tid; i < ntf * 4; i += blockDim.x * blockDim.y) {
    const double v = tfg_s[i];
    if (v != 0.0) atomicAdd(tf_g + i, v);
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of `device` may opt in to.
int march_bwd_max_dynamic_smem(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* march_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the re-march on `stream` and returns cudaGetLastError().  All
// pointers are device pointers.  pos0, dirs, hit, vol, tf are K1's inputs;
// out is K1's (height, width, 4) output and grad its cotangent, same shape.
// The caller zeroes the outputs: vol_g (nz, ny, nx) f32, tf_g (ntf, 4) f64
// and win_g (2,) f64 = (dmin_g, dmax_g).  All contiguous, float4 arrays
// 16-byte aligned.  own_* as for march_fwd_launch: on a depth chunk, vol_g
// has the chunk's shape, halo row included.
int march_bwd_launch(int device, const float* pos0, const float* dirs,
                     const unsigned char* hit, const float* vol, int nz,
                     int ny, int nx, int own_axis, int own_start,
                     int own_body, int own_total, const float* tf, int ntf,
                     const float* out, const float* grad, float* vol_g,
                     double* tf_g, double* win_g, int height, int width,
                     float dmin, float inv_w, float sx0, float sy0, float sz0,
                     float sx1, float sy1, float sz1, int num_steps, float dt,
                     int early_termination, float eps, float amax,
                     float alpha_eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(ntf) * 4 * (sizeof(double) + sizeof(float));
  err = march::allow_dynamic_smem(march_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const march::Window win{dmin, inv_w, sx0, sy0, sz0, sx1, sy1, sz1};
  const march::Grid vgrid = march::make_grid(nz, ny, nx, own_axis, own_start,
                                             own_body, own_total);
  const dim3 block(kTile, kTile);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  march_bwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos0, dirs, hit, vol, vgrid, tf, ntf, out, grad, vol_g, tf_g,
      win_g, height, width, win, num_steps, dt, early_termination, eps, amax,
      alpha_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
