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
// are exact, because the plain version adds exactly 0 on those steps.  On a
// depth chunk a ray walks only the steps the chunk can own, the interval K1
// walks (march_common.cuh:owned_steps), as the TPU kernel loops over
// [k_lo, k_hi) only; the steps outside it add exactly 0 as well.
//
// What bounds it, measured on an H100 (PERF.md §6), depends on the grid.
//   * A fixed, smooth grid (BASELINE config 3: 256^3, 1920x1080, 512
//     steps): not the voxel scatter.  K2 took 2.79 ms; without its ~580 M
//     global f32 atomics 2.62-2.77 ms, without the shared-memory flush of
//     its TF-gradient runs 1.80-2.01 ms.  On sm_90a a shared-memory f64
//     atomicAdd (and an f32 one too) compiles to a compare-and-swap loop
//     (ATOMS.CAST.SPIN), and the flushes of one warp land on a few texels:
//     neighbouring rays cross the same densities, so up to 32 lanes retried
//     on one address.  What remains is the re-march (8 gathers per step,
//     through march_common.cuh:fetch_corners: one base offset and constant
//     strides where all 8 corners lie inside the array) plus the backward
//     arithmetic.
//   * A grid that a fit is changing (32 stacked 256x256 views of a 256^3
//     grid that Adam has made noisy: 130 M samples, 870 M voxel atomics a
//     launch): the voxel scatter.  K2 took 18.4 ms with its table; without
//     the TF runs and their flushes 17.6 ms at the same 3 blocks an SM,
//     and with its atomics replaced by a store that never runs, 3.1 ms.
//     The atomics cost more the more blocks an SM holds: 11.4 ms at 1
//     block, 15.9 at 2, 17.6 at 3, 20.3 at 4.  The same kernel on a
//     quarter of 8 stacked 1920x1080 views of a 512^3 grid (one rank of a
//     four-card fit) took 10.8-11.0 ms at 1, 2 or 3 blocks an SM.
//
// Design on the card:
//   * 16x16-pixel blocks, one thread per ray, the TF table in shared memory
//     (as K1).
//   * The TF gradient and dmin_g / dmax_g are sums over every ray and step
//     (~1e6 terms in one TF texel at 96x96 pixels and 128 steps), where f32
//     in an arbitrary order loses ~1e-4 relative.  So they are accumulated
//     in f64, as the plain version does.  Each thread sums its run of steps
//     that share the same two TF texels in f64 registers.  Where any lane's
//     run ends, the whole warp flushes together: __match_any_sync groups the
//     lanes whose runs end on the same texel, a shuffle tree sums each group
//     into its lowest lane, and that lane alone adds the group's sum to an
//     (ntf, 4) f64 table.  So no two lanes of a warp contend for one
//     address.  The table is one of two, chosen per launch (Table):
//       - many waves of blocks (BASELINE config 3, 8160 blocks): the
//         block's table in shared memory, where the CAS loop of the f64
//         atomicAdd succeeds at its first try unless another warp of the
//         block adds to the same texel then; the block adds its table to
//         global memory once at its end.  Shared memory ntf*48 bytes.
//       - at most one wave (a config-4 view, 256 blocks): the global
//         memory directly, with REDG.E.ADD.F64, which is native and does
//         not wait for its result, so nothing is added to a step's chain of
//         dependent latencies, and a launch of one wave is bound by that
//         chain.  Shared memory ntf*16 bytes.
//     Measured at config 3 and on a config-4 view (PERF.md §6): shared
//     2.21-2.38 and 1.35-1.50 ms, global 2.61-2.72 and 0.76-0.89 ms (many
//     waves of blocks load L2 with their f64 reductions).  The wrapper
//     picks the table from the launch's size and the card's occupancy.
//     Either adds into one of up to 64 copies of the table in global
//     memory (block index mod copies), which the wrapper sums and rounds to
//     f32.
//   * For the warp-wide flush every lane of a warp runs every step of the
//     warp's loop, a lane whose ray is done (or that has no ray) included;
//     it then only votes.  The loop ends when no lane of the warp is live.
//   * The grid-only instantiation (kNoTable) is for a caller that wants the
//     grid's gradient alone (a grid fit: autograd asks for no TF or window
//     gradient, kernels/march.py:march_backward).  It keeps no TF runs, no
//     f64 sum, no flush, no table and no window sums: 72 registers and no
//     spill, against 80 with 20 bytes spilled (-Xptxas -v); the warp's vote
//     is its loop's end test alone.  Everything else is the same
//     instruction for instruction.  Its launch asks for more than half of
//     an SM's shared memory (no_table_smem), so that an SM holds one block
//     of it at a time: with fewer rays in flight its voxel atomics cost
//     less (the measurements above: 11.4 against 17.6 ms at the fit's
//     launch, the same time at a four-card rank's).  With the float4
//     scatter below, one block still leads at both launches (medians of 9
//     launches: 8.1, 11.2 and 14.7 ms at 1, 2 and 3 blocks at the fit's,
//     8.7, 8.8 and 9.3 at a rank's).
//   * dmin_g and dmax_g are per-thread f64 sums, reduced per block (warp
//     shuffles, then shared memory) into one global f64 atomicAdd each.
//   * The voxel gradient is a zeroed (Z, Y, X) f32 grid in global memory;
//     each active step adds to its 8 corners with fire-and-forget
//     reductions in L2 (skipped where the density gradient is exactly 0,
//     e.g. in empty space where the TF is flat, which changes nothing).
//     On the fixed, smooth grid of config 3 they cost 0.02-0.17 ms of the
//     2.79 (above); at a grid fit's launch, 8 scalar reductions a sample
//     took about 8 of the 11.4 ms (above: 3.1 without them).  So where the
//     grid's rows are whole 16-byte slots (nx % 4 == 0, vol_g aligned), a
//     sample inside the grid adds each of its 4 rows' x-pairs of corners
//     with one float4 reduction (REDG.E.ADD.F32x4), or two where the pair
//     straddles two slots: 5 requests a sample in place of 8, 0.625 of
//     them in both fit cells (scatter_corners).  The grid-only K2 went
//     from 10.4 to 8.1 ms at the fit's launch and from 10.7 to 8.7 at a
//     rank's (medians, PERF.md §6).  Border samples and other grids (a
//     depth chunk split along x, an odd nx) add corner by corner.  On the
//     fixed, smooth grid of config 3 the shared table took 3-6% longer
//     with it (2.06-2.13 against 2.18-2.22 ms), and a version of the
//     scatter without its 4 more bytes of spill there was slower still.
//     An accumulator per block in shared memory would trade them for
//     shared f32 atomicAdds, which are CAS loops on this card, contended
//     wherever neighbouring rays share a voxel; it is not built.
//
//   * A counted instantiation (kCount) counts the samples, the steps the
//     warps pay for, the voxel atomics, the TF flushes and the voxel
//     reductions (scalar and float4), for
//     utils/metrics.py:counting.  A launch without a counter buffer runs the
//     other, which counts nothing.
//
// Atomics add in an order that changes from run to run, so the gradients
// are not bitwise repeatable; they are held to the plain version with a
// tolerance (atol 1e-4, rtol 1e-5), not exactly.

#include <algorithm>

#include "march_common.cuh"

// Called once for each step a ray walks (samples, or finds outside the box,
// the slicing window or the chunk).  Empty on the card; the CPU stand-in of
// the CUDA runtime (tests/cuda_on_cpu/cuda_runtime.h) records the walk, so
// that a test can hold it to owned_steps.
#ifndef MARCH_WALKED_STEP
#define MARCH_WALKED_STEP(ray, k)
#endif

namespace {

using march::kFullWarp;
using march::kTile;
constexpr int kWarps = kTile * kTile / 32;

// Where a launch sums the TF gradient (march_bwd_launch's `table`): an
// (ntf, 4) f64 table in the block's shared memory, added to global memory
// at the block's end; global memory directly; or nowhere, in the grid-only
// instantiation, which computes the voxel gradient alone.
enum Table { kGlobalTable = 0, kSharedTable = 1, kNoTable = 2 };

// The blocks of 256 threads an SM should hold at once (__launch_bounds__),
// which caps the registers a thread has.  The shared table: 3 (80
// registers, a few spilled): its launches run in waves, where more warps
// hide more of the gathers' latency (2.23-2.33 against 2.51-2.59 ms at
// config 3 with 92 registers).  The global table: 1 (its launches are one
// wave).  No table: 1, the blocks an SM holds of its launch
// (march_bwd_launch).
constexpr int min_blocks(int table) {
  return table == kSharedTable ? 3 : 1;
}

// Adds the ended TF-gradient runs of a warp to `table`: every lane of the
// warp calls it at once; `texel` < 0 where the lane adds nothing.
// The lanes that add to one texel sum their `acc` in a shuffle tree (after
// round r each lane holds the sum over 2^r of the group's lanes from itself
// up), and the lowest of them adds the group's sum.
__device__ __forceinline__ void add_runs(double* table, int texel,
                                         const double (&acc)[4]) {
  const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
  unsigned peers = __match_any_sync(kFullWarp, texel);
  if (texel < 0) peers = 0u;
  const bool leader =
      peers != 0u && __ffs(static_cast<int>(peers)) - 1 == lane;
  // position among the group's lanes, lowest first
  unsigned rank =
      static_cast<unsigned>(__popc(peers & ((1u << lane) - 1u)));
  peers &= ~((2u << lane) - 1u);   // the group's lanes above this one
  double sum[4] = {acc[0], acc[1], acc[2], acc[3]};
  while (__any_sync(kFullWarp, peers != 0u)) {
    const int next = __ffs(static_cast<int>(peers));   // 0: none left
    const int src = next > 0 ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const double t = __shfl_sync(kFullWarp, sum[c], src);
      if (next > 0) sum[c] += t;
    }
    // lanes at odd positions have passed their sum on: drop them
    peers &= ~__ballot_sync(kFullWarp, rank & 1u);
    rank >>= 1;
  }
  if (leader) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (sum[c] != 0.0) atomicAdd(table + texel * 4 + c, sum[c]);
    }
  }
}

// The voxel gradient's scatter, the transpose of the 8-corner gather: adds
// dl_dd times each in-grid corner's weight to vol_g, and counts the
// in-grid corners (`atomics`) and the reductions issued (`reds`).
//   * `pairs` (vol_g's rows are whole 16-byte slots: nx % 4 == 0 and vol_g
//     16-byte aligned) and all 8 corners inside the array: each of the 4
//     rows (y0 + cy, z0 + cz) adds its pair of x-neighbours (x0, x0 + 1)
//     with one float4 reduction into the slot that holds both, +0 in the
//     slot's other two lanes, or with two where the pair straddles two
//     slots (x0 % 4 == 3): 5 requests for 8 corners where x0 % 4 is spread
//     evenly, against 8.
//   * Otherwise (a border sample, or rows that are not whole slots): one
//     scalar atomicAdd for each in-grid corner.
// Each corner's value is the same product either way, and adding +0
// changes no sum: every voxel receives the same f32 addends.
__device__ __forceinline__ void scatter_corners(float* __restrict__ vol_g,
                                                const march::Grid& grid,
                                                const march::Sample& s,
                                                float dl_dd, bool pairs,
                                                int& atomics, int& reds) {
  if (pairs && march::interior(grid, s)) {
    const int lane = s.x0 & 3;
    const int64_t sy = grid.nx;
    const int64_t sz = sy * grid.ny;
    float* const row0 = vol_g + march::voxel_offset(s.x0 - lane, s.y0, s.z0,
                                                    grid.nx, grid.ny);
#pragma unroll
    for (int cz = 0; cz < 2; ++cz) {
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const float v0 = dl_dd * march::corner_weight(s, 0, cy, cz);
        const float v1 = dl_dd * march::corner_weight(s, 1, cy, cz);
        float4* const slot =
            reinterpret_cast<float4*>(row0 + cz * sz + cy * sy);
        atomicAdd(slot, make_float4(lane == 0 ? v0 : 0.0f,
                                    lane == 0 ? v1 : lane == 1 ? v0 : 0.0f,
                                    lane == 1 ? v1 : lane == 2 ? v0 : 0.0f,
                                    lane == 2 ? v1 : lane == 3 ? v0 : 0.0f));
        if (lane == 3) atomicAdd(slot + 1, make_float4(v1, 0.0f, 0.0f, 0.0f));
      }
    }
    atomics += 8;
    reds += lane == 3 ? 8 : 4;
    return;
  }
#pragma unroll
  for (int cz = 0; cz < 2; ++cz) {
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int ix = s.x0 + cx, iy = s.y0 + cy, iz = s.z0 + cz;
        if (march::in_grid(ix, iy, iz, grid.nx, grid.ny, grid.nz)) {
          atomicAdd(vol_g + march::voxel_offset(ix, iy, iz, grid.nx, grid.ny),
                    dl_dd * march::corner_weight(s, cx, cy, cz));
          ++atomics;
          ++reds;
        }
      }
    }
  }
}

// kTable: a Table.  kCount: the counted instantiation, which adds the
// block's samples, lane steps, voxel atomics, TF flushes and voxel
// reductions to `counts` (march_common.cuh:add_block_counts); the other
// takes counts == nullptr.  pairs: scatter_corners's, the same for every
// thread of the launch.
template <int kTable, bool kCount>
__global__ void __launch_bounds__(kTile * kTile, min_blocks(kTable))
    march_bwd_kernel(const float* __restrict__ pos0,
                     const float* __restrict__ dirs,
                     const unsigned char* __restrict__ hit,
                     const float* __restrict__ vol, march::Grid grid,
                     const float* __restrict__ tf, int ntf,
                     const float* __restrict__ out,
                     const float* __restrict__ grad,
                     float* __restrict__ vol_g, double* __restrict__ tf_g,
                     int tf_copies, double* __restrict__ win_g, int height,
                     int width, const float* __restrict__ window,
                     int num_steps, float dt, int early_termination,
                     float eps, float amax, float alpha_eps, int pairs,
                     unsigned long long* __restrict__ counts) {
  // With the TF gradient and the window's (every table but kNoTable).
  constexpr bool kTfGrad = kTable != kNoTable;
  // Dynamic shared memory, 16-byte aligned: with kSharedTable the (ntf, 4)
  // f64 gradient table first, then the (ntf, 4) f32 TF table (read as
  // float4 by march_common.cuh:shade; the density gradient reads its
  // slope, so every table keeps it).
  extern __shared__ float4 smem4[];
  double* smem_d = reinterpret_cast<double*>(smem4);
  float* tf_s = reinterpret_cast<float*>(
      kTable == kSharedTable ? smem_d + ntf * 4 : smem_d);
  double* tfg_copy =
      kTfGrad ? tf_g + static_cast<int64_t>(
                           (blockIdx.y * gridDim.x + blockIdx.x) %
                           tf_copies) * ntf * 4
              : nullptr;
  double* tfg = kTable == kSharedTable ? smem_d : tfg_copy;
  __shared__ double red_s[2][kWarps];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < ntf * 4; i += blockDim.x * blockDim.y) {
    tf_s[i] = tf[i];
    if (kTable == kSharedTable) tfg[i] = 0.0;
  }
  __syncthreads();
  const march::Window win = march::load_window(window);

  const int px = blockIdx.x * kTile + threadIdx.x;
  const int py = blockIdx.y * kTile + threadIdx.y;
  const int64_t ray = static_cast<int64_t>(py) * width + px;
  // No early return: every lane takes part in the warp's votes and TF
  // flushes and every thread in the block reductions below.
  bool live = px < width && py < height && hit[ray];
  march::Ray rr{};
  float4 o{}, g{};
  if (live) {
    rr = march::load_ray(pos0, dirs, ray);
    o = reinterpret_cast<const float4*>(out)[ray];
    g = reinterpret_cast<const float4*>(grad)[ray];
  }
  // The steps this ray can own on a depth chunk, as K1 walks them
  // (march_common.cuh:owned_steps; [0, num_steps) on the whole volume).  A
  // lane whose interval is empty starts dead, and each lane walks from its
  // own k_begin: only the loop's trip count is the warp's.
  int k = 0, k_end = 0;
  if (live) {
    march::owned_steps(grid, rr, dt, num_steps, k, k_end);
    live = k < k_end;
  }
  const float big_g = g.x * o.x + g.y * o.y + g.z * o.z;
  const float ga_tfin = g.w * (1.0f - o.w);
  const float fntf = static_cast<float>(ntf);
  float tr = 1.0f, p = 0.0f;
  double dmin_acc = 0.0, dmax_acc = 0.0;
  // the current run: its two texels and their f64 gradient sums
  int run_lo = -1, run_hi = -1;
  double acc_lo[4] = {0.0, 0.0, 0.0, 0.0};
  double acc_hi[4] = {0.0, 0.0, 0.0, 0.0};
  march::Sample s;
  // what the counted instantiation counts: every lane counts its warp's
  // trips of this loop and its flushes, which are the same on every lane
  int trips = 0, flushes = 0, n_sampled = 0, n_atomics = 0, n_reds = 0;
  for (; __any_sync(kFullWarp, live); ++k) {
    if (kCount) ++trips;
    bool sampled = false;
    if (live) {
      if (k >= k_end || (early_termination && !(tr > eps))) {
        live = false;
      } else {
        MARCH_WALKED_STEP(ray, k);
        const int kind =
            march::sample_step(vol, grid, tf_s, ntf, rr, win, k, dt, s);
        live = kind != march::kLeftBox;
        sampled = kind == march::kSampled;
      }
    }
    // A run ends where a sampled step has other texels, or with its ray.
    if (kTfGrad) {
      const bool ends =
          run_lo >= 0 &&
          (sampled ? (s.lo != run_lo || s.hi != run_hi) : !live);
      if (__any_sync(kFullWarp, ends)) {
        if (kCount) ++flushes;
        add_runs(tfg, ends ? run_lo : -1, acc_lo);
        add_runs(tfg, ends ? run_hi : -1, acc_hi);
        if (ends) {
          run_lo = run_hi = -1;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc_lo[c] = acc_hi[c] = 0.0;
        }
      }
    }
    if (!sampled) continue;
    if (kCount) ++n_sampled;

    const bool clamped = s.a > amax;
    const float a = march::clamp_alpha(s.a, amax);
    const float gc = g.x * s.r + g.y * s.g + g.z * s.b;
    const float ta = tr * a;
    p = p + ta * gc;
    const float suffix = big_g - p;
    const float one_minus_a = 1.0f - a;
    // max(1 - a, ALPHA_EPS), NaN propagating as torch.clamp does
    const float denom = (one_minus_a < alpha_eps) ? alpha_eps : one_minus_a;
    const float dr = ta * g.x, dg = ta * g.y, db = ta * g.z;
    const float da = clamped ? 0.0f : tr * gc + (ga_tfin - suffix) / denom;

    // TF-table gradient: the transpose of the 2-bin lerp.
    if (kTfGrad) {
      run_lo = s.lo;
      run_hi = s.hi;
      const float w1 = s.w, w0 = 1.0f - s.w;
      acc_lo[0] += static_cast<double>(dr * w0);
      acc_lo[1] += static_cast<double>(dg * w0);
      acc_lo[2] += static_cast<double>(db * w0);
      acc_lo[3] += static_cast<double>(da * w0);
      acc_hi[0] += static_cast<double>(dr * w1);
      acc_hi[1] += static_cast<double>(dg * w1);
      acc_hi[2] += static_cast<double>(db * w1);
      acc_hi[3] += static_cast<double>(da * w1);
    }

    // Density gradient through the lerp slope (tf[hi] - tf[lo]) * ntf.
    const float* tlo = tf_s + s.lo * 4;
    const float* thi = tf_s + s.hi * 4;
    const float dl_dt = dr * ((thi[0] - tlo[0]) * fntf) +
                        dg * ((thi[1] - tlo[1]) * fntf) +
                        db * ((thi[2] - tlo[2]) * fntf) +
                        da * ((thi[3] - tlo[3]) * fntf);
    if (kTfGrad) {
      dmin_acc += static_cast<double>(dl_dt * (s.t - 1.0f) * win.inv_w);
      dmax_acc += static_cast<double>(dl_dt * (-s.t) * win.inv_w);
    }
    const float dl_dd = dl_dt * win.inv_w;

    if (dl_dd != 0.0f) {
      scatter_corners(vol_g, grid, s, dl_dd, pairs != 0, n_atomics, n_reds);
    }
    tr = tr * (1.0f - a);
  }

  const int lane = tid & 31;
  if (kTfGrad) {
    // dmin_g / dmax_g: warp shuffles, then one partial per warp.
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      dmin_acc += __shfl_down_sync(kFullWarp, dmin_acc, offset);
      dmax_acc += __shfl_down_sync(kFullWarp, dmax_acc, offset);
    }
    const int warp = tid >> 5;
    if (lane == 0) {
      red_s[0][warp] = dmin_acc;
      red_s[1][warp] = dmax_acc;
    }
    __syncthreads();   // also orders the shared table's adds before its flush
    if (tid == 0) {
      double a0 = 0.0, a1 = 0.0;
      for (int i = 0; i < kWarps; ++i) {
        a0 += red_s[0][i];
        a1 += red_s[1][i];
      }
      atomicAdd(win_g + 0, a0);
      atomicAdd(win_g + 1, a1);
    }
  }
  if (kTable == kSharedTable) {
    for (int i = tid; i < ntf * 4; i += blockDim.x * blockDim.y) {
      const double v = tfg[i];
      if (v != 0.0) atomicAdd(tfg_copy + i, v);
    }
  }
  if (kCount) {
    const unsigned long long c[5] = {
        static_cast<unsigned long long>(n_sampled),
        static_cast<unsigned long long>(trips),
        static_cast<unsigned long long>(n_atomics),
        static_cast<unsigned long long>(lane == 0 ? flushes : 0),
        static_cast<unsigned long long>(n_reds)};
    march::add_block_counts(counts, c);
  }
}

size_t smem_bytes(int table, int ntf) {
  return static_cast<size_t>(ntf) * 4 *
         ((table == kSharedTable ? sizeof(double) : 0) + sizeof(float));
}

// The dynamic shared memory a grid-only launch asks for on `device`: its TF
// table, or more than half of what an SM has, so that an SM holds one block
// of the launch at a time (see the header).
cudaError_t no_table_smem(int device, int ntf, size_t* smem) {
  int per_sm = 0, reserved = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err != cudaSuccess) return err;
  *smem = std::max(smem_bytes(kNoTable, ntf),
                   static_cast<size_t>(per_sm / 2 - reserved + 16));
  return cudaSuccess;
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

// The blocks of the kernel with the table in global memory that one SM of
// `device` holds at once with `ntf` texels, and the device's SM count: a
// launch of more blocks than their product runs in several waves.
int march_bwd_occupancy(int device, int ntf, int* blocks_per_sm, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(kGlobalTable, ntf);
  const auto kernel = march_bwd_kernel<kGlobalTable, false>;
  err = march::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kTile * kTile, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device));
}

// Launches the re-march on `stream` and returns cudaGetLastError().  All
// pointers are device pointers.  pos0, dirs, hit, vol, tf and window are
// K1's inputs (march_fwd_launch); out is K1's (height, width, 4) output and
// grad its cotangent, same shape.  The caller zeroes the outputs: vol_g
// (nz, ny, nx) f32, tf_g (tf_copies, ntf, 4) f64, whose copies it sums,
// and win_g (2,) f64 = (dmin_g, dmax_g).  All contiguous, float4 arrays
// 16-byte aligned.  table (a Table): 1 sums each block's TF gradient in
// shared memory first (ntf*48 bytes of it, else ntf*16), 0 adds it to
// global memory directly, 2 computes vol_g alone (tf_g and win_g are not
// read and may be null, tf_copies is not read).  own_* as for
// march_fwd_launch: on a depth chunk, vol_g has the chunk's shape, halo row
// included.  The voxel gradient's scatter adds x-pairs of corners as float4
// reductions where nx % 4 == 0 and vol_g is 16-byte aligned, and corner by
// corner elsewhere (scatter_corners).  counts, where not null, launches the
// counted instantiation, which adds (samples, lane steps, voxel atomics, TF
// flushes, voxel reductions) to counts[0..5).
int march_bwd_launch(int device, const float* pos0, const float* dirs,
                     const unsigned char* hit, const float* vol, int nz,
                     int ny, int nx, int own_axis, int own_start,
                     int own_body, int own_total, const float* tf, int ntf,
                     const float* out, const float* grad, float* vol_g,
                     double* tf_g, int tf_copies, int table,
                     double* win_g, int height, int width,
                     const float* window, int num_steps, float dt,
                     int early_termination, float eps, float amax,
                     float alpha_eps, unsigned long long* counts,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table < kGlobalTable || table > kNoTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel =
      table == kSharedTable
          ? (counts ? march_bwd_kernel<kSharedTable, true>
                    : march_bwd_kernel<kSharedTable, false>)
      : table == kNoTable
          ? (counts ? march_bwd_kernel<kNoTable, true>
                    : march_bwd_kernel<kNoTable, false>)
          : (counts ? march_bwd_kernel<kGlobalTable, true>
                    : march_bwd_kernel<kGlobalTable, false>);
  size_t smem = smem_bytes(table, ntf);
  if (table == kNoTable) {
    err = no_table_smem(device, ntf, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = march::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const march::Grid vgrid = march::make_grid(nz, ny, nx, own_axis, own_start,
                                             own_body, own_total);
  const int pairs =
      nx % 4 == 0 && reinterpret_cast<uintptr_t>(vol_g) % sizeof(float4) == 0;
  const dim3 block(kTile, kTile);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos0, dirs, hit, vol, vgrid, tf, ntf, out, grad, vol_g, tf_g,
      tf_copies, win_g, height, width, window, num_steps, dt,
      early_termination, eps, amax, alpha_eps, pairs, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
