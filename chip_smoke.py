#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the forward and backward ray-march kernels (``volumetric_renderer_
torch/csrc/march_fwd.cu``, ``march_bwd.cu``) and the depth fold's kernels
(``csrc/fold.cu``) with nvcc, holds each against
its plain PyTorch version on the card (K1 bit for bit, on border and
depth-chunk cases too, with rays whose chunk step interval is empty),
holds render gradients through both against plain autograd, renders a 256^3 NRRD volume at 1920x1080 / 512 steps
through the port's ``render_cli``, trains through ``apps.optimize`` at the
sizes of BASELINE configs 3 (TF fit, 1920x1080) and 4 (grid inversion, 32
views, with checkpoint and resume), and times the kernels against the plain
versions.  The multi-device path (``parallel/``): both kernels on depth
chunks (the ownership range ``own``) against their plain versions, a 512^3
volume folded from 4 depth chunks by the fold kernels against the
whole-volume frame and its gradients, K2's device time on each of those
chunks (where it walks only the steps the chunk can own) beside K2 on the
whole grid, with chunk 1 against its plain version, the fold kernels
against their plain versions and autograd on the 4 chunks' partials of an
8-view config-5 step (phase ``fold_kernel_vs_plain``), and, in a one-rank
NCCL process group, the depth renderer's gather and fold, the
pixel-sharded config-5 frame (512^3, 1920x1080, 512 steps) and ``apps.optimize
--parallel pixels|depth`` at that size.  Both train steps march all their
views at once: config 4 and config 5 under ``--parallel depth`` must make
one K1 and one K2 launch a step (the depth step one copy into K1's
texture), and one step of each (config 4; config 5 depth with 4 views on
two opposing arcs) is held against a loop of one march per view built
here.  It also holds K1 and K2 against their plain versions on one
config-4 view and on both steps' stacked rays, launches both kernels under
``torch.cuda.set_sync_debug_mode("error")``, and computes each kernel's
bound from the steps its inputs make it sample.  The phase
``no_host_waits`` runs a second call of each main path (the reference
frame and config 2's through ``render``, the config-3, config-4 and
config-5 pixel-sharded train steps, and the config-5 depth-sharded one in
the one-rank NCCL group; host cameras, Adam) under sync-debug mode
"error", so that a wait for the card fails the run, and counts each
call's synchronizing CUDA runtime calls with the profiler (they must be
0).  Each phase prints one JSON
object per line; the line before the last lists the kernels (times, bounds,
launches per training step); the last line is ``{"ok": true, "device":
{...}}``.  Any failed check raises, so the run exits non-zero; without a
CUDA device it exits non-zero before any work.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

SMALL_N, SMALL_STEPS, SMALL_HW = 64, 128, (96, 96)   # kernel-vs-plain cases
SMALL_ATOL = 1e-5
# K2 against its plain version: its sums are taken by atomics in another
# order on every run (f32 for the grid, f64 for the TF and window).
BWD_ATOL, BWD_RTOL = 1e-4, 1e-5
BWD_NOTE = ("atomics reorder the sums (f32 grid, f64 TF and window): not "
            "bitwise repeatable")
GRAD_ATOL = 1e-4        # render grads through K1 + K2 vs oracle autograd
FRAME_N, FRAME_W, FRAME_H, FRAME_STEPS, NTF = 256, 1920, 1080, 512, 256
# With early termination, a ray whose T lands within an ulp of eps may take
# one sample more or fewer: 1e-5 on 99.99% of pixels, 1/255 everywhere.
FRAME_ATOL, FRAME_SHARE, FRAME_MAX = 1e-5, 0.9999, 1.0 / 255.0
KERNELS = {
    "march_fwd": ("volumetric_renderer_torch/csrc/march_fwd.cu",
                  "volumetric_renderer_tpu/kernels/slab.py:160"),
    "march_bwd": ("volumetric_renderer_torch/csrc/march_bwd.cu",
                  "volumetric_renderer_tpu/kernels/slab.py:912"),
    "fold": ("volumetric_renderer_torch/csrc/fold.cu",
             "volumetric_renderer_tpu/parallel/depth.py:68 composite_chunks "
             "(XLA, no Pallas)"),
}
PLAIN_BWD_LIMIT_S = 120.0   # time the plain backward at fewer steps past it
OWN_CHUNKS = (2, 4)     # depth chunks of the small kernel-vs-plain cases
C5_N, C5_CHUNKS = 512, 4    # config 5: a 512^3 grid; the depth fold's chunks
# A folded frame reassociates every composite: 1e-5 on 99.99% of pixels and
# 1/255 everywhere, as FRAME_*; the chunk gradients against the whole-volume
# ones within 5e-4 of the largest (tests/test_depth.py's bar).
FOLD_GRAD_REL = 5e-4
# Bounds: the larger of operations over the f32 peak and bytes over the
# memory rate (H100 SXM data sheet, 700 W).  Operations of one sampled step,
# counted from the sources (PERF.md §6): march_common.cuh:sample_step 87
# (position 7, box and slicing tests 12, texel coordinate and weights 15,
# corner weights 19, trilinear 16, window 2, TF lerp 16), K1's composite and
# ET test 11; K2 adds 99 (opacity clamp 2, g.c 5, prefix and suffix 4,
# dL/dc 3, dL/da 5, TF runs 17, dL/dt 15, window gradients 8, corner weights
# and atomics 35, T 2, ET test 1).  No multiply-add is contracted
# (-fmad=false), so each counts once against a peak that counts an FMA as 2.
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
OPS_PER_STEP = {"march_fwd": 98, "march_bwd": 186}
# The fold kernels against their plain versions: the forward bit for bit,
# each chunk's backward within FOLD_KERNEL_REL of the largest gradient (the
# closed form rounds T and the fold behind another way than autograd).
FOLD_VIEWS, FOLD_KERNEL_REL = 8, 1e-6


def emit(**obj):
    print(json.dumps(obj), flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def max_errs(got, want):
    """Per-output max abs error and whether each is within BWD_ATOL /
    BWD_RTOL, for ``(vol_g, tf_g, dmin_g, dmax_g)``."""
    names = ("vol", "tf", "dmin", "dmax")
    errs = {n: float((a - b).abs().max()) for n, a, b in zip(names, got, want)}
    ok = all(bool(torch.isfinite(a).all()) and bool(torch.allclose(
        a, b, atol=BWD_ATOL, rtol=BWD_RTOL)) for a, b in zip(got, want))
    return errs, ok


def step_grads_close(got, want):
    """Whether the gradients ``(vol_g, tf_g)`` of a train step are finite
    and within BWD_RTOL of ``want`` plus an absolute bar of BWD_ATOL times
    the largest ``|want|`` where that is below 1: a loss averaged over
    millions of pixels gives the grid ~1e-8 a voxel, which a bare 1e-4
    would pass whatever it held.  ``(ok, {name: bar})``."""
    bars = {n: BWD_ATOL * min(1.0, float(b.abs().max()))
            for n, b in zip(("vol", "tf"), want)}
    ok = all(bool(torch.isfinite(a).all()) and bool(torch.allclose(
        a, b, atol=bar, rtol=BWD_RTOL))
        for a, b, bar in zip(got, want, bars.values()))
    return ok, bars


def sampled_steps(args, march, own=None):
    """The steps K1 and K2 sample on these inputs: inside the box and the
    slicing window, on a hit ray, on a depth chunk ``own = (axis, start,
    body, total)`` where the chunk owns the sample (its lower corner along
    the axis in [start, start + body), from -1 on the first chunk) and,
    with early termination, while T > eps.  The bounds count this work."""
    from volumetric_renderer_torch.core.fused import ALPHA_EPS
    from volumetric_renderer_torch.core.marcher import step_offsets
    from volumetric_renderer_torch.core.sampling import trilinear_sample
    from volumetric_renderer_torch.transfer.texture import sample_tf
    vol, tf, pos0, dirs, hit, dmin, inv_w, smin, smax = args
    check(own is None or not march["early_termination"],
          "sampled_steps: early termination on a chunk is not counted")
    tr = torch.ones(hit.shape, device=hit.device)
    count = torch.zeros((), dtype=torch.int64, device=hit.device)
    offsets = step_offsets(march["num_steps"], march["step_size"],
                           torch.float32, hit.device)
    for k in range(march["num_steps"]):
        pos = pos0 + offsets[k] * dirs
        active = (((pos >= 0.0) & (pos <= 1.0)).all(-1)
                  & ((pos < smax) & (pos > smin)).all(-1) & hit)
        if own is not None:
            axis, start, body, total = own
            corner = torch.floor(pos[..., 2 - axis] * total - 0.5)
            active &= ((corner >= (-1 if start == 0 else start))
                       & (corner < start + body))
        if march["early_termination"]:
            active = active & (tr > march["termination_eps"])
            t = torch.where(active,
                            (trilinear_sample(vol, pos) - dmin) * inv_w, 0.0)
            a = sample_tf(tf, t)[..., 3].clamp(max=1.0 - ALPHA_EPS)
            tr = tr * (1.0 - torch.where(active, a, 0.0))
        count += active.sum()
    return int(count)


def bound(name, args, march, own=None):
    """``(bound_ms, bound_by, work)`` of kernel ``name`` on these inputs
    (on the depth chunk ``own``, if given): each input read once and each
    output written once, against the operations of the steps it
    samples."""
    vol, tf, pos0, dirs, hit = args[:5]
    hw = hit.numel()
    nbytes = (4 * (vol.numel() + pos0.numel() + dirs.numel() + tf.numel())
              + hw + 32 + 16 * hw)            # inputs, window, out
    if name == "march_bwd":                   # g; vol_g, tf_g (f64), win_g
        nbytes += 16 * hw + 4 * vol.numel() + 8 * tf.numel() + 16
    steps = sampled_steps(args, march, own)
    ops = OPS_PER_STEP[name] * steps
    t_ops, t_bytes = 1e3 * ops / PEAK_F32_OPS, 1e3 * nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
            "bytes", dict(sampled_steps=steps, operations=ops, bytes=nbytes,
                          ops_ms=t_ops, bytes_ms=t_bytes))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from volumetric_renderer_torch import models
    from volumetric_renderer_torch.apps import (
        ablation, bench, benchmark, optimize, render_cli, scaling, turntable,
        viewer,
    )
    from volumetric_renderer_torch.apps.time_kernels import (
        cuda_ms, device_ms, host_waits,
    )
    from volumetric_renderer_torch.core.marcher import (
        frame_inputs, prepare_rays,
    )
    from volumetric_renderer_torch.data.formats import read_png_image
    from volumetric_renderer_torch.data.importer import import_volume
    from volumetric_renderer_torch.data.nrrd import write_nrrd
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.kernels import _build
    from volumetric_renderer_torch.kernels import fold as kfold
    from volumetric_renderer_torch.kernels.fold import (
        fold, fold_backward, fold_backward_plain, fold_forward,
        fold_forward_plain,
    )
    from volumetric_renderer_torch.kernels.march import (
        _one_wave, load_library, march_backward, march_backward_plain,
        march_forward, march_forward_plain, make_kernel_marcher,
    )
    from volumetric_renderer_torch.parallel.depth import (
        _GatherFold, chunk_of, dominant_axis, fold_partials,
        make_depth_sharded_renderer,
    )
    from volumetric_renderer_torch.parallel.distributed import (
        init_distributed,
    )
    from volumetric_renderer_torch.parallel.mesh import make_layout
    from volumetric_renderer_torch.parallel.render import (
        make_sharded_renderer,
    )
    from volumetric_renderer_torch.parallel.train import (
        init_depth_state, init_state, make_depth_train_step,
        make_train_step, stack_cameras,
    )
    from volumetric_renderer_torch.render.api import (
        composite_over, make_marcher, render,
    )
    from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.config import RenderSettings
    from volumetric_renderer_torch.utils.sanitize import (
        assert_deterministic, checked_render,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gpu = torch.cuda.get_device_name(0)

    def counted(fn):
        """``fn()`` with the kernels' launch counts and K1's texture-copy
        count set to 0 just before; returns its result and the counts."""
        torch.cuda.synchronize()
        march_forward.launches = march_backward.launches = 0
        fold_forward.launches = fold_backward.launches = 0
        march_forward.texture_fills = 0
        res = fn()
        torch.cuda.synchronize()
        return res, {"march_fwd": march_forward.launches,
                     "march_bwd": march_backward.launches,
                     "texture_fills": march_forward.texture_fills,
                     "fold_fwd": fold_forward.launches,
                     "fold_bwd": fold_backward.launches}

    def quietly(fn, *args):
        """``fn(*args)`` with its printed lines sent to stderr: this run's
        stdout holds one JSON object per line."""
        with contextlib.redirect_stdout(sys.stderr):
            return fn(*args)

    def kernel_inputs(vol, tf, cam, settings, window=(None, None),
                      slicing=(None, None)):
        """The kernel's arguments and march settings, as ``render`` makes
        them."""
        origin, dirs, dmin, dmax, smin, smax = frame_inputs(
            vol, cam, settings, *window, *slicing)
        pos0, hit, inv_w = prepare_rays(origin, dirs, dmin, dmax)
        march = dict(num_steps=settings.num_steps,
                     step_size=settings.step_size,
                     early_termination=settings.early_termination,
                     termination_eps=settings.termination_eps)
        return (vol, tf, pos0, dirs, hit, dmin, inv_w, smin, smax), march

    # -- 0. start ---------------------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit(phase="start", gpu=gpu, nvidia_smi=smi,
         device_count=torch.cuda.device_count(), torch=torch.__version__,
         torch_cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=run([_build.find_nvcc(), "--version"]).splitlines()[-1])

    # -- 1. build: one nvcc per source, started together ------------------
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, built in builds.items():
        if name == "fold":
            kfold.load_library()
        else:
            load_library(name)
        emit(phase="build", kernel=name, source=KERNELS[name][0],
             seconds=built.seconds,
             ptxas=[ln.strip() for ln in built.log.splitlines()
                    if "Used" in ln or "spill" in ln])

    def cotangent(shape, seed):
        g = np.random.default_rng(seed).normal(size=shape)
        return torch.as_tensor(g.astype(np.float32), device=dev)

    # -- 2. kernel vs plain on the card, small cases ----------------------
    rng = np.random.default_rng(0)
    ramp = Gradient.grayscale_ramp().discretize(NTF)
    ramp[:, 3] = np.linspace(0.0, 1.0, NTF, dtype=np.float32) ** 2
    tf_ramp = torch.as_tensor(ramp, device=dev)       # the bench.py TF
    tf_rand = torch.as_tensor(rng.uniform(0.0, 1.0, (NTF, 4))
                              .astype(np.float32), device=dev)
    sphere = Volume.synthetic_sphere(SMALL_N).as_torch(dev)
    nan_vol = sphere.clone()
    nan_vol[2, 2, 2] = float("nan")
    cases = [
        dict(name=f"orient_{y}_{p}", yaw=y, pitch=p)
        for y, p in ((30.0, 20.0), (120.0, -35.0), (200.0, 5.0), (0.0, 80.0))
    ] + [
        dict(name="early_termination", et=True),
        dict(name="slicing", slicing=((0.1, 0.2, 0.0), (0.9, 1.0, 0.7))),
        dict(name="image_30x20", hw=(30, 20)),
        dict(name="close_wide_fov", radius=0.9, fov=90.0),
        dict(name="constant_volume", tf=tf_rand,
             vol=torch.full((SMALL_N,) * 3, 0.5, device=dev)),
        dict(name="nan_voxel_outside_slicing", vol=nan_vol, et=True,
             window=(0.0, 1.0), slicing=((0.2,) * 3, (0.8,) * 3)),
        # K1's border: rays along the faces, at a corner, a 2^3 grid
        dict(name="graze_faces", yaw=0.0, pitch=0.0),
        dict(name="graze_corner", yaw=45.0, pitch=35.26),
        dict(name="grid_2", vol=torch.as_tensor(
            rng.uniform(0.0, 1.0, (2, 2, 2)).astype(np.float32),
            device=dev)),
    ]
    for c in cases:
        h, w = c.get("hw", SMALL_HW)
        settings = RenderSettings(
            height=h, width=w, step_size=1.8 / SMALL_STEPS,
            fov_y_degrees=c.get("fov", 40.0),
            early_termination=c.get("et", False))
        cam = OrbitCamera.from_angles(c.get("yaw", 30.0), c.get("pitch", 20.0),
                                      c.get("radius", 3.0))
        args, march = kernel_inputs(
            c.get("vol", sphere), c.get("tf", tf_ramp), cam, settings,
            c.get("window", (None, None)), c.get("slicing", (None, None)))
        got = march_forward(*args, **march)
        ref = march_forward_plain(*args, **march)
        torch.cuda.synchronize()
        check(got.shape == (h, w, 4), f"{c['name']}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{c['name']}: non-finite")
        err = float((got - ref).abs().max())
        equal = bool(torch.equal(got, ref))
        emit(phase="kernel_vs_plain", case=c["name"], shape=[h, w],
             steps=settings.num_steps, hit_rays=int(args[4].sum()),
             alpha_max=float(got[..., 3].max()), max_abs_err=err,
             bitwise_equal=equal)
        check(equal, f"{c['name']}: K1 differs from plain, max abs err "
              f"{err}")
        if c["name"] == "early_termination":
            # the same case through the plain version on the host
            host = march_forward_plain(*(a.cpu() for a in args), **march)
            err = float((got.cpu() - host).abs().max())
            emit(phase="kernel_vs_plain_on_host", case=c["name"],
                 max_abs_err=err, atol=SMALL_ATOL)
            check(err <= SMALL_ATOL, f"host plain: max abs err {err}")

    # -- 2b. K2 vs plain on the card, small cases -------------------------
    clamp_tf = ramp.copy()
    clamp_tf[:, 3] = np.minimum(1.0, np.linspace(0.0, 2.0, NTF))
    cases.append(dict(name="clamped_alpha",
                      tf=torch.as_tensor(clamp_tf, device=dev)))
    bwd_small_err = 0.0
    for i, c in enumerate(cases):
        h, w = c.get("hw", SMALL_HW)
        settings = RenderSettings(
            height=h, width=w, step_size=1.8 / SMALL_STEPS,
            fov_y_degrees=c.get("fov", 40.0),
            early_termination=c.get("et", False))
        cam = OrbitCamera.from_angles(c.get("yaw", 30.0), c.get("pitch", 20.0),
                                      c.get("radius", 3.0))
        args, march = kernel_inputs(
            c.get("vol", sphere), c.get("tf", tf_ramp), cam, settings,
            c.get("window", (None, None)), c.get("slicing", (None, None)))
        out = march_forward(*args, **march)
        g = cotangent((h, w, 4), 100 + i)
        got = march_backward(*args, out, g, **march)
        ref = march_backward_plain(*args, out, g, **march)
        torch.cuda.synchronize()
        errs, ok = max_errs(got, ref)
        bwd_small_err = max(bwd_small_err, *errs.values())
        emit(phase="kernel_bwd_vs_plain", case=c["name"], shape=[h, w],
             steps=settings.num_steps, max_abs_err=errs,
             max_abs={n: float(a.abs().max()) for n, a in
                      zip(("vol", "tf", "dmin", "dmax"), ref)},
             atol=BWD_ATOL, rtol=BWD_RTOL, note=BWD_NOTE)
        check(ok, f"{c['name']}: K2 vs plain {errs}")

    # -- 2c. render grads through K1 + K2 vs oracle autograd --------------
    tf8 = Gradient.grayscale_ramp().discretize(8)
    tf8[:, 3] = np.linspace(0.0, 1.0, 8, dtype=np.float32) ** 2
    for n, steps, et in ((8, 12, False), (12, 20, True), (12, 20, False)):
        settings = RenderSettings(height=16, width=16, step_size=1.8 / steps,
                                  early_termination=et)
        cam = OrbitCamera.from_angles(120.0, -35.0)
        grads = {}
        for method in ("oracle", "kernel"):
            leaves = [Volume.synthetic_sphere(n).as_torch(dev),
                      torch.as_tensor(tf8, device=dev),
                      torch.tensor(0.0, device=dev),
                      torch.tensor(1.0, device=dev)]
            for x in leaves:
                x.requires_grad_(True)
            img = render(leaves[0], leaves[1], cam, settings,
                         density_min=leaves[2], density_max=leaves[3],
                         method=method)
            (img ** 2).sum().backward()
            grads[method] = [x.grad for x in leaves]
        errs = {name: float((a - b).abs().max()) for name, a, b in zip(
            ("vol", "tf", "dmin", "dmax"), grads["kernel"], grads["oracle"])}
        emit(phase="kernel_grad_vs_oracle", grid=n, shape=[16, 16],
             steps=steps, early_termination=et, max_abs_err=errs,
             atol=GRAD_ATOL)
        check(all(e <= GRAD_ATOL for e in errs.values()),
              f"grid {n} et {et}: render grads vs oracle {errs}")

    # -- 2d. K1 and K2 on depth chunks vs plain, small cases --------------
    own_fwd_err = own_bwd_err = 0.0
    settings = RenderSettings(height=SMALL_HW[0], width=SMALL_HW[1],
                              step_size=1.8 / SMALL_STEPS,
                              early_termination=False)
    # one view each way, and one along y: its rays cross few x-chunks, so
    # many walk no step of the others (an empty step interval)
    for yaw, pitch in ((30.0, 20.0), (210.0, -20.0), (0.0, 0.0)):
        args, march = kernel_inputs(sphere, tf_ramp,
                                    OrbitCamera.from_angles(yaw, pitch),
                                    settings)
        whole = march_forward(*args, **march)
        for axis in range(3):
            full = march_forward(chunk_of(sphere, 0, SMALL_N, axis),
                                 *args[1:], **march,
                                 own=(axis, 0, SMALL_N, SMALL_N))
            check(torch.equal(full, whole), f"axis {axis}: the whole-volume "
                  "range differs from no range")
            for n in OWN_CHUNKS:
                body = SMALL_N // n
                parts, k1_err, k2_errs, k2_ok = [], 0.0, {}, True
                k1_equal = True
                for c in range(n):
                    cargs = (chunk_of(sphere, c, body, axis),) + args[1:]
                    own = (axis, c * body, body, SMALL_N)
                    got = march_forward(*cargs, **march, own=own)
                    ref = march_forward_plain(*cargs, **march, own=own)
                    k1_equal = k1_equal and bool(torch.equal(got, ref))
                    g = cotangent(SMALL_HW + (4,), 300 + c)
                    errs, ok = max_errs(
                        march_backward(*cargs, got, g, **march, own=own),
                        march_backward_plain(*cargs, got, g, **march,
                                             own=own))
                    torch.cuda.synchronize()
                    k1_err = max(k1_err, float((got - ref).abs().max()))
                    k2_errs = {k: max(v, k2_errs.get(k, 0.0))
                               for k, v in errs.items()}
                    k2_ok = k2_ok and ok
                    parts.append(got)
                fold_err = float((fold_partials(torch.stack(parts), args[3],
                                                axis) - whole).abs().max())
                own_fwd_err = max(own_fwd_err, k1_err)
                own_bwd_err = max(own_bwd_err, *k2_errs.values())
                emit(phase="own_kernel_vs_plain", grid=SMALL_N,
                     view=[yaw, pitch], axis=axis, chunks=n,
                     shape=list(SMALL_HW), steps=settings.num_steps,
                     k1_max_abs_err=k1_err, k1_bitwise_equal=k1_equal,
                     k2_max_abs_err=k2_errs, k2_atol=BWD_ATOL,
                     k2_rtol=BWD_RTOL, fold_vs_whole_max_abs_err=fold_err,
                     whole_range_bitwise=True)
                check(k1_equal, f"own K1 differs from plain: {k1_err}")
                check(k2_ok, f"own K2 vs plain {k2_errs}")
                check(fold_err <= 1e-4, f"folded chunks vs whole {fold_err}")

    # -- 3. main path: NRRD import -> render_cli on the card --------------
    with tempfile.TemporaryDirectory() as tmp:
        nrrd = os.path.join(tmp, "head.nrrd")
        npy = os.path.join(tmp, "head.npy")
        png = os.path.join(tmp, "head.png")
        t0 = time.perf_counter()
        head = models.head_phantom(FRAME_N)
        write_nrrd(nrrd, (head.data * 60000).astype(np.uint16),
                   encoding="gzip")
        setup_s = time.perf_counter() - t0
        argv = [nrrd, "--size", f"{FRAME_W}x{FRAME_H}", "--steps",
                str(FRAME_STEPS), "--tf", "preset:ramp", "--yaw", "30",
                "--pitch", "20", "--device", "cuda", "--npy", npy,
                "--out", png]
        march_forward.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):   # the CLI's own lines
            render_cli.main(argv)
        cli_s = time.perf_counter() - t0
        launches = march_forward.launches
        img = np.load(npy)
        png_bytes = os.path.getsize(png)
        # the same frame through the plain version, from the same file
        vol = import_volume(nrrd).as_torch(dev)
    tf = torch.as_tensor(render_cli.load_tf("preset:ramp", NTF), device=dev)
    settings = RenderSettings(height=FRAME_H, width=FRAME_W,
                              step_size=1.8 / FRAME_STEPS)
    plain = render(vol, tf, OrbitCamera.from_angles(30.0, 20.0), settings,
                   method="fused").cpu().numpy()
    alpha = img[..., 3]
    diff = np.abs(img - plain).max(axis=-1)
    err = float(diff.max())
    share = float((diff <= FRAME_ATOL).mean())
    emit(phase="main_path", entry="volumetric_renderer_torch.apps.render_cli",
         argv=argv[1:], volume=f"head_phantom({FRAME_N}) uint16 gzip NRRD",
         setup_s=setup_s, cli_s=cli_s, launches=launches,
         shape=list(img.shape), finite=bool(np.isfinite(img).all()),
         alpha_max=float(alpha.max()),
         share_alpha_gt_001=float((alpha > 0.01).mean()), png_bytes=png_bytes,
         max_abs_err_vs_plain=err, share_within_atol=share,
         atol=FRAME_ATOL)
    check(img.shape == (FRAME_H, FRAME_W, 4), f"frame shape {img.shape}")
    check(bool(np.isfinite(img).all()), "frame has non-finite values")
    check(float(alpha.max()) > 0.9, f"alpha max {alpha.max()}")
    check(float((alpha > 0.01).mean()) > 0.10, "too few covered pixels")
    check(launches >= 1, "the main path never launched the kernel")
    check(share >= FRAME_SHARE, f"only {share} of pixels within {FRAME_ATOL}")
    check(err <= FRAME_MAX, f"frame max abs err {err} > 1/255")
    del vol, plain

    # -- 3b. training main path: apps.optimize at configs 3 and 4 ---------
    def optimize_run(argv, want_fwd, want_bwd):
        """``apps.optimize.main(argv)``; its K1 and K2 launches must be
        ``want_fwd`` and ``want_bwd``."""
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log), \
                contextlib.redirect_stdout(sys.stderr):
            res, launches = counted(lambda: optimize.main(argv))
        wall_s = time.perf_counter() - t0
        print(log.getvalue(), end="", file=sys.stderr, flush=True)
        losses = res["losses"]
        emit(phase="train_main_path",
             entry="volumetric_renderer_torch.apps.optimize", argv=argv,
             start=res["start"], steps_run=len(losses), loss_first=losses[0],
             loss_last=losses[-1], err_vs_truth=res["err"],
             train_s=res["train_s"], rays_per_s=res["rays_per_s"],
             wall_s=wall_s, method=res["method"], launches=launches)
        check(res["method"] == "kernel", f"method {res['method']}")
        check(all(np.isfinite(losses)), f"non-finite loss {losses}")
        got = (launches["march_fwd"], launches["march_bwd"])
        check(got == (want_fwd, want_bwd),
              f"launches {launches}, want ({want_fwd}, {want_bwd})")
        return res, launches

    def per_step(n, views, res):
        """Launches and K1 texture copies per training step: all but those
        of the target renders (one launch a view, one copy of the truth)."""
        steps = len(res["losses"])
        return {"march_fwd": (n["march_fwd"] - views) / steps,
                "march_bwd": n["march_bwd"] / steps,
                "texture_fills": (n["texture_fills"] - 1) / steps}

    main_launches = {"march_fwd": launches, "march_bwd": 0}
    steps3, views4 = 5, 32
    res, n = optimize_run(
        ["tf-fit", "--grid", str(FRAME_N), "--size", f"{FRAME_W}x{FRAME_H}",
         "--march-steps", str(FRAME_STEPS), "--views", "1", "--steps-opt",
         str(steps3), "--device", "cuda"], 1 + steps3, steps3)
    check(res["losses"][-1] < res["losses"][0], f"config 3 loss did not "
          f"fall: {res['losses']}")
    launches_per_step = {"reference_frame": {"march_fwd": launches,
                                             "march_bwd": 0},
                         "config3": per_step(n, 1, res)}
    for k in main_launches:
        main_launches[k] += n[k]
    with tempfile.TemporaryDirectory() as ck:
        inv = ["invert", "--grid", str(FRAME_N), "--size", "256x256",
               "--march-steps", str(FRAME_STEPS), "--views", str(views4),
               "--ckpt-dir", ck, "--ckpt-every", "2", "--device", "cuda"]
        # the target renders (one K1 launch a view), then one K1 and one
        # K2 launch a step for all 32 views
        first, n = optimize_run(inv + ["--steps-opt", "4"], views4 + 4, 4)
        launches_per_step["config4"] = per_step(n, views4, first)
        for k in main_launches:
            main_launches[k] += n[k]
        check(first["losses"][-1] < first["losses"][0],
              f"config 4 loss did not fall: {first['losses']}")
        check({k: launches_per_step["config4"][k]
               for k in ("march_fwd", "march_bwd")} ==
              {"march_fwd": 1, "march_bwd": 1},
              f"config 4 per step {launches_per_step['config4']}")
        # the grid changes once per Adam step: one copy into K1's texture
        check(launches_per_step["config4"]["texture_fills"] == 1,
              f"config 4 texture copies {launches_per_step['config4']}")
        resumed, n = optimize_run(inv + ["--steps-opt", "6", "--resume"],
                                  views4 + 2, 2)
        for k in main_launches:
            main_launches[k] += n[k]
        check(resumed["start"] == 4, f"resumed at step {resumed['start']}")
        check(resumed["losses"][-1] < first["losses"][0],
              f"resumed loss {resumed['losses']} not below the first "
              f"{first['losses'][0]}")

    # -- 3b'. one config-4 step both ways: all views in one march (the
    # train step) against a loop of one march per view built here
    t_phase = time.perf_counter()
    s4 = RenderSettings(height=256, width=256, step_size=1.8 / FRAME_STEPS,
                        early_termination=False)        # as optimize.py
    vol = Volume.synthetic_sphere(FRAME_N).as_torch(dev)
    cams4 = [OrbitCamera.from_angles(float(a), 20.0) for a in
             np.linspace(0.0, 360.0, views4, endpoint=False)]
    window4 = dict(dmin=vol.min(), dmax=vol.max(),
                   smin=torch.zeros(3, device=dev),
                   smax=torch.ones(3, device=dev))
    with torch.no_grad():
        targets4 = torch.stack([render(vol, tf_ramp, c, s4, method="kernel")
                                for c in cams4])
    init4 = {"vol": torch.full_like(vol, 0.3), "tf": tf_ramp * 0.5}
    fixed4 = dict(window4, vol=vol, tf=tf_ramp)
    step4 = make_train_step(s4, optimize_vol=True, optimize_tf=True,
                            row_layout="tile-cyclic")

    def batched4():
        state = init_state(init4, lambda p: torch.optim.SGD(p, lr=0.0))
        state, loss = step4(state, fixed4, cams4, targets4)
        return float(loss), [state.params[k].grad for k in ("vol", "tf")]

    per_view4 = make_sharded_renderer(None, s4, row_layout="tile-cyclic",
                                      permuted_output=True,
                                      reduce_grads=False)
    _, _, pack4, _, valid4 = make_layout("tile-cyclic", 256, 256, 1)
    valid4 = valid4.to(dev)[..., None]

    def loop4():
        xs = [init4[k].clone().requires_grad_(True) for k in ("vol", "tf")]
        total = torch.zeros((), device=dev)
        for i, c in enumerate(cams4):
            img = per_view4(*xs, c, *window4.values())
            loss_v = torch.sum((img - pack4(targets4[i])) ** 2 * valid4) \
                / float(256 * 256 * 4)
            (loss_v / views4).backward()
            total = total + loss_v.detach()
        return float(total / views4), [x.grad for x in xs]

    (loss_b, grads_b), n_b = counted(batched4)
    (loss_l, grads_l), n_l = counted(loop4)
    errs4 = {"loss": abs(loss_b - loss_l)}
    errs4.update({k: float((a - b).abs().max()) for k, a, b in
                  zip(("vol", "tf"), grads_b, grads_l)})
    close4, atol4 = step_grads_close(grads_b, grads_l)
    ok4 = abs(loss_b - loss_l) <= 1e-5 * abs(loss_l) and close4
    step4_ms = cuda_ms(batched4, 5)
    loop4_ms = cuda_ms(loop4, 3)
    emit(phase="config4_step_both_ways", entry="parallel.train."
         "make_train_step", views=views4, shape=[256, 256],
         steps=FRAME_STEPS, row_layout="tile-cyclic", gpu=gpu,
         nvidia_smi=smi, loss=loss_b, loss_per_view_loop=loss_l,
         max_abs_err=errs4,
         max_abs={k: float(b.abs().max()) for k, b in
                  zip(("vol", "tf"), grads_l)},
         atol=atol4, rtol=BWD_RTOL, note=BWD_NOTE, launches=n_b,
         launches_per_view_loop=n_l, step_ms=step4_ms,
         per_view_loop_ms=loop4_ms, seconds=time.perf_counter() - t_phase)
    check(ok4, f"config-4 step, one march vs the per-view loop: {errs4}")
    check((n_b["march_fwd"], n_b["march_bwd"]) == (1, 1) and
          (n_l["march_fwd"], n_l["march_bwd"]) == (views4, views4),
          f"config-4 step launches {n_b}, per-view loop {n_l}")
    bwd_small_err = max(bwd_small_err, errs4["vol"], errs4["tf"])
    del targets4, init4, fixed4, grads_b, grads_l

    # -- 3c. depth fold at config-5 size: 4 chunks along z, one device ---
    vol5 = Volume.synthetic_sphere(C5_N).as_torch(dev)
    s5 = RenderSettings(height=FRAME_H, width=FRAME_W,
                        step_size=1.8 / FRAME_STEPS, early_termination=False)
    cam = OrbitCamera.from_angles(30.0, 20.0)
    args5, march5 = kernel_inputs(vol5, tf_ramp, cam, s5)
    origin, dirs, dmin, dmax, smin, smax = frame_inputs(vol5, cam, s5)
    body5 = C5_N // C5_CHUNKS
    g5 = cotangent((FRAME_H, FRAME_W, 4), 11)

    def fold_grads(n_chunks):
        """The frame and its (vol, tf, dmin, dmax) gradients of sum(img*g5):
        the whole volume (n_chunks 1, no range) or n_chunks depth chunks
        along z, folded per ray by the fold kernels (halo-row gradients
        land on their owners through chunk_of's backward)."""
        xs = [x.detach().requires_grad_(True)
              for x in (vol5, tf_ramp, dmin, dmax)]
        if n_chunks == 1:
            img = make_kernel_marcher(**march5)(
                xs[0], xs[1], origin, dirs, xs[2], xs[3], smin, smax)
        else:
            body = C5_N // n_chunks
            parts = [make_kernel_marcher(
                **march5, own=(0, c * body, body, C5_N))(
                chunk_of(xs[0], c, body, 0), xs[1], origin, dirs, xs[2],
                xs[3], smin, smax) for c in range(n_chunks)]
            img = fold(torch.stack(parts), dirs, 0)
        (img * g5).sum().backward()
        return img.detach(), [x.grad for x in xs]

    whole5, grads_w = fold_grads(1)
    (folded5, grads_c), n_fold = counted(lambda: fold_grads(C5_CHUNKS))
    fold_launches = {k: n_fold[k] for k in ("fold_fwd", "fold_bwd")}
    torch.cuda.synchronize()
    diff = (folded5 - whole5).abs().max(dim=-1).values
    fold_err, fold_share = float(diff.max()), float(
        (diff <= FRAME_ATOL).float().mean())
    grad_err = {n: float((a - b).abs().max()) for n, a, b in
                zip(("vol", "tf", "dmin", "dmax"), grads_c, grads_w)}
    grad_max = {n: float(b.abs().max()) for n, b in
                zip(("vol", "tf", "dmin", "dmax"), grads_w)}
    emit(phase="depth_fold_config5", grid=C5_N, chunks=C5_CHUNKS, axis=0,
         shape=[FRAME_H, FRAME_W], steps=FRAME_STEPS, early_termination=False,
         alpha_max=float(whole5[..., 3].max()), max_abs_err=fold_err,
         share_within_atol=fold_share, atol=FRAME_ATOL,
         grad_max_abs_err=grad_err, grad_max_abs=grad_max,
         grad_rel_bar=FOLD_GRAD_REL, launches=n_fold)
    check(bool(torch.isfinite(folded5).all()), "folded frame not finite")
    check(float(whole5[..., 3].max()) > 0.9, "config-5 frame is empty")
    check(fold_share >= FRAME_SHARE and fold_err <= FRAME_MAX,
          f"folded frame vs whole: {fold_err}, share {fold_share}")
    check(all(grad_err[n] <= FOLD_GRAD_REL * grad_max[n] for n in grad_err),
          f"chunk gradients vs whole: {grad_err} (max {grad_max})")
    check(fold_launches == {"fold_fwd": 1, "fold_bwd": C5_CHUNKS},
          f"the depth fold's fold launches {n_fold}")
    del whole5, folded5, grads_w, grads_c

    # timing: K1 on the whole 512^3 grid, and on its 4 chunks as the fold
    # marches them: each call cuts the chunks anew, and K1 copies each into
    # its texture
    k1_512_ms = cuda_ms(lambda: march_forward(*args5, **march5), 5)
    k1_512_device_ms = device_ms(lambda: march_forward(*args5, **march5), 5,
                                 "march_fwd_kernel")[0]

    def k1_fold():
        for c in range(C5_CHUNKS):
            march_forward(chunk_of(vol5, c, body5, 0), *args5[1:], **march5,
                          own=(0, c * body5, body5, C5_N))

    fold_ms = cuda_ms(k1_fold, 5)
    fold_device_ms = device_ms(k1_fold, 5, "march_fwd_kernel")[2]
    fold_copy_ms = device_ms(k1_fold, 5, "Memcpy")[2]

    # K2 on each chunk, where it walks only the steps the chunk can own,
    # beside K2 on the whole grid; on chunk 1 also against its plain version
    out5 = march_forward(*args5, **march5)
    k2_512 = dict(whole_device_ms=device_ms(
        lambda: march_backward(*args5, out5, g5, **march5), 5,
        "march_bwd_kernel")[0], chunk_device_ms=[], chunk_ms=[],
        chunk_bounds=[])
    for c in range(C5_CHUNKS):
        cargs = (chunk_of(vol5, c, body5, 0),) + args5[1:]
        own = (0, c * body5, body5, C5_N)
        cout = march_forward(*cargs, **march5, own=own)

        def k2_chunk(cargs=cargs, cout=cout, own=own):
            return march_backward(*cargs, cout, g5, **march5, own=own)

        k2_512["chunk_ms"].append(cuda_ms(k2_chunk, 5))
        k2_512["chunk_device_ms"].append(
            device_ms(k2_chunk, 5, "march_bwd_kernel")[0])
        k2_512["chunk_bounds"].append(bound("march_bwd", cargs, march5,
                                            own))
        if c == 1:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ref = march_backward_plain(*cargs, cout, g5, **march5, own=own)
            ev[1].record()
            torch.cuda.synchronize()
            k2_512["chunk1_plain_ms"] = ev[0].elapsed_time(ev[1])
            k2_512["chunk1_max_abs_err"], ok = max_errs(k2_chunk(), ref)
            check(ok, f"512^3 chunk 1: K2 vs plain "
                  f"{k2_512['chunk1_max_abs_err']}")
            own_bwd_err = max(own_bwd_err,
                              *k2_512["chunk1_max_abs_err"].values())
            del ref
        del cargs, cout
    k2_512["chunk_device_sum_ms"] = sum(k2_512["chunk_device_ms"])
    del out5
    emit(phase="timing_depth_chunks",
         workload=f"{C5_N}^3 sphere, {FRAME_W}x{FRAME_H}, {FRAME_STEPS} "
         f"steps, ET off, ntf {NTF}, {C5_CHUNKS} chunks along z", gpu=gpu,
         nvidia_smi=smi, k1_whole_ms=k1_512_ms,
         k1_whole_device_ms=k1_512_device_ms, k1_fold_ms=fold_ms,
         k1_fold_kernels_device_ms=fold_device_ms,
         k1_fold_copies_device_ms=fold_copy_ms,
         fold_over_whole=fold_ms / k1_512_ms, k2=k2_512, k2_atol=BWD_ATOL,
         k2_rtol=BWD_RTOL)

    # -- 3c'. the fold kernels against their plain versions at config-5
    # width: the 4 chunks' (8*1080, 1920, 4) partials of an 8-view depth
    # step (made from a seed), folded along the views' rays, which march
    # both ways along the split axis (the optimize app's two opposing arcs)
    t_phase = time.perf_counter()
    yaws_f = np.concatenate([np.linspace(-40.0, 40.0, FOLD_VIEWS // 2),
                             np.linspace(140.0, 220.0, FOLD_VIEWS // 2)])
    cams_f = [OrbitCamera.from_angles(float(a), 20.0) for a in yaws_f]
    axis_f = dominant_axis(cams_f)
    dirs_f = frame_inputs(vol5, stack_cameras(cams_f), s5)[1]
    dirs_f = dirs_f.reshape(-1, FRAME_W, 3).contiguous()
    gen = torch.Generator(device=dev).manual_seed(13)
    shape_f = (C5_CHUNKS,) + tuple(dirs_f.shape[:2])
    alpha_f = 0.999 * torch.rand(shape_f + (1,), generator=gen, device=dev)
    parts_f = torch.cat([alpha_f * torch.rand(shape_f + (3,), generator=gen,
                                              device=dev), alpha_f], -1)
    g_f = torch.randn(tuple(dirs_f.shape[:2]) + (4,), generator=gen,
                      device=dev)
    del alpha_f
    reverse_f = dirs_f[..., 2 - axis_f] < 0.0
    rays_f, n_rev = reverse_f.numel(), int(reverse_f.sum())
    check(0 < n_rev < rays_f, f"fold rays march one way only ({n_rev} of "
          f"{rays_f} reversed)")
    got_f = fold_forward(parts_f, dirs_f, axis_f)
    plain_f = fold_forward_plain(parts_f, dirs_f, axis_f)
    fold_equal = bool(torch.equal(got_f, plain_f))
    fold_fwd_err = float((got_f - plain_f).abs().max())
    del plain_f
    x_f = parts_f.clone().requires_grad_(True)
    (fold_partials(x_f, dirs_f, axis_f) * g_f).sum().backward()
    auto_f = x_f.grad
    del x_f
    fold_bwd_err, fold_bwd_auto_err, fold_grad_max = [], [], []
    for r in range(C5_CHUNKS):
        got_r = fold_backward(parts_f, dirs_f, axis_f, g_f, r)
        plain_r = fold_backward_plain(parts_f, dirs_f, axis_f, g_f, r)
        fold_bwd_err.append(float((got_r - plain_r).abs().max()))
        fold_bwd_auto_err.append(float((got_r - auto_f[r]).abs().max()))
        fold_grad_max.append(float(auto_f[r].abs().max()))
        del got_r, plain_r
    del auto_f
    fold_bwd_ok = all(
        a <= FOLD_KERNEL_REL * m and b <= FOLD_KERNEL_REL * m
        for a, b, m in zip(fold_bwd_err, fold_bwd_auto_err, fold_grad_max))

    def fold_fwd_call():
        return fold_forward(parts_f, dirs_f, axis_f)

    def fold_bwd_call(r=1):
        return fold_backward(parts_f, dirs_f, axis_f, g_f, r)

    def fold_bound(backward, r=1):
        """``(bound_ms, bound_by, work)`` of one fold call on these rays:
        the forward reads every partial, the backward the n - 1 partials
        other than chunk r's and g; both read the directions and write
        16 bytes a ray.  Operations per ray from fold.cu: 10 per over, 1
        compare; the backward 2 per chunk before r, 10 per over behind it
        beyond the first, 12 for the gradient."""
        n = C5_CHUNKS
        if not backward:
            nbytes = rays_f * (16 * n + 12 + 16)
            ops = rays_f * (10 * (n - 1) + 1)
        else:
            nbytes = rays_f * (16 * (n - 1) + 12 + 16 + 16)
            ops = 0
            for pos, count in ((r, rays_f - n_rev), (n - 1 - r, n_rev)):
                ops += count * (1 + 2 * pos + 10 * max(n - 2 - pos, 0) + 12)
        t_ops, t_bytes = 1e3 * ops / PEAK_F32_OPS, 1e3 * nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
                "bytes", dict(operations=ops, bytes=nbytes, ops_ms=t_ops,
                              bytes_ms=t_bytes))

    fold_t = dict(
        fwd_ms=cuda_ms(fold_fwd_call, 10),
        fwd_device_ms=device_ms(fold_fwd_call, 10, "fold_fwd_kernel")[0],
        bwd_ms=cuda_ms(fold_bwd_call, 10),
        bwd_device_ms=device_ms(fold_bwd_call, 10, "fold_bwd_kernel")[0],
        fwd_plain_ms=cuda_ms(
            lambda: fold_forward_plain(parts_f, dirs_f, axis_f), 3),
        bwd_plain_ms=cuda_ms(lambda: fold_backward_plain(
            parts_f, dirs_f, axis_f, g_f, 1), 3),
        bwd_device_ms_per_chunk=[device_ms(
            lambda r=r: fold_bwd_call(r), 5, "fold_bwd_kernel")[0]
            for r in range(C5_CHUNKS)])
    fold_b = {"forward": fold_bound(False), "backward": fold_bound(True)}
    fold_shape = list(dirs_f.shape[:2])
    emit(phase="fold_kernel_vs_plain", chunks=C5_CHUNKS, views=FOLD_VIEWS,
         shape=fold_shape, axis=axis_f, rays_reversed=n_rev,
         gpu=gpu, nvidia_smi=smi, fwd_bitwise_equal_plain=fold_equal,
         fwd_max_abs_err=fold_fwd_err,
         bwd_max_abs_err_vs_plain=fold_bwd_err,
         bwd_max_abs_err_vs_autograd=fold_bwd_auto_err,
         bwd_max_abs=fold_grad_max, rel_bar=FOLD_KERNEL_REL, **fold_t,
         bounds=fold_b, seconds=time.perf_counter() - t_phase)
    check(fold_equal, "the fold kernel differs from fold_forward_plain")
    check(fold_bwd_ok, f"fold backward vs plain {fold_bwd_err}, vs autograd "
          f"{fold_bwd_auto_err} (max {fold_grad_max})")
    del parts_f, g_f, got_f, dirs_f, reverse_f

    # -- 3d. one-rank NCCL group: the sharded frame and optimize at config 5
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    rank_dev = init_distributed(f"tcp://localhost:{port}", 1, 0,
                                device="cuda")
    probe = torch.full((4,), 2.0, device=rank_dev)
    dist.all_reduce(probe)      # the group's NCCL communicator works
    torch.cuda.synchronize()

    # the depth renderer's gather and fold (_GatherFold) in this group: one
    # all_gather into one buffer, then the fold kernels on one chunk, which
    # give back the partial and the cotangent themselves
    part1 = torch.rand((64, FRAME_W, 4), generator=gen, device=dev)
    g1 = torch.randn((64, FRAME_W, 4), generator=gen, device=dev)
    dir1 = torch.randn((64, FRAME_W, 3), generator=gen, device=dev)

    def gather_fold_one_rank():
        x = part1.clone().requires_grad_(True)
        img = _GatherFold.apply(x, dir1, 0, None, 0, 1)
        (img * g1).sum().backward()
        return img.detach(), x.grad

    (img1, grad1), n_gf = counted(gather_fold_one_rank)
    gf_exact = bool(torch.equal(img1, part1) and torch.equal(grad1, g1))
    emit(phase="process_group", backend=dist.get_backend(),
         world=dist.get_world_size(), rank=dist.get_rank(),
         device=str(rank_dev), all_reduce=probe.tolist(),
         gather_fold_exact=gf_exact, gather_fold_launches=n_gf)
    check(dist.get_backend() == "nccl" and probe.tolist() == [2.0] * 4,
          f"process group {dist.get_backend()}: {probe.tolist()}")
    check(gf_exact and (n_gf["fold_fwd"], n_gf["fold_bwd"]) == (1, 1),
          f"_GatherFold in a one-rank group: exact {gf_exact}, {n_gf}")
    del part1, g1, dir1, img1, grad1
    s5_et = RenderSettings(height=FRAME_H, width=FRAME_W,
                           step_size=1.8 / FRAME_STEPS)    # ET on
    sharded = make_sharded_renderer(None, s5_et, row_layout="tile-cyclic")
    march_forward.launches = 0
    img_s = sharded(vol5, tf_ramp, cam, None, None, None, None)
    torch.cuda.synchronize()
    sharded_launches = march_forward.launches
    img_r = render(vol5, tf_ramp, cam, s5_et, method="kernel")
    diff = (img_s - img_r).abs().max(dim=-1).values
    sh_err, sh_share = float(diff.max()), float(
        (diff <= FRAME_ATOL).float().mean())
    emit(phase="sharded_frame_config5", entry="parallel.render."
         "make_sharded_renderer", row_layout="tile-cyclic", grid=C5_N,
         shape=list(img_s.shape), steps=FRAME_STEPS, early_termination=True,
         launches=sharded_launches, max_abs_err_vs_render_kernel=sh_err,
         exact=sh_err == 0.0, share_within_atol=sh_share)
    check(img_s.shape == (FRAME_H, FRAME_W, 4), f"shape {img_s.shape}")
    check(sharded_launches == 1, f"{sharded_launches} K1 launches")
    check(sh_share >= FRAME_SHARE and sh_err <= FRAME_MAX,
          f"sharded frame vs render: {sh_err}, share {sh_share}")
    main_launches["march_fwd"] += sharded_launches
    sharded_ms = cuda_ms(lambda: sharded(vol5, tf_ramp, cam, None, None,
                                         None, None), 5)
    render_ms = cuda_ms(lambda: render(vol5, tf_ramp, cam, s5_et,
                                       method="kernel"), 5)
    del img_s, img_r

    c5 = ["invert", "--grid", str(C5_N), "--size", f"{FRAME_W}x{FRAME_H}",
          "--march-steps", str(FRAME_STEPS), "--views", "2", "--device",
          "cuda"]
    res, n = optimize_run(c5 + ["--parallel", "pixels", "--steps-opt", "3"],
                          2 + 3, 3)
    check(res["losses"][-1] < res["losses"][0],
          f"config 5 pixels: loss did not fall: {res['losses']}")
    c5_pixels = res
    for k in main_launches:
        main_launches[k] += n[k]
    with tempfile.TemporaryDirectory() as ck:
        dep = c5 + ["--parallel", "depth", "--ckpt-dir", ck, "--ckpt-every",
                    "2"]
        # the target renders (one K1 launch and one chunk copied into
        # K1's texture a view), then one K1 and one K2 launch and one
        # texture copy a step for both views
        first, n = optimize_run(dep + ["--steps-opt", "2"], 2 + 2, 2)
        launches_per_step["config5_depth"] = {
            "march_fwd": (n["march_fwd"] - 2) / 2,
            "march_bwd": n["march_bwd"] / 2,
            "texture_fills": (n["texture_fills"] - 2) / 2}
        check(n["texture_fills"] == 2 + 2, f"config 5 depth texture "
              f"copies {n}")
        for k in main_launches:
            main_launches[k] += n[k]
        resumed, n = optimize_run(dep + ["--steps-opt", "3", "--resume"],
                                  2 + 1, 1)
        for k in main_launches:
            main_launches[k] += n[k]
    check(first["losses"][-1] < first["losses"][0] and
          resumed["start"] == 2 and
          resumed["losses"][-1] < first["losses"][0],
          f"config 5 depth: {first['losses']} then {resumed['losses']}")

    # the config-5 step through the train step itself: one 1080p view
    with torch.no_grad():
        target5 = render(vol5, tf_ramp, cam, s5, method="kernel")[None]
    fixed5 = dict(vol=vol5, tf=tf_ramp, dmin=vol5.min(), dmax=vol5.max(),
                  smin=torch.zeros(3, device=dev),
                  smax=torch.ones(3, device=dev))
    step5 = make_train_step(s5, optimize_vol=True, optimize_tf=False,
                            row_layout="tile-cyclic")
    state5 = [init_state({"vol": torch.full_like(vol5, 0.3)},
                         lambda p: torch.optim.Adam(p, lr=5e-2))]

    def config5_step():
        state5[0], _ = step5(state5[0], fixed5, [cam], target5)

    step5_ms = cuda_ms(config5_step, 5)
    emit(phase="timing_config5", workload=f"{C5_N}^3 sphere, {FRAME_W}x"
         f"{FRAME_H}, {FRAME_STEPS} steps, one-rank NCCL group, tile-cyclic",
         gpu=gpu, nvidia_smi=smi, sharded_frame_ms=sharded_ms,
         render_kernel_frame_ms=render_ms, train_step_1view_ms=step5_ms,
         app_pixels_step_ms=1e3 * c5_pixels["train_s"] /
         len(c5_pixels["losses"]),
         app_depth_step_ms=1e3 * first["train_s"] / len(first["losses"]),
         app_pixels_rays_per_s=c5_pixels["rays_per_s"],
         app_depth_rays_per_s=first["rays_per_s"])
    del state5, fixed5, target5

    # -- 3d'. one config-5 depth step both ways: 4 views on the optimize
    # app's two opposing arcs in one call of the depth-sharded renderer
    # (the train step) against a loop of one call per view built here
    t_phase = time.perf_counter()
    yaws5d = np.concatenate([np.linspace(-40.0, 40.0, 2),
                             np.linspace(140.0, 220.0, 2)])
    cams5d = [OrbitCamera.from_angles(float(a), 20.0) for a in yaws5d]
    axis5d = dominant_axis(cams5d)
    window5d = dict(dmin=vol5.min(), dmax=vol5.max(),
                    smin=torch.zeros(3, device=dev),
                    smax=torch.ones(3, device=dev))
    per_view5d = make_depth_sharded_renderer(
        None, s5, vol_shape=vol5.shape, axis=axis5d, reduce_grads=False)
    with torch.no_grad():
        targets5d = torch.stack([per_view5d(vol5, tf_ramp, c,
                                            *window5d.values())
                                 for c in cams5d])
    init5d = {"vol": torch.full_like(vol5, 0.3), "tf": tf_ramp * 0.5}
    fixed5d = dict(window5d, vol=vol5, tf=tf_ramp)
    step5d = make_depth_train_step(s5, optimize_vol=True, optimize_tf=True,
                                   vol_shape=vol5.shape, axis=axis5d)

    def batched5d():
        state = init_depth_state(init5d, lambda p: torch.optim.SGD(
            p, lr=0.0), axis=axis5d)
        state, loss = step5d(state, fixed5d, cams5d, targets5d)
        return float(loss), [state.params[k].grad for k in ("vol", "tf")]

    def loop5d():
        xs = [init5d[k].clone().requires_grad_(True) for k in ("vol", "tf")]
        total = torch.zeros((), device=dev)
        for i, c in enumerate(cams5d):
            img = per_view5d(*xs, c, *window5d.values())
            loss_v = torch.mean((img - targets5d[i]) ** 2)
            (loss_v / len(cams5d)).backward()
            total = total + loss_v.detach()
        return float(total / len(cams5d)), [x.grad for x in xs]

    (loss_b, grads_b), n_b = counted(batched5d)
    (loss_l, grads_l), n_l = counted(loop5d)
    errs5d = {"loss": abs(loss_b - loss_l)}
    errs5d.update({k: float((a - b).abs().max()) for k, a, b in
                   zip(("vol", "tf"), grads_b, grads_l)})
    close5d, atol5d = step_grads_close(grads_b, grads_l)
    ok5d = abs(loss_b - loss_l) <= 1e-6 * abs(loss_l) and close5d
    max5d = {k: float(b.abs().max()) for k, b in zip(("vol", "tf"),
                                                      grads_l)}
    del grads_b, grads_l
    step5d_ms = cuda_ms(batched5d, 3)
    loop5d_ms = cuda_ms(loop5d, 3)
    emit(phase="config5_depth_step_both_ways", entry="parallel.train."
         "make_depth_train_step", grid=C5_N, views=len(cams5d),
         yaws=yaws5d.tolist(), axis=axis5d, shape=[FRAME_H, FRAME_W],
         steps=FRAME_STEPS, world=dist.get_world_size(),
         backend=dist.get_backend(), gpu=gpu, nvidia_smi=smi, loss=loss_b,
         loss_per_view_loop=loss_l, loss_rtol=1e-6, max_abs_err=errs5d,
         max_abs=max5d, atol=atol5d, rtol=BWD_RTOL, note=BWD_NOTE,
         launches=n_b, launches_per_view_loop=n_l, step_ms=step5d_ms,
         per_view_loop_ms=loop5d_ms, seconds=time.perf_counter() - t_phase)
    check(ok5d, f"config-5 depth step, one call vs the per-view loop: "
          f"{errs5d}")
    check(max5d["vol"] > 0 and max5d["tf"] > 0, f"zero gradients {max5d}")
    check((n_b["march_fwd"], n_b["march_bwd"], n_b["texture_fills"]) ==
          (1, 1, 1) and (n_l["march_fwd"], n_l["march_bwd"],
                         n_l["texture_fills"]) == (4, 4, 4),
          f"config-5 depth step launches {n_b}, per-view loop {n_l}")
    bwd_small_err = max(bwd_small_err, errs5d["vol"], errs5d["tf"])

    # K1 and K2 on that step's rays: the 4 views stacked along rows, the
    # rank's chunk (the whole grid plus a zero halo row in a world of one)
    origin, dirs, dmin, dmax, smin, smax = frame_inputs(
        vol5, stack_cameras(cams5d), s5, window5d["dmin"], window5d["dmax"])
    dirs = dirs.reshape(-1, FRAME_W, 3).contiguous()
    origin = origin.reshape(-1, 1, 1, 3).expand(-1, FRAME_H, 1, 3)
    pos0, hit, inv_w = prepare_rays(origin.reshape(-1, 1, 3), dirs, dmin,
                                    dmax)
    own5d = (axis5d, 0, C5_N, C5_N)
    args5d = (chunk_of(vol5, 0, C5_N, axis5d), tf_ramp, pos0, dirs, hit,
              dmin, inv_w, smin, smax)
    del targets5d, init5d, fixed5d, origin, pos0

    def k1_5d():
        return march_forward(*args5d, **march5, own=own5d)

    out5d = k1_5d()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    g5d = cotangent(tuple(hit.shape) + (4,), 12)
    ev[0].record()
    ref5d = march_forward_plain(*args5d, **march5, own=own5d)
    ev[1].record()
    ref5d_g = march_backward_plain(*args5d, out5d, g5d, **march5, own=own5d)
    ev[2].record()
    torch.cuda.synchronize()
    k1_5d_equal = bool(torch.equal(out5d, ref5d))
    k1_5d_err = float((out5d - ref5d).abs().max())
    errs5d_k, ok5d_k = max_errs(
        march_backward(*args5d, out5d, g5d, **march5, own=own5d), ref5d_g)
    del ref5d, ref5d_g

    def k2_5d():
        return march_backward(*args5d, out5d, g5d, **march5, own=own5d)

    depth5d = dict(
        shape=list(hit.shape), own=list(own5d),
        k1_ms=cuda_ms(k1_5d, 5),
        k1_device_ms=device_ms(k1_5d, 5, "march_fwd_kernel")[0],
        k1_plain_ms=ev[0].elapsed_time(ev[1]),
        k2_ms=cuda_ms(k2_5d, 5),
        k2_device_ms=device_ms(k2_5d, 5, "march_bwd_kernel")[0],
        k2_plain_ms=ev[1].elapsed_time(ev[2]),
        bounds={k: bound(k, args5d, march5)[:2]
                for k in ("march_fwd", "march_bwd")},
        k1_bitwise_equal_plain=k1_5d_equal, k1_max_abs_err=k1_5d_err,
        k2_max_abs_err=errs5d_k)
    emit(phase="kernel_vs_plain", case="config5_depth_stacked",
         **depth5d, atol=BWD_ATOL, rtol=BWD_RTOL, note=BWD_NOTE, gpu=gpu,
         nvidia_smi=smi)
    check(k1_5d_equal, f"config-5 depth stacked rays: K1 differs from "
          f"plain by {k1_5d_err}")
    check(ok5d_k, f"config-5 depth stacked rays: K2 vs plain {errs5d_k}")
    bwd_small_err = max(bwd_small_err, *errs5d_k.values())
    own_fwd_err = max(own_fwd_err, k1_5d_err)
    del args5d, out5d, g5d, dirs, hit, args5

    # -- 3d''. no host waits: the second call of each main path under
    # sync-debug mode "error", where a wait for the card raises (the error
    # is never caught: it fails the run), from host cameras, with Adam as
    # the optimize app runs it; and each call's synchronizing CUDA runtime
    # calls counted by the profiler
    t_phase = time.perf_counter()

    def without_waits(fn):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def adam(p):
        return torch.optim.Adam(p, lr=5e-2)

    def pixel_step(settings, cams, params, fixed):
        step = make_train_step(settings, optimize_vol="vol" in params,
                               optimize_tf="tf" in params,
                               row_layout="tile-cyclic")
        with torch.no_grad():
            targets = torch.stack([render(fixed["vol"], fixed["tf"], c,
                                          settings) for c in cams])
        state = [init_state(params, adam)]

        def one():
            state[0], loss = step(state[0], fixed, cams, targets)
            return loss

        return one

    s_ref = RenderSettings(height=FRAME_H, width=FRAME_W,
                           step_size=1.8 / FRAME_STEPS)            # ET on
    s3 = s_ref.replace(early_termination=False)       # as optimize.py
    cam_ref = OrbitCamera.from_angles(30.0, 20.0)
    vol2nw = models.head_phantom(128).as_torch(dev)       # config 2
    s2_nw = RenderSettings(height=512, width=512, step_size=1.8 / 360)
    tf2nw = torch.as_tensor(ablation.bone_tf(NTF), device=dev)
    fixed256 = dict(window4, vol=vol, tf=tf_ramp)
    fixed512 = dict(window5d, vol=vol5, tf=tf_ramp)
    state5dnw = [init_depth_state({"vol": torch.full_like(vol5, 0.3)}, adam,
                                  axis=axis5d)]
    with torch.no_grad():
        targets5dnw = torch.stack([per_view5d(vol5, tf_ramp, c,
                                              *window5d.values())
                                   for c in cams5d])
    step5dnw = make_depth_train_step(s5, optimize_vol=True,
                                     optimize_tf=False, vol_shape=vol5.shape,
                                     axis=axis5d)
    fixed5dnw = dict(window5d, vol=vol5, tf=tf_ramp)

    def depth_step():
        state5dnw[0], loss = step5dnw(state5dnw[0], fixed5dnw, cams5d,
                                      targets5dnw)
        return loss

    nw_paths = {
        "reference_frame": (lambda: render(vol, tf_ramp, cam_ref, s_ref),
                            False),
        "config2_frame": (lambda: render(vol2nw, tf2nw, cam_ref, s2_nw),
                          False),
        "config3_step": (pixel_step(s3, [cam_ref],
                                    {"tf": tf_ramp * 0.5}, fixed256), True),
        "config4_step": (pixel_step(s4, cams4,
                                    {"vol": torch.full_like(vol, 0.3)},
                                    fixed256), True),
        "config5_pixels_step": (pixel_step(
            s5, [OrbitCamera.from_angles(float(a), 20.0)
                       for a in (0.0, 180.0)],
            {"vol": torch.full_like(vol5, 0.3)}, fixed512), True),
        "config5_depth_step": (depth_step, True),
    }
    no_waits = {}
    for name, (fn, trains) in nw_paths.items():
        fn()                                  # builds, allocates, warms up
        out, n = counted(lambda: without_waits(fn))
        no_waits[name] = dict(
            host_waits_per_call=host_waits(fn), launches=n,
            ms=cuda_ms(fn, 5), finite=bool(torch.isfinite(out).all()))
        for k in main_launches:
            main_launches[k] += n[k]
    emit(phase="no_host_waits", sync_debug_mode="error", gpu=gpu,
         nvidia_smi=smi, cameras="on the host", optimizer="Adam",
         world=dist.get_world_size(), backend=dist.get_backend(),
         paths=no_waits, seconds=time.perf_counter() - t_phase)
    for name, r in no_waits.items():
        trains = nw_paths[name][1]
        check(r["finite"], f"no_host_waits {name}: non-finite output")
        check(r["launches"]["march_fwd"] == 1 and
              r["launches"]["march_bwd"] == int(trains),
              f"no_host_waits {name}: launches {r['launches']}")
        check(r["host_waits_per_call"] == 0, f"no_host_waits {name}: "
              f"{r['host_waits_per_call']} synchronizing calls a call")
    del (nw_paths, state5dnw, targets5dnw, fixed5dnw, fixed256, fixed512,
         vol2nw, vol5)

    # -- 3e. apps.benchmark: devices=1 in this one-rank NCCL group --------
    t_phase = time.perf_counter()
    bm_argv = ["--grid", str(FRAME_N), "--size", f"{FRAME_W}x{FRAME_H}",
               "--steps", str(FRAME_STEPS), "--iters", "10"]
    bm_fwd, n_fwd = counted(lambda: quietly(benchmark.main, bm_argv))
    bm_grad, n_grad = counted(lambda: quietly(benchmark.main,
                                              bm_argv + ["--grad"]))
    # its checksums, as the JAX benchmark's: the sum of the frame and of
    # the grid's gradient of mean(img**2), here through render on the same
    # grid, TF, camera and window (0, 1)
    bm_vol = Volume.synthetic_sphere(FRAME_N).as_torch(dev).requires_grad_()
    bm_img = render(bm_vol, torch.as_tensor(Gradient.grayscale_ramp()
                                            .discretize(256), device=dev),
                    OrbitCamera.from_angles(30.0, 20.0),
                    RenderSettings(height=FRAME_H, width=FRAME_W,
                                   step_size=1.8 / FRAME_STEPS),
                    density_min=0.0, density_max=1.0, method="kernel")
    bm_want = {"forward": float(bm_img.detach().double().sum()),
               "grad": float(torch.autograd.grad(torch.mean(bm_img ** 2),
                                                 bm_vol)[0].double().sum())}
    bm_got = {"forward": bm_fwd["scaling"][0]["checksum"],
              "grad": bm_grad["scaling"][0]["checksum"]}
    del bm_vol, bm_img
    emit(phase="benchmark", entry="volumetric_renderer_torch.apps.benchmark",
         argv=bm_argv, gpu=gpu, nvidia_smi=smi, world=dist.get_world_size(),
         forward=bm_fwd["scaling"], grad=bm_grad["scaling"],
         launches={"forward": n_fwd, "grad": n_grad},
         checksum=bm_got, checksum_through_render=bm_want,
         seconds=time.perf_counter() - t_phase)
    check([r["devices"] for r in bm_fwd["scaling"]] == [1] and
          [r["devices"] for r in bm_grad["scaling"]] == [1],
          f"benchmark sizes {bm_fwd['scaling']}")
    check(n_fwd["march_fwd"] >= 11 and n_grad["march_fwd"] >= 11 and
          n_grad["march_bwd"] >= 11, f"benchmark launches {n_fwd} {n_grad}")
    check(all(np.isfinite(bm_got[k]) and bm_want[k] != 0 and
              abs(bm_got[k] - bm_want[k]) <= 1e-4 * abs(bm_want[k])
              for k in bm_got), f"benchmark checksums {bm_got} against "
          f"render's {bm_want}")
    dist.destroy_process_group()

    # -- 4. timing: the bench.py workload ---------------------------------
    vol = Volume.synthetic_sphere(FRAME_N).as_torch(dev)
    cam = OrbitCamera.from_angles(30.0, 20.0)
    args, march = kernel_inputs(vol, tf_ramp, cam, settings)
    kernel_ms = cuda_ms(lambda: march_forward(*args, **march), 5)
    kernel_device_ms = device_ms(lambda: march_forward(*args, **march), 5,
                                 "march_fwd_kernel")[0]
    # K1 with the whole-volume ownership range (a zero halo row appended)
    whole_chunk = (chunk_of(vol, 0, FRAME_N, 0),) + args[1:]
    whole_own = (0, 0, FRAME_N, FRAME_N)
    own_ms = cuda_ms(lambda: march_forward(*whole_chunk, **march,
                                           own=whole_own), 5)
    kernel_ms_again = cuda_ms(lambda: march_forward(*args, **march), 5)
    del whole_chunk
    frame_ms = cuda_ms(lambda: render(vol, tf_ramp, cam, settings,
                                      method="kernel"), 5)
    plain_ms = cuda_ms(lambda: march_forward_plain(*args, **march), 3)
    k1_bound_ms, k1_bound_by, k1_work = bound("march_fwd", args, march)
    rays = FRAME_H * FRAME_W
    emit(phase="timing", workload=f"{FRAME_N}^3 sphere, {FRAME_W}x{FRAME_H}, "
         f"{FRAME_STEPS} steps, ET on, ntf {NTF}", gpu=gpu, nvidia_smi=smi,
         kernel_ms=kernel_ms, kernel_device_ms=kernel_device_ms,
         kernel_ms_again=kernel_ms_again,
         kernel_whole_range_own_ms=own_ms, plain_ms=plain_ms,
         frame_ms=frame_ms, bound_ms=k1_bound_ms, bound_by=k1_bound_by,
         work=k1_work,
         kernel_rays_per_s=rays / (kernel_ms / 1e3),
         plain_rays_per_s=rays / (plain_ms / 1e3),
         frame_rays_per_s=rays / (frame_ms / 1e3))

    # -- 4b. timing: the training step at config 3 ------------------------
    settings = RenderSettings(height=FRAME_H, width=FRAME_W,
                              step_size=1.8 / FRAME_STEPS,
                              early_termination=False)   # as optimize.py
    args, march = kernel_inputs(vol, tf_ramp, cam, settings)
    g = cotangent((FRAME_H, FRAME_W, 4), 7)
    k1_ms = cuda_ms(lambda: march_forward(*args, **march), 5)
    k1_device_ms = device_ms(lambda: march_forward(*args, **march), 5,
                             "march_fwd_kernel")[0]
    out = march_forward(*args, **march)
    k2_ms = cuda_ms(lambda: march_backward(*args, out, g, **march), 5)
    k2_bound_ms, k2_bound_by, k2_work = bound("march_bwd", args, march)
    # K1 and K2 on one view of config 4 (the app's first: yaw 0, pitch 20)
    s4 = RenderSettings(height=256, width=256, step_size=1.8 / FRAME_STEPS,
                        early_termination=False)
    args4, march4 = kernel_inputs(vol, tf_ramp,
                                  OrbitCamera.from_angles(0.0, 20.0), s4)
    g4 = cotangent((256, 256, 4), 8)
    k1_view4_ms = cuda_ms(lambda: march_forward(*args4, **march4), 5)
    k1_view4_device_ms = device_ms(lambda: march_forward(*args4, **march4), 5,
                                   "march_fwd_kernel")[0]
    out4 = march_forward(*args4, **march4)
    k2_view4_ms = cuda_ms(
        lambda: march_backward(*args4, out4, g4, **march4), 5)
    view4_bounds = {k: bound(k, args4, march4)[:2]
                    for k in ("march_fwd", "march_bwd")}
    errs4, ok4 = max_errs(march_backward(*args4, out4, g4, **march4),
                          march_backward_plain(*args4, out4, g4, **march4))
    emit(phase="kernel_bwd_vs_plain", case="config4_view", shape=[256, 256],
         steps=FRAME_STEPS, max_abs_err=errs4, atol=BWD_ATOL, rtol=BWD_RTOL,
         note=BWD_NOTE)
    check(ok4, f"config-4 view: K2 vs plain {errs4}")
    bwd_small_err = max(bwd_small_err, *errs4.values())
    # K1 and K2 at the config-4 step's size: the 32 views' tile-cyclic
    # blocks stacked along rows, as the train step marches them
    origin, dirs, dmin, dmax, smin, smax = frame_inputs(
        vol, stack_cameras(cams4), s4)
    dirs = pack4(dirs.permute(1, 2, 0, 3)).permute(2, 0, 1, 3)
    rows4, cols4 = dirs.shape[1:3]
    origin = origin.reshape(-1, 1, 1, 3).expand(-1, rows4, 1, 3)
    dirs = dirs.reshape(-1, cols4, 3).contiguous()
    pos0, hit, inv_w = prepare_rays(origin.reshape(-1, 1, 3), dirs, dmin,
                                    dmax)
    args4s = (vol, tf_ramp, pos0, dirs, hit, dmin, inv_w, smin, smax)
    g4s = cotangent(tuple(hit.shape) + (4,), 9)
    out4s = march_forward(*args4s, **march4)
    k1_stacked_equal = bool(torch.equal(
        out4s, march_forward_plain(*args4s, **march4)))
    errs4s, ok4s = max_errs(march_backward(*args4s, out4s, g4s, **march4),
                            march_backward_plain(*args4s, out4s, g4s,
                                                 **march4))
    blocks4s = -(-hit.shape[0] // 16) * -(-hit.shape[1] // 16)
    stacked4 = dict(
        shape=list(hit.shape), blocks=blocks4s,
        k2_one_wave_blocks=_one_wave(load_library("march_bwd"),
                                     torch.cuda.current_device(), NTF),
        k1_ms=cuda_ms(lambda: march_forward(*args4s, **march4), 5),
        k1_device_ms=device_ms(lambda: march_forward(*args4s, **march4), 5,
                               "march_fwd_kernel")[0],
        k2_ms=cuda_ms(lambda: march_backward(*args4s, out4s, g4s, **march4),
                      5),
        k2_device_ms=device_ms(
            lambda: march_backward(*args4s, out4s, g4s, **march4), 5,
            "march_bwd_kernel")[0],
        bounds={k: bound(k, args4s, march4)[:2]
                for k in ("march_fwd", "march_bwd")},
        k1_bitwise_equal_plain=k1_stacked_equal, k2_max_abs_err=errs4s)
    stacked4["k2_shared_table"] = \
        stacked4["blocks"] > stacked4["k2_one_wave_blocks"]
    emit(phase="kernel_bwd_vs_plain", case="config4_stacked",
         shape=list(hit.shape), steps=FRAME_STEPS, max_abs_err=errs4s,
         atol=BWD_ATOL, rtol=BWD_RTOL, note=BWD_NOTE)
    check(k1_stacked_equal, "config-4 stacked rays: K1 differs from plain")
    check(ok4s, f"config-4 stacked rays: K2 vs plain {errs4s}")
    bwd_small_err = max(bwd_small_err, *errs4s.values())
    del args4s, out4s, g4s, pos0, dirs, hit

    # both kernels at config 3 with every input on the card: a launch that
    # waited on the device would raise under sync-debug mode "error"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_ns = march_forward(*args, **march)
        grads_ns = march_backward(*args, out_ns, g, **march)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ns_k1_equal = bool(torch.equal(out_ns, out))
    emit(phase="no_host_sync", sync_debug_mode="error", k1_equal=ns_k1_equal,
         k2_finite=all(bool(torch.isfinite(x).all()) for x in grads_ns))
    check(ns_k1_equal, "K1 under sync-debug mode differs")
    del out_ns, grads_ns

    def kernel_step():
        leaves = [vol.detach().requires_grad_(True),
                  tf_ramp.detach().requires_grad_(True)]
        img = render(leaves[0], leaves[1], cam, settings, method="kernel")
        (img * g).sum().backward()

    step_ms = cuda_ms(kernel_step, 5)
    # the optimizer's share of an invert step: Adam on the 256^3 grid
    grid = torch.zeros((FRAME_N,) * 3, device=dev, requires_grad=True)
    grid.grad = torch.ones_like(grid)
    adam = torch.optim.Adam([grid], lr=5e-2)
    adam_ms = cuda_ms(adam.step, 5)
    del grid, adam
    # the plain backward, timed at full depth unless that would take over
    # PLAIN_BWD_LIMIT_S (then at the probe's depth, and said so)
    probe = dict(march, num_steps=64)
    t0 = time.perf_counter()
    march_backward_plain(*args, march_forward_plain(*args, **probe), g,
                         **probe)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    plain_march = march if probe_s * FRAME_STEPS / 64 < PLAIN_BWD_LIMIT_S \
        else probe
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    out_p = march_forward_plain(*args, **plain_march)
    ev[1].record()
    grads_p = march_backward_plain(*args, out_p, g, **plain_march)
    ev[2].record()
    torch.cuda.synchronize()
    plain_fwd_ms, plain_bwd_ms = (ev[0].elapsed_time(ev[1]),
                                  ev[1].elapsed_time(ev[2]))
    full_depth = plain_march is march
    bwd_err = None
    if full_depth:
        # K2 against its plain version at the main path's shapes
        got = march_backward(*args, out, g, **march)
        torch.cuda.synchronize()
        errs, ok = max_errs(got, grads_p)
        bwd_err = max(errs.values())
        emit(phase="kernel_bwd_vs_plain", case="config3_frame",
             shape=[FRAME_H, FRAME_W], steps=FRAME_STEPS, max_abs_err=errs,
             max_abs={n: float(a.abs().max()) for n, a in
                      zip(("vol", "tf", "dmin", "dmax"), grads_p)},
             atol=BWD_ATOL, rtol=BWD_RTOL, note=BWD_NOTE)
        check(ok, f"config 3 frame: K2 vs plain {errs}")
    emit(phase="timing_train_step",
         workload=f"{FRAME_N}^3 sphere, {FRAME_W}x{FRAME_H}, {FRAME_STEPS} "
         f"steps, ET off, ntf {NTF}", gpu=gpu, nvidia_smi=smi,
         k1_ms=k1_ms, k1_device_ms=k1_device_ms, k2_ms=k2_ms,
         k2_bound_ms=k2_bound_ms,
         k2_bound_by=k2_bound_by, k2_work=k2_work,
         config4_view=dict(shape=[256, 256], camera=[0.0, 20.0],
                           k1_ms=k1_view4_ms,
                           k1_device_ms=k1_view4_device_ms,
                           k2_ms=k2_view4_ms,
                           bounds=view4_bounds),
         config4_stacked=stacked4,
         kernel_fwd_bwd_step_ms=step_ms,
         rest_of_step_ms=step_ms - k1_ms - k2_ms, adam_256cubed_ms=adam_ms,
         plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
         plain_fwd_bwd_ms=plain_fwd_ms + plain_bwd_ms,
         plain_steps=plain_march["num_steps"], plain_probe_s=probe_s,
         step_rays_per_s=FRAME_H * FRAME_W / (step_ms / 1e3))
    del out_p, grads_p

    # -- 6. the apps and harnesses, each on the card through K1 (and K2) --
    app_launches = {"benchmark_forward": n_fwd, "benchmark_grad": n_grad}
    ref_settings = RenderSettings(height=FRAME_H, width=FRAME_W,
                                  step_size=1.8 / FRAME_STEPS)   # ET on
    cam = OrbitCamera.from_angles(30.0, 20.0)
    # BASELINE config 2: the 128^3 head phantom at 512x512, 360 steps, ET
    # on, the bone TF of apps.ablation (alpha 1 by skull density)
    head2 = models.head_phantom(128)
    vol2 = head2.as_torch(dev)
    tf2 = torch.as_tensor(ablation.bone_tf(NTF), device=dev)
    s2 = RenderSettings(height=512, width=512, step_size=1.8 / 360)

    # -- 6a. sanitize -----------------------------------------------------
    t_phase = time.perf_counter()
    (err2, rgba2), _ = counted(lambda: checked_render(vol2, tf2, cam, s2))
    checked_s = time.perf_counter() - t_phase
    clean_equal = bool(torch.equal(rgba2, render(vol2, tf2, cam, s2,
                                                 method="fused")))
    nan_vol = vol2.clone()
    nan_vol[64, 64, 64] = float("nan")
    nan_msg = checked_render(nan_vol, tf2, cam, s2)[0].get()
    refused = []
    for method in ("kernel", "auto"):
        try:
            checked_render(vol2, tf2, cam, s2, method=method)
        except ValueError:
            refused.append(method)
    _, n_det = counted(lambda: assert_deterministic(
        lambda: render(vol, tf_ramp, cam, ref_settings, method="kernel"),
        runs=3))
    app_launches["sanitize"] = n_det
    emit(phase="sanitize", entry="volumetric_renderer_torch.utils.sanitize",
         gpu=gpu, nvidia_smi=smi, workload="config 2: head_phantom(128), 512x512, 360 steps, ET on, "
         "bone TF; assert_deterministic on the reference frame",
         clean_error=err2.get(), clean_equals_render_fused=clean_equal,
         checked_render_s=checked_s, centre_nan_error=nan_msg,
         kernel_refused=refused, deterministic_runs=3,
         launches=n_det, seconds=time.perf_counter() - t_phase)
    check(err2.get() is None and clean_equal, f"checked_render on a clean "
          f"grid: {err2.get()}, equal {clean_equal}")
    check(nan_msg is not None and "nan" in nan_msg, "a centre NaN voxel "
          "was not caught")
    check(refused == ["kernel", "auto"], f"checked_render refused {refused}")
    check(n_det["march_fwd"] == 3, f"assert_deterministic launches {n_det}")
    del nan_vol, rgba2

    # -- 6b. formats: the 256^3 sphere as VTK and as a 16-bit PGM stack ---
    t_phase = time.perf_counter()
    sphere256 = Volume.synthetic_sphere(FRAME_N).data
    quant = np.round(sphere256 * 65535.0).astype(np.uint16)
    held = {"vtk": sphere256,
            "pgm": quant.astype(np.float32) / np.float32(65535.0)}
    read_s, write_s, imported = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        vtk = os.path.join(tmp, "sphere.vtk")
        with open(vtk, "wb") as f:
            f.write(b"# vtk DataFile Version 3.0\nsphere\nBINARY\n"
                    b"DATASET STRUCTURED_POINTS\nDIMENSIONS %d %d %d\n"
                    % ((FRAME_N,) * 3) + b"POINT_DATA %d\n" % FRAME_N ** 3
                    + b"SCALARS density float 1\nLOOKUP_TABLE default\n")
            f.write(sphere256.astype(">f4").tobytes())
        write_s["vtk"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pgms = []
        for z in range(FRAME_N):
            pgms.append(os.path.join(tmp, f"slice_{z:03d}.pgm"))
            with open(pgms[-1], "wb") as f:
                f.write(b"P5\n%d %d\n65535\n" % (FRAME_N, FRAME_N)
                        + quant[z].astype(">u2").tobytes())
        write_s["pgm"] = time.perf_counter() - t0
        for key, paths in (("vtk", vtk), ("pgm", pgms)):
            t0 = time.perf_counter()
            imported[key] = import_volume(paths)
            read_s[key] = time.perf_counter() - t0
    formats = {}
    for key, v in imported.items():
        same_voxels = bool(np.array_equal(v.data, held[key]))
        img, n = counted(lambda: render(v.as_torch(dev), tf_ramp, cam,
                                        ref_settings, method="kernel"))
        app_launches[f"formats_{key}"] = n
        ref = render(torch.as_tensor(held[key], device=dev), tf_ramp, cam,
                     ref_settings, method="kernel")
        formats[key] = dict(read_s=read_s[key], write_s=write_s[key],
                            voxels_equal=same_voxels,
                            frame_equal=bool(torch.equal(img, ref)),
                            alpha_max=float(img[..., 3].max()), launches=n)
    emit(phase="formats", entry="volumetric_renderer_torch.data.importer."
         "import_volume", gpu=gpu, nvidia_smi=smi, volume=f"sphere({FRAME_N}): BINARY big-endian f32 "
         f"VTK; {FRAME_N} 16-bit PGM slices", frame=f"{FRAME_W}x{FRAME_H}, "
         f"{FRAME_STEPS} steps, ET on, K1", results=formats,
         seconds=time.perf_counter() - t_phase)
    for key, r in formats.items():
        check(r["voxels_equal"] and r["frame_equal"] and
              r["launches"]["march_fwd"] == 1 and r["alpha_max"] > 0.9,
              f"{key} import: {r}")
    del imported, held, sphere256, quant

    # -- 6c. turntable: 36 PNG frames at 512x512, 180 steps ---------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tt_argv = ["--synthetic", "--frames", "36", "--size", "512x512",
                   "--steps", "180", "--out",
                   os.path.join(tmp, "orbit_%d.png"), "--device", "cuda"]
        with contextlib.redirect_stderr(io.StringIO()):
            tt, n_tt = counted(lambda: quietly(turntable.main, tt_argv))
        png_bytes = [os.path.getsize(p) for p in tt["paths"]]
        frame0 = read_png_image(tt["paths"][0])
    app_launches["turntable"] = n_tt
    vol64 = Volume.synthetic_sphere(64)
    with torch.no_grad():
        plain0 = composite_over(render(
            vol64.as_torch(dev), torch.as_tensor(render_cli.load_tf(
                "preset:ramp", 256), device=dev), OrbitCamera.from_angles(
                0.0, 20.0), RenderSettings(height=512, width=512,
                                           step_size=1.8 / 180),
            method="fused"), (0.11, 0.11, 0.11)).clamp(0.0, 1.0).cpu()
    plain0 = ((plain0.numpy() * 255).astype(np.uint8) / np.float32(255.0)
              * np.asarray([0.2126, 0.7152, 0.0722], np.float32)).sum(-1)
    tt_err = float(np.abs(frame0 - plain0).max())
    emit(phase="turntable", entry="volumetric_renderer_torch.apps.turntable",
         argv=tt_argv[:-3] + tt_argv[-2:], gpu=gpu, nvidia_smi=smi,
         frames=tt["frames"], rays_per_s=tt["rays_per_s"],
         launches=n_tt, png_bytes_min=min(png_bytes),
         frame0_vs_plain_max_abs_err=tt_err,
         seconds=time.perf_counter() - t_phase)
    check(tt["frames"] == 36 and n_tt["march_fwd"] == 36,
          f"turntable launches {n_tt}")
    check(n_tt["texture_fills"] == 1, f"turntable refilled K1's texture "
          f"after the first frame: {n_tt}")
    check(tt_err <= 1.0 / 255.0 + 1e-6, f"turntable frame 0 vs plain "
          f"{tt_err}")

    # -- 6d. viewer: ViewerState driving K1 at 512x512 --------------------
    t_phase = time.perf_counter()
    vol128 = Volume.synthetic_sphere(128)
    state = viewer.ViewerState(
        viewer.make_frame_renderer(
            vol128.as_torch(dev), torch.as_tensor(render_cli.load_tf(
                "preset:ramp", 256), device=dev),
            RenderSettings(height=512, width=512, step_size=1.8 / 360),
            density_min=vol128.vmin, density_max=vol128.vmax),
        OrbitCamera.from_angles(30.0, 20.0))

    def viewer_session():
        frames, rates = [state.frame()], []
        state.press(256, -256)
        for event in (lambda: state.drag(296, -256),
                      lambda: state.drag(296, -230),
                      lambda: state.scroll(1), lambda: state.scroll(-2),
                      state.reset):
            check(event(), "a viewer event changed nothing")
            frames.append(state.frame())
            rates.append(state.last_rays_per_s)
        state.release()
        return frames, rates

    (v_frames, v_rates), n_v = counted(viewer_session)
    app_launches["viewer"] = n_v
    reset_equal = bool(torch.equal(v_frames[-1], v_frames[0]))
    distinct = len({float(f.sum()) for f in v_frames[:-1]})
    emit(phase="viewer", entry="volumetric_renderer_torch.apps.viewer."
         "ViewerState", volume="sphere(128)", shape=[512, 512], steps=360,
         gpu=gpu, nvidia_smi=smi, renders=len(v_frames), launches=n_v,
         last_rays_per_s=state.last_rays_per_s, rays_per_s=v_rates,
         reset_equals_first=reset_equal, distinct_frames=distinct,
         seconds=time.perf_counter() - t_phase)
    check(n_v["march_fwd"] == len(v_frames) == 6, f"viewer launches {n_v}")
    check(reset_equal and distinct == 5, f"viewer frames: reset equal "
          f"{reset_equal}, {distinct} distinct")

    # -- 6e. bench: the reference workload, --grad, 512^3 in 4 bands ------
    t_phase = time.perf_counter()
    b_fwd, n_bf = counted(lambda: quietly(bench.main, ["--iters", "20"]))
    b_grad, n_bg = counted(lambda: quietly(bench.main, ["--grad", "--iters",
                                                        "20"]))
    b_512, n_b5 = counted(lambda: quietly(bench.main, [
        "--grid", str(C5_N), "--grad", "--ray-chunks", "4", "--iters",
        "10"]))
    app_launches.update(bench_forward=n_bf, bench_grad=n_bg,
                        bench_512_grad_4_chunks=n_b5)
    # the 4 bands' accumulated gradients against one band's
    vol5 = Volume.synthetic_sphere(C5_N).as_torch(dev)
    origin, dirs = ray_grid(cam.to(dev), FRAME_H, FRAME_W)
    scal = (torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev),
            torch.zeros(3, device=dev), torch.ones(3, device=dev))
    k_marcher = make_marcher("kernel", ref_settings)
    g1 = bench.band_grads(k_marcher, vol5, tf_ramp, origin + 0.5, dirs, 1,
                          scal)
    g4 = bench.band_grads(k_marcher, vol5, tf_ramp, origin + 0.5, dirs, 4,
                          scal)
    chunk_err = {name: float((a - b).abs().max())
                 for name, a, b in zip(("vol", "tf"), g4, g1)}
    chunk_ok = all(bool(torch.allclose(a, b, atol=BWD_ATOL, rtol=BWD_RTOL))
                   for a, b in zip(g4, g1))
    chunk_max = {name: float(b.abs().max()) for name, b in
                 zip(("vol", "tf"), g1)}
    del vol5, g1, g4, dirs
    emit(phase="bench", entry="volumetric_renderer_torch.apps.bench",
         gpu=gpu, nvidia_smi=smi, forward=b_fwd, grad=b_grad,
         grad_512_4_chunks=b_512,
         launches={"forward": n_bf, "grad": n_bg, "grad_512_4_chunks": n_b5},
         chunks4_vs_1_max_abs_err=chunk_err, chunks1_max_abs=chunk_max,
         atol=BWD_ATOL, rtol=BWD_RTOL, seconds=time.perf_counter() - t_phase)
    check(b_fwd["value"] > 0 and b_fwd["vs_baseline"] > 1.0,
          f"bench forward {b_fwd['value']}, vs oracle {b_fwd['vs_baseline']}")
    check(all(b["texture_fills_timed"] == 0 for b in (b_fwd, b_grad, b_512)),
          "K1's texture was refilled inside a timed bench call")
    check(n_bg["march_bwd"] >= 21 and n_b5["march_bwd"] >= 44,
          f"bench --grad launches {n_bg} {n_b5}")
    check(chunk_ok, f"4-band gradients vs 1 band: {chunk_err}")

    # -- 6f. ablation: config 2 (kernel, fused) and the flagship ----------
    t_phase = time.perf_counter()
    abl, n_abl = counted(lambda: quietly(ablation.main, [
        "--methods", "kernel", "fused", "--iters", "10"]))
    app_launches["ablation"] = n_abl
    c2 = abl["workloads"]["config2_head_phantom"]
    # config 2 through K1 against its plain version, bit for bit as K1's
    # small and chunk cases
    c2_vs_plain = {}
    for et in (True, False):
        s2_et = s2.replace(early_termination=et)
        got = render(vol2, tf2, cam, s2_et, method="kernel")
        want = render(vol2, tf2, cam, s2_et, method="fused")
        c2_vs_plain[f"et{'on' if et else 'off'}"] = dict(
            equal=bool(torch.equal(got, want)),
            max_abs_err=float((got - want).abs().max()))
    del got, want
    # where config 2's frame time goes: K1 alone (event and device ms)
    # beside its bound, ET on and off
    c2_k1 = {}
    for et in (True, False):
        kargs, kmarch = kernel_inputs(vol2, tf2, cam,
                                      s2.replace(early_termination=et))
        c2_bound, c2_by, c2_work = bound("march_fwd", kargs, kmarch)
        c2_k1[f"et{'on' if et else 'off'}"] = dict(
            event_ms=cuda_ms(lambda: march_forward(*kargs, **kmarch), 10),
            device_ms=device_ms(lambda: march_forward(*kargs, **kmarch), 10,
                                "march_fwd_kernel")[0],
            bound_ms=c2_bound, bound_by=c2_by,
            sampled_steps=c2_work["sampled_steps"])
    del kargs
    emit(phase="ablation", entry="volumetric_renderer_torch.apps.ablation",
         gpu=gpu, nvidia_smi=smi, workloads=abl["workloads"],
         config2_kernel_vs_fused=c2_vs_plain, config2_k1=c2_k1,
         launches=n_abl, seconds=time.perf_counter() - t_phase)
    check(all(c2[f"et_speedup_{m}"] > 0 for m in ("kernel", "fused")) and
          "et_speedup_kernel" in abl["workloads"]["flagship_sphere"],
          f"ablation keys {sorted(c2)}")
    check(n_abl["march_fwd"] >= 4 * 11, f"ablation launches {n_abl}")
    check(all(r["equal"] for r in c2_vs_plain.values()),
          f"config 2 K1 vs plain {c2_vs_plain}")

    # -- 6g. scaling: the reference workload, 1 2 4 8 devices -------------
    t_phase = time.perf_counter()
    sc, n_sc = counted(lambda: quietly(scaling.main, ["--iters", "5"]))
    app_launches["scaling"] = n_sc
    effs = {f"{r['devices']}/{name}": (lay["efficiency"],
                                       lay.get("efficiency_dispatch_"
                                               "adjusted"))
            for r in sc["emulated_strong_scaling"]
            for name, lay in r["layouts"].items()}
    exact = all(lay["exact"] for r in sc["emulated_strong_scaling"]
                for lay in r["layouts"].values())
    emit(phase="scaling", entry="volumetric_renderer_torch.apps.scaling",
         gpu=gpu, nvidia_smi=smi, t_full_ms=sc["t_full_ms"],
         dispatch_floor_ms=sc["dispatch_floor_ms"],
         dispatch_floor_validation=sc["dispatch_floor_validation"],
         efficiency_and_adjusted=effs, bands_exact=exact, launches=n_sc,
         seconds=time.perf_counter() - t_phase)
    check(exact, "scaling: a layout's bands, unpacked, differ from the "
          "full frame")
    check(sc["dispatch_floor_validation"]["n"] == 8 and len(effs) == 13,
          f"scaling entries {sorted(effs)}")
    for n in app_launches.values():
        for k in main_launches:
            main_launches[k] += n[k]

    # -- 5. summary -------------------------------------------------------
    emit(phase="total", seconds=time.perf_counter() - t_start,
         app_launches=app_launches)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "march_fwd", "route": "cuda",
         "source": KERNELS["march_fwd"][0],
         "replaces": KERNELS["march_fwd"][1],
         "launches": main_launches["march_fwd"],
         "max_abs_err": max(err, own_fwd_err),
         "ms": kernel_ms, "device_ms": kernel_device_ms,
         "plain_ms": plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": None,
         "launches_per_step": {k: v["march_fwd"] for k, v in
                               launches_per_step.items()},
         "config4_step": {k: stacked4[k] for k in ("k1_ms", "k1_device_ms")}
         | {"bound_ms": stacked4["bounds"]["march_fwd"][0]},
         "config5_depth_step": {
             "ms": depth5d["k1_ms"], "device_ms": depth5d["k1_device_ms"],
             "plain_ms": depth5d["k1_plain_ms"],
             "bound_ms": depth5d["bounds"]["march_fwd"][0],
             "bound_by": depth5d["bounds"]["march_fwd"][1],
             "max_abs_err": depth5d["k1_max_abs_err"],
             "shape": depth5d["shape"]}},
        {"name": "march_bwd", "route": "cuda",
         "source": KERNELS["march_bwd"][0],
         "replaces": KERNELS["march_bwd"][1],
         "launches": main_launches["march_bwd"],
         "max_abs_err": max(own_bwd_err, bwd_small_err, bwd_err or 0.0),
         "ms": k2_ms, "plain_ms": plain_bwd_ms,
         "plain_steps": plain_march["num_steps"], "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": None,
         "launches_per_step": {k: v["march_bwd"] for k, v in
                               launches_per_step.items()},
         "config4_step": {k: stacked4[k] for k in ("k2_ms", "k2_device_ms",
                                                   "k2_shared_table")}
         | {"bound_ms": stacked4["bounds"]["march_bwd"][0]},
         "config5_depth_step": {
             "ms": depth5d["k2_ms"], "device_ms": depth5d["k2_device_ms"],
             "plain_ms": depth5d["k2_plain_ms"],
             "bound_ms": depth5d["bounds"]["march_bwd"][0],
             "bound_by": depth5d["bounds"]["march_bwd"][1],
             "max_abs_err": max(depth5d["k2_max_abs_err"].values()),
             "shape": depth5d["shape"]},
         "depth_chunk_512": {
             "chunks": C5_CHUNKS, "ms": k2_512["chunk_ms"],
             "device_ms": k2_512["chunk_device_ms"],
             "device_sum_ms": k2_512["chunk_device_sum_ms"],
             "whole_device_ms": k2_512["whole_device_ms"],
             "bound_ms": [b[0] for b in k2_512["chunk_bounds"]],
             "bound_by": [b[1] for b in k2_512["chunk_bounds"]],
             "chunk1_plain_ms": k2_512["chunk1_plain_ms"],
             "chunk1_max_abs_err": max(
                 k2_512["chunk1_max_abs_err"].values())}},
        # one forward and one backward (chunk 1), the pair a depth-sharded
        # step launches, on the 8-view config-5 partials of 4 chunks
        {"name": "fold", "route": "cuda", "source": KERNELS["fold"][0],
         "replaces": KERNELS["fold"][1],
         "launches": sum(fold_launches.values()),
         "launches_by_kernel": fold_launches,
         "max_abs_err": max(fold_fwd_err, *fold_bwd_err),
         "ms": fold_t["fwd_ms"] + fold_t["bwd_ms"],
         "device_ms": None if None in (fold_t["fwd_device_ms"],
                                       fold_t["bwd_device_ms"])
         else fold_t["fwd_device_ms"] + fold_t["bwd_device_ms"],
         "plain_ms": fold_t["fwd_plain_ms"] + fold_t["bwd_plain_ms"],
         "bound_ms": fold_b["forward"][0] + fold_b["backward"][0],
         "bound_by": ("bytes" if fold_b["forward"][1] ==
                      fold_b["backward"][1] == "bytes" else "operations"),
         "library_ms": None,
         "shape": fold_shape, "chunks": C5_CHUNKS,
         "forward": {"ms": fold_t["fwd_ms"],
                     "device_ms": fold_t["fwd_device_ms"],
                     "plain_ms": fold_t["fwd_plain_ms"],
                     "bound_ms": fold_b["forward"][0],
                     "max_abs_err": fold_fwd_err},
         "backward": {"ms": fold_t["bwd_ms"],
                      "device_ms": fold_t["bwd_device_ms"],
                      "plain_ms": fold_t["bwd_plain_ms"],
                      "bound_ms": fold_b["backward"][0],
                      "max_abs_err": max(fold_bwd_err)}},
    ]}), flush=True)
    # the devices this run used: those it allocated memory on
    used = sum(torch.cuda.max_memory_allocated(i) > 0
               for i in range(torch.cuda.device_count()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": used}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
