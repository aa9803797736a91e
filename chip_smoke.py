#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the forward and backward ray-march kernels (``volumetric_renderer_
torch/csrc/march_fwd.cu``, ``march_bwd.cu``) with nvcc, holds each against
its plain PyTorch version on the card, holds render gradients through both
against plain autograd, renders a 256^3 NRRD volume at 1920x1080 / 512 steps
through the port's ``render_cli``, trains through ``apps.optimize`` at the
sizes of BASELINE configs 3 (TF fit, 1920x1080) and 4 (grid inversion, 32
views, with checkpoint and resume), and times the kernels against the plain
versions.  The multi-device path (``parallel/``): both kernels on depth
chunks (the ownership range ``own``) against their plain versions, a 512^3
volume folded from 4 depth chunks against the whole-volume frame and its
gradients, and, in a one-rank NCCL process group, the pixel-sharded
config-5 frame (512^3, 1920x1080, 512 steps) and ``apps.optimize
--parallel pixels|depth`` at that size.  Each phase prints one JSON object
per line; the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the run exits non-zero; without a CUDA device it exits
non-zero before any work.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import socket
import statistics
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
}
PLAIN_BWD_LIMIT_S = 120.0   # time the plain backward at fewer steps past it
OWN_CHUNKS = (2, 4)     # depth chunks of the small kernel-vs-plain cases
C5_N, C5_CHUNKS = 512, 4    # config 5: a 512^3 grid; the depth fold's chunks
# A folded frame reassociates every composite: 1e-5 on 99.99% of pixels and
# 1/255 everywhere, as FRAME_*; the chunk gradients against the whole-volume
# ones within 5e-4 of the largest (tests/test_depth.py's bar).
FOLD_GRAD_REL = 5e-4


def emit(**obj):
    print(json.dumps(obj), flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def cuda_ms(fn, iters):
    """Median device time of ``fn`` over ``iters`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_errs(got, want):
    """Per-output max abs error and whether each is within BWD_ATOL /
    BWD_RTOL, for ``(vol_g, tf_g, dmin_g, dmax_g)``."""
    names = ("vol", "tf", "dmin", "dmax")
    errs = {n: float((a - b).abs().max()) for n, a, b in zip(names, got, want)}
    ok = all(bool(torch.isfinite(a).all()) and bool(torch.allclose(
        a, b, atol=BWD_ATOL, rtol=BWD_RTOL)) for a, b in zip(got, want))
    return errs, ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from volumetric_renderer_torch import models
    from volumetric_renderer_torch.apps import optimize, render_cli
    from volumetric_renderer_torch.core.marcher import (
        frame_inputs, prepare_rays,
    )
    from volumetric_renderer_torch.data.importer import import_volume
    from volumetric_renderer_torch.data.nrrd import write_nrrd
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.kernels import _build
    from volumetric_renderer_torch.kernels.march import (
        load_library, march_backward, march_backward_plain, march_forward,
        march_forward_plain, make_kernel_marcher,
    )
    from volumetric_renderer_torch.parallel.depth import (
        chunk_of, fold_partials,
    )
    from volumetric_renderer_torch.parallel.distributed import (
        init_distributed,
    )
    from volumetric_renderer_torch.parallel.render import (
        make_sharded_renderer,
    )
    from volumetric_renderer_torch.parallel.train import (
        init_state, make_train_step,
    )
    from volumetric_renderer_torch.render.api import render
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.config import RenderSettings

    dev = torch.device("cuda")
    gpu = torch.cuda.get_device_name(0)

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
        emit(phase="kernel_vs_plain", case=c["name"], shape=[h, w],
             steps=settings.num_steps, hit_rays=int(args[4].sum()),
             alpha_max=float(got[..., 3].max()), max_abs_err=err,
             atol=SMALL_ATOL)
        check(err <= SMALL_ATOL, f"{c['name']}: max abs err {err}")
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
    for yaw, pitch in ((30.0, 20.0), (210.0, -20.0)):   # one view each way
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
                for c in range(n):
                    cargs = (chunk_of(sphere, c, body, axis),) + args[1:]
                    own = (axis, c * body, body, SMALL_N)
                    got = march_forward(*cargs, **march, own=own)
                    ref = march_forward_plain(*cargs, **march, own=own)
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
                     k1_max_abs_err=k1_err, k1_atol=SMALL_ATOL,
                     k2_max_abs_err=k2_errs, k2_atol=BWD_ATOL,
                     k2_rtol=BWD_RTOL, fold_vs_whole_max_abs_err=fold_err,
                     whole_range_bitwise=True)
                check(k1_err <= SMALL_ATOL, f"own K1 vs plain {k1_err}")
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
    def optimize_run(argv, min_fwd, min_bwd):
        march_forward.launches = march_backward.launches = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log), \
                contextlib.redirect_stdout(sys.stderr):
            res = optimize.main(argv)
        wall_s = time.perf_counter() - t0
        launches = {"march_fwd": march_forward.launches,
                    "march_bwd": march_backward.launches}
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
        check(launches["march_fwd"] >= min_fwd and
              launches["march_bwd"] >= min_bwd,
              f"launches {launches} < ({min_fwd}, {min_bwd})")
        return res, launches

    main_launches = {"march_fwd": launches, "march_bwd": 0}
    steps3, views4 = 5, 32
    res, n = optimize_run(
        ["tf-fit", "--grid", str(FRAME_N), "--size", f"{FRAME_W}x{FRAME_H}",
         "--march-steps", str(FRAME_STEPS), "--views", "1", "--steps-opt",
         str(steps3), "--device", "cuda"], 1 + steps3, steps3)
    check(res["losses"][-1] < res["losses"][0], f"config 3 loss did not "
          f"fall: {res['losses']}")
    for k in main_launches:
        main_launches[k] += n[k]
    with tempfile.TemporaryDirectory() as ck:
        inv = ["invert", "--grid", str(FRAME_N), "--size", "256x256",
               "--march-steps", str(FRAME_STEPS), "--views", str(views4),
               "--ckpt-dir", ck, "--ckpt-every", "2", "--device", "cuda"]
        first, n = optimize_run(inv + ["--steps-opt", "4"],
                                views4 * 5, views4 * 4)
        for k in main_launches:
            main_launches[k] += n[k]
        check(first["losses"][-1] < first["losses"][0],
              f"config 4 loss did not fall: {first['losses']}")
        resumed, n = optimize_run(inv + ["--steps-opt", "6", "--resume"],
                                  views4 * 3, views4 * 2)
        for k in main_launches:
            main_launches[k] += n[k]
        check(resumed["start"] == 4, f"resumed at step {resumed['start']}")
        check(resumed["losses"][-1] < first["losses"][0],
              f"resumed loss {resumed['losses']} not below the first "
              f"{first['losses'][0]}")

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
        along z, folded per ray (halo-row gradients land on their owners
        through chunk_of's backward)."""
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
            img = fold_partials(torch.stack(parts), dirs, 0)
        (img * g5).sum().backward()
        return img.detach(), [x.grad for x in xs]

    whole5, grads_w = fold_grads(1)
    folded5, grads_c = fold_grads(C5_CHUNKS)
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
         grad_rel_bar=FOLD_GRAD_REL)
    check(bool(torch.isfinite(folded5).all()), "folded frame not finite")
    check(float(whole5[..., 3].max()) > 0.9, "config-5 frame is empty")
    check(fold_share >= FRAME_SHARE and fold_err <= FRAME_MAX,
          f"folded frame vs whole: {fold_err}, share {fold_share}")
    check(all(grad_err[n] <= FOLD_GRAD_REL * grad_max[n] for n in grad_err),
          f"chunk gradients vs whole: {grad_err} (max {grad_max})")
    del whole5, folded5, grads_w, grads_c

    # timing: K1 on the whole 512^3 grid and on each of its 4 chunks
    k1_512_ms = cuda_ms(lambda: march_forward(*args5, **march5), 5)
    chunk_ms = []
    for c in range(C5_CHUNKS):
        cargs = (chunk_of(vol5, c, body5, 0),) + args5[1:]
        own = (0, c * body5, body5, C5_N)
        chunk_ms.append(cuda_ms(
            lambda: march_forward(*cargs, **march5, own=own), 5))
        del cargs
    emit(phase="timing_depth_chunks",
         workload=f"{C5_N}^3 sphere, {FRAME_W}x{FRAME_H}, {FRAME_STEPS} "
         f"steps, ET off, ntf {NTF}, {C5_CHUNKS} chunks along z", gpu=gpu,
         nvidia_smi=smi, k1_whole_ms=k1_512_ms, k1_chunk_ms=chunk_ms,
         k1_chunks_sum_ms=sum(chunk_ms),
         chunks_over_whole=sum(chunk_ms) / k1_512_ms)

    # -- 3d. one-rank NCCL group: the sharded frame and optimize at config 5
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    rank_dev = init_distributed(f"tcp://localhost:{port}", 1, 0,
                                device="cuda")
    probe = torch.full((4,), 2.0, device=rank_dev)
    dist.all_reduce(probe)      # the group's NCCL communicator works
    torch.cuda.synchronize()
    emit(phase="process_group", backend=dist.get_backend(),
         world=dist.get_world_size(), rank=dist.get_rank(),
         device=str(rank_dev), all_reduce=probe.tolist())
    check(dist.get_backend() == "nccl" and probe.tolist() == [2.0] * 4,
          f"process group {dist.get_backend()}: {probe.tolist()}")
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
                          2 + 3 * 2, 3 * 2)
    check(res["losses"][-1] < res["losses"][0],
          f"config 5 pixels: loss did not fall: {res['losses']}")
    c5_pixels = res
    for k in main_launches:
        main_launches[k] += n[k]
    with tempfile.TemporaryDirectory() as ck:
        dep = c5 + ["--parallel", "depth", "--ckpt-dir", ck, "--ckpt-every",
                    "2"]
        first, n = optimize_run(dep + ["--steps-opt", "2"], 2 + 2 * 2, 2 * 2)
        for k in main_launches:
            main_launches[k] += n[k]
        resumed, n = optimize_run(dep + ["--steps-opt", "3", "--resume"],
                                  2 + 2, 2)
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
    del state5, fixed5, target5, vol5, args5
    dist.destroy_process_group()

    # -- 4. timing: the bench.py workload ---------------------------------
    vol = Volume.synthetic_sphere(FRAME_N).as_torch(dev)
    cam = OrbitCamera.from_angles(30.0, 20.0)
    args, march = kernel_inputs(vol, tf_ramp, cam, settings)
    kernel_ms = cuda_ms(lambda: march_forward(*args, **march), 5)
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
    rays = FRAME_H * FRAME_W
    emit(phase="timing", workload=f"{FRAME_N}^3 sphere, {FRAME_W}x{FRAME_H}, "
         f"{FRAME_STEPS} steps, ET on, ntf {NTF}", gpu=gpu, nvidia_smi=smi,
         kernel_ms=kernel_ms, kernel_ms_again=kernel_ms_again,
         kernel_whole_range_own_ms=own_ms, plain_ms=plain_ms,
         frame_ms=frame_ms,
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
    out = march_forward(*args, **march)
    k2_ms = cuda_ms(lambda: march_backward(*args, out, g, **march), 5)

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
         k1_ms=k1_ms, k2_ms=k2_ms, kernel_fwd_bwd_step_ms=step_ms,
         rest_of_step_ms=step_ms - k1_ms - k2_ms, adam_256cubed_ms=adam_ms,
         plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
         plain_fwd_bwd_ms=plain_fwd_ms + plain_bwd_ms,
         plain_steps=plain_march["num_steps"], plain_probe_s=probe_s,
         step_rays_per_s=FRAME_H * FRAME_W / (step_ms / 1e3))
    del out_p, grads_p

    # -- 5. summary -------------------------------------------------------
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "march_fwd", "route": "cuda",
         "source": KERNELS["march_fwd"][0],
         "replaces": KERNELS["march_fwd"][1],
         "launches": main_launches["march_fwd"],
         "max_abs_err": max(err, own_fwd_err),
         "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": "march_bwd", "route": "cuda",
         "source": KERNELS["march_bwd"][0],
         "replaces": KERNELS["march_bwd"][1],
         "launches": main_launches["march_bwd"],
         "max_abs_err": max(own_bwd_err, bwd_err if bwd_err is not None
                            else bwd_small_err),
         "ms": k2_ms, "plain_ms": plain_bwd_ms,
         "plain_steps": plain_march["num_steps"]},
    ]}), flush=True)
    # the devices this run used: those it allocated memory on
    used = sum(torch.cuda.max_memory_allocated(i) > 0
               for i in range(torch.cuda.device_count()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": used}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
