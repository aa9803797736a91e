#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the forward ray-march kernel (``volumetric_renderer_torch/csrc/
march_fwd.cu``) with nvcc, holds it against its plain PyTorch version on the
card, renders a 256^3 NRRD volume at 1920x1080 / 512 steps through the
port's ``render_cli`` and times the kernel against the plain version.  Each
phase prints one JSON object per line; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run exits
non-zero; without a CUDA device it exits non-zero before any work.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SMALL_N, SMALL_STEPS, SMALL_HW = 64, 128, (96, 96)   # kernel-vs-plain cases
SMALL_ATOL = 1e-5
FRAME_N, FRAME_W, FRAME_H, FRAME_STEPS, NTF = 256, 1920, 1080, 512, 256
# With early termination, a ray whose T lands within an ulp of eps may take
# one sample more or fewer: 1e-5 on 99.99% of pixels, 1/255 everywhere.
FRAME_ATOL, FRAME_SHARE, FRAME_MAX = 1e-5, 0.9999, 1.0 / 255.0
KERNEL_SOURCE = "volumetric_renderer_torch/csrc/march_fwd.cu"
REPLACES = "volumetric_renderer_tpu/kernels/slab.py:160"


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from volumetric_renderer_torch import models
    from volumetric_renderer_torch.apps import render_cli
    from volumetric_renderer_torch.core.marcher import (
        frame_inputs, prepare_rays,
    )
    from volumetric_renderer_torch.data.importer import import_volume
    from volumetric_renderer_torch.data.nrrd import write_nrrd
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.kernels import _build
    from volumetric_renderer_torch.kernels.march import (
        load_library, march_forward, march_forward_plain,
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

    # -- 1. build ---------------------------------------------------------
    built = _build.build("march_fwd")
    load_library()
    emit(phase="build", kernel="march_fwd", source=KERNEL_SOURCE,
         seconds=built.seconds,
         ptxas=[ln.strip() for ln in built.log.splitlines()
                if "Used" in ln or "spill" in ln])

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

    # -- 4. timing: the bench.py workload ---------------------------------
    vol = Volume.synthetic_sphere(FRAME_N).as_torch(dev)
    cam = OrbitCamera.from_angles(30.0, 20.0)
    args, march = kernel_inputs(vol, tf_ramp, cam, settings)
    kernel_ms = cuda_ms(lambda: march_forward(*args, **march), 5)
    frame_ms = cuda_ms(lambda: render(vol, tf_ramp, cam, settings,
                                      method="kernel"), 5)
    plain_ms = cuda_ms(lambda: march_forward_plain(*args, **march), 3)
    rays = FRAME_H * FRAME_W
    emit(phase="timing", workload=f"{FRAME_N}^3 sphere, {FRAME_W}x{FRAME_H}, "
         f"{FRAME_STEPS} steps, ET on, ntf {NTF}", gpu=gpu, nvidia_smi=smi,
         kernel_ms=kernel_ms, plain_ms=plain_ms, frame_ms=frame_ms,
         kernel_rays_per_s=rays / (kernel_ms / 1e3),
         plain_rays_per_s=rays / (plain_ms / 1e3),
         frame_rays_per_s=rays / (frame_ms / 1e3))

    # -- 5. summary -------------------------------------------------------
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "march_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
