#!/usr/bin/env python3
"""Times the ray-march kernels and the training steps of one checkout of
the port on one CUDA card, so that two checkouts, or two builds of a
kernel, can be compared in turns on the same card.

    PYTHONPATH=<checkout> python volumetric_renderer_torch/apps/time_kernels.py \\
        [--what k2|all] [--iters N] [--label NAME]

Run it by path: ``volumetric_renderer_torch`` is then imported from the
checkout that ``PYTHONPATH`` names, and its kernels are built from that
checkout's ``csrc/`` into its own ``build/``.  Prints one JSON line with
the card's name and power limit and these times in ms, each the median of
``--iters`` runs after one warm-up (CUDA events):

* ``k2_config3_ms``: K2 on BASELINE config 3's frame (256^3 sphere,
  1920x1080, 512 steps of 1.8/512, early termination off, 256-texel TF
  with alpha ``linspace(0, 1)**2``, camera yaw 30 pitch 20);
* ``k2_config4_view_ms``: K2 on one view of config 4 (the same grid, TF and
  steps, 256x256, yaw 0 pitch 20, the first view of ``apps.optimize``'s
  ring);

and with ``--what all`` also ``k1_config3_ms``, ``k1_config4_view_ms``,
``k2_512_chunks_ms`` (K2 on each of 4 depth chunks along z of a 512^3
sphere, 1920x1080, 512 steps), ``step_config3_ms`` (``render(method=
"kernel")`` and the backward of a pixel loss at config 3) and
``app_step_config4_ms`` (the mean step wall time of ``apps.optimize
invert`` at config 4: 32 views at 256x256, 5 steps after a 1-step run).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess

import numpy as np
import torch


def cuda_ms(fn, iters: int) -> float:
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--what", choices=["k2", "all"], default="all")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")

    import volumetric_renderer_torch as pkg
    from volumetric_renderer_torch.apps import optimize
    from volumetric_renderer_torch.core.marcher import (
        frame_inputs, prepare_rays,
    )
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.kernels.march import (
        march_backward, march_forward,
    )
    from volumetric_renderer_torch.parallel.depth import chunk_of
    from volumetric_renderer_torch.render.api import render
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.config import RenderSettings

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.splitlines()[0]
    res = dict(label=args.label, package=os.path.dirname(pkg.__file__),
               gpu=torch.cuda.get_device_name(0), nvidia_smi=smi,
               iters=args.iters)
    ramp = Gradient.grayscale_ramp().discretize(256)
    ramp[:, 3] = np.linspace(0.0, 1.0, 256, dtype=np.float32) ** 2
    tf = torch.as_tensor(ramp, device=dev)

    def case(vol, yaw, h, w):
        settings = RenderSettings(height=h, width=w, step_size=1.8 / 512,
                                  early_termination=False)
        cam = OrbitCamera.from_angles(yaw, 20.0)
        origin, dirs, dmin, dmax, smin, smax = frame_inputs(vol, cam,
                                                            settings)
        pos0, hit, inv_w = prepare_rays(origin, dirs, dmin, dmax)
        march = dict(num_steps=512, step_size=1.8 / 512,
                     early_termination=False, termination_eps=1.0 / 255.0)
        g = np.random.default_rng(7).normal(size=(h, w, 4))
        g = torch.as_tensor(g.astype(np.float32), device=dev)
        return ((vol, tf, pos0, dirs, hit, dmin, inv_w, smin, smax), march,
                g, cam, settings)

    vol = Volume.synthetic_sphere(256).as_torch(dev)
    for key, yaw, h, w in (("config3", 30.0, 1080, 1920),
                           ("config4_view", 0.0, 256, 256)):
        kargs, march, g, cam, settings = case(vol, yaw, h, w)
        out = march_forward(*kargs, **march)
        res[f"k2_{key}_ms"] = cuda_ms(
            lambda: march_backward(*kargs, out, g, **march), args.iters)
        if args.what == "all":
            res[f"k1_{key}_ms"] = cuda_ms(
                lambda: march_forward(*kargs, **march), args.iters)
        if args.what == "all" and key == "config3":
            def kernel_step():
                leaves = [vol.detach().requires_grad_(True),
                          tf.detach().requires_grad_(True)]
                img = render(leaves[0], leaves[1], cam, settings,
                             method="kernel")
                (img * g).sum().backward()

            res["step_config3_ms"] = cuda_ms(kernel_step, args.iters)
        del kargs, out, g

    if args.what == "all":
        vol5 = Volume.synthetic_sphere(512).as_torch(dev)
        kargs, march, g, _, _ = case(vol5, 30.0, 1080, 1920)
        body = 512 // 4
        chunk_ms = []
        for c in range(4):
            cargs = (chunk_of(vol5, c, body, 0),) + kargs[1:]
            own = (0, c * body, body, 512)
            out = march_forward(*cargs, **march, own=own)
            chunk_ms.append(cuda_ms(lambda: march_backward(
                *cargs, out, g, **march, own=own), args.iters))
            del cargs, out
        res["k2_512_chunks_ms"] = chunk_ms
        res["k2_512_chunks_sum_ms"] = sum(chunk_ms)
        del vol5, kargs, g

        inv = ["invert", "--grid", "256", "--size", "256x256",
               "--march-steps", "512", "--views", "32", "--device", "cuda"]
        with open(os.devnull, "w") as null, contextlib.redirect_stderr(null):
            optimize.main(inv + ["--steps-opt", "1"])
            run = optimize.main(inv + ["--steps-opt", "5"])
        res["app_step_config4_ms"] = 1e3 * run["train_s"] / len(run["losses"])

    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
