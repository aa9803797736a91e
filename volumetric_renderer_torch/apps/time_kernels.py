#!/usr/bin/env python3
"""Times the ray-march kernels and the training steps of one checkout of
the port on one CUDA card, so that two checkouts, or two builds of a
kernel, can be compared in turns on the same card.

    PYTHONPATH=<checkout> python volumetric_renderer_torch/apps/time_kernels.py \\
        [--what k1|k2|all] [--cases A,B,..] [--iters N] [--label NAME]

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
* ``k2_512_chunks_ms``: K2 on each of 4 depth chunks along z of a 512^3
  sphere, 1920x1080, 512 steps;

and with ``--what all`` also ``k1_config3_ms``, ``k1_config4_view_ms``,
``frame_ref_ms`` (the reference frame,
early termination on, through ``render(method="kernel")``: ray setup and
K1), ``step_config3_ms`` (``render(method="kernel")`` and the backward of a
pixel loss at config 3),
``app_step_config4_ms`` (the mean step wall time of ``apps.optimize
invert`` at config 4: 32 views at 256x256, 5 steps after a 1-step run) and
``app_step_config5_depth_ms`` (the same for config 5 under ``--parallel
depth`` in one process: the 512^3 sphere, 2 views at 1920x1080, 3 steps
after a 1-step run).

``--what k1`` times K1 alone on these cases, each twice: ``k1_<case>_
event_ms``, CUDA events around the whole ``march_forward`` call (the
wrapper's host work included), and ``k1_<case>_device_ms``, the median of
the ``march_fwd_kernel`` entries of a ``torch.profiler`` run (the kernel
alone; ``None`` where the profiler saw no such entry):

* ``ref_frame``: the reference frame (256^3 sphere, 1920x1080, 512 steps,
  early termination on, yaw 30 pitch 20);
* ``ref_frame_own_whole``: the same with the whole-volume ownership range
  ``own=(0, 0, 256, 256)`` (a zero halo row appended);
* ``ref_frame_inner``: the same in the slicing window [0.01, 0.99]^3, where
  every corner a sample reads lies inside the grid;
* ``config3``: early termination off; ``config4_view``: 256x256, yaw 0,
  early termination off;
* ``c512_whole``: the 512^3 sphere at 1920x1080, early termination off;
* ``c512_fold``: the same in 4 depth chunks along z, as the depth fold
  marches them: each call cuts the 4 chunks (``parallel.depth.chunk_of``)
  and marches each; its device time is the 4 kernels' sum per call, and
  ``k1_c512_fold_copy_device_ms`` the device time per call of the copies
  into K1's texture (the profiler's ``Memcpy`` entries but host-device
  ones; their names in ``k1_c512_fold_copy_names``);
* ``ref_frame_refill``, ``config4_view_refill`` and ``c512_whole_refill``:
  those cases with the grid alternating between two equal tensors, so that
  K1 copies the grid into its texture before every launch (the copy's
  cost is the difference to the case itself);

and the ``ptxas`` lines of K1's build (registers, spills).  ``--cases``
times only the named ones.
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

from volumetric_renderer_torch.utils.metrics import time_calls


def cuda_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` over ``iters`` runs after one warm-up."""
    return statistics.median(time_calls(fn, iters, "cuda"))


def device_ms(fn, iters: int, kernel: str):
    """Device times of the entries whose name holds ``kernel`` in a
    ``torch.profiler`` run of ``fn`` ``iters`` times after one warm-up:
    ``(median ms of an entry, number of entries, ms per call of fn, the
    entries' names)``; ``(None, 0, None, [])`` where the profiler saw
    none.  ``kernel="Memcpy"`` takes no host-device copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = []
    for _ in range(3):     # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.events()
                if kernel in e.name and e.device_type == DeviceType.CUDA
                and not ("HtoD" in e.name or "DtoH" in e.name)]
        us = [e.time_range.elapsed_us() for e in hits]
        if us:
            break
    if not us:
        return None, 0, None, []
    return (statistics.median(us) / 1e3, len(us), sum(us) / 1e3 / iters,
            sorted({e.name for e in hits}))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--what", choices=["k1", "k2", "all"], default="all")
    ap.add_argument("--cases", default="",
                    help="with --what k1: a comma-separated subset of the "
                    "cases (default: all)")
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
    from volumetric_renderer_torch.kernels import _build
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

    def case(vol, yaw, h, w, et=False, slicing=(None, None)):
        settings = RenderSettings(height=h, width=w, step_size=1.8 / 512,
                                  early_termination=et)
        cam = OrbitCamera.from_angles(yaw, 20.0)
        origin, dirs, dmin, dmax, smin, smax = frame_inputs(
            vol, cam, settings, None, None, *slicing)
        pos0, hit, inv_w = prepare_rays(origin, dirs, dmin, dmax)
        march = dict(num_steps=512, step_size=1.8 / 512,
                     early_termination=et, termination_eps=1.0 / 255.0)
        g = np.random.default_rng(7).normal(size=(h, w, 4))
        g = torch.as_tensor(g.astype(np.float32), device=dev)
        return ((vol, tf, pos0, dirs, hit, dmin, inv_w, smin, smax), march,
                g, cam, settings)

    vol = Volume.synthetic_sphere(256).as_torch(dev)
    if args.what == "k1":
        res["ptxas"] = [ln.strip() for ln in
                        _build.build("march_fwd").log.splitlines()
                        if "Used" in ln or "spill" in ln]
        vol5 = Volume.synthetic_sphere(512).as_torch(dev)
        inner = ((0.01,) * 3, (0.99,) * 3)
        runs = [("ref_frame", case(vol, 30.0, 1080, 1920, et=True), None),
                ("ref_frame_own_whole", case(vol, 30.0, 1080, 1920, et=True),
                 (0, 0, 256, 256)),
                ("ref_frame_inner", case(vol, 30.0, 1080, 1920, et=True,
                                         slicing=inner), None),
                ("config3", case(vol, 30.0, 1080, 1920), None),
                ("config4_view", case(vol, 0.0, 256, 256), None),
                ("c512_whole", case(vol5, 30.0, 1080, 1920), None)]
        runs.append(("c512_fold", runs[-1][1], "fold"))
        runs += [(key + "_refill", case_, "refill") for key, case_, own in runs
                 if key in ("ref_frame", "config4_view", "c512_whole")]
        if args.cases:
            runs = [r for r in runs if r[0] in args.cases.split(",")]
        for key, (kargs, march, *_), own in runs:
            grids = [kargs[0]]
            if own == "refill":       # two equal grids, taken in turns
                grids, own = [kargs[0], kargs[0].clone()], None
            elif own is not None and own != "fold":   # the whole range
                grids = [chunk_of(vol, 0, 256, 0)]

            def k1(kargs=kargs, march=march, own=own, grids=grids):
                if own == "fold":
                    for c in range(4):
                        march_forward(chunk_of(kargs[0], c, 128, 0),
                                      *kargs[1:], **march,
                                      own=(0, c * 128, 128, 512))
                    return None
                grids.reverse()
                return march_forward(grids[0], *kargs[1:], **march, own=own)

            res[f"k1_{key}_event_ms"] = cuda_ms(k1, args.iters)
            dev_ms, n, per_call, _ = device_ms(k1, args.iters,
                                               "march_fwd_kernel")
            res[f"k1_{key}_device_ms"] = per_call if own == "fold" else dev_ms
            res[f"k1_{key}_device_entries"] = n
            if own == "fold":
                _, _, copy_ms, names = device_ms(k1, args.iters, "Memcpy")
                res["k1_c512_fold_copy_device_ms"] = copy_ms
                res["k1_c512_fold_copy_names"] = names
        print(json.dumps(res), flush=True)
        return res

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
            et_on = RenderSettings(height=h, width=w, step_size=1.8 / 512)
            res["frame_ref_ms"] = cuda_ms(
                lambda: render(vol, tf, cam, et_on, method="kernel"),
                args.iters)
        del kargs, out, g

    if args.what in ("k2", "all"):
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

    if args.what == "all":
        inv = ["invert", "--grid", "256", "--size", "256x256",
               "--march-steps", "512", "--views", "32", "--device", "cuda"]
        with open(os.devnull, "w") as null, contextlib.redirect_stderr(null):
            optimize.main(inv + ["--steps-opt", "1"])
            run = optimize.main(inv + ["--steps-opt", "5"])
        res["app_step_config4_ms"] = 1e3 * run["train_s"] / len(run["losses"])
        c5 = ["invert", "--grid", "512", "--size", "1920x1080",
              "--march-steps", "512", "--views", "2", "--device", "cuda",
              "--parallel", "depth"]
        with open(os.devnull, "w") as null, contextlib.redirect_stderr(null):
            optimize.main(c5 + ["--steps-opt", "1"])
            run = optimize.main(c5 + ["--steps-opt", "3"])
        res["app_step_config5_depth_ms"] = \
            1e3 * run["train_s"] / len(run["losses"])

    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
