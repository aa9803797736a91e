"""Differentiable-rendering optimization apps: TF-fit and grid inversion.

BASELINE configs 3-4 — capabilities with no reference counterpart (the
reference's TF editing is a human dragging markers,
``src/ui/components/gradient.cpp:134-469``):

* ``tf-fit``: recover the 1D transfer-function table from target images
  rendered with an unknown TF.
* ``invert``: recover the full density grid from N posed renders by
  pixel-loss gradient descent.

Both run on one device (``--device``, default ``cuda``: the K1 forward and
K2 backward kernels; ``cpu`` runs their plain versions) and
checkpoint/resume via ``utils.checkpoint``:

    python -m volumetric_renderer_torch.apps.optimize invert \\
        --grid 64 --views 32 --steps-opt 200 --size 256x256 \\
        --ckpt-dir ckpt --resume

The optimizer is ``torch.optim.Adam(lr)``, the same update as
``optax.adam``.  The TF-fit init draws ``uniform(0.2, 0.8)`` from a
``torch.Generator`` seeded with ``--seed``: other numbers than the JAX
package's ``jax.random`` draw from the same seed.

Not ported: ``--row-layout`` and ``--parallel`` (mesh options; they come
with ``parallel/`` on ``torch.distributed``) and ``--slab-mode`` (a TPU
matmul-precision knob; the CUDA kernels compute in f32 throughout).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> dict:
    """Run the app; returns a summary: ``start`` (first step run),
    ``losses`` (one per step run), ``err`` (max abs error of the result
    against the ground truth), ``train_s`` (wall time of the steps),
    ``rays_per_s``, ``method`` and ``device``."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["tf-fit", "invert"])
    ap.add_argument("--dataset", default=None,
                    help="NRRD ground-truth volume (default: synthetic)")
    ap.add_argument("--grid", type=int, default=64,
                    help="synthetic grid resolution")
    ap.add_argument("--size", default="256x256", help="render WxH")
    ap.add_argument("--march-steps", type=int, default=128)
    ap.add_argument("--views", type=int, default=32,
                    help="posed target views (config 4: 32)")
    ap.add_argument("--steps-opt", type=int, default=200)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--tf-resolution", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="save result (.npy)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "fused", "kernel"],
                    help="auto = the CUDA kernels (K1 + K2) on a CUDA "
                         "device, the plain PyTorch re-march (fused) on the "
                         "CPU")
    args = ap.parse_args(argv)

    import torch

    from volumetric_renderer_torch.data.importer import import_volume
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.parallel.train import (
        init_state, make_train_step,
    )
    from volumetric_renderer_torch.render.api import render, resolve_method
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.checkpoint import (
        latest_checkpoint, load_checkpoint, save_checkpoint,
    )
    from volumetric_renderer_torch.utils.config import RenderSettings
    from volumetric_renderer_torch.utils.metrics import PhaseTimers

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (use --device cpu)")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    w, h = (int(v) for v in args.size.split("x"))
    settings = RenderSettings(height=h, width=w,
                              step_size=1.8 / args.march_steps,
                              early_termination=False,
                              tf_resolution=args.tf_resolution)

    if args.dataset:
        vol_gt = import_volume(args.dataset).as_torch(device)
    else:
        vol_gt = Volume.synthetic_sphere(args.grid).as_torch(device)

    tf_gt = Gradient.grayscale_ramp().discretize(args.tf_resolution)
    tf_gt[:, 3] = np.linspace(0.0, 0.8, args.tf_resolution, dtype=np.float32)
    tf_gt = torch.as_tensor(tf_gt, device=device)

    # posed target views on an orbit ring (config 4 geometry)
    yaws = np.linspace(0.0, 360.0, args.views, endpoint=False)
    cams = [OrbitCamera.from_angles(yaw_deg=float(a), pitch_deg=20.0)
            for a in yaws]

    method = resolve_method(vol_gt) if args.method == "auto" else args.method
    print(f"device: {device}, method: {method}", file=sys.stderr)

    fixed = dict(vol=vol_gt, tf=tf_gt, dmin=vol_gt.min(), dmax=vol_gt.max(),
                 smin=torch.zeros(3, device=device),
                 smax=torch.ones(3, device=device))

    timers = PhaseTimers()
    with timers.phase("render_targets"), torch.no_grad():
        targets = torch.stack([
            render(vol_gt, tf_gt, c, settings, density_min=fixed["dmin"],
                   density_max=fixed["dmax"], slice_min=fixed["smin"],
                   slice_max=fixed["smax"], method=method) for c in cams])
        sync()

    optimize_vol = args.mode == "invert"
    optimize_tf = args.mode == "tf-fit"
    step_fn = make_train_step(settings, optimize_vol=optimize_vol,
                              optimize_tf=optimize_tf, method=method)

    params = {}
    if optimize_vol:
        # mid-window init (zeros sit in the TF sampler's zero-gradient
        # clamp zone)
        params["vol"] = torch.full_like(vol_gt, 0.3)
    if optimize_tf:
        gen = torch.Generator().manual_seed(args.seed)
        params["tf"] = (0.2 + 0.6 * torch.rand(
            (args.tf_resolution, 4), generator=gen)).to(device)
    state = init_state(params,
                       lambda p: torch.optim.Adam(p, lr=args.lr))

    start = 0
    if args.resume and args.ckpt_dir:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            state, start = load_checkpoint(ck, state)
            print(f"resumed from {ck} at step {start}", file=sys.stderr)

    rays_per_step = args.views * h * w
    losses = []
    for i in range(start, args.steps_opt):
        with timers.phase("train_step"):
            state, loss = step_fn(state, fixed, cams, targets)
            loss = float(loss)
        losses.append(loss)
        rate = (rays_per_step / timers.totals["train_step"]
                * max(1, i - start + 1))
        if i % 10 == 0 or i == args.steps_opt - 1:
            print(f"step {i:5d}  loss {loss:.6e}  ({rate:,.0f} rays/s)",
                  file=sys.stderr)
        if not np.isfinite(loss):
            raise SystemExit(f"non-finite loss at step {i}: fail-fast "
                             "(restart with --resume)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(f"{args.ckpt_dir}/ckpt_{i+1}.pt", state, i + 1)

    timers.log_report()
    with torch.no_grad():
        if optimize_vol:
            result = state.params["vol"]
            err = float(torch.max(torch.abs(result - vol_gt)))
            print(f"grid max abs err vs ground truth: {err:.4f}",
                  file=sys.stderr)
        else:
            result = state.params["tf"]
            err = float(torch.max(torch.abs(result - tf_gt)))
            print(f"tf max abs err vs ground truth: {err:.4f}",
                  file=sys.stderr)
    if args.out:
        np.save(args.out, result.detach().cpu().numpy())
        print(args.out)
    train_s = timers.totals.get("train_step", 0.0)
    return dict(start=start, losses=losses, err=err, train_s=train_s,
                rays_per_s=(rays_per_step * len(losses) / train_s
                            if train_s else None),
                method=method, device=str(device))


if __name__ == "__main__":
    main()
