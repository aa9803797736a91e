"""Differentiable-rendering optimization apps: TF-fit and grid inversion.

BASELINE configs 3-5 — capabilities with no reference counterpart (the
reference's TF editing is a human dragging markers,
``src/ui/components/gradient.cpp:134-469``):

* ``tf-fit``: recover the 1D transfer-function table from target images
  rendered with an unknown TF.
* ``invert``: recover the full density grid from N posed renders by
  pixel-loss gradient descent.

Both run on one device (``--device``, default ``cuda``: the K1 forward and
K2 backward kernels; ``cpu`` runs their plain versions), or on several
under ``torchrun``, one process per device (``parallel.distributed``):

* ``--parallel pixels`` (default): every view's pixels are sharded over the
  ranks in ``--row-layout`` (default ``tile-cyclic``: 16x16 tiles
  round-robin); the grid and the TF are replicated, and their gradients
  are summed across the ranks once per step (BASELINE config 5).
* ``--parallel depth``: the grid and its Adam moments are split into
  chunks along one array axis (``parallel.depth``).  The views come from
  two opposing yaw arcs, -40..40 and 140..220 degrees, and the split axis
  is the dominant axis of the views: the array axis with the largest sum
  over views of the view direction's component (``parallel.depth.
  dominant_axis``; the arcs give axis 1, y).  Checkpoints hold the whole
  grid and its moments, gathered on rank 0, and are split again on resume.

Checkpoint and resume through ``utils.checkpoint``:

    python -m volumetric_renderer_torch.apps.optimize invert \\
        --grid 64 --views 32 --steps-opt 200 --size 256x256 \\
        --ckpt-dir ckpt --resume
    torchrun --nproc_per_node 4 -m volumetric_renderer_torch.apps.optimize \\
        invert --grid 512 --size 1920x1080 --march-steps 512 --views 8 \\
        --parallel depth

The optimizer is ``torch.optim.Adam(lr)``, the same update as
``optax.adam``.  The TF-fit init draws ``uniform(0.2, 0.8)`` from a
``torch.Generator`` seeded with ``--seed``: other numbers than the JAX
package's ``jax.random`` draw from the same seed.

Not ported: ``--slab-mode`` (a TPU matmul-precision knob; the CUDA kernels
compute in f32 throughout).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from volumetric_renderer_torch.data.importer import import_volume
from volumetric_renderer_torch.data.volume import Volume
from volumetric_renderer_torch.parallel import depth
from volumetric_renderer_torch.parallel.distributed import init_distributed
from volumetric_renderer_torch.parallel.mesh import LAYOUTS, group_info
from volumetric_renderer_torch.parallel.render import make_sharded_renderer
from volumetric_renderer_torch.parallel.train import (
    init_depth_state,
    init_state,
    make_depth_train_step,
    make_train_step,
    stack_cameras,
)
from volumetric_renderer_torch.render.api import resolve_method
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils.metrics import PhaseTimers


def main(argv=None) -> dict:
    """Run the app; returns a summary: ``start`` (first step run),
    ``losses`` (one per step run), ``err`` (max abs error of the result
    against the ground truth), ``train_s`` (wall time of the steps),
    ``rays_per_s``, ``method``, ``device``, ``parallel``, ``world`` and
    ``axis`` (the split axis under ``--parallel depth``)."""
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
                    help="torch device (cuda, cuda:N or cpu); under torchrun "
                         "each rank takes cuda:LOCAL_RANK")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "fused", "kernel"],
                    help="auto = the CUDA kernels (K1 + K2) on a CUDA "
                         "device, the plain PyTorch re-march (fused) on the "
                         "CPU")
    ap.add_argument("--row-layout", default="tile-cyclic",
                    choices=list(LAYOUTS),
                    help="pixel distribution over the ranks (tile-cyclic = "
                         "16x16 tiles round-robin)")
    ap.add_argument("--parallel", default="pixels",
                    choices=["pixels", "depth"],
                    help="pixels: pixels sharded, grid replicated. depth: "
                         "the grid and its Adam moments split into chunks "
                         "along the views' dominant axis")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (use --device cpu)")
    owns_group = not dist.is_initialized()
    device = init_distributed(device=device)
    try:
        return _run(args, device)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device) -> dict:
    _, rank, world = group_info()
    depth_par = args.parallel == "depth"

    def say(*a):
        if rank == 0:
            print(*a, file=sys.stderr)

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
    vol_shape = tuple(vol_gt.shape)

    tf_gt = Gradient.grayscale_ramp().discretize(args.tf_resolution)
    tf_gt[:, 3] = np.linspace(0.0, 0.8, args.tf_resolution, dtype=np.float32)
    tf_gt = torch.as_tensor(tf_gt, device=device)

    # posed target views on an orbit ring (config 4 geometry); the depth
    # split takes two opposing yaw arcs, both directions of one axis
    if depth_par:
        half = -(-args.views // 2)
        yaws = np.concatenate([np.linspace(-40.0, 40.0, half),
                               np.linspace(140.0, 220.0, args.views - half)])
    else:
        yaws = np.linspace(0.0, 360.0, args.views, endpoint=False)
    cams = [OrbitCamera.from_angles(yaw_deg=float(a), pitch_deg=20.0)
            for a in yaws]

    method = resolve_method(vol_gt) if args.method == "auto" \
        else args.method
    axis = depth.dominant_axis(cams) if depth_par else None
    say(f"device: {device}, method: {method}, world: {world}, "
        + (f"depth-split grid along axis {axis}" if depth_par else
           f"{args.row_layout} pixel layout"))

    smin, smax = torch.zeros(3, device=device), torch.ones(3, device=device)
    if depth_par:
        # this rank's rows of the ground truth, and the whole grid's window
        vol_gt = depth.split_rows(vol_gt, axis)
        dmin, dmax = depth.global_window(vol_gt)
        render_fn = depth.make_depth_sharded_renderer(
            None, settings, vol_shape=vol_shape, axis=axis, method=method)
    else:
        dmin, dmax = vol_gt.min(), vol_gt.max()
        render_fn = make_sharded_renderer(None, settings, method,
                                          row_layout=args.row_layout)
    fixed = dict(vol=vol_gt, tf=tf_gt, dmin=dmin, dmax=dmax, smin=smin,
                 smax=smax)

    timers = PhaseTimers()
    with timers.phase("render_targets"), torch.no_grad():
        targets = torch.stack([render_fn(vol_gt, tf_gt, c, dmin, dmax, smin,
                                         smax) for c in cams])
        sync()

    optimize_vol = args.mode == "invert"
    optimize_tf = args.mode == "tf-fit"
    flags = dict(optimize_vol=optimize_vol, optimize_tf=optimize_tf,
                 method=method)
    params = {}
    if optimize_vol:
        # mid-window init (zeros sit in the TF sampler's zero-gradient
        # clamp zone)
        params["vol"] = torch.full(vol_shape, 0.3, device=device)
    if optimize_tf:
        gen = torch.Generator().manual_seed(args.seed)
        params["tf"] = (0.2 + 0.6 * torch.rand(
            (args.tf_resolution, 4), generator=gen)).to(device)

    def adam(p):
        return torch.optim.Adam(p, lr=args.lr)

    ckpt_kw, resume_kw = {}, {}
    if depth_par:
        step_fn = make_depth_train_step(settings, vol_shape=vol_shape,
                                        axis=axis, **flags)
        state = init_depth_state(params, adam, axis=axis)
        if optimize_vol:
            ckpt_kw["gather"] = {"vol": lambda x: depth.gather_rows(x, axis)}
            resume_kw["split"] = {"vol": lambda x: depth.split_rows(x, axis)}
    else:
        step_fn = make_train_step(settings, row_layout=args.row_layout,
                                  **flags)
        state = init_state(params, adam)

    start = 0
    if args.resume and args.ckpt_dir:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            state, start = load_checkpoint(ck, state, **resume_kw)
            say(f"resumed from {ck} at step {start}")

    rays_per_step = args.views * h * w
    # the views stacked and put on the device once, not on every step
    views = stack_cameras(cams).to(device)
    losses = []
    for i in range(start, args.steps_opt):
        with timers.phase("train_step"):
            state, loss = step_fn(state, fixed, views, targets)
            loss = float(loss)
        losses.append(loss)
        rate = (rays_per_step / timers.totals["train_step"]
                * max(1, i - start + 1))
        if i % 10 == 0 or i == args.steps_opt - 1:
            say(f"step {i:5d}  loss {loss:.6e}  ({rate:,.0f} rays/s)")
        if not np.isfinite(loss):
            raise SystemExit(f"non-finite loss at step {i}: fail-fast "
                             "(restart with --resume)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(f"{args.ckpt_dir}/ckpt_{i+1}.pt", state, i + 1,
                            write=rank == 0, **ckpt_kw)

    if rank == 0:
        timers.log_report()
    with torch.no_grad():
        key = "vol" if optimize_vol else "tf"
        result, truth = state.params[key], vol_gt if optimize_vol else tf_gt
        err = torch.max(torch.abs(result - truth))
        if world > 1:
            dist.all_reduce(err, op=dist.ReduceOp.MAX)
        err = float(err)
        say(f"{'grid' if optimize_vol else 'tf'} max abs err vs ground "
            f"truth: {err:.4f}")
        if depth_par and optimize_vol:
            result = depth.gather_rows(result, axis)
    if args.out and rank == 0:
        np.save(args.out, result.detach().cpu().numpy())
        print(args.out)
    train_s = timers.totals.get("train_step", 0.0)
    return dict(start=start, losses=losses, err=err, train_s=train_s,
                rays_per_s=(rays_per_step * len(losses) / train_s
                            if train_s else None),
                method=method, device=str(device), parallel=args.parallel,
                world=world, axis=axis)


if __name__ == "__main__":
    main()
