"""Scaling benchmark harness: rays/s at 1..N devices + efficiency.

Measures the BASELINE scaling metric — rays/s efficiency from 1 card to
all of them (target >= 0.9) — by timing the pixel-sharded renderer
(``parallel/render.make_sharded_renderer``) on process groups of 1, 2, 4
... ranks and of every rank.  One process per card, under ``torchrun``:

    torchrun --standalone --nproc_per_node 4 -m \\
        volumetric_renderer_torch.apps.benchmark --size 512x512 \\
        --steps 256 --grid 128

Every rank creates every group (``dist.new_group`` in the same order on
all ranks); the ranks of a group time it while the others wait at a
barrier.  Without a process group (a plain ``python -m`` run) it reports
``devices=1`` only.  ``--grad`` times the gradient of ``mean(img**2)``
with respect to the grid and the TF (K1 and K2 on a card, the gradients
summed across the group once).  Rank 0 prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys


# the layout apps.optimize trains with (its --row-layout default), so the
# scaling measured here is that of the sharded training path: 16x16 tiles
# round-robin over the ranks (parallel/mesh.py)
ROW_LAYOUT = "tile-cyclic"


def _sizes(world: int) -> list:
    sizes, n = [], 1
    while n <= world:
        sizes.append(n)
        n *= 2
    if sizes[-1] != world:
        sizes.append(world)
    return sizes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--grad", action="store_true",
                    help="benchmark forward+backward instead of forward")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu); under torchrun each "
                         "rank takes cuda:LOCAL_RANK")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from volumetric_renderer_torch.apps.render_cli import open_device
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.parallel.distributed import (
        init_distributed,
    )
    from volumetric_renderer_torch.parallel.mesh import group_info
    from volumetric_renderer_torch.parallel.render import (
        make_sharded_renderer,
    )
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.config import RenderSettings
    from volumetric_renderer_torch.utils.metrics import spread, time_calls

    device = open_device(args.device)
    owns_group = not dist.is_initialized()
    device = init_distributed(device=device)
    try:
        _, rank, world = group_info()
        w, h = (int(v) for v in args.size.split("x"))
        settings = RenderSettings(height=h, width=w,
                                  step_size=1.8 / args.steps)
        vol = Volume.synthetic_sphere(args.grid).as_torch(device)
        tf = torch.as_tensor(Gradient.grayscale_ramp().discretize(256),
                             device=device)
        cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
        window = (torch.tensor(0.0, device=device),
                  torch.tensor(1.0, device=device),
                  torch.zeros(3, device=device), torch.ones(3, device=device))

        results = []
        for n in _sizes(world):
            # every rank makes every group, in the same order
            group = (None if n == world else
                     dist.new_group(list(range(n))))
            if rank < n:
                render_fn = make_sharded_renderer(group, settings,
                                                  row_layout=ROW_LAYOUT)

                def forward():
                    with torch.no_grad():
                        return render_fn(vol, tf, cam, *window)

                def fwd_bwd():
                    v = vol.detach().requires_grad_(True)
                    t = tf.detach().requires_grad_(True)
                    img = render_fn(v, t, cam, *window)
                    return torch.autograd.grad(torch.mean(img ** 2), (v, t))

                work = fwd_bwd if args.grad else forward
                # as the JAX benchmark: the sum of the frame, or of the
                # grid's gradient with --grad
                warm = work()
                checksum = float((warm[0] if args.grad else warm)
                                 .double().sum())
                times = spread(time_calls(work, args.iters, device))
                rays = h * w / (times["median"] / 1e3)
                results.append(dict(devices=n, rays_per_s=rays,
                                     ms=times["median"], ms_spread=times,
                                     checksum=checksum))
                if rank == 0:
                    eff = rays / (n * results[0]["rays_per_s"])
                    print(f"devices={n:3d}  {times['median']:8.3f} ms  "
                          f"{rays:14,.0f} rays/s  efficiency={eff:.3f}",
                          file=sys.stderr)
            if world > 1:
                dist.barrier()
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()

    if rank == 0:
        base = results[0]["rays_per_s"]
        for r in results:
            r["efficiency"] = r["rays_per_s"] / (r["devices"] * base)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    out = {
        "workload": f"{args.grid}^3/{args.size}/{args.steps}steps"
                    + ("/grad" if args.grad else ""),
        "device": kind, "row_layout": ROW_LAYOUT, "iters": args.iters,
        "scaling": results,
    }
    if rank == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
