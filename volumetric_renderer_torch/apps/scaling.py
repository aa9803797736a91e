"""Single-card strong-scaling emulation for the pixel-sharded renderer.

The sharded forward (``parallel/render.py``) is communication-free until
its one ``all_gather`` of the finished blocks: an N-card run renders a
frame in ``max`` over the per-card band times, plus that gather.  Each
band's time is measurable on one card by handing the K1 kernel exactly the
rays that band owns: ``parallel/mesh.make_layout`` distributes the SAME
frame's ray grid (contiguous bands, 16-row blocks round-robin with
``cyclic``, 16x16 tiles round-robin with ``tile-cyclic`` or in a fixed
shuffled order with ``tile-shuffle``), not a rescaled frame — re-deriving
the grid at 1080/N rows distorts the camera frustum and makes
"efficiency" super-linear.

So:  ``efficiency(N) = t_full / (N * max_band_time(N))``.

The rays are set up once for the whole frame (``ray_grid``,
``core.marcher.prepare_rays``), as each card sets up its own; each band is
then ONE launch of the K1 kernel (``kernels.march.march_forward``; its
plain version on the CPU) over the packed ``pos0``/``dirs``/``hit`` of the
rays it owns, padding inert (``hit`` false).  K1 marches every ray alone,
so the bands, unpacked, equal the full frame bit for bit (``exact`` per
layout).

Dispatch floor: one launch over an all-miss 16x16 frame is the fixed cost
of a launch.  The emulation pays it once per band (N launches on one
card) where a real run pays it once per card, so
``efficiency_dispatch_adjusted`` removes it from each band.  The floor is
validated: the N bands of ``tile-cyclic`` at the largest N are marched as
N launches and as ONE launch over the N bands stacked (``(N * band_h,
W)``); ``floor_implied = (sum(separate) - one_launch) / (N - 1)`` should
come out near the all-miss floor.

    python -m volumetric_renderer_torch.apps.scaling --out scaling.json
    python -m volumetric_renderer_torch.apps.scaling --quick --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--tf-resolution", type=int, default=256)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--quick", action="store_true",
                    help="64^3 / 256x256 / 128 steps for smoke testing")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--out", default=None, help="write JSON here")
    args = ap.parse_args(argv)

    import torch

    from volumetric_renderer_torch.apps.bench import bench_tf
    from volumetric_renderer_torch.apps.render_cli import open_device
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.core.marcher import prepare_rays
    from volumetric_renderer_torch.kernels.march import march_forward
    from volumetric_renderer_torch.parallel.mesh import LAYOUTS, make_layout
    from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
    from volumetric_renderer_torch.utils.config import RenderSettings
    from volumetric_renderer_torch.utils.metrics import spread, time_calls

    device = open_device(args.device)
    if args.quick:
        w, h, steps, grid_n = 256, 256, 128, 64
    else:
        w, h = (int(v) for v in args.size.split("x"))
        steps, grid_n = args.steps, args.grid
    settings = RenderSettings(height=h, width=w, step_size=1.8 / steps,
                              early_termination=True)

    vol = Volume.synthetic_sphere(grid_n).as_torch(device)
    tf = torch.as_tensor(bench_tf(args.tf_resolution), device=device)
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    dmin = torch.tensor(0.0, device=device)
    origin, dirs = ray_grid(cam.to(device), h, w)
    pos0, hit, inv_window = prepare_rays(origin + 0.5, dirs, dmin,
                                         torch.tensor(1.0, device=device))
    window = (dmin, inv_window, torch.zeros(3, device=device),
              torch.ones(3, device=device))
    march_kw = dict(num_steps=steps, step_size=settings.step_size,
                    early_termination=True,
                    termination_eps=settings.termination_eps)
    up = torch.tensor([0.0, 0.0, 1.0], device=device)

    def march(rays):
        """One K1 launch over ``rays = (pos0, dirs, hit)``."""
        with torch.no_grad():
            return march_forward(vol, tf, *rays, *window, **march_kw)

    def timed(rays):
        return spread(time_calls(lambda: march(rays), args.iters,
                                 device))["median"]

    def bands(layout, n):
        """The frame's rays in shard order, padding inert, cut into the n
        bands (each one contiguous tensor per input), and the unpacking."""
        gh, _, pack, unpack, valid = make_layout(layout, h, w, n)
        valid = valid.to(device) > 0.0
        packed = (pack(pos0), torch.where(valid[..., None], pack(dirs), up),
                  pack(hit) & valid)
        band_h = gh // n
        return [tuple(x[d * band_h:(d + 1) * band_h].contiguous()
                      for x in packed) for d in range(n)], unpack

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# device={kind} workload={grid_n}^3, {w}x{h}, {steps} steps, "
          "ET on", file=sys.stderr)

    frame = (pos0, dirs, hit)
    full = march(frame)
    t_full = timed(frame)
    miss_dirs = torch.zeros((16, 16, 3), device=device)
    miss_dirs[..., 2] = 1.0
    t_floor = timed((torch.zeros_like(miss_dirs), miss_dirs,
                     torch.zeros((16, 16), dtype=torch.bool, device=device)))
    print(f"# full frame: {t_full:.3f} ms, dispatch floor {t_floor:.3f} ms",
          file=sys.stderr)

    n_val = max(args.devices)
    floor_val = None
    if n_val > 1:
        val_bands, _ = bands("tile-cyclic", n_val)
        t_sep = [timed(b) for b in val_bands]
        t_one = timed(tuple(torch.cat(x) for x in zip(*val_bands)))
        floor_implied = (sum(t_sep) - t_one) / (n_val - 1)
        floor_val = dict(n=n_val, sum_separate_ms=sum(t_sep),
                         one_launch_ms=t_one, floor_implied_ms=floor_implied,
                         floor_all_miss_ms=t_floor)
        print(f"# floor validation N={n_val}: separate {sum(t_sep):.3f} ms "
              f"vs one launch {t_one:.3f} ms -> implied floor "
              f"{floor_implied:.3f} ms/launch (all-miss frame: "
              f"{t_floor:.3f} ms)", file=sys.stderr)

    results = []
    for n in args.devices:
        if n == 1:
            results.append(dict(devices=1, layouts={"full": dict(
                band_ms=[t_full], efficiency=1.0, exact=True)}))
            continue
        entry = dict(devices=n, layouts={})
        for layout in LAYOUTS:
            layout_bands, unpack = bands(layout, n)
            band_ms = [timed(b) for b in layout_bands]
            exact = bool(torch.equal(
                unpack(torch.cat([march(b) for b in layout_bands])), full))
            eff = t_full / (n * max(band_ms))
            eff_adj = t_full / (n * max(b - t_floor for b in band_ms)
                                + t_floor)
            entry["layouts"][layout] = dict(
                band_ms=band_ms, max_band_ms=max(band_ms), efficiency=eff,
                efficiency_dispatch_adjusted=eff_adj, exact=exact)
            print(f"# N={n} {layout}: bands "
                  f"{['%.3f' % b for b in band_ms]} -> eff {eff:.3f} "
                  f"(adj {eff_adj:.3f}), exact {exact}", file=sys.stderr)
        results.append(entry)

    out = dict(
        method=("single-card strong-scaling emulation: each band marches "
                "the rays an N-card shard owns (a subset of the SAME frame's "
                "ray grid in the shard order of parallel/mesh.make_layout), "
                "set up once and marched by one K1 launch per band; the sharded forward needs no "
                "communication before its final all_gather, so the frame "
                "time is the largest band's and efficiency = t_full / (N * "
                "max_band).  efficiency_dispatch_adjusted also removes the "
                "measured per-launch floor from each band, since the emulation "
                "makes N launches where N cards make one each.  The all_gather "
                "and the backward's gradient all_reduce are not included "
                "(one card).  'exact': the bands, unpacked, equal the full "
                "frame bit for bit."),
        workload=f"{grid_n}^3 grid, {w}x{h}, {steps} steps, early "
                 "termination on; K1 on a CUDA device, its plain version on "
                 "the CPU",
        device=kind,
        iters=args.iters,
        t_full_ms=t_full,
        dispatch_floor_ms=t_floor,
        dispatch_floor_validation=floor_val,
        emulated_strong_scaling=results,
    )
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(args.out)
    else:
        print(text)
    return out


if __name__ == "__main__":
    main()
