"""Headline benchmark: rays/s on one card at the reference workload.

Workload (BASELINE.md, config 3 forward): 256^3 density grid,
1920x1080 image, 512 steps/ray, 256-texel RGBA transfer function with
alpha ``linspace(0, 1)**2``, early ray termination on, camera yaw 30 pitch
20 radius 3.

    python -m volumetric_renderer_torch.apps.bench [--quick] [--grid 512]
        [--grad [--ray-chunks K]] [--iters N] [--device cuda|cpu]
        [--size WxH] [--steps N]

Prints ONE JSON line:
  {"metric": ..., "value": rays/s, "unit": "rays/s", "vs_baseline": R, ...}
``value`` is H*W over the median frame time of ``render(method=...)``
(``auto``: the K1 kernel on a CUDA device), each call timed with CUDA
events over ``--iters`` calls after one warm-up.  ``vs_baseline`` is its
speedup over ``method="oracle"``, the plain-autograd march, on a
row-subsampled frame (H/8 rows, at least 64; rays/s normalises per ray),
timed over at most 3 calls: the oracle takes seconds a frame.
Every median stands beside its spread: ``<name>_spread`` holds the
median, min, quartiles, max and count of the per-call times in ms.
``texture_fills_timed`` counts the copies of the grid into K1's texture
inside the timed calls (0 unless something else changed the grid).
``grid_bytes_gib`` is added from 512^3 on.

``--grad`` times the training path instead: the forward (K1) and
forward+backward (K1 and K2, through ``MarchFunction``) of the loss
``sum(img**2) / (H*W)`` over the whole image, reported as ``fwd_ms`` and
``fwd_bwd_ms`` (medians) with ``value`` the training rays/s and
``vs_baseline`` the fwd+bwd cost in forwards.  ``--ray-chunks K`` splits
the image into K row bands per step and accumulates: the band gradients
are summed into the grid's and the TF's ``.grad`` and the sum is the whole
image's (the JAX package's ``bench.py`` returns the last band's alone).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def bench_tf(n: int = 256) -> np.ndarray:
    """The benchmark TF: the grayscale ramp with alpha ``linspace(0,1)**2``
    (opaque centres terminate rays early)."""
    from volumetric_renderer_torch.transfer.gradient import Gradient

    tf = Gradient.grayscale_ramp().discretize(n)
    tf[:, 3] = np.linspace(0.0, 1.0, n, dtype=np.float32) ** 2
    return tf


def band_grads(marcher, vol, tf, origin, dirs, chunks: int, scal):
    """Gradients of ``sum(img**2) / (H*W)`` with respect to ``(vol, tf)``
    over the whole image ``dirs`` (H, W, 3), marched in ``chunks`` row
    bands: each band's backward adds into the same ``.grad``, so the result
    is the whole image's for any number of bands."""
    h, w = dirs.shape[:2]
    if h % chunks:
        raise ValueError(f"{chunks} row bands do not divide height {h}")
    hc = h // chunks
    v = vol.detach().requires_grad_(True)
    t = tf.detach().requires_grad_(True)
    for i in range(chunks):
        img = marcher(v, t, origin, dirs[i * hc:(i + 1) * hc], *scal)
        ((img ** 2).sum() / (h * w)).backward()
    return v.grad, t.grad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="small workload for local iteration (64^3, "
                         "256x256, 128 steps)")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "kernel", "fused", "oracle"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the oracle baseline measurement")
    ap.add_argument("--grid", type=int, default=256,
                    help="volume resolution (512 = BASELINE config-5 scale)")
    ap.add_argument("--size", default="1920x1080", help="image WxH")
    ap.add_argument("--steps", type=int, default=512, help="march steps")
    ap.add_argument("--ray-chunks", type=int, default=1,
                    help="with --grad: K row bands per training step, their "
                         "gradients accumulated")
    ap.add_argument("--grad", action="store_true",
                    help="benchmark the training path: fwd_ms / fwd_bwd_ms "
                         "/ train rays/s")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    import torch

    from volumetric_renderer_torch.apps.render_cli import open_device
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.kernels.march import march_forward
    from volumetric_renderer_torch.render.api import (
        make_marcher, render, select_method,
    )
    from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
    from volumetric_renderer_torch.utils.config import RenderSettings
    from volumetric_renderer_torch.utils.metrics import spread, time_calls

    device = open_device(args.device)
    if args.quick:
        h, w, steps, grid_n = 256, 256, 128, 64
    else:
        w, h = (int(v) for v in args.size.split("x"))
        steps, grid_n = args.steps, args.grid
    settings = RenderSettings(height=h, width=w, step_size=1.8 / steps,
                              early_termination=True)
    vol = Volume.synthetic_sphere(grid_n).as_torch(device)
    tf = torch.as_tensor(bench_tf(), device=device)
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    method = select_method(args.method, vol)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# device={kind} workload={grid_n}^3 grid, {w}x{h}, {steps} "
          f"steps, method={method}{' (grad)' if args.grad else ''}",
          file=sys.stderr)
    rays = h * w
    if h % args.ray_chunks:
        raise SystemExit(f"--ray-chunks {args.ray_chunks} must divide "
                         f"height {h}")
    fills = []

    def timed(fn, iters):
        """The spread of ``fn``'s times; the copies of the grid into K1's
        texture inside the timed calls are counted (the first call, not
        timed, makes the one the grid needs)."""
        fn()
        before = march_forward.texture_fills
        t = spread(time_calls(fn, iters, device, warmup=0))
        fills.append(march_forward.texture_fills - before)
        return t

    if args.grad:
        marcher = make_marcher(method, settings)
        origin, dirs = ray_grid(cam.to(device), h, w)
        origin = origin + 0.5
        scal = (torch.tensor(0.0, device=device),
                torch.tensor(1.0, device=device),
                torch.zeros(3, device=device), torch.ones(3, device=device))
        hc = h // args.ray_chunks
        bands = [dirs[i * hc:(i + 1) * hc] for i in range(args.ray_chunks)]

        def fwd():
            with torch.no_grad():
                return [marcher(vol, tf, origin, d, *scal) for d in bands]

        t_fwd = timed(fwd, args.iters)
        t_fb = timed(lambda: band_grads(marcher, vol, tf, origin, dirs,
                                        args.ray_chunks, scal), args.iters)
        print(f"# fwd {t_fwd['median']:.3f} ms, fwd+bwd "
              f"{t_fb['median']:.3f} ms -> "
              f"{rays / t_fb['median'] * 1e3:,.0f} train rays/s",
              file=sys.stderr)
        out = {
            "metric": f"train_rays_per_sec_per_chip_{grid_n}cubed_"
                      f"{w}x{h}_{steps}steps",
            "value": rays / (t_fb["median"] / 1e3),
            "unit": "rays/s",
            "vs_baseline": t_fb["median"] / t_fwd["median"],
            "fwd_ms": t_fwd["median"],
            "fwd_bwd_ms": t_fb["median"],
            "fwd_ms_spread": t_fwd,
            "fwd_bwd_ms_spread": t_fb,
            "ray_chunks": args.ray_chunks,
        }
    else:
        def frame(s=settings, m=method):
            with torch.no_grad():
                return render(vol, tf, cam, s, method=m)

        t_frame = timed(frame, args.iters)
        out = {
            "metric": f"rays_per_sec_per_chip_{grid_n}cubed_{w}x{h}_"
                      f"{steps}steps",
            "value": rays / (t_frame["median"] / 1e3),
            "unit": "rays/s",
            "vs_baseline": 1.0,
            "ms": t_frame["median"],
            "ms_spread": t_frame,
        }
        print(f"# {method}: {t_frame['median']:.3f} ms/frame -> "
              f"{out['value']:,.0f} rays/s", file=sys.stderr)
        if not args.no_baseline:
            # the oracle, the plain-autograd march of the reference shader
            # (volume.frag:21-51), on a row-subsampled frame
            bh = max(64, h // 8)
            t_base = timed(
                lambda: frame(settings.replace(height=bh), "oracle"),
                min(args.iters, 3))
            base_rays_per_s = bh * w / (t_base["median"] / 1e3)
            out["vs_baseline"] = out["value"] / base_rays_per_s
            out.update(baseline_rows=bh, baseline_ms=t_base["median"],
                       baseline_ms_spread=t_base,
                       baseline_rays_per_s=base_rays_per_s)
            print(f"# oracle baseline ({bh}x{w}): {t_base['median']:.1f} ms "
                  f"-> {base_rays_per_s:,.0f} rays/s", file=sys.stderr)
    out.update(device=kind, method=method, iters=args.iters,
               texture_fills_timed=sum(fills))
    if grid_n >= 512:
        # config-5 scale sidecar: replication headroom arithmetic
        out["grid_bytes_gib"] = round(grid_n ** 3 * 4 / 2 ** 30, 3)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
