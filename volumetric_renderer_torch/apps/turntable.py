"""Turntable viewer: the offline replacement for the SDL/ImGui front end.

The reference demonstrates itself with an orbiting GIF
(``docs/images/example.gif``; camera drag = ``Camera::rotate``,
``src/scene/camera.cpp:15-29``).  This app reproduces that artifact
head-on: render an orbit sweep and write an animated GIF (or a PNG frame
sequence), with the same orbit camera math and a live rays/s meter in
place of the status-bar FPS counter.

    python -m volumetric_renderer_torch.apps.turntable --synthetic \\
        --frames 36 --size 512x512 --out orbit.gif
    python -m volumetric_renderer_torch.apps.turntable --synthetic \\
        --frames 36 --out frames/orbit_%d.png --device cpu

Each frame is ``render(method="auto")``: the K1 kernel on a CUDA device,
the plain PyTorch march on the CPU.  The grid stays one tensor, so K1
copies it into its texture once, for the first frame.  A GIF needs PIL; PNG
frames are written with ``render_cli.write_png`` and need nothing more.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--pitch", type=float, default=20.0)
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--steps", type=int, default=180)
    ap.add_argument("--out", default="orbit.gif")
    ap.add_argument("--fps", type=int, default=12)
    ap.add_argument("--tf", default="preset:ramp")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    import torch

    from volumetric_renderer_torch.apps.render_cli import (
        load_tf, open_device, write_png,
    )
    from volumetric_renderer_torch.data.importer import import_volume
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.render.api import composite_over, render
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.utils.config import RenderSettings
    from volumetric_renderer_torch.utils.metrics import ThroughputMeter

    device = open_device(args.device)
    w, h = (int(v) for v in args.size.split("x"))
    vol = (Volume.synthetic_sphere(64)
           if args.synthetic or not args.dataset
           else import_volume(args.dataset))
    tf = torch.as_tensor(load_tf(args.tf, 256), device=device)
    settings = RenderSettings(height=h, width=w,
                              step_size=1.8 / args.steps)
    vol_t = vol.as_torch(device)
    bg = (0.11, 0.11, 0.11)

    meter = ThroughputMeter()
    meter.tick(0)
    frames = []
    # no_grad, not inference_mode: K1 keys its texture copy on the grid's
    # version counter, which an inference tensor lacks
    with torch.no_grad():
        for i in range(args.frames):
            cam = OrbitCamera.from_angles(
                yaw_deg=360.0 * i / args.frames, pitch_deg=args.pitch)
            rgb = composite_over(
                render(vol_t, tf, cam, settings, density_min=vol.vmin,
                       density_max=vol.vmax), bg).cpu().numpy()
            rate = meter.tick(h * w)
            if i == 0 or (i + 1) % 10 == 0:
                print(f"frame {i+1}/{args.frames}"
                      + (f"  {rate:,.0f} rays/s" if rate else ""),
                      file=sys.stderr)
            frames.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))

    if args.out.endswith(".gif"):
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(args.out, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / args.fps), loop=0)
        paths = [args.out]
    else:
        paths = [args.out.replace("%d", str(i)) if "%d" in args.out
                 else f"{args.out}.{i:04d}.png" for i in range(len(frames))]
        for path, frame in zip(paths, frames):
            write_png(path, frame)
    print(args.out)
    return {"paths": paths, "frames": len(frames), "rays_per_s": meter.rate}


if __name__ == "__main__":
    main()
