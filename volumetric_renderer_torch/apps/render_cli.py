"""Offline renderer CLI — the reference app's interactive surface as flags.

The reference exposes, via ImGui (``src/ui/main_window.cpp:178-258``):
dataset import (NRRD / CSV stack), camera orbit + zoom, per-axis slicing
windows, the density window, and a transfer-function editor.  This CLI maps
each of those controls onto an offline invocation producing a PNG (and
optionally the raw RGBA .npy):

    python -m volumetric_renderer_torch.apps.render_cli head.nrrd \\
        --yaw 30 --pitch 20 --zoom 3 --size 1024x768 \\
        --slice-x 0.1:0.9 --tf preset:grayscale --out head.png --device cuda

Transfer functions: ``preset:grayscale`` (the reference default,
black->white / alpha 1, ``gradient.cpp:64-70``), ``preset:ramp``
(alpha ramp), or a JSON file with ``color_markers`` / ``alpha_markers``
lists mirroring the marker data model (``gradient.h:11-35``).

``--device cuda`` renders on the card (``--method auto`` then runs the CUDA
kernel) and is an error where no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time
import zlib

import numpy as np


def parse_range(s: str):
    lo, hi = s.split(":")
    return float(lo), float(hi)


def load_tf(spec: str, resolution: int):
    from volumetric_renderer_torch.transfer.gradient import Gradient
    if spec.startswith("preset:"):
        name = spec.split(":", 1)[1]
        if name == "grayscale":
            g = Gradient()           # reference default markers
        elif name == "ramp":
            g = Gradient.grayscale_ramp()
        else:
            raise SystemExit(f"unknown TF preset {name!r}")
    else:
        with open(spec) as f:
            d = json.load(f)
        g = Gradient(
            color_markers=[(m[0], tuple(m[1:4]))
                           for m in d.get("color_markers", [])] or None,
            alpha_markers=[tuple(m) for m in d.get("alpha_markers", [])]
            or None,
        )
    return g.discretize(resolution)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an ``(H, W, 3)`` uint8 image as an 8-bit RGB PNG (stdlib only)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    # each scanline: filter byte 0 (None) + the row's RGB bytes
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Render a volumetric dataset to PNG (CUDA/CPU)")
    ap.add_argument("dataset", nargs="+",
                    help="NRRD file, or CSV slice files (one per Z slice)")
    ap.add_argument("--format", choices=["nrrd", "csv"], default=None)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--npy", default=None, help="also save raw RGBA .npy")
    ap.add_argument("--size", default="1280x720",
                    help="WxH (reference window: 1280x720)")
    ap.add_argument("--yaw", type=float, default=0.0)
    ap.add_argument("--pitch", type=float, default=0.0)
    ap.add_argument("--zoom", type=float, default=3.0,
                    help="orbit radius, clamped to [0.1, 10] like "
                         "camera.cpp:31-34")
    ap.add_argument("--steps", type=int, default=360,
                    help="march steps (reference: 360, volume.frag:29-31)")
    ap.add_argument("--ray-dist", type=float, default=1.8)
    ap.add_argument("--slice-x", type=parse_range, default=(0.0, 1.0),
                    metavar="LO:HI")
    ap.add_argument("--slice-y", type=parse_range, default=(0.0, 1.0),
                    metavar="LO:HI")
    ap.add_argument("--slice-z", type=parse_range, default=(0.0, 1.0),
                    metavar="LO:HI")
    ap.add_argument("--density", type=parse_range, default=None,
                    metavar="LO:HI", help="density window (default: "
                    "dataset min/max, offscreen_pass.cpp:265-266)")
    ap.add_argument("--tf", default="preset:grayscale")
    ap.add_argument("--tf-resolution", type=int, default=256)
    ap.add_argument("--background", type=float, nargs=3,
                    default=(0.11, 0.11, 0.11))
    ap.add_argument("--no-early-termination", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda, cuda:N or cpu)")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "oracle", "fused", "kernel"],
                    help="auto = the CUDA kernel on a CUDA device, the "
                         "plain PyTorch march (fused) on the CPU")
    ap.add_argument("--synthetic", action="store_true",
                    help="ignore dataset path; render the built-in sphere")
    args = ap.parse_args(argv)

    import torch

    from volumetric_renderer_torch.data.importer import import_volume
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.render.api import composite_over, render
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.utils.config import RenderSettings

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (use --device cpu)")

    w, h = (int(v) for v in args.size.split("x"))
    if args.synthetic:
        vol = Volume.synthetic_sphere(64)
    else:
        paths = args.dataset if len(args.dataset) > 1 else args.dataset[0]
        vol = import_volume(paths, fmt=args.format)

    tf = torch.as_tensor(load_tf(args.tf, args.tf_resolution), device=device)
    cam = OrbitCamera.from_angles(yaw_deg=args.yaw, pitch_deg=args.pitch,
                                  radius=args.zoom)
    settings = RenderSettings(
        height=h, width=w,
        step_size=args.ray_dist / args.steps, ray_dist=args.ray_dist,
        early_termination=not args.no_early_termination,
        tf_resolution=args.tf_resolution,
    )
    dmin, dmax = args.density if args.density else (vol.vmin, vol.vmax)
    smin = [args.slice_x[0], args.slice_y[0], args.slice_z[0]]
    smax = [args.slice_x[1], args.slice_y[1], args.slice_z[1]]
    vol_t = vol.as_torch(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    img = render(vol_t, tf, cam, settings,
                 density_min=dmin, density_max=dmax,
                 slice_min=smin, slice_max=smax, method=args.method)
    sync()
    dt = time.perf_counter() - t0
    print(f"rendered {w}x{h} on {device} in {dt:.3f}s "
          f"({h * w / dt:,.0f} rays/s, first call incl. any kernel build)",
          file=sys.stderr)

    if args.npy:
        np.save(args.npy, img.cpu().numpy())
    rgb = composite_over(img, args.background).cpu().numpy()
    write_png(args.out, (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8))
    print(args.out)


if __name__ == "__main__":
    main()
