"""Early-termination ablation on realistic workloads.

The reference never terminates rays early — it breaks only on leaving the
unit cube (``res/shaders/volume.frag:33-37``); early termination on
transmittance saturation is a BASELINE-required improvement.  Whether it
*pays* depends on the scene: a translucent sphere rarely saturates, while
an opaque surface — the CT-head case it exists for (BASELINE config 2) —
stops rays within a few samples of the skull shell.

Measures, on one device:

* config 2: ``models.head_phantom`` 128^3, 512x512, 360 steps, an opaque
  bone TF (alpha ramps to 1 at skull density) — the port's methods
  (``kernel``: K1; ``fused``: its plain PyTorch version; ``oracle``: the
  plain-autograd march), ET on vs off.
* flagship: 256^3 sphere, 1920x1080, 512 steps, the bench TF —
  ``method="auto"`` only (K1 on a CUDA device), ET on vs off.

Each time is the median of ``--iters`` calls after one warm-up (CUDA events
on a card), beside its spread; the plain PyTorch methods take seconds a
frame on a card and are timed over at most 3 calls (``plain_iters``).

    python -m volumetric_renderer_torch.apps.ablation --out ablation.json
    python -m volumetric_renderer_torch.apps.ablation --device cpu \\
        --methods fused --skip-flagship --size 64x64 --steps 48
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def bone_tf(n: int = 256) -> np.ndarray:
    """Config 2's bone TF: the grayscale ramp with a linear alpha that
    reaches 1 by skull density (0.9 of the phantom's range)."""
    from volumetric_renderer_torch.transfer.gradient import Gradient

    tf = Gradient.grayscale_ramp().discretize(n)
    tf[:, 3] = np.clip(np.linspace(0.0, 1.0, n, dtype=np.float32) / 0.85,
                       0.0, 1.0)
    return tf


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--skip-flagship", action="store_true")
    ap.add_argument("--methods", nargs="+",
                    default=["kernel", "fused", "oracle"],
                    choices=["auto", "kernel", "fused", "oracle"])
    ap.add_argument("--size", default="512x512",
                    help="config-2 image size (shrink for smoke tests)")
    ap.add_argument("--steps", type=int, default=360,
                    help="config-2 march steps")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from volumetric_renderer_torch import models
    from volumetric_renderer_torch.apps.bench import bench_tf
    from volumetric_renderer_torch.apps.render_cli import open_device
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.render.api import render, select_method
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.utils.config import RenderSettings
    from volumetric_renderer_torch.utils.metrics import spread, time_calls

    device = open_device(args.device)
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    plain_iters = min(args.iters, 3)
    out = {"device": kind, "iters": args.iters, "plain_iters": plain_iters,
           "workloads": {}}

    def run(name, vol, tf, settings, methods):
        res = {}
        rays = settings.height * settings.width
        methods = [select_method(m, vol) for m in methods]
        for method in methods:
            for et in (True, False):
                s = settings.replace(early_termination=et)

                def frame(s=s, m=method):
                    with torch.no_grad():
                        return render(vol, tf, cam, s, method=m)

                iters = args.iters if method == "kernel" else plain_iters
                t = spread(time_calls(frame, iters, device))
                key = f"{method}_et{'on' if et else 'off'}"
                res[key] = dict(ms_per_frame=t["median"],
                                rays_per_s=rays / (t["median"] / 1e3),
                                ms_spread=t)
                print(f"# {name} {key}: {t['median']:.3f} ms",
                      file=sys.stderr)
        for method in methods:
            on = res[f"{method}_eton"]["ms_per_frame"]
            off = res[f"{method}_etoff"]["ms_per_frame"]
            res[f"et_speedup_{method}"] = off / on
            print(f"# {name} ET speedup {method}: {off/on:.3f}x",
                  file=sys.stderr)
        out["workloads"][name] = res

    # config 2: opaque skull — the case early termination exists for
    vol2 = models.head_phantom(128).as_torch(device)
    c2w, c2h = (int(v) for v in args.size.split("x"))
    run("config2_head_phantom", vol2,
        torch.as_tensor(bone_tf(), device=device),
        RenderSettings(height=c2h, width=c2w, step_size=1.8 / args.steps),
        args.methods)

    if not args.skip_flagship:
        vol3 = Volume.synthetic_sphere(256).as_torch(device)
        run("flagship_sphere", vol3,
            torch.as_tensor(bench_tf(), device=device),
            RenderSettings(height=1080, width=1920, step_size=1.8 / 512),
            ["auto"])

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
