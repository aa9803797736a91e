"""An orbiting viewer: one frame in flight, closed loop.

The viewer passes a host camera each frame, calls the renderer's
``render`` (``method="auto"``: the ray setup and K1 on a card) and waits
until the frame's image is complete on the card before it asks for the
next, as a viewer that shows each frame does.  The yaw advances
``yaw_step_deg`` a frame from a start drawn from the seed, at a fixed
pitch and radius; one revolution's cameras are made in set-up.

End-to-end: ``rays_per_s`` (the window's frames times H times W over the
window) and ``frame_p95_ms`` (the 95th percentile of every frame's
latency, from the host's call to the end of the frame on the card).
``correct``: frames drawn from the seed among the window's, and its last,
against the reference (``checks.frame_numbers``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vrbench import checks, inputs, session, work
from vrbench.reference import march as ref


def settings_of(cell, m: ref.March):
    from volumetric_renderer_torch.utils.config import RenderSettings
    p, cam = cell.params, cell.config["camera"]
    s = RenderSettings(height=p["height"], width=p["width"],
                       step_size=m.step_size,
                       ray_dist=cell.config["march"]["ray_dist"],
                       early_termination=m.early_termination,
                       termination_eps=m.termination_eps,
                       tf_resolution=cell.config["tf_texels"],
                       fov_y_degrees=cam["fov_y_degrees"], near=cam["near"],
                       far=cam["far"])
    if s.num_steps != m.num_steps:
        raise ValueError(f"the renderer would march {s.num_steps} steps, "
                         f"the configuration {m.num_steps}")
    return s


def program(cell, vol, tf, yaws, m: ref.March):
    """The renderer under test: ``f(i)`` renders the frame of ``yaws[i]``
    through ``render`` from a host camera made in set-up."""
    from volumetric_renderer_torch.render.api import render
    from volumetric_renderer_torch.scene.camera import OrbitCamera

    p = cell.params
    settings = settings_of(cell, m)
    cams = [OrbitCamera.from_angles(yaw_deg=float(y),
                                    pitch_deg=p["pitch_deg"],
                                    radius=p["radius"]) for y in yaws]
    return lambda i: render(vol, tf, cams[i], settings, method="auto")


def run(cell) -> dict:
    p, dev = cell.params, cell.device
    m = ref.March.of(cell.config, p["early_termination"])
    vol = inputs.make_volume(cell.config["volume"], cell.seed, dev)
    tf = inputs.tf_table(cell.config["tf_texels"], p["tf_alpha"], dev)
    per_rev = int(round(360.0 / p["yaw_step_deg"]))
    yaws = inputs.orbit_yaws(cell.seed, p["yaw_step_deg"], per_rev)
    render = program(cell, vol, tf, yaws, m)
    done = torch.cuda.Event() if dev.type == "cuda" else None
    count = [0]

    def frame():
        """One frame: ``(index, image, host issue s, latency s)``."""
        i = count[0]
        count[0] += 1
        t0 = time.perf_counter()
        img = render(i % per_rev)
        t1 = time.perf_counter()
        if done is not None:
            done.record()
            done.synchronize()
        return i, img, t1 - t0, time.perf_counter() - t0

    for _ in range(p["warmup_frames"]):
        frame()
    rng = np.random.default_rng(cell.seed)
    drawn = set(int(i) for i in rng.choice(p["check_within"],
                                           p["checked_frames"],
                                           replace=False))
    issue, latency, kept = [], [], {}
    first = count[0]
    window_start = time.perf_counter()
    while True:
        i, img, t_issue, t_frame = frame()
        issue.append(t_issue)
        latency.append(t_frame)
        if i - first in drawn:
            kept[i] = img
        if time.perf_counter() - window_start >= cell.seconds:
            break
    window_s = time.perf_counter() - window_start
    kept[i] = img
    n = len(latency)
    out = {"window_start": window_start,
           "metrics": {"rays_per_s": n * p["height"] * p["width"] / window_s,
                       "frame_p95_ms": 1e3 * float(np.percentile(latency,
                                                                 95))},
           "attempted": n}
    traced_yaws = []
    if cell.trace:
        summaries = []
        with session.traced(dev, summaries):
            for _ in range(p["traced_frames"]):
                with session.unit():
                    i = frame()[0]
                traced_yaws.append(float(yaws[i % per_rev]))
    out["memory_peak_bytes"] = session.memory_peak(dev)
    del img, render
    session.free(dev)

    numbers = [checks.frame_numbers(got, frame_reference(
        cell, vol, tf, float(yaws[i % per_rev]), m)) for i, got in
        sorted(kept.items())]
    out["correct"], out["failed"], out["checks"] = checks.judge(
        numbers, cell.spec["limits"])
    if cell.trace:
        out["trace"] = {"ranks": summaries, "host_issue_ms":
                        [1e3 * t for t in issue],
                        "work": frames_work(cell, vol, tf, traced_yaws, m)}
    return out


def view(cell, yaw: float):
    p = cell.params
    return (yaw, p["pitch_deg"], p["radius"])


def frame_reference(cell, vol, tf, yaw: float, m: ref.March, store=None):
    """The reference's frame at ``yaw``, ``(H * W, 4)``."""
    p = cell.params
    rays = ref.view_rays([view(cell, yaw)], p["height"], p["width"],
                         cell.config["camera"], vol.device)
    return ref.render(vol, tf, rays, vol.min(), vol.max(), m, store)


def frames_work(cell, vol, tf, yaws, m: ref.March) -> dict:
    """K1's bound over the frames at ``yaws``."""
    p = cell.params
    samples = 0
    for yaw in yaws:
        rays = ref.view_rays([view(cell, yaw)], p["height"], p["width"],
                             cell.config["camera"], vol.device)
        samples += work.sampled_steps(vol, tf, rays, vol.min(), vol.max(), m)
    n_rays = len(yaws) * p["height"] * p["width"]
    return {"k1": work.bound("k1", samples, n_rays, vol.numel(), tf.numel(),
                             launches=len(yaws))} if yaws else {}
