"""Pure-PyTorch reference ray-marcher — the port's correctness oracle.

A faithful restatement of the reference fragment shader
``res/shaders/volume.frag:21-51``:

  * ray per pixel from the camera through the pixel center
    (``volume.frag:23``; the entry point comes from an analytic slab test),
  * fixed-step march, ``steps = int(ray_dist / step_size)``
    (``volume.frag:29-31``),
  * break on leaving ``[0,1]^3`` — strict inequalities, a sample exactly on
    the face still contributes (``volume.frag:33-37``),
  * per-sample slicing window test, strict inequalities
    (``volume.frag:39-40``),
  * density -> normalized ``t = (d - min) / (max - min)``
    (``volume.frag:41-42``),
  * 1D transfer-function fetch (``volume.frag:43``),
  * front-to-back compositing with transmittance carried in alpha:
    ``rgb += T * a_s * rgb_s; T *= 1 - a_s``; final ``alpha = 1 - T``
    (``volume.frag:44-50``),
  * plus optional early-ray termination on transmittance ~ 0, which the
    reference lacks (its only exit is the bounds break).

A plain Python loop over steps: it runs on any device, differentiates by
plain autograd, and is the ground truth the other marchers are held to.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from volumetric_renderer_torch.core.sampling import (
    ray_box_intersect,
    trilinear_sample,
)
from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer_torch.transfer.texture import sample_tf
from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils.device import as_device, constant


def step_offsets(num_steps: int, step_size: float, dtype,
                 device) -> torch.Tensor:
    """``k * step_size`` for every step k, each rounded once in ``dtype``:
    every marcher (and the CUDA kernel) computes ``float(k) * dt`` in the
    ray's precision, so sample positions agree bit for bit."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    ks = np.arange(num_steps, dtype=np_dtype) * np_dtype(step_size)
    return torch.from_numpy(ks).to(device)


def prepare_rays(origin, dirs, density_min, density_max):
    """Per-ray setup shared by every marcher and the CUDA kernel.

    Returns ``(pos0, hit, inv_window)``: the box entry point, the hit mask
    and ``1 / (density_max - density_min)``.  ``origin`` is ``(3,)`` or one
    per ray, broadcast against ``dirs``.  The exact entry point is ON
    the cube face; float rounding can land it epsilon outside (masking the
    first sample via the bounds test) or exactly on a face (masking it via
    the strict slicing test, volume.frag:39-40), so it is clamped strictly
    inside; the golden marcher uses the same epsilon.  A degenerate window
    (constant volume: min == max) would divide by zero, as the reference
    shader would (volume.frag:42); it normalizes to t = 0 everywhere.
    """
    t_entry, _, hit = ray_box_intersect(origin, dirs)
    pos0 = torch.clamp(origin + t_entry[..., None] * dirs, 1e-6, 1.0 - 1e-6)
    width = density_max - density_min
    inv_window = torch.where(
        width > 0.0, 1.0 / torch.clamp(width, min=1e-30),
        torch.zeros_like(width))
    return pos0, hit, inv_window


def frame_inputs(vol, camera, settings, density_min=None, density_max=None,
                 slice_min=None, slice_max=None, ndc=None):
    """``(origin, dirs, dmin, dmax, smin, smax)`` of one frame, on ``vol``'s
    device, with the reference UBO defaults (``offscreen_pass.h:29-37``):
    the density window is the volume's min/max as set on import
    (``offscreen_pass.cpp:265-266``), the slicing window [0,1]^3.  The
    origin is in texture space: the world cube [-0.5,0.5]^3
    (``offscreen_pass.cpp:55-90``) maps to [0,1]^3, tex = world + 0.5.  A
    camera of V views (``scene.camera.ray_grid``) gives ``origin`` (V, 3)
    and ``dirs`` (V, H, W, 3).  ``ndc``, where given, is the pair of NDC
    coordinates (shape S each, on ``vol``'s device) of the frame's pixels
    to make rays for in place of all of them: ``dirs`` is then ``S + (3,)``
    (``(V,) + S + (3,)``), each pixel's direction bit for bit its
    direction in the whole grid (``ray_grid``'s ``ndc``).

    Nothing here makes the host wait for the card: the default slicing
    window is a constant kept on the device, values already there are
    used as they are, and a host camera or host values reach it in one
    asynchronous copy each (``utils.device``).
    """
    dev = vol.device

    def f32(x):
        return as_device(x, dev, torch.float32)

    density_min = vol.min() if density_min is None else density_min
    density_max = vol.max() if density_max is None else density_max
    slice_min = constant((0.0, 0.0, 0.0), dev) if slice_min is None \
        else slice_min
    slice_max = constant((1.0, 1.0, 1.0), dev) if slice_max is None \
        else slice_max
    origin_world, dirs = ray_grid(
        camera.to(dev), settings.height, settings.width,
        settings.fov_y_degrees, settings.near, settings.far, ndc=ndc,
    )
    return (origin_world + 0.5, dirs, f32(density_min), f32(density_max),
            f32(slice_min), f32(slice_max))


def march_rays(
    vol: torch.Tensor,
    tf_table: torch.Tensor,
    origin: torch.Tensor,
    dirs: torch.Tensor,
    *,
    density_min,
    density_max,
    slice_min,
    slice_max,
    num_steps: int,
    step_size: float,
    early_termination: bool = False,
    termination_eps: float = 1.0 / 255.0,
    check=None,
) -> torch.Tensor:
    """March a batch of rays; returns RGBA of shape ``dirs.shape[:-1] + (4,)``.

    ``origin`` is the camera position in *texture* space (world + 0.5);
    ``dirs`` are unit world directions (translation-invariant, so identical
    in texture space).  RGB is the accumulated front-to-back sum; alpha is
    opacity ``1 - T``.  Pixels whose rays miss the cube are ``(0, 0, 0, 0)``
    (no fragment in the reference).  ``check(stage, k, x)``, where given,
    sees every value the march makes, as in ``core.fused.march_prepared``.
    """
    pos0, hit, inv_window = prepare_rays(origin, dirs, density_min,
                                         density_max)
    if check is not None:
        check("entry", -1, pos0)
        check("window", -1, inv_window)
    # dtype follows the rays so the oracle doubles as a float64 ground
    # truth for numerics studies (f64 inputs).
    rgb = torch.zeros(dirs.shape[:-1] + (3,), dtype=dirs.dtype,
                      device=dirs.device)
    trans = torch.ones(dirs.shape[:-1], dtype=dirs.dtype, device=dirs.device)
    offsets = step_offsets(num_steps, step_size, dirs.dtype, dirs.device)
    for k in range(num_steps):
        pos = pos0 + offsets[k] * dirs
        # Bounds break (volume.frag:33-37). The box is convex so positions
        # never re-enter: a pure mask is equivalent to the shader's `break`.
        inside = torch.all((pos >= 0.0) & (pos <= 1.0), dim=-1)
        # Slicing window, strict comparisons (volume.frag:39-40).
        sliced = torch.all((pos < slice_max) & (pos > slice_min), dim=-1)
        active = inside & sliced & hit
        if early_termination:
            active = active & (trans > termination_eps)

        density = trilinear_sample(vol, pos)
        t = (density - density_min) * inv_window
        if check is not None:
            for stage, x in (("pos", pos), ("density", density), ("t", t)):
                check(stage, k, x)
        # The fetch is unconditional, so zero t for masked lanes to keep
        # non-finite voxel values from leaking through `0 * NaN`.
        t = torch.where(active, t, 0.0)
        rgba = sample_tf(tf_table, t)
        a = torch.where(active, rgba[..., 3], 0.0)
        rgb = rgb + (trans * a)[..., None] * rgba[..., :3]
        trans = trans * (1.0 - a)
        if check is not None:
            for stage, x in (("tf", rgba), ("rgb", rgb),
                             ("transmittance", trans)):
                check(stage, k, x)

    alpha = torch.where(hit, 1.0 - trans, 0.0)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def render_oracle(
    vol: torch.Tensor,
    tf_table: torch.Tensor,
    camera: OrbitCamera,
    settings: RenderSettings,
    *,
    density_min: Optional[torch.Tensor] = None,
    density_max: Optional[torch.Tensor] = None,
    slice_min: Optional[torch.Tensor] = None,
    slice_max: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render an ``(H, W, 4)`` image with the pure-PyTorch oracle marcher,
    with the defaults of :func:`frame_inputs`."""
    origin, dirs, dmin, dmax, smin, smax = frame_inputs(
        vol, camera, settings, density_min, density_max, slice_min, slice_max)
    return march_rays(
        vol, tf_table, origin, dirs,
        density_min=dmin, density_max=dmax, slice_min=smin, slice_max=smax,
        num_steps=settings.num_steps,
        step_size=settings.step_size,
        early_termination=settings.early_termination,
        termination_eps=settings.termination_eps,
    )
