"""The plain reference march: the shader's loop in plain PyTorch.

``res/shaders/volume.frag:21-51`` of the reference renderer: a ray per
pixel from its entry into the unit cube, a fixed step (``steps =
int(ray_dist / step_size)``, ``:29-31``), samples strictly inside the cube
and the slicing window [0, 1]^3, a trilinear fetch with a transparent
black border, the density window ``t = (d - dmin) / (dmax - dmin)``, a
transfer-function fetch clamped to its edge texels, and front-to-back
compositing ``rgb += T a c``, ``T *= 1 - a``, alpha ``1 - T``.  Early ray
termination, where a configuration asks for it, skips the samples after T
falls to ``termination_eps``.  The entry point is nudged 1e-6 inside the
cube, so that the first sample counts.

The trilinear and TF fetches are ``torch.nn.functional.grid_sample``
(``align_corners=False`` puts texel centres at ``(i + 0.5) / N``; padding
``zeros`` is the border, ``border`` the edge clamp), so plain autograd
gives the gradient of a grid or a TF.  Rays go in blocks, so that a
backward fits on the card.  ``store=torch.bfloat16`` rounds the grid, the
TF and every fetched value to bfloat16: the control of the correctness
check (``checks``).  Nothing here imports the renderer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vrbench.reference import camera

#: The nudge of the entry point into the cube.
ENTRY_EPS = 1e-6
#: Rays in one block of a forward without grad, and of a forward and
#: backward by autograd.
BLOCK, GRAD_BLOCK = 1 << 21, 1 << 19


@dataclass(frozen=True)
class March:
    num_steps: int
    step_size: float
    early_termination: bool
    termination_eps: float

    @classmethod
    def of(cls, config: dict, early_termination: bool) -> "March":
        m = config["march"]
        return cls(int(m["num_steps"]), float(m["ray_dist"]) /
                   int(m["num_steps"]), bool(early_termination),
                   float(m["termination_eps"]))


def entry(origin, dirs):
    """``(pos0, hit)`` of float64 rays ``origin`` (3,) and ``dirs`` (..., 3):
    the box entry nudged inside the cube (float32) and whether the ray
    enters the cube in front of its origin."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (0.0 - origin) / dirs
        t1 = (1.0 - origin) / dirs
    t_in = np.minimum(t0, t1).max(-1)
    t_out = np.maximum(t0, t1).min(-1)
    hit = (t_in <= t_out) & (t_in >= 0.0)
    t_in = np.where(hit, t_in, 0.0)
    pos0 = np.clip(origin + t_in[..., None] * dirs, ENTRY_EPS, 1 - ENTRY_EPS)
    return pos0.astype(np.float32), hit


def view_rays(views, height: int, width: int, cam: dict, device):
    """``(pos0, dirs, hit)`` of every pixel of the views ``[(yaw, pitch,
    radius), ...]`` in view, row, column order, flattened to ``(R, 3)``,
    ``(R, 3)`` and ``(R,)`` on ``device``."""
    parts = []
    for yaw, pitch, radius in views:
        origin, dirs = camera.rays(yaw, pitch, radius, height, width,
                                   cam["fov_y_degrees"], cam["near"],
                                   cam["far"])
        pos0, hit = entry(origin, dirs)
        parts.append((pos0.reshape(-1, 3), dirs.astype(np.float32)
                      .reshape(-1, 3), hit.reshape(-1)))
    return tuple(torch.from_numpy(np.concatenate(p)).to(device)
                 for p in zip(*parts))


def _store(x, store):
    return x if store is None else x.to(store).to(torch.float32)


def march(vol, tf, pos0, dirs, hit, dmin, dmax, m: March, store=None,
          counts=None):
    """RGBA ``(R, 4)`` of rays ``pos0``/``dirs`` ``(R, 3)``, ``hit``
    ``(R,)``; differentiable in ``vol`` and ``tf``.  ``counts``, a tensor,
    gets the number of samples that composite added to it."""
    n_rays = pos0.shape[0]
    dev = pos0.device
    inv_w = 1.0 / (dmax - dmin)
    vol5 = _store(vol, store)[None, None]              # (1, 1, Z, Y, X)
    tf4 = _store(tf, store).t()[None, :, None, :]      # (1, 4, 1, N)
    offsets = np.arange(m.num_steps, dtype=np.float32) * np.float32(
        m.step_size)
    rgb = torch.zeros((n_rays, 3), device=dev)
    tr = torch.ones(n_rays, device=dev)
    zero = torch.zeros(n_rays, device=dev)
    for k in range(m.num_steps):
        pos = pos0 + float(offsets[k]) * dirs
        # strictly inside the cube and the slicing window [0, 1]^3
        active = ((pos > 0.0) & (pos < 1.0)).all(-1) & hit
        if m.early_termination:
            active = active & (tr > m.termination_eps)
        if k % 32 == 0 and not bool(active.any()):
            break      # every ray has left the cube or terminated
        d = F.grid_sample(vol5, (2.0 * pos - 1.0).view(1, n_rays, 1, 1, 3),
                          mode="bilinear", padding_mode="zeros",
                          align_corners=False).view(n_rays)
        t = torch.where(active, (_store(d, store) - dmin) * inv_w, 0.0)
        grid = torch.stack([2.0 * t - 1.0, zero], -1).view(1, 1, n_rays, 2)
        rgba = F.grid_sample(tf4, grid, mode="bilinear",
                             padding_mode="border",
                             align_corners=False).view(4, n_rays).t()
        rgba = _store(rgba, store)
        a = torch.where(active, rgba[:, 3], 0.0)
        rgb = rgb + (tr * a)[:, None] * rgba[:, :3]
        tr = tr * (1.0 - a)
        if counts is not None:
            counts += active.sum()
    alpha = torch.where(hit, 1.0 - tr, 0.0)
    return torch.cat([rgb, alpha[:, None]], -1)


def render(vol, tf, rays, dmin, dmax, m: March, store=None, counts=None):
    """RGBA ``(R, 4)`` of the rays ``(pos0, dirs, hit)``, in blocks, with
    no graph."""
    with torch.no_grad():
        return torch.cat([
            march(vol, tf, *(x[i:i + BLOCK] for x in rays), dmin, dmax, m,
                  store, counts)
            for i in range(0, rays[0].shape[0], BLOCK)])


def loss_and_grad(vol, tf, rays, targets, dmin, dmax, m: March, norm: float,
                  store=None):
    """``(loss, grad)``: ``sum((rgba - targets) ** 2) / norm`` over the rays
    and its gradient in ``vol``, by autograd in blocks of rays; the loss
    in float64."""
    v = vol.detach().clone().requires_grad_(True)
    total = torch.zeros((), dtype=torch.float64, device=vol.device)
    for i in range(0, rays[0].shape[0], GRAD_BLOCK):
        img = march(v, tf, *(x[i:i + GRAD_BLOCK] for x in rays), dmin, dmax,
                    m, store)
        loss = ((img - targets[i:i + GRAD_BLOCK]) ** 2).sum() / norm
        loss.backward()
        total += loss.detach().double()
    return total, v.grad
