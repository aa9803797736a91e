"""Volume sampling: trilinear interpolation with GPU sampler semantics.

Replicates the reference's ``sampler3D`` configuration
(``src/rendering/offscreen_pass.cpp:1014-1039``): VK_FILTER_LINEAR with
VK_SAMPLER_ADDRESS_MODE_CLAMP_TO_BORDER and a transparent-black border — a
fetch whose 2x2x2 neighborhood reaches outside the volume blends toward
density 0 instead of clamping to the edge texel.

Volume layout: ``vol[z, y, x]`` (x fastest), matching NRRD axis order where
axis 0 is fastest (``src/data/nrrd_file_parser.cpp:32-33``).  A normalized
texture coordinate ``u = (ux, uy, uz)`` addresses texel centers at
``(i + 0.5) / N`` per axis.
"""

from __future__ import annotations

import torch


def trilinear_corners(shape, pts: torch.Tensor) -> list:
    """The 8 corners of a trilinear fetch from a ``(Z, Y, X)`` grid at
    normalized coords ``pts[..., 3] = (x, y, z)``, in the order z, y, x:
    ``(flat, valid, weight)`` with ``flat`` the index into the flattened
    grid (clipped into it), ``valid`` whether the corner lies inside the
    grid and ``weight`` its lerp weight.  The backward of the fused march
    scatters to the same corners."""
    zdim, ydim, xdim = shape
    dims = torch.tensor([xdim, ydim, zdim], dtype=pts.dtype,
                        device=pts.device)
    # Texel space: coordinate u covers texel centers at (i+0.5)/N.
    f = pts * dims - 0.5
    i0 = torch.floor(f)
    w = f - i0  # per-axis lerp weight toward the +1 corner
    i0 = i0.long()

    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    corners = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = x0 + dx, y0 + dy, z0 + dz
                valid = (
                    (ix >= 0) & (ix < xdim)
                    & (iy >= 0) & (iy < ydim)
                    & (iz >= 0) & (iz < zdim)
                )
                flat = ((torch.clamp(iz, 0, zdim - 1) * ydim
                         + torch.clamp(iy, 0, ydim - 1)) * xdim
                        + torch.clamp(ix, 0, xdim - 1))
                weight = (
                    (wx if dx else 1.0 - wx)
                    * (wy if dy else 1.0 - wy)
                    * (wz if dz else 1.0 - wz)
                )
                corners.append((flat, valid, weight))
    return corners


def trilinear_sample(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample ``vol[Z, Y, X]`` at normalized coords ``pts[..., 3] = (x, y, z)``.

    Border handling: out-of-range corner texels contribute 0 (transparent
    black border), i.e. the corner's weight is kept but its value is zeroed —
    exactly what CLAMP_TO_BORDER linear filtering computes.
    """
    flat_vol = vol.reshape(-1)
    out = torch.zeros(pts.shape[:-1], dtype=vol.dtype, device=vol.device)
    for flat, valid, weight in trilinear_corners(vol.shape, pts):
        out = out + torch.where(valid, flat_vol[flat], 0.0) * weight
    return out


def ray_box_intersect(origin: torch.Tensor, dirs: torch.Tensor,
                      box_min: float = 0.0, box_max: float = 1.0):
    """Slab test of rays against the axis-aligned box ``[box_min, box_max]^3``.

    ``origin``: ``(3,)``; ``dirs``: ``(..., 3)`` unit directions.
    Returns ``(t_entry, t_exit, hit)``.

    ``hit`` additionally requires ``t_entry >= 0``: the reference draws the
    cube with back-face culling (``offscreen_pass.cpp:680``), so a camera
    *inside* the cube rasterizes nothing — such rays are misses here too.

    ``torch.minimum``/``maximum`` (not ``fmin``/``fmax``) keep NaN: an
    axis-parallel ray whose origin lies on a slab plane gives ``0 * inf =
    NaN``, and the NaN must make the ray a miss, as in the JAX package.
    """
    inv = 1.0 / dirs  # inf on zero components is fine under min/max
    t0 = (box_min - origin) * inv
    t1 = (box_max - origin) * inv
    t_near = torch.minimum(t0, t1)
    t_far = torch.maximum(t0, t1)
    t_entry = torch.amax(t_near, dim=-1)
    t_exit = torch.amin(t_far, dim=-1)
    hit = (t_entry <= t_exit) & (t_entry >= 0.0)
    # Miss rays can carry t = +/-inf (axis-parallel dirs); downstream
    # ``origin + t_entry * dirs`` would produce inf*0 = NaN entry points.
    # Misses park at t = 0 (pos = origin, outside the cube).
    t_entry = torch.where(hit, t_entry, 0.0)
    t_exit = torch.where(hit, t_exit, 0.0)
    return t_entry, t_exit, hit
