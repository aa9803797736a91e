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


def check_own(own, shape):
    """Validate a depth-chunk ownership range for a grid of ``shape``.

    ``own = (axis, a_start, body, n_total)``: the grid is one chunk of a
    volume of ``n_total`` rows along array axis ``axis`` (0 z, 1 y, 2 x),
    holding rows ``a_start .. a_start + body - 1`` and one halo row (the
    next row of the volume, zeros past its end), so ``shape[axis]`` is
    ``body + 1``.  The chunk owns the samples whose lower trilinear corner
    along ``axis`` lies in ``[a_start, a_start + body)``; the chunk with
    ``a_start == 0`` also owns corner -1, the border before row 0.  Returns
    ``own`` as a tuple of ints, or None for the whole volume."""
    if own is None:
        return None
    axis, a_start, body, n_total = (int(v) for v in own)
    if axis not in (0, 1, 2):
        raise ValueError(f"own axis must be 0, 1 or 2, got {axis}")
    if body < 1 or a_start < 0 or a_start + body > n_total:
        raise ValueError(f"own rows [{a_start}, {a_start + body}) do not lie "
                         f"in a volume of {n_total} rows")
    if shape[axis] != body + 1:
        raise ValueError(f"a chunk of {body} rows holds {body + 1} along "
                         f"axis {axis} (the last is the halo), got shape "
                         f"{tuple(shape)}")
    return axis, a_start, body, n_total


def _texel_corner(shape, pts, own):
    """The lower trilinear corner ``i0`` (int64, whole-volume indices) and
    the lerp weights ``w`` toward the +1 corner, per coordinate x, y, z.
    On a chunk the coordinate along its axis is taken with the whole
    volume's extent, as for the whole volume."""
    zdim, ydim, xdim = shape
    extent = [xdim, ydim, zdim]
    if own is not None:
        extent[2 - own[0]] = own[3]
    dims = torch.tensor(extent, dtype=pts.dtype, device=pts.device)
    # Texel space: coordinate u covers texel centers at (i+0.5)/N.
    f = pts * dims - 0.5
    i0 = torch.floor(f)
    return i0.long(), f - i0


def chunk_owns(shape, pts: torch.Tensor, own) -> torch.Tensor:
    """Whether the chunk ``own`` (see :func:`check_own`) owns the sample at
    ``pts``: a bool tensor of ``pts.shape[:-1]``."""
    axis, a_start, body, _ = own
    c = _texel_corner(shape, pts, own)[0][..., 2 - axis]
    lo = -1 if a_start == 0 else a_start
    return (c >= lo) & (c < a_start + body)


def trilinear_corners(shape, pts: torch.Tensor, own=None) -> list:
    """The 8 corners of a trilinear fetch from a ``(Z, Y, X)`` grid at
    normalized coords ``pts[..., 3] = (x, y, z)``, in the order z, y, x:
    ``(flat, valid, weight)`` with ``flat`` the index into the flattened
    grid (clipped into it), ``valid`` whether the corner lies inside the
    grid and ``weight`` its lerp weight.  The backward of the fused march
    scatters to the same corners.  On a depth chunk (``own``, see
    :func:`check_own`) the weights are the whole volume's and the corners
    are shifted into the chunk."""
    zdim, ydim, xdim = shape
    i0, w = _texel_corner(shape, pts, own)
    if own is not None:
        shift = torch.zeros(3, dtype=i0.dtype, device=i0.device)
        shift[2 - own[0]] = own[1]
        i0 = i0 - shift

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


def trilinear_sample(vol: torch.Tensor, pts: torch.Tensor,
                     own=None) -> torch.Tensor:
    """Sample ``vol[Z, Y, X]`` at normalized coords ``pts[..., 3] = (x, y, z)``.

    Border handling: out-of-range corner texels contribute 0 (transparent
    black border), i.e. the corner's weight is kept but its value is zeroed —
    exactly what CLAMP_TO_BORDER linear filtering computes.  ``vol`` may be
    a depth chunk of a larger volume (``own``, see :func:`check_own`).
    """
    flat_vol = vol.reshape(-1)
    out = torch.zeros(pts.shape[:-1], dtype=vol.dtype, device=vol.device)
    for flat, valid, weight in trilinear_corners(vol.shape, pts, own):
        out = out + torch.where(valid, flat_vol[flat], 0.0) * weight
    return out


def ray_box_intersect(origin: torch.Tensor, dirs: torch.Tensor,
                      box_min: float = 0.0, box_max: float = 1.0):
    """Slab test of rays against the axis-aligned box ``[box_min, box_max]^3``.

    ``origin``: ``(3,)``, or broadcast against ``dirs`` (one per ray);
    ``dirs``: ``(..., 3)`` unit directions.
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
