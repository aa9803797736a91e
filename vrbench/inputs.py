"""The inputs of a cell, made from its seed on its device.

Both sides get the same tensors: the renderer under test and the plain
reference (``reference/``).  Nothing here imports the renderer.

* :func:`ct_head` is a CT-head-like phantom: an ellipsoidal skull shell
  (0.9), brain (0.35), two ventricle-like pockets (0.12) and seeded
  Gaussian acquisition noise in the whole head, clipped to [0, 1].  The
  shapes are the renderer's ``models.head_phantom``, rewritten here in
  torch so that it is made on the card, in z-slabs, from a
  ``torch.Generator`` there.  That phantom adds its noise to the brain
  alone, which the opaque skull hides from every ray; here the skull is
  noisy too, so that each seed's frames and targets differ.
* :func:`tf_table` is the grayscale ramp at texel centres with alpha
  ``linspace(a0, a1) ** power``.
* :func:`orbit_yaws` and :func:`ring_yaws` are the camera poses in degrees.
"""

from __future__ import annotations

import numpy as np
import torch

#: Half axes of the head ellipsoid (x, y, z) and the shell's inner radius.
HEAD_AXES = (0.42, 0.36, 0.45)
BRAIN_R = 0.88
#: Densities of brain, skull and ventricles.
BRAIN, SKULL, VENTRICLE = 0.35, 0.9, 0.12
#: The ventricles: centre (x, y, z) and radius.
VENTRICLES = ((-0.06, 0.0, 0.05, 0.12 * 0.42), (0.06, 0.0, 0.05, 0.12 * 0.42))
SLAB = 64


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number up
    to 2**63 - 1)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def ct_head(n: int, seed: int, device, noise_std: float = 0.01):
    """The ``(n, n, n)`` float32 phantom ``vol[z, y, x]`` on ``device``."""
    gen = generator(seed, device)
    ax = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n - 0.5
    vol = torch.empty((n, n, n), dtype=torch.float32, device=device)
    y, x = torch.meshgrid(ax, ax, indexing="ij")
    for z0 in range(0, n, SLAB):
        z = ax[z0:z0 + SLAB, None, None]
        r = torch.sqrt((x / HEAD_AXES[0]) ** 2 + (y / HEAD_AXES[1]) ** 2
                       + (z / HEAD_AXES[2]) ** 2)
        v = torch.where(r < BRAIN_R, BRAIN, 0.0)
        v = torch.where((r >= BRAIN_R) & (r < 1.0), SKULL, v)
        for cx, cy, cz, rr in VENTRICLES:
            rv = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
            v = torch.where(rv < rr, VENTRICLE, v)
        noise = torch.randn(v.shape, generator=gen, device=device)
        v = v + noise * noise_std * (r < 1.0)
        vol[z0:z0 + SLAB] = v.clamp(0.0, 1.0)
    return vol


def make_volume(spec: dict, seed: int, device) -> torch.Tensor:
    """The volume a configuration's ``volume`` entry describes."""
    if spec["kind"] != "ct_head_phantom":
        raise ValueError(f"unknown volume kind {spec['kind']!r}")
    return ct_head(int(spec["n"]), seed, device, float(spec["noise_std"]))


def tf_table(texels: int, alpha, device) -> torch.Tensor:
    """``(texels, 4)`` float32: RGB the grayscale ramp at texel centres
    ``(i + 0.5) / texels``, alpha ``linspace(a0, a1, texels) ** power`` for
    ``alpha = [a0, a1, power]``."""
    a0, a1, power = alpha
    ramp = (np.arange(texels, dtype=np.float64) + 0.5) / texels
    table = np.empty((texels, 4), dtype=np.float32)
    table[:, :3] = ramp[:, None]
    table[:, 3] = np.linspace(a0, a1, texels, dtype=np.float32) ** power
    return torch.from_numpy(table).to(device)


def orbit_yaws(seed: int, step_deg: float, count: int) -> np.ndarray:
    """``count`` yaws of an orbit that advances ``step_deg`` a frame from
    a start drawn from the seed, in [0, 360)."""
    start = np.random.default_rng(seed).uniform(0.0, 360.0)
    return np.mod(start + step_deg * np.arange(count), 360.0)


def ring_yaws(views: int) -> np.ndarray:
    """``views`` yaws evenly on the ring, ``linspace(0, 360)`` without its
    end: the posed views of a fit."""
    return np.linspace(0.0, 360.0, views, endpoint=False)
