"""Synthetic volume models and scene presets.

The reference ships no sample data — datasets arrive through the import
dialog (``src/data/importer.cpp:20-50``).  For benchmarks, tests, and the
BASELINE configs this module provides procedural stand-ins (all return
:class:`~volumetric_renderer_torch.data.volume.Volume`):

* :func:`sphere` — soft-edged ball (BASELINE config 1).
* :func:`shells` — concentric density shells (TF stress test).
* :func:`head_phantom` — a CT-head-like phantom: skull shell + brain +
  ventricle-ish cavities (stands in for the "128^3 NRRD CT head" of
  BASELINE config 2 when no real scan is on disk).
"""

from __future__ import annotations

import numpy as np

from volumetric_renderer_torch.data.volume import Volume


def sphere(n: int = 64, radius: float = 0.4) -> Volume:
    return Volume.synthetic_sphere(n, radius)


def shells(n: int = 128) -> Volume:
    return Volume.synthetic_shells(n)


def head_phantom(n: int = 128, seed: int = 0) -> Volume:
    """CT-head-like phantom: outer skull shell (high density), soft brain
    interior (mid), low-density cavities, plus mild acquisition noise."""
    rng = np.random.default_rng(seed)
    ax = (np.arange(n) + 0.5) / n - 0.5
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    # slightly ellipsoidal head
    r = np.sqrt((x / 0.42) ** 2 + (y / 0.36) ** 2 + (z / 0.45) ** 2)
    vol = np.zeros((n, n, n), np.float32)
    brain = r < 0.88
    vol[brain] = 0.35
    skull = (r >= 0.88) & (r < 1.0)
    vol[skull] = 0.9
    # ventricle-like low-density pockets
    for cx, cy, cz, rr in ((-0.06, 0.0, 0.05, 0.12), (0.06, 0.0, 0.05, 0.12)):
        rv = np.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
        vol[rv < rr * 0.42] = 0.12
    vol += rng.normal(0.0, 0.01, vol.shape).astype(np.float32) * brain
    vol = np.clip(vol, 0.0, 1.0).astype(np.float32)
    return Volume.from_array(vol)


__all__ = ["sphere", "shells", "head_phantom"]
