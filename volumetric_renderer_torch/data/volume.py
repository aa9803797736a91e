"""The in-memory volume dataset.

Equivalent of the reference's ``Dataset`` POD (``src/data/dataset.h:9-13``):
``{u32vec3 dimensions; float min, max; vector<float> data}``.  Data is always
widened to float32 on import (``src/data/nrrd_file_parser.cpp:49-77``) and
the global min/max is computed once (``nrrd_file_parser.cpp:38-41``) — it
seeds the renderer's density window (``offscreen_pass.cpp:265-266``).

Array layout is ``data[z, y, x]`` with x fastest, i.e. NRRD axis 0 = x.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Volume:
    """A scalar volume: float32 ``(Z, Y, X)`` grid plus its value range."""

    data: np.ndarray  # (Z, Y, X) float32
    vmin: float
    vmax: float

    @property
    def dimensions(self) -> Tuple[int, int, int]:
        """(x, y, z) sizes, matching the reference's ``u32vec3 dimensions``."""
        z, y, x = self.data.shape
        return (x, y, z)

    @classmethod
    def from_array(cls, arr) -> "Volume":
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim != 3:
            raise ValueError(f"volume must be 3-D, got shape {arr.shape}")
        return cls(data=arr, vmin=float(arr.min()), vmax=float(arr.max()))

    def as_torch(self, device="cuda") -> torch.Tensor:
        """The grid as a contiguous float32 ``(Z, Y, X)`` tensor on ``device``:
        the CUDA card unless the caller asks for another (``"cpu"``), as the
        JAX package's ``as_jax()`` places it on the accelerator.  Raises
        where a CUDA device is asked for and there is none."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Volume.as_torch: no CUDA device for "
                               f"{device}; pass device='cpu' for a CPU "
                               "tensor")
        return torch.from_numpy(np.ascontiguousarray(self.data)).to(device)

    # -- synthetic volumes for tests/benchmarks ----------------------------
    @classmethod
    def synthetic_sphere(cls, n: int = 64, radius: float = 0.4) -> "Volume":
        """Soft sphere density grid (BASELINE config 1)."""
        zs, ys, xs = np.meshgrid(
            *( (np.arange(d, dtype=np.float32) + 0.5) / d - 0.5 for d in (n, n, n) ),
            indexing="ij",
        )
        r = np.sqrt(xs * xs + ys * ys + zs * zs)
        data = np.clip(1.0 - r / radius, 0.0, 1.0).astype(np.float32)
        return cls.from_array(data)

    @classmethod
    def synthetic_shells(cls, n: int = 128) -> "Volume":
        """Concentric density shells — structured content for benchmarks."""
        zs, ys, xs = np.meshgrid(
            *( (np.arange(d, dtype=np.float32) + 0.5) / d - 0.5 for d in (n, n, n) ),
            indexing="ij",
        )
        r = np.sqrt(xs * xs + ys * ys + zs * zs)
        data = (0.5 + 0.5 * np.cos(r * 40.0)) * np.exp(-r * 2.0)
        return cls.from_array(data.astype(np.float32))
