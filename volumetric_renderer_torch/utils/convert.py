"""Carry a scene from the JAX package into this one.

The renderer has no learned weights: its "parameters" are the density grid,
the transfer-function table and the camera pose.  Given those as NumPy
arrays (``np.asarray`` of the JAX package's arrays), this returns the
tensors and camera with which both packages compute the same frame.
"""

from __future__ import annotations

import numpy as np
import torch

from volumetric_renderer_torch.scene.camera import OrbitCamera


def from_reference_arrays(vol, tf_table, center, orientation, radius, *,
                          device="cpu"):
    """``(vol_t, tf_t, OrbitCamera)`` on ``device`` from NumPy arrays: grid
    ``(Z, Y, X)``, TF ``(N, 4)``, camera center ``(3,)``, orientation
    ``(4,)`` as ``[w, x, y, z]`` and radius ``()``, all cast to float32."""

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    vol_t = f32(vol).contiguous()
    tf_t = f32(tf_table).contiguous()
    camera = OrbitCamera(f32(center), f32(orientation), f32(radius))
    return vol_t, tf_t, camera
