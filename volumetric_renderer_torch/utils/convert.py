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
                          device="cuda"):
    """``(vol_t, tf_t, OrbitCamera)`` on ``device`` from NumPy arrays: grid
    ``(Z, Y, X)``, TF ``(N, 4)``, camera center ``(3,)``, orientation
    ``(4,)`` as ``[w, x, y, z]`` and radius ``()``, all cast to float32.

    ``device`` is the CUDA card unless the caller asks for another
    (``"cpu"``); where a CUDA device is asked for and there is none this
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"from_reference_arrays: no CUDA device for "
                           f"{device}; pass device='cpu' for CPU tensors")

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    vol_t = f32(vol).contiguous()
    tf_t = f32(tf_table).contiguous()
    camera = OrbitCamera(f32(center), f32(orientation), f32(radius))
    return vol_t, tf_t, camera
