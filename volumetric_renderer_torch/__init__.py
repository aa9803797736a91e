"""volumetric_renderer_torch — the volume renderer on PyTorch and CUDA.

A port of the JAX package ``volumetric_renderer_tpu`` (which stays beside it
as the reference) to PyTorch, with the hot loop as a CUDA kernel written for
NVIDIA Hopper.  Module paths and public names mirror the JAX package:

  * ``scene``, ``core``, ``transfer``, ``ops``: cameras, rays, sampling and
    the plain PyTorch marchers (``core.marcher`` is the oracle),
  * ``kernels``: the CUDA forward ray march (``csrc/march_fwd.cu``) and its
    plain version, built with nvcc on first use,
  * ``data``, ``models``: NRRD / CSV import and procedural volumes (NumPy),
  * ``render``: the one-frame API, ``apps.render_cli``: the offline CLI.

This package never imports JAX.
"""

__version__ = "0.1.0"

from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.data.volume import Volume
from volumetric_renderer_torch.render.api import render

__all__ = [
    "RenderSettings",
    "OrbitCamera",
    "Gradient",
    "Volume",
    "render",
]
