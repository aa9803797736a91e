"""Public low-level op set.

The numerical primitives the renderer is built from, re-exported as a
stable surface (the GPU-side equivalents live in the reference's shader
and sampler state):

* :func:`trilinear_sample` — ``sampler3D`` linear filtering with
  CLAMP_TO_BORDER transparent black
  (``src/rendering/offscreen_pass.cpp:1014-1039``).
* :func:`ray_box_intersect` — analytic slab test replacing the
  rasterized-cube ray entry (``res/shaders/volume.vert:19-24``).
* :func:`sample_tf` — 1D TF fetch, linear + CLAMP_TO_EDGE
  (``offscreen_pass.cpp:1125-1150``).
* :func:`composite_step` — one front-to-back blend step
  (``res/shaders/volume.frag:44-48``).
"""

from volumetric_renderer_torch.core.sampling import (  # noqa: F401
    ray_box_intersect,
    trilinear_sample,
)
from volumetric_renderer_torch.transfer.texture import sample_tf  # noqa: F401


def composite_step(rgb, transmittance, sample_rgb, sample_alpha):
    """One front-to-back compositing step (``volume.frag:44-48``).

    ``rgb += T * a_s * rgb_s;  T *= (1 - a_s)``.  Returns the updated
    ``(rgb, transmittance)``.
    """
    ta = transmittance * sample_alpha
    return rgb + ta[..., None] * sample_rgb, transmittance * (1.0 - sample_alpha)


__all__ = [
    "trilinear_sample",
    "ray_box_intersect",
    "sample_tf",
    "composite_step",
]
