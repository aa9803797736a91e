"""Render configuration.

The reference application has *no* config system: every knob is a
compile-time constant scattered through the source (step size / ray distance
in ``res/shaders/volume.frag:29-30``, FoV/near/far in
``src/rendering/offscreen_pass.cpp:1166``, TF resolution 256 in
``src/ui/main_window.cpp:252``, density window + slicing bounds in the UBO,
``src/rendering/offscreen_pass.h:29-37``).  Here they are a single frozen
dataclass that is hashable, copied unchanged from the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render settings (shapes + compile-time constants).

    Anything that changes array shapes or trip counts lives here; anything
    that is a runtime float (density window, slicing bounds, camera) is a
    traced argument instead.

    Attributes:
      height/width: output image size in pixels.
      step_size: world-space march step (reference: 0.005,
        ``volume.frag:30``).
      ray_dist: maximum march distance (reference: 1.8, ``volume.frag:29``).
        ``num_steps == int(ray_dist / step_size)`` exactly as
        ``volume.frag:31``.
      fov_y_degrees / near / far: perspective parameters
        (``offscreen_pass.cpp:1166``: 40 deg, 0.1, 10.0).
      early_termination: stop a ray once transmittance falls below
        ``termination_eps``.  The reference has *no* early termination
        (``volume.frag:33-37`` breaks only on leaving the unit cube); with
        ``early_termination=False`` output matches the reference bit-for-bit,
        with ``True`` it matches to ~termination_eps and runs faster.
      termination_eps: transmittance threshold for early termination.
      tf_resolution: number of transfer-function texels (reference: 256).
      background: RGB clear color composited behind the volume (reference
        offscreen clear 0.11 gray, ``offscreen_pass.cpp:171``).  The raw
        ``render`` output is *not* composited; see ``render.api.composite``.
    """

    height: int = 256
    width: int = 256
    step_size: float = 0.005
    ray_dist: float = 1.8
    fov_y_degrees: float = 40.0
    near: float = 0.1
    far: float = 10.0
    early_termination: bool = True
    termination_eps: float = 1.0 / 255.0
    tf_resolution: int = 256
    background: Tuple[float, float, float] = (0.11, 0.11, 0.11)

    @property
    def num_steps(self) -> int:
        # int(ray_dist / step_size): truncation exactly as volume.frag:31.
        return int(self.ray_dist / self.step_size)

    @property
    def aspect(self) -> float:
        return float(self.width) / float(self.height)

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
