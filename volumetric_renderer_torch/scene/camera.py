"""Orbit camera + per-pixel ray generation.

Mirrors the reference's quaternion orbit camera
(``src/scene/camera.cpp:7-48``) and its projection setup
(``src/rendering/offscreen_pass.cpp:1152-1171``): 40 deg vertical FoV
perspective (``glm::perspectiveRH`` with ``GLM_FORCE_DEPTH_ZERO_TO_ONE``,
near 0.1 / far 10) composed with the GL->Vulkan coordinate conversion
``rotX(90deg) * scale(-1,1,1)``.

Rays are generated analytically by unprojecting pixel centers through
``inverse(proj * view)``; the directions are identical to the rasterized
ones of ``res/shaders/volume.frag:23`` because both are straight lines
through the camera center and the pixel.

Conventions: image row 0 is the top of the screen (Vulkan NDC y=-1 with the
default positive-height viewport), column 0 is the left.  World space is the
app's z-up space containing the volume cube ``[-0.5, 0.5]^3``; texture space
is ``world + 0.5``.

All camera maths is float32 at full precision: a TF32 matmul (about three
decimal digits) would move ray directions far past the renderer's 1e-5 bar.
So no product here is a matmul: each is written out as broadcast products
and sums, which no device runs in TF32, and no global flag is touched.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from volumetric_renderer_torch.utils import quaternion as quat


class OrbitCamera:
    """Quaternion orbit camera around ``center`` (``src/scene/camera.cpp``).

    Three float32 tensors: ``center`` (3,), ``orientation`` (4,) as
    ``[w, x, y, z]`` and ``radius`` (scalar).  Functional: ``rotate`` and
    ``zoom`` return new cameras.
    """

    #: drag sensitivity in degrees per pixel (``camera.cpp:18``)
    SENSITIVITY = 0.25
    #: zoom radius clamp (``camera.cpp:33``)
    MIN_RADIUS, MAX_RADIUS = 0.1, 10.0

    def __init__(self, center, orientation, radius):
        self.center = torch.as_tensor(center, dtype=torch.float32)
        self.orientation = torch.as_tensor(
            orientation, dtype=torch.float32, device=self.center.device)
        self.radius = torch.as_tensor(
            radius, dtype=torch.float32, device=self.center.device)

    @classmethod
    def create(cls) -> "OrbitCamera":
        """Initial pose: 180 deg about +z, radius 3 (``camera.cpp:7-13``)."""
        return cls(
            center=torch.zeros(3, dtype=torch.float32),
            orientation=quat.from_axis_angle([0.0, 0.0, 1.0], math.pi),
            radius=3.0,
        )

    def to(self, device) -> "OrbitCamera":
        return OrbitCamera(self.center.to(device), self.orientation.to(device),
                           self.radius.to(device))

    # -- interaction (``camera.cpp:15-34``) --------------------------------
    def rotate(self, delta_xy) -> "OrbitCamera":
        """Drag rotation: yaw about world z by ``-dx*0.25`` degrees, then
        pitch about the camera's right axis by ``dy*0.25`` degrees."""
        dev = self.orientation.device
        delta_xy = torch.as_tensor(delta_xy, dtype=torch.float32, device=dev)
        ang = delta_xy * self.SENSITIVITY
        z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
        yaw = quat.from_axis_angle(z_axis, -torch.deg2rad(ang[0]))
        o = quat.multiply(yaw, self.orientation)
        right = quat.rotate_vector(o, [1.0, 0.0, 0.0])
        pitch = quat.from_axis_angle(right, torch.deg2rad(ang[1]))
        o = quat.multiply(pitch, o)
        return OrbitCamera(self.center, o, self.radius)

    def zoom(self, delta) -> "OrbitCamera":
        r = torch.clamp(self.radius - delta, self.MIN_RADIUS, self.MAX_RADIUS)
        return OrbitCamera(self.center, self.orientation, r)

    @classmethod
    def from_angles(cls, yaw_deg=0.0, pitch_deg=0.0, radius=3.0) -> "OrbitCamera":
        """Convenience pose: start from the default camera and apply a drag
        equivalent to (yaw, pitch) degrees."""
        cam = cls.create()
        cam = OrbitCamera(cam.center, cam.orientation, radius)
        return cam.rotate(
            torch.tensor([yaw_deg, pitch_deg], dtype=torch.float32)
            / cls.SENSITIVITY
        )

    # -- matrices (``camera.cpp:36-48``, ``offscreen_pass.cpp:1152-1171``) -
    def position(self):
        """``center - radius * (q * (0,-1,0))`` (``camera.cpp:36-40``)."""
        forward = quat.rotate_vector(self.orientation, [0.0, -1.0, 0.0])
        return self.center - self.radius * forward

    def view_matrix(self):
        """``transpose(mat4_cast(q)) * translate(-position)``."""
        r = quat.to_rotation_matrix(self.orientation).T
        pos = self.position()
        m = torch.eye(4, dtype=torch.float32, device=r.device)
        m[:3, :3] = r
        m[:3, 3] = -(r * pos).sum(-1)
        return m


def perspective_rh_zo(fov_y_rad, aspect, near, far, device=None):
    """glm::perspectiveRH_ZO (GLM_FORCE_DEPTH_ZERO_TO_ONE is defined by the
    reference, ``offscreen_pass.cpp:3``)."""
    t = torch.tan(torch.as_tensor(fov_y_rad, dtype=torch.float32,
                                  device=device) / 2.0)
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = far / (near - far)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def coordinate_conversion(device=None):
    """GL->Vulkan world conversion ``rotX(90deg) * scale(-1,1,1)``
    (``offscreen_pass.cpp:1158-1162``): maps (x,y,z) -> (-x, -z, y)."""
    return torch.tensor(
        [
            [-1.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, -1.0, 0.0],
            [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=torch.float32, device=device,
    )


def projection_matrix(camera: OrbitCamera, aspect, fov_y_degrees=40.0,
                      near=0.1, far=10.0):
    """Full clip-from-world matrix ``P * C * V`` as the reference composes it
    (``ubo.proj = perspectiveRH(...) * coordinate_conversion`` then the
    shader does ``proj * view * pos``, ``volume.vert:23``)."""
    dev = camera.orientation.device
    fov = torch.deg2rad(torch.tensor(fov_y_degrees, dtype=torch.float32,
                                     device=dev))
    p = perspective_rh_zo(fov, aspect, near, far, device=dev)
    return _mm(_mm(p, coordinate_conversion(dev)), camera.view_matrix())


def _mm(a, b):
    """``a @ b`` for small matrices, as broadcast products and sums."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def ray_grid(camera: OrbitCamera, height: int, width: int,
             fov_y_degrees: float = 40.0, near: float = 0.1,
             far: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world-space rays through pixel centers, on the camera's
    device.

    Returns ``(origin[3], dirs[H, W, 3])`` with unit-norm directions,
    identical to the shader's ``normalize(frag_pos - camera_pos)``
    (``volume.frag:23``) for every point of the rasterized cube.
    """
    dev = camera.orientation.device
    aspect = float(width) / float(height)
    m = projection_matrix(camera, aspect, fov_y_degrees, near, far)
    m_inv = torch.linalg.inv(m)

    ys = (2.0 * (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)
          / height) - 1.0
    xs = (2.0 * (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
          / width) - 1.0
    ndc_y, ndc_x = torch.meshgrid(ys, xs, indexing="ij")

    def unproject(z):
        # (ndc_x, ndc_y, z, 1) @ m_inv.T over m_inv's four columns
        w = (ndc_x[..., None] * m_inv[:, 0] + ndc_y[..., None] * m_inv[:, 1]
             + (z * m_inv[:, 2] + m_inv[:, 3]))
        return w[..., :3] / w[..., 3:4]

    p_near = unproject(0.25)
    p_far = unproject(0.75)
    d = p_far - p_near
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return camera.position(), d
