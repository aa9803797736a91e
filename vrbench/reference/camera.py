"""Rays of the orbit camera, in float64 NumPy.

The reference renderer's camera (``src/scene/camera.cpp:7-48``) and its
projection (``src/rendering/offscreen_pass.cpp:1152-1171``): a quaternion
orbit around the origin that starts at 180 degrees about +z, a yaw about
world z and a pitch about the camera's right axis; ``perspectiveRH_ZO``
(40 degrees, near 0.1, far 10) times the GL-to-Vulkan conversion
``(x, y, z) -> (-x, -z, y)``.  A pixel's ray runs through its centre: the
pixel unprojected at NDC depths 0.25 and 0.75 through ``inverse(P C V)``,
normalised.  Row 0 is the top of the image.  Texture space is world + 0.5.
"""

from __future__ import annotations

import math

import numpy as np


def _axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    return np.concatenate([[math.cos(angle / 2)], axis * math.sin(angle / 2)])


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _rotation(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def pose(yaw_deg: float, pitch_deg: float, radius: float):
    """``(eye, view)``: the camera position in world space and the 4x4
    view matrix ``[R^T | -R^T eye]``."""
    q = _axis_angle([0.0, 0.0, 1.0], math.pi)
    q = _qmul(_axis_angle([0.0, 0.0, 1.0], -math.radians(yaw_deg)), q)
    right = _rotation(q) @ np.array([1.0, 0.0, 0.0])
    q = _qmul(_axis_angle(right, math.radians(pitch_deg)), q)
    rot = _rotation(q)
    eye = -radius * (rot @ np.array([0.0, -1.0, 0.0]))
    view = np.eye(4)
    view[:3, :3] = rot.T
    view[:3, 3] = -rot.T @ eye
    return eye, view


def projection(aspect: float, fov_y_deg: float, near: float, far: float):
    """``P C``: perspectiveRH_ZO times the coordinate conversion."""
    t = math.tan(math.radians(fov_y_deg) / 2)
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / (aspect * t)
    p[1, 1] = 1.0 / t
    p[2, 2] = far / (near - far)
    p[2, 3] = -(far * near) / (far - near)
    p[3, 2] = -1.0
    conv = np.array([[-1.0, 0, 0, 0], [0, 0, -1.0, 0], [0, 1.0, 0, 0],
                     [0, 0, 0, 1.0]])
    return p @ conv


def rays(yaw_deg: float, pitch_deg: float, radius: float, height: int,
         width: int, fov_y_deg: float = 40.0, near: float = 0.1,
         far: float = 10.0):
    """``(origin (3,), dirs (H, W, 3))`` in float64, the origin in texture
    space, the directions unit length."""
    eye, view = pose(yaw_deg, pitch_deg, radius)
    inv = np.linalg.inv(projection(width / height, fov_y_deg, near, far)
                        @ view)
    ys = 2.0 * (np.arange(height) + 0.5) / height - 1.0
    xs = 2.0 * (np.arange(width) + 0.5) / width - 1.0
    ndc_y, ndc_x = np.meshgrid(ys, xs, indexing="ij")

    def unproject(z):
        w = (ndc_x[..., None] * inv[:, 0] + ndc_y[..., None] * inv[:, 1]
             + z * inv[:, 2] + inv[:, 3])
        return w[..., :3] / w[..., 3:4]

    d = unproject(0.75) - unproject(0.25)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return eye + 0.5, d
