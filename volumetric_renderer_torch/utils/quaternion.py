"""Quaternion helpers (w, x, y, z convention, matching glm).

The reference uses ``glm::quat`` for its orbit camera
(``src/scene/camera.cpp``).  These are plain torch functions over shape-(4,)
float32 tensors ``[w, x, y, z]``; results stay on the input's device.
:func:`rotate_vector` and :func:`to_rotation_matrix` also take quaternions
with leading axes ``(..., 4)`` (a batch of camera poses).
"""

from __future__ import annotations

import torch

from volumetric_renderer_torch.utils.device import constant


def from_axis_angle(axis, angle_rad):
    """glm::angleAxis(angle, axis) — axis must be unit length."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    half = torch.as_tensor(angle_rad, dtype=torch.float32,
                           device=axis.device) / 2.0
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[None], axis * s])


def multiply(q1, q2):
    """Hamilton product q1 * q2 (applies q2's rotation first, like glm)."""
    w1, x1, y1, z1 = q1[0], q1[1], q1[2], q1[3]
    w2, x2, y2, z2 = q2[0], q2[1], q2[2], q2[3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def rotate_vector(q, v):
    """q * v * q^-1 — rotate vector v by unit quaternion q.  A ``v`` given
    as a list or tuple is a constant made once per device."""
    w = q[..., 0, None]
    u = q[..., 1:]
    if isinstance(v, (list, tuple)):
        v = constant(tuple(float(x) for x in v), q.device)
    else:
        v = torch.as_tensor(v, dtype=torch.float32, device=q.device)
    # Rodrigues form: v' = v + 2w (u x v) + 2 u x (u x v)
    uv = torch.linalg.cross(u, v.expand_as(u))
    uuv = torch.linalg.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def to_rotation_matrix(q):
    """3x3 rotation matrix equivalent to glm::mat3_cast(q)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ], dim=-2
    ).to(torch.float32)


def normalize(q):
    return q / torch.linalg.norm(q)
