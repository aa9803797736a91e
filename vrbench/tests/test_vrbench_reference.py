"""The yardstick against the renderer's plain versions, on the CPU at tiny
sizes: the reference camera and march, their autograd gradients, the
frozen work count and Adam written out.

    python -m pytest vrbench/tests -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from vrbench import inputs, work
from vrbench.reference import adam as ref_adam
from vrbench.reference import camera
from vrbench.reference import march as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N, H, W, STEPS = 16, 12, 20, 32
CAM = {"fov_y_degrees": 40.0, "near": 0.1, "far": 10.0}


def _port_rays(yaw, pitch=20.0, radius=3.0, h=H, w=W):
    from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
    cam = OrbitCamera.from_angles(yaw_deg=yaw, pitch_deg=pitch,
                                  radius=radius)
    return ray_grid(cam, h, w)


@pytest.mark.parametrize("yaw,pitch", [(0.0, 20.0), (37.0, 20.0),
                                       (211.5, -35.0)])
def test_reference_camera_matches_the_renderers(yaw, pitch):
    origin, dirs = _port_rays(yaw, pitch)
    r_origin, r_dirs = camera.rays(yaw, pitch, 3.0, H, W)
    assert np.abs(origin.numpy() + 0.5 - r_origin).max() < 1e-5
    assert np.abs(dirs.numpy() - r_dirs).max() < 1e-5


def _prepared(vol, yaw):
    from volumetric_renderer_torch.core.marcher import prepare_rays
    origin, dirs = _port_rays(yaw)
    pos0, hit, inv = prepare_rays(origin + 0.5, dirs, vol.min(), vol.max())
    return pos0, dirs, hit, inv


@pytest.mark.parametrize("early_termination", [False, True])
def test_reference_march_matches_the_plain_kernel(early_termination):
    from volumetric_renderer_torch.core.fused import march_prepared
    vol = inputs.ct_head(N, 3, "cpu")
    tf = inputs.tf_table(256, [0.0, 1.0, 2], "cpu")
    pos0, dirs, hit, inv = _prepared(vol, 37.0)
    m = ref.March(STEPS, 1.8 / STEPS, early_termination, 1 / 255)
    port = march_prepared(vol, tf, pos0, dirs, hit, vol.min(), inv,
                          torch.zeros(3), torch.ones(3), num_steps=STEPS,
                          step_size=m.step_size,
                          early_termination=early_termination,
                          termination_eps=m.termination_eps)
    mine = ref.render(vol, tf, (pos0.reshape(-1, 3), dirs.reshape(-1, 3),
                                hit.reshape(-1)), vol.min(), vol.max(), m)
    assert float(port.reshape(-1, 4)[:, 3].max()) > 0.5
    torch.testing.assert_close(mine, port.reshape(-1, 4), atol=1e-6,
                               rtol=0)


def test_reference_gradient_matches_the_plain_backward():
    from volumetric_renderer_torch.core.fused import make_fused_marcher
    gt = inputs.ct_head(N, 4, "cpu")
    tf = inputs.tf_table(256, [0.0, 0.8, 1], "cpu")
    grid = torch.full_like(gt, 0.3)
    origin, dirs = _port_rays(80.0)
    m = ref.March(STEPS, 1.8 / STEPS, False, 1 / 255)
    dmin, dmax = gt.min(), gt.max()
    rays = ref.entry(origin.double().numpy() + 0.5, dirs.double().numpy())
    rays = (torch.from_numpy(rays[0]).reshape(-1, 3), dirs.reshape(-1, 3),
            torch.from_numpy(rays[1]).reshape(-1))
    targets = ref.render(gt, tf, rays, dmin, dmax, m)
    loss, grad = ref.loss_and_grad(grid, tf, rays, targets, dmin, dmax, m,
                                   norm=float(H * W * 4))
    march = make_fused_marcher(STEPS, m.step_size, False, 1 / 255)
    v = grid.clone().requires_grad_(True)
    img = march(v, tf, origin + 0.5, dirs, dmin, dmax, torch.zeros(3),
                torch.ones(3))
    port_loss = ((img.reshape(-1, 4) - targets) ** 2).sum() / (H * W * 4)
    port_loss.backward()
    assert float(v.grad.abs().max()) > 0
    torch.testing.assert_close(float(loss), float(port_loss.detach()),
                               rtol=1e-5, atol=0)
    scale = float(v.grad.abs().max())
    torch.testing.assert_close(grad, v.grad, atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("early_termination", [False, True])
def test_work_count_matches_chip_smoke(early_termination):
    sys.path.insert(0, ROOT)
    import chip_smoke
    vol = inputs.ct_head(N, 5, "cpu")
    tf = inputs.tf_table(256, [0.0, 1.0, 2], "cpu")
    pos0, dirs, hit, inv = _prepared(vol, 150.0)
    m = ref.March(STEPS, 1.8 / STEPS, early_termination, 1 / 255)
    theirs = chip_smoke.sampled_steps(
        (vol, tf, pos0, dirs, hit, vol.min(), inv, torch.zeros(3),
         torch.ones(3)),
        dict(num_steps=STEPS, step_size=m.step_size,
             early_termination=early_termination,
             termination_eps=m.termination_eps))
    mine = work.sampled_steps(vol, tf, (pos0.reshape(-1, 3),
                                        dirs.reshape(-1, 3),
                                        hit.reshape(-1)),
                              vol.min(), vol.max(), m)
    assert theirs > 100
    assert mine == theirs


def test_bound_counts_the_work_and_the_bytes():
    b = work.bound("k1", 10 ** 9, 2_073_600, 256 ** 3, 1024)
    assert b["ops"] == 98 * 10 ** 9 and b["by"] == "operations"
    assert b["ms"] == pytest.approx(1e3 * 98e9 / 67e12)
    tiny = work.bound("k2", 0, 10, 8, 4, launches=3)
    assert tiny["by"] == "bytes"
    assert tiny["bytes"] == 3 * (4 * 12 + 32 + 4 * 8 + 8 * 4 + 16) + 10 * 57


def test_adam_written_out_matches_torch():
    gen = torch.Generator().manual_seed(0)
    p0 = torch.rand(1000, generator=gen)
    grads = [torch.randn(1000, generator=gen) * 10 ** -k for k in (0, 3, 6)]
    theirs = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([theirs], lr=5e-2)
    mine = p0.clone()
    adam = ref_adam.Adam(5e-2)
    for g in grads:
        theirs.grad = g.clone()
        opt.step()
        adam.step(mine, g)
    torch.testing.assert_close(mine, theirs.detach(), rtol=1e-5, atol=1e-7)


def test_phantom_is_the_seeds_and_shaped_like_a_head():
    a = inputs.ct_head(32, 7, "cpu")
    assert torch.equal(a, inputs.ct_head(32, 7, "cpu"))
    assert not torch.equal(a, inputs.ct_head(32, 8, "cpu"))
    assert float(a.max()) > 0.89 and float(a.min()) == 0.0
    centre = a[16, 16, 4:28]
    assert float(centre.median()) == pytest.approx(0.35, abs=0.05)
