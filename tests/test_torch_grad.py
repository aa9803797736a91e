"""The port's backward against the JAX package: the plain re-march backward
(``core.fused.march_backward_prepared``, the plain version of the K2 kernel)
against ``jax.vjp`` of the JAX ``make_fused_marcher`` and against the JAX
Pallas backward kernel in interpret mode; ``render`` gradients against plain
autograd through the oracle; ``render_loss_and_grads`` against the JAX
package's.

Tolerances:
* atol 1e-4 / rtol 1e-5 where both packages march the same rays with the
  same cotangent (the bar the JAX package holds its backward kernel to,
  ``tests/test_slab.py``); the gradients are sums over rays and steps taken
  in another order in each package;
* atol 1e-4 for the oracle comparison (the oracle has no ``ALPHA_EPS``
  clamp, ``tests/test_slab.py:313-353``);
* 5e-4 relative to the largest gradient for the whole API, where each
  package makes its own rays: ray directions differ by up to ~4e-6
  (``tests/test_torch_render.py``), which moves a few voxel gradients by
  ~1.5e-4 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetric_renderer_tpu.core.fused import make_fused_marcher as jfused
from volumetric_renderer_tpu.render import api as japi
from volumetric_renderer_tpu.scene.camera import OrbitCamera as JCamera
from volumetric_renderer_tpu.scene.camera import ray_grid as jray_grid
from volumetric_renderer_tpu.utils.config import RenderSettings as JSettings
from volumetric_renderer_torch import models
from volumetric_renderer_torch.core.fused import make_fused_marcher
from volumetric_renderer_torch.render import api as tapi
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils.convert import from_reference_arrays

N, NTF, STEPS, H, W = 16, 16, 24, 16, 16
GRAD_CASES = ["orient_30_20", "orient_120_-35", "orient_200_5",
              "orient_0_80", "early_termination", "slicing",
              "clamped_alpha", "constant_volume", "nan_voxel_outside_slicing"]


def ramp_tf(n=NTF, amax=1.0):
    tf = Gradient.grayscale_ramp().discretize(n)
    tf[:, 3] = np.linspace(0.0, amax, n, dtype=np.float32) ** 2
    return tf


def grad_case(name):
    """(vol, tf, origin, dirs, window, slicing, march kwargs) as NumPy, with
    the JAX package's rays, for one case."""
    rng = np.random.default_rng(5)
    vol, tf = models.sphere(N).data, ramp_tf()
    camera, window = (30.0, 20.0), (0.0, 1.0)
    slicing, et = ((0, 0, 0), (1, 1, 1)), False
    if name.startswith("orient"):
        camera = tuple(float(v) for v in name.split("_")[1:])
    elif name == "early_termination":
        et = True
    elif name == "slicing":
        slicing = ((0.1, 0.2, 0.0), (0.9, 1.0, 0.7))
    elif name == "clamped_alpha":
        # alpha reaches 1 from t = 0.5 on: the ALPHA_EPS clamp engages
        tf[:, 3] = np.minimum(1.0, np.linspace(0.0, 2.0, NTF)).astype(
            np.float32)
    elif name == "constant_volume":
        vol = np.full((N, N, N), 0.25, np.float32)
        tf = rng.uniform(size=(NTF, 4)).astype(np.float32)
        window = (0.25, 0.25)                 # inv_w = 0
    elif name == "nan_voxel_outside_slicing":
        vol = vol.copy()
        vol[1, 2, 3] = np.nan
        slicing = ((0.2, 0.2, 0.2), (0.8, 0.8, 0.8))
        et = True
    origin, dirs = jray_grid(JCamera.from_angles(*camera), H, W)
    kw = dict(num_steps=STEPS, step_size=1.8 / STEPS, early_termination=et,
              termination_eps=1.0 / 255.0)
    return (vol, tf, np.asarray(origin) + 0.5, np.asarray(dirs), window,
            slicing, kw)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def port_grads(marcher, vol, tf, origin, dirs, window, slicing, g):
    """(vol_g, tf_g, dmin_g, dmax_g) of ``sum(marcher(...) * g)``."""
    args = [t(vol), t(tf), t(origin), t(dirs), t(window[0]), t(window[1]),
            t(slicing[0]), t(slicing[1])]
    for i in (0, 1, 4, 5):
        args[i].requires_grad_(True)
    img = marcher(*args)
    img.backward(t(g))
    return img.detach().numpy(), [args[i].grad.numpy() for i in (0, 1, 4, 5)]


def assert_grads_close(got, want, atol=1e-4, rtol=1e-5):
    for name, a, b in zip(("vol", "tf", "dmin", "dmax"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_fused_backward_matches_jax_vjp(name):
    vol, tf, origin, dirs, window, slicing, kw = grad_case(name)
    g = np.random.default_rng(3).normal(size=(H, W, 4)).astype(np.float32)
    jargs = (jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(origin),
             jnp.asarray(dirs), jnp.float32(window[0]),
             jnp.float32(window[1]), jnp.asarray(slicing[0], jnp.float32),
             jnp.asarray(slicing[1], jnp.float32))
    out, vjp = jax.vjp(jfused(**kw), *jargs)
    jg = vjp(jnp.asarray(g))
    img, got = port_grads(make_fused_marcher(**kw), vol, tf, origin, dirs,
                          window, slicing, g)
    np.testing.assert_allclose(img, np.asarray(out), atol=1e-5)
    assert_grads_close(got, [jg[i] for i in (0, 1, 4, 5)])
    assert np.abs(got[1]).max() > 0
    if name != "constant_volume":
        assert (got[0] != 0).sum() > 50


def test_axis_parallel_miss_ray_grads_finite():
    """The miss ray of ``tests/test_fused.py:134``: t_entry = +/-inf in the
    slab test must not poison the gradients."""
    vol = models.sphere(8).data
    tf = np.linspace(0, 1, 32 * 4, dtype=np.float32).reshape(32, 4)
    origin = np.array([0.5, -2.32, 1.53], np.float32)
    dirs = np.array([[[0.0, 0.0, 1.0]]], np.float32)
    window, slicing = (0.0, 1.0), ((0, 0, 0), (1, 1, 1))
    kw = dict(num_steps=12, step_size=1.8 / 12, early_termination=False,
              termination_eps=1.0 / 255.0)
    g = np.ones((1, 1, 4), np.float32)
    img, got = port_grads(make_fused_marcher(**kw), vol, tf, origin, dirs,
                          window, slicing, g)
    np.testing.assert_array_equal(img.ravel(), 0.0)
    jargs = (jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(origin),
             jnp.asarray(dirs), jnp.float32(0.0), jnp.float32(1.0),
             jnp.zeros(3), jnp.ones(3))
    _, vjp = jax.vjp(jfused(**kw), *jargs)
    jg = vjp(jnp.asarray(g))
    assert_grads_close(got, [jg[i] for i in (0, 1, 4, 5)])
    for a in got:
        assert np.isfinite(a).all() and not np.any(a)


def test_fused_backward_matches_jax_pallas_backward_kernel():
    """The TPU backward kernel itself (``_make_bwd_kernel``) in interpret
    mode, as ``tests/test_slab.py:270-307`` runs it: 8^3 grid (one slab),
    16x16 pixels, 12 steps, loss ``sum(img**2)``."""
    from volumetric_renderer_tpu.kernels.slab import (
        choose_axis_from_camera, make_slab_marcher,
    )

    vol = models.sphere(8).data
    tf = ramp_tf(8)
    jcam = JCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    origin, dirs = jray_grid(jcam, 16, 16)
    origin = np.asarray(origin) + 0.5
    axis, reverse = choose_axis_from_camera(jcam)
    marcher = make_slab_marcher(12, 1.8 / 12, False, 1.0 / 255.0, (8, 8, 8),
                                8, 16, 16, axis=axis, reverse=reverse,
                                interpret=True, bwd="slab", bwd_mode="exact")
    smin, smax = jnp.zeros(3), jnp.ones(3)

    def loss(v, tt, dmn, dmx):
        img = marcher(v, tt, jnp.asarray(origin), dirs, dmn, dmx, smin, smax)
        return jnp.sum(img ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(vol), jnp.asarray(tf), jnp.float32(0.0), jnp.float32(1.0))

    args = [t(vol), t(tf), t(origin), t(dirs), t(0.0), t(1.0), t((0, 0, 0)),
            t((1, 1, 1))]
    for i in (0, 1, 4, 5):
        args[i].requires_grad_(True)
    kw = dict(num_steps=12, step_size=1.8 / 12, early_termination=False,
              termination_eps=1.0 / 255.0)
    (make_fused_marcher(**kw)(*args) ** 2).sum().backward()
    assert_grads_close([args[i].grad.numpy() for i in (0, 1, 4, 5)], want)


@pytest.mark.parametrize("n,steps,et", [(8, 12, False), (12, 20, True),
                                        (12, 20, False)])
def test_render_fused_grads_match_oracle_autograd(n, steps, et):
    """``render(method="fused")`` (the re-march Function) against plain
    autograd through ``render(method="oracle")``: grid, TF and window."""
    vol = models.sphere(n).as_torch()
    tf = torch.from_numpy(ramp_tf(8))
    cam = OrbitCamera.from_angles(120.0, -35.0)
    settings = RenderSettings(height=16, width=16, step_size=1.8 / steps,
                              early_termination=et)
    grads = {}
    for method in ("oracle", "fused"):
        leaves = [vol.clone().requires_grad_(True),
                  tf.clone().requires_grad_(True),
                  torch.tensor(0.0, requires_grad=True),
                  torch.tensor(1.0, requires_grad=True)]
        img = tapi.render(leaves[0], leaves[1], cam, settings,
                          density_min=leaves[2], density_max=leaves[3],
                          method=method)
        (img ** 2).sum().backward()
        grads[method] = [x.grad.numpy() for x in leaves]
    assert_grads_close(grads["fused"], grads["oracle"], atol=1e-4, rtol=0.0)
    assert np.abs(grads["fused"][0]).max() > 1e-3


def smooth_scene():
    """The smooth sphere and a TF transparent at zero density (the
    whole-frame parity scene of ``tests/test_torch_render.py``)."""
    vol = models.sphere(N).data
    tf = Gradient(color_markers=[(0.0, (0.2, 0.1, 0.0)),
                                 (1.0, (1.0, 0.9, 0.8))],
                  alpha_markers=[(0.0, 0.0), (0.1, 0.0),
                                 (1.0, 1.0)]).discretize(NTF)
    return vol, tf


@pytest.mark.parametrize("loss", ["l2", "l1"])
def test_render_loss_and_grads_matches_jax(loss):
    """The full API with the default window: the gradient reaching
    ``vol.min()``/``vol.max()`` flows into the tied voxels in both
    packages."""
    vol, tf = smooth_scene()
    jcam = JCamera.from_angles(30.0, 20.0)
    kw = dict(height=H, width=W, step_size=1.8 / STEPS, tf_resolution=NTF)
    target = np.random.default_rng(4).uniform(size=(H, W, 4)).astype(
        np.float32)
    jv, (jvol_g, jtf_g) = japi.render_loss_and_grads(
        jnp.asarray(vol), jnp.asarray(tf), jcam, jnp.asarray(target),
        JSettings(**kw), loss=loss, method="fused")
    vol_t, tf_t, cam = from_reference_arrays(
        vol, tf, np.asarray(jcam.center), np.asarray(jcam.orientation),
        np.asarray(jcam.radius))
    tv, (tvol_g, ttf_g) = tapi.render_loss_and_grads(
        vol_t, tf_t, cam, torch.from_numpy(target), RenderSettings(**kw),
        loss=loss, method="fused")
    assert tvol_g.shape == vol_t.shape and ttf_g.shape == tf_t.shape
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    for got, want in ((tvol_g, jvol_g), (ttf_g, jtf_g)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4 * scale)
    # the voxels tied at the minimum (the sphere's zero corners) carry the
    # share of the window gradient, as in JAX
    zero = vol == vol.min()
    assert zero.sum() > 100
    np.testing.assert_allclose(tvol_g.numpy()[zero], np.asarray(jvol_g)[zero],
                               atol=5e-4 * np.abs(np.asarray(jvol_g)).max())


def test_default_window_splits_its_gradient_among_ties():
    """With no window given, ``render`` keeps ``vol.min()``/``vol.max()`` in
    the graph: the grid gradient is the fixed-window gradient plus the window
    gradients split evenly among the voxels tied at the min and the max."""
    vol, tf = smooth_scene()
    cam = OrbitCamera.from_angles(30.0, 20.0)
    settings = RenderSettings(height=H, width=W, step_size=1.8 / STEPS)

    v = t(vol).requires_grad_(True)
    (tapi.render(v, t(tf), cam, settings, method="fused") ** 2).sum() \
        .backward()
    default = v.grad.numpy()

    v = t(vol).requires_grad_(True)
    lo = torch.tensor(float(vol.min()), requires_grad=True)
    hi = torch.tensor(float(vol.max()), requires_grad=True)
    (tapi.render(v, t(tf), cam, settings, density_min=lo, density_max=hi,
                 method="fused") ** 2).sum().backward()
    expect = v.grad.numpy().copy()
    at_min, at_max = vol == vol.min(), vol == vol.max()
    assert at_min.sum() > 100 and at_max.sum() == 8   # the 8 centre voxels
    expect[at_min] += float(lo.grad) / at_min.sum()
    expect[at_max] += float(hi.grad) / at_max.sum()
    np.testing.assert_allclose(default, expect, atol=1e-6, rtol=1e-6)
    assert abs(float(lo.grad)) > 1e-3
