"""The port's sanitizer layer against the JAX package's
(``volumetric_renderer_tpu/utils/sanitize.py``).

``checked_render`` must raise where the JAX package's checkify-instrumented
render raises and stay silent where it does, on the same grids: a clean
sphere, one NaN voxel at the centre, NaN voxels that the slicing window
masks (rays still sample them, and checkify traps the product that carries
the NaN), and an Inf voxel.  On a clean grid its image equals
``render(method=...)`` bit for bit.  ``assert_deterministic`` is checked
on the forward (the backward kernel's atomics are not bitwise repeatable).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetric_renderer_tpu.scene.camera import OrbitCamera as JCamera
from volumetric_renderer_tpu.transfer.gradient import Gradient as JGradient
from volumetric_renderer_tpu.utils.config import RenderSettings as JSettings
from volumetric_renderer_tpu.utils.sanitize import (
    checked_render as jchecked_render,
)
from volumetric_renderer_torch.data.volume import Volume
from volumetric_renderer_torch.render.api import render
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils import sanitize
from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils.sanitize import (
    assert_deterministic,
    checked_render,
)

SETTINGS = dict(height=24, width=24, step_size=1.8 / 24,
                early_termination=False)
MASKED_SLICE = ([0.0, 0.0, 0.35], [1.0, 1.0, 1.0])


def grid(name):
    """The 16^3 sphere of ``tests/test_sanitize.py`` and its poisoned
    variants, with the slicing window each is rendered in."""
    vol = Volume.synthetic_sphere(16).data.copy()
    slicing = (None, None)
    if name == "centre_nan":
        vol[8, 8, 8] = np.nan
    elif name == "masked_nan":
        vol[:4] = np.nan                 # z < 0.25, outside the window
        slicing = MASKED_SLICE
    elif name == "centre_inf":
        vol[8, 8, 8] = np.inf
    return vol, slicing


GRIDS = ["clean", "centre_nan", "masked_nan", "centre_inf"]


@pytest.fixture(scope="module")
def jax_raises():
    """Whether the JAX package's ``checked_render`` raises, per grid and
    method (one checkify compile per method)."""
    tf = jnp.asarray(JGradient.grayscale_ramp().discretize(16))
    cam = JCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    out = {}
    for method in ("fused", "oracle"):
        for name in GRIDS:
            vol, (smin, smax) = grid(name)
            err, _ = jchecked_render(
                jnp.asarray(vol), tf, cam, JSettings(**SETTINGS),
                density_min=0.0, density_max=1.0, slice_min=smin,
                slice_max=smax, method=method)
            try:
                err.throw()
                out[name, method] = False
            except Exception as e:       # checkify's JaxRuntimeError
                assert "nan" in str(e)
                out[name, method] = True
    return out


def port_scene(name, device="cpu"):
    vol, (smin, smax) = grid(name)
    tf = torch.as_tensor(Gradient.grayscale_ramp().discretize(16),
                         device=device)
    return (torch.as_tensor(vol, device=device), tf,
            OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0),
            dict(density_min=0.0, density_max=1.0, slice_min=smin,
                 slice_max=smax))


@pytest.mark.parametrize("method", ["fused", "oracle"])
@pytest.mark.parametrize("name", GRIDS)
def test_checked_render_raises_where_jax_does(jax_raises, name, method):
    vol, tf, cam, window = port_scene(name)
    err, img = checked_render(vol, tf, cam, RenderSettings(**SETTINGS),
                              method=method, **window)
    assert img.shape == (24, 24, 4)
    if jax_raises[name, method]:
        assert err.get() is not None
        with pytest.raises(FloatingPointError, match="nan"):
            err.throw()
    else:
        assert err.get() is None
        err.throw()
    assert jax_raises["clean", method] is False
    assert jax_raises["masked_nan", method] is True


@pytest.mark.parametrize("method", ["fused", "oracle", "auto"])
def test_checked_render_clean_image_equals_render(method):
    vol, tf, cam, window = port_scene("clean")
    settings = RenderSettings(**SETTINGS)
    err, img = checked_render(vol, tf, cam, settings, method=method,
                              **window)
    err.throw()
    assert torch.equal(img, render(vol, tf, cam, settings, method=method,
                                   **window))


def test_masked_nan_voxels_leave_the_image_finite():
    """NaN voxels the slicing window excludes must not reach the image:
    the masked-compositing contract, which the checks do not change."""
    vol, tf, cam, window = port_scene("masked_nan")
    settings = RenderSettings(**SETTINGS)
    _, img = checked_render(vol, tf, cam, settings, **window)
    assert torch.isfinite(img).all()
    assert torch.equal(img, render(vol, tf, cam, settings, method="fused",
                                   **window))


def test_checked_render_rejects_the_kernel(monkeypatch):
    vol, tf, cam, _ = port_scene("clean")
    settings = RenderSettings(**SETTINGS)
    with pytest.raises(ValueError):
        checked_render(vol, tf, cam, settings, method="kernel")
    # "auto" on a CUDA volume resolves to the kernel
    monkeypatch.setattr(sanitize, "select_method", lambda m, v: "kernel")
    with pytest.raises(ValueError, match="plain PyTorch"):
        checked_render(vol, tf, cam, settings, method="auto")


def test_render_deterministic():
    vol, tf, cam, window = port_scene("clean")
    settings = RenderSettings(**SETTINGS)
    first = assert_deterministic(
        lambda v, t: render(v, t, cam, settings, **window), vol, tf, runs=3)
    assert first.shape == (24, 24, 4)


def test_assert_deterministic_catches_mutation():
    vol, _, _, _ = port_scene("clean")
    state = {"n": 0}

    def flaky(v):
        state["n"] += 1
        return v + float(state["n"])

    with pytest.raises(AssertionError, match="nondeterministic"):
        assert_deterministic(flaky, vol)


def test_assert_deterministic_exempts_shared_nan_and_walks_containers():
    x = torch.tensor([1.0, float("nan"), 3.0])
    out = assert_deterministic(lambda: {"a": x.clone(), "b": (x * 2, [x])})
    assert torch.equal(out["a"][::2], x[::2])
    moving = iter([torch.tensor([float("nan"), 1.0]),
                   torch.tensor([0.0, 1.0])])
    with pytest.raises(AssertionError, match="nondeterministic"):
        assert_deterministic(lambda: next(moving))
