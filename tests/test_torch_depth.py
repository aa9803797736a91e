"""The depth-chunk ownership range of the port's plain marchers and the fold
of ``parallel/depth``, against the JAX package's fused whole-volume render
(``volumetric_renderer_tpu/core/fused.py``; never against the Pallas slab
kernel, whose depth tests are ``slow``).

A volume rendered as K chunks (body rows plus one halo row, each marched
with ``own = (axis, a_start, body, n)``) and folded per ray must equal the
whole-volume render, and the summed chunk gradients (each halo row's onto
its owner) the whole-volume gradients.  Both packages march the JAX
package's rays.  Tolerances: forward atol 1e-4 and gradients
``2e-4 * max|g|`` (``tests/test_depth.py``: the fold reassociates every
composite); the whole-volume range against ``own=None``: bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetric_renderer_tpu.core.fused import make_fused_marcher as jfused
from volumetric_renderer_tpu.parallel.depth import (
    composite_chunks as jcomposite,
)
from volumetric_renderer_tpu.scene.camera import OrbitCamera as JCamera
from volumetric_renderer_tpu.scene.camera import ray_grid as jray_grid
from volumetric_renderer_torch import models
from volumetric_renderer_torch.core.fused import (
    make_fused_marcher,
    march_backward_prepared,
    march_prepared,
)
from volumetric_renderer_torch.core.marcher import prepare_rays
from volumetric_renderer_torch.core.sampling import check_own
from volumetric_renderer_torch.parallel.depth import (
    chunk_of,
    composite_chunks,
    dominant_axis,
    fold_partials,
    over,
)
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient

N, NTF, H, W, STEPS = 16, 32, 24, 24, 36
VIEWS = {"forward": (33.0, 21.0), "backward": (213.0, -21.0),
         "steep": (120.0, -35.0)}
MARCH = dict(num_steps=STEPS, step_size=1.8 / STEPS, early_termination=False,
             termination_eps=1.0 / 255.0)


def scene():
    vol = models.sphere(N).data
    tf = Gradient.grayscale_ramp().discretize(NTF)
    tf[:, 3] = np.linspace(0.0, 0.7, NTF, dtype=np.float32)
    return vol, tf


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def jax_reference(view):
    """The JAX fused render of ``view`` and the vjp of ``sum(sin(3 img))``
    in the grid, TF, dmin and dmax; with the rays, as NumPy."""
    vol, tf = scene()
    origin, dirs = jray_grid(JCamera.from_angles(*VIEWS[view]), H, W)
    origin = np.asarray(origin) + 0.5
    rest = (jnp.asarray(origin), jnp.asarray(dirs))

    def loss(v, tt, dmin, dmax):
        img = jfused(**MARCH)(v, tt, *rest, dmin, dmax, jnp.zeros(3),
                              jnp.ones(3))
        return jnp.sum(jnp.sin(3.0 * img)), img

    (_, img), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        jnp.asarray(vol), jnp.asarray(tf), jnp.float32(0.0), jnp.float32(1.0))
    return (np.asarray(img), [np.asarray(g) for g in grads], origin,
            np.asarray(dirs))


def render_chunks(n_chunks, axis, view):
    """The port's chunked plain march, folded per ray, and its gradients."""
    vol, tf = scene()
    _, _, origin, dirs = jax_reference(view)
    body = N // n_chunks
    xs = [t(vol), t(tf), t(0.0), t(1.0)]
    for x in xs:
        x.requires_grad_(True)
    parts = [make_fused_marcher(**MARCH, own=(axis, c * body, body, N))(
        chunk_of(xs[0], c, body, axis), xs[1], t(origin), t(dirs), xs[2],
        xs[3], torch.zeros(3), torch.ones(3)) for c in range(n_chunks)]
    img = fold_partials(torch.stack(parts), t(dirs), axis)
    torch.sum(torch.sin(3.0 * img)).backward()
    return img.detach().numpy(), [x.grad.numpy() for x in xs], parts


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunked_plain_march_matches_jax_fused(n_chunks, axis, view):
    want_img, want_grads, _, _ = jax_reference(view)
    img, grads, _ = render_chunks(n_chunks, axis, view)
    assert float(want_img[..., 3].max()) > 0.3
    np.testing.assert_allclose(img, want_img, atol=1e-4)
    for name, a, b in zip(("vol", "tf", "dmin", "dmax"), grads, want_grads):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-4 * np.abs(b).max(), err_msg=name)


def prepared(view):
    _, _, origin, dirs = jax_reference(view)
    dmin, dmax = t(0.0), t(1.0)
    pos0, hit, inv_w = prepare_rays(t(origin), t(dirs), dmin, dmax)
    return (pos0, t(dirs), hit, dmin, inv_w, torch.zeros(3), torch.ones(3))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_whole_volume_range_is_bitwise_the_whole_volume(axis):
    """``own=(axis, 0, n, n)`` on the volume plus a zero halo row equals
    ``own=None`` bit for bit, forward and backward."""
    vol, tf = scene()
    args = prepared("steep")
    chunk = chunk_of(t(vol), 0, N, axis)
    assert chunk.shape[axis] == N + 1
    want = march_prepared(t(vol), t(tf), *args, **MARCH)
    got = march_prepared(chunk, t(tf), *args, own=(axis, 0, N, N), **MARCH)
    assert torch.equal(got, want)
    g = t(np.random.default_rng(2).normal(size=(H, W, 4)))
    want_b = march_backward_prepared(t(vol), t(tf), *args, want, g, **MARCH)
    got_b = march_backward_prepared(chunk, t(tf), *args, want, g,
                                    own=(axis, 0, N, N), **MARCH)
    assert torch.equal(got_b[0].narrow(axis, 0, N), want_b[0])
    assert not got_b[0].narrow(axis, N, 1).any()      # the zero halo row
    for a, b in zip(got_b[1:], want_b[1:]):
        assert torch.equal(a, b)


def test_fold_per_ray_equals_jax_composite_on_one_way_views():
    """On a view whose rays all march one way along the axis, the per-ray
    fold is the JAX package's ``composite_chunks(reverse=...)``."""
    for view, axis in (("forward", 1), ("backward", 1)):
        _, _, _, dirs = jax_reference(view)
        d = dirs[..., 2 - axis]
        assert (d > 0).all() or (d < 0).all()
        parts = render_chunks(4, axis, view)[2]
        parts = [p.detach().numpy() for p in parts]
        got = fold_partials(torch.from_numpy(np.stack(parts)), t(dirs), axis)
        want = jcomposite([jnp.asarray(p) for p in parts],
                          reverse=bool((d < 0).all()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            composite_chunks([torch.from_numpy(p) for p in parts],
                             reverse=bool((d < 0).all())).numpy(),
            np.asarray(want))


def test_over_operator_associative():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.random((4, 4, 4)).astype(np.float32))
             for _ in range(3)]
    left = over(over(parts[0], parts[1]), parts[2])
    right = over(parts[0], over(parts[1], parts[2]))
    np.testing.assert_allclose(left.numpy(), right.numpy(), atol=1e-6)


def test_chunk_of_is_body_plus_halo():
    vol = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
    c = chunk_of(vol, 1, 3, 1)
    assert c.shape == (4, 4, 5)
    assert torch.equal(c[:, :3], vol[:, 3:6]) and not c[:, 3].any()
    assert torch.equal(chunk_of(vol, 0, 3, 1), vol[:, :4])


def test_check_own_rejects_bad_ranges():
    assert check_own(None, (4, 4, 4)) is None
    assert check_own((0, 2, 2, 4), (3, 4, 4)) == (0, 2, 2, 4)
    for own, shape, match in (((3, 0, 2, 4), (3, 4, 4), "axis"),
                              ((0, 3, 2, 4), (3, 4, 4), "do not lie"),
                              ((0, 0, 2, 4), (2, 4, 4), "halo")):
        with pytest.raises(ValueError, match=match):
            check_own(own, shape)


def test_dominant_axis_of_the_optimize_arcs():
    """The arcs of ``apps.optimize --parallel depth`` look along y (array
    axis 1); a top-down view looks along z (array axis 0)."""
    arcs = [OrbitCamera.from_angles(yaw_deg=float(a), pitch_deg=20.0)
            for a in (-40.0, 0.0, 40.0, 140.0, 180.0, 220.0)]
    assert dominant_axis(arcs) == 1
    assert dominant_axis([OrbitCamera.from_angles(0.0, 80.0)]) == 0
    assert dominant_axis([OrbitCamera.from_angles(90.0, 10.0)]) == 2
