"""Sampling primitives of the PyTorch port against the JAX package:
trilinear (CLAMP_TO_BORDER), the ray/box slab test, the TF lookup
(CLAMP_TO_EDGE), the sRGB helpers and one compositing step.  Inputs are
made with NumPy from a seed and fed to both packages.

Tolerance: atol 1e-6 (same float32 formulas, elementwise); the slab test's
hit masks and parked entry points must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.reference_marcher import sample1d_edge, sample3d_border

from volumetric_renderer_tpu.core import sampling as jsamp
from volumetric_renderer_tpu import ops as jops
from volumetric_renderer_tpu.transfer.texture import sample_tf as jsample_tf
from volumetric_renderer_tpu.utils import color as jcolor
from volumetric_renderer_torch.core import sampling as tsamp
from volumetric_renderer_torch import ops as tops
from volumetric_renderer_torch.transfer.texture import sample_tf as tsample_tf
from volumetric_renderer_torch.utils import color as tcolor

ATOL = 1e-6


def t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype=dtype))


def test_trilinear_past_every_face_matches_jax():
    rng = np.random.default_rng(1)
    vol = rng.uniform(-1.0, 2.0, size=(5, 6, 7)).astype(np.float32)
    pts = rng.uniform(-0.3, 1.3, size=(400, 3)).astype(np.float32)
    # points exactly on, just inside and just past each of the 6 faces
    faces = []
    for axis in range(3):
        for v in (0.0, 1e-6, -1e-3, 1.0, 1.0 - 1e-6, 1.0 + 1e-3):
            p = rng.uniform(0.0, 1.0, size=3).astype(np.float32)
            p[axis] = v
            faces.append(p)
    pts = np.concatenate([pts, np.array(faces, np.float32)])
    got = tsamp.trilinear_sample(t(vol), t(pts)).numpy()
    want = np.asarray(jsamp.trilinear_sample(jnp.asarray(vol), jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # float64 against the sampler emulation of the reference
    got64 = tsamp.trilinear_sample(t(vol, np.float64), t(pts, np.float64))
    assert got64.dtype == torch.float64
    want64 = [sample3d_border(vol.astype(np.float64), p) for p in pts]
    np.testing.assert_allclose(got64.numpy(), want64, atol=1e-12)


@pytest.mark.parametrize("origin", [(0.5, -2.0, 0.5), (0.0, 0.3, 1.7),
                                    (0.5, 0.5, 0.5), (1.0, 1.0, -0.5)])
def test_ray_box_axis_parallel_matches_jax(origin):
    rng = np.random.default_rng(2)
    axis_dirs = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    rand = rng.normal(size=(20, 3)).astype(np.float32)
    rand /= np.linalg.norm(rand, axis=-1, keepdims=True)
    dirs = np.concatenate([axis_dirs, rand])
    got = tsamp.ray_box_intersect(t(origin), t(dirs))
    want = jsamp.ray_box_intersect(jnp.asarray(origin, jnp.float32),
                                   jnp.asarray(dirs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t_in, t_out, hit = got
    assert bool(torch.isfinite(t_in).all() & torch.isfinite(t_out).all())
    assert bool((t_in[~hit] == 0).all() & (t_out[~hit] == 0).all())


def test_ray_box_nan_from_origin_on_slab_plane_is_a_miss():
    """Origin on the x = 0 plane with dir.x = 0: (0 - 0) * inf = NaN must
    make the ray a miss (torch.minimum keeps NaN, fmin would drop it)."""
    origin = t([0.0, -1.0, 0.5])
    dirs = t([[0.0, 1.0, 0.0]])
    t_in, _, hit = tsamp.ray_box_intersect(origin, dirs)
    _, _, jhit = jsamp.ray_box_intersect(jnp.asarray(origin.numpy()),
                                         jnp.asarray(dirs.numpy()))
    assert not bool(hit[0]) and not bool(jhit[0])
    assert float(t_in[0]) == 0.0


def test_sample_tf_out_of_range_matches_jax():
    rng = np.random.default_rng(3)
    table = rng.uniform(size=(17, 4)).astype(np.float32)
    ts = np.concatenate([rng.uniform(-0.5, 1.5, size=300),
                         [0.0, 1.0, -1e-7, 1.0 + 1e-7, 0.5 / 17]]
                        ).astype(np.float32)
    got = tsample_tf(t(table), t(ts)).numpy()
    want = np.asarray(jsample_tf(jnp.asarray(table), jnp.asarray(ts)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    ref = np.array([sample1d_edge(table.astype(np.float64), x) for x in ts])
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert tsample_tf(t(table), t(ts.reshape(5, -1))).shape == (5, 61, 4)


def test_color_helpers_match_jax():
    rng = np.random.default_rng(4)
    table = rng.uniform(size=(32, 4)).astype(np.float32)
    c = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    np.testing.assert_allclose(tcolor.srgb_to_linear(t(c)).numpy(),
                               np.asarray(jcolor.srgb_to_linear(c)), atol=ATOL)
    np.testing.assert_allclose(tcolor.linear_to_srgb(t(c)).numpy(),
                               np.asarray(jcolor.linear_to_srgb(c)), atol=ATOL)
    got = tcolor.linearize_tf_table(t(table)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jcolor.linearize_tf_table(table)), atol=ATOL)
    np.testing.assert_array_equal(got[:, 3], table[:, 3])
    np.testing.assert_array_equal(tcolor.pack_rgba8(table),
                                  jcolor.pack_rgba8(table))
    np.testing.assert_array_equal(
        tcolor.unpack_rgba8(tcolor.pack_rgba8(table)),
        jcolor.unpack_rgba8(jcolor.pack_rgba8(table)))


def test_composite_step_matches_jax():
    rng = np.random.default_rng(5)
    rgb = rng.uniform(size=(9, 3)).astype(np.float32)
    tr = rng.uniform(size=9).astype(np.float32)
    srgb = rng.uniform(size=(9, 3)).astype(np.float32)
    sa = rng.uniform(size=9).astype(np.float32)
    got = tops.composite_step(t(rgb), t(tr), t(srgb), t(sa))
    want = jops.composite_step(jnp.asarray(rgb), jnp.asarray(tr),
                               jnp.asarray(srgb), jnp.asarray(sa))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
