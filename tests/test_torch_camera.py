"""Camera parity: the PyTorch port's quaternions, OrbitCamera and ray_grid
against the JAX package, on inputs made with NumPy from a seed.

Tolerances:
* quaternions, camera poses and matrices: atol 1e-6 (float32 rounding of
  the same formulas; 4x4 products may sum in another order);
* ray_grid directions: atol 1e-5.  Unprojecting pixel centres at two depths
  and subtracting cancels about a decade of float32 precision, so each
  package lies up to ~3e-6 from the float64 reference
  (``tests/reference_marcher.ref_rays``) and the two packages differ by up
  to ~4e-6 where ``torch.linalg.inv`` and ``jnp.linalg.inv`` round
  differently.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.reference_marcher import RefCamera, ref_rays

from volumetric_renderer_tpu.scene import camera as jcam
from volumetric_renderer_tpu.utils import quaternion as jquat
from volumetric_renderer_torch.scene import camera as tcam
from volumetric_renderer_torch.utils import quaternion as tquat
from volumetric_renderer_torch.utils.convert import from_reference_arrays

ATOL = 1e-6
RAY_ATOL = 1e-5
POSES = [(30.0, 20.0, 3.0), (120.0, -35.0, 2.0), (200.0, 5.0, 1.2)]


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def n(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        axis = rng.normal(size=3).astype(np.float32)
        axis /= np.linalg.norm(axis)
        angle = np.float32(rng.uniform(-np.pi, np.pi))
        q1 = rng.normal(size=4).astype(np.float32)
        q2 = rng.normal(size=4).astype(np.float32)
        v = rng.normal(size=3).astype(np.float32)
        pairs = [
            (tquat.from_axis_angle(t(axis), angle),
             jquat.from_axis_angle(axis, angle)),
            (tquat.multiply(t(q1), t(q2)), jquat.multiply(q1, q2)),
            (tquat.rotate_vector(t(q1), t(v)), jquat.rotate_vector(q1, v)),
            (tquat.to_rotation_matrix(t(q1)), jquat.to_rotation_matrix(q1)),
            (tquat.normalize(t(q1)), jquat.normalize(jnp.asarray(q1))),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL,
                                       rtol=1e-6)


@pytest.mark.parametrize("yaw,pitch,radius", POSES)
def test_orbit_camera_matches_jax(yaw, pitch, radius):
    tc = tcam.OrbitCamera.from_angles(yaw, pitch, radius)
    jc = jcam.OrbitCamera.from_angles(yaw, pitch, radius)
    for got, want in [(tc.center, jc.center), (tc.orientation, jc.orientation),
                      (tc.radius, jc.radius), (tc.position(), jc.position()),
                      (tc.view_matrix(), jc.view_matrix())]:
        np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)
    # interaction: a drag then a zoom, past the radius clamp both ways
    drag = np.array([37.0, -12.0], np.float32)
    for dz in (0.5, -20.0, 20.0):
        got = tc.rotate(drag).zoom(dz)
        want = jc.rotate(drag).zoom(dz)
        np.testing.assert_allclose(n(got.orientation),
                                   np.asarray(want.orientation), atol=ATOL)
        np.testing.assert_allclose(n(got.radius), np.asarray(want.radius),
                                   atol=ATOL)
    np.testing.assert_allclose(
        n(tcam.projection_matrix(tc, 1.2)),
        np.asarray(jcam.projection_matrix(jc, 1.2)), atol=ATOL, rtol=1e-6)


def test_create_and_matrices_match_jax():
    tc, jc = tcam.OrbitCamera.create(), jcam.OrbitCamera.create()
    np.testing.assert_allclose(n(tc.orientation), np.asarray(jc.orientation),
                               atol=ATOL)
    np.testing.assert_allclose(n(tc.position()), [0.0, -3.0, 0.0], atol=ATOL)
    np.testing.assert_array_equal(n(tcam.coordinate_conversion()),
                                  np.asarray(jcam.coordinate_conversion()))
    for fov, aspect in [(np.deg2rad(40.0), 1.5), (np.deg2rad(90.0), 0.75)]:
        np.testing.assert_allclose(
            n(tcam.perspective_rh_zo(fov, aspect, 0.1, 10.0)),
            np.asarray(jcam.perspective_rh_zo(fov, aspect, 0.1, 10.0)),
            atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("yaw,pitch,radius", POSES)
def test_ray_grid_matches_jax_and_reference(yaw, pitch, radius):
    h, w = 40, 48
    tc = tcam.OrbitCamera.from_angles(yaw, pitch, radius)
    jc = jcam.OrbitCamera.from_angles(yaw, pitch, radius)
    origin, dirs = tcam.ray_grid(tc, h, w)
    jorigin, jdirs = jcam.ray_grid(jc, h, w)
    assert dirs.shape == (h, w, 3) and dirs.dtype == torch.float32
    np.testing.assert_allclose(n(origin), np.asarray(jorigin), atol=ATOL)
    np.testing.assert_allclose(n(dirs), np.asarray(jdirs), atol=RAY_ATOL)
    np.testing.assert_allclose(np.linalg.norm(n(dirs), axis=-1), 1.0,
                               atol=ATOL)

    ref = RefCamera()
    ref.rotate(np.array([yaw, pitch]) / 0.25)
    ref.zoom(3.0 - radius)
    ref_origin, ref_dirs = ref_rays(ref, h, w)
    np.testing.assert_allclose(n(origin), ref_origin, atol=ATOL)
    np.testing.assert_allclose(n(dirs), ref_dirs, atol=RAY_ATOL)


def test_ray_grid_wide_fov_and_reference_arrays():
    """A camera carried across with ``from_reference_arrays`` gives the
    port's own rays; FoV 90 close to the cube as in the kernel's cases."""
    jc = jcam.OrbitCamera.from_angles(75.0, -10.0, 0.9)
    _, _, tc = from_reference_arrays(
        np.zeros((2, 2, 2)), np.zeros((2, 4)), np.asarray(jc.center),
        np.asarray(jc.orientation), np.asarray(jc.radius))
    own = tcam.OrbitCamera.from_angles(75.0, -10.0, 0.9)
    np.testing.assert_array_equal(n(tc.orientation), n(own.orientation))
    _, dirs = tcam.ray_grid(tc, 20, 30, fov_y_degrees=90.0)
    _, jdirs = jcam.ray_grid(jc, 20, 30, fov_y_degrees=90.0)
    np.testing.assert_allclose(n(dirs), np.asarray(jdirs), atol=RAY_ATOL)


@pytest.mark.parametrize("allow", [True, False])
def test_ray_grid_leaves_the_tf32_flag_as_the_caller_set_it(allow):
    """``ray_grid`` writes no process-wide flag: TF32 stays as set, and the
    rays are those of the JAX package either way."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        _, dirs = tcam.ray_grid(tcam.OrbitCamera.from_angles(30.0, 20.0),
                                24, 32)
        assert torch.backends.cuda.matmul.allow_tf32 is allow
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    _, jdirs = jcam.ray_grid(jcam.OrbitCamera.from_angles(30.0, 20.0), 24, 32)
    np.testing.assert_allclose(n(dirs), np.asarray(jdirs), atol=RAY_ATOL)


def test_camera_module_assigns_no_backend_flag():
    with open(tcam.__file__) as f:
        src = f.read()
    assert not re.search(r"torch\.backends\.[\w.]+\s*=[^=]", src)
    assert "allow_tf32" not in src
