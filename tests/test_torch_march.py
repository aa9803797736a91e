"""The port's marchers against the JAX package and the NumPy golden marcher.

``march_rays`` (the oracle) is held against JAX ``march_rays`` and
``tests/reference_marcher.py``; ``march_forward_plain`` (the plain version
of the CUDA forward kernel) against the forward of JAX
``make_fused_marcher``, which is the Pallas kernel's own reference.  Both
packages get *the same* ``origin``/``dirs`` arrays (from the JAX
``ray_grid``): the inside and slicing tests are strict comparisons, so ray
drift could flip a sample at a face.

Tolerance: atol 1e-5, the bar the JAX package holds its kernel to
(``tests/test_slab.py``).  The kernel itself is compared with its plain
version on the card by ``tests/test_torch_kernels.py`` (marked ``cuda``)
and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.reference_marcher import RefCamera, ref_rays, ref_render

from volumetric_renderer_tpu.core.fused import make_fused_marcher as jfused
from volumetric_renderer_tpu.core.marcher import march_rays as jmarch
from volumetric_renderer_tpu.scene.camera import OrbitCamera as JCamera
from volumetric_renderer_tpu.scene.camera import ray_grid as jray_grid
from volumetric_renderer_torch.core.fused import make_fused_marcher
from volumetric_renderer_torch.core.marcher import march_rays, prepare_rays
from volumetric_renderer_torch.data.volume import Volume
from volumetric_renderer_torch.kernels.march import march_forward
from volumetric_renderer_torch.transfer.gradient import Gradient

from tests.test_torch_kernels import CASES, case_params

ATOL = 1e-5


def case_inputs(name):
    """(vol, tf, origin, dirs, window, slicing, march kwargs) as NumPy for
    one case of ``test_torch_kernels.CASES``, with the JAX package's rays."""
    c = case_params(name)
    origin, dirs = jray_grid(JCamera.from_angles(*c["camera"]), *c["hw"],
                             fov_y_degrees=c["fov"])
    return (c["vol"], c["tf"], np.asarray(origin) + 0.5, np.asarray(dirs),
            c["window"], c["slicing"], c["march"])


def t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype=dtype))


@pytest.mark.parametrize("name", CASES)
def test_march_matches_jax(name):
    vol, tf, origin, dirs, window, (smin, smax), kw = case_inputs(name)
    jargs = (jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(origin),
             jnp.asarray(dirs), jnp.float32(window[0]),
             jnp.float32(window[1]), jnp.asarray(smin, jnp.float32),
             jnp.asarray(smax, jnp.float32))
    targs = (t(vol), t(tf), t(origin), t(dirs), t(window[0]), t(window[1]),
             t(smin), t(smax))

    want = np.asarray(jmarch(*jargs[:4], density_min=jargs[4],
                             density_max=jargs[5], slice_min=jargs[6],
                             slice_max=jargs[7], **kw))
    got = march_rays(*targs[:4], density_min=targs[4], density_max=targs[5],
                     slice_min=targs[6], slice_max=targs[7], **kw).numpy()
    assert got.shape == dirs.shape[:-1] + (4,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)

    want_f = np.asarray(jfused(**kw)(*jargs))
    got_f = make_fused_marcher(**kw)(*targs).numpy()
    np.testing.assert_allclose(got_f, want_f, atol=ATOL)
    assert (got[..., 3] > 0.5).any() or name == "degenerate_window"

    # march_forward on CPU tensors is the plain version, kernel untouched
    pos0, hit, inv_w = prepare_rays(targs[2], targs[3], targs[4], targs[5])
    before = march_forward.launches
    via = march_forward(targs[0], targs[1], pos0, targs[3], hit, targs[4],
                        inv_w, targs[6], targs[7], **kw)
    assert march_forward.launches == before
    np.testing.assert_array_equal(via.numpy(), got_f)


@pytest.mark.parametrize("drags", [((40.0, 25.0),), ((200.0, -60.0),)])
def test_march_rays_float64_matches_golden_marcher(drags):
    """The oracle in float64 (dtype follows dirs) against the NumPy
    transliteration of the shader, on the golden marcher's own rays."""
    vol = Volume.synthetic_sphere(12).data
    tf = Gradient.grayscale_ramp().discretize(16)
    ref_cam = RefCamera()
    for d in drags:
        ref_cam.rotate(np.array(d))
    h, w, steps = 12, 14, 40
    want = ref_render(vol, tf, ref_cam, h, w, step_size=1.8 / steps,
                      density_min=0.0, density_max=1.0)
    cam_pos, dirs = ref_rays(ref_cam, h, w)
    f64 = np.float64
    got = march_rays(t(vol, f64), t(tf, f64), t(cam_pos + 0.5, f64),
                     t(dirs, f64), density_min=t(0.0, f64),
                     density_max=t(1.0, f64), slice_min=t((0, 0, 0), f64),
                     slice_max=t((1, 1, 1), f64), num_steps=steps,
                     step_size=1.8 / steps)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_oracle_differentiates_by_autograd():
    """Plain autograd through the Python step loop reaches grid and TF."""
    vol, tf, origin, dirs, *_ = case_inputs("orient_30_20")
    v = t(vol).requires_grad_(True)
    table = t(tf).requires_grad_(True)
    img = march_rays(v, table, t(origin), t(dirs[::4, ::4]),
                     density_min=t(0.0), density_max=t(1.0),
                     slice_min=t((0, 0, 0)), slice_max=t((1, 1, 1)),
                     num_steps=24, step_size=1.8 / 24)
    (img ** 2).sum().backward()
    assert torch.isfinite(v.grad).all() and (v.grad != 0).sum() > 100
    assert torch.isfinite(table.grad).all() and (table.grad != 0).any()
