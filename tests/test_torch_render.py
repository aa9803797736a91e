"""The port's whole render slice against the JAX package: ``render`` from
camera to RGBA, the display helpers, and the CLI from NRRD file to image.

Tolerance: atol 1e-4 for rendered frames.  Each package generates its own
rays here, and its ray directions differ from the other's by up to ~4e-6
(``torch.linalg.inv`` vs ``jnp.linalg.inv`` and the unprojection round
differently; see ``test_torch_camera.py``), which moves sample positions by
~1e-5 voxel widths and the frame by up to ~8e-5.  Post-processing helpers
are elementwise: atol 1e-6.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetric_renderer_tpu.data.nrrd import write_nrrd
from volumetric_renderer_tpu.render import api as japi
from volumetric_renderer_tpu.scene.camera import OrbitCamera as JCamera
from volumetric_renderer_tpu.utils.config import RenderSettings as JSettings
from volumetric_renderer_torch import models
from volumetric_renderer_torch.core.marcher import render_oracle
from volumetric_renderer_torch.render import api as tapi
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils.convert import from_reference_arrays

ATOL = 1e-4
N, NTF, STEPS, H, W = 32, 32, 48, 40, 48


def scene():
    """The JAX package's test scene: sphere, grayscale ramp TF whose alpha
    is linspace(0, 1)^2 (``tests/test_slab.py``)."""
    vol = models.sphere(N).data
    tf = Gradient.grayscale_ramp().discretize(NTF)
    tf[:, 3] = np.linspace(0.0, 1.0, NTF, dtype=np.float32) ** 2
    return vol, tf


RENDER_CASES = [
    dict(yaw=30.0, pitch=20.0),
    dict(yaw=120.0, pitch=-35.0, early_termination=False),
    dict(yaw=200.0, pitch=5.0, slice_min=(0.1, 0.2, 0.0),
         slice_max=(0.9, 1.0, 0.7)),
    dict(yaw=0.0, pitch=80.0, density_min=0.1, density_max=0.8, tf_srgb=True),
]


@pytest.mark.parametrize("case", RENDER_CASES,
                         ids=["default", "no_et", "slicing", "window_srgb"])
def test_render_matches_jax(case):
    case = dict(case)
    vol, tf = scene()
    yaw, pitch = case.pop("yaw"), case.pop("pitch")
    et = case.pop("early_termination", True)
    settings = dict(height=H, width=W, step_size=1.8 / STEPS,
                    early_termination=et, tf_resolution=NTF)
    jcam = JCamera.from_angles(yaw, pitch)
    vol_t, tf_t, cam = from_reference_arrays(
        vol, tf, np.asarray(jcam.center), np.asarray(jcam.orientation),
        np.asarray(jcam.radius), device="cpu")
    jkw = {k: (jnp.asarray(v, jnp.float32) if isinstance(v, tuple) else v)
           for k, v in case.items()}
    for method, jmethod in [("oracle", "oracle"), ("fused", "fused"),
                            ("auto", "fused")]:
        got = tapi.render(vol_t, tf_t, cam, RenderSettings(**settings),
                          method=method, **case)
        want = japi.render(jnp.asarray(vol), jnp.asarray(tf), jcam,
                           JSettings(**settings), method=jmethod, **jkw)
        assert got.shape == (H, W, 4) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=method)
        assert float(got[..., 3].max()) > 0.5


def test_render_oracle_is_render_oracle_method():
    vol, tf = scene()
    cam = OrbitCamera.from_angles(45.0, 10.0)
    settings = RenderSettings(height=12, width=16, step_size=1.8 / 24)
    a = render_oracle(torch.from_numpy(vol), torch.from_numpy(tf), cam,
                      settings)
    b = tapi.render(torch.from_numpy(vol), torch.from_numpy(tf), cam,
                    settings, method="oracle")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_composite_and_display_match_jax():
    rng = np.random.default_rng(2)
    rgba = rng.uniform(size=(7, 9, 4)).astype(np.float32)
    bg = (0.11, 0.2, 0.3)
    for ref_blend in (False, True):
        got = tapi.composite_over(torch.from_numpy(rgba), bg, ref_blend)
        want = japi.composite_over(jnp.asarray(rgba), bg, ref_blend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    rgb = rgba[..., :3]
    for b, c in [(0.0, 0.0), (0.2, -0.5), (-0.3, 1.5)]:
        got = tapi.adjust_display(torch.from_numpy(rgb), b, c)
        want = japi.adjust_display(jnp.asarray(rgb), b, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_render_cli_matches_jax_cli(tmp_path):
    """The same NRRD file through both CLIs (``--npy``), and the PNG.

    Each CLI makes its own rays, so the ~1e-5 drift of sample positions
    meets the data's gradient: the volume is the smooth sphere (a grid with
    hard edges, like the head phantom's skull, turns the drift into ~3e-4),
    the TF is transparent over the lowest densities (an empty-space sample
    lying within ~1e-5 of a cube face may fall on either side of it) and no
    slicing plane cuts the volume.  Slicing is held at 1e-5 with shared rays
    in ``test_torch_march.py`` and at 1e-4 on the sphere above."""
    from PIL import Image

    from volumetric_renderer_tpu.apps.render_cli import main as jmain
    from volumetric_renderer_torch.apps.render_cli import main as tmain

    nrrd = str(tmp_path / "sphere.nrrd")
    write_nrrd(nrrd, (scene()[0] * 60000).astype(np.uint16), encoding="gzip")
    tf_json = tmp_path / "tf.json"
    tf_json.write_text(json.dumps({
        "color_markers": [[0.0, 0.2, 0.1, 0.0], [1.0, 1.0, 0.9, 0.8]],
        "alpha_markers": [[0.0, 0.0], [0.1, 0.0], [1.0, 1.0]]}))
    common = [nrrd, "--size", f"{W}x{H}", "--steps", str(STEPS), "--tf",
              str(tf_json), "--tf-resolution", str(NTF), "--yaw", "30",
              "--pitch", "20"]
    tmain(common + ["--device", "cpu", "--npy", str(tmp_path / "t.npy"),
                    "--out", str(tmp_path / "t.png")])
    jmain(common + ["--npy", str(tmp_path / "j.npy"),
                    "--out", str(tmp_path / "j.png")])
    got = np.load(tmp_path / "t.npy")
    want = np.load(tmp_path / "j.npy")
    assert got.shape == (H, W, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[..., 3] > 0.01).mean() > 0.05

    png = np.asarray(Image.open(tmp_path / "t.png"))
    assert png.shape == (H, W, 3) and png.dtype == np.uint8
    rgb = tapi.composite_over(torch.from_numpy(got), (0.11, 0.11, 0.11))
    np.testing.assert_array_equal(
        png, (np.clip(rgb.numpy(), 0.0, 1.0) * 255).astype(np.uint8))
    # the JAX CLI's PNG of the same frame differs by at most one level
    jpng = np.asarray(Image.open(tmp_path / "j.png")).astype(int)
    assert np.abs(png.astype(int) - jpng).max() <= 1
