"""Rules of the port: it never imports JAX, it never falls back from the
CUDA kernel to the plain version, it rejects the JAX package's TPU methods,
and ``chip_smoke.py`` fails without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from volumetric_renderer_torch import models
from volumetric_renderer_torch.kernels import _build
from volumetric_renderer_torch.kernels.march import march_forward
from volumetric_renderer_torch.render.api import render
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils.config import RenderSettings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = RenderSettings(height=8, width=8, step_size=1.8 / 16)


def small_scene():
    vol = models.sphere(12).as_torch()
    tf = torch.from_numpy(Gradient.grayscale_ramp().discretize(16))
    return vol, tf, OrbitCamera.from_angles(30.0, 20.0)


def test_package_renders_without_importing_jax():
    code = (
        "import sys, torch\n"
        "import volumetric_renderer_torch as vt\n"
        "from volumetric_renderer_torch import models\n"
        "from volumetric_renderer_torch.apps import optimize, render_cli\n"
        "from volumetric_renderer_torch.parallel import train\n"
        "from volumetric_renderer_torch.utils import checkpoint, convert\n"
        "from volumetric_renderer_torch.utils import metrics\n"
        "v = models.sphere(12).as_torch()\n"
        "tf = torch.from_numpy(vt.Gradient.grayscale_ramp().discretize(16))\n"
        "img = vt.render(v, tf, vt.OrbitCamera.from_angles(30, 20),\n"
        "                vt.RenderSettings(height=8, width=8,\n"
        "                                  step_size=1.8 / 16))\n"
        "assert img.shape == (8, 8, 4) and float(img[..., 3].max()) > 0\n"
        "optimize.main(['tf-fit', '--grid', '8', '--size', '8x8',\n"
        "               '--march-steps', '8', '--views', '1',\n"
        "               '--steps-opt', '1', '--tf-resolution', '8',\n"
        "               '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'volumetric_renderer_tpu')))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_kernel_method_on_cpu_raises():
    vol, tf, cam = small_scene()
    with pytest.raises(ValueError, match="CUDA"):
        render(vol, tf, cam, SMALL, method="kernel")


def test_auto_on_cpu_runs_the_plain_version():
    vol, tf, cam = small_scene()
    before = march_forward.launches
    auto = render(vol, tf, cam, SMALL, method="auto")
    assert march_forward.launches == before
    fused = render(vol, tf, cam, SMALL, method="fused")
    np.testing.assert_array_equal(auto.numpy(), fused.numpy())


@pytest.mark.parametrize("method", ["slab", "pallas", "blocked", "bogus"])
def test_tpu_and_unknown_methods_raise(method):
    vol, tf, cam = small_scene()
    with pytest.raises(ValueError, match="oracle"):
        render(vol, tf, cam, SMALL, method=method)


def test_cli_device_cuda_without_cuda_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from volumetric_renderer_torch.apps.render_cli import main

    with pytest.raises(SystemExit, match="CUDA"):
        main(["x", "--synthetic", "--size", "8x8", "--steps", "8",
              "--device", "cuda", "--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_march_forward_rejects_mixed_devices():
    vol, tf, _ = small_scene()
    pos0 = torch.zeros(2, 2, 3, device="meta")
    with pytest.raises(ValueError, match="devices"):
        march_forward(vol, tf, pos0, pos0, torch.zeros(2, 2, dtype=bool),
                      0.0, 1.0, (0, 0, 0), (1, 1, 1), num_steps=1,
                      step_size=0.1, early_termination=False,
                      termination_eps=0.0)


def test_package_sources_never_import_jax():
    pkg = os.path.join(REPO, "volumetric_renderer_torch")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
               if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    assert not words[1].startswith(
                        ("jax", "volumetric_renderer_tpu")), (path, line)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No GPU (``CUDA_VISIBLE_DEVICES=""``): non-zero within seconds and no
    result line; copied into an empty directory it fails too."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
