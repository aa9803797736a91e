"""The forward ray-march kernel (K1): its build step and wrapper on any
machine, and the kernel itself against its plain PyTorch version on a CUDA
card (tests marked ``cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so the ``cuda`` tests
also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

Tolerance on the card: atol 1e-5 (the kernel repeats the plain version's
float operations in the same order and is built with -fmad=false, so the
two agree bit for bit in practice).
"""

import os
import stat

import numpy as np
import pytest
import torch

from volumetric_renderer_torch.core.marcher import prepare_rays
from volumetric_renderer_torch.data.volume import Volume
from volumetric_renderer_torch.kernels import _build
from volumetric_renderer_torch.kernels.march import (
    march_forward,
    march_forward_plain,
)
from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer_torch.transfer.gradient import Gradient

ATOL = 1e-5
N, NTF, STEPS, H, W = 32, 32, 48, 40, 48
CASES = ["orient_30_20", "orient_120_-35", "orient_200_5", "orient_0_80",
         "early_termination", "slicing", "image_30x20", "close_wide_fov",
         "degenerate_window", "nan_voxel"]
# A random 4096-texel TF: 64 KiB of shared memory, past the 48 KB a launch
# gets without opting in.  Its steep lerp turns the last-ulp differences of
# another framework's trilinear sum into ~1e-4, so it is a kernel-only case.
KERNEL_CASES = CASES + ["tf_past_48k_shared_memory"]


def case_params(name):
    """One march case, made with NumPy from a seed (shared with
    ``test_torch_march.py``): grid, TF table, camera ``(yaw, pitch,
    radius)``, FoV, image ``(H, W)``, density window, slicing window, and
    the march settings."""
    rng = np.random.default_rng(11)
    c = dict(vol=Volume.synthetic_sphere(N).data, camera=(30.0, 20.0, 3.0),
             fov=40.0, hw=(H, W), window=(0.0, 1.0),
             slicing=((0, 0, 0), (1, 1, 1)), et=False)
    c["tf"] = Gradient.grayscale_ramp().discretize(NTF)
    c["tf"][:, 3] = np.linspace(0.0, 1.0, NTF, dtype=np.float32) ** 2
    if name.startswith("orient"):
        yaw, pitch = (float(v) for v in name.split("_")[1:])
        c["camera"] = (yaw, pitch, 3.0)
    elif name == "early_termination":
        c["et"] = True
    elif name == "slicing":
        c["slicing"] = ((0.1, 0.2, 0.0), (0.9, 1.0, 0.7))
    elif name == "image_30x20":
        c["hw"] = (30, 20)
    elif name == "close_wide_fov":
        c["camera"], c["fov"] = (30.0, 20.0, 0.9), 90.0
    elif name == "degenerate_window":
        c["vol"] = np.full((N, N, N), 0.25, np.float32)
        c["tf"] = rng.uniform(size=(NTF, 4)).astype(np.float32)
        c["window"] = (0.25, 0.25)
    elif name == "nan_voxel":
        c["vol"][1, 2, 3] = np.nan
        c["slicing"] = ((0.2, 0.2, 0.2), (0.8, 0.8, 0.8))
        c["et"] = True
    elif name == "tf_past_48k_shared_memory":
        c["tf"] = rng.uniform(size=(4096, 4)).astype(np.float32)
    c["march"] = dict(num_steps=STEPS, step_size=1.8 / STEPS,
                      early_termination=c["et"], termination_eps=1.0 / 255.0)
    return c


def case_inputs(name, device):
    """Prepared kernel inputs for one case, rays from the port's camera."""
    c = case_params(name)
    dev = torch.device(device)
    origin, dirs = ray_grid(OrbitCamera.from_angles(*c["camera"]).to(dev),
                            *c["hw"], fov_y_degrees=c["fov"])
    dmin, dmax = (torch.tensor(v, device=dev) for v in c["window"])
    pos0, hit, inv_w = prepare_rays(origin + 0.5, dirs, dmin, dmax)
    smin, smax = (torch.tensor(v, dtype=torch.float32, device=dev)
                  for v in c["slicing"])
    args = (torch.from_numpy(c["vol"]).to(dev),
            torch.from_numpy(c["tf"]).to(dev), pos0, dirs, hit, dmin, inv_w,
            smin, smax)
    return args, c["march"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_march_forward_on_cpu_is_the_plain_version(name):
    args, kw = case_inputs(name, "cpu")
    before = march_forward.launches
    got = march_forward(*args, **kw)
    assert march_forward.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  march_forward_plain(*args, **kw).numpy())
    assert torch.isfinite(got).all()


def fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def test_build_invokes_nvcc_once_per_source_and_flags(tmp_path, monkeypatch):
    """``_build.build`` compiles on first use with the sm_90a flags, keys
    the output on the source hash, reuses it, and raises with nvcc's output
    when nvcc fails (no fallback)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls"
    # a stand-in compiler: records its arguments, writes the -o target
    fake_nvcc(bindir / "nvcc",
              f'echo "$@" >> {calls}\n'
              'while [ "$1" != "-o" ]; do shift; done\n'
              'echo lib > "$2"\necho "ptxas info    : Used 9 registers" >&2\n')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))

    first = _build.build("march_fwd")
    assert first.path.startswith(str(tmp_path / "build"))
    assert os.path.exists(first.path) and "Used 9 registers" in first.log
    args = calls.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args and "-fmad=false" in args
    assert "--use_fast_math" not in args
    assert args[-1].endswith(os.path.join("csrc", "march_fwd.cu"))

    again = _build.build("march_fwd")
    assert again.path == first.path and again.seconds == 0.0
    assert len(calls.read_text().splitlines()) == 1

    fake_nvcc(bindir / "nvcc", 'echo "error: bad kernel" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build2"))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build("march_fwd")


def test_march_forward_has_no_kernel_for_other_devices():
    args, kw = case_inputs("orient_30_20", "cpu")
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        march_forward(*meta, **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_matches_plain_on_cuda(cuda, name):
    args, kw = case_inputs(name, cuda)
    before = march_forward.launches
    got = march_forward(*args, **kw)
    assert march_forward.launches == before + 1
    want = march_forward_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    args, kw = case_inputs("orient_30_20", cuda)
    vol, tf, pos0, dirs, hit = args[:5]
    rest = args[5:]
    with pytest.raises(NotImplementedError, match="K2"):
        march_forward(vol.clone().requires_grad_(True), *args[1:], **kw)
    with pytest.raises(TypeError, match="float32"):
        march_forward(vol.double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        march_forward(vol.transpose(0, 2), *args[1:], **kw)
    with pytest.raises(ValueError, match="hit"):
        march_forward(vol, tf, pos0, dirs, hit[:-1], *rest, **kw)
    with pytest.raises(ValueError, match="devices"):
        march_forward(vol, tf.cpu(), pos0, dirs, hit, *rest, **kw)
    huge_tf = torch.zeros((1 << 16, 4), device=cuda)   # 1 MiB of TF
    with pytest.raises(ValueError, match="shared memory"):
        march_forward(vol, huge_tf, pos0, dirs, hit, *rest, **kw)
