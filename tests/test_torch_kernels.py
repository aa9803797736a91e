"""The ray-march kernels, forward (K1) and backward (K2): their build step
and wrappers on any machine, and the kernels themselves against their plain
PyTorch versions on a CUDA card (tests marked ``cuda``; they skip without
one).

This file imports neither JAX nor the JAX package, so the ``cuda`` tests
also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

Tolerances on the card: K1 atol 1e-5 (it repeats the plain version's float
operations in the same order and is built with -fmad=false, so the two agree
bit for bit in practice); K2 atol 1e-4 / rtol 1e-5 (its gradients are sums
that f32 atomics take in another order on every run); render gradients
through K1 + K2 against oracle autograd atol 1e-4 (the oracle has no
``ALPHA_EPS`` clamp).
"""

import os
import shutil
import stat

import numpy as np
import pytest
import torch

from volumetric_renderer_torch.core.marcher import prepare_rays
from volumetric_renderer_torch.data.volume import Volume
from volumetric_renderer_torch.core.fused import make_fused_marcher
from volumetric_renderer_torch.kernels import _build, march
from volumetric_renderer_torch.kernels.march import (
    make_kernel_marcher,
    march_backward,
    march_backward_plain,
    march_forward,
    march_forward_plain,
)
from volumetric_renderer_torch.render.api import render
from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils.config import RenderSettings

ATOL = 1e-5
BWD_ATOL, BWD_RTOL = 1e-4, 1e-5
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


def cotangent(args, seed=7):
    """A cotangent of the march output ``(H, W, 4)``, drawn with NumPy."""
    h, w = args[2].shape[:2]
    g = np.random.default_rng(seed).normal(size=(h, w, 4)).astype(np.float32)
    return torch.from_numpy(g).to(args[0].device)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_march_backward_on_cpu_is_the_plain_version(name):
    args, kw = case_inputs(name, "cpu")
    out = march_forward_plain(*args, **kw)
    g = cotangent(args)
    before = march_backward.launches
    got = march_backward(*args, out, g, **kw)
    assert march_backward.launches == before
    want = march_backward_plain(*args, out, g, **kw)
    assert [tuple(x.shape) for x in got] == [tuple(args[0].shape),
                                             tuple(args[1].shape), (), ()]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert torch.isfinite(a).all()


def leaf_grads(marcher, name, device):
    """``(img, [vol_g, tf_g, dmin_g, dmax_g])`` of ``sum(img * g)`` for one
    case, through ``marcher`` (a fused or kernel marcher)."""
    c = case_params(name)
    dev = torch.device(device)
    origin, dirs = ray_grid(OrbitCamera.from_angles(*c["camera"]).to(dev),
                            *c["hw"], fov_y_degrees=c["fov"])
    leaves = [torch.from_numpy(c["vol"]).to(dev),
              torch.from_numpy(c["tf"]).to(dev),
              torch.tensor(c["window"][0], device=dev),
              torch.tensor(c["window"][1], device=dev)]
    for x in leaves:
        x.requires_grad_(True)
    smin, smax = (torch.tensor(v, dtype=torch.float32, device=dev)
                  for v in c["slicing"])
    img = marcher(**c["march"])(leaves[0], leaves[1], origin + 0.5, dirs,
                                leaves[2], leaves[3], smin, smax)
    img.backward(cotangent([img, None, dirs]))
    return img.detach(), [x.grad for x in leaves]


def test_kernel_marcher_on_cpu_is_the_fused_marcher():
    """On CPU tensors the K1 + K2 Function runs the plain versions: the same
    image and gradients as the fused marcher, bit for bit."""
    before = (march_forward.launches, march_backward.launches)
    img, got = leaf_grads(make_kernel_marcher, "slicing", "cpu")
    assert (march_forward.launches, march_backward.launches) == before
    img_f, want = leaf_grads(make_fused_marcher, "slicing", "cpu")
    np.testing.assert_array_equal(img.numpy(), img_f.numpy())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def test_build_invokes_nvcc_once_per_source_and_flags(tmp_path, monkeypatch):
    """``_build.build`` compiles on first use with the sm_90a flags, keys
    the output on the hash of the source and its headers, reuses it, builds
    again exactly once after a header changes, and raises with nvcc's output
    when nvcc fails (no fallback)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
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

    # a touched shared header rebuilds both kernels, each exactly once
    with open(csrc / "march_common.cuh", "a") as f:
        f.write("// touched\n")
    touched = _build.build("march_fwd")
    assert touched.path != first.path
    assert _build.build("march_fwd").path == touched.path
    assert len(calls.read_text().splitlines()) == 2
    bwd = _build.build("march_bwd")
    assert _build.build("march_bwd").path == bwd.path
    assert len(calls.read_text().splitlines()) == 3
    assert calls.read_text().split()[-1].endswith("march_bwd.cu")

    fake_nvcc(bindir / "nvcc", 'echo "error: bad kernel" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build2"))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build("march_fwd")


def test_march_forward_has_no_kernel_for_other_devices():
    args, kw = case_inputs("orient_30_20", "cpu")
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        march_forward(*meta, **kw)
    out = torch.zeros(args[2].shape[:2] + (4,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        march_backward(*meta, out, out, **kw)


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
@pytest.mark.parametrize("name", KERNEL_CASES)
def test_backward_kernel_matches_plain_on_cuda(cuda, name):
    args, kw = case_inputs(name, cuda)
    out = march_forward(*args, **kw)
    g = cotangent(args)
    before = march_backward.launches
    got = march_backward(*args, out, g, **kw)
    assert march_backward.launches == before + 1
    want = march_backward_plain(*args, out, g, **kw)
    torch.cuda.synchronize()
    for what, a, b in zip(("vol", "tf", "dmin", "dmax"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, what
        assert torch.isfinite(a).all(), what
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=BWD_ATOL, rtol=BWD_RTOL,
                                   err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("n,steps,et", [(8, 12, False), (12, 20, True),
                                        (12, 20, False)])
def test_render_kernel_grads_match_oracle_on_cuda(cuda, n, steps, et):
    """K1 + K2 through ``render(method="kernel")`` against plain autograd
    through ``render(method="oracle")`` on the card."""
    vol = Volume.synthetic_sphere(n).as_torch(cuda)
    tf = Gradient.grayscale_ramp().discretize(8)
    tf[:, 3] = np.linspace(0.0, 1.0, 8, dtype=np.float32) ** 2
    tf = torch.from_numpy(tf).to(cuda)
    cam = OrbitCamera.from_angles(120.0, -35.0)
    settings = RenderSettings(height=16, width=16, step_size=1.8 / steps,
                              early_termination=et)
    grads = {}
    launches = (march_forward.launches, march_backward.launches)
    for method in ("oracle", "kernel"):
        leaves = [vol.clone().requires_grad_(True),
                  tf.clone().requires_grad_(True),
                  torch.tensor(0.0, device=cuda, requires_grad=True),
                  torch.tensor(1.0, device=cuda, requires_grad=True)]
        img = render(leaves[0], leaves[1], cam, settings,
                     density_min=leaves[2], density_max=leaves[3],
                     method=method)
        (img ** 2).sum().backward()
        grads[method] = [x.grad.cpu().numpy() for x in leaves]
    assert (march_forward.launches, march_backward.launches) == \
        (launches[0] + 1, launches[1] + 1)
    for what, a, b in zip(("vol", "tf", "dmin", "dmax"), grads["kernel"],
                          grads["oracle"]):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=what)


@pytest.mark.cuda
def test_failing_backward_launch_raises(cuda, monkeypatch):
    """A CUDA error from the K2 launch raises; nothing falls back to the
    plain version and the launch is not counted."""
    args, kw = case_inputs("orient_30_20", cuda)
    out = march_forward(*args, **kw)
    lib = march.load_library("march_bwd")
    monkeypatch.setattr(lib, "march_bwd_launch", lambda *a: 700)
    monkeypatch.setattr(march, "march_backward_plain", None)
    before = march_backward.launches
    with pytest.raises(RuntimeError, match="march_bwd: launch failed: CUDA "
                                           "error 700"):
        march_backward(*args, out, cotangent(args), **kw)
    assert march_backward.launches == before


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    args, kw = case_inputs("orient_30_20", cuda)
    vol, tf, pos0, dirs, hit = args[:5]
    rest = args[5:]
    # the output of march_forward carries no graph: differentiate through
    # the K1 + K2 Function instead
    with pytest.raises(RuntimeError, match="make_kernel_marcher"):
        march_forward(vol.clone().requires_grad_(True), *args[1:], **kw)
    with torch.no_grad():
        march_forward(vol.clone().requires_grad_(True), *args[1:], **kw)
    out = march_forward(*args, **kw)
    g = cotangent(args)
    with pytest.raises(ValueError, match="out must be"):
        march_backward(*args, out[:-1], g, **kw)
    with pytest.raises(TypeError, match="float32"):
        march_backward(*args, out, g.double(), **kw)
    with pytest.raises(ValueError, match="shared memory"):
        march_backward(vol, torch.zeros((5000, 4), device=cuda), pos0, dirs,
                       hit, *rest, out, g, **kw)
    # a non-contiguous cotangent (the grad of a slice) is made contiguous
    got = march_backward(*args, out, torch.cat([g, g], -1)[..., ::2], **kw)
    assert torch.isfinite(got[0]).all()
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
