"""The ray-march kernels, forward (K1) and backward (K2), and the depth
fold's kernels (``csrc/fold.cu``): their build step and wrappers on any
machine, the CUDA sources compiled by g++ for the CPU, and the kernels
themselves against their plain PyTorch versions on a CUDA card (tests
marked ``cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so the ``cuda`` tests
also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

Tolerances on the card: K1 atol 1e-5 (it repeats the plain version's float
operations in the same order and is built with -fmad=false, so the two agree
bit for bit in practice); K2 atol 1e-4 / rtol 1e-5 (its gradients are sums
that f32 atomics take in another order on every run); render gradients
through K1 + K2 against oracle autograd atol 1e-4 (the oracle has no
``ALPHA_EPS`` clamp).  The same bars hold on depth chunks (``own``), which
``tests/test_torch_depth.py`` holds to the JAX package's whole-volume
render on the CPU.  The fold: forward ``torch.equal`` to its plain version
(the same operations in the same order, -fmad=false), each chunk's
backward within ``1e-6 * max|grad|`` of its plain version (the bar of
``tests/test_torch_fold.py`` against autograd).
"""

import ctypes
import os
import re
import shutil
import stat
import subprocess
import time
import weakref

import numpy as np
import pytest
import torch

from volumetric_renderer_torch.core.marcher import prepare_rays
from volumetric_renderer_torch.data.volume import Volume
from volumetric_renderer_torch.core.fused import make_fused_marcher
from volumetric_renderer_torch.kernels import _build, march
from volumetric_renderer_torch.kernels import fold as kfold
from volumetric_renderer_torch.kernels.march import (
    make_kernel_marcher,
    march_backward,
    march_backward_plain,
    march_forward,
    march_forward_plain,
)
from volumetric_renderer_torch.parallel.depth import chunk_of
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
    elif name.startswith("image_"):
        c["hw"] = tuple(int(v) for v in name[6:].split("x"))
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
    elif name == "graze_faces":
        # looking straight at a face: the silhouette rays run along the
        # four side faces, where K1 takes its border path
        c["camera"] = (0.0, 0.0, 3.0)
    elif name == "graze_corner":
        # looking down the cube's diagonal, at a corner
        c["camera"] = (45.0, 35.26, 3.0)
    elif name == "grid_2":
        c["vol"] = rng.uniform(size=(2, 2, 2)).astype(np.float32)
    elif name == "close_wide_fov_et":
        c["camera"], c["fov"], c["et"] = (30.0, 20.0, 0.9), 90.0, True
    elif name.startswith("near_constant"):
        # every sample inside the grid lands on the same two TF texels, so
        # one TF-gradient run spans all of a ray's steps on a chunk
        c["vol"] = (0.5 + 1e-3 * rng.uniform(-1.0, 1.0, (N, N, N))).astype(
            np.float32)
        if name == "near_constant_et":
            # opaque enough that T falls below eps within a quarter's steps
            c["tf"][:, 3] = np.linspace(0.6, 0.8, NTF, dtype=np.float32)
            c["et"] = True
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


# depth chunks: (view, axis, chunks, chunk) -- one view marching each way
OWN_CASES = [(name, axis, n, c) for name in ("orient_30_20", "orient_200_5")
             for axis in (0, 1, 2) for n in (2, 4) for c in (0, n - 1)]


def own_inputs(name, axis, n, c, device):
    """Case ``name`` with its grid cut to chunk ``c`` of ``n`` along
    ``axis``, and the chunk's ownership range."""
    args, kw = case_inputs(name, device)
    body = N // n
    return ((chunk_of(args[0], c, body, axis),) + args[1:],
            dict(kw, own=(axis, c * body, body, N)))


@pytest.mark.parametrize("name,axis,n,c", OWN_CASES[::5])
def test_march_with_own_on_cpu_is_the_plain_version(name, axis, n, c):
    args, kw = own_inputs(name, axis, n, c, "cpu")
    before = (march_forward.launches, march_backward.launches)
    got = march_forward(*args, **kw)
    want = march_forward_plain(*args, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    g = cotangent(args)
    for a, b in zip(march_backward(*args, got, g, **kw),
                    march_backward_plain(*args, got, g, **kw)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (march_forward.launches, march_backward.launches) == before
    bad = dict(kw, own=(axis, 0, N // n + 1, N))      # no halo row
    with pytest.raises(ValueError, match="halo"):
        march_forward(*args, **bad)


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


# -- the CUDA sources compiled for the CPU -------------------------------------

SHIM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cuda_on_cpu")


def compile_for_cpu(src_path, out_dir, *flags):
    """``src_path`` (a CUDA source) compiled by g++ against the CPU
    stand-in for the CUDA runtime (``tests/cuda_on_cpu/cuda_runtime.h``)
    into a shared library under ``out_dir``; returns its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    with open(src_path) as f:
        src = f.read()
    src = re.sub(r"(\w+)<<<([^,]+), ([^,]+), .*>>>\(",
                 r"emul::Launch(\2, \3)(\1, ", src)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"static \1 \2[1 << 17];", src)
    stem = os.path.splitext(os.path.basename(src_path))[0] + "".join(
        f.lstrip("-").replace("=", "_") for f in flags)
    cpp, lib = out_dir / f"{stem}.cpp", out_dir / f"lib{stem}.so"
    cpp.write_text(src)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", f"-I{SHIM_DIR}", f"-I{_build.CSRC_DIR}", *flags,
         "-o", str(lib), str(cpp)], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return str(lib)


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """K1 and K2 from ``csrc/`` compiled by g++ for the CPU, bound as
    ``kernels/march.py`` binds the nvcc builds."""
    out = tmp_path_factory.mktemp("cuda_on_cpu")
    libs = {name: march._bind(name, ctypes.CDLL(compile_for_cpu(
        os.path.join(_build.CSRC_DIR, name + ".cu"), out)))
        for name in ("march_fwd", "march_bwd")}
    # the stand-in's record of K2's walk (k2_walks)
    lib = libs["march_bwd"]
    lib.emul_walk_reset.restype = lib.emul_walks.restype = None
    lib.emul_walks.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 3
    return libs


@pytest.fixture(scope="module")
def cpu_fold(tmp_path_factory):
    """``csrc/fold.cu`` compiled by g++ for the CPU, bound as
    ``kernels/fold.py`` binds the nvcc build."""
    return kfold._bind(ctypes.CDLL(compile_for_cpu(
        os.path.join(_build.CSRC_DIR, "fold.cu"),
        tmp_path_factory.mktemp("fold_on_cpu"))))


FOLD_REL = 1e-6


def fold_inputs(n, rays, device="cpu", seed=0):
    """``(parts (n, rays, 4), dirs (rays, 3), g (rays, 4))`` from a seed:
    premultiplied partials, directions of both signs on every axis."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.0, 0.999, size=(n, rays, 1))
    parts = np.concatenate([alpha * rng.uniform(size=(n, rays, 3)), alpha],
                           -1)
    dirs = rng.normal(size=(rays, 3))
    g = rng.normal(size=(rays, 4))
    return tuple(torch.as_tensor(x.astype(np.float32), device=device)
                 for x in (parts, dirs, g))


def cpu_fold_launch(lib, parts, dirs, axis, g=None, r=0):
    """The fold (``g`` None) or chunk ``r``'s backward on CPU tensors,
    through the C interface the wrapper calls."""
    n, rays = parts.shape[:2]
    out = torch.empty((rays, 4))
    if g is None:
        code = lib.fold_fwd_launch(0, parts.data_ptr(), n, rays,
                                   dirs.data_ptr(), axis, out.data_ptr(),
                                   None)
    else:
        code = lib.fold_bwd_launch(0, parts.data_ptr(), n, rays,
                                   dirs.data_ptr(), axis, g.data_ptr(), r,
                                   out.data_ptr(), None)
    assert code == 0
    return out


def assert_fold_grad_close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0,
                               atol=FOLD_REL * float(want.abs().max()))


@pytest.mark.parametrize("rays", [256, 300, 1])
@pytest.mark.parametrize("axis", [0, 2])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_fold_source_compiled_for_cpu_matches_plain(cpu_fold, n, axis, rays):
    """``csrc/fold.cu``, compiled by g++ for the CPU, against the plain
    versions: the fold bit for bit, each chunk's backward within
    ``1e-6 * max|grad|``; ray counts of one block of 256, of one and a
    part (the last block masked) and of one ray."""
    parts, dirs, g = fold_inputs(n, rays, seed=n + rays)
    if rays > 1:
        d = dirs[:, 2 - axis]
        assert bool((d < 0).any()) and bool((d > 0).any())
    got = cpu_fold_launch(cpu_fold, parts, dirs, axis)
    assert torch.equal(got, kfold.fold_forward_plain(parts, dirs, axis))
    for r in range(n):
        assert_fold_grad_close(
            cpu_fold_launch(cpu_fold, parts, dirs, axis, g, r),
            kfold.fold_backward_plain(parts, dirs, axis, g, r))


# The stand-in's barrier timeout for the fault cases below, in seconds.
FAULT_TIMEOUT_S = 2


@pytest.fixture(scope="module")
def fault_kernels(tmp_path_factory):
    lib = ctypes.CDLL(compile_for_cpu(
        os.path.join(SHIM_DIR, "collective_faults.cu"),
        tmp_path_factory.mktemp("cuda_on_cpu_faults"),
        f"-DEMUL_BARRIER_TIMEOUT_MS={FAULT_TIMEOUT_S * 1000}"))
    lib.one_warp_launch.restype = ctypes.c_int
    lib.one_warp_launch.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
    return lib


@pytest.mark.parametrize("which,code,value", [
    (0, 0, -1),     # all 32 lanes vote: every bit set
    (1, 702, 0),    # lane 0 alone: cudaErrorLaunchTimeout, no hang
    (2, 0, 31)])    # lane 0 returns before __syncthreads: no hang
def test_cpu_stand_in_fails_a_skipped_collective_instead_of_hanging(
        fault_kernels, which, code, value):
    """A warp collective that one lane calls alone fails its launch within
    the stand-in's barrier timeout, and the process goes on; a thread that
    returns early holds up no later ``__syncthreads``."""
    out = ctypes.c_int(0)
    t0 = time.perf_counter()
    got = fault_kernels.one_warp_launch(which, ctypes.byref(out))
    assert time.perf_counter() - t0 < FAULT_TIMEOUT_S + 10
    assert (got, out.value) == (code, value)


def cpu_launch(libs, args, kw, out=None, g=None, shared_table=False,
               counts=None):
    """K1 (``out`` None) or K2 on CPU tensors, through the C interface the
    wrapper calls; returns what ``march_forward`` / ``march_backward``
    would.  K2 sums its TF gradient in shared memory first with
    ``shared_table``, and adds into 3 copies of it in any case.  With
    ``counts``, the address of the kernel's slots in a counter buffer
    (``march.KernelCounts.pointer``), the launch runs the kernel's counted
    instantiation, which adds to them."""
    vol, tf, pos0, dirs, hit = args[:5]
    h, w = pos0.shape[:2]
    own = march._own_args("cpu_launch", kw.get("own"), vol)
    window = march._window("cpu_launch", "cpu", *args[5:])
    steps = (kw["num_steps"], kw["step_size"], int(kw["early_termination"]),
             kw["termination_eps"], 1.0 - march.ALPHA_EPS)
    tail = (*vol.shape, *own, tf.data_ptr(), tf.shape[0])
    rays = (0, pos0.data_ptr(), dirs.data_ptr(), hit.data_ptr())
    if out is None:
        lib = libs["march_fwd"]
        handle, tex = ctypes.c_void_p(), ctypes.c_ulonglong()
        assert lib.march_fwd_texture_alloc(0, *vol.shape, ctypes.byref(handle),
                                           ctypes.byref(tex)) == 0
        assert lib.march_fwd_texture_fill(handle, vol.data_ptr(), None) == 0
        res = torch.empty((h, w, 4))
        code = lib.march_fwd_launch(*rays, tex.value, *tail, res.data_ptr(),
                                    h, w, window.data_ptr(), *steps, counts,
                                    None)
        assert lib.march_fwd_texture_free(handle) == 0
        assert code == 0
        return res
    head = (*rays, vol.data_ptr(), *tail)
    g = g.contiguous()
    vol_g = torch.zeros_like(vol)
    tf_g = torch.zeros((3,) + tuple(tf.shape), dtype=torch.float64)
    win_g = torch.zeros(2, dtype=torch.float64)
    code = libs["march_bwd"].march_bwd_launch(
        *head, out.data_ptr(), g.data_ptr(), vol_g.data_ptr(),
        tf_g.data_ptr(), 3, int(shared_table), win_g.data_ptr(), h, w,
        window.data_ptr(), *steps, march.ALPHA_EPS, counts, None)
    assert code == 0
    win_g = win_g.float()
    return vol_g, tf_g.sum(0).float(), win_g[0], win_g[1]


@pytest.mark.parametrize("table", ["shared", "global"])
@pytest.mark.parametrize("name,own", [
    ("orient_30_20", None), ("early_termination", None), ("slicing", None),
    ("nan_voxel", None), ("orient_30_20", (0, 2, 1)),
    ("orient_200_5", (1, 4, 0)), ("orient_200_5", (2, 4, 3)),
    # K2's warp-wide TF flush: every lane of a warp on one texel, lanes
    # outside the image, a wide fan of rays, 4096 texels, on chunks too
    ("degenerate_window", None), ("image_30x20", None),
    ("close_wide_fov", None), ("tf_past_48k_shared_memory", None),
    ("close_wide_fov", (0, 4, 1)), ("image_30x20", (2, 2, 0)),
    # K1's border path: rays along the faces and at a corner, a grid of 2^3,
    # a camera close in with early termination
    ("graze_faces", None), ("graze_corner", None), ("grid_2", None),
    ("close_wide_fov_et", None),
    # K1's step interval of a chunk: every axis, both view directions, rays
    # whose interval is empty (graze_faces along x), early termination
    ("graze_faces", (2, 4, 1)), ("graze_faces", (0, 4, 2)),
    ("orient_30_20", (2, 4, 2)), ("orient_200_5", (1, 4, 2)),
    ("early_termination", (1, 4, 1)), ("early_termination", (0, 4, 2)),
    ("graze_corner", (1, 4, 3)),
    # K2's step interval of a chunk (test_k2_chunk_edge_cases_reach_their_
    # edge checks that each case gets there): a TF run still open
    # where the interval ends, the first chunk's border samples, early
    # termination on a chunk past the first, warps whose every lane has an
    # empty interval
    ("near_constant", (0, 4, 1)), ("near_constant", (2, 4, 2)),
    ("near_constant", (1, 4, 0)), ("near_constant_et", (0, 4, 2)),
    ("near_constant_et", (1, 4, 1)), ("graze_faces", (2, 4, 3))])
def test_kernel_sources_compiled_for_cpu_match_plain(cpu_kernels, name,
                                                     own, table):
    """The CUDA sources, compiled by g++ for the CPU, against the plain
    versions: K1 bit for bit, K2 within its bars with its TF gradient
    summed in either table (shared memory, or global memory directly), on
    the whole volume and on depth chunks ``own = (axis, chunks, chunk)``."""
    if own is None:
        args, kw = case_inputs(name, "cpu")
    else:
        args, kw = own_inputs(name, *own, "cpu")
    got = cpu_launch(cpu_kernels, args, kw)
    want = march_forward_plain(*args, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    g = cotangent(args)
    for what, a, b in zip(("vol", "tf", "dmin", "dmax"),
                          cpu_launch(cpu_kernels, args, kw, want, g,
                                     shared_table=table == "shared"),
                          march_backward_plain(*args, want, g, **kw)):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=what)


def test_k2_occupancy_is_queried_once_per_device_and_tf_size(cpu_kernels,
                                                             monkeypatch):
    """``_one_wave`` asks the library for K2's occupancy once per ``(device,
    TF texels)`` and keeps the answer: two launches make one query."""
    lib = cpu_kernels["march_bwd"]
    query, queries = lib.march_bwd_occupancy, []

    def counted(*args):
        queries.append(args[:2])
        return query(*args)

    monkeypatch.setattr(lib, "march_bwd_occupancy", counted)
    monkeypatch.setattr(march, "_waves", {})
    first = march._one_wave(lib, 0, NTF)
    assert first > 0 and march._one_wave(lib, 0, NTF) == first
    assert queries == [(0, NTF)]
    march._one_wave(lib, 0, 2 * NTF)
    march._one_wave(lib, 0, 2 * NTF)
    assert queries == [(0, NTF), (0, 2 * NTF)]


def owned_steps_proxy(pos0, dirs, own, num_steps: int, step_size: float):
    """Each ray's steps ``[k_begin, k_end)`` on the depth chunk ``own``, as
    ``csrc/march_common.cuh:owned_steps`` computes them, in float32 NumPy
    (the same operations, so the same bits); ``[0, num_steps)`` for the
    whole volume (``own`` None)."""
    if own is None:
        shape = pos0.shape[:-1]
        return np.zeros(shape, int), np.full(shape, num_steps)
    f = np.float32
    axis, a_start, body, n_total = own
    o = pos0[..., 2 - axis].numpy()
    per_step = dirs[..., 2 - axis].numpy() * f(step_size)
    u0 = (f(-1 if a_start == 0 else a_start) + f(0.5)) / f(n_total) - f(1e-5)
    u1 = (f(a_start + body) + f(0.5)) / f(n_total) + f(1e-5)
    with np.errstate(divide="ignore", invalid="ignore"):
        ka, kb = (u0 - o) / per_step, (u1 - o) / per_step
    k_begin = np.clip(np.floor(np.minimum(ka, kb)) - 1, 0, num_steps)
    k_end = np.clip(np.ceil(np.maximum(ka, kb)) + 1, 0, num_steps)
    keep = (per_step == 0) | np.isnan(ka) | np.isnan(kb)
    k_begin = np.where(keep, 0, k_begin).astype(int)
    return k_begin, np.maximum(np.where(keep, num_steps, k_end),
                               k_begin).astype(int)


def test_chunk_cases_have_rays_with_an_empty_step_interval():
    """The chunk cases above reach K1's empty step interval: hit rays that
    walk no step of the chunk at all (by ``owned_steps_proxy``)."""
    args, kw = own_inputs("graze_faces", 2, 4, 1, "cpu")
    k_begin, k_end = owned_steps_proxy(args[2], args[3], kw["own"],
                                       kw["num_steps"], kw["step_size"])
    hit = args[4].numpy()
    assert ((k_end == k_begin) & hit).sum() > 100
    assert ((k_end - k_begin > 0) & hit).sum() > 100


def k2_walks(libs, args, kw):
    """``(first, last, count)`` per pixel: the steps K2 (the g++ build)
    walked on each ray in one launch, as the CPU stand-in records them
    (``MARCH_WALKED_STEP``); -1, -1, 0 where a ray walked none."""
    lib = libs["march_bwd"]
    lib.emul_walk_reset()
    cpu_launch(libs, args, kw, march_forward_plain(*args, **kw),
               cotangent(args))
    hit = args[4]
    walks = [np.empty(hit.shape, np.int32) for _ in range(3)]
    lib.emul_walks(hit.numel(), *(w.ctypes.data for w in walks))
    return walks


@pytest.mark.parametrize("name,own", [
    ("orient_30_20", None), ("early_termination", None),
    ("graze_faces", (2, 4, 1)), ("graze_faces", (2, 4, 3)),
    ("near_constant", (0, 4, 1)), ("near_constant", (1, 4, 0)),
    ("near_constant_et", (0, 4, 2)), ("orient_200_5", (1, 4, 2)),
    ("close_wide_fov", (0, 4, 1))])
def test_k2_walks_only_the_steps_of_owned_steps(cpu_kernels, name, own):
    """K2's walk, recorded by the CPU stand-in: each hit ray starts at its
    own ``k_begin`` of ``owned_steps`` (``owned_steps_proxy``; 0 on the
    whole volume), walks consecutive steps and stops before ``k_end``; a ray
    whose interval is empty, or that misses the box, walks none.  A K2 that
    walks from k = 0 on a chunk fails here."""
    args, kw = (case_inputs(name, "cpu") if own is None
                else own_inputs(name, *own, "cpu"))
    first, last, count = k2_walks(cpu_kernels, args, kw)
    k_begin, k_end = owned_steps_proxy(args[2], args[3], kw.get("own"),
                                       kw["num_steps"], kw["step_size"])
    hit = args[4].numpy()
    walks = hit & (k_end > k_begin)
    assert (count[~walks] == 0).all()
    assert (count[walks] >= 1).all()
    np.testing.assert_array_equal(first[walks], k_begin[walks])
    np.testing.assert_array_equal(count[walks],
                                  last[walks] - first[walks] + 1)
    assert (last[walks] < k_end[walks]).all()
    if own is not None:
        # rays a walk from step 0 would get wrong: they start past it, or
        # own no step at all
        assert (hit & ((k_begin > 0) | (k_end == k_begin))).sum() > 100


def test_k2_chunk_edge_cases_reach_their_edge():
    """The chunk cases added for K2's interval reach what they are there
    for (``owned_steps_proxy`` and the plain forward, in NumPy): a warp
    of hit rays whose every lane has an empty interval; on the
    near-constant grid, one TF texel pair for every voxel; the first
    chunk's samples at lower corner -1; early termination inside a chunk
    past the first."""
    # a warp (2 rows of a 16x16 block) of hit rays, all with empty intervals
    args, kw = own_inputs("graze_faces", 2, 4, 3, "cpu")
    k_begin, k_end = owned_steps_proxy(args[2], args[3], kw["own"],
                                       kw["num_steps"], kw["step_size"])
    hit = args[4].numpy()
    h, w = hit.shape
    rows = -(-h // 2) * 2
    empty = np.ones((rows, -(-w // 16) * 16), bool)
    empty[:h, :w] = k_end <= k_begin
    some_hit = np.zeros_like(empty)
    some_hit[:h, :w] = hit

    def warps(a):
        return a.reshape(rows // 2, 2, -1, 16).transpose(0, 2, 1, 3) \
            .reshape(rows // 2, -1, 32)

    assert (warps(empty).all(-1) & warps(some_hit).any(-1)).sum() >= 4
    # one TF texel pair on the near-constant grid
    vol = case_params("near_constant")["vol"]
    assert np.unique(np.floor(vol * np.float32(NTF) - 0.5)).tolist() == [15]
    # samples of the first chunk at lower corner -1 along its axis (y)
    args, kw = own_inputs("near_constant", 1, 4, 0, "cpu")
    k = np.arange(kw["num_steps"], dtype=np.float32)
    pos = (args[2].numpy()[..., None, :] + (k * np.float32(kw["step_size"]))
           [:, None] * args[3].numpy()[..., None, :])
    inside = ((pos >= 0) & (pos <= 1)).all(-1) & args[4].numpy()[..., None]
    corner = np.floor(pos[..., 1] * np.float32(N) - 0.5)
    assert (inside & (corner == -1)).sum() > 100
    # early termination inside chunk 2 of 4 along z: T <= eps on many rays
    args, kw = own_inputs("near_constant_et", 0, 4, 2, "cpu")
    alpha = march_forward_plain(*args, **kw)[..., 3].numpy()
    assert (alpha >= 1.0 - kw["termination_eps"]).sum() > 100


class _FakeTextureLib:
    """The texture entry points of K1's library, recording their calls."""

    def __init__(self):
        self.calls = []

    def march_fwd_texture_alloc(self, dev, nz, ny, nx, handle, tex):
        self.calls.append(("alloc", (nz, ny, nx)))
        handle._obj.value = tex._obj.value = len(self.calls)
        return 0

    def march_fwd_texture_fill(self, handle, ptr, stream):
        self.calls.append(("fill", handle.value))
        return 0

    def march_fwd_texture_free(self, handle):
        self.calls.append(("free", handle.value))
        return 0


class _FakeEvent:
    waits = 0

    def synchronize(self):
        _FakeEvent.waits += 1


class _FakeStream:
    def wait_event(self, event):
        pass


def test_k1_texture_cache_copies_when_the_grid_changes(monkeypatch):
    """``_grid_texture``'s bookkeeping, on CPU tensors with the library's
    texture calls recorded: a grid is copied in again after an in-place
    change, for another tensor, for a tensor at a freed grid's address and
    at every launch on an inference tensor; shapes taken in turns keep
    their arrays, and a shape past ``TEXTURES_PER_DEVICE`` frees the least
    recently used one, after waiting for the launches that read it."""
    monkeypatch.setattr(march, "_textures", {})
    monkeypatch.setattr(march.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(march.torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(_FakeEvent, "waits", 0)
    lib = _FakeTextureLib()

    def launch(vol):
        n = len(lib.calls)
        march._grid_texture(lib, 0, vol, None)
        return [c[0] for c in lib.calls[n:]]

    vol = torch.rand(4, 5, 6)
    assert launch(vol) == ["alloc", "fill"]
    assert launch(vol) == [] and launch(vol.detach()) == []
    vol.mul_(0.5)                               # in place: copied again
    assert launch(vol) == ["fill"] and launch(vol) == []
    other = vol.clone()
    assert launch(other) == ["fill"]            # another tensor
    assert launch(vol) == ["fill"]
    assert launch(vol.view(5, 4, 6)) == ["alloc", "fill"]  # another shape
    assert launch(vol) == []                    # ... and back: still copied
    gone = weakref.ref(other)
    del other
    assert gone() is None                       # the cache holds no grid
    # a new tensor, at the freed grid's address where the allocator gives
    # that again, with the same version
    assert launch(torch.empty(4, 5, 6)) == ["fill"]
    with torch.inference_mode():
        inf = torch.rand(4, 5, 6)
    assert launch(inf) == ["fill"] and launch(inf) == ["fill"]
    assert _FakeEvent.waits == 0
    for n in range(1, march.TEXTURES_PER_DEVICE - 1):
        launch(torch.rand(n, 2, 2))
    assert len(march._textures[0]) == march.TEXTURES_PER_DEVICE
    oldest = march._textures[0][(5, 4, 6)].handle.value
    assert launch(torch.rand(9, 2, 2)) == ["free", "alloc", "fill"]
    assert _FakeEvent.waits == 1 and ("free", oldest) in lib.calls
    assert (5, 4, 6) not in march._textures[0] and \
        (4, 5, 6) in march._textures[0]


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
@pytest.mark.parametrize("name,shared_table", [("orient_30_20", False),
                                               ("image_288x288", True)])
def test_backward_kernel_tf_tables_on_cuda(cuda, name, shared_table):
    """K2 adds its TF gradient to global memory directly in a launch of at
    most one wave of blocks (40x48 pixels: 9 blocks) and sums it per block
    in shared memory first in a larger one (288x288: 324 blocks, more than
    an H100 runs at once): both against the plain version."""
    args, kw = case_inputs(name, cuda)
    h, w = args[2].shape[:2]
    lib = march.load_library("march_bwd")
    wave = march._one_wave(lib, torch.cuda.current_device(), NTF)
    assert (-(-h // 16) * -(-w // 16) > wave) == shared_table
    out = march_forward(*args, **kw)
    g = cotangent(args)
    got = march_backward(*args, out, g, **kw)
    want = march_backward_plain(*args, out, g, **kw)
    for what, a, b in zip(("vol", "tf", "dmin", "dmax"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=BWD_ATOL, rtol=BWD_RTOL,
                                   err_msg=what)


@pytest.mark.cuda
def test_kernels_launch_without_host_sync(cuda):
    """K1 and K2 take every input from the card, the density and slicing
    windows included: under sync-debug mode "error" a launch that waited on
    the device would raise."""
    args, kw = case_inputs("slicing", cuda)
    g = cotangent(args)
    march_backward(*args, march_forward(*args, **kw), g, **kw)   # build
    torch.cuda.synchronize()
    launches = (march_forward.launches, march_backward.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = march_forward(*args, **kw)
        got = march_backward(*args, out, g, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (march_forward.launches, march_backward.launches) == \
        (launches[0] + 1, launches[1] + 1)
    want_out = march_forward_plain(*args, **kw)
    want = march_backward_plain(*args, want_out, g, **kw)
    np.testing.assert_array_equal(out.cpu().numpy(), want_out.cpu().numpy())
    for what, a, b in zip(("vol", "tf", "dmin", "dmax"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=BWD_ATOL, rtol=BWD_RTOL,
                                   err_msg=what)


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
        march_backward(vol, torch.zeros((1 << 16, 4), device=cuda), pos0,
                       dirs, hit, *rest, out, g, **kw)
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


@pytest.mark.cuda
@pytest.mark.parametrize("name,axis,n,c", OWN_CASES)
def test_kernels_with_own_match_plain_on_cuda(cuda, name, axis, n, c):
    """K1 and K2 on a depth chunk against their plain versions on it."""
    args, kw = own_inputs(name, axis, n, c, cuda)
    got = march_forward(*args, **kw)
    want = march_forward_plain(*args, **kw)
    g = cotangent(args)
    got_b = march_backward(*args, want, g, **kw)
    want_b = march_backward_plain(*args, want, g, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)
    for what, a, b in zip(("vol", "tf", "dmin", "dmax"), got_b, want_b):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=BWD_ATOL, rtol=BWD_RTOL,
                                   err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_whole_volume_range_equals_no_range_on_cuda(cuda, axis):
    """``own=(axis, 0, N, N)`` on the grid plus a zero halo row: K1 equals
    K1 without a range, bit for bit."""
    args, kw = case_inputs("orient_120_-35", cuda)
    whole = march_forward(*args, **kw)
    chunk = (chunk_of(args[0], 0, N, axis),) + args[1:]
    got = march_forward(*chunk, **kw, own=(axis, 0, N, N))
    torch.cuda.synchronize()
    assert torch.equal(got, whole)


@pytest.mark.cuda
def test_k1_texture_follows_the_grid_on_cuda(cuda):
    """K1 reads the grid through a cached copy in a texture: the copy is
    made again after an in-place change of the grid (its version counter),
    for another tensor at the same shape, and for another shape; each
    result is bit for bit the plain version's on the grid as it is then."""
    args, kw = case_inputs("orient_30_20", cuda)
    vol = args[0].clone()

    def check(v, own=None):
        a = (v,) + args[1:]
        got = march_forward(*a, **kw, own=own)
        torch.cuda.synchronize()
        assert torch.equal(got, march_forward_plain(*a, **kw, own=own))
        return got

    first = check(vol)
    assert torch.equal(check(vol), first)          # the cached copy
    vol.mul_(0.5)                                  # in place: copied again
    assert not torch.equal(check(vol), first)
    check(vol.flip(0).contiguous())                # another tensor
    check(vol.detach())                            # the same grid, a view
    check(chunk_of(vol, 1, N // 4, 0), own=(0, N // 4, N // 4, N))
    check(vol)                                     # the first shape again
    tmp = vol.flip(1).contiguous()
    check(tmp)
    gone = weakref.ref(tmp)
    del tmp
    assert gone() is None                          # the cache holds no grid
    check(vol.flip(2).contiguous())   # where the allocator reuses tmp's block
    march.release_grid_textures()
    check(vol)


@pytest.mark.cuda
def test_k1_on_inference_tensors_matches_plain_on_cuda(cuda):
    """Under ``torch.inference_mode`` (tensors without a version counter)
    K1 and ``render(method="kernel")`` run, copy the grid at every launch,
    and follow an in-place change bit for bit."""
    args, kw = case_inputs("orient_30_20", cuda)
    cam = OrbitCamera.from_angles(30.0, 20.0)
    settings = RenderSettings(height=24, width=32, step_size=1.8 / STEPS)
    with torch.inference_mode():
        vol = args[0].clone()
        for _ in range(2):
            a = (vol,) + args[1:]
            got = march_forward(*a, **kw)
            assert torch.equal(got, march_forward_plain(*a, **kw))
            img = render(vol, args[1], cam, settings, method="kernel")
            assert torch.equal(img, render(vol, args[1], cam, settings,
                                           method="fused"))
            vol.mul_(0.5)
    assert vol.is_inference()


@pytest.mark.cuda
def test_k1_whole_and_chunk_in_turns_without_host_sync_on_cuda(cuda):
    """A whole grid and a depth chunk of it, marched in turns as a depth
    split's whole render and chunk renders are, each keep their texture
    array: under sync-debug mode "error" no launch allocates, frees or
    waits, and each result is bit for bit the plain version's."""
    args, kw = case_inputs("orient_120_-35", cuda)
    own = (0, 0, N // 2, N)
    chunk = (chunk_of(args[0], 0, N // 2, 0),) + args[1:]
    march_forward(*args, **kw)
    march_forward(*chunk, **kw, own=own)
    torch.cuda.synchronize()
    textures = march._textures[torch.cuda.current_device()]
    arrays = {s: t.handle.value for s, t in textures.items()}
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            got.append(march_forward(*args, **kw))
            got.append(march_forward(*chunk, **kw, own=own))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {s: t.handle.value for s, t in textures.items()} == arrays
    want = (march_forward_plain(*args, **kw),
            march_forward_plain(*chunk, **kw, own=own))
    for i, x in enumerate(got):
        assert torch.equal(x, want[i % 2])


@pytest.mark.cuda
@pytest.mark.parametrize("n,rays", [(1, 300), (2, 4097), (4, 70000)])
def test_fold_kernels_match_plain_on_cuda(cuda, n, rays):
    """The fold kernels on the card: the fold ``torch.equal`` to its plain
    version and each chunk's backward within ``1e-6 * max|grad|``, one
    launch each; the differentiable ``fold`` against autograd through the
    plain fold."""
    parts, dirs, g = fold_inputs(n, rays, cuda, seed=rays)
    for axis in (0, 1, 2):
        before = (kfold.fold_forward.launches, kfold.fold_backward.launches)
        got = kfold.fold_forward(parts, dirs, axis)
        grads = [kfold.fold_backward(parts, dirs, axis, g, r)
                 for r in range(n)]
        assert (kfold.fold_forward.launches,
                kfold.fold_backward.launches) == (before[0] + 1,
                                                  before[1] + n)
        assert torch.equal(got, kfold.fold_forward_plain(parts, dirs, axis))
        for r in range(n):
            assert_fold_grad_close(grads[r], kfold.fold_backward_plain(
                parts, dirs, axis, g, r))
        x = parts.clone().requires_grad_(True)
        (kfold.fold(x, dirs, axis) * g).sum().backward()
        y = parts.clone().requires_grad_(True)
        (kfold.fold_forward_plain(y, dirs, axis) * g).sum().backward()
        assert_fold_grad_close(x.grad, y.grad)


@pytest.mark.cuda
def test_fold_kernels_launch_without_host_sync(cuda):
    parts, dirs, g = fold_inputs(4, 5000, cuda)
    kfold.fold_backward(parts, dirs, 1, g, 2)             # build
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kfold.fold_forward(parts, dirs, 1)
        grad = kfold.fold_backward(parts, dirs, 1, g, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, kfold.fold_forward_plain(parts, dirs, 1))
    assert_fold_grad_close(grad, kfold.fold_backward_plain(parts, dirs, 1,
                                                           g, 2))


@pytest.mark.cuda
def test_fold_forward_refuses_parts_that_require_grad_on_cuda(cuda):
    """The kernel's output carries no graph: ``fold_forward`` on parts that
    require grad raises under grad mode and runs under ``no_grad``."""
    parts, dirs, _ = fold_inputs(2, 300, cuda)
    x = parts.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="differentiate through fold"):
        kfold.fold_forward(x, dirs, 0)
    with torch.no_grad():
        assert torch.equal(kfold.fold_forward(x, dirs, 0),
                           kfold.fold_forward_plain(parts, dirs, 0))


@pytest.mark.cuda
def test_failing_fold_launch_raises(cuda, monkeypatch):
    """A CUDA error from a fold launch raises; nothing falls back to the
    plain version and the launch is not counted."""
    parts, dirs, g = fold_inputs(2, 300, cuda)
    lib = kfold.load_library()
    monkeypatch.setattr(lib, "fold_fwd_launch", lambda *a: 700)
    monkeypatch.setattr(lib, "fold_bwd_launch", lambda *a: 700)
    monkeypatch.setattr(kfold, "fold_forward_plain", None)
    monkeypatch.setattr(kfold, "fold_backward_plain", None)
    before = (kfold.fold_forward.launches, kfold.fold_backward.launches)
    with pytest.raises(RuntimeError, match="fold: launch failed: CUDA "
                                           "error 700"):
        kfold.fold_forward(parts, dirs, 0)
    with pytest.raises(RuntimeError, match="fold: launch failed: CUDA "
                                           "error 700"):
        kfold.fold_backward(parts, dirs, 0, g, 1)
    assert (kfold.fold_forward.launches,
            kfold.fold_backward.launches) == before


@pytest.mark.cuda
def test_sanitizer_on_cuda(cuda):
    """``checked_render`` on a CUDA grid: the plain march with its checks,
    equal to ``render(method="fused")``; a NaN voxel caught; the kernel
    refused (``"auto"`` picks it on the card).  K1 is bitwise repeatable
    (``assert_deterministic`` over 3 launches, the texture kept)."""
    from volumetric_renderer_torch.utils.sanitize import (
        assert_deterministic, checked_render,
    )

    vol = Volume.synthetic_sphere(16).as_torch(cuda)
    tf = torch.as_tensor(Gradient.grayscale_ramp().discretize(16),
                         device=cuda)
    cam = OrbitCamera.from_angles(30.0, 20.0)
    settings = RenderSettings(height=24, width=24, step_size=1.8 / 24)
    err, img = checked_render(vol, tf, cam, settings)
    err.throw()
    assert torch.equal(img, render(vol, tf, cam, settings, method="fused"))
    with pytest.raises(ValueError, match="plain PyTorch"):
        checked_render(vol, tf, cam, settings, method="auto")
    bad = vol.clone()
    bad[8, 8, 8] = float("nan")
    with pytest.raises(FloatingPointError, match="nan"):
        checked_render(bad, tf, cam, settings)[0].throw()
    before = march_forward.launches
    assert_deterministic(lambda: render(vol, tf, cam, settings,
                                        method="kernel"), runs=3)
    assert march_forward.launches == before + 3
