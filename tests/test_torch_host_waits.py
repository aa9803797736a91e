"""The main paths never make the host wait for the card.

Once built, a frame through ``render``, the pixel-sharded train step
(``make_train_step``) and the depth-sharded one (``make_depth_train_step``)
must not wait for the device: no copy from pageable host memory, no
readback.  On the CPU there is no card, so this file holds what such a wait
shows in the dispatcher: a second call, recorded under a
``TorchDispatchMode``, must hold no ``aten::_local_scalar_dense`` (a
readback: ``.item()``, ``float()``), no ``aten::_linalg_check_errors``
(``torch.linalg.inv``'s singularity check, which reads the result back on
a card) and no ``aten::lift_fresh`` (a tensor made from Python data on
every call, which a card receives through a blocking copy).

The plain versions of K1 and K2 (``core.fused.march_prepared`` and
``march_backward_prepared``) stand in for the kernels on the CPU and are
not on the card's path, so the recording pauses inside them.  The steps
run with SGD: ``torch.optim.Adam`` reads its step counter, a host tensor,
with ``.item()``, which on the card is no wait (the card's check,
``chip_smoke.py``'s ``no_host_waits`` phase, runs Adam as the optimize
app does).

The same inputs give the same bits whether the camera comes on the host or
already on the device (on the CPU: as it is, or stacked once), and on a
first and a second call.  The test marked ``cuda`` runs the same paths on a
card under ``torch.cuda.set_sync_debug_mode("error")`` (it skips without
one).  This file imports no JAX:

    python -m pytest tests/test_torch_host_waits.py -q -m cuda --noconftest
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)

from volumetric_renderer_torch import models
from volumetric_renderer_torch.apps import optimize
from volumetric_renderer_torch.core import fused
from volumetric_renderer_torch.kernels import march
from volumetric_renderer_torch.parallel.mesh import LAYOUTS, make_layout
from volumetric_renderer_torch.parallel.render import (
    block_inputs,
    rank_pixels,
)
from volumetric_renderer_torch.parallel.train import (
    init_depth_state,
    init_state,
    make_depth_train_step,
    make_train_step,
    stack_cameras,
)
from volumetric_renderer_torch.render.api import render
from volumetric_renderer_torch.scene import camera as camera_mod
from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils import device as device_mod
from volumetric_renderer_torch.utils.config import RenderSettings

#: what a wait for the card shows in the dispatcher (module docstring)
WAITS = ("aten::_local_scalar_dense", "aten::_linalg_check_errors",
         "aten::lift_fresh")
N, NTF = 8, 16
# 10 x 12 pixels: not a multiple of the 16x16 tiles, so tile layouts pad
SMALL = RenderSettings(height=10, width=12, step_size=1.8 / 8,
                       early_termination=False, tf_resolution=NTF)
YAWS = (0.0, 120.0, 240.0)


class Recorder(TorchDispatchMode):
    """Counts the ATen operations dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func._schema.name] += 1
        return func(*args, **(kwargs or {}))

    def waits(self) -> dict:
        return {k: n for k, n in self.ops.items() if k in WAITS}


def _paused(fn):
    """``fn`` with every dispatch mode off while it runs."""
    def call(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return call


@pytest.fixture
def plain_twins_paused(monkeypatch):
    """The recording pauses inside the plain versions of K1 and K2, which
    stand in for the kernels on the CPU (module docstring)."""
    monkeypatch.setattr(fused, "march_prepared",
                        _paused(fused.march_prepared))
    monkeypatch.setattr(fused, "march_backward_prepared",
                        _paused(fused.march_backward_prepared))


def scene():
    vol = models.sphere(N).as_torch("cpu")
    tf = torch.from_numpy(Gradient.grayscale_ramp().discretize(NTF))
    return vol, tf


def cameras():
    return [OrbitCamera.from_angles(a, 20.0) for a in YAWS]


def fixed_inputs(vol, tf):
    return dict(vol=vol, tf=tf, dmin=vol.min(), dmax=vol.max(),
                smin=torch.zeros(3), smax=torch.ones(3))


def targets(n_views):
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.uniform(
        0.0, 1.0, (n_views, SMALL.height, SMALL.width, 4)).astype(
            np.float32))


def sgd_state(vol, tf, depth_axis=None):
    params = {"vol": torch.full_like(vol, 0.3), "tf": tf * 0.5}

    def make(p):           # lr 0: every call sees the same parameters
        return torch.optim.SGD(p, lr=0.0)

    if depth_axis is None:
        return init_state(params, make)
    return init_depth_state(params, make, axis=depth_axis)


def run_step(step, state, fixed, cams, tgt):
    """One step: the loss and the gradients it leaves, copied."""
    state, loss = step(state, fixed, cams, tgt)
    return state, loss.clone(), [state.params[k].grad.clone()
                                 for k in ("vol", "tf")]


def assert_same(a, b):
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


# -- the guard itself -----------------------------------------------------

@pytest.mark.parametrize("what", ["tensor_from_list", "as_tensor_numpy",
                                  "linalg_inv", "item", "float"])
def test_guard_sees_what_would_wait(what):
    """Each way a call could wait for the card shows in the recording."""
    m = torch.eye(4) * 2.0
    make = {
        "tensor_from_list": lambda: torch.tensor([0.0, 0.0, 1.0]),
        "as_tensor_numpy": lambda: torch.as_tensor(np.zeros(3)),
        "linalg_inv": lambda: torch.linalg.inv(m),
        "item": lambda: m.sum().item(),
        "float": lambda: float(m.sum()),
    }[what]
    with Recorder() as rec:
        make()
    assert rec.waits(), rec.ops


def test_guard_passes_inv_ex_and_device_constants():
    """``torch.linalg.inv_ex`` makes no check, and a cached constant is no
    new tensor; both give what they replace, bit for bit."""
    m = camera_mod.projection_matrix(OrbitCamera.from_angles(30.0, 20.0),
                                     1.5)
    device_mod.constant((0.0, 0.0, 1.0), "cpu")
    with Recorder() as rec:
        inv = torch.linalg.inv_ex(m).inverse
        up = device_mod.constant((0.0, 0.0, 1.0), "cpu")
    assert not rec.waits(), rec.waits()
    assert torch.equal(inv, torch.linalg.inv(m))
    assert torch.equal(up, torch.tensor([0.0, 0.0, 1.0]))


# -- the paths: a second call waits for nothing ---------------------------

@pytest.mark.parametrize("windows", ["default", "given"])
def test_render_second_call_waits_for_nothing(plain_twins_paused, windows):
    vol, tf = scene()
    cam = OrbitCamera.from_angles(30.0, 20.0)
    kw = {} if windows == "default" else dict(
        density_min=vol.min(), density_max=vol.max(),
        slice_min=torch.full((3,), 0.1), slice_max=torch.full((3,), 0.9))
    first = render(vol, tf, cam, SMALL, **kw)
    with Recorder() as rec:
        second = render(vol, tf, cam, SMALL, **kw)
    assert not rec.waits(), rec.waits()
    assert rec.ops, "the recording saw no operation"
    assert torch.equal(first, second)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("stacked", [False, True])
def test_pixel_step_second_call_waits_for_nothing(plain_twins_paused, layout,
                                                  stacked):
    vol, tf = scene()
    cams = stack_cameras(cameras()) if stacked else cameras()
    step = make_train_step(SMALL, optimize_vol=True, optimize_tf=True,
                           row_layout=layout)
    fixed, tgt = fixed_inputs(vol, tf), targets(len(YAWS))
    state, *first = run_step(step, sgd_state(vol, tf), fixed, cams, tgt)
    with Recorder() as rec:
        state, loss = step(state, fixed, cams, tgt)
    assert not rec.waits(), rec.waits()
    assert torch.isfinite(loss) and float(loss) > 0.0


def test_depth_step_second_call_waits_for_nothing(plain_twins_paused):
    vol, tf = scene()
    step = make_depth_train_step(SMALL, optimize_vol=True, optimize_tf=True,
                                 vol_shape=vol.shape, axis=1)
    fixed, tgt, cams = fixed_inputs(vol, tf), targets(len(YAWS)), cameras()
    state, *first = run_step(step, sgd_state(vol, tf, 1), fixed, cams, tgt)
    with Recorder() as rec:
        state, loss = step(state, fixed, cams, tgt)
    assert not rec.waits(), rec.waits()
    assert torch.isfinite(loss) and float(loss) > 0.0


# -- the same bits, whatever way the camera comes -------------------------

def test_render_same_bits_for_a_moved_camera_and_a_second_call():
    vol, tf = scene()
    cam = OrbitCamera.from_angles(30.0, 20.0)
    moved = cam.to(vol.device)
    first = render(vol, tf, cam, SMALL)
    assert torch.equal(render(vol, tf, moved, SMALL), first)
    assert torch.equal(render(vol, tf, cam, SMALL), first)


def test_ray_grid_same_bits_as_uncached_projection_and_checked_inverse():
    """The cached ``P * C`` and ``inv_ex`` give the operations they replace
    bit for bit: ``_mm(_mm(P, C), V)`` made afresh and ``linalg.inv``."""
    cam = stack_cameras(cameras())
    aspect = SMALL.width / SMALL.height
    fov = torch.deg2rad(torch.tensor(40.0, dtype=torch.float32))
    want = camera_mod._mm(camera_mod._mm(
        camera_mod.perspective_rh_zo(fov, aspect, 0.1, 10.0),
        camera_mod.coordinate_conversion()), cam.view_matrix())
    got = camera_mod.projection_matrix(cam, aspect)
    assert torch.equal(got, want)
    assert torch.equal(torch.linalg.inv_ex(got).inverse,
                       torch.linalg.inv(want))
    origin, dirs = ray_grid(cam, SMALL.height, SMALL.width)
    again = ray_grid(cam.to("cpu"), SMALL.height, SMALL.width)
    assert torch.equal(origin, again[0]) and torch.equal(dirs, again[1])
    assert torch.isfinite(dirs).all()


@pytest.mark.parametrize("layout", ["contiguous", "tile-cyclic"])
def test_pixel_step_same_bits_stacked_once_and_on_a_second_call(layout):
    vol, tf = scene()
    step = make_train_step(SMALL, optimize_vol=True, optimize_tf=True,
                           row_layout=layout)
    fixed, tgt = fixed_inputs(vol, tf), targets(len(YAWS))
    state, *listed = run_step(step, sgd_state(vol, tf), fixed, cameras(),
                              tgt)
    state, *stacked = run_step(step, state, fixed,
                               stack_cameras(cameras()).to("cpu"), tgt)
    _, *again = run_step(step, state, fixed, cameras(), tgt)
    assert_same(listed, stacked)
    assert_same(listed, again)
    assert float(listed[0]) > 0.0 and float(listed[1][0].abs().max()) > 0.0


def test_depth_step_same_bits_stacked_once_and_on_a_second_call():
    vol, tf = scene()
    step = make_depth_train_step(SMALL, optimize_vol=True, optimize_tf=True,
                                 vol_shape=vol.shape, axis=1)
    fixed, tgt = fixed_inputs(vol, tf), targets(len(YAWS))
    state, *listed = run_step(step, sgd_state(vol, tf, 1), fixed, cameras(),
                              tgt)
    state, *stacked = run_step(step, state, fixed,
                               stack_cameras(cameras()).to("cpu"), tgt)
    _, *again = run_step(step, state, fixed, cameras(), tgt)
    assert_same(listed, stacked)
    assert_same(listed, again)
    assert float(listed[1][0].abs().max()) > 0.0


# -- the pieces: layouts, the kernel's window, the copy -------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_make_layout_on_a_device_packs_as_before(layout):
    """``device=`` puts ``valid`` and the indices there; ``pack`` and
    ``unpack`` give what the default layout gives and, on that device, copy
    no index (no ``_to_copy``, no new tensor from host data)."""
    h, w, n_dev = 21, 37, 3
    img = torch.arange(h * w * 2, dtype=torch.float32).reshape(h, w, 2)
    gh, gw, pack, unpack, valid = make_layout(layout, h, w, n_dev)
    dgh, dgw, dpack, dunpack, dvalid = make_layout(layout, h, w, n_dev,
                                                   device="cpu")
    assert (dgh, dgw) == (gh, gw) and dvalid.device.type == "cpu"
    assert torch.equal(dvalid, valid)
    with Recorder() as rec:
        packed = dpack(img)
        back = dunpack(packed)
    assert not rec.waits() and "aten::_to_copy" not in rec.ops, rec.ops
    assert torch.equal(packed, pack(img)) and torch.equal(back, img)


@pytest.mark.parametrize("layout", ["cyclic", "tile-cyclic"])
def test_make_layout_indices_live_on_its_device(layout):
    """A layout made for the ``meta`` device indexes meta images with no
    copy; one made for the CPU copies its index over on every call."""
    img = torch.empty((21, 37, 2), device="meta")
    gh, gw, pack, unpack, valid = make_layout(layout, 21, 37, 3,
                                              device="meta")
    assert valid.device.type == "meta" and valid.shape == (gh, gw)
    with Recorder() as rec:
        packed = pack(img)
        unpack(packed)
    assert "aten::_to_copy" not in rec.ops, rec.ops
    assert packed.device.type == "meta" and packed.shape == (gh, gw, 2)
    host_pack = make_layout(layout, 21, 37, 3)[2]
    with Recorder() as rec:
        host_pack(img)
    assert "aten::_to_copy" in rec.ops


def test_window_takes_device_values_as_they_are():
    """The kernel's window packs tensors already on its device without a
    copy and takes Python numbers through the host path, as values."""
    dev = torch.device("cpu")
    parts = (torch.tensor(0.25), torch.tensor([2.0]),
             torch.tensor([0.1, 0.2, 0.3]), torch.tensor([0.7, 0.8, 0.9]))
    with Recorder() as rec:
        win = march._window("f", dev, *parts)
    assert not rec.waits() and "aten::_to_copy" not in rec.ops, rec.ops
    want = torch.tensor([0.25, 2.0, 0.1, 0.2, 0.3, 0.7, 0.8, 0.9])
    assert torch.equal(win, want)
    assert torch.equal(march._window("f", dev, 0.25, 2.0, (0.1, 0.2, 0.3),
                                     (0.7, 0.8, 0.9)), want)
    with pytest.raises(ValueError, match="smin must hold 3"):
        march._window("f", dev, 0.0, 1.0, (0.0, 0.0), (1.0, 1.0, 1.0))


def test_to_device_pins_nothing_for_a_cpu_target(monkeypatch):
    def no_pinning(self, *a, **k):
        raise AssertionError("pinned memory for a CPU target")

    monkeypatch.setattr(torch.Tensor, "pin_memory", no_pinning)
    cam = OrbitCamera.from_angles(30.0, 20.0)
    moved = cam.to("cpu")
    assert moved.center is cam.center and moved.radius is cam.radius
    assert moved.orientation is cam.orientation
    x = torch.ones(3, dtype=torch.float64)
    assert device_mod.to_device([x], "cpu")[0] is x
    got = device_mod.as_device((1.0, 2.0), "cpu", torch.float32)
    assert torch.equal(got, torch.tensor([1.0, 2.0]))


def test_constants_are_made_once_per_device_outside_inference_mode():
    with torch.inference_mode():
        up = device_mod.constant((0.5, 0.25), "cpu")
    assert not up.is_inference()
    assert device_mod.constant((0.5, 0.25), "cpu") is up
    made = []
    on = device_mod.per_device(lambda d: made.append(d) or torch.zeros(2))
    assert on("cpu") is on(torch.device("cpu"))
    assert made == [torch.device("cpu")]


def test_optimize_app_stacks_its_cameras_once(monkeypatch):
    """The app hands every step the same batched camera, put on the device
    once before the loop, and not a list stacked anew each step."""
    seen = []

    def recording(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def wrapped(state, fixed, cams, tgt):
            seen.append(cams)
            return step(state, fixed, cams, tgt)

        return wrapped

    monkeypatch.setattr(optimize, "make_train_step", recording)
    res = optimize.main(["tf-fit", "--grid", "8", "--size", "8x8",
                         "--march-steps", "8", "--views", "2",
                         "--steps-opt", "3", "--tf-resolution", "8",
                         "--device", "cpu"])
    assert len(res["losses"]) == 3 and len(seen) == 3
    assert all(c is seen[0] for c in seen)
    assert isinstance(seen[0], OrbitCamera)
    assert seen[0].orientation.shape == (2, 4)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_main_paths_make_no_host_wait_on_cuda(cuda):
    """A second call of each path under sync-debug mode "error": a wait
    for the card raises.  Adam, as the optimize app runs it."""
    vol, tf = (x.to(cuda) for x in scene())
    fixed = {k: v.to(cuda) for k, v in fixed_inputs(vol, tf).items()}
    tgt = targets(len(YAWS)).to(cuda)
    paths = {"render": lambda: render(vol, tf, cameras()[0], SMALL)}
    for layout in ("contiguous", "tile-cyclic"):
        step = make_train_step(SMALL, optimize_vol=True, optimize_tf=True,
                               row_layout=layout)
        state = [init_state({"vol": vol, "tf": tf},
                            lambda p: torch.optim.Adam(p, lr=1e-2))]

        def pixel(step=step, state=state):
            state[0], loss = step(state[0], fixed, cameras(), tgt)
            return loss

        paths[layout] = pixel
    dstep = make_depth_train_step(SMALL, optimize_vol=True, optimize_tf=True,
                                  vol_shape=vol.shape, axis=1)
    dstate = [init_depth_state({"vol": vol, "tf": tf},
                               lambda p: torch.optim.Adam(p, lr=1e-2),
                               axis=1)]

    def depth():
        dstate[0], loss = dstep(dstate[0], fixed, cameras(), tgt)
        return loss

    paths["depth"] = depth
    for name, fn in paths.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(out).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
def test_block_rays_match_the_packed_whole_grid_on_cuda(cuda, world):
    """A 1080p batch of 8 views on the card: each rank's block of rays
    from the sharded renderer's ray setup (``rank_pixels``,
    ``block_inputs``; the world built by hand, rank and size as arguments)
    within 1e-7 of that rank's rows of the whole frame's ``ray_grid``
    packed with the layout, the inert direction on padding, in every
    layout."""
    h, w = 1080, 1920
    settings = RenderSettings(height=h, width=w, step_size=1.8 / 512)
    cam = stack_cameras([OrbitCamera.from_angles(45.0 * i, 20.0)
                         for i in range(8)]).to(cuda)
    vol = torch.zeros((2, 2, 2), device=cuda)
    _, whole = ray_grid(cam, h, w)
    inert = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    worst = {}
    for layout in LAYOUTS:
        gh, gw, pack, _, valid = make_layout(layout, h, w, world,
                                             device=cuda)
        rows = gh // world
        packed = torch.where(valid[..., None, None] > 0.0,
                             pack(whole.permute(1, 2, 0, 3)), inert)
        for rank in range(world):
            want = packed[rank * rows:(rank + 1) * rows].permute(2, 0, 1, 3)
            _, got, *_ = block_inputs(
                vol, cam, settings,
                rank_pixels(layout, h, w, rank, world, cuda),
                None, None, None, None)
            assert got.shape == want.shape
            worst[layout, rank] = float((got - want).abs().max())
    print(f"block rays, world {world}: largest |difference| by (layout, "
          f"rank) {worst}")
    assert max(worst.values()) <= 1e-7
