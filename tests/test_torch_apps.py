"""The port's apps against the JAX package's: the turntable, the viewer's
state machine and window handlers, and the bench, ablation, scaling and
benchmark harnesses, on the CPU at toy sizes.

Tolerances:
* turntable frames: 1/255 per pixel (one step of the 8-bit PNG), against
  the JAX turntable's frames: the two packages' f32 ray directions differ
  by up to ~4e-6, which can move a value across a rounding boundary;
* the bench's gradients accumulated over row bands: rtol 1e-5 / atol 1e-6
  of the one-band gradients (sums taken in another order); against the
  JAX package's gradients of the same loss (each package's own rays),
  5e-4 of the largest;
* the scaling bands, unpacked: equal to the full frame (each ray is
  marched alone); against the JAX emulation's bands, their rays within
  1e-5 (ray drift) and their images within 1e-4, as
  ``tests/test_torch_render.py``'s frames;
* the viewer's cameras: 1e-6, as ``tests/test_apps.py``;
* the ablation's config-2 cell against the JAX ablation's: the same grid,
  the bone TF within one f32 ulp (``np.linspace`` against
  ``jnp.linspace``), the frames within 1/255 and 1e-4 on average (each
  package makes its own rays, and the phantom's sharp edges and the bone
  TF's steep alpha turn their ~4e-6 drift into up to 2.8e-3 on a few
  pixels); along the same rays, 1e-5;
* the benchmark's checksum (the sum of the frame, or of the grid's
  gradient with ``--grad``) against the JAX benchmark's: rtol 1e-5.

Two defects of the JAX apps that the port fixes each get a test that
shows the JAX app getting it wrong: ``bench.py``'s ``--ray-chunks`` keeps
only the last band's gradients, and the viewer drops a real motion after
an edge it cannot warp the cursor across and pitches on the first motion
of every drag (press and motion disagree on the sign of y).
"""

import importlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetric_renderer_tpu.scene.camera import OrbitCamera as JCamera
from volumetric_renderer_tpu.scene.camera import ray_grid as jray_grid
from volumetric_renderer_torch import models
from volumetric_renderer_torch.apps import (
    ablation, bench, benchmark, scaling, turntable, viewer,
)
from volumetric_renderer_torch.apps.viewer import ViewerState
from volumetric_renderer_torch.core.marcher import frame_inputs
from volumetric_renderer_torch.render.api import make_marcher
from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer_torch.utils.config import RenderSettings


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- turntable ---------------------------------------------------------------

def test_turntable_png_frames_match_jax(tmp_path):
    from PIL import Image

    from volumetric_renderer_tpu.apps import turntable as jturntable

    common = ["--synthetic", "--frames", "3", "--size", "32x32", "--steps",
              "16"]
    jturntable.main(common + ["--out", str(tmp_path / "j_%d.png")])
    res = turntable.main(common + ["--out", str(tmp_path / "t_%d.png"),
                                   "--device", "cpu"])
    assert res["frames"] == 3 and res["rays_per_s"] > 0
    assert res["paths"] == [str(tmp_path / f"t_{i}.png") for i in range(3)]
    for i in range(3):
        got = np.asarray(Image.open(tmp_path / f"t_{i}.png"), np.int32)
        want = np.asarray(Image.open(tmp_path / f"j_{i}.png"), np.int32)
        assert got.shape == want.shape == (32, 32, 3)
        assert np.abs(got - want).max() <= 1
        assert got.max() > 100          # the sphere is in the frame
    # the default names when the pattern has no %d
    res = turntable.main(common + ["--out", str(tmp_path / "f"),
                                   "--device", "cpu"])
    assert res["paths"][2] == str(tmp_path / "f.0002.png")


def test_turntable_gif(tmp_path):
    out = str(tmp_path / "o.gif")
    turntable.main(["--synthetic", "--frames", "3", "--size", "32x32",
                    "--steps", "16", "--out", out, "--device", "cpu"])
    from PIL import Image

    assert Image.open(out).n_frames == 3


def test_turntable_cuda_without_a_card_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        turntable.main(["--synthetic", "--frames", "1", "--size", "8x8",
                        "--out", str(tmp_path / "x.png")])


# -- viewer ------------------------------------------------------------------

def test_viewer_state_machine():
    """Headless viewer logic: drag orbits (sensitivity 0.25 inside
    OrbitCamera), scroll zooms with the reference radius clamp, reset
    restores; every event triggers exactly one re-render."""
    calls = []

    def render_frame(cam):
        calls.append(cam.orientation.clone())
        return np.zeros((8, 8, 3), np.float32)

    cam0 = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    st = ViewerState(render_frame, cam0)
    st.frame()
    assert st.last_rays_per_s > 0 and len(calls) == 1

    assert not st.drag(10, 10)          # no press yet
    st.press(0, 0)
    assert st.drag(40, 0)               # 40px drag = 10 deg yaw
    want = cam0.rotate((40.0, 0.0))
    np.testing.assert_allclose(st.camera.orientation.numpy(),
                               want.orientation.numpy(), atol=1e-6)
    st.release()
    assert not st.drag(50, 0)

    r0 = float(st.camera.radius)
    st.scroll(1)                        # wheel up zooms in
    assert float(st.camera.radius) < r0
    for _ in range(100):
        st.scroll(1)
    np.testing.assert_allclose(float(st.camera.radius), 0.1,
                               rtol=1e-6)      # camera.cpp:31-34 clamp

    st.reset()
    np.testing.assert_allclose(st.camera.orientation.numpy(),
                               cam0.orientation.numpy())


def test_viewer_cursor_wrap_around():
    """Edge wrap-around during a drag (main_window.cpp:267-315): the
    cursor warps to the opposite edge, the motion event after the warp
    is ignored (its delta would be the warp jump), and subsequent drags
    keep rotating from the warped position."""
    warps = []
    cam0 = OrbitCamera.from_angles(yaw_deg=0.0, pitch_deg=0.0)
    st = ViewerState(lambda c: np.zeros((4, 4, 3), np.float32), cam0,
                     wrap_bounds=((0.0, 0.0), (100.0, 100.0)),
                     warp_cursor=lambda x, y: warps.append((x, y)))

    st.press(90, 50)
    assert st.drag(105, 50)             # crosses max_x -> warp to min_x
    assert warps == [(0.0, 50)]
    want = cam0.rotate((15.0, 0.0))     # rotation BEFORE the warp applies
    np.testing.assert_allclose(st.camera.orientation.numpy(),
                               want.orientation.numpy(), atol=1e-6)
    assert not st.drag(0, 50)
    assert st.drag(20, 50)
    want = want.rotate((20.0, 0.0))
    np.testing.assert_allclose(st.camera.orientation.numpy(),
                               want.orientation.numpy(), atol=1e-6)

    st.press(50, 5)
    assert st.drag(50, -10)
    assert warps[-1] == (50, 100.0)


def test_viewer_wraps_only_with_a_warp_hook():
    """Without a ``warp_cursor`` hook the cursor is not moved, so the next
    motion is a real one and must rotate.  The JAX viewer sets its
    'ignore the next motion' flag anyway and drops it."""
    from volumetric_renderer_tpu.apps.viewer import ViewerState as JState

    bounds = ((0.0, 0.0), (100.0, 100.0))
    cam0 = OrbitCamera.from_angles(yaw_deg=0.0, pitch_deg=0.0)
    st = ViewerState(lambda c: None, cam0, wrap_bounds=bounds)
    jst = JState(lambda c: None, JCamera.from_angles(0.0, 0.0),
                 wrap_bounds=bounds)
    for s in (st, jst):
        s.press(90, 50)
        assert s.drag(105, 50)
    assert st.drag(110, 50)             # 5 px more: a rotation
    assert not jst.drag(110, 50)        # the JAX viewer drops it
    want = cam0.rotate((20.0, 0.0))
    np.testing.assert_allclose(st.camera.orientation.numpy(),
                               want.orientation.numpy(), atol=1e-6)


class _FakeFigure:
    """Just enough of a matplotlib figure for the viewers' ``main``."""

    def __init__(self):
        self.handlers, self.frames = {}, []
        self.canvas = types.SimpleNamespace(
            mpl_connect=self.handlers.__setitem__, draw_idle=lambda: None,
            manager=types.SimpleNamespace(set_window_title=lambda t: None))

    def subplots(self, **kw):
        fig = self

        class Axes:
            def set_axis_off(self):
                pass

            def imshow(self, img):
                fig.frames.append(np.asarray(img))
                return types.SimpleNamespace(set_data=fig.frames.append)

        return self, Axes()


@pytest.fixture
def fake_pyplot(monkeypatch):
    import matplotlib.pyplot as plt

    fig = _FakeFigure()
    monkeypatch.setattr(plt, "subplots", fig.subplots)
    monkeypatch.setattr(plt, "show", lambda: None)
    return fig


def _drive(fig):
    """Press at a point, move by zero, then 8 px up on the screen
    (matplotlib's y grows upward): the frames rendered after each."""
    ev = types.SimpleNamespace
    fig.handlers["button_press_event"](ev(button=1, xdata=1.0, x=100.0,
                                          y=100.0))
    fig.handlers["motion_notify_event"](ev(x=100.0, y=100.0))
    after_zero = len(fig.frames)
    fig.handlers["motion_notify_event"](ev(x=100.0, y=108.0))
    return after_zero, len(fig.frames)


def test_viewer_press_and_motion_agree_on_y(fake_pyplot):
    """A press followed by a motion to the same point must not rotate, and
    the next motion must.  The JAX viewer's press takes ``(x, y)`` and its
    motion ``(x, -y)``, so it pitches by twice the cursor's height and
    re-renders; that motion lies outside the wrap bounds it sets with no
    hook to warp the cursor, so it then drops the real motion."""
    from volumetric_renderer_tpu.apps import viewer as jviewer

    argv = ["--synthetic", "--size", "8x8", "--steps", "4"]
    viewer.main(argv + ["--device", "cpu"])
    assert _drive(fake_pyplot) == (1, 2)      # no frame for the zero move
    port_frames = list(fake_pyplot.frames)

    fake_pyplot.frames.clear()
    jviewer.main(argv)
    assert _drive(fake_pyplot) == (2, 2)      # a frame for no motion,
    # none for the real one
    assert port_frames[0].shape == (8, 8, 3)


def test_viewer_frames_through_render():
    """``make_frame_renderer`` under ``ViewerState``: one render per
    event, and the reset frame equals the first."""
    vol = models.sphere(16).as_torch("cpu")
    from volumetric_renderer_torch.apps.render_cli import load_tf

    render_frame = viewer.make_frame_renderer(
        vol, torch.as_tensor(load_tf("preset:ramp", 32)),
        RenderSettings(height=12, width=16, step_size=1.8 / 16))
    st = ViewerState(render_frame, OrbitCamera.from_angles(30.0, 20.0))
    first = st.frame()
    assert first.shape == (12, 16, 3) and float(first.max()) > 0.2
    st.press(0, 0)
    assert st.drag(40, 12)
    moved = st.frame()
    assert not torch.equal(moved, first)
    assert st.scroll(1) and st.reset()
    assert torch.equal(st.frame(), first)


# -- bench -------------------------------------------------------------------

SMALL = ["--grid", "16", "--size", "12x16", "--steps", "16", "--iters", "2",
         "--device", "cpu"]


def test_bench_prints_the_keys_of_bench_py(capsys):
    out = bench.main(["--quick", "--device", "cpu", "--iters", "1"])
    assert last_json(capsys) == out
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in out
    assert out["unit"] == "rays/s" and out["value"] > 0
    assert out["metric"] == "rays_per_sec_per_chip_64cubed_256x256_128steps"
    assert out["ms_spread"]["n"] == 1 and out["baseline_rows"] == 64
    assert out["vs_baseline"] > 0 and out["method"] == "fused"
    assert "grid_bytes_gib" not in out


def test_bench_grad_keys_and_spread(capsys):
    out = bench.main(SMALL + ["--grad", "--ray-chunks", "2"])
    assert last_json(capsys) == out
    assert out["metric"].startswith("train_rays_per_sec_per_chip_16cubed")
    for key in ("fwd_ms", "fwd_bwd_ms"):
        s = out[key + "_spread"]
        assert s["min"] <= out[key] == s["median"] <= s["max"]
        assert s["n"] == 2
    assert out["ray_chunks"] == 2 and out["vs_baseline"] > 0
    with pytest.raises(SystemExit, match="divide"):
        bench.main(SMALL + ["--grad", "--ray-chunks", "3"])


def small_march(h=16, w=12, n=16, steps=16):
    vol = models.sphere(n).as_torch("cpu")
    tf = torch.as_tensor(bench.bench_tf())
    settings = RenderSettings(height=h, width=w, step_size=1.8 / steps)
    origin, dirs = ray_grid(OrbitCamera.from_angles(30.0, 20.0), h, w)
    scal = (torch.tensor(0.0), torch.tensor(1.0), torch.zeros(3),
            torch.ones(3))
    return make_marcher("fused", settings), vol, tf, origin + 0.5, dirs, scal


@pytest.mark.parametrize("chunks", [2, 4])
def test_bench_ray_chunks_accumulate(chunks):
    marcher, vol, tf, origin, dirs, scal = small_march()
    one = bench.band_grads(marcher, vol, tf, origin, dirs, 1, scal)
    many = bench.band_grads(marcher, vol, tf, origin, dirs, chunks, scal)
    for a, b in zip(many, one):
        assert float(b.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # the sum over bands, not the last band's share
    last = bench.band_grads(marcher, vol, tf, origin, dirs[-16 // chunks:],
                            1, scal)
    assert not torch.allclose(many[0], last[0] * (16 // chunks) / 16)


def test_jax_bench_keeps_only_the_last_band(monkeypatch):
    """``bench.py``'s ``--grad --ray-chunks 2`` (with the fused marcher in
    place of the TPU kernel) returns the last band's gradients; the port's
    accumulated ones are the whole image's."""
    import bench as jbench
    from volumetric_renderer_tpu.core.fused import make_fused_marcher
    from volumetric_renderer_tpu.kernels import slab
    from volumetric_renderer_tpu.utils.config import (
        RenderSettings as JSettings,
    )

    h, w, n, steps = 16, 12, 16, 16
    monkeypatch.setattr(slab, "make_slab_marcher",
                        lambda s, dt, et, eps, *a, **k:
                        make_fused_marcher(s, dt, et, eps))
    returned = []
    ready = jax.block_until_ready
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: returned.append(x) or ready(x))
    args = types.SimpleNamespace(ray_chunks=2, iters=1, slab_mode="exact",
                                 bwd_mode="high")
    settings = JSettings(height=h, width=w, step_size=1.8 / steps,
                         early_termination=True)
    jbench.bench_grad(args, settings, n, h, w, steps)
    _, (jax_vol_g, _) = returned[-1]     # what its grad() hands back

    # the whole image's gradient of sum(img**2), and the last band's
    marcher = make_fused_marcher(steps, 1.8 / steps, True, 1.0 / 255.0)
    vol = jnp.asarray(models.sphere(n).data)
    tf = jnp.asarray(bench.bench_tf())
    origin, dirs = jray_grid(JCamera.from_angles(30.0, 20.0), h, w)
    scal = (jnp.float32(0.0), jnp.float32(1.0), jnp.zeros(3), jnp.ones(3))

    def vol_grad(d):
        return jax.grad(lambda v: jnp.sum(
            marcher(v, tf, origin + 0.5, d, *scal) ** 2))(vol)

    whole, last = vol_grad(dirs), vol_grad(dirs[h // 2:])
    np.testing.assert_allclose(np.asarray(jax_vol_g), np.asarray(last),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(np.asarray(jax_vol_g), np.asarray(whole),
                           rtol=1e-3, atol=1e-4)

    pmarcher, pvol, ptf, porigin, pdirs, pscal = small_march(h, w, n, steps)
    port = bench.band_grads(pmarcher, pvol, ptf, porigin, pdirs, 2, pscal)
    want = np.asarray(whole) / (h * w)
    err = np.abs(port[0].numpy() - want).max()
    assert err <= 5e-4 * np.abs(want).max()


# -- ablation ----------------------------------------------------------------

def test_ablation_harness(capsys, monkeypatch):
    """Early-termination ablation produces speedup ratios (tiny shapes)."""
    orig = models.head_phantom
    monkeypatch.setattr(models, "head_phantom", lambda n=128: orig(16))
    out = ablation.main(["--iters", "2", "--skip-flagship", "--size",
                         "24x24", "--steps", "12", "--methods", "fused",
                         "oracle", "--device", "cpu"])
    data = json.loads(capsys.readouterr().out)
    assert data == json.loads(json.dumps(out))
    w = data["workloads"]["config2_head_phantom"]
    for m in ("fused", "oracle"):
        assert w[f"et_speedup_{m}"] > 0 and w[f"{m}_eton"]["rays_per_s"] > 0
        assert w[f"{m}_etoff"]["ms_spread"]["n"] == 2
    assert "flagship_sphere" not in data["workloads"]
    with pytest.raises(ValueError, match="CUDA"):
        ablation.main(["--iters", "1", "--skip-flagship", "--size", "8x8",
                       "--steps", "4", "--methods", "kernel", "--device",
                       "cpu"])


def record_renders(monkeypatch, module):
    """Replace ``module.render`` with a wrapper that keeps each call's
    ``(vol, tf, settings, image)``."""
    api = importlib.import_module(module)
    real, calls = api.render, []

    def recorded(vol, tf, cam, settings, **kw):
        img = real(vol, tf, cam, settings, **kw)
        calls.append((vol, tf, settings, img))
        return img

    monkeypatch.setattr(api, "render", recorded)
    return calls


def test_ablation_config2_matches_jax(capsys, monkeypatch):
    """Config 2 as both ablations build it, ``head_phantom(128)`` and the
    bone TF, cut to a 24x24 frame of 12 steps: the port's inputs are the
    JAX ablation's, and so are its frames, ET on and off."""
    from volumetric_renderer_tpu.apps import ablation as jablation

    jcalls = record_renders(monkeypatch, "volumetric_renderer_tpu.render.api")
    tcalls = record_renders(monkeypatch,
                            "volumetric_renderer_torch.render.api")
    # run the JAX ablation's frames eagerly, so its inputs are arrays
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    argv = ["--iters", "1", "--skip-flagship", "--size", "24x24", "--steps",
            "12", "--methods", "fused"]
    jablation.main(argv)
    ablation.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    # a warm-up and a timed call, ET on, then ET off
    ets = [True, True, False, False]
    assert [c[2].early_termination for c in jcalls] == ets
    assert [c[2].early_termination for c in tcalls] == ets
    for (jv, jt, js, jimg), (tv, tt, ts, timg) in zip(jcalls, tcalls):
        assert tv.shape == (128, 128, 128)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                                   atol=1.2e-7)
        np.testing.assert_array_equal(tt.numpy(), ablation.bone_tf())
        assert (ts.height, ts.width, ts.step_size) == (js.height, js.width,
                                                       js.step_size)
        assert float(timg[..., 3].max()) > 0.99    # rays stop at the skull
        err = np.abs(timg.numpy() - np.asarray(jimg))
        assert err.max() <= 1.0 / 255.0 and err.mean() <= 1e-4
        # what differs is the rays: the JAX ablation's grid and TF marched
        # by the port along the JAX package's rays give the JAX frame
        vol = torch.as_tensor(np.array(jv))
        _, _, *window = frame_inputs(vol, OrbitCamera.from_angles(30.0, 20.0),
                                     ts)
        origin, dirs = jray_grid(JCamera.from_angles(30.0, 20.0), js.height,
                                 js.width)
        with torch.no_grad():
            got = make_marcher("fused", ts)(
                vol, torch.as_tensor(np.array(jt)),
                torch.as_tensor(np.array(origin)) + 0.5,
                torch.as_tensor(np.array(dirs)), *window)
        np.testing.assert_allclose(got.numpy(), np.asarray(jimg), atol=1e-5)


# -- scaling -----------------------------------------------------------------

def test_scaling_bands_unpack_to_the_full_frame(tmp_path):
    path = tmp_path / "s.json"
    out = scaling.main(["--grid", "12", "--size", "40x24", "--steps", "16",
                        "--devices", "1", "2", "4", "--iters", "1",
                        "--device", "cpu", "--out", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    runs = out["emulated_strong_scaling"]
    assert [r["devices"] for r in runs] == [1, 2, 4]
    for r in runs[1:]:
        assert set(r["layouts"]) == {"contiguous", "cyclic", "tile-cyclic",
                                     "tile-shuffle"}
        for layout in r["layouts"].values():
            assert layout["exact"] is True
            assert len(layout["band_ms"]) == r["devices"]
            assert layout["efficiency"] > 0
    val = out["dispatch_floor_validation"]
    assert val["n"] == 4 and val["one_launch_ms"] > 0


def distinct(calls):
    """The calls' ``(dirs, image)`` pairs, each ray set once, in order."""
    out = []
    for dirs, img in calls:
        if not any(dirs.shape == d.shape and np.array_equal(dirs, d)
                   for d, _ in out):
            out.append((dirs, img))
    return out


def test_scaling_bands_match_jax(monkeypatch):
    """Each band the port's emulation marches holds the rays the JAX
    emulation gives that band, in the same order, and its image is the
    JAX band's: the full frame, the all-miss floor, the validation's bands
    and every layout's bands at N = 2 and 4 (a 32x64 frame: no padding).
    The JAX app's kernel is replaced by its plain reference, the fused
    marcher, as ``test_jax_bench_keeps_only_the_last_band`` does."""
    from volumetric_renderer_tpu.apps import scaling as jscaling
    from volumetric_renderer_tpu.core.fused import make_fused_marcher
    from volumetric_renderer_tpu.kernels import slab

    jit, jcalls, tcalls = jax.jit, [], []

    def jax_marcher(steps, dt, et, eps, *a, **kw):
        march = jit(make_fused_marcher(steps, dt, et, eps))

        def recorded(vol, tf, origin, dirs, *scal):
            img = march(vol, tf, origin, dirs, *scal)
            if not isinstance(dirs, jax.core.Tracer):   # lax.map's bands
                jcalls.append((np.asarray(dirs), np.asarray(img)))
            return img

        return recorded

    kernels = importlib.import_module("volumetric_renderer_torch.kernels.march")
    march_forward = kernels.march_forward

    def recorded_forward(*args, **kw):
        img = march_forward(*args, **kw)
        tcalls.append((args[3].numpy(), img.numpy()))
        return img

    monkeypatch.setattr(slab, "make_slab_marcher", jax_marcher)
    monkeypatch.setattr(kernels, "march_forward", recorded_forward)
    # the JAX app's timed calls eagerly, so the marcher sees arrays
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    argv = ["--grid", "12", "--size", "32x64", "--steps", "16", "--devices",
            "1", "2", "4", "--iters", "1"]
    jscaling.main(argv + ["--out", os.devnull])
    scaling.main(argv + ["--device", "cpu", "--out", os.devnull])
    want, got = distinct(jcalls), distinct(tcalls)
    # the port's one launch over the 4 validation bands stacked
    stacked = got.pop(6)
    np.testing.assert_array_equal(
        stacked[0], np.concatenate([d for d, _ in got[2:6]]))
    # frame, floor, 4 validation bands, 4 layouts x (2 + 4) bands; at N = 4
    # tile-cyclic repeats the validation bands, and cyclic's 16-row blocks
    # are contiguous's bands
    assert len(got) == len(want) == 2 + 4 + 4 * (2 + 4) - 4 - 4
    for (jd, jimg), (td, timg) in zip(want, got):
        assert td.shape == jd.shape
        np.testing.assert_allclose(td, jd, atol=1e-5)       # ray drift
        np.testing.assert_allclose(timg, jimg, atol=1e-4)
    assert max(float(img[..., 3].max()) for _, img in got) > 0.5


# -- benchmark ---------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
def test_benchmark_one_device(capsys, monkeypatch, grad):
    """One device, against the JAX benchmark on one device: the checksum
    of the same workload under the same definition."""
    from volumetric_renderer_tpu.apps import benchmark as jbenchmark

    argv = ["--size", "32x32", "--steps", "12", "--grid", "8", "--iters",
            "1"] + (["--grad"] if grad else [])
    devices, ready, returned = jax.devices, jax.block_until_ready, []
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: returned.append(x) or ready(x))
    jbenchmark.main(argv)
    jax_data = last_json(capsys)
    # its checksum is taken from the first (warm-up) call's first leaf
    want = float(np.sum(jax.device_get(jax.tree.leaves(returned[0])[0])))

    out = benchmark.main(argv + ["--device", "cpu"])
    data = last_json(capsys)
    assert data == json.loads(json.dumps(out))
    assert data["workload"] == jax_data["workload"]
    assert data["workload"].endswith("/grad") == grad
    assert [r["devices"] for r in data["scaling"]] == [1]
    assert data["scaling"][0]["efficiency"] == 1.0
    assert abs(want) > 1e-2
    np.testing.assert_allclose(data["scaling"][0]["checksum"], want,
                               rtol=1e-5)
