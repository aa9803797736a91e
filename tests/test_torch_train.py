"""The port's training slice against the JAX package: the single-device
train step, Adam, checkpoint/resume, the optimize app and the phase timers.

The train-step comparison feeds both packages the same rays (the JAX
package's ``ray_grid``, patched into the port's ``core.marcher``), as the
marcher parity tests do: each package's own rays differ by up to ~4e-6
(``tests/test_torch_render.py``).  Tolerances:
* SGD steps: rtol 1e-5 on the losses and atol 1e-6 on the parameters after
  three steps (f32 sums over rays and steps taken in another order);
* Adam: rtol 1e-6 / atol 1e-6 from identical gradients (the two place the
  bias corrections differently, so parameters of order 1 differ by a few
  ulps).  Adam is checked apart from the train step because it turns a
  gradient whose sign flips at the noise floor into a difference of 2 * lr;
* checkpoint resume on the CPU: bitwise.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volumetric_renderer_tpu.parallel.mesh import make_mesh
from volumetric_renderer_tpu.parallel.train import init_state as jinit_state
from volumetric_renderer_tpu.parallel.train import (
    make_train_step as jmake_train_step,
)
from volumetric_renderer_tpu.render import api as japi
from volumetric_renderer_tpu.scene.camera import OrbitCamera as JCamera
from volumetric_renderer_tpu.scene.camera import ray_grid as jray_grid
from volumetric_renderer_tpu.utils.config import RenderSettings as JSettings
from volumetric_renderer_torch import models
from volumetric_renderer_torch.core import marcher
from volumetric_renderer_torch.parallel.train import (
    camera_views,
    init_state,
    make_train_step,
)
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils import metrics
from volumetric_renderer_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from volumetric_renderer_torch.utils.config import RenderSettings

N, NTF, STEPS, HW = 8, 16, 12, 16
SETTINGS = dict(height=HW, width=HW, step_size=1.8 / STEPS,
                early_termination=False, tf_resolution=NTF)
YAWS = (0.0, 180.0)


@pytest.fixture
def jax_rays(monkeypatch):
    """Make the port march the JAX package's rays for its cameras."""

    def rays(camera, height, width, fov_y_degrees=40.0, near=0.1,
             far=10.0):
        jcam = JCamera(camera.center.numpy(), camera.orientation.numpy(),
                       camera.radius.numpy())
        o, d = jray_grid(jcam, height, width, fov_y_degrees, near, far)
        return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))

    monkeypatch.setattr(marcher, "ray_grid", rays)


def scene():
    """Ground truth (8^3 sphere, TF alpha ramp to 0.8), two posed views,
    targets rendered by the JAX package, and the initial parameters."""
    vol = models.sphere(N).data
    tf = Gradient.grayscale_ramp().discretize(NTF)
    tf[:, 3] = np.linspace(0.0, 0.8, NTF, dtype=np.float32)
    jcams = [JCamera.from_angles(yaw_deg=a, pitch_deg=20.0) for a in YAWS]
    targets = np.stack([np.asarray(japi.render(
        jnp.asarray(vol), jnp.asarray(tf), c, JSettings(**SETTINGS),
        density_min=0.0, density_max=1.0, method="fused")) for c in jcams])
    init = dict(vol=np.full_like(vol, 0.3),
                tf=np.random.default_rng(0).uniform(0.2, 0.8, (NTF, 4))
                .astype(np.float32))
    return vol, tf, jcams, targets, init


def port_cameras(jcams):
    return [OrbitCamera(np.array(c.center), np.array(c.orientation),
                        np.array(c.radius)) for c in jcams]


def port_fixed(vol, tf):
    return dict(vol=torch.from_numpy(vol), tf=torch.from_numpy(tf),
                dmin=torch.tensor(float(vol.min())),
                dmax=torch.tensor(float(vol.max())),
                smin=torch.zeros(3), smax=torch.ones(3))


@pytest.mark.parametrize("mode,lr", [("tf-fit", 20.0), ("invert", 200.0)])
def test_train_step_matches_jax_under_sgd(jax_rays, mode, lr):
    vol, tf, jcams, targets, init = scene()
    key = "vol" if mode == "invert" else "tf"
    flags = dict(optimize_vol=mode == "invert", optimize_tf=mode == "tf-fit")

    opt = optax.sgd(lr)
    jstep = jmake_train_step(make_mesh(jax.devices()[:1]),
                             JSettings(**SETTINGS), opt, method="fused",
                             **flags)
    jstate = jinit_state(opt, {key: jnp.asarray(init[key])})
    jfixed = dict(vol=jnp.asarray(vol), tf=jnp.asarray(tf),
                  dmin=jnp.float32(vol.min()), dmax=jnp.float32(vol.max()),
                  smin=jnp.zeros(3), smax=jnp.ones(3))
    jcameras = jax.tree.map(lambda *xs: jnp.stack(xs), *jcams)

    step = make_train_step(RenderSettings(**SETTINGS), method="fused",
                           **flags)
    state = init_state({key: torch.from_numpy(init[key])},
                       lambda p: torch.optim.SGD(p, lr=lr))
    fixed, cams = port_fixed(vol, tf), port_cameras(jcams)
    tgt = torch.from_numpy(targets)

    for i in range(3):
        jstate, jloss = jstep(jstate, jfixed, jcameras, jnp.asarray(targets))
        state, loss = step(state, fixed, cams, tgt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == 3 and int(jstate.step) == 3
    got, want = state.params[key].detach().numpy(), np.asarray(
        jstate.params[key])
    moved = np.abs(want - init[key]).max()
    assert moved > 1e-3, moved           # the steps moved the parameters
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_adam_update_matches_optax():
    """``torch.optim.Adam`` defaults compute ``optax.adam``'s update."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    opt = optax.adam(5e-2)
    jp = jnp.asarray(p0)
    jst = opt.init(jp)
    p = torch.from_numpy(p0.copy()).requires_grad_(True)
    topt = torch.optim.Adam([p], lr=5e-2)
    for g in grads:
        upd, jst = opt.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-6)


def test_train_step_takes_a_batched_camera_and_clamps():
    vol, tf, jcams, targets, init = scene()
    cams = port_cameras(jcams)
    batched = OrbitCamera(torch.stack([c.center for c in cams]),
                          torch.stack([c.orientation for c in cams]),
                          torch.stack([c.radius for c in cams]))
    views = camera_views(batched)
    assert len(views) == 2
    for a, b in zip(views, cams):
        assert torch.equal(a.orientation, b.orientation)
    assert len(camera_views(cams[0])) == 1

    step = make_train_step(RenderSettings(**SETTINGS), optimize_vol=False,
                           optimize_tf=True)
    state = init_state({"tf": torch.from_numpy(init["tf"])},
                       lambda p: torch.optim.SGD(p, lr=1e4))
    state, loss = step(state, port_fixed(vol, tf), batched,
                       torch.from_numpy(targets))
    t = state.params["tf"]
    assert torch.isfinite(loss) and t.min() >= 0.0 and t.max() <= 1.0
    assert ((t == 0.0) | (t == 1.0)).any()     # the huge step hit a clamp


def adam_invert_state():
    vol, tf, jcams, targets, init = scene()
    state = init_state({"vol": torch.from_numpy(init["vol"])},
                       lambda p: torch.optim.Adam(p, lr=5e-2))
    step = make_train_step(RenderSettings(**SETTINGS), optimize_vol=True,
                           optimize_tf=False)
    return (state, step, port_fixed(vol, tf), port_cameras(jcams),
            torch.from_numpy(targets))


def test_checkpoint_resume_is_bitwise(tmp_path):
    """Four steps straight equal two steps, save, load into a fresh state,
    and two more steps, bit for bit on the CPU."""
    state, step, fixed, cams, targets = adam_invert_state()
    straight = []
    for _ in range(4):
        state, loss = step(state, fixed, cams, targets)
        straight.append(float(loss))

    state2, _, _, _, _ = adam_invert_state()
    split = []
    for _ in range(2):
        state2, loss = step(state2, fixed, cams, targets)
        split.append(float(loss))
    path = save_checkpoint(str(tmp_path / "ckpt_2.pt"), state2)
    assert state2.step == 2 and latest_checkpoint(str(tmp_path)) == path

    fresh, _, _, _, _ = adam_invert_state()
    resumed, start = load_checkpoint(path, fresh)
    assert start == 2 and resumed.step == 2
    for _ in range(2):
        resumed, loss = step(resumed, fixed, cams, targets)
        split.append(float(loss))
    assert split == straight
    np.testing.assert_array_equal(resumed.params["vol"].detach().numpy(),
                                  state.params["vol"].detach().numpy())
    a = state.optimizer.state_dict()["state"][0]
    b = resumed.optimizer.state_dict()["state"][0]
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_helpers(tmp_path):
    state, *_ = adam_invert_state()
    assert latest_checkpoint(str(tmp_path / "none")) is None
    for s in (3, 12, 7):
        save_checkpoint(str(tmp_path / f"ckpt_{s}.pt"), state, s)
    (tmp_path / "ckpt_x.pt").write_text("not a step")
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_12.pt")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    other = init_state({"tf": torch.zeros(NTF, 4)},
                       lambda p: torch.optim.Adam(p, lr=1e-2))
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(str(tmp_path / "ckpt_3.pt"), other)


def test_optimize_app_invert_and_resume(tmp_path, capsys):
    from volumetric_renderer_torch.apps.optimize import main

    ck, out = str(tmp_path / "ck"), str(tmp_path / "vol.npy")
    common = ["invert", "--grid", "8", "--size", "24x24", "--march-steps",
              "12", "--views", "2", "--ckpt-dir", ck, "--device", "cpu",
              "--out", out]
    first = main(common + ["--steps-opt", "6", "--ckpt-every", "5"])
    assert first["start"] == 0 and len(first["losses"]) == 6
    assert first["method"] == "fused" and first["device"] == "cpu"
    assert first["losses"][-1] < first["losses"][0]
    assert np.load(out).shape == (8, 8, 8)
    assert latest_checkpoint(ck).endswith("ckpt_5.pt")
    second = main(common + ["--steps-opt", "8", "--resume"])
    assert second["start"] == 5 and len(second["losses"]) == 3
    err = capsys.readouterr().err
    assert "resumed from" in err and "at step 5" in err
    assert "grid max abs err vs ground truth" in err


def test_optimize_app_tf_fit(tmp_path):
    from volumetric_renderer_torch.apps.optimize import main

    out = str(tmp_path / "tf.npy")
    res = main(["tf-fit", "--grid", "8", "--size", "24x24",
                "--march-steps", "12", "--views", "2", "--steps-opt", "4",
                "--tf-resolution", "32", "--device", "cpu", "--out", out])
    tf = np.load(out)
    assert tf.shape == (32, 4) and tf.min() >= 0.0 and tf.max() <= 1.0
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]


def test_optimize_app_device_cuda_without_cuda_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from volumetric_renderer_torch.apps.optimize import main

    with pytest.raises(SystemExit, match="CUDA"):
        main(["tf-fit", "--grid", "8", "--size", "8x8", "--device", "cuda"])


def test_phase_timers_and_meter(monkeypatch, caplog):
    clock = iter([0.0, 0.5, 1.0, 1.25, 2.0, 4.0, 5.0])
    monkeypatch.setattr(metrics.time, "perf_counter", lambda: next(clock))
    timers = metrics.PhaseTimers()
    with timers.phase("train_step"):
        pass
    with timers.phase("train_step"):
        pass
    rep = timers.report()
    assert rep == {"train_step": {"total_s": 0.75, "count": 2,
                                  "mean_ms": 375.0}}
    with caplog.at_level(logging.INFO, logger="volumetric_renderer_torch"):
        timers.log_report({"rays": 10})
    assert json.loads(caplog.records[-1].getMessage()) == {
        "phases": rep, "rays": 10}

    meter = metrics.ThroughputMeter(window=2)
    assert meter.tick(100) is None          # t = 2.0
    assert meter.tick(100) == 50.0          # 100 items in 2 s
    assert meter.tick(300) == 400.0 / 3.0   # 400 items in 3 s


def test_trace_writes_a_chrome_trace(tmp_path):
    with metrics.trace(str(tmp_path)):
        torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
