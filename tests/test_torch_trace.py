"""The port's tracing: the spans at the layer boundaries of a train step
(``utils.metrics.span``), the counts inside K1 and K2 (their counted
instantiations, ``utils.metrics.counting``) and the all-reduce's byte
counter.

The counted kernels are held here, on the g++ build of the CUDA sources
(``tests/cuda_on_cpu``), to counts computed from the plain forward's
steps: ``sampled`` from its ``_active`` mask, ``voxel_atomics`` from the
in-grid corners of sampled steps whose density gradient is not 0 (the plain
backward's formula), ``lane_steps`` and ``tf_flushes`` from each ray's step
interval (``owned_steps_proxy``) and the warp layout (16x16 blocks, a warp
two rows of a block).  The test marked ``cuda`` does the same on the card.

This file imports neither JAX nor the JAX package.  Its worker, for the
byte counter on two ranks over gloo, is the file itself:

    python tests/test_torch_trace.py OUT_DIR WORLD RANK
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_kernels import (  # noqa: F401 (cpu_kernels: a fixture)
    BWD_ATOL,
    BWD_RTOL,
    case_inputs,
    cotangent,
    cpu_kernels,
    cpu_launch,
    own_inputs,
    owned_steps_proxy,
)
from volumetric_renderer_torch.core.fused import ALPHA_EPS, _active, _dot
from volumetric_renderer_torch.core.sampling import (
    check_own,
    trilinear_corners,
)
from volumetric_renderer_torch.kernels import march
from volumetric_renderer_torch.parallel import render as prender
from volumetric_renderer_torch.transfer.texture import tf_lerp
from volumetric_renderer_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The spans a pixel train step opens directly below ``vr.train_step``, in
#: order; ``vr.ray_setup`` opens once more, inside the march's autograd
#: function, and the kernels' spans only on a card.
STEP_SPANS = ("vr.ray_setup", "vr.loss", "vr.backward", "vr.grad_sum",
              "vr.optimizer", "vr.clamp")


# -- spans --------------------------------------------------------------------

def tiny_step(kind: str):
    """A world-of-one train step on the CPU (the plain marcher) at a tiny
    size, its state and inputs: ``step()`` runs one step."""
    from volumetric_renderer_torch import models
    from volumetric_renderer_torch.parallel.train import (
        init_depth_state,
        init_state,
        make_depth_train_step,
        make_train_step,
        stack_cameras,
    )
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.config import RenderSettings

    vol = torch.from_numpy(models.sphere(8).data)
    tf = torch.from_numpy(Gradient.grayscale_ramp().discretize(16))
    settings = RenderSettings(height=8, width=8, step_size=0.2,
                              early_termination=False, tf_resolution=16)
    cams = stack_cameras([OrbitCamera.from_angles(yaw_deg=y, pitch_deg=20.0)
                          for y in (30.0, 200.0)])
    targets = torch.rand((2, 8, 8, 4),
                         generator=torch.Generator().manual_seed(0))
    fixed = dict(vol=vol, tf=tf, dmin=vol.min(), dmax=vol.max(),
                 smin=torch.zeros(3), smax=torch.ones(3))
    params = {"vol": torch.full(vol.shape, 0.3)}

    def adam(p):
        return torch.optim.Adam(p, lr=1e-2)

    if kind == "depth":
        step_fn = make_depth_train_step(settings, optimize_vol=True,
                                        optimize_tf=False,
                                        vol_shape=vol.shape, axis=0)
        state = init_depth_state(params, adam, axis=0)
    else:
        step_fn = make_train_step(settings, optimize_vol=True,
                                  optimize_tf=False, row_layout="tile-cyclic")
        state = init_state(params, adam)
    box = [state]

    def step():
        box[0], loss = step_fn(box[0], fixed, cams, targets)
        return loss

    return step


def vr_spans(events) -> list:
    """``(start, end, name)`` of the ``vr.*`` ranges of a CPU trace, by
    start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.name.startswith("vr."))


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler collecting, a span is one shared null context: a
    train step, both kinds, and a timer's phase call no
    ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert metrics.span("vr.loss") is metrics.span("vr.k2")
    for kind in ("pixels", "depth"):
        assert torch.isfinite(tiny_step(kind)())
    timers = metrics.PhaseTimers()
    with timers.phase("train_step"):
        pass
    assert timers.counts["train_step"] == 1


@pytest.mark.parametrize("kind", ["pixels", "depth"])
def test_train_step_opens_its_spans_in_order_under_the_profiler(kind):
    """A CPU train step (world of one, the plain marcher) under the CPU
    profiler: ``vr.train_step`` holds ``vr.ray_setup``, ``vr.loss``,
    ``vr.backward``, ``vr.optimizer`` and ``vr.clamp``, in that order (the
    pixel step's ``vr.grad_sum`` between the backward and the optimizer),
    each once; ``vr.ray_setup`` opens once more inside the march's
    autograd function, and no span is left outside the step."""
    step = tiny_step(kind)
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    spans = vr_spans(prof.events())
    outer = [s for s in spans if s[2] == "vr.train_step"]
    assert len(outer) == 1
    t0, t1 = outer[0][:2]
    inner = [s for s in spans if s[2] != "vr.train_step"]
    assert all(t0 <= a and b <= t1 for a, b, _ in inner)
    want = [n for n in STEP_SPANS if kind == "pixels" or n != "vr.grad_sum"]
    firsts = []
    for name in want:
        opened = [a for a, _, n in inner if n == name]
        assert len(opened) == (2 if name == "vr.ray_setup" else 1), name
        firsts.append(opened[0])
    assert firsts == sorted(firsts)
    assert {n for _, _, n in inner} == set(want)


def test_phase_timers_phase_is_a_span_and_its_report_is_unchanged(
        monkeypatch):
    clock = iter([0.0, 0.5, 1.0, 1.25])
    monkeypatch.setattr(metrics.time, "perf_counter", lambda: next(clock))
    timers = metrics.PhaseTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.phase("train_step"):
            torch.ones(4).sum()
    with timers.phase("train_step"):
        pass
    names = [e.name for e in prof.events()]
    assert names.count("train_step") == 1 and "aten::sum" in names
    assert timers.report() == {"train_step": {"total_s": 0.75, "count": 2,
                                              "mean_ms": 375.0}}


# -- the counts inside the kernels --------------------------------------------

def warps(a: np.ndarray) -> np.ndarray:
    """An ``(H, W)`` per-pixel array as ``(warps, 32)``: 16x16-pixel
    blocks, a warp two rows of a block, pixels past the image 0."""
    h, w = a.shape
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    full = np.zeros((hp, wp), a.dtype)
    full[:h, :w] = a
    return full.reshape(hp // 2, 2, wp // 16, 16).transpose(0, 2, 1, 3) \
        .reshape(-1, 32)


def _first(cond: np.ndarray, k_from: np.ndarray, none: int) -> np.ndarray:
    """The first step k >= k_from where ``cond`` ``(S, H, W)`` holds, or
    ``none``."""
    k = np.arange(cond.shape[0])[:, None, None]
    cond = cond & (k >= k_from)
    return np.where(cond.any(0), cond.argmax(0), none)


def plain_counts(args, kw, g) -> dict:
    """K1's and K2's counts (``march.COUNTED``) for these inputs and the
    cotangent ``g``, from the plain forward's steps (``march_prepared``'s
    check hook): a step samples where ``_active`` holds; K2 adds to the 8
    in-grid corners of a sample whose density gradient (the plain
    backward's formula) is not 0; a lane's walk is its step interval
    (``owned_steps_proxy``) up to the box exit or early termination; a
    warp's lane steps are 32 times the longest walk of its lanes, K2's
    loop taking one trip more where a ray ends other than at the box's
    exit; K2 flushes in each trip in which a lane's TF run ends."""
    vol, tf, pos0, dirs, hit, dmin, inv_w, smin, smax = args
    own = check_own(kw.get("own"), tuple(vol.shape))
    n_steps, et, eps = (kw["num_steps"], kw["early_termination"],
                        kw["termination_eps"])
    seen = {}
    out = march.march_forward_plain(
        *args, **kw,
        check=lambda stage, k, x: seen.setdefault(stage, []).append(x))
    pos, t_all = torch.stack(seen["pos"]), torch.stack(seen["t"])
    after = torch.stack(seen["transmittance"])
    before = torch.cat([torch.ones_like(after[:1]), after[:-1]])
    active = torch.stack([_active(pos[k], hit, smin, smax, before[k],
                                  vol.shape, own, et, eps)
                          for k in range(n_steps)])

    # K2's voxel atomics: the plain backward's step, counted
    n, amax = tf.shape[0], 1.0 - ALPHA_EPS
    g_rgb, g_alpha = g[..., :3], torch.where(hit, g[..., 3], 0.0)
    big_g, tr_fin = _dot(g_rgb, out), 1.0 - out[..., 3]
    tr, p = torch.ones(hit.shape), torch.zeros(hit.shape)
    atomics, lo_all, hi_all = 0, [], []
    for k in range(n_steps):
        act = active[k]
        lo, hi, w = tf_lerp(n, torch.where(act, t_all[k], 0.0))
        lo_all.append(lo)
        hi_all.append(hi)
        rgba = tf[lo] * (1.0 - w[..., None]) + tf[hi] * w[..., None]
        a = torch.where(act, torch.clamp(rgba[..., 3], max=amax), 0.0)
        gc = _dot(g_rgb, rgba[..., :3])
        p = p + tr * a * gc
        dl_dc = torch.where(act[..., None], (tr * a)[..., None] * g_rgb, 0.0)
        dl_da = tr * gc + (g_alpha * tr_fin - (big_g - p)) / torch.clamp(
            1.0 - a, min=ALPHA_EPS)
        dl_da = torch.where(act & ~(rgba[..., 3] > amax), dl_da, 0.0)
        dl_dt = _dot(torch.cat([dl_dc, dl_da[..., None]], -1),
                     (tf[hi] - tf[lo]) * n, 4)
        adds = act & (dl_dt * inv_w != 0.0)
        atomics += sum(int((valid & adds).sum()) for _, valid, _ in
                       trilinear_corners(vol.shape, pos[k], own))
        tr = tr * (1.0 - a)

    # each lane's walk: its interval, up to the box exit or termination
    k_begin, k_end = owned_steps_proxy(pos0, dirs, kw.get("own"), n_steps,
                                       kw["step_size"])
    live = hit.numpy() & (k_end > k_begin)
    never = n_steps + 2
    k_left = _first(~((pos >= 0) & (pos <= 1)).all(-1).numpy(), k_begin,
                    never)
    k_et = _first(~(before > eps).numpy(), k_begin, never) if et else never
    k1_walk = np.where(live, np.minimum(np.minimum(k_end, k_et + 1),
                                        k_left + 1) - k_begin, 0)
    k2_trips = np.where(live, np.minimum(np.minimum(k_end, k_et), k_left)
                        - k_begin + 1, 0)

    # K2's flushes: the trips in which any lane's TF run ends
    act, lo_all, hi_all = active.numpy(), torch.stack(lo_all).numpy(), \
        torch.stack(hi_all).numpy()
    ends = np.zeros(hit.shape + (n_steps + 3,), bool)
    for y, x in zip(*np.nonzero(live)):
        run = None
        for i in range(k2_trips[y, x]):
            k = k_begin[y, x] + i
            sampled = i < k2_trips[y, x] - 1 and act[k, y, x]
            texels = (lo_all[k, y, x], hi_all[k, y, x]) if sampled else None
            if run is not None and (texels != run if sampled else
                                    i == k2_trips[y, x] - 1):
                ends[y, x, i] = True
            if sampled:
                run = texels
    flushes = sum(int(warps(ends[..., i]).any(-1).sum())
                  for i in range(ends.shape[-1]))
    sampled = int(active.sum())
    return {"k1": {"sampled": sampled,
                   "lane_steps": 32 * int(warps(k1_walk).max(-1).sum())},
            "k2": {"sampled": sampled,
                   "lane_steps": 32 * int(warps(k2_trips).max(-1).sum()),
                   "voxel_atomics": atomics, "tf_flushes": flushes}}


COUNT_CASES = [("orient_30_20", None), ("early_termination", None),
               ("slicing", None), ("image_30x20", None),
               ("orient_200_5", (1, 4, 0)), ("graze_faces", (2, 4, 1)),
               ("near_constant", (0, 4, 1)), ("near_constant_et", (0, 4, 2)),
               ("close_wide_fov", (0, 4, 1))]


def inputs(name, own, device="cpu"):
    return case_inputs(name, device) if own is None else \
        own_inputs(name, *own, device)


@pytest.mark.parametrize("name,own", COUNT_CASES)
def test_counted_kernels_compiled_for_cpu_count_what_plain_counts(
        cpu_kernels, monkeypatch, name, own):
    """The counted instantiations of K1 and K2 (the g++ build), launched
    through the counter buffer that ``counting`` switches on: their counts
    equal :func:`plain_counts`, K1's output is the uncounted launch's bit
    for bit and K2's gradients lie within K2's bars of the uncounted
    launch's (its atomics add in another order)."""
    monkeypatch.setattr(march, "counts", march.KernelCounts())
    args, kw = inputs(name, own)
    g = cotangent(args)
    out = cpu_launch(cpu_kernels, args, kw)
    grads = cpu_launch(cpu_kernels, args, kw, out, g, shared_table=True)
    with metrics.counting():
        counted_out = cpu_launch(cpu_kernels, args, kw,
                                 counts=march.counts.pointer("cpu", "k1"))
        counted_grads = cpu_launch(
            cpu_kernels, args, kw, out, g, shared_table=True,
            counts=march.counts.pointer("cpu", "k2"))
    assert torch.equal(counted_out, out)
    for a, b in zip(counted_grads, grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=BWD_ATOL,
                                   rtol=BWD_RTOL)
    got = metrics.read_counters("cpu")
    want = plain_counts(args, kw, g)
    assert {k: got[k] for k in want} == want
    assert want["k2"]["voxel_atomics"] > 0 and want["k2"]["tf_flushes"] > 0
    assert want["k1"]["lane_steps"] > want["k1"]["sampled"] > 0


def test_counting_resets_the_counters_and_is_off_outside_its_block(
        cpu_kernels, monkeypatch):
    """``counting`` resets every counter ``read_counters`` reads and lets a
    launch take a counter buffer only inside its block: a launch after it
    leaves the counts as they were.  No counted launch on a device: its
    kernel counts read None."""
    monkeypatch.setattr(march, "counts", march.KernelCounts())
    assert march.counts.pointer("cpu", "k1") is None
    assert metrics.read_counters("cpu")["k1"] is None
    monkeypatch.setattr(march.march_forward, "launches", 5)
    monkeypatch.setattr(march.march_forward, "texture_fills", 2)
    monkeypatch.setattr(prender.all_reduce_sum, "bytes", 7)
    args, kw = case_inputs("orient_30_20", "cpu")
    with metrics.counting():
        got = metrics.read_counters("cpu")
        assert (got["k1_launches"], got["texture_fills"],
                got["nccl_bytes"]) == (0, 0, 0)
        cpu_launch(cpu_kernels, args, kw,
                   counts=march.counts.pointer("cpu", "k1"))
    counted = metrics.read_counters("cpu")
    assert counted["k1"]["sampled"] > 0 and counted["k2"] == dict.fromkeys(
        march.COUNTED["k2"], 0)
    assert march.counts.pointer("cpu", "k1") is None
    cpu_launch(cpu_kernels, args, kw,
               counts=march.counts.pointer("cpu", "k1"))
    assert metrics.read_counters("cpu") == counted
    with metrics.counting():
        assert metrics.read_counters("cpu")["k1"]["sampled"] == 0


# -- the all-reduce's bytes on two ranks --------------------------------------

def worker(out_dir, world, rank):
    """Two pixel train steps of a 8^3 grid on this rank under ``counting``;
    ``read_counters`` to ``out_dir/rank{rank}.json``."""
    from volumetric_renderer_torch import models
    from volumetric_renderer_torch.parallel import distributed
    from volumetric_renderer_torch.parallel.train import (
        init_state,
        make_train_step,
        stack_cameras,
    )
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.config import RenderSettings

    torch.set_num_threads(1)
    distributed.init_distributed(f"file://{os.path.join(out_dir, 'store')}",
                                 world, rank, device="cpu")
    vol = torch.from_numpy(models.sphere(8).data)
    tf = torch.from_numpy(Gradient.grayscale_ramp().discretize(16))
    settings = RenderSettings(height=8, width=16, step_size=0.2,
                              early_termination=False, tf_resolution=16)
    cams = stack_cameras([OrbitCamera.from_angles(yaw_deg=30.0,
                                                  pitch_deg=20.0)])
    fixed = dict(vol=vol, tf=tf, dmin=vol.min(), dmax=vol.max(),
                 smin=torch.zeros(3), smax=torch.ones(3))
    step = make_train_step(settings, optimize_vol=True, optimize_tf=True,
                           row_layout="tile-cyclic")
    state = init_state({"vol": torch.full(vol.shape, 0.3), "tf": tf},
                       lambda p: torch.optim.Adam(p, lr=1e-2))
    targets = torch.rand((1, 8, 16, 4), generator=torch.Generator()
                         .manual_seed(0))
    with metrics.counting():
        for _ in range(2):
            state, _ = step(state, fixed, cams, targets)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(metrics.read_counters("cpu"), f)


def test_the_all_reduce_counts_the_bytes_it_hands_the_process_group(
        tmp_path):
    """Two gloo ranks, two pixel train steps fitting the grid and the TF:
    each rank hands the all-reduce the grid's gradient (8^3 float32), the
    TF's (16 x 4) and the loss a step, and counts those bytes."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp_path), "2",
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for r in range(2)]
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            got = json.load(f)
        assert got["nccl_bytes"] == 2 * 4 * (8 ** 3 + 16 * 4 + 1)
        assert got["k1"] is None and got["k1_launches"] == 0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,own", [("orient_30_20", None),
                                      ("early_termination", None),
                                      ("near_constant", (0, 4, 1))])
def test_counted_kernels_count_what_plain_counts_on_cuda(cuda, monkeypatch,
                                                         name, own):
    """K1 and K2 through their wrappers on the card: outside ``counting``
    the uncounted launches leave the counts alone; inside, the counted
    ones count :func:`plain_counts` (the plain steps on the same inputs,
    on the CPU) and give the uncounted outputs (K1 bit for bit, K2 within
    its bars)."""
    monkeypatch.setattr(march, "counts", march.KernelCounts())
    args, kw = inputs(name, own)
    g = cotangent(args)
    dev_args = tuple(x.to(cuda) if torch.is_tensor(x) else x for x in args)
    out = march.march_forward(*dev_args, **kw)
    grads = march.march_backward(*dev_args, out, g.to(cuda), **kw)
    with metrics.counting():
        counted_out = march.march_forward(*dev_args, **kw)
        counted_grads = march.march_backward(*dev_args, out, g.to(cuda), **kw)
        got = metrics.read_counters(cuda)
    assert torch.equal(counted_out, out)
    for a, b in zip(counted_grads, grads):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=BWD_ATOL, rtol=BWD_RTOL)
    want = plain_counts(args, kw, g)
    assert {k: got[k] for k in want} == want
    assert (got["k1_launches"], got["k2_launches"]) == (1, 1)
    march.march_forward(*dev_args, **kw)
    march.march_backward(*dev_args, out, g.to(cuda), **kw)
    assert {k: metrics.read_counters(cuda)[k] for k in want} == want


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
