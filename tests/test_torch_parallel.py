"""The port's ``parallel/`` on ``torch.distributed``: the pixel layouts
against the JAX package's, and real multi-process runs on the CPU (gloo)
with 2 and 4 ranks of the pixel-sharded and depth-sharded renderers and
train steps against the port's unsharded render and single-process step.

The worker is this file run as a script:

    python tests/test_torch_parallel.py OUT_DIR WORLD RANK

Each rank joins a process group through a ``FileStore`` under ``OUT_DIR``,
runs every scenario and saves its results to ``OUT_DIR/rank{RANK}.pt``;
the tests compare them with references made in the test process.

Tolerances:
* the sharded forward against the unsharded render: atol 1e-6 (each ray is
  marched by the same operations; only the packing moves it);
* pixel-sharded gradients: ``2e-4 * max|g|`` (``tests/test_parallel.py``:
  sums over rays taken per rank, then across ranks);
* depth-sharded forward, gradients and steps: ``5e-4 * max|g|``
  (``tests/test_depth.py``: the over-fold reassociates every composite);
* all views in one march against one march per view: the frames bit for
  bit (the same operations on each ray); loss rtol 1e-5, gradients atol
  1e-4 / rtol 1e-5 (the scatters add the same terms in another order);
* every rank's parameters after a step: identical.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NTF, HW, STEP = 16, 32, (24, 16), 0.05
LAYOUTS = ("contiguous", "cyclic", "tile-cyclic", "tile-shuffle")
GRAD_LAYOUTS = ("contiguous", "tile-cyclic")
YAWS = (33.0, 213.0)            # one view marching each way
# two opposite eyes: their rays march both ways along every axis
OPPOSED = ((33.0, 21.0), (213.0, -21.0))
DEPTH_AXES = (0, 1, 2)
LR = 100.0


def scene():
    """Grid, TF, settings and two views, from NumPy."""
    from volumetric_renderer_torch import models
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.config import RenderSettings

    vol = torch.from_numpy(models.sphere(N).data)
    tf = Gradient.grayscale_ramp().discretize(NTF)
    tf[:, 3] = np.linspace(0.0, 0.7, NTF, dtype=np.float32)
    settings = RenderSettings(height=HW[0], width=HW[1], step_size=STEP,
                              early_termination=False, tf_resolution=NTF)
    cams = [OrbitCamera.from_angles(yaw_deg=y, pitch_deg=21.0) for y in YAWS]
    return vol, torch.from_numpy(tf), settings, cams


def window():
    return (torch.tensor(0.0), torch.tensor(1.0), torch.zeros(3),
            torch.ones(3))


def leaves(vol, tf):
    """Fresh leaves requiring grad: grid, TF, dmin, dmax."""
    out = [vol.clone(), tf.clone(), torch.tensor(0.0), torch.tensor(1.0)]
    return [x.requires_grad_(True) for x in out]


def grads_of(render_fn, vol, tf, cam):
    """``(img, [vol_g, tf_g, dmin_g, dmax_g])`` of ``sum(sin(3 img))``."""
    xs = leaves(vol, tf)
    img = render_fn(xs[0], xs[1], cam, xs[2], xs[3], torch.zeros(3),
                    torch.ones(3))
    torch.sum(torch.sin(3.0 * img)).backward()
    return img.detach(), [x.grad for x in xs]


def opposed_cameras():
    from volumetric_renderer_torch.scene.camera import OrbitCamera

    return [OrbitCamera.from_angles(yaw_deg=y, pitch_deg=p)
            for y, p in OPPOSED]


def targets_of(vol, tf, settings, cams):
    from volumetric_renderer_torch.render.api import render

    return torch.stack([render(vol, tf, c, settings, density_min=0.0,
                               density_max=1.0, method="fused")
                        for c in cams])


def sgd_state(vol, tf):
    from volumetric_renderer_torch.parallel.train import init_state

    return init_state({"vol": torch.full_like(vol, 0.3), "tf": tf * 0.5},
                      lambda p: torch.optim.SGD(p, lr=LR))


def fixed_of(vol, tf):
    dmin, dmax, smin, smax = window()
    return dict(vol=vol, tf=tf, dmin=dmin, dmax=dmax, smin=smin, smax=smax)


def batched_step(settings, layout, vol, tf, fixed, cams, targets):
    """``(loss, [vol_g, tf_g])`` of one step of ``make_train_step`` (every
    view in one march), read after an SGD step of rate 0."""
    from volumetric_renderer_torch.parallel.train import (
        init_state, make_train_step,
    )

    step = make_train_step(settings, optimize_vol=True, optimize_tf=True,
                           row_layout=layout)
    state = init_state({"vol": vol, "tf": tf},
                       lambda p: torch.optim.SGD(p, lr=0.0))
    state, loss = step(state, fixed, cams, targets)
    return float(loss), [state.params[k].grad for k in ("vol", "tf")]


def per_view_step(settings, layout, vol, tf, fixed, cams, targets):
    """The same loss and gradients by a loop over the views: the one-camera
    sharded renderer per view, each view's loss differentiated alone, the
    sums taken across the ranks once after the loop."""
    import torch.distributed as dist

    from volumetric_renderer_torch.parallel.mesh import (
        group_info, make_layout,
    )
    from volumetric_renderer_torch.parallel.render import (
        all_reduce_grads, make_sharded_renderer,
    )

    _, rank, world = group_info()
    h, w = settings.height, settings.width
    f = make_sharded_renderer(None, settings, row_layout=layout,
                              permuted_output=True, reduce_grads=False)
    gh, _, pack, _, valid = make_layout(layout, h, w, world)
    rows = gh // world
    mask = valid[rank * rows:(rank + 1) * rows, :, None]
    xs = [x.detach().clone().requires_grad_(True) for x in (vol, tf)]
    total = torch.zeros(())
    for i, cam in enumerate(cams):
        img = f(*xs, cam, fixed["dmin"], fixed["dmax"], fixed["smin"],
                fixed["smax"])
        target = pack(targets[i])[rank * rows:(rank + 1) * rows]
        loss_v = torch.sum((img - target) ** 2 * mask) / float(h * w * 4)
        (loss_v / len(cams)).backward()
        total = total + loss_v.detach()
    all_reduce_grads(xs)
    if world > 1:
        dist.all_reduce(total)
    return float(total / len(cams)), [x.grad for x in xs]


def batched_depth_step(settings, axis, vol, tf, fixed, cams, targets, lr):
    """One step of ``make_depth_train_step`` (every view in one call of
    the depth-sharded renderer) from the whole grid ``vol`` and the TF
    ``tf`` under ``torch.optim.SGD(lr)``: ``(loss, [vol_g, tf_g], [vol,
    tf])``, this rank's rows of the grid."""
    from volumetric_renderer_torch.parallel.train import (
        init_depth_state, make_depth_train_step,
    )

    step = make_depth_train_step(settings, optimize_vol=True,
                                 optimize_tf=True, vol_shape=vol.shape,
                                 axis=axis)
    state = init_depth_state({"vol": vol, "tf": tf},
                             lambda p: torch.optim.SGD(p, lr=lr), axis=axis)
    state, loss = step(state, fixed, cams, targets)
    xs = [state.params[k] for k in ("vol", "tf")]
    return float(loss), [x.grad for x in xs], [x.detach() for x in xs]


def per_view_depth_step(settings, axis, vol, tf, fixed, cams, targets, lr):
    """:func:`batched_depth_step` by a loop over the views: the one-camera
    depth-sharded renderer per view, each view's loss differentiated
    alone, the TF gradient summed across the ranks once after the loop,
    then the SGD step and the clamps."""
    from volumetric_renderer_torch.parallel.depth import (
        make_depth_sharded_renderer, split_rows,
    )
    from volumetric_renderer_torch.parallel.render import all_reduce_grads

    f = make_depth_sharded_renderer(None, settings, vol_shape=vol.shape,
                                    axis=axis, reduce_grads=False)
    xs = [split_rows(vol, axis).requires_grad_(True),
          tf.detach().clone().requires_grad_(True)]
    opt = torch.optim.SGD(xs, lr=lr)
    total = torch.zeros(())
    for i, cam in enumerate(cams):
        img = f(*xs, cam, fixed["dmin"], fixed["dmax"], fixed["smin"],
                fixed["smax"])
        loss_v = torch.mean((img - targets[i]) ** 2)
        (loss_v / len(cams)).backward()
        total = total + loss_v.detach()
    all_reduce_grads([xs[1]])
    opt.step()
    with torch.no_grad():
        xs[0].clamp_(min=0.0)
        xs[1].clamp_(0.0, 1.0)
    return (float(total / len(cams)), [x.grad for x in xs],
            [x.detach() for x in xs])


def assert_depth_steps_equal(got, want):
    """The batched depth step against the per-view loop: loss rtol 1e-6,
    gradients and parameters after the step atol 1e-4 / rtol 1e-5."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-5)


def assert_steps_equal(got, want):
    """Loss and gradients of the batched step against the per-view loop:
    rtol 1e-5 on the loss, atol 1e-4 / rtol 1e-5 on the gradients."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for a, b in zip(got[1], want[1]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-5)


# -- the worker ---------------------------------------------------------------

def worker(out_dir, world, rank):
    """Every scenario on this rank; results to ``out_dir/rank{rank}.pt``."""
    import torch.distributed as dist

    from volumetric_renderer_torch.parallel import depth, distributed
    from volumetric_renderer_torch.parallel.render import (
        make_sharded_renderer,
    )
    from volumetric_renderer_torch.parallel.train import (
        init_depth_state, make_depth_train_step, make_train_step,
        stack_cameras,
    )
    from volumetric_renderer_torch.utils import metrics

    torch.set_num_threads(1)
    dev = distributed.init_distributed(
        f"file://{os.path.join(out_dir, 'store')}", world, rank, device="cpu")
    vol, tf, settings, cams = scene()
    res = {"device": str(dev), "world": dist.get_world_size(),
           "rank": dist.get_rank()}
    for layout in LAYOUTS:
        f = make_sharded_renderer(None, settings, row_layout=layout)
        res[f"pixels_fwd_{layout}"] = f(vol, tf, cams[0], *window())
    for layout in GRAD_LAYOUTS:
        f = make_sharded_renderer(None, settings, row_layout=layout)
        res[f"pixels_grads_{layout}"] = grads_of(f, vol, tf, cams[0])[1]

    for axis in DEPTH_AXES:
        f = depth.make_depth_sharded_renderer(None, settings,
                                              vol_shape=vol.shape, axis=axis)
        local = depth.split_rows(vol, axis)
        for i, cam in enumerate(cams):
            img, (g_local, *rest) = grads_of(f, local, tf, cam)
            res[f"depth_fwd_{axis}_{i}"] = img
            res[f"depth_grads_{axis}_{i}"] = [
                depth.gather_rows(g_local, axis), *rest]
        dmin, dmax = depth.global_window(local)
        res[f"depth_window_{axis}"] = (float(dmin), float(dmax))
        both = opposed_cameras()
        res[f"depth_batched_{axis}"] = (
            grads_of(f, local, tf, stack_cameras(both)),
            [grads_of(f, local, tf, c) for c in both])

    targets = targets_of(vol, tf, settings, cams)
    init = sgd_state(vol, tf).params
    for layout in GRAD_LAYOUTS:
        f = make_sharded_renderer(None, settings, row_layout=layout)
        res[f"batched_render_{layout}"] = (
            grads_of(f, vol, tf, stack_cameras(cams)),
            [grads_of(f, vol, tf, c) for c in cams])
        args = (settings, layout, init["vol"].detach(), init["tf"].detach(),
                fixed_of(vol, tf), cams, targets)
        res[f"batched_step_{layout}"] = (batched_step(*args),
                                         per_view_step(*args))
    step = make_train_step(settings, optimize_vol=True, optimize_tf=True,
                           row_layout="tile-cyclic")
    state, loss = step(sgd_state(vol, tf), fixed_of(vol, tf), cams, targets)
    res["pixels_step"] = (float(loss), state.params["vol"].detach(),
                          state.params["tf"].detach())
    for layout in LAYOUTS:
        step = make_train_step(settings, optimize_vol=True,
                               optimize_tf=True, row_layout=layout)
        with metrics.counting():
            step(sgd_state(vol, tf), fixed_of(vol, tf), cams, targets)
            res[f"ray_setup_rays_{layout}"] = \
                metrics.read_counters("cpu")["ray_setup_rays"]

    axis = 1
    step = make_depth_train_step(settings, optimize_vol=True,
                                 optimize_tf=True, vol_shape=vol.shape,
                                 axis=axis)
    init = sgd_state(vol, tf)
    state = init_depth_state({k: v.detach() for k, v in init.params.items()},
                             lambda p: torch.optim.SGD(p, lr=LR), axis=axis)
    state, loss = step(state, fixed_of(depth.split_rows(vol, axis), tf),
                       cams, targets)
    res["depth_step"] = (float(loss),
                         depth.gather_rows(state.params["vol"].detach(), axis),
                         state.params["tf"].detach(),
                         tuple(state.params["vol"].shape))

    both = opposed_cameras()
    targets2 = targets_of(vol, tf, settings, both)
    start = [v.detach() for v in sgd_state(vol, tf).params.values()]
    for axis in DEPTH_AXES:
        args = (settings, axis, *start,
                fixed_of(depth.split_rows(vol, axis), tf), both, targets2, LR)
        res[f"depth_step_pair_{axis}"] = (batched_depth_step(*args),
                                          per_view_depth_step(*args))

    try:
        depth.make_depth_sharded_renderer(None, settings,
                                          vol_shape=(N - 1, N, N), axis=0)
        res["nondivisible"] = "no error"
    except ValueError as e:
        res["nondivisible"] = str(e)

    from volumetric_renderer_torch.apps import optimize

    for par in ("pixels", "depth"):
        ck = os.path.join(out_dir, f"ck_{par}")
        common = ["invert", "--grid", str(N), "--size", "24x24",
                  "--march-steps", "12", "--views", "2", "--device", "cpu",
                  "--parallel", par, "--ckpt-every", "2"]
        straight = optimize.main(common + ["--steps-opt", "4"])
        optimize.main(common + ["--steps-opt", "2", "--ckpt-dir", ck])
        resumed = optimize.main(common + ["--steps-opt", "4", "--ckpt-dir",
                                          ck, "--resume"])
        res[f"app_{par}"] = (straight, resumed)

    mesh = distributed.pod_mesh("cpu", per_host=2 if world % 2 == 0 else 1)
    res["pod_mesh"] = (tuple(mesh.mesh.shape), mesh.mesh_dim_names)
    res["batch_bounds"] = distributed.local_batch_bounds(64)
    dist.barrier()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- running the workers --------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def runs(request, tmp_path_factory):
    """Run ``world`` worker processes once; ``(world, [result per rank])``."""
    world = request.param
    out = tmp_path_factory.mktemp(f"gloo{world}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out), str(world),
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for r in range(world)]
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
        errs.append(err)
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    return world, [torch.load(out / f"rank{r}.pt", weights_only=False)
                   for r in range(world)]


@pytest.fixture(scope="module")
def reference():
    """The port's unsharded renders, gradients and single-process steps."""
    from volumetric_renderer_torch.parallel.train import make_train_step
    from volumetric_renderer_torch.render.api import render

    vol, tf, settings, cams = scene()

    def unsharded(v, t, cam, dmin, dmax, smin, smax):
        return render(v, t, cam, settings, density_min=dmin,
                      density_max=dmax, slice_min=smin, slice_max=smax,
                      method="fused")

    ref = {f"grads_{i}": grads_of(unsharded, vol, tf, c)
           for i, c in enumerate(cams)}
    targets = targets_of(vol, tf, settings, cams)
    step = make_train_step(settings, optimize_vol=True, optimize_tf=True)
    state, loss = step(sgd_state(vol, tf), fixed_of(vol, tf), cams, targets)
    ref["step"] = (float(loss), state.params["vol"].detach(),
                   state.params["tf"].detach())
    ref["init"] = [v.detach() for v in sgd_state(vol, tf).params.values()]
    return ref


def assert_steps_close(got, want, init, rel):
    """Parameters after a step: their moves agree within ``rel`` of the
    largest move."""
    for a, b, p0 in zip(got, want, init):
        assert float((b - p0).abs().max()) > 1e-3      # the step moved
        assert_scaled_close([a - p0], [b - p0], rel)


def assert_scaled_close(got, want, rel):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=rel * float(b.abs().max()))


def test_ranks_joined_the_gloo_group(runs):
    world, res = runs
    assert [(r["world"], r["rank"]) for r in res] == \
        [(world, i) for i in range(world)]
    assert all(r["device"] == "cpu" for r in res)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pixel_sharded_forward_equals_unsharded(runs, reference, layout):
    _, res = runs
    want = reference["grads_0"][0]
    for r in res:
        got = r[f"pixels_fwd_{layout}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("layout", GRAD_LAYOUTS)
def test_pixel_sharded_grads_equal_unsharded(runs, reference, layout):
    _, res = runs
    for r in res:
        assert_scaled_close(r[f"pixels_grads_{layout}"],
                            reference["grads_0"][1], 2e-4)


@pytest.mark.parametrize("axis", DEPTH_AXES)
@pytest.mark.parametrize("view", [0, 1])
def test_depth_sharded_forward_and_grads_equal_unsharded(runs, reference,
                                                         axis, view):
    _, res = runs
    img, grads = reference[f"grads_{view}"]
    vol = scene()[0]
    for r in res:
        np.testing.assert_allclose(r[f"depth_fwd_{axis}_{view}"].numpy(),
                                   img.numpy(), atol=5e-4)
        assert r[f"depth_window_{axis}"] == (float(vol.min()),
                                             float(vol.max()))
    # the grid gradient is gathered on rank 0; the others hold their rows
    assert_scaled_close(res[0][f"depth_grads_{axis}_{view}"], grads, 5e-4)
    for r in res[1:]:
        assert r[f"depth_grads_{axis}_{view}"][0] is None
        assert_scaled_close(r[f"depth_grads_{axis}_{view}"][1:], grads[1:],
                            5e-4)


def test_pixel_train_step_is_replicated_and_equals_one_process(runs,
                                                               reference):
    _, res = runs
    loss, vol, tf = reference["step"]
    for r in res:
        got_loss, got_vol, got_tf = r["pixels_step"]
        assert torch.equal(got_vol, res[0]["pixels_step"][1])
        assert torch.equal(got_tf, res[0]["pixels_step"][2])
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        assert_steps_close([got_vol, got_tf], [vol, tf], reference["init"],
                           2e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_step_makes_the_rays_of_its_own_block_only(runs, layout):
    """Under ``counting``, one pixel train step of the two views makes
    ``V * gh * gw / world`` rays on every rank (``ray_setup_rays``): its
    own block of the packed frame, padding included, and no other."""
    from volumetric_renderer_torch.parallel.mesh import make_layout

    world, res = runs
    gh, gw = make_layout(layout, *HW, world)[:2]
    for r in res:
        assert r[f"ray_setup_rays_{layout}"] == len(YAWS) * gh * gw // world


@pytest.mark.parametrize("layout", GRAD_LAYOUTS)
def test_batched_views_equal_the_per_view_loop_in_a_group(runs, layout):
    """In the gloo group, every view in one march equals one march per view:
    the sharded frames bit for bit and their grid, TF and window gradients
    within atol 1e-4 / rtol 1e-5; the train step's loss and gradients as
    ``assert_steps_equal``."""
    _, res = runs
    for r in res:
        (img, grads), per_view = r[f"batched_render_{layout}"]
        assert img.shape == (len(YAWS),) + HW + (4,)
        for i, (one, _) in enumerate(per_view):
            assert torch.equal(img[i], one)
        for k, g in enumerate(grads):
            want = sum(v[1][k] for v in per_view)
            np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-4,
                                       rtol=1e-5)
        assert_steps_equal(*r[f"batched_step_{layout}"])


def test_depth_train_step_keeps_chunks_and_equals_one_process(runs,
                                                              reference):
    world, res = runs
    loss, vol, tf = reference["step"]
    for r in res:
        got_loss, got_vol, got_tf, local_shape = r["depth_step"]
        assert local_shape == (N, N // world, N)     # axis 1: its rows only
        assert torch.equal(got_tf, res[0]["depth_step"][2])
        np.testing.assert_allclose(got_loss, loss, rtol=5e-4)
    _, got_vol, got_tf, _ = res[0]["depth_step"]    # the grid on rank 0
    assert_steps_close([got_vol, got_tf], [vol, tf], reference["init"], 5e-4)


@pytest.mark.parametrize("axis", DEPTH_AXES)
def test_depth_batched_views_equal_per_camera_calls_in_a_group(runs, axis):
    """In the gloo group, two opposite views (rays marching both ways
    along ``axis``) in one call of the depth-sharded renderer equal one
    call per camera: the folded frames bit for bit, this rank's grid rows'
    gradient and the TF and window gradients within atol 1e-4 / rtol
    1e-5."""
    world, res = runs
    for r in res:
        (img, grads), per_view = r[f"depth_batched_{axis}"]
        assert img.shape == (len(OPPOSED),) + HW + (4,)
        assert grads[0].shape[axis] == N // world
        for i, (one, _) in enumerate(per_view):
            assert torch.equal(img[i], one)
        assert float(img[..., 3].max()) > 0.3
        for k, g in enumerate(grads):
            want = sum(v[1][k] for v in per_view)
            assert float(want.abs().max()) > 0
            np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-4,
                                       rtol=1e-5)


@pytest.mark.parametrize("axis", DEPTH_AXES)
def test_depth_batched_step_equals_the_per_view_loop_in_a_group(runs, axis):
    """In the gloo group, ``make_depth_train_step`` (both views in one
    call) equals a loop of one call per view built in the test, as
    ``assert_depth_steps_equal``; every rank holds the same loss and TF."""
    world, res = runs
    for r in res:
        got, want = r[f"depth_step_pair_{axis}"]
        assert got[2][0].shape[axis] == N // world
        assert got[0] > 1e-3
        assert_depth_steps_equal(got, want)
        first = res[0][f"depth_step_pair_{axis}"][0]
        assert got[0] == first[0] and torch.equal(got[2][1], first[2][1])


def test_depth_not_divisible_raises(runs):
    world, res = runs
    for r in res:
        assert r["nondivisible"] == (f"grid a-extent {N - 1} must divide the "
                                     f"depth mesh ({world}); pad the volume")


@pytest.mark.parametrize("par", ["pixels", "depth"])
def test_optimize_app_under_a_group_resumes_exactly(runs, par):
    """``apps.optimize --parallel pixels|depth`` inside a process group:
    the loss falls, and two steps, a checkpoint (the whole grid and its
    moments, gathered on rank 0) and two resumed steps (split again) give
    the losses of four straight steps, bit for bit."""
    world, res = runs
    for r in res:
        straight, resumed = r[f"app_{par}"]
        assert straight["world"] == world and straight["parallel"] == par
        assert straight["axis"] == (1 if par == "depth" else None)
        assert straight["losses"][-1] < straight["losses"][0]
        assert resumed["start"] == 2
        assert resumed["losses"] == straight["losses"][2:]
        assert straight["losses"] == res[0][f"app_{par}"][0]["losses"]


def test_pod_mesh_and_batch_bounds(runs):
    world, res = runs
    for r in res:
        shape, names = r["pod_mesh"]
        assert names == ("hosts", "tiles")
        assert shape == (world // 2, 2)
    rows = sorted(i for r in res for i in range(*r["batch_bounds"]))
    assert rows == list(range(64))


# -- layouts against the JAX package --------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("hwn", [(24, 16, 8), (24, 16, 7), (30, 20, 4)])
def test_layouts_equal_jax(layout, hwn):
    """``pack``, ``unpack`` and ``valid`` equal the JAX package's exactly,
    padding and a frame not divisible by 16 included."""
    import jax.numpy as jnp

    from volumetric_renderer_torch.parallel.mesh import make_layout
    from volumetric_renderer_tpu.parallel.mesh import (
        make_layout as jmake_layout,
    )

    h, w, n = hwn
    gh, gw, pack, unpack, valid = make_layout(layout, h, w, n)
    jgh, jgw, jpack, junpack, jvalid = jmake_layout(layout, h, w, n)
    assert (gh, gw) == (jgh, jgw) and gh % n == 0
    img = np.random.default_rng(3).random((h, w, 4)).astype(np.float32)
    packed = pack(torch.from_numpy(img))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpack(jnp.asarray(img))))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    x = np.random.default_rng(4).random((gh, gw, 2)).astype(np.float32)
    np.testing.assert_array_equal(unpack(torch.from_numpy(x)).numpy(),
                                  np.asarray(junpack(jnp.asarray(x))))
    np.testing.assert_array_equal(unpack(packed).numpy(), img)


RANKS = [(1, 0), (2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)]


@pytest.mark.parametrize("views", [1, 3])
@pytest.mark.parametrize("hw", [(72, 120), (64, 64)], ids=["pads", "whole"])
@pytest.mark.parametrize("world,rank", RANKS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_block_rays_equal_the_packed_whole_grid(layout, world, rank, hw,
                                                views):
    """The sharded renderer's ray setup for rank ``rank`` of ``world``
    (``rank_pixels`` and ``block_inputs``; no group needed) gives bit for
    bit that rank's rows of the whole frame's ``ray_grid`` packed with the
    layout, the inert direction on padding, and counts those rays."""
    from volumetric_renderer_torch.parallel.mesh import make_layout
    from volumetric_renderer_torch.parallel.render import (
        block_inputs, rank_pixels,
    )
    from volumetric_renderer_torch.parallel.train import stack_cameras
    from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid
    from volumetric_renderer_torch.utils.config import RenderSettings

    h, w = hw
    settings = RenderSettings(height=h, width=w, step_size=STEP)
    cams = [OrbitCamera.from_angles(yaw_deg=y, pitch_deg=21.0)
            for y in (33.0, 150.0, 213.0)[:views]]
    cam = cams[0] if views == 1 else stack_cameras(cams)
    origin, whole = ray_grid(cam, h, w)
    gh, gw, pack, _, valid = make_layout(layout, h, w, world)
    rows = gh // world
    packed = pack(whole.reshape((-1, h, w, 3)).permute(1, 2, 0, 3))
    packed = torch.where(valid[..., None, None] > 0.0, packed,
                         torch.tensor([0.0, 0.0, 1.0]))
    want = packed[rank * rows:(rank + 1) * rows].permute(2, 0, 1, 3)

    pixels = rank_pixels(layout, h, w, rank, world)
    before = block_inputs.rays
    got_origin, got, *_ = block_inputs(torch.zeros(2, 2, 2), cam, settings,
                                       pixels, None, None, None, None)
    assert got.shape == origin.shape[:-1] + (rows, gw, 3)
    assert torch.equal(got.reshape(want.shape), want)
    assert torch.equal(got_origin, origin + 0.5)
    assert block_inputs.rays - before == views * rows * gw
    assert (pixels[1] is None) == (gh * gw == h * w)


def test_cyclic_row_layout_equals_jax():
    from volumetric_renderer_torch.parallel.mesh import cyclic_row_layout
    from volumetric_renderer_tpu.parallel.mesh import (
        cyclic_row_layout as jcyclic,
    )

    for h, n in [(1080, 8), (24, 8), (128, 4), (48, 3)]:
        for a, b in zip(cyclic_row_layout(h, n), jcyclic(h, n)):
            np.testing.assert_array_equal(a, b)


def test_init_distributed_without_cuda_is_an_error(monkeypatch):
    """With no ``device`` the ranks run on CUDA; where there is none that
    is an error, not a quiet run on the CPU."""
    from volumetric_renderer_torch.parallel import distributed

    monkeypatch.setattr(distributed.torch.cuda, "is_available",
                        lambda: False)
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.init_distributed(device=device)
    assert distributed.init_distributed(device="cpu") == torch.device("cpu")


def test_world_of_one_without_a_process_group():
    """No process group: a world of one whose collectives are identities,
    and ``init_distributed`` without a cluster is a no-op."""
    import torch.distributed as dist

    from volumetric_renderer_torch.parallel import distributed
    from volumetric_renderer_torch.parallel.mesh import group_info
    from volumetric_renderer_torch.parallel.render import (
        gather_blocks, sum_across,
    )

    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE")
           if k in os.environ}
    try:
        assert distributed.init_distributed(device="cpu") == \
            torch.device("cpu")
    finally:
        os.environ.update(env)
    assert not dist.is_initialized()
    assert group_info() == (None, 0, 1)
    x = torch.ones(3, requires_grad=True)
    assert sum_across(x) is x and gather_blocks(x) is x
    assert distributed.local_batch_bounds(10) == (0, 10)
    with pytest.raises(ValueError, match="not initialised"):
        group_info(object())


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
