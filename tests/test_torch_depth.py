"""The depth-chunk ownership range of the port's plain marchers and the fold
of ``parallel/depth``, against the JAX package's fused whole-volume render
(``volumetric_renderer_tpu/core/fused.py``; never against the Pallas slab
kernel, whose depth tests are ``slow``).

A volume rendered as K chunks (body rows plus one halo row, each marched
with ``own = (axis, a_start, body, n)``) and folded per ray must equal the
whole-volume render, and the summed chunk gradients (each halo row's onto
its owner) the whole-volume gradients.  Both packages march the JAX
package's rays.  Tolerances: forward atol 1e-4 and gradients
``2e-4 * max|g|`` (``tests/test_depth.py``: the fold reassociates every
composite); the whole-volume range against ``own=None``: bitwise.

The depth-sharded renderer and train step with all views in one call, in
a world of one: against one call per camera (frames bit for bit,
gradients atol 1e-4 / rtol 1e-5), against a per-view loop (loss rtol
1e-6; gradients and parameters after an SGD step atol 1e-4 / rtol 1e-5),
split into groups past ``kernels.march.MAX_ROWS`` (equal to one march),
and the step's gradient against ``jax.grad`` of the JAX package's fused
render loss with its own rays (``5e-4 * max|g|``, the bar of
``tests/test_depth.py``'s train step: each package makes its rays).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetric_renderer_tpu.core.fused import make_fused_marcher as jfused
from volumetric_renderer_tpu.data.volume import Volume as JVolume
from volumetric_renderer_tpu.parallel.depth import (
    composite_chunks as jcomposite,
)
from volumetric_renderer_tpu.scene.camera import OrbitCamera as JCamera
from volumetric_renderer_tpu.scene.camera import ray_grid as jray_grid
from volumetric_renderer_torch import models
from volumetric_renderer_torch.core.fused import (
    make_fused_marcher,
    march_backward_prepared,
    march_prepared,
)
from volumetric_renderer_torch.core.marcher import prepare_rays
from volumetric_renderer_torch.core.sampling import check_own
from volumetric_renderer_torch.parallel.depth import (
    chunk_of,
    composite_chunks,
    dominant_axis,
    fold_partials,
    over,
)
from volumetric_renderer_torch.parallel import depth
from volumetric_renderer_torch.parallel.train import (
    init_depth_state,
    make_depth_train_step,
    stack_cameras,
)
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.utils.config import RenderSettings
from tests import test_torch_parallel as tp

N, NTF, H, W, STEPS = 16, 32, 24, 24, 36
VIEWS = {"forward": (33.0, 21.0), "backward": (213.0, -21.0),
         "steep": (120.0, -35.0)}
MARCH = dict(num_steps=STEPS, step_size=1.8 / STEPS, early_termination=False,
             termination_eps=1.0 / 255.0)


def scene():
    vol = models.sphere(N).data
    tf = Gradient.grayscale_ramp().discretize(NTF)
    tf[:, 3] = np.linspace(0.0, 0.7, NTF, dtype=np.float32)
    return vol, tf


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def jax_reference(view):
    """The JAX fused render of ``view`` and the vjp of ``sum(sin(3 img))``
    in the grid, TF, dmin and dmax; with the rays, as NumPy."""
    vol, tf = scene()
    origin, dirs = jray_grid(JCamera.from_angles(*VIEWS[view]), H, W)
    origin = np.asarray(origin) + 0.5
    rest = (jnp.asarray(origin), jnp.asarray(dirs))

    def loss(v, tt, dmin, dmax):
        img = jfused(**MARCH)(v, tt, *rest, dmin, dmax, jnp.zeros(3),
                              jnp.ones(3))
        return jnp.sum(jnp.sin(3.0 * img)), img

    (_, img), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        jnp.asarray(vol), jnp.asarray(tf), jnp.float32(0.0), jnp.float32(1.0))
    return (np.asarray(img), [np.asarray(g) for g in grads], origin,
            np.asarray(dirs))


def render_chunks(n_chunks, axis, view):
    """The port's chunked plain march, folded per ray, and its gradients."""
    vol, tf = scene()
    _, _, origin, dirs = jax_reference(view)
    body = N // n_chunks
    xs = [t(vol), t(tf), t(0.0), t(1.0)]
    for x in xs:
        x.requires_grad_(True)
    parts = [make_fused_marcher(**MARCH, own=(axis, c * body, body, N))(
        chunk_of(xs[0], c, body, axis), xs[1], t(origin), t(dirs), xs[2],
        xs[3], torch.zeros(3), torch.ones(3)) for c in range(n_chunks)]
    img = fold_partials(torch.stack(parts), t(dirs), axis)
    torch.sum(torch.sin(3.0 * img)).backward()
    return img.detach().numpy(), [x.grad.numpy() for x in xs], parts


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunked_plain_march_matches_jax_fused(n_chunks, axis, view):
    want_img, want_grads, _, _ = jax_reference(view)
    img, grads, _ = render_chunks(n_chunks, axis, view)
    assert float(want_img[..., 3].max()) > 0.3
    np.testing.assert_allclose(img, want_img, atol=1e-4)
    for name, a, b in zip(("vol", "tf", "dmin", "dmax"), grads, want_grads):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-4 * np.abs(b).max(), err_msg=name)


def prepared(view):
    _, _, origin, dirs = jax_reference(view)
    dmin, dmax = t(0.0), t(1.0)
    pos0, hit, inv_w = prepare_rays(t(origin), t(dirs), dmin, dmax)
    return (pos0, t(dirs), hit, dmin, inv_w, torch.zeros(3), torch.ones(3))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_whole_volume_range_is_bitwise_the_whole_volume(axis):
    """``own=(axis, 0, n, n)`` on the volume plus a zero halo row equals
    ``own=None`` bit for bit, forward and backward."""
    vol, tf = scene()
    args = prepared("steep")
    chunk = chunk_of(t(vol), 0, N, axis)
    assert chunk.shape[axis] == N + 1
    want = march_prepared(t(vol), t(tf), *args, **MARCH)
    got = march_prepared(chunk, t(tf), *args, own=(axis, 0, N, N), **MARCH)
    assert torch.equal(got, want)
    g = t(np.random.default_rng(2).normal(size=(H, W, 4)))
    want_b = march_backward_prepared(t(vol), t(tf), *args, want, g, **MARCH)
    got_b = march_backward_prepared(chunk, t(tf), *args, want, g,
                                    own=(axis, 0, N, N), **MARCH)
    assert torch.equal(got_b[0].narrow(axis, 0, N), want_b[0])
    assert not got_b[0].narrow(axis, N, 1).any()      # the zero halo row
    for a, b in zip(got_b[1:], want_b[1:]):
        assert torch.equal(a, b)


def test_fold_per_ray_equals_jax_composite_on_one_way_views():
    """On a view whose rays all march one way along the axis, the per-ray
    fold is the JAX package's ``composite_chunks(reverse=...)``."""
    for view, axis in (("forward", 1), ("backward", 1)):
        _, _, _, dirs = jax_reference(view)
        d = dirs[..., 2 - axis]
        assert (d > 0).all() or (d < 0).all()
        parts = render_chunks(4, axis, view)[2]
        parts = [p.detach().numpy() for p in parts]
        got = fold_partials(torch.from_numpy(np.stack(parts)), t(dirs), axis)
        want = jcomposite([jnp.asarray(p) for p in parts],
                          reverse=bool((d < 0).all()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            composite_chunks([torch.from_numpy(p) for p in parts],
                             reverse=bool((d < 0).all())).numpy(),
            np.asarray(want))


def test_over_operator_associative():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.random((4, 4, 4)).astype(np.float32))
             for _ in range(3)]
    left = over(over(parts[0], parts[1]), parts[2])
    right = over(parts[0], over(parts[1], parts[2]))
    np.testing.assert_allclose(left.numpy(), right.numpy(), atol=1e-6)


def test_chunk_of_is_body_plus_halo():
    vol = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
    c = chunk_of(vol, 1, 3, 1)
    assert c.shape == (4, 4, 5)
    assert torch.equal(c[:, :3], vol[:, 3:6]) and not c[:, 3].any()
    assert torch.equal(chunk_of(vol, 0, 3, 1), vol[:, :4])


def test_check_own_rejects_bad_ranges():
    assert check_own(None, (4, 4, 4)) is None
    assert check_own((0, 2, 2, 4), (3, 4, 4)) == (0, 2, 2, 4)
    for own, shape, match in (((3, 0, 2, 4), (3, 4, 4), "axis"),
                              ((0, 3, 2, 4), (3, 4, 4), "do not lie"),
                              ((0, 0, 2, 4), (2, 4, 4), "halo")):
        with pytest.raises(ValueError, match=match):
            check_own(own, shape)


def test_dominant_axis_of_the_optimize_arcs():
    """The arcs of ``apps.optimize --parallel depth`` look along y (array
    axis 1); a top-down view looks along z (array axis 0)."""
    arcs = [OrbitCamera.from_angles(yaw_deg=float(a), pitch_deg=20.0)
            for a in (-40.0, 0.0, 40.0, 140.0, 180.0, 220.0)]
    assert dominant_axis(arcs) == 1
    assert dominant_axis([OrbitCamera.from_angles(0.0, 80.0)]) == 0
    assert dominant_axis([OrbitCamera.from_angles(90.0, 10.0)]) == 2


# -- every view in one call of the depth-sharded renderer -------------------

@pytest.mark.parametrize("axis", [0, 1, 2])
def test_depth_batched_views_equal_per_camera_calls(axis):
    """Two opposite views in one call, their rays marching both ways along
    ``axis`` in one stack, equal one call per camera: the frames bit for
    bit, the grid, TF and window gradients within atol 1e-4 / rtol 1e-5;
    one camera keeps its ``(H, W, 4)`` shape."""
    vol, tf, settings, _ = tp.scene()
    cams = tp.opposed_cameras()
    f = depth.make_depth_sharded_renderer(None, settings,
                                          vol_shape=vol.shape, axis=axis)
    img, grads = tp.grads_of(f, vol, tf, stack_cameras(cams))
    per_view = [tp.grads_of(f, vol, tf, c) for c in cams]
    assert img.shape == (2,) + tp.HW + (4,)
    assert float(img[..., 3].max()) > 0.3
    for i, (one, _) in enumerate(per_view):
        assert one.shape == tp.HW + (4,)
        assert torch.equal(img[i], one)
    for k, g in enumerate(grads):
        want = sum(v[1][k] for v in per_view)
        assert float(want.abs().max()) > 0
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-5)
    # the stack holds rays marching each way along the axis: each view's
    # rays one way, the two views opposite ways
    from volumetric_renderer_torch.scene.camera import ray_grid
    d = ray_grid(stack_cameras(cams), *tp.HW)[1][..., 2 - axis]
    d = d * torch.sign(d[0].mean())
    assert bool((d[0] > 0).all()) and bool((d[1] < 0).all())


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_depth_batched_step_equals_the_per_view_loop(axis):
    """``make_depth_train_step`` with both views in one call equals a loop
    of one call per view (``tests/test_torch_parallel.depth_step_pair``):
    loss rtol 1e-6, gradients and parameters after an SGD step atol 1e-4
    / rtol 1e-5."""
    vol, tf, settings, _ = tp.scene()
    cams = tp.opposed_cameras()
    targets = tp.targets_of(vol, tf, settings, cams)
    start = [v.detach() for v in tp.sgd_state(vol, tf).params.values()]
    args = (settings, axis, *start, tp.fixed_of(vol, tf), cams, targets,
            tp.LR)
    got = tp.batched_depth_step(*args)
    want = tp.per_view_depth_step(*args)
    assert got[0] > 1e-3
    assert all(float(g.abs().max()) > 0 for g in got[1])
    assert float((got[2][0] - start[0]).abs().max()) > 1e-3   # it moved
    tp.assert_depth_steps_equal(got, want)


@pytest.mark.parametrize("max_views,launches", [(2, 2), (1, 3)])
def test_depth_views_past_the_launch_grid_split_into_fewest_groups(
        monkeypatch, max_views, launches):
    """Where the stacked rows pass ``kernels.march.MAX_ROWS`` the depth
    renderer marches its views in the fewest groups that fit: the frames
    equal one march bit for bit, and the train step equals it (loss rtol
    1e-6; gradients and parameters atol 1e-4 / rtol 1e-5)."""
    from volumetric_renderer_torch.kernels import march as kmarch

    vol, tf, settings, _ = tp.scene()
    cams = tp.opposed_cameras() + [OrbitCamera.from_angles(120.0, -35.0)]
    targets = tp.targets_of(vol, tf, settings, cams)
    start = [v.detach() for v in tp.sgd_state(vol, tf).params.values()]
    f = depth.make_depth_sharded_renderer(None, settings,
                                          vol_shape=vol.shape, axis=1)
    fixed = tp.fixed_of(vol, tf)

    def run():
        img = f(vol, tf, stack_cameras(cams), *tp.window())
        step = tp.batched_depth_step(settings, 1, *start, fixed, cams,
                                     targets, tp.LR)
        return img, step

    whole_img, whole_step = run()
    calls = []
    make = depth.make_marcher

    def counting(*a, **kw):
        march = make(*a, **kw)

        def counted(vol, tf, origin, dirs, *rest):
            calls.append(dirs.shape[0])
            return march(vol, tf, origin, dirs, *rest)
        return counted

    rows = tp.HW[0]
    monkeypatch.setattr(depth, "make_marcher", counting)
    monkeypatch.setattr(kmarch, "MAX_ROWS", max_views * rows + rows - 1)
    img, step = run()
    assert len(calls) == 2 * launches and sum(calls) == 2 * 3 * rows
    assert max(calls) <= kmarch.MAX_ROWS
    assert torch.equal(img, whole_img)
    tp.assert_depth_steps_equal(step, whole_step)


def test_depth_step_matches_jax_fused_loss_gradient():
    """The port's depth train step at SGD rate 1 on a 16^3 grid with two
    opposite views: its grid move and TF gradient against ``jax.grad`` of
    the JAX package's fused render loss over the same views, the mean
    over views of each view's mean squared error (``tests/test_depth.py``'s
    reference loss), each package with its own rays: within 5e-4 of the
    largest gradient."""
    from volumetric_renderer_tpu.utils.config import (
        RenderSettings as JSettings,
    )

    h, w, n, ntf = 24, 24, 16, 32
    kw = dict(height=h, width=w, step_size=0.05, early_termination=False,
              tf_resolution=ntf)
    js = JSettings(**kw)
    vol_gt = jnp.asarray(JVolume.synthetic_sphere(n).data)
    tf = Gradient.grayscale_ramp().discretize(ntf)
    tf[:, 3] = np.linspace(0.0, 0.7, ntf, dtype=np.float32)
    views = [VIEWS["forward"], VIEWS["backward"]]
    jcams = [JCamera.from_angles(*v) for v in views]
    march = jfused(js.num_steps, js.step_size, False, js.termination_eps)
    window = (jnp.float32(0.0), jnp.float32(1.0), jnp.zeros(3), jnp.ones(3))

    def jrender(v, c):
        origin, dirs = jray_grid(c, h, w)
        return march(v, jnp.asarray(tf), origin + 0.5, dirs, *window)

    targets = [jrender(vol_gt, c) for c in jcams]

    def ref_loss(v, tt):
        imgs = [jfused(js.num_steps, js.step_size, False,
                       js.termination_eps)(
            v, tt, *(lambda o, d: (o + 0.5, d))(*jray_grid(c, h, w)),
            *window) for c in jcams]
        return sum(jnp.mean((img - t) ** 2)
                   for img, t in zip(imgs, targets)) / len(jcams)

    vol0 = np.full((n, n, n), 0.3, np.float32)
    want = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(vol0),
                                              jnp.asarray(tf))
    want = [np.asarray(g) for g in want]

    settings = RenderSettings(**kw)
    cams = [OrbitCamera.from_angles(*v) for v in views]
    axis = depth.dominant_axis(cams)
    step = make_depth_train_step(settings, optimize_vol=True,
                                 optimize_tf=True, vol_shape=(n, n, n),
                                 axis=axis)
    state = init_depth_state({"vol": t(vol0), "tf": t(tf)},
                             lambda p: torch.optim.SGD(p, lr=1.0), axis=axis)
    fixed = dict(dmin=t(0.0), dmax=t(1.0), smin=torch.zeros(3),
                 smax=torch.ones(3))
    state, loss = step(state, fixed, cams,
                       torch.from_numpy(np.stack([np.asarray(x)
                                                  for x in targets])))
    new_vol = state.params["vol"].detach().numpy()
    assert new_vol.min() > 0.0             # no clamp: the move is -grad
    got = [vol0 - new_vol, state.params["vol"].grad.numpy(),
           state.params["tf"].grad.numpy()]
    assert float(loss) > 1e-3 and np.abs(want[0]).max() > 0
    for name, a, b in zip(("vol move", "vol", "tf"), got,
                          [want[0], want[0], want[1]]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=5e-4 * np.abs(b).max(), err_msg=name)
