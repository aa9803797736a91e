"""Optimization steps for TF-fit and voxel-grid inversion over a process
group.

BASELINE configs 3-5: recover a transfer function (or the whole density
grid) from target images by pixel-loss gradient descent.  The semantics of
the JAX package's ``parallel/train.py`` (``make_train_step``,
``init_state``, ``make_depth_train_step``, ``init_depth_state``,
``TrainState``): the same losses, the same clamps after the update.  The
optimizer is a ``torch.optim`` instance that updates the parameters in
place.

* :func:`make_train_step` shards pixels over the ranks
  (``parallel/render``); the parameters are replicated, and the loss and
  the gradients are summed across the ranks once per step, before one
  optimizer step that leaves every rank's parameters identical.
* :func:`make_depth_train_step` shards the grid (``parallel/depth``): each
  rank holds its rows of the grid and their Adam moments; the TF and the
  window are replicated.

Once its kernels are built, neither step makes the host wait for the
card before the caller reads the loss: a host camera reaches the device
in one asynchronous copy (``scene.camera.OrbitCamera.to``), and the
layout's tensors, the loss mask and the ray setup's constants are made
once per device (``utils.device``).  A caller that steps many times
stacks its cameras and puts them on the device once
(:func:`stack_cameras`, then ``.to(device)``).

Without a process group both run as a world of one.  ``method="auto"``
trains through the CUDA kernels on a CUDA grid (K1 forward, K2 backward,
``kernels/march.py``) and through the plain re-march (``"fused"``) on the
CPU.  A ray-major kernel has no slab orientation, so the JAX package's
per-view kernel switch (``slab_axes_for_cameras``) has no counterpart, and
depth-sharded views may look along any axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from volumetric_renderer_torch.parallel.depth import (
    make_depth_sharded_renderer,
    split_rows,
)
from volumetric_renderer_torch.parallel.mesh import group_info, make_layout
from volumetric_renderer_torch.parallel.render import (
    all_reduce_grads,
    all_reduce_sum,
    make_sharded_renderer,
)
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils.device import per_device
from volumetric_renderer_torch.utils.metrics import span


class TrainState(NamedTuple):
    params: dict                       # {"vol": (Z,Y,X)?, "tf": (N,4)?}
    optimizer: torch.optim.Optimizer   # updates ``params`` in place
    step: int


def init_state(params: dict, make_optimizer: Callable) -> TrainState:
    """A state over copies of ``params`` (detached, requiring grad), with
    ``make_optimizer(list_of_tensors)`` as its optimizer, e.g.
    ``lambda p: torch.optim.Adam(p, lr=5e-2)``."""
    return _state_over({k: v.detach().clone() for k, v in params.items()},
                       make_optimizer)


def _state_over(params: dict, make_optimizer: Callable) -> TrainState:
    """A state over ``params`` themselves (copies the caller made)."""
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    return TrainState(params, make_optimizer(list(params.values())), 0)


def camera_views(cameras) -> list:
    """The posed views as a list of :class:`OrbitCamera`: a list as it is,
    one camera as ``[camera]``, a batched camera (leading axis on every
    field) split along that axis."""
    if isinstance(cameras, OrbitCamera):
        if cameras.orientation.dim() == 1:
            return [cameras]
        return [OrbitCamera(cameras.center[i], cameras.orientation[i],
                            cameras.radius[i])
                for i in range(cameras.orientation.shape[0])]
    return list(cameras)


def stack_cameras(cameras) -> OrbitCamera:
    """The posed views as one batched camera (a leading view axis on every
    field): a batched camera as it is, one camera or a list stacked."""
    if isinstance(cameras, OrbitCamera) and cameras.orientation.dim() == 2:
        return cameras
    views = camera_views(cameras)
    return OrbitCamera(*(torch.stack([getattr(c, f) for c in views])
                         for f in ("center", "orientation", "radius")))


def _clamp(params: dict, optimize_vol: bool, optimize_tf: bool) -> None:
    with span("vr.clamp"), torch.no_grad():
        if optimize_tf:
            # keep the TF a physical RGBA table (the reference's unorm
            # texture range, offscreen_pass.cpp:1076)
            params["tf"].clamp_(0.0, 1.0)
        if optimize_vol:
            params["vol"].clamp_(min=0.0)


def make_train_step(settings: RenderSettings, *, optimize_vol: bool,
                    optimize_tf: bool, method: str = "auto", group=None,
                    row_layout: str = "contiguous"):
    """Build ``step(state, fixed, cameras, targets) -> (state, loss)`` with
    the pixels of every view sharded over the ranks of ``group`` (None: the
    default group, or a world of one without one) in ``row_layout``.

    ``cameras``: the posed views (see :func:`stack_cameras`); ``targets``:
    ``(V, H, W, 4)``, the same on every rank.  ``fixed`` carries whichever
    of ``vol``/``tf`` is not optimized and the windows ``dmin``, ``dmax``,
    ``smin``, ``smax`` as constants, so no gradient reaches the grid
    through the window.

    The loss is the mean over views of ``mean((img - target)**2)`` over all
    four channels, taken in shard order: each rank sums the squared error
    over its own blocks, masked by the layout's ``valid``, and divides by
    ``H*W*4*V``.  All the views are rendered in one march (the sharded
    renderer's batched camera): one ray setup, and one K1 and one K2
    launch on a CUDA grid, or the fewest the launch grid allows
    (``kernels.march.MAX_ROWS``); then one ``backward``.  After it the loss
    and the gradients are summed across the ranks (``all_reduce``, once),
    then one optimizer step and, in place, the clamps: TF to [0, 1], grid
    to >= 0.  Every rank's parameters stay identical.
    """
    group, rank, world = group_info(group)
    h, w = settings.height, settings.width
    render_fn = make_sharded_renderer(group, settings, method,
                                      row_layout=row_layout,
                                      permuted_output=True,
                                      reduce_grads=False)
    rows = make_layout(row_layout, h, w, world)[0] // world

    def layout(dev):
        """The layout's ``pack`` and this rank's rows of its mask."""
        _, _, pack, _, valid = make_layout(row_layout, h, w, world,
                                           device=dev)
        return pack, valid[rank * rows:(rank + 1) * rows, :, None]

    layout_on = per_device(layout)

    def train_step(state: TrainState, fixed: dict, cameras, targets):
        with span("vr.train_step"):
            params, opt = state.params, state.optimizer
            vol = params["vol"] if optimize_vol else fixed["vol"]
            tf = params["tf"] if optimize_tf else fixed["tf"]
            cams = stack_cameras(cameras)
            n_views = cams.orientation.shape[0]
            opt.zero_grad(set_to_none=True)
            img = render_fn(vol, tf, cams, fixed["dmin"], fixed["dmax"],
                            fixed["smin"], fixed["smax"])  # (V, rows, gw, 4)
            with span("vr.loss"):
                pack, mask = layout_on(img.device)
                # every view's target packed as the renderer packs its rays
                target = pack(targets.permute(1, 2, 0, 3))[
                    rank * rows:(rank + 1) * rows]
                sq = (img - target.permute(2, 0, 1, 3)) ** 2 * mask
                loss = torch.sum(sq) / float(h * w * 4) / n_views
            with span("vr.backward"):
                loss.backward()
            with span("vr.grad_sum"):
                total = loss.detach().clone()
                all_reduce_grads(params.values(), group)
                if world > 1:
                    all_reduce_sum(total, group)
            with span("vr.optimizer"):
                opt.step()
            _clamp(params, optimize_vol, optimize_tf)
            return state._replace(step=state.step + 1), total

    return train_step


def make_depth_train_step(settings: RenderSettings, *, optimize_vol: bool,
                          optimize_tf: bool, vol_shape, axis: int,
                          method: str = "auto", group=None):
    """Build ``step(state, fixed, cameras, targets) -> (state, loss)`` with
    the GRID split over the ranks of ``group`` along array axis ``axis``
    (``parallel/depth``): ``state.params["vol"]`` (or ``fixed["vol"]``) is
    this rank's body rows of a grid of ``vol_shape``, and so are its
    gradient and Adam moments (:func:`init_depth_state`).  ``fixed["dmin"]``
    and ``fixed["dmax"]`` are the whole grid's window
    (``parallel.depth.global_window``).

    The same contract and loss as :func:`make_train_step`, over the whole
    folded image, which every rank holds: ``sum((img - targets)**2) /
    (V*H*W*4)``.  All the views are rendered in one call of the depth-
    sharded renderer (a batched camera): one ray setup, one halo exchange,
    and one K1 and one K2 launch and one copy into K1's texture on a CUDA
    grid, or the fewest launches the launch grid allows
    (``kernels.march.MAX_ROWS``); then one ``backward``.  After it the TF
    gradient is summed across the ranks (once); the grid gradient stays
    with its rows.  Views may look along any axis, in either direction.
    """
    group, _, _ = group_info(group)
    h, w = settings.height, settings.width
    render_fn = make_depth_sharded_renderer(group, settings,
                                            vol_shape=vol_shape, axis=axis,
                                            method=method, reduce_grads=False)

    def train_step(state: TrainState, fixed: dict, cameras, targets):
        with span("vr.train_step"):
            params, opt = state.params, state.optimizer
            vol = params["vol"] if optimize_vol else fixed["vol"]
            tf = params["tf"] if optimize_tf else fixed["tf"]
            cams = stack_cameras(cameras)
            n_views = cams.orientation.shape[0]
            opt.zero_grad(set_to_none=True)
            img = render_fn(vol, tf, cams, fixed["dmin"], fixed["dmax"],
                            fixed["smin"], fixed["smax"])   # (V, H, W, 4)
            with span("vr.loss"):
                loss = torch.sum((img - targets) ** 2) / float(
                    n_views * h * w * 4)
            with span("vr.backward"):
                loss.backward()
            if optimize_tf:
                with span("vr.grad_sum"):
                    all_reduce_grads([params["tf"]], group)
            with span("vr.optimizer"):
                opt.step()
            _clamp(params, optimize_vol, optimize_tf)
            return state._replace(step=state.step + 1), loss.detach()

    return train_step


def init_depth_state(params: dict, make_optimizer: Callable, *, axis: int,
                     group=None) -> TrainState:
    """:func:`init_state` with the whole grid ``params["vol"]`` cut to this
    rank's body rows along ``axis``, so its Adam moments are that size
    too.  The grid is copied once, by ``split_rows``."""
    return _state_over({k: split_rows(v.detach(), axis, group) if k == "vol"
                        else v.detach().clone() for k, v in params.items()},
                       make_optimizer)
