"""Optimization step for TF-fit and voxel-grid inversion, on one device.

BASELINE configs 3-4: recover a transfer function (or the whole density
grid) from target images by pixel-loss gradient descent.  The semantics of
the JAX package's ``parallel/train.py`` (``make_train_step``,
``init_state``, ``TrainState``) without a mesh: the same loss, the same
clamps after the update.  The optimizer is a ``torch.optim`` instance that
updates the parameters in place.

``method="auto"`` trains through the CUDA kernels on a CUDA grid (K1
forward, K2 backward, ``kernels/march.py``) and through the plain re-march
(``"fused"``) on the CPU.  A ray-major kernel has no slab orientation, so
the JAX package's per-view kernel switch (``slab_axes_for_cameras``) has no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from volumetric_renderer_torch.render.api import render
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.utils.config import RenderSettings


class TrainState(NamedTuple):
    params: dict                       # {"vol": (Z,Y,X)?, "tf": (N,4)?}
    optimizer: torch.optim.Optimizer   # updates ``params`` in place
    step: int


def init_state(params: dict, make_optimizer: Callable) -> TrainState:
    """A state over copies of ``params`` (detached, requiring grad), with
    ``make_optimizer(list_of_tensors)`` as its optimizer, e.g.
    ``lambda p: torch.optim.Adam(p, lr=5e-2)``."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
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


def make_train_step(settings: RenderSettings, *, optimize_vol: bool,
                    optimize_tf: bool, method: str = "auto"):
    """Build ``step(state, fixed, cameras, targets) -> (state, loss)``.

    ``cameras``: the posed views (see :func:`camera_views`); ``targets``:
    ``(V, H, W, 4)``.  ``fixed`` carries whichever of ``vol``/``tf`` is not
    optimized and the windows ``dmin``, ``dmax``, ``smin``, ``smax`` as
    constants, so no gradient reaches the grid through the window.

    The loss is the mean over views of ``mean((img - target)**2)`` over all
    four channels.  Each view's render is differentiated as soon as it is
    made (``backward`` of ``loss_v / V``), so only one view's graph is alive
    at a time; the summed gradients equal those of the whole loss.  Then one
    optimizer step and, in place, the clamps: TF to [0, 1], grid to >= 0.
    """

    def train_step(state: TrainState, fixed: dict, cameras, targets):
        params, opt = state.params, state.optimizer
        vol = params["vol"] if optimize_vol else fixed["vol"]
        tf = params["tf"] if optimize_tf else fixed["tf"]
        views = camera_views(cameras)
        opt.zero_grad(set_to_none=True)
        total = torch.zeros((), dtype=torch.float32, device=targets.device)
        for i, cam in enumerate(views):
            img = render(vol, tf, cam, settings, density_min=fixed["dmin"],
                         density_max=fixed["dmax"], slice_min=fixed["smin"],
                         slice_max=fixed["smax"], method=method)
            loss_v = torch.mean((img - targets[i]) ** 2)
            (loss_v / len(views)).backward()
            total = total + loss_v.detach()
        opt.step()
        with torch.no_grad():
            if optimize_tf:
                # keep the TF a physical RGBA table (the reference's unorm
                # texture range, offscreen_pass.cpp:1076)
                params["tf"].clamp_(0.0, 1.0)
            if optimize_vol:
                params["vol"].clamp_(min=0.0)
        return state._replace(step=state.step + 1), total / len(views)

    return train_step
