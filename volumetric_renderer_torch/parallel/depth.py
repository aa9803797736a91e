"""Depth-sharded rendering: the voxel grid split into chunks over the ranks.

The pixel-sharded design (``parallel/render``) keeps the whole grid on
every rank.  Here each rank holds ``body = n / world`` rows of the grid
along one array axis, and with them that chunk's gradient and Adam
moments.  It rests on one fact: **front-to-back compositing over disjoint
segments of a ray is associative.**  With premultiplied partials
``(rgb, alpha)``,

    front OVER back = (rgb_f + (1 - alpha_f) * rgb_b,
                       1 - (1 - alpha_f) * (1 - alpha_b))

so each rank renders the partial image of the samples its chunk owns, and
the partials fold in march order.  On each rank:

1. hold the body rows; take one halo row from rank + 1 (the trilinear +1
   corner) with one ``send``/``recv`` pair; the last rank's halo is zeros,
   the transparent-black border;
2. march every ray with the ownership range ``own = (axis, rank * body,
   body, n)`` (K1 on CUDA, its plain version on the CPU): a sample counts
   where its lower corner along ``axis`` lies in the chunk;
3. ``all_gather`` the ``(H, W, 4)`` partials and fold them **per ray**:
   ascending chunk order where the ray's direction along ``axis`` is
   >= 0, descending where it is < 0 (``kernels.fold``: a kernel on CUDA,
   its plain version on the CPU).  A ray-major kernel has no slab
   orientation, so views may march along any axis, either way.

A camera of V views takes each step once for all of them: its rays are
stacked along rows, so a train step makes one halo exchange, one K1 and
one K2 launch and one ``all_gather`` whatever V is.

Backward: the fold's gradient is written out for this rank's partial
alone (``kernels.fold.fold_backward``), the grid gradient stays on its
rank, and the halo row's gradient goes back to rank + 1's first body row
(the transpose of the halo exchange); the TF and window gradients are
summed across the ranks once.

Early termination inside a chunk uses the chunk's own T, starting at 1 (as
in the JAX package), so depth-sharded renders run with it off.  Callers
pass the global density window (:func:`global_window`): a chunk's own
``min``/``max`` is not the volume's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from volumetric_renderer_torch.core.marcher import frame_inputs
from volumetric_renderer_torch.kernels.fold import (
    fold_backward,
    fold_forward,
    fold_forward_plain,
    over,
)
from volumetric_renderer_torch.parallel.mesh import group_info
from volumetric_renderer_torch.parallel.render import (
    march_views,
    sum_across,
    view_groups,
)
from volumetric_renderer_torch.render.api import make_marcher, select_method
from volumetric_renderer_torch.utils import quaternion as quat
from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils.metrics import span


def composite_chunks(partials, reverse: bool = False) -> torch.Tensor:
    """Fold partial images in march order (ascending chunk index, or
    descending when the march runs toward -axis)."""
    order = range(len(partials))
    if reverse:
        order = reversed(order)
    out = None
    for i in order:
        out = partials[i] if out is None else over(out, partials[i])
    return out


#: The per-ray fold's plain version (``kernels.fold``; its kernel is
#: ``kernels.fold.fold_forward``).
fold_partials = fold_forward_plain


def chunk_of(vol: torch.Tensor, c: int, body: int, axis: int) -> torch.Tensor:
    """Chunk ``c``: rows ``[c*body, (c+1)*body)`` of ``vol`` along ``axis``
    plus the halo row ``(c+1)*body``, zeros past the end of the volume."""
    n = vol.shape[axis]
    lo = c * body
    rows = vol.narrow(axis, lo, min(body + 1, n - lo))
    if rows.shape[axis] < body + 1:
        pad = list(rows.shape)
        pad[axis] = body + 1 - rows.shape[axis]
        rows = torch.cat([rows, rows.new_zeros(pad)], dim=axis)
    return rows.contiguous()


def body_rows(vol_shape, axis: int, world: int) -> int:
    """Rows of each chunk; raises unless ``world`` divides the extent."""
    na = vol_shape[axis]
    if na % world != 0:
        raise ValueError(f"grid a-extent {na} must divide the depth mesh "
                         f"({world}); pad the volume")
    return na // world


def split_rows(vol: torch.Tensor, axis: int, group=None) -> torch.Tensor:
    """This rank's body rows of the whole grid ``vol`` (a contiguous copy)."""
    _, rank, world = group_info(group)
    body = body_rows(vol.shape, axis, world)
    # a copy even where the rows are contiguous already (axis 0, a world
    # of one): the caller may update it in place
    return vol.narrow(axis, rank * body, body).clone(
        memory_format=torch.contiguous_format)


def gather_rows(local: torch.Tensor, axis: int, group=None, dst: int = 0):
    """The whole grid from every rank's body rows, on rank ``dst`` only
    (``gather``; the other ranks get None and never hold the whole grid)."""
    group, rank, world = group_info(group)
    if world == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(world)] \
        if rank == dst else None
    dist.gather(local.contiguous(), parts, dst=_peer(group, dst),
                group=group)
    return torch.cat(parts, dim=axis) if rank == dst else None


def global_window(local: torch.Tensor, group=None) -> tuple:
    """``(min, max)`` of the whole grid from every rank's rows
    (``all_reduce`` MIN and MAX): the density window of a depth-sharded
    render."""
    group, _, world = group_info(group)
    lo, hi = local.min().detach().clone(), local.max().detach().clone()
    if world > 1:
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    return lo, hi


def dominant_axis(cameras) -> int:
    """The array axis (0 z, 1 y, 2 x) the views look along most: the
    coordinate with the largest sum over views of ``|forward|``, the unit
    vector from the eye to the orbit centre."""
    total = None
    for cam in cameras:
        fwd = quat.rotate_vector(cam.orientation, [0.0, -1.0, 0.0]).abs()
        total = fwd if total is None else total + fwd
    return 2 - int(torch.argmax(total))


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _exchange(send, recv, group, rank: int, world: int, to_lower: bool):
    """Send ``send`` to the neighbour rank below (``to_lower``) or above,
    and fill ``recv`` from the other neighbour; the ends skip the missing
    side."""
    dst, src = (rank - 1, rank + 1) if to_lower else (rank + 1, rank - 1)
    ops = []
    if 0 <= dst < world:
        ops.append(dist.P2POp(dist.isend, send, _peer(group, dst), group))
    if 0 <= src < world:
        ops.append(dist.P2POp(dist.irecv, recv, _peer(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return 0 <= src < world


class _HaloExchange(torch.autograd.Function):
    """Body rows -> chunk (body rows + the halo row from rank + 1).  The
    backward sends the halo row's gradient back to rank + 1, which adds it
    to its first body row."""

    @staticmethod
    def forward(ctx, local, axis, group, rank, world):
        ctx.axis, ctx.group, ctx.rank, ctx.world = axis, group, rank, world
        first = local.narrow(axis, 0, 1).contiguous()
        halo = torch.zeros_like(first)
        _exchange(first, halo, group, rank, world, to_lower=True)
        return torch.cat([local, halo], dim=axis)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        body = g.shape[axis] - 1
        g_local = g.narrow(axis, 0, body).clone()
        g_halo = g.narrow(axis, body, 1).contiguous()
        back = torch.empty_like(g_halo)
        if _exchange(g_halo, back, ctx.group, ctx.rank, ctx.world,
                     to_lower=False):
            g_local.narrow(axis, 0, 1).add_(back)
        return g_local, None, None, None, None


# ``all_gather_single`` is the newer name of ``all_gather_into_tensor``
_all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class _GatherFold(torch.autograd.Function):
    """This rank's partial image ``(R, W, 4)`` -> every rank's partial
    gathered (one ``all_gather`` into one ``(world, R, W, 4)`` buffer) and
    folded per ray (``kernels.fold.fold_forward``): the whole image.  The
    backward is the gradient of this rank's partial alone
    (``kernels.fold.fold_backward`` with ``r = rank``): right when the loss
    is computed from the folded image identically on every rank, as the
    depth train step's replicated loss is (the contract of
    ``parallel.render.gather_blocks``)."""

    @staticmethod
    def forward(ctx, partial, rays, axis, group, rank, world):
        partial = partial.contiguous()
        parts = partial.new_empty((world * partial.shape[0],) +
                                  tuple(partial.shape[1:]))
        _all_gather_into(parts, partial, group=group)
        parts = parts.view((world,) + tuple(partial.shape))
        ctx.axis, ctx.rank = axis, rank
        ctx.save_for_backward(parts, rays)
        return fold_forward(parts, rays, axis)

    @staticmethod
    def backward(ctx, g):
        parts, rays = ctx.saved_tensors
        return (fold_backward(parts, rays, ctx.axis, g, ctx.rank), None,
                None, None, None, None)


def make_depth_sharded_renderer(group, settings: RenderSettings, *, vol_shape,
                                axis: int, method: str = "auto",
                                reduce_grads: bool = True):
    """Build ``f(vol_local, tf, camera, dmin, dmax, smin, smax) -> (H, W,
    4)`` with the VOXEL GRID split over the ranks of ``group`` along array
    axis ``axis`` (0 z, 1 y, 2 x).

    ``vol_shape`` is the whole grid's shape; ``vol_local`` is this rank's
    body rows (:func:`split_rows`).  Every rank returns the whole folded
    image.  ``dmin``/``dmax`` are required: pass the whole grid's window
    (:func:`global_window`).  ``method`` is ``"auto"``, ``"fused"`` or
    ``"kernel"``.  The TF and window gradients are summed across the ranks
    once, in the backward, unless ``reduce_grads=False`` leaves that to the
    caller; the grid gradient stays with its rows.

    A camera of V views (a leading axis on its fields, ``scene.camera.
    OrbitCamera``) renders all of them in one call and returns ``(V, H, W,
    4)``: one ray setup, one halo exchange (one chunk tensor, so one copy
    into K1's texture), the V views' rays stacked along rows into one
    ``(V*H, W)`` image marched once with a per-ray origin
    (``parallel.render.view_groups``: the fewest groups past
    ``kernels.march.MAX_ROWS``), one ``all_gather`` of the partials and
    the per-ray fold over the stacked image, whose rays may march either
    way along ``axis`` (:class:`_GatherFold`: one fold launch forward and
    one backward on CUDA).  In a world of one the image is the partial
    itself.
    """
    vol_shape = tuple(int(v) for v in vol_shape)
    group, rank, world = group_info(group)
    body = body_rows(vol_shape, axis, world)
    own = (axis, rank * body, body, vol_shape[axis])
    local_shape = tuple(body if i == axis else d
                        for i, d in enumerate(vol_shape))
    h, w = settings.height, settings.width

    def render_fn(vol_local, tf, camera, dmin, dmax, smin, smax):
        if tuple(vol_local.shape) != local_shape:
            raise ValueError(f"this rank holds {local_shape} of the "
                             f"{vol_shape} grid, got "
                             f"{tuple(vol_local.shape)}")
        if dmin is None or dmax is None:
            raise ValueError("a depth-sharded render needs the whole grid's "
                             "density window (global_window)")
        march = make_marcher(select_method(method, vol_local), settings, own)
        with span("vr.ray_setup"):
            origin, dirs, dmin, dmax, smin, smax = frame_inputs(
                vol_local, camera, settings, dmin, dmax, smin, smax)
            views = tuple(dirs.shape[:-3])      # () for one camera, or (V,)
            rays = dirs.reshape((-1, h, w, 3))
            groups = view_groups(origin, rays)
        if world > 1:
            chunk = _HaloExchange.apply(vol_local, axis, group, rank, world)
        else:
            chunk = chunk_of(vol_local, 0, body, axis)   # a zero halo row
        if reduce_grads:
            tf, dmin, dmax = (sum_across(x, group) for x in (tf, dmin, dmax))
        partial = march_views(march, chunk, tf, groups, dmin, dmax, smin,
                              smax)                     # (V*H, W, 4)
        if world > 1:
            partial = _GatherFold.apply(partial, rays.reshape((-1, w, 3)),
                                        axis, group, rank, world)
        return partial.reshape(views + (h, w, 4))

    return render_fn
