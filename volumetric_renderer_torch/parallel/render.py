"""Pixel-sharded rendering and its gradients over a process group.

The reference's implicit parallelism (every fragment independent,
``res/shaders/volume.frag:21-51``) becomes ranks that each march their own
block of the packed image (``parallel/mesh.make_layout``).  The voxel grid
and the TF table are replicated on every rank.  The forward needs one
``all_gather`` only to give every rank the whole image; the backward sums
the grid, TF and window gradients across ranks.

``torch.distributed`` collectives carry no autograd, so both reductions are
written out, each applied exactly once (a reduction placed twice gives a
world-size multiple of the gradient, the trap the JAX package hit under
``shard_map``, ``volumetric_renderer_tpu/parallel/render.py:63-71``):

* :func:`gather_blocks` — ``all_gather`` of each rank's block; its backward
  keeps this rank's part of the cotangent.  That is right when the loss is
  computed from the gathered output identically on every rank, as a
  replicated loss is.
* :func:`sum_across` — the identity; its backward sums the cotangent over
  the ranks (``all_reduce``).  It marks a replicated input whose uses are
  split over the ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from volumetric_renderer_torch.core.marcher import frame_inputs
from volumetric_renderer_torch.kernels import march as kernel_march
from volumetric_renderer_torch.parallel.mesh import group_info, make_layout
from volumetric_renderer_torch.render.api import make_marcher, select_method
from volumetric_renderer_torch.scene.camera import pixel_ndc
from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils.device import constant, per_device
from volumetric_renderer_torch.utils.metrics import span


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, group, rank, world):
        ctx.rank, ctx.rows = rank, block.shape[0]
        parts = [torch.empty_like(block) for _ in range(world)]
        dist.all_gather(parts, block.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather_blocks(block: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``block`` (equal shapes) concatenated in rank order
    along dim 0; differentiable (see the module docstring)."""
    group, rank, world = group_info(group)
    if world == 1:
        return block
    return _GatherBlocks.apply(block, group, rank, world)


def sum_across(x, group=None):
    """``x`` itself; its gradient is summed across the ranks of ``group``
    (see the module docstring).  A tensor that needs no gradient passes
    through."""
    _, _, world = group_info(group)
    if world == 1 or not (torch.is_tensor(x) and x.requires_grad):
        return x
    return _SumAcross.apply(x, group)


def all_reduce_sum(t: torch.Tensor, group=None) -> None:
    """``dist.all_reduce`` (a sum) of ``t`` in place, its bytes added to
    ``all_reduce_sum.bytes`` on the host (``utils.metrics.read_counters``
    reads them)."""
    all_reduce_sum.bytes += t.numel() * t.element_size()
    dist.all_reduce(t, group=group)


#: Bytes handed to :func:`all_reduce_sum` since the count was last reset.
all_reduce_sum.bytes = 0


def all_reduce_grads(tensors, group=None) -> None:
    """Sum the ``.grad`` of each tensor across ``group``, in place."""
    _, _, world = group_info(group)
    if world == 1:
        return
    for t in tensors:
        if t.grad is not None:
            all_reduce_sum(t.grad, group)


def rank_pixels(row_layout: str, height: int, width: int, rank: int,
                world: int, device=None):
    """Rank ``rank``'s block of an H x W image packed with ``row_layout``
    over ``world`` ranks (``parallel.mesh.make_layout``), on ``device``:
    ``(ndc, valid)``.  ``ndc`` is the pair ``(ndc_x, ndc_y)``, each ``(gh/n,
    gw)``: the NDC coordinates of the pixel centres
    (``scene.camera.pixel_ndc``) packed by the layout's own ``pack`` and
    cut to this rank's rows, ``(0, 0)`` on padding.  ``valid`` is this
    rank's rows of the layout's mask, or None where the layout pads no
    position.  The coordinates depend on no camera, so a renderer makes
    them once per device."""
    gh, gw, pack, _, valid = make_layout(row_layout, height, width, world,
                                         device=device)
    rows = gh // world
    lo = rank * rows
    ndc = pack(torch.stack(pixel_ndc(height, width, device), -1))
    ndc = tuple(c.contiguous() for c in ndc[lo:lo + rows].unbind(-1))
    if gh * gw == height * width:
        return ndc, None
    return ndc, valid[lo:lo + rows].clone()


def block_inputs(vol, camera, settings: RenderSettings, pixels, dmin, dmax,
                 smin, smax):
    """``core.marcher.frame_inputs`` for a rank's block of pixels only
    (``pixels``, :func:`rank_pixels`): ``(origin, dirs, dmin, dmax, smin,
    smax)`` with ``dirs`` ``(gh/n, gw, 3)``, or ``(V, gh/n, gw, 3)`` for a
    camera of V views, each ray bit for bit the one at its position in the
    packed whole frame, and the inert direction ``(0, 0, 1)`` on padded
    positions.  Adds the rays it made to ``block_inputs.rays``
    (``utils.metrics.read_counters``' ``ray_setup_rays``)."""
    ndc, valid = pixels
    origin, dirs, *window = frame_inputs(vol, camera, settings, dmin, dmax,
                                         smin, smax, ndc=ndc)
    if valid is not None:
        dirs = torch.where(valid[..., None] > 0.0, dirs,
                           constant((0.0, 0.0, 1.0), vol.device))
    block_inputs.rays += dirs.numel() // 3
    return (origin, dirs, *window)


#: Rays made by :func:`block_inputs` since the count was last reset.
block_inputs.rays = 0


def view_groups(origin, rays) -> list:
    """V views' rays ``rays`` ``(V, rows, W, 3)`` from their eyes ``origin``
    (``(V, 3)``, or ``(3,)`` for one view), stacked along rows with a
    per-ray origin for :func:`march_views`: ``(origin (n*rows, 1, 3), rays
    (n*rows, W, 3))`` for each group of n views.  Where the stacked rows
    pass what one kernel launch takes (``kernels.march.MAX_ROWS``), the
    views fall in the fewest groups that fit.  Contiguous ``rays``, as
    both renderers make them, are stacked without a copy."""
    n_views, rows, w = rays.shape[:3]
    origin = origin.reshape((-1, 1, 1, 3))
    per = max(1, kernel_march.MAX_ROWS // rows)
    return [(origin[i:i + per].expand(-1, rows, 1, 3).reshape(-1, 1, 3),
             rays[i:i + per].reshape(-1, w, 3).contiguous())
            for i in range(0, n_views, per)]


def march_views(march, vol, tf, groups, dmin, dmax, smin, smax):
    """March the groups of :func:`view_groups` with ``march`` (a marcher of
    ``render.api.make_marcher``), one call each; returns the views stacked
    along rows, ``(V*rows, W, 4)``."""
    parts = [march(vol, tf, origin, rays, dmin, dmax, smin, smax)
             for origin, rays in groups]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def make_sharded_renderer(group, settings: RenderSettings,
                          method: str = "auto", *,
                          row_layout: str = "contiguous",
                          permuted_output: bool = False,
                          reduce_grads: bool = True):
    """Build ``f(vol, tf, camera, dmin, dmax, smin, smax) -> (H, W, 4)``
    with the image's pixels sharded over the ranks of ``group`` (None: the
    default group, or a world of one without one).

    Every rank makes the rays of its own block of the image packed with
    ``row_layout`` (:func:`~volumetric_renderer_torch.parallel.mesh.
    make_layout`) and no others: it unprojects the block's pixel
    coordinates (:func:`rank_pixels`, packed once per device) through the
    camera (:func:`block_inputs`), gives padded positions the inert
    direction ``(0, 0, 1)`` and marches the block: the K1 kernel for a CUDA
    volume and ``method="auto"``, the plain version on the CPU (``method``
    as in ``render``).  Each ray is bit for bit the one a whole frame's ray
    grid holds at its pixel.  ``tile-cyclic`` gives each rank a ``(T*16/n,
    16)`` image, which the kernel tiles in exactly the original 16x16
    tiles.

    A camera of V views (a leading axis on its fields, ``scene.camera.
    OrbitCamera``) renders all of them in one march: the ray setup runs
    once for the V views' blocks, ``(V, gh/n, gw)`` rays, which are stacked
    along rows into one ``(V*gh/n, gw)`` image of rays.  Where that passes
    the rows one kernel launch takes (``kernels.march.MAX_ROWS``), the
    views are marched in as few groups as fit.

    The block's coordinates, the layout's tensors and the inert direction
    are made once per device, on the first call there, so a later call
    copies nothing from the host and never makes the host wait for the
    card.

    The output is the whole image, gathered and unpacked; with
    ``permuted_output=True`` it is this rank's ``(gh/n, gw, 4)`` block in
    shard order (what the train step's loss takes).  A camera of V views
    puts its leading axis on either: ``(V, H, W, 4)``, ``(V, gh/n, gw,
    4)``.  ``vol``, ``tf`` and the density window are replicated: their
    gradients are summed across the ranks once, in the backward, unless
    ``reduce_grads=False`` leaves that to the caller (the train step sums
    once a step).
    """
    _, rank, world = group_info(group)
    h, w = settings.height, settings.width
    gh, gw = make_layout(row_layout, h, w, world)[:2]
    rows = gh // world
    pixels_on = per_device(
        lambda dev: rank_pixels(row_layout, h, w, rank, world, dev))
    unpack_on = per_device(
        lambda dev: make_layout(row_layout, h, w, world, device=dev)[3])

    def render_fn(vol, tf, camera, dmin, dmax, smin, smax):
        march = make_marcher(select_method(method, vol), settings)
        with span("vr.ray_setup"):
            origin, dirs, dmin, dmax, smin, smax = block_inputs(
                vol, camera, settings, pixels_on(vol.device), dmin, dmax,
                smin, smax)
            views = tuple(dirs.shape[:-3])      # () for one camera, or (V,)
            groups = view_groups(origin, dirs.reshape((-1, rows, gw, 3)))
        if reduce_grads:
            vol, tf, dmin, dmax = (sum_across(x, group)
                                   for x in (vol, tf, dmin, dmax))
        img = march_views(march, vol, tf, groups, dmin, dmax, smin,
                          smax).reshape((-1, rows, gw, 4))  # (V, rows, gw, 4)
        if permuted_output:
            return img.reshape(views + (rows, gw, 4))
        img = unpack_on(img.device)(gather_blocks(img.permute(1, 2, 0, 3),
                                                  group))
        return img.permute(2, 0, 1, 3).reshape(views + (h, w, 4))

    return render_fn


def render_distributed(vol, tf, camera, settings: RenderSettings, group=None,
                       *, density_min=None, density_max=None,
                       slice_min=None, slice_max=None, method: str = "auto"):
    """One-shot wrapper around :func:`make_sharded_renderer`, with the
    window defaults of ``render`` (the volume's min/max, ``[0,1]^3``)."""
    f = make_sharded_renderer(group, settings, method)
    return f(vol, torch.as_tensor(tf, device=vol.device), camera,
             density_min, density_max, slice_min, slice_max)
