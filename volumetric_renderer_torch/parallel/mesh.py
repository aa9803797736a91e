"""Pixel layouts of the sharded renderers, and the process group they run on.

The JAX package shards image rows over a ``jax.sharding.Mesh``.  Here the
mesh is a ``torch.distributed`` process group: each rank is one process on
one device and marches its own block of the packed image.  With no process
group initialised every function acts as a world of one, as a one-device
mesh does.

Layouts (:func:`make_layout`) are index maths on tensors, equal to the JAX
package's ``parallel/mesh.py:make_layout`` for every layout, the seeded
``tile-shuffle`` permutation included.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
HOST_AXIS = "hosts"

# Pixel-to-rank layouts understood by make_layout (CLI surfaces derive their
# choices from this so new layouts appear everywhere at once).
LAYOUTS = ("contiguous", "cyclic", "tile-cyclic", "tile-shuffle")


def group_info(group=None) -> tuple:
    """``(group, rank, world)`` of ``group`` (None: the default group).

    Without an initialised process group this is ``(None, 0, 1)``: a world
    of one, whose collectives are identities."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a process group was given, but "
                             "torch.distributed is not initialised")
        return None, 0, 1
    return group, dist.get_rank(group), dist.get_world_size(group)


def pad_rows(h: int, n_dev: int) -> int:
    """Rows after padding ``h`` up to a multiple of ``n_dev`` ranks."""
    return -(-h // n_dev) * n_dev


def _pad_image(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``img`` ``(h0, w0, ...)`` zero-padded at the end to ``(h, w, ...)``."""
    if img.shape[1] < w:
        img = torch.cat([img, img.new_zeros(
            (img.shape[0], w - img.shape[1]) + img.shape[2:])], dim=1)
    if img.shape[0] < h:
        img = torch.cat([img, img.new_zeros(
            (h - img.shape[0],) + img.shape[1:])], dim=0)
    return img


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]``, the index copied to ``x``'s device first where it lies
    elsewhere (a layout made for another device)."""
    return x[index.to(x.device)]


def make_layout(layout: str, h: int, w: int, n_dev: int, tile: int = 16,
                device=None):
    """Pixel-to-rank distribution for the sharded renderer.

    Returns ``(gh, gw, pack, unpack, valid)``:

    * ``gh, gw`` — the packed image shape (``gh`` rows split contiguously
      over ``n_dev`` ranks; rank r marches rows ``[r*gh/n, (r+1)*gh/n)``).
    * ``pack(img)`` — ``(h, w, C...) -> (gh, gw, C...)`` rearrangement
      into shard order, zero-filled on padding; differentiable.
    * ``unpack(x)`` — the exact inverse, ``(gh, gw, C...) -> (h, w, C...)``.
    * ``valid`` — ``(gh, gw)`` float32 mask of true pixels (0 on padding),
      for loss masking and for making padded rays inert.

    ``valid`` and the index tensors that ``pack`` and ``unpack`` take lie on
    ``device`` (default: the CPU), made there once: a layout made for the
    device of the images it packs copies nothing from the host per call
    (one made for another device copies its index to theirs on every
    call, which on a CUDA device makes the host wait).

    Layouts:

    * ``"contiguous"`` — rank r owns rows ``[r*h/n, (r+1)*h/n)``.
    * ``"cyclic"`` — 16-row blocks round-robin over ranks
      (:func:`cyclic_row_layout`).
    * ``"tile-cyclic"`` — 16x16 tiles round-robin over ranks in raster
      order; each rank marches a ``(T*16/n, 16)`` image, which the kernel
      tiles back into exactly the original 16x16 tiles.
    * ``"tile-shuffle"`` — tile-cyclic after a fixed permutation of the
      tile order (``np.random.Generator(np.random.PCG64(0))``), which breaks
      the stride-n correlation of raster order.
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    if layout == "contiguous":
        gh = pad_rows(h, n_dev)

        def pack(img):
            return _pad_image(img, gh, img.shape[1])

        def unpack(x):
            return x[:h]

        valid = torch.zeros((gh, w), dtype=torch.float32)
        valid[:h] = 1.0
        return gh, w, pack, unpack, valid.to(device)
    if layout == "cyclic":
        gh, perm, inv = cyclic_row_layout(h, n_dev, tile)
        valid = torch.zeros((gh, w), dtype=torch.float32)
        valid[torch.from_numpy(perm < h)] = 1.0
        perm, inv = (torch.as_tensor(i, device=device) for i in (perm, inv))

        def pack(img):
            return _take(_pad_image(img, gh, img.shape[1]), perm)

        def unpack(x):
            return _take(x, inv)[:h]

        return gh, w, pack, unpack, valid.to(device)
    if layout not in ("tile-cyclic", "tile-shuffle"):
        raise ValueError(f"unknown row_layout {layout!r}")

    ht, wt = -(-h // tile), -(-w // tile)
    tp = pad_rows(ht * wt, n_dev)
    idx = np.arange(tp)
    if layout == "tile-shuffle":
        idx = np.random.Generator(np.random.PCG64(0)).permutation(tp)
    order = np.concatenate([idx[d::n_dev] for d in range(n_dev)])
    order, inv_order = (torch.as_tensor(i, device=device)
                        for i in (order, np.argsort(order)))

    def pack(img):
        c = img.shape[2:]
        x = _pad_image(img, ht * tile, wt * tile)
        x = x.reshape((ht, tile, wt, tile) + c).movedim(2, 1)
        x = x.reshape((ht * wt, tile, tile) + c)
        x = _pad_image(x, tp, tile)
        return _take(x, order).reshape((tp * tile, tile) + c)

    def unpack(x):
        c = x.shape[2:]
        x = _take(x.reshape((tp, tile, tile) + c), inv_order)[:ht * wt]
        x = x.reshape((ht, wt, tile, tile) + c).movedim(1, 2)
        return x.reshape((ht * tile, wt * tile) + c)[:h, :w]

    valid = pack(torch.ones((h, w), dtype=torch.float32, device=device))
    return tp * tile, tile, pack, unpack, valid


def cyclic_row_layout(h: int, n_dev: int, block: int = 16):
    """Block-cyclic row assignment for load balance.

    A contiguous band split gives each rank one horizontal strip of the
    frame, and the strip holding the subject becomes the critical path.
    Assigning 16-row blocks round-robin gives every rank a uniform sample of
    the frame; ``block=16`` matches the kernel's tile height, so ray
    coherence inside each 16x16 tile is untouched.

    Returns ``(hp, perm, inv)``: rows after padding to a multiple of
    ``block * n_dev``, the permutation such that ``img[perm]`` is shard
    order (rank d owns blocks d, d+n, d+2n, ...), and its inverse
    (``img_shardorder[inv] == img``).
    """
    hp = -(-h // (block * n_dev)) * (block * n_dev)
    n_blocks = hp // block
    order = np.concatenate(
        [np.arange(d, n_blocks, n_dev) for d in range(n_dev)])
    perm = (order[:, None] * block + np.arange(block)[None, :]).reshape(-1)
    inv = np.argsort(perm)
    return hp, perm, inv
