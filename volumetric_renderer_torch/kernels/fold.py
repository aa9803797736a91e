"""The depth fold's kernels and their plain PyTorch versions.

A depth-sharded frame (``parallel/depth``) renders one partial image of
premultiplied ``(rgb, alpha)`` per depth chunk and folds the ``n`` partials
per ray in the ray's march order with the over-operator (:func:`over`):
ascending chunk index where the ray's direction along the split axis is
>= 0, descending where it is < 0.  The JAX package folds with
``volumetric_renderer_tpu/parallel/depth.py:68`` ``composite_chunks``,
which XLA fuses; it has no Pallas kernel.  The port adds one:

* ``fold_fwd`` in ``csrc/fold.cu``, the fold; its plain version is
  :func:`fold_forward_plain`, bit for bit;
* ``fold_bwd``, the gradient of ``sum(fold * g)`` in one chunk's partial,
  written out in closed form; its plain version is
  :func:`fold_backward_plain`.

:func:`fold_forward` and :func:`fold_backward` are the entry points.  On
CPU tensors they run the plain versions; on CUDA tensors they launch the
kernel or raise.  They never fall back to the plain version on the card.
:func:`fold` ties the two into a differentiable fold of every chunk.
"""

from __future__ import annotations

import ctypes

import torch

from volumetric_renderer_torch.kernels import _build
from volumetric_renderer_torch.kernels.march import _check_cuda, _device_of
from volumetric_renderer_torch.utils.metrics import span

_lib = None


def over(front: torch.Tensor, back: torch.Tensor) -> torch.Tensor:
    """Associative over-operator on premultiplied ``(..., 4)`` partials."""
    t = 1.0 - front[..., 3:4]
    rgb = front[..., :3] + t * back[..., :3]
    alpha = 1.0 - t[..., 0] * (1.0 - back[..., 3])
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def _reverse(dirs: torch.Tensor, axis: int) -> torch.Tensor:
    """Where each ray marches toward -axis: its chunks fold descending."""
    return (dirs[..., 2 - axis] < 0.0)[..., None]


def fold_forward_plain(parts: torch.Tensor, dirs: torch.Tensor,
                       axis: int) -> torch.Tensor:
    """Fold ``(n, ..., 4)`` chunk partials per ray: ascending chunk order
    where the ray's direction ``dirs`` ``(..., 3)`` along array axis
    ``axis`` (0 z, 1 y, 2 x) is >= 0, descending where it is < 0.  On a
    view whose rays all march one way this is ``parallel.depth.
    composite_chunks`` with ``reverse`` set to match."""
    n = parts.shape[0]
    reverse = _reverse(dirs, axis)
    out = None
    for i in range(n):
        p = torch.where(reverse, parts[n - 1 - i], parts[i])
        out = p if out is None else over(out, p)
    return out


def _chunk_grad(parts, g, r: int, order) -> torch.Tensor:
    """The gradient in chunk ``r``'s partial for rays whose march order is
    ``order`` (chunk indices, front to back): ``T`` the product of ``1 - a``
    over the chunks before ``r``, ``B`` the fold of those after it
    (transparent where none)."""
    pos = order.index(r)
    tr = torch.ones_like(g[..., 3])
    for c in order[:pos]:
        tr = tr * (1.0 - parts[c][..., 3])
    after = order[pos + 1:]
    b = parts[after[0]] if after else torch.zeros_like(g)
    for c in after[1:]:
        b = over(b, parts[c])
    dot = g[..., 0] * b[..., 0] + g[..., 1] * b[..., 1] + g[..., 2] * b[..., 2]
    da = tr * ((1.0 - b[..., 3]) * g[..., 3] - dot)
    return torch.cat([tr[..., None] * g[..., :3], da[..., None]], dim=-1)


def fold_backward_plain(parts: torch.Tensor, dirs: torch.Tensor, axis: int,
                        g: torch.Tensor, r: int) -> torch.Tensor:
    """The gradient of ``sum(fold_forward_plain(parts, dirs, axis) * g)`` in
    chunk ``r``'s partial alone, ``(..., 4)``.  Per ray, with ``T`` the
    product of ``1 - a`` over the chunks before ``r`` in its march order
    and ``B`` the fold of the chunks after it: ``d rgb_r = T * g_rgb`` and
    ``d a_r = T * ((1 - B_a) * g_a - g_rgb . B_rgb)``."""
    n = parts.shape[0]
    ascending = list(range(n))
    return torch.where(_reverse(dirs, axis),
                       _chunk_grad(parts, g, r, ascending[::-1]),
                       _chunk_grad(parts, g, r, ascending))


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``csrc/fold.cu``."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(_build.build("fold").path))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the fold library on ``lib``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fold_fwd_launch.restype = i
    lib.fold_fwd_launch.argtypes = [i, p, i, ll, p, i, p, p]
    lib.fold_bwd_launch.restype = i
    lib.fold_bwd_launch.argtypes = [i, p, i, ll, p, i, p, i, p, p]
    lib.fold_error_string.restype = ctypes.c_char_p
    lib.fold_error_string.argtypes = [i]
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels load
    float4s)."""
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(fn: str, parts, dirs, axis: int, g=None, r: int = 0):
    """The checks every call makes: devices, types, shapes, axis, chunk.
    Returns the device."""
    tensors = {"parts": parts, "dirs": dirs}
    if g is not None:
        tensors["g"] = g
    device = _device_of(fn, tensors)
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {key} must be torch.float32, got "
                            f"{t.dtype}")
    rays = tuple(dirs.shape[:-1])
    if parts.dim() < 2 or parts.shape[0] < 1 or \
            tuple(parts.shape[1:]) != rays + (4,) or dirs.shape[-1] != 3:
        raise ValueError(f"{fn}: parts must be (n, ..., 4) and dirs (..., 3) "
                         f"over the same rays, got {tuple(parts.shape)} and "
                         f"{tuple(dirs.shape)}")
    if g is not None and tuple(g.shape) != rays + (4,):
        raise ValueError(f"{fn}: g must be {rays + (4,)}, got "
                         f"{tuple(g.shape)}")
    if axis not in (0, 1, 2):
        raise ValueError(f"{fn}: axis must be 0, 1 or 2, got {axis}")
    if not 0 <= r < parts.shape[0]:
        raise ValueError(f"{fn}: chunk {r} of {parts.shape[0]}")
    return device


def _launch_args(device: torch.device) -> tuple:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def fold_forward(parts: torch.Tensor, dirs: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """The fold of ``(n, ..., 4)`` chunk partials per ray (see
    :func:`fold_forward_plain`): ``(..., 4)`` float32.  On CUDA every
    tensor must be float32 on one device, and the output carries no graph:
    under grad mode, ``parts`` that requires grad raises; differentiate
    through :func:`fold` instead."""
    device = _check("fold_forward", parts, dirs, axis)
    if device.type == "cpu":
        return fold_forward_plain(parts, dirs, axis)
    if torch.is_grad_enabled() and parts.requires_grad:
        raise RuntimeError("fold_forward: parts requires grad, but the "
                           "kernel's output carries no graph; differentiate "
                           "through fold, whose backward is the fold_bwd "
                           "kernel (fold_backward)")
    with span("vr.fold"):
        parts, dirs = _aligned(parts), _aligned(dirs)
        out = torch.empty(parts.shape[1:], dtype=torch.float32,
                          device=device)
        rays = out.numel() // 4
        if rays == 0:
            return out
        lib = load_library()
        index, stream = _launch_args(device)
        _check_cuda(lib.fold_fwd_launch(index, parts.data_ptr(),
                                        parts.shape[0], rays,
                                        dirs.data_ptr(), int(axis),
                                        out.data_ptr(), stream),
                    lib, "fold", "launch")
        fold_forward.launches += 1
        return out


def fold_backward(parts: torch.Tensor, dirs: torch.Tensor, axis: int,
                  g: torch.Tensor, r: int) -> torch.Tensor:
    """The gradient of ``sum(fold_forward(parts, dirs, axis) * g)`` in
    chunk ``r``'s partial, ``(..., 4)`` float32 (see
    :func:`fold_backward_plain`).  The same checks as
    :func:`fold_forward`."""
    device = _check("fold_backward", parts, dirs, axis, g, r)
    if device.type == "cpu":
        return fold_backward_plain(parts, dirs, axis, g, r)
    with span("vr.fold"):
        parts, dirs, g = _aligned(parts), _aligned(dirs), _aligned(g)
        grad = torch.empty_like(g)
        rays = grad.numel() // 4
        if rays == 0:
            return grad
        lib = load_library()
        index, stream = _launch_args(device)
        _check_cuda(lib.fold_bwd_launch(index, parts.data_ptr(),
                                        parts.shape[0], rays,
                                        dirs.data_ptr(), int(axis),
                                        g.data_ptr(), int(r),
                                        grad.data_ptr(), stream),
                    lib, "fold", "launch")
        fold_backward.launches += 1
        return grad


#: Kernel launches since the count was last reset; a run sets them to 0 and
#: reads them back to show that its main path went through the kernels.
fold_forward.launches = 0
fold_backward.launches = 0


class _Fold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, parts, dirs, axis):
        ctx.axis = axis
        ctx.save_for_backward(parts, dirs)
        return fold_forward(parts, dirs, axis)

    @staticmethod
    def backward(ctx, g):
        parts, dirs = ctx.saved_tensors
        grads = [fold_backward(parts, dirs, ctx.axis, g, r)
                 for r in range(parts.shape[0])]
        return torch.stack(grads), None, None


def fold(parts: torch.Tensor, dirs: torch.Tensor, axis: int) -> torch.Tensor:
    """:func:`fold_forward`, differentiable in ``parts``: its backward is
    one :func:`fold_backward` per chunk."""
    return _Fold.apply(parts, dirs, axis)
