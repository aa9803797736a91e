"""Forward ray march (K1): the CUDA kernel ``csrc/march_fwd.cu`` and its
plain PyTorch version.

It replaces the JAX package's TPU kernel
``volumetric_renderer_tpu/kernels/slab.py:_make_kernel``.  Ray setup
(``core.marcher.prepare_rays``: box entry, entry clamp, window reciprocal)
stays in torch; the kernel takes over the per-step loop.

:func:`march_forward` is the one entry point.  On CPU tensors it runs
:func:`march_forward_plain`; on CUDA tensors it launches the kernel or
raises.  It never falls back to the plain version on the card.
"""

from __future__ import annotations

import ctypes

import torch

from volumetric_renderer_torch.core.fused import ALPHA_EPS, march_prepared
from volumetric_renderer_torch.kernels import _build

#: The plain version: the forward of ``core.fused`` (same inputs, same
#: operations in the same order).
march_forward_plain = march_prepared

_lib = None


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build.build("march_fwd").path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.march_fwd_launch.restype = i
        lib.march_fwd_launch.argtypes = [
            i, p, p, p, p, i, i, i, p, i, p, i, i,  # device .. width
            f, f, f, f, f, f, f, f,                 # dmin, inv_w, smin, smax
            i, f, i, f, f, p,                       # steps .. amax, stream
        ]
        lib.march_fwd_max_dynamic_smem.restype = i
        lib.march_fwd_max_dynamic_smem.argtypes = [
            i, ctypes.POINTER(ctypes.c_int)]
        lib.march_fwd_error_string.restype = ctypes.c_char_p
        lib.march_fwd_error_string.argtypes = [i]
        _lib = lib
    return _lib


def _check_cuda(code: int, lib, what: str) -> None:
    if code != 0:
        msg = lib.march_fwd_error_string(code).decode()
        raise RuntimeError(f"march_fwd: {what} failed: CUDA error {code} "
                           f"({msg})")


def march_forward(vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax, *,
                  num_steps: int, step_size: float, early_termination: bool,
                  termination_eps: float) -> torch.Tensor:
    """March prepared rays: ``pos0``/``dirs`` ``(H, W, 3)``, ``hit``
    ``(H, W)`` bool; returns RGBA ``(H, W, 4)`` float32.

    ``dmin`` and ``inv_window`` are scalars and ``smin``/``smax`` 3-vectors
    (tensors or numbers).  On CUDA every tensor must be float32 (``hit``
    bool) and contiguous, on one device, and none may require grad: the
    backward kernel (K2) is not ported yet.
    """
    tensors = {"vol": vol, "tf": tf, "pos0": pos0, "dirs": dirs, "hit": hit}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"march_forward: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return march_forward_plain(
            vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax,
            num_steps=num_steps, step_size=step_size,
            early_termination=early_termination,
            termination_eps=termination_eps)
    if device.type != "cuda":
        raise ValueError(f"march_forward: no kernel for device {device}")

    scalars = {"dmin": dmin, "inv_window": inv_window, "smin": smin,
               "smax": smax}
    for name, x in {**tensors, **scalars}.items():
        if torch.is_tensor(x) and x.requires_grad:
            raise NotImplementedError(
                f"march_forward: {name} requires grad, but the backward "
                "ray-march kernel (K2, volumetric_renderer_tpu/kernels/"
                "slab.py:_make_bwd_kernel) is not ported yet")
    for name, t in tensors.items():
        want = torch.bool if name == "hit" else torch.float32
        if t.dtype != want:
            raise TypeError(f"march_forward: {name} must be {want}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"march_forward: {name} must be contiguous")
    if vol.dim() != 3 or min(vol.shape) < 1:
        raise ValueError(f"march_forward: vol must be (Z, Y, X), got "
                         f"{tuple(vol.shape)}")
    if tf.dim() != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
        raise ValueError(f"march_forward: tf must be (N, 4), got "
                         f"{tuple(tf.shape)}")
    if pos0.dim() != 3 or pos0.shape[-1] != 3:
        raise ValueError(f"march_forward: pos0 must be (H, W, 3), got "
                         f"{tuple(pos0.shape)}")
    height, width = pos0.shape[:2]
    if tuple(dirs.shape) != tuple(pos0.shape) or \
            tuple(hit.shape) != (height, width):
        raise ValueError("march_forward: dirs must match pos0 (H, W, 3) and "
                         "hit must be (H, W)")
    if max(*vol.shape, height, width) >= 2 ** 31:
        raise ValueError("march_forward: a dimension past 2^31 - 1 does not "
                         "fit the kernel's int arguments")

    lib = load_library()
    dev_index = device.index if device.index is not None else \
        torch.cuda.current_device()
    smem_limit = ctypes.c_int(0)
    _check_cuda(lib.march_fwd_max_dynamic_smem(dev_index,
                                               ctypes.byref(smem_limit)),
                lib, "reading the shared-memory limit")
    if tf.shape[0] * 16 > smem_limit.value:
        raise ValueError(f"march_forward: a {tf.shape[0]}-texel TF needs "
                         f"{tf.shape[0] * 16} bytes of shared memory; the "
                         f"device allows {smem_limit.value}")

    def floats(x, n):
        vals = torch.as_tensor(x, dtype=torch.float32).reshape(-1).tolist()
        if len(vals) != n:
            raise ValueError(f"march_forward: expected {n} values, got "
                             f"{len(vals)}")
        return vals

    (dmin_f,) = floats(dmin, 1)
    (inv_w,) = floats(inv_window, 1)
    s0 = floats(smin, 3)
    s1 = floats(smax, 3)

    out = torch.empty((height, width, 4), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    nz, ny, nx = vol.shape
    code = lib.march_fwd_launch(
        dev_index, pos0.data_ptr(), dirs.data_ptr(), hit.data_ptr(),
        vol.data_ptr(), nz, ny, nx, tf.data_ptr(), tf.shape[0],
        out.data_ptr(), height, width, dmin_f, inv_w, *s0, *s1,
        int(num_steps), float(step_size), int(bool(early_termination)),
        float(termination_eps), 1.0 - ALPHA_EPS, stream)
    _check_cuda(code, lib, "launch")
    march_forward.launches += 1
    return out


#: Kernel launches since the count was last reset; a run sets it to 0 and
#: reads it back to show that its main path went through the kernel.
march_forward.launches = 0
