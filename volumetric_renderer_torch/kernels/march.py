"""The ray-march kernels and their plain PyTorch versions.

* K1, the forward march ``csrc/march_fwd.cu``, replaces the JAX package's
  TPU kernel ``volumetric_renderer_tpu/kernels/slab.py:_make_kernel``;
  its plain version is ``core.fused.march_prepared``.
* K2, the backward re-march ``csrc/march_bwd.cu``, replaces
  ``slab.py:_make_bwd_kernel``; its plain version is
  ``core.fused.march_backward_prepared``.

Ray setup (``core.marcher.prepare_rays``: box entry, entry clamp, window
reciprocal) stays in torch; the kernels take over the per-step loops.  K1
reads the grid through a texture: a copy of it in a 3D array, made again
only when the grid changes (``_grid_texture``), kept per device and shape.
:func:`make_kernel_marcher` ties K1 and K2 into one differentiable marcher.

:func:`march_forward` and :func:`march_backward` are the entry points.  On
CPU tensors they run the plain versions; on CUDA tensors they launch the
kernel or raise.  They never fall back to the plain version on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch

from volumetric_renderer_torch.core.fused import (
    ALPHA_EPS,
    MarchFunction,
    march_backward_prepared,
    march_prepared,
)
from volumetric_renderer_torch.core.sampling import check_own
from volumetric_renderer_torch.kernels import _build
from volumetric_renderer_torch.utils.device import device_key, to_device
from volumetric_renderer_torch.utils.metrics import span

#: The plain versions: same inputs, same operations in the same order.
march_forward_plain = march_prepared
march_backward_plain = march_backward_prepared

_libs: dict = {}
#: Rows of rays one launch of K1 or K2 takes at most: its launch grid has
#: at most 65535 blocks of 16 rows along y.  A caller with more rows splits
#: them over several launches (``parallel/render.make_sharded_renderer``).
MAX_ROWS = 65535 * 16
#: Copies of K2's (N, 4) f64 TF-gradient table in global memory, one per
#: block index mod copies, which the wrapper sums: fewer blocks reduce into
#: one address at once.
TF_GRAD_COPIES = 64


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of kernel library ``name`` on ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "march_fwd":
        launch = [i, p, p, p, ctypes.c_ulonglong,   # device .. tex
                  i, i, i,                      # nz, ny, nx
                  i, i, i, i,                   # own: axis, start, body, total
                  p, i, p, i, i,                # tf .. width
                  p,                            # window
                  i, f, i, f, f,                # steps .. amax
                  p, p]                         # counts, stream
    else:
        launch = [i, p, p, p, p, i, i, i,        # device .. nx
                  i, i, i, i,                    # own: axis, start, body, total
                  p, i,                          # tf, ntf
                  p, p, p, p, i, i, p, i, i,     # out .. width
                  p,                             # window
                  i, f, i, f, f, f,              # steps .. alpha_eps
                  p, p]                          # counts, stream
    getattr(lib, f"{name}_launch").restype = i
    getattr(lib, f"{name}_launch").argtypes = launch
    getattr(lib, f"{name}_max_dynamic_smem").restype = i
    getattr(lib, f"{name}_max_dynamic_smem").argtypes = [
        i, ctypes.POINTER(ctypes.c_int)]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    getattr(lib, f"{name}_error_string").argtypes = [i]
    if name == "march_fwd":
        lib.march_fwd_texture_alloc.restype = i
        lib.march_fwd_texture_alloc.argtypes = [
            i, i, i, i, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_ulonglong)]
        lib.march_fwd_texture_fill.restype = i
        lib.march_fwd_texture_fill.argtypes = [p, p, p]
        lib.march_fwd_texture_free.restype = i
        lib.march_fwd_texture_free.argtypes = [p]
    if name == "march_bwd":
        lib.march_bwd_occupancy.restype = i
        lib.march_bwd_occupancy.argtypes = [
            i, i, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib


def load_library(name: str = "march_fwd") -> ctypes.CDLL:
    """Build (on first use) and load kernel library ``name``
    (``march_fwd`` or ``march_bwd``)."""
    if name not in _libs:
        _libs[name] = _bind(name, ctypes.CDLL(_build.build(name).path))
    return _libs[name]


def _check_cuda(code: int, lib, name: str, what: str) -> None:
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: {what} failed: CUDA error {code} "
                           f"({msg})")


def _device_of(fn: str, tensors: dict) -> torch.device:
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{fn}: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {device}")
    return device


def _check_kernel_inputs(fn: str, tensors: dict, smem_per_texel: int,
                         name: str, device) -> tuple:
    """The checks every launch makes: types, contiguity, shapes, int and
    launch-grid range and shared memory.  Returns ``(lib, device index,
    height, width, the device's shared-memory limit per block)``."""
    for key, t in tensors.items():
        want = torch.bool if key == "hit" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{fn}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {key} must be contiguous")
    vol, tf, pos0 = tensors["vol"], tensors["tf"], tensors["pos0"]
    if vol.dim() != 3 or min(vol.shape) < 1:
        raise ValueError(f"{fn}: vol must be (Z, Y, X), got "
                         f"{tuple(vol.shape)}")
    if tf.dim() != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
        raise ValueError(f"{fn}: tf must be (N, 4), got {tuple(tf.shape)}")
    if pos0.dim() != 3 or pos0.shape[-1] != 3:
        raise ValueError(f"{fn}: pos0 must be (H, W, 3), got "
                         f"{tuple(pos0.shape)}")
    height, width = pos0.shape[:2]
    if tuple(tensors["dirs"].shape) != tuple(pos0.shape) or \
            tuple(tensors["hit"].shape) != (height, width):
        raise ValueError(f"{fn}: dirs must match pos0 (H, W, 3) and hit "
                         "must be (H, W)")
    for key in ("out", "g"):
        if key in tensors and \
                tuple(tensors[key].shape) != (height, width, 4):
            raise ValueError(f"{fn}: {key} must be (H, W, 4) = "
                             f"{(height, width, 4)}, got "
                             f"{tuple(tensors[key].shape)}")
    if max(*vol.shape, height, width) >= 2 ** 31:
        raise ValueError(f"{fn}: a dimension past 2^31 - 1 does not fit the "
                         "kernel's int arguments")
    if height > MAX_ROWS:
        raise ValueError(f"{fn}: {height} rows need more than the "
                         f"{-(-MAX_ROWS // 16)} blocks of 16 a launch grid "
                         "has along y")

    lib = load_library(name)
    dev_index = device.index if device.index is not None else \
        torch.cuda.current_device()
    limit = ctypes.c_int(0)
    _check_cuda(getattr(lib, f"{name}_max_dynamic_smem")(
        dev_index, ctypes.byref(limit)), lib, name,
        "reading the shared-memory limit")
    need = tf.shape[0] * smem_per_texel
    if need > limit.value:
        raise ValueError(f"{fn}: a {tf.shape[0]}-texel TF needs {need} bytes "
                         f"of shared memory; the device allows {limit.value}")
    return lib, dev_index, height, width, limit.value


def _window(fn: str, device, dmin, inv_window, smin, smax) -> torch.Tensor:
    """``[dmin, inv_w, *smin, *smax]`` as one contiguous ``(8,)`` float32
    tensor on ``device``, which the kernel reads there: values already on
    the card are used as they are and never pass through the host, and
    host values (numbers or host tensors) reach it in one asynchronous
    copy from pinned memory (``utils.device.to_device``), so the host never
    waits for the card here."""
    parts = []
    for key, x, n in (("dmin", dmin, 1), ("inv_window", inv_window, 1),
                      ("smin", smin, 3), ("smax", smax, 3)):
        x = torch.as_tensor(x, dtype=torch.float32).detach().reshape(-1)
        if x.numel() != n:
            raise ValueError(f"{fn}: {key} must hold {n} value(s), got "
                             f"{x.numel()}")
        parts.append(x)
    return torch.cat(to_device(parts, device))


#: :func:`_one_wave` for each ``(device index, TF texels)`` queried.
_waves: dict = {}


def _one_wave(lib, dev_index: int, ntf: int) -> int:
    """The blocks of K2 (its TF gradient in global memory) that the device
    runs at once.  A launch of more runs in waves and is bound by
    throughput, so K2 then sums each block's TF gradient in shared memory
    first; a launch of at most one wave is bound by each thread's chain of
    dependent latencies, and K2 then adds to global memory directly.  The
    occupancy query runs once per device and TF size."""
    key = (dev_index, ntf)
    if key not in _waves:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        _check_cuda(lib.march_bwd_occupancy(dev_index, ntf,
                                            ctypes.byref(per_sm),
                                            ctypes.byref(sms)),
                    lib, "march_bwd", "reading the occupancy")
        _waves[key] = per_sm.value * sms.value
    return _waves[key]


@dataclasses.dataclass
class _GridTexture:
    """K1's copy of a grid in a 3D array, read through a texture object."""
    handle: ctypes.c_void_p       # for march_fwd_texture_fill / _free
    tex: int                      # the texture object, for the launch
    done: torch.cuda.Event        # recorded after each launch that read it
    source: tuple = None          # what was copied in (_grid_source)


#: K1's grid textures: for each device, an array per grid shape, the least
#: recently used first (``_grid_texture``).
_textures: dict = {}
#: The arrays a device keeps at most; one more shape frees the oldest.
TEXTURES_PER_DEVICE = 4


def _grid_source(vol):
    """What tells ``vol``'s voxels apart from others of its shape: a weak
    reference to its storage, its address and its version counter (shared
    by its views and ``detach()``); ``None`` for an inference tensor,
    which has no version counter and is copied at every launch."""
    if vol.is_inference():
        return None
    return (weakref.ref(vol.untyped_storage()), vol.data_ptr(),
            vol._version)


def _grid_texture(lib, dev_index: int, vol, stream) -> _GridTexture:
    """The texture K1 reads ``vol`` through on device ``dev_index``.

    Each device keeps an array for each of the last
    ``TEXTURES_PER_DEVICE`` grid shapes it marched, so whole grids and
    depth chunks taken in turns each keep theirs.  The voxels are copied
    in again unless ``vol`` is the grid copied last at its shape, unchanged
    since (the same live storage, address and version counter).  No
    reference to the grid is kept: freeing it is not held up, and a grid
    that takes a freed grid's address is copied in.  Freeing an array waits
    for the device, so it happens only where a shape pushes out the oldest
    array, or in :func:`release_grid_textures`.  A change that bypasses the
    version counter (through ``.data`` or raw pointers) is not seen: change
    the grid through the tensor itself, or pass another."""
    shape = tuple(vol.shape)
    textures = _textures.setdefault(dev_index, {})
    entry = textures.pop(shape, None)
    if entry is None:
        if len(textures) >= TEXTURES_PER_DEVICE:
            _free_texture(lib, textures.pop(next(iter(textures))))
        handle, tex = ctypes.c_void_p(), ctypes.c_ulonglong()
        _check_cuda(lib.march_fwd_texture_alloc(
            dev_index, *shape, ctypes.byref(handle), ctypes.byref(tex)),
            lib, "march_fwd", "allocating the grid texture")
        entry = _GridTexture(handle, tex.value, torch.cuda.Event())
    textures[shape] = entry             # now the most recently used
    source = _grid_source(vol)
    old = entry.source
    if source is None or old is None or old[0]() is not source[0]() or \
            old[1:] != source[1:]:
        with span("vr.texture_fill"):
            # a launch on another stream may still read the array
            torch.cuda.current_stream(vol.device).wait_event(entry.done)
            _check_cuda(lib.march_fwd_texture_fill(entry.handle,
                                                   vol.data_ptr(), stream),
                        lib, "march_fwd", "copying the grid into its texture")
        entry.source = source
        march_forward.texture_fills += 1
    return entry


def _free_texture(lib, entry: _GridTexture) -> None:
    entry.done.synchronize()            # no launch reads the array any more
    _check_cuda(lib.march_fwd_texture_free(entry.handle), lib, "march_fwd",
                "freeing the grid texture")


def release_grid_textures() -> None:
    """Frees K1's grid textures on every device (waiting for the launches
    that read them); the next launch on a grid copies it in again."""
    while _textures:
        _, textures = _textures.popitem()
        while textures:
            _free_texture(load_library("march_fwd"), textures.popitem()[1])


def _own_args(fn: str, own, vol) -> tuple:
    """The kernel's ``(own_axis, own_start, own_body, own_total)``:
    ``(-1, 0, 0, 0)`` for the whole volume."""
    try:
        own = check_own(own, tuple(vol.shape))
    except ValueError as e:
        raise ValueError(f"{fn}: {e}") from None
    return (-1, 0, 0, 0) if own is None else own


def march_forward(vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax, *,
                  num_steps: int, step_size: float, early_termination: bool,
                  termination_eps: float, own=None) -> torch.Tensor:
    """K1: march prepared rays: ``pos0``/``dirs`` ``(H, W, 3)``, ``hit``
    ``(H, W)`` bool; returns RGBA ``(H, W, 4)`` float32.

    ``dmin`` and ``inv_window`` are scalars and ``smin``/``smax`` 3-vectors
    (tensors or numbers).  ``own = (axis, a_start, body, n_total)`` marches
    one depth chunk: ``vol`` is rows ``a_start .. a_start + body`` (the last
    one the halo) of a volume of ``n_total`` rows along array axis
    ``axis``, and only the samples the chunk owns are composited
    (``core.sampling.check_own``).  On CUDA every tensor must be float32
    (``hit`` bool) and contiguous, on one device; the kernel reads ``vol``
    through a copy in a texture, kept for the next launch on the same grid
    (``_grid_texture``; :func:`release_grid_textures` frees the copies).
    The output carries no
    graph: under grad mode, inputs that require grad raise; differentiate
    through :func:`make_kernel_marcher` (``render(method="kernel")``)
    instead.
    """
    fn = "march_forward"
    tensors = {"vol": vol, "tf": tf, "pos0": pos0, "dirs": dirs, "hit": hit}
    device = _device_of(fn, tensors)
    if device.type == "cpu":
        return march_forward_plain(
            vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax,
            num_steps=num_steps, step_size=step_size,
            early_termination=early_termination,
            termination_eps=termination_eps, own=own)

    if torch.is_grad_enabled():
        for key, x in {**tensors, "dmin": dmin, "inv_window": inv_window,
                       "smin": smin, "smax": smax}.items():
            if torch.is_tensor(x) and x.requires_grad:
                raise RuntimeError(
                    f"{fn}: {key} requires grad, but the kernel's output "
                    "carries no graph; differentiate through "
                    "make_kernel_marcher or render(method='kernel'), whose "
                    "backward is the K2 kernel (march_backward)")
    with span("vr.k1"):
        lib, dev_index, height, width, _ = _check_kernel_inputs(
            fn, tensors, 16, "march_fwd", device)
        own = _own_args(fn, own, vol)
        window = _window(fn, device, dmin, inv_window, smin, smax)

        out = torch.empty((height, width, 4), dtype=torch.float32,
                          device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        texture = _grid_texture(lib, dev_index, vol, stream)
        code = lib.march_fwd_launch(
            dev_index, pos0.data_ptr(), dirs.data_ptr(), hit.data_ptr(),
            texture.tex, *vol.shape, *own, tf.data_ptr(), tf.shape[0],
            out.data_ptr(), height, width, window.data_ptr(),
            int(num_steps), float(step_size), int(bool(early_termination)),
            float(termination_eps), 1.0 - ALPHA_EPS,
            counts.pointer(device, "k1"), stream)
        _check_cuda(code, lib, "march_fwd", "launch")
        texture.done.record(torch.cuda.current_stream(device))
        march_forward.launches += 1
        return out


def march_backward(vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax,
                   out, g, *, num_steps: int, step_size: float,
                   early_termination: bool, termination_eps: float,
                   own=None):
    """K2: the re-march backward of :func:`march_forward` over the same
    prepared rays, given its output ``out`` and the cotangent ``g`` (both
    ``(H, W, 4)``).  Returns ``(vol_g, tf_g, dmin_g, dmax_g)``: the grid
    gradient with ``vol``'s shape (a chunk's halo row included), the TF
    gradient ``(N, 4)`` and two scalars.

    The same checks and the same ``own`` as :func:`march_forward`; ``g`` is
    made contiguous.  On CUDA the gradients come from f32 atomics, so they
    are not bitwise repeatable.
    """
    fn = "march_backward"
    g = g.detach().contiguous()
    tensors = {"vol": vol, "tf": tf, "pos0": pos0, "dirs": dirs, "hit": hit,
               "out": out, "g": g}
    device = _device_of(fn, tensors)
    if device.type == "cpu":
        return march_backward_plain(
            vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax, out, g,
            num_steps=num_steps, step_size=step_size,
            early_termination=early_termination,
            termination_eps=termination_eps, own=own)

    with span("vr.k2"):
        lib, dev_index, height, width, smem_limit = _check_kernel_inputs(
            fn, tensors, 16, "march_bwd", device)
        own = _own_args(fn, own, vol)
        window = _window(fn, device, dmin, inv_window, smin, smax)
        blocks = -(-height // 16) * -(-width // 16)
        # the shared table takes ntf*48 bytes of shared memory, else ntf*16
        shared_table = (tf.shape[0] * 48 <= smem_limit
                        and blocks > _one_wave(lib, dev_index, tf.shape[0]))
        copies = max(1, min(TF_GRAD_COPIES, blocks))

        # the TF and window gradients are accumulated in f64, as in the
        # plain version, and rounded to f32 here
        vol_g = torch.zeros_like(vol)
        tf_g = torch.zeros((copies,) + tuple(tf.shape), dtype=torch.float64,
                           device=device)
        win_g = torch.zeros(2, dtype=torch.float64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        nz, ny, nx = vol.shape
        code = lib.march_bwd_launch(
            dev_index, pos0.data_ptr(), dirs.data_ptr(), hit.data_ptr(),
            vol.data_ptr(), nz, ny, nx, *own, tf.data_ptr(), tf.shape[0],
            out.data_ptr(), g.data_ptr(), vol_g.data_ptr(), tf_g.data_ptr(),
            copies, int(shared_table), win_g.data_ptr(), height, width,
            window.data_ptr(),
            int(num_steps), float(step_size), int(bool(early_termination)),
            float(termination_eps), 1.0 - ALPHA_EPS, ALPHA_EPS,
            counts.pointer(device, "k2"), stream)
        _check_cuda(code, lib, "march_bwd", "launch")
        march_backward.launches += 1
        win_g = win_g.float()
        return vol_g, tf_g.sum(0).float(), win_g[0], win_g[1]


#: Kernel launches since the count was last reset; a run sets them to 0 and
#: reads them back to show that its main path went through the kernels.
march_forward.launches = 0
march_backward.launches = 0
#: Copies of a grid into K1's texture (``_grid_texture``) since the count
#: was last reset: a timed loop over one unchanged grid should make none.
march_forward.texture_fills = 0

#: What K1's and K2's counted instantiations count, in the order of their
#: slots in a device's counter buffer (:class:`KernelCounts`).
COUNTED = {"k1": ("sampled", "lane_steps"),
           "k2": ("sampled", "lane_steps", "voxel_atomics", "tf_flushes")}


class KernelCounts:
    """The counts K1 and K2 take on the card while :attr:`on`
    (``utils.metrics.counting`` sets it): each kernel's :data:`COUNTED` in
    one int64 buffer per device, K1's slots first.  ``sampled`` counts the
    steps that composite; ``lane_steps`` 32 times each warp's trips of the
    step loop (K1: its longest walk); ``voxel_atomics`` K2's ``atomicAdd``
    on the grid gradient (an in-grid corner of a sample whose density
    gradient is not 0); ``tf_flushes`` the trips in which K2's warp flushes
    ended TF-gradient runs.  While off, a launch takes no buffer and runs
    the kernel's uncounted instantiation."""

    def __init__(self):
        self.on = False
        self._buffers = {}

    def pointer(self, device, kernel: str):
        """The address of ``kernel``'s slots on ``device``, or None (off);
        the device's buffer is made, zeroed, on its first counted launch."""
        if not self.on:
            return None
        key = device_key(device)
        if key not in self._buffers:
            self._buffers[key] = torch.zeros(
                sum(map(len, COUNTED.values())), dtype=torch.int64,
                device=key)
        offset = 0 if kernel == "k1" else len(COUNTED["k1"])
        return self._buffers[key][offset:].data_ptr()

    def reset(self) -> None:
        for buffer in self._buffers.values():
            buffer.zero_()

    def read(self, device) -> dict:
        """``{"k1": {count: n}, "k2": {...}}`` on ``device`` (waits for
        it); None for each where no counted launch ran there."""
        buffer = self._buffers.get(device_key(device))
        if buffer is None:
            return dict.fromkeys(COUNTED)
        values, out = buffer.tolist(), {}
        for kernel, names in COUNTED.items():
            out[kernel] = dict(zip(names, values))
            values = values[len(names):]
        return out


counts = KernelCounts()


def make_kernel_marcher(num_steps: int, step_size: float,
                        early_termination: bool, termination_eps: float,
                        own=None):
    """The differentiable kernel marcher: ``f(vol, tf_table, origin, dirs,
    density_min, density_max, slice_min, slice_max) -> rgba`` with K1
    (:func:`march_forward`) as its forward and K2 (:func:`march_backward`)
    as its backward; the signature of ``core.fused.make_fused_marcher``,
    ``own`` included."""
    march_kw = dict(num_steps=num_steps, step_size=step_size,
                    early_termination=early_termination,
                    termination_eps=termination_eps, own=own)

    def march(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        return MarchFunction.apply(march_forward, march_backward, march_kw,
                                   vol, tf, origin, dirs, dmin, dmax, smin,
                                   smax)

    return march
