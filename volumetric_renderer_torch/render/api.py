"""Public render API.

The functional equivalent of the reference's render loop
(``OffscreenPass::record`` -> ``volume.frag``): one call renders one frame.
The interactive mutation entry points of the reference collapse into plain
function arguments: pass a different volume / TF table / slicing window /
``RenderSettings`` and you have "mutated" the renderer.

Methods, all differentiable in the grid, the TF table and the density
window:
  * ``"oracle"`` — the plain-autograd marcher of ``core.marcher``.  Ground
    truth; its backward keeps every step's intermediates.
  * ``"fused"``  — the plain PyTorch versions of the kernels
    (``core.fused``: the oracle plus the ``ALPHA_EPS`` opacity clamp), with
    the O(1)-memory re-march backward; any device.
  * ``"kernel"`` — the hand-written CUDA kernels (``kernels/march.py``): K1
    forward, K2 backward; CUDA volumes only.
  * ``"auto"`` (default) — ``"kernel"`` for a CUDA volume, ``"fused"`` for a
    CPU volume.

The JAX package's ``"blocked"``, ``"slab"`` and ``"pallas"`` are TPU paths
and are rejected: a ray-major kernel has per-ray trip counts natively and no
march-direction envelope.
"""

from __future__ import annotations

import torch

from volumetric_renderer_torch.core.fused import make_fused_marcher
from volumetric_renderer_torch.core.marcher import frame_inputs, march_rays
from volumetric_renderer_torch.kernels.march import make_kernel_marcher
from volumetric_renderer_torch.scene.camera import OrbitCamera
from volumetric_renderer_torch.utils.config import RenderSettings

METHODS = ("auto", "oracle", "fused", "kernel")


def resolve_method(vol: torch.Tensor) -> str:
    """``method="auto"``: the kernel for a CUDA volume, else ``"fused"``."""
    return "kernel" if vol.device.type == "cuda" else "fused"


def render(
    vol: torch.Tensor,
    tf_table: torch.Tensor,
    camera: OrbitCamera,
    settings: RenderSettings = RenderSettings(),
    *,
    density_min=None,
    density_max=None,
    slice_min=None,
    slice_max=None,
    method: str = "auto",
    tf_srgb: bool = False,
) -> torch.Tensor:
    """Render one ``(H, W, 4)`` RGBA frame on ``vol``'s device.

    ``vol``: float32 ``(Z, Y, X)`` density grid.  ``tf_table``: float32
    ``(N, 4)`` RGBA transfer function (see ``transfer``).  RGB is the
    front-to-back accumulation, alpha is opacity; composite over a
    background with :func:`composite_over`.

    Defaults mirror the reference UBO (``offscreen_pass.h:29-37``): the
    density window is the volume's min/max, the slicing window [0,1]^3.
    That default window stays in the graph: the gradient reaching it flows
    into ``vol`` through ``min``/``max``, split evenly among tied voxels,
    as ``jnp.min``/``jnp.max`` do in the JAX package.

    ``tf_srgb=True`` treats the TF table's RGB as sRGB-encoded and decodes
    it before lookup — byte-for-byte the reference's ``R8G8B8A8_SRGB`` TF
    sampler (``offscreen_pass.cpp:1076``).  The default (False) is this
    framework's linear-throughout convention.
    """
    if method in ("blocked", "slab", "pallas"):
        raise ValueError(
            f"method={method!r} is a TPU path of the JAX package; this "
            f"port's methods are {METHODS}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    if method == "auto":
        method = resolve_method(vol)
    if method == "kernel" and vol.device.type != "cuda":
        raise ValueError("method='kernel' launches the CUDA kernel and needs "
                         f"a CUDA volume, got one on {vol.device}; use "
                         "'fused' or 'auto' on the CPU")
    tf_table = torch.as_tensor(tf_table, device=vol.device)
    if tf_srgb:
        from volumetric_renderer_torch.utils.color import linearize_tf_table

        tf_table = linearize_tf_table(tf_table)
    origin, dirs, dmin, dmax, smin, smax = frame_inputs(
        vol, camera, settings, density_min, density_max, slice_min, slice_max
    )
    march = dict(num_steps=settings.num_steps, step_size=settings.step_size,
                 early_termination=settings.early_termination,
                 termination_eps=settings.termination_eps)
    if method == "oracle":
        return march_rays(vol, tf_table, origin, dirs, density_min=dmin,
                          density_max=dmax, slice_min=smin, slice_max=smax,
                          **march)
    make = make_fused_marcher if method == "fused" else make_kernel_marcher
    return make(**march)(vol, tf_table, origin, dirs, dmin, dmax, smin, smax)


def composite_over(rgba: torch.Tensor, background,
                   reference_blend: bool = False):
    """Composite a rendered frame over an RGB background.

    The renderer's RGB output is premultiplied-by-construction (each sample
    adds ``T * a * c``), so the correct operator is
    ``rgb + bg * (1 - alpha)``.  The reference instead configures standard
    (non-premultiplied) alpha blending over its 0.11-gray clear color
    (``offscreen_pass.cpp:171``, blend state ``offscreen_pass.cpp:715-726``),
    i.e. ``rgb * alpha + bg * (1 - alpha)`` — double-weighting the volume
    color by alpha.  Pass ``reference_blend=True`` to reproduce that quirk.
    """
    bg = torch.as_tensor(background, dtype=torch.float32, device=rgba.device)
    a = rgba[..., 3:4]
    if reference_blend:
        return rgba[..., :3] * a + bg * (1.0 - a)
    return rgba[..., :3] + bg * (1.0 - a)


def adjust_display(rgb: torch.Tensor, brightness: float = 0.0,
                   contrast: float = 0.0):
    """Display-space brightness/contrast post-process.

    The reference shows Brightness/Contrast sliders in its Display panel
    but never pushes them to the renderer (``src/ui/main_window.cpp:191-205``).
    Here they work: ``out = (rgb - 0.5) * (1 + contrast) + 0.5 +
    brightness``, clipped to [0, 1], applied after :func:`composite_over`.
    """
    out = (rgb - 0.5) * (1.0 + contrast) + 0.5 + brightness
    return torch.clamp(out, 0.0, 1.0)


def render_loss_and_grads(vol, tf_table, camera, target,
                          settings: RenderSettings = RenderSettings(), *,
                          loss: str = "l2", method: str = "fused", **kw):
    """Pixel loss against ``target`` and its gradients with respect to
    ``(vol, tf_table)``: ``(value, (vol_g, tf_g))``, as the JAX package's
    ``render_loss_and_grads``.  ``loss="l2"`` is ``0.5 * mean(diff**2)`` over
    RGB, ``"l1"`` is ``mean(|diff|)``; ``kw`` goes to :func:`render`."""
    if loss not in ("l2", "l1"):
        raise ValueError(f"unknown loss {loss!r}")
    v = vol.detach().requires_grad_(True)
    tf = torch.as_tensor(tf_table, device=vol.device).detach()
    tf.requires_grad_(True)
    img = render(v, tf, camera, settings, method=method, **kw)
    diff = img[..., :3] - torch.as_tensor(target, device=vol.device)[..., :3]
    value = 0.5 * torch.mean(diff * diff) if loss == "l2" else \
        torch.mean(torch.abs(diff))
    vol_g, tf_g = torch.autograd.grad(value, (v, tf))
    return value.detach(), (vol_g, tf_g)
