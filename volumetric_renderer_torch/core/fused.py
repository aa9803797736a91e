"""The fused march, forward only: the plain PyTorch version of the forward
kernel (``kernels/march.py``).

Same semantics as ``core.marcher.march_rays`` plus the opacity clamp
``a <= 1 - ALPHA_EPS`` that the JAX package's custom-VJP marcher
(``volumetric_renderer_tpu/core/fused.py``) applies so that its re-march
backward can divide by ``1 - a``.  The clamp deviates from the reference
shader by at most ~ALPHA_EPS * num_steps << 1e-5.

The march is split in two so the CUDA kernel can take over the loop:
``core.marcher.prepare_rays`` (ray/box entry, entry clamp, window
reciprocal) always runs in torch, and :func:`march_prepared` is the
per-step loop that the kernel replaces.  The re-march backward waits for
the backward kernel.
"""

from __future__ import annotations

import torch

from volumetric_renderer_torch.core.marcher import prepare_rays, step_offsets
from volumetric_renderer_torch.core.sampling import trilinear_sample
from volumetric_renderer_torch.transfer.texture import sample_tf

ALPHA_EPS = 1e-7


def march_prepared(vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax, *,
                   num_steps: int, step_size: float, early_termination: bool,
                   termination_eps: float) -> torch.Tensor:
    """The forward march over prepared rays; RGBA ``dirs.shape[:-1] + (4,)``.

    Every step runs for every ray (masked steps add exactly 0), in the
    operation order the kernel reproduces: ``pos = pos0 + (k*dt)*dir``,
    texel coordinate ``pos*N - 0.5``, CLAMP_TO_BORDER trilinear, window
    normalisation, CLAMP_TO_EDGE TF lerp, opacity clamp, composite.
    """
    amax = 1.0 - ALPHA_EPS
    rgb = torch.zeros(dirs.shape[:-1] + (3,), dtype=torch.float32,
                      device=dirs.device)
    tr = torch.ones(dirs.shape[:-1], dtype=torch.float32, device=dirs.device)
    offsets = step_offsets(num_steps, step_size, torch.float32, dirs.device)
    for k in range(num_steps):
        pos = pos0 + offsets[k] * dirs
        inside = torch.all((pos >= 0.0) & (pos <= 1.0), dim=-1)
        sliced = torch.all((pos < smax) & (pos > smin), dim=-1)
        active = inside & sliced & hit
        if early_termination:
            active = active & (tr > termination_eps)

        density = trilinear_sample(vol, pos)
        t = (density - dmin) * inv_window
        t = torch.where(active, t, 0.0)  # NaN-voxel containment
        rgba = sample_tf(tf, t)
        a = torch.clamp(rgba[..., 3], max=amax)
        a = torch.where(active, a, 0.0)
        rgb = rgb + (tr * a)[..., None] * rgba[..., :3]
        tr = tr * (1.0 - a)
    alpha = torch.where(hit, 1.0 - tr, 0.0)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def make_fused_marcher(num_steps: int, step_size: float,
                       early_termination: bool, termination_eps: float):
    """A marcher specialised to static march settings, with the signature of
    the JAX package's ``make_fused_marcher``:
    ``f(vol, tf_table, origin, dirs, density_min, density_max, slice_min,
    slice_max) -> rgba``.  Forward only."""

    def march(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        pos0, hit, inv_window = prepare_rays(origin, dirs, dmin, dmax)
        return march_prepared(
            vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax,
            num_steps=num_steps, step_size=step_size,
            early_termination=early_termination,
            termination_eps=termination_eps)

    return march
