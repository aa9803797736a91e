"""The fused march: the plain PyTorch versions of the forward kernel (K1) and
the backward re-march kernel (K2) of ``kernels/march.py``, and the
O(1)-memory differentiable marcher they make together.

Same semantics as ``core.marcher.march_rays`` plus the opacity clamp
``a <= 1 - ALPHA_EPS`` that the JAX package's custom-VJP marcher
(``volumetric_renderer_tpu/core/fused.py``) applies so that its re-march
backward can divide by ``1 - a``.  The clamp deviates from the reference
shader by at most ~ALPHA_EPS * num_steps << 1e-5.

The march is split so the CUDA kernels can take over the loops:
``core.marcher.prepare_rays`` (ray/box entry, entry clamp, window
reciprocal) always runs in torch; :func:`march_prepared` is the per-step
loop that K1 replaces and :func:`march_backward_prepared` the re-march that
K2 replaces.

The backward needs no stored activations.  With per-step opacity ``a_k``,
colour ``c_k``, transmittance ``T_k`` and output ``rgb = sum_k T_k a_k c_k``,
``alpha = 1 - T_N``, the gradient of ``a_k`` needs the suffix sum
``S_k = sum_{j>k} T_j a_j (g_rgb . c_j)``, which is ``G - P_k`` with
``G = g_rgb . rgb_out`` and ``P_k`` the prefix sum of a second front-to-back
march:

    dL/dc_k = T_k a_k g_rgb
    dL/da_k = T_k (g_rgb . c_k) + (g_alpha T_N - S_k) / (1 - a_k)

Memory is O(1) in the step count; plain autograd through the step loop
(``method="oracle"``) keeps every step's intermediates instead.
"""

from __future__ import annotations

import torch

from volumetric_renderer_torch.core.marcher import prepare_rays, step_offsets
from volumetric_renderer_torch.core.sampling import (
    check_own,
    chunk_owns,
    trilinear_corners,
    trilinear_sample,
)
from volumetric_renderer_torch.transfer.texture import sample_tf, tf_lerp
from volumetric_renderer_torch.utils.metrics import span

ALPHA_EPS = 1e-7


def _active(pos, hit, smin, smax, tr, vol_shape, own, early_termination,
            termination_eps):
    """The steps that composite: inside the box, strictly inside the
    slicing window, on a hit ray, owned by the depth chunk (``own``) and,
    with early termination, where T > eps."""
    inside = torch.all((pos >= 0.0) & (pos <= 1.0), dim=-1)
    sliced = torch.all((pos < smax) & (pos > smin), dim=-1)
    active = inside & sliced & hit
    if own is not None:
        active = active & chunk_owns(vol_shape, pos, own)
    if early_termination:
        active = active & (tr > termination_eps)
    return active


def march_prepared(vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax, *,
                   num_steps: int, step_size: float, early_termination: bool,
                   termination_eps: float, own=None,
                   check=None) -> torch.Tensor:
    """The forward march over prepared rays; RGBA ``dirs.shape[:-1] + (4,)``.

    Every step runs for every ray (masked steps add exactly 0), in the
    operation order the kernel reproduces: ``pos = pos0 + (k*dt)*dir``,
    texel coordinate ``pos*N - 0.5``, CLAMP_TO_BORDER trilinear, window
    normalisation, CLAMP_TO_EDGE TF lerp, opacity clamp, composite.
    ``own = (axis, a_start, body, n_total)`` marches one depth chunk of a
    larger volume and composites only the samples it owns
    (``core.sampling.check_own``); T starts at 1 in every chunk.
    ``check(stage, k, x)``, where given, sees every value the loop makes
    (``utils.sanitize.checked_render`` tests them for NaN and Inf).
    """
    own = check_own(own, tuple(vol.shape))
    amax = 1.0 - ALPHA_EPS
    rgb = torch.zeros(dirs.shape[:-1] + (3,), dtype=torch.float32,
                      device=dirs.device)
    tr = torch.ones(dirs.shape[:-1], dtype=torch.float32, device=dirs.device)
    offsets = step_offsets(num_steps, step_size, torch.float32, dirs.device)
    for k in range(num_steps):
        pos = pos0 + offsets[k] * dirs
        active = _active(pos, hit, smin, smax, tr, vol.shape, own,
                         early_termination, termination_eps)

        density = trilinear_sample(vol, pos, own)
        t = (density - dmin) * inv_window
        if check is not None:
            for stage, x in (("pos", pos), ("density", density), ("t", t)):
                check(stage, k, x)
        t = torch.where(active, t, 0.0)  # NaN-voxel containment
        rgba = sample_tf(tf, t)
        a = torch.clamp(rgba[..., 3], max=amax)
        a = torch.where(active, a, 0.0)
        rgb = rgb + (tr * a)[..., None] * rgba[..., :3]
        tr = tr * (1.0 - a)
        if check is not None:
            for stage, x in (("tf", rgba), ("rgb", rgb),
                             ("transmittance", tr)):
                check(stage, k, x)
    alpha = torch.where(hit, 1.0 - tr, 0.0)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def _dot(a, b, n=3):
    """``sum_i a[..., i] * b[..., i]`` over the first ``n`` channels, added
    left to right as K2 adds them.  Near ``a -> 1`` the backward divides by
    ``1 - a`` (down to ALPHA_EPS), which turns a one-ulp difference here
    into a visible one, so the order is fixed rather than left to
    ``torch.sum``."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, n):
        out = out + a[..., i] * b[..., i]
    return out


#: Which of ``(vol, tf, window)`` a backward computes, where nothing says
#: otherwise: all three.
ALL_GRADS = (True, True, True)


def march_backward_prepared(vol, tf, pos0, dirs, hit, dmin, inv_window, smin,
                            smax, out, g, *, num_steps: int, step_size: float,
                            early_termination: bool, termination_eps: float,
                            own=None, needs=ALL_GRADS):
    """The re-march backward over prepared rays (the plain version of K2).

    ``out`` is the forward's RGBA and ``g`` its cotangent, both
    ``dirs.shape[:-1] + (4,)``.  Returns ``(vol_g, tf_g, dmin_g, dmax_g)``,
    operation for operation the backward of the JAX package's
    ``make_fused_marcher``, with ``T_N = 1 - out alpha`` and
    ``G = g_rgb . out_rgb`` as its slab kernel takes them.  With ``own``
    (as :func:`march_prepared`) ``vol_g`` has the chunk's shape, its halo
    row included.

    The TF-table and window gradients are sums over every ray and step
    (~1e6 terms in one TF texel at 96x96 pixels and 128 steps); f32 in an
    arbitrary order loses ~1e-4 relative there, so they are accumulated in
    float64, here and in K2, and returned as float32.

    ``needs = (vol, tf, window)`` says which gradients are wanted; the
    others are returned as ``None``.  Without the TF's and the window's
    their sums are not taken; the grid's is the same either way.
    """
    want_vol, want_tf, want_win = map(bool, needs)
    own = check_own(own, tuple(vol.shape))
    amax = 1.0 - ALPHA_EPS
    dev = dirs.device
    n = tf.shape[0]
    g_rgb = g[..., :3]
    g_alpha = torch.where(hit, g[..., 3], 0.0)
    big_g = _dot(g_rgb, out)
    tr_fin = 1.0 - out[..., 3]

    vol_flat = vol.reshape(-1)
    vol_g = torch.zeros_like(vol_flat)
    f64 = torch.float64
    tf_g = torch.zeros(tf.shape, dtype=f64, device=dev)
    dmin_g = torch.zeros((), dtype=f64, device=dev)
    dmax_g = torch.zeros((), dtype=f64, device=dev)
    tr = torch.ones(dirs.shape[:-1], dtype=torch.float32, device=dev)
    p = torch.zeros_like(tr)
    offsets = step_offsets(num_steps, step_size, torch.float32, dev)
    for k in range(num_steps):
        pos = pos0 + offsets[k] * dirs
        active = _active(pos, hit, smin, smax, tr, vol.shape, own,
                         early_termination, termination_eps)

        # the forward's sample, recomputed with the same operations
        corners = trilinear_corners(vol.shape, pos, own)
        density = torch.zeros(pos.shape[:-1], dtype=vol.dtype, device=dev)
        for flat, valid, weight in corners:
            v = torch.where(valid, vol_flat[flat], 0.0)
            density = density + v * weight
        t = (density - dmin) * inv_window
        t = torch.where(active, t, 0.0)  # NaN-voxel containment
        lo, hi, w = tf_lerp(n, t)
        tf_lo, tf_hi = tf[lo], tf[hi]
        rgba = tf_lo * (1.0 - w[..., None]) + tf_hi * w[..., None]
        a_raw = rgba[..., 3]
        clamped = a_raw > amax
        a = torch.where(active, torch.clamp(a_raw, max=amax), 0.0)
        c = rgba[..., :3]

        gc_dot_c = _dot(g_rgb, c)
        p = p + tr * a * gc_dot_c
        s_k = big_g - p                      # suffix sum over j > k
        one_minus_a = torch.clamp(1.0 - a, min=ALPHA_EPS)
        dl_dc = (tr * a)[..., None] * g_rgb
        dl_da = tr * gc_dot_c + (g_alpha * tr_fin - s_k) / one_minus_a
        dl_da = torch.where(active & ~clamped, dl_da, 0.0)
        dl_dc = torch.where(active[..., None], dl_dc, 0.0)

        # TF-table scatter: the transpose of the 2-bin lerp fetch.
        g_rgba = torch.cat([dl_dc, dl_da[..., None]], dim=-1)
        if want_tf:
            flat_g = g_rgba.reshape(-1, 4)
            flat_w = w.reshape(-1, 1)
            tf_g.index_add_(0, lo.reshape(-1),
                            (flat_g * (1.0 - flat_w)).to(f64))
            tf_g.index_add_(0, hi.reshape(-1), (flat_g * flat_w).to(f64))

        # Density gradient through the lerp: d rgba / dt = (hi - lo) * N.
        dl_dt = _dot(g_rgba, (tf_hi - tf_lo) * n, 4)
        dl_dt = torch.where(active, dl_dt, 0.0)
        dl_ddensity = dl_dt * inv_window
        # Window scalars: dt/ddmin = inv*(t-1), dt/ddmax = -t*inv.
        if want_win:
            dmin_g = dmin_g + torch.sum(
                (dl_dt * (t - 1.0) * inv_window).to(f64))
            dmax_g = dmax_g + torch.sum((dl_dt * (-t) * inv_window).to(f64))

        # Voxel-grid scatter: the transpose of the 8-corner gather.
        for flat, valid, weight in corners:
            contrib = torch.where(valid, dl_ddensity * weight, 0.0)
            vol_g.index_add_(0, flat.reshape(-1), contrib.reshape(-1))

        tr = tr * (1.0 - a)
    return (vol_g.reshape(vol.shape) if want_vol else None,
            tf_g.float() if want_tf else None,
            dmin_g.float() if want_win else None,
            dmax_g.float() if want_win else None)


class MarchFunction(torch.autograd.Function):
    """A march whose forward and backward are given as functions over
    prepared rays (:func:`march_prepared` / :func:`march_backward_prepared`,
    or the CUDA kernels K1 / K2 of ``kernels/march.py``).

    ``apply(forward, backward, march_kw, vol, tf, origin, dirs, dmin, dmax,
    smin, smax)``.  The ray setup runs inside, so the window enters as
    ``dmin``/``dmax`` and its own dependence reaches their gradients, as in
    the JAX package.  Origin, dirs and the slicing bounds get ``None``
    (the JAX package returns zeros there).  The backward asks ``backward``
    (keyword ``needs``) only for the gradients of ``(vol, tf, window)``
    that autograd wants (``ctx.needs_input_grad``): a grid fit takes K2's
    grid-only instantiation.
    """

    @staticmethod
    def forward(ctx, forward, backward, march_kw, vol, tf, origin, dirs, dmin,
                dmax, smin, smax):
        vol, tf, origin, dirs = (x.detach() for x in (vol, tf, origin, dirs))
        dmin, dmax, smin, smax = (torch.as_tensor(x).detach()
                                  for x in (dmin, dmax, smin, smax))
        with span("vr.ray_setup"):
            pos0, hit, inv_window = prepare_rays(origin, dirs, dmin, dmax)
        out = forward(vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax,
                      **march_kw)
        ctx.backward_fn, ctx.march_kw = backward, march_kw
        ctx.save_for_backward(vol, tf, pos0, dirs, hit, dmin, dmax,
                              inv_window, smin, smax, out)
        return out

    @staticmethod
    def backward(ctx, g):
        (vol, tf, pos0, dirs, hit, dmin, dmax, inv_window, smin, smax,
         out) = ctx.saved_tensors
        need = ctx.needs_input_grad
        vol_g, tf_g, dmin_g, dmax_g = ctx.backward_fn(
            vol, tf, pos0, dirs, hit, dmin, inv_window, smin, smax, out,
            g.contiguous(), **ctx.march_kw,
            needs=(need[3], need[4], need[7] or need[8]))
        if dmin_g is not None:
            dmin_g, dmax_g = dmin_g.reshape(dmin.shape), \
                dmax_g.reshape(dmax.shape)
        grads = (None, None, None, vol_g, tf_g, None, None, dmin_g, dmax_g,
                 None, None)
        return tuple(x if n else None for x, n in zip(grads, need))


def make_fused_marcher(num_steps: int, step_size: float,
                       early_termination: bool, termination_eps: float,
                       own=None):
    """A differentiable marcher specialised to static march settings, with
    the signature of the JAX package's ``make_fused_marcher``:
    ``f(vol, tf_table, origin, dirs, density_min, density_max, slice_min,
    slice_max) -> rgba``.  Forward :func:`march_prepared`, backward the
    re-march :func:`march_backward_prepared`, on any device.  With ``own``
    (see :func:`march_prepared`) ``vol`` is a depth chunk and the output
    its partial image."""
    march_kw = dict(num_steps=num_steps, step_size=step_size,
                    early_termination=early_termination,
                    termination_eps=termination_eps, own=own)

    def march(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        return MarchFunction.apply(march_prepared, march_backward_prepared,
                                   march_kw, vol, tf, origin, dirs, dmin,
                                   dmax, smin, smax)

    return march
