"""Sanitizer-equivalent layer (SURVEY §5).

The reference's only runtime checking is the Vulkan validation layer in
debug builds (``src/rendering/vulkan_context.cpp:20-28``) plus structural
race-freedom (single thread, ``wait_till_idle`` before resource swaps,
``offscreen_pass.cpp:242,260,282``).  The equivalents here:

* :func:`checked_render` — a render through the plain PyTorch marchers with
  every value the march makes tested for NaN and Inf (``torch.isfinite``):
  the ray setup and, at every step, the position, the sampled density, the
  normalised density, the TF sample, the colour sum and the transmittance.
  The JAX package traps the same values with ``checkify.float_checks``;
  torch has no checkify, so the plain loops take a ``check`` hook
  (``core.fused.march_prepared``, ``core.marcher.march_rays``).  The input
  grid itself is not tested: a NaN voxel no ray samples is legal.  One that
  a ray samples is caught even where the slicing window then masks it, as
  checkify catches the product that carries it.
* Determinism in place of a race detector: the forward renderer is a pure
  function of its inputs, so two runs must be *bitwise* identical —
  asserted by :func:`assert_deterministic`.  The backward kernel (K2) sums
  with atomics and is not bitwise repeatable; use this on forwards only.
"""

from __future__ import annotations

import torch

from volumetric_renderer_torch.core.fused import march_prepared
from volumetric_renderer_torch.core.marcher import (
    frame_inputs,
    march_rays,
    prepare_rays,
)
from volumetric_renderer_torch.render.api import select_method


class CheckError:
    """The outcome of :func:`checked_render`: :meth:`get` gives the message
    of the first non-finite value (``None`` if there was none), and
    :meth:`throw` raises ``FloatingPointError`` with it."""

    def __init__(self, message: str | None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


class _FiniteChecks:
    """A ``check`` hook that records, per value, whether it held a NaN or an
    Inf, on the value's device (no sync per step); :meth:`first` reads them
    once."""

    def __init__(self):
        self.labels, self.flags = [], []

    def __call__(self, stage, k, x):
        self.labels.append((stage, k))
        self.flags.append(~torch.isfinite(x).all())

    def first(self) -> CheckError:
        if not self.flags:
            return CheckError(None)
        bad = torch.stack(self.flags).nonzero()
        if bad.numel() == 0:
            return CheckError(None)
        stage, k = self.labels[int(bad[0, 0])]
        where = "in the ray setup" if k < 0 else f"at march step {k}"
        return CheckError(f"non-finite value (nan or inf) generated: "
                          f"{stage} {where}")


def checked_render(vol, tf_table, camera, settings, *, density_min=None,
                   density_max=None, slice_min=None, slice_max=None,
                   method: str = "fused"):
    """Render with NaN/Inf checks enabled.

    Returns ``(err, rgba)``; call ``err.throw()`` to raise on the first
    non-finite value produced anywhere in the march.  The plain PyTorch
    methods only (``"fused"``, ``"oracle"``, or ``"auto"`` on a CPU
    volume): a CUDA kernel's body cannot be instrumented, so
    ``method="kernel"``, and ``"auto"`` on a CUDA volume, raise
    ``ValueError``; the parity tests hold the kernel to the plain version
    instead.  ``rgba`` equals ``render(method=...)`` bit for bit.
    """
    resolved = select_method(method, vol)
    if resolved == "kernel":
        raise ValueError("checked_render instruments the plain PyTorch paths "
                         "only (oracle/fused), not the CUDA kernel")
    tf_table = torch.as_tensor(tf_table, device=vol.device)
    origin, dirs, dmin, dmax, smin, smax = frame_inputs(
        vol, camera, settings, density_min, density_max, slice_min, slice_max)
    march = dict(num_steps=settings.num_steps, step_size=settings.step_size,
                 early_termination=settings.early_termination,
                 termination_eps=settings.termination_eps)
    checks = _FiniteChecks()
    checks("rays", -1, dirs)
    with torch.no_grad():
        if resolved == "oracle":
            rgba = march_rays(vol, tf_table, origin, dirs, density_min=dmin,
                              density_max=dmax, slice_min=smin,
                              slice_max=smax, check=checks, **march)
        else:
            pos0, hit, inv_window = prepare_rays(origin, dirs, dmin, dmax)
            checks("entry", -1, pos0)
            checks("window", -1, inv_window)
            rgba = march_prepared(vol, tf_table, pos0, dirs, hit, dmin,
                                  inv_window, smin, smax, check=checks,
                                  **march)
    return checks.first(), rgba


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, dict):
        return [leaf for key in sorted(x) for leaf in _leaves(x[key])]
    return [torch.as_tensor(x)]


def assert_deterministic(fn, *args, runs: int = 2):
    """Run ``fn(*args)`` ``runs`` times and assert bitwise-equal outputs.

    The replacement for a race detector: any nondeterminism would indicate
    an unsynchronized reduction order or uninitialized memory.  Outputs may
    be tensors or lists, tuples and dicts of them.  Positions that are NaN
    in both runs count as equal.  Returns the first output.
    """
    first = fn(*args)
    want = [leaf.detach().clone() for leaf in _leaves(first)]
    for _ in range(runs - 1):
        got = _leaves(fn(*args))
        if len(got) != len(want) or any(
                a.shape != b.shape or bool(((a != b) & ~(
                    torch.isnan(a) & torch.isnan(b))).any())
                for a, b in zip(want, got)):
            raise AssertionError("nondeterministic output across runs")
    return first
