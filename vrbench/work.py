"""The frozen count of the work a march needs, and the least time a card
could take for it.

A kernel's roofline share is this bound over its device time.  The bound
is the larger of the operations over the card's float32 peak and the
bytes over its memory rate (NVIDIA H100 SXM data sheet, at its 700 W
limit; the run prints the card's own limit beside it).

* Operations: the samples these inputs need, times the operations of one
  sample.  A sample is needed inside the cube and the slicing window, on
  a ray that enters the cube and, with early termination, while T >
  eps.  K1 (the forward march) takes 98 operations a sample: position 7,
  cube and window tests 12, texel coordinate and weights 15, corner
  weights 19, trilinear 16, window 2, TF lerp 16, composite and the
  termination test 11.  K2 (the re-march backward) recomputes the sample
  (87) and adds 99, 186 in all: opacity clamp, g.c, prefix and suffix,
  dL/dc, dL/da, TF runs, dL/dt, window gradients, corner weights and
  scatter, T and the termination test.  Each multiply and add counts once,
  as the kernels are built without contracting them (``-fmad=false``).
* Bytes: each input read once and each output written once, whatever a
  kernel reads again: the grid, the TF table and the window once a launch;
  a ray's entry point and direction (24 B), its hit flag (1 B) and its
  RGBA (16 B); K2 also reads the RGBA's cotangent (16 B a ray) and writes
  the grid's gradient and the TF's (float64) and the window's.

The counts depend on the inputs alone, never on the kernel that computes
them.  Nothing here imports the renderer.
"""

from __future__ import annotations

import numpy as np
import torch

from vrbench.reference import march as ref

PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_SAMPLE = {"k1": 98, "k2": 186}


def sampled_steps(vol, tf, rays, dmin, dmax, m: ref.March) -> int:
    """The samples that composite on the rays ``(pos0, dirs, hit)``."""
    counts = torch.zeros((), dtype=torch.int64, device=rays[0].device)
    if m.early_termination:
        ref.render(vol, tf, rays, dmin, dmax, m, counts=counts)
        return int(counts)
    # without early termination the count is the geometry's alone
    offsets = np.arange(m.num_steps, dtype=np.float32) * np.float32(
        m.step_size)
    for i in range(0, rays[0].shape[0], ref.BLOCK):
        pos0, dirs, hit = (x[i:i + ref.BLOCK] for x in rays)
        for k in range(m.num_steps):
            pos = pos0 + float(offsets[k]) * dirs
            counts += (((pos > 0.0) & (pos < 1.0)).all(-1) & hit).sum()
    return int(counts)


def bound(kernel: str, samples: int, rays: int, vol_numel: int,
          tf_numel: int, launches: int = 1) -> dict:
    """The bound of ``kernel`` (``"k1"`` or ``"k2"``) over ``samples``
    samples of ``rays`` rays in ``launches`` launches, each of which reads
    a grid of ``vol_numel`` voxels and a TF of ``tf_numel`` values:
    ``{"ms", "by", "ops", "bytes"}``."""
    per_launch = 4 * (vol_numel + tf_numel) + 32
    per_ray = 24 + 1 + 16
    if kernel == "k2":
        per_launch += 4 * vol_numel + 8 * tf_numel + 16
        per_ray += 16
    nbytes = launches * per_launch + rays * per_ray
    ops = OPS_PER_SAMPLE[kernel] * samples
    t_ops, t_bytes = 1e3 * ops / PEAK_F32_OPS, 1e3 * nbytes / PEAK_BYTES
    return {"ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}
