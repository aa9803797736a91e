"""Differentiable 1D transfer-function texture lookup.

Replicates the reference's ``sampler1D`` fetch semantics
(``src/rendering/offscreen_pass.cpp:1125-1150``): linear filtering at texel
centers with CLAMP_TO_EDGE addressing.  The table is a dense float
``(N, 4)`` RGBA tensor; the lookup is linear interpolation, so gradients
flow from pixels to table entries (BASELINE config 3).
"""

from __future__ import annotations

import torch


def sample_tf(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Sample the TF table at normalized density ``t`` (any shape).

    ``table``: ``(N, 4)`` float RGBA.  Returns ``t.shape + (4,)``.

    GPU linear-sampler semantics: texel i covers ``[i/N, (i+1)/N)`` with its
    center at ``(i+0.5)/N``; a fetch at coordinate u interpolates the two
    nearest texel centers, with out-of-range indices clamped to the edge
    (CLAMP_TO_EDGE).  Out-of-[0,1] coordinates (densities outside the density
    window) therefore return the edge color, like the reference.
    """
    n = table.shape[0]
    x = t * n - 0.5
    i0 = torch.floor(x)
    w = (x - i0)[..., None]
    i0 = i0.long()
    lo = torch.clamp(i0, 0, n - 1)
    hi = torch.clamp(i0 + 1, 0, n - 1)
    return table[lo] * (1.0 - w) + table[hi] * w
