"""The comparison that decides ``correct``.

Each cell's file (``workloads/<name>.json``) gives the limit of each number
it compares, under ``limits``; ``PERF.md`` gives the readings each limit
was set from.  A number that is not finite fails.

* A frame (:func:`frame_numbers`): ``mae``, the mean over its pixels and
  channels of the distance from the reference's frame, and
  ``median_gap``, the median over the pixels the reference covers of the
  largest channel's distance.  The renderer's float32 camera puts a ray's
  direction up to ~2e-6 from the reference's float64 one, which moves a
  sample at the skull's edge and so most covered pixels by ~1e-4; early
  termination lets a ray whose T lands within rounding of eps take one
  sample more or fewer, which moves that pixel by up to eps.  A mean and
  a median take both in without letting them hide a wrong frame, while a
  largest gap would read alike for a sound frame and a wrong one.
* A fit (:func:`fit_numbers`), over its first three steps:
  ``loss_rel``, the largest of the three losses' gaps from the
  reference's, over the reference's; ``grad1_rel``, the gap between the
  norm of the first gradient as the optimizer got it and the norm of the
  reference's, over the latter; ``change3_rel``, the same of the change
  of the grid after the three steps.
"""

from __future__ import annotations

import math
import sys

import torch


def frame_numbers(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The numbers of one frame, ``got`` against ``want`` (both RGBA)."""
    gap = (got.reshape(-1, 4).double() - want.reshape(-1, 4).double()).abs()
    covered = want.reshape(-1, 4)[:, 3] > 0
    return {"mae": float(gap.mean()),
            "median_gap": float(gap.amax(-1)[covered].median())}


def _rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == 0 else math.inf)


def fit_numbers(got: dict, want: dict) -> dict:
    """The numbers of a fit's first three steps; ``got`` and ``want`` each
    hold ``losses`` (three floats), ``grad1_norm`` and ``change3_norm``."""
    return {
        "loss_rel": max(_rel_gap(a, b) for a, b in zip(got["losses"],
                                                        want["losses"])),
        "grad1_rel": _rel_gap(got["grad1_norm"], want["grad1_norm"]),
        "change3_rel": _rel_gap(got["change3_norm"], want["change3_norm"]),
    }


def judge(numbers: list, limits: dict) -> tuple:
    """``(correct, failed, checks)`` of a list of number dicts against
    ``limits``: ``checks`` maps each compared number to its worst value and
    its limit; ``failed`` counts the dicts with some number over its limit
    or not finite."""
    failed, worst = 0, {}
    for nums in numbers:
        bad = False
        for key, limit in limits.items():
            value = nums[key]
            if not (math.isfinite(value) and value <= limit):
                bad = True
            if key not in worst or not value <= worst[key]:
                worst[key] = value
        failed += bad
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits
              if k in worst}
    return bool(numbers) and failed == 0, failed, checks


def report(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for key, c in checks.items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
