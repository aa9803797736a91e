"""Hooks that redirect or break a run, for the tests and for the readings
that the limits of the correctness check were set from.

A run calls each hook named in ``VRBENCH_PATCH`` (``module:function``,
comma-separated) before anything else, in every rank:

* ``cpu``: skip the look for a card and run on the CPU (the renderer's
  plain versions of its kernels, ``gloo`` between ranks);
* ``control``: the control: the reference, in bfloat16 (its grid, TF and
  every fetched value rounded to it), in the renderer's place;
* ``altered``: an orbit whose every frame shows the next frame's camera;
* ``half_batch``: a fit whose steps see only the first half of the views,
  the loss the mean over those;
* ``no_exchange``: a fit whose ranks never sum their gradients;
* ``unchanged``: a fit whose steps leave the grid as it was;
* ``jax_loaded``: a run in which JAX counts as loaded;
* ``jax_on_rank_1``: a run whose rank 1 alone loads JAX, after its fit;
* ``readings``: a fit cell's readings of the sound program, the control
  and each fault, on one seed in one run (no measurement).

The readings the limits of ``workloads/<name>.json`` were set from::

    VRBENCH_PATCH=vrbench.tests.faults:readings python3 -m vrbench.run \
        --workload fit-8x1080p-4chip --seed 1 --seconds 0
    VRBENCH_PATCH=vrbench.tests.faults:control python3 -m vrbench.run \
        --workload fit-32x256 --seed 1 --seconds 1
"""

from __future__ import annotations

import torch

import vrbench.run
from vrbench.traffic import fit, orbit


def cpu():
    vrbench.run.require_cuda = lambda chips: "cpu"


def control():
    def program(cell, vol, tf, yaws, m):
        p = cell.params
        return lambda i: orbit.frame_reference(
            cell, vol, tf, float(yaws[i]), m, torch.bfloat16).view(
                p["height"], p["width"], 4)

    orbit.program = program
    fit.Fit.first_steps = lambda self: fit.reference(
        self.cell, self.vol, self.tf, torch.bfloat16, torch.bfloat16)


def altered():
    sound = orbit.program

    def program(cell, vol, tf, yaws, m):
        render = sound(cell, vol, tf, yaws, m)
        return lambda i: render((i + 1) % len(yaws))

    orbit.program = program


def half_batch():
    init = fit.Fit.__init__

    def __init__(self, cell):
        init(self, cell)
        half = cell.params["views"] // 2
        self.cams = type(self.cams)(*(getattr(self.cams, f)[:half] for f in
                                      ("center", "orientation", "radius")))
        self.targets = self.targets[:half]

    fit.Fit.__init__ = __init__


def no_exchange():
    from volumetric_renderer_torch.parallel import train
    train.all_reduce_grads = lambda tensors, group=None: None


def unchanged():
    sound = fit.Fit.step

    def step(self):
        before = self.grid.detach().clone()
        loss = sound(self)
        with torch.no_grad():
            self.grid.copy_(before)
        return loss

    fit.Fit.step = step


def jax_loaded():
    import sys
    import types
    sys.modules["jax"] = types.ModuleType("jax")


def jax_on_rank_1():
    import sys
    import types
    sound = fit.run

    def run(cell):
        out = sound(cell)
        if cell.rank == 1:
            sys.modules["jax"] = types.ModuleType("jax")
        return out

    fit.run = run


def readings():
    """A fit cell's readings in one run, one seed: the numbers of the
    sound program, of the control and of each fault the cell can have,
    as one JSON line on standard error (rank 0); the run's result is not
    a measurement.  The readings the check's limits were set from."""
    import json
    import sys

    from volumetric_renderer_torch.parallel import train

    from vrbench import checks

    def run(cell):
        f = fit.Fit(cell)
        want = fit.reference(cell, f.vol, f.tf)
        rows = {"program": f.first_steps()}
        rows["control"] = fit.reference(cell, f.vol, f.tf, torch.bfloat16,
                                        torch.bfloat16)
        cams, targets, half = f.cams, f.targets, cell.params["views"] // 2
        f.cams = type(cams)(*(getattr(cams, k)[:half] for k in
                              ("center", "orientation", "radius")))
        f.targets = targets[:half]
        rows["half_batch"] = f.first_steps()
        f.cams, f.targets = cams, targets
        if cell.world > 1:
            sound = train.all_reduce_grads
            train.all_reduce_grads = lambda tensors, group=None: None
            rows["no_exchange"] = f.first_steps()
            train.all_reduce_grads = sound
        numbers = {k: checks.fit_numbers(v, want) for k, v in rows.items()}
        if cell.rank == 0:
            print(json.dumps({"seed": cell.seed, "readings": numbers}),
                  file=sys.stderr, flush=True)
        return {"window_start": 0.0, "metrics": {"fit_step_ms": 0.0},
                "attempted": 0, "failed": 0, "correct": False,
                "checks": {}, "memory_peak_bytes": 0}

    fit.run = run
