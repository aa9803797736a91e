"""Grid inversion: whole fits of the renderer's pixel-sharded train step.

A fit recovers the density grid from posed views of the phantom (BASELINE
configs 4 and 5, as ``apps/optimize.py invert`` runs them): targets
rendered by the renderer from the phantom, then ``steps`` steps of
``parallel.train.make_train_step`` (pixels sharded over the ranks in
``row_layout``, the grid replicated, one all-reduce of its gradient a
step) with ``torch.optim.Adam`` from a constant grid.  Every fit starts
from the same state.  A step's loss stays on the card; the losses of a
fit are read at its end.

Set-up builds the train step and its state once, drives them through the
first steps with the window's own call and inputs, and keeps what the
check compares: the three losses, the norm of the first gradient as Adam
got it (its first moment after one step, over ``1 - beta1``) and the norm
of the grid's change after three steps.

End-to-end: ``fit_step_ms``, the window's time over the steps it
completed.  The window is made of whole fits: it ends with the last fit
that ends within ``--seconds``.  ``correct``: the three steps against
the reference's (``checks.fit_numbers``).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from vrbench import checks, inputs, session, work
from vrbench.reference import adam as ref_adam
from vrbench.reference import march as ref
from vrbench.traffic.orbit import settings_of

BETA1 = 0.9


def views(cell) -> list:
    p = cell.params
    return [(float(y), p["pitch_deg"], p["radius"])
            for y in inputs.ring_yaws(p["views"])]


class Fit:
    """The renderer's side of a fit: inputs, targets, train step, state."""

    def __init__(self, cell):
        from volumetric_renderer_torch.parallel.render import (
            make_sharded_renderer,
        )
        from volumetric_renderer_torch.parallel.train import (
            init_state,
            make_train_step,
            stack_cameras,
        )
        from volumetric_renderer_torch.scene.camera import OrbitCamera

        p, dev = cell.params, cell.device
        self.cell, self.steps = cell, p["steps_per_fit"]
        self.m = ref.March.of(cell.config, False)
        settings = settings_of(cell, self.m)
        self.vol = inputs.make_volume(cell.config["volume"], cell.seed, dev)
        self.tf = inputs.tf_table(cell.config["tf_texels"], p["tf_alpha"],
                                  dev)
        cams = stack_cameras([OrbitCamera.from_angles(
            yaw_deg=y, pitch_deg=pitch, radius=r)
            for y, pitch, r in views(cell)]).to(dev)
        dmin, dmax = self.vol.min(), self.vol.max()
        self.fixed = dict(vol=self.vol, tf=self.tf, dmin=dmin, dmax=dmax,
                          smin=torch.zeros(3, device=dev),
                          smax=torch.ones(3, device=dev))
        render_fn = make_sharded_renderer(cell.group, settings, "auto",
                                          row_layout=p["row_layout"])
        with torch.no_grad():
            self.targets = render_fn(self.vol, self.tf, cams, dmin, dmax,
                                     self.fixed["smin"], self.fixed["smax"])
        self.cams = cams
        self.step_fn = make_train_step(
            settings, optimize_vol=True, optimize_tf=False, method="auto",
            group=cell.group, row_layout=p["row_layout"])
        self.state = init_state(
            {"vol": torch.full(self.vol.shape, p["init"], device=dev)},
            lambda params: torch.optim.Adam(params, lr=p["lr"]))
        self.grid = self.state.params["vol"]

    def step(self):
        self.state, loss = self.step_fn(self.state, self.fixed, self.cams,
                                        self.targets)
        return loss

    def reset(self) -> None:
        """The state a fit starts from: the constant grid, no moments."""
        with torch.no_grad():
            self.grid.fill_(self.cell.params["init"])
        self.state.optimizer.state.clear()

    def first_steps(self) -> dict:
        """The first three steps of a fit, as the check compares them."""
        self.reset()
        losses = [self.step()]
        moment = self.state.optimizer.state[self.grid]["exp_avg"]
        grad1 = torch.linalg.vector_norm(moment.double() / (1 - BETA1))
        losses += [self.step(), self.step()]
        change = torch.linalg.vector_norm(
            (self.grid.detach() - self.cell.params["init"]).double())
        return {"losses": [float(x) for x in losses],
                "grad1_norm": float(grad1), "change3_norm": float(change)}

    def fit(self):
        """One whole fit; its losses, read at its end."""
        self.reset()
        losses = torch.stack([self.step() for _ in range(self.steps)])
        return losses.cpu()


def run(cell) -> dict:
    p, dev = cell.params, cell.device
    fit = Fit(cell)
    first = fit.first_steps()
    for _ in range(p["warmup_steps"]):
        fit.step()
    session.sync(dev)
    if cell.world > 1:
        dist.barrier()
    window_start = time.perf_counter()
    fits, failed, last_end = 0, 0, window_start
    while True:
        t_fit = time.perf_counter()
        losses = fit.fit()
        now = time.perf_counter()
        within = now - window_start <= cell.seconds
        if within or fits == 0:
            fits += 1
            last_end = now
            failed += int((~torch.isfinite(losses)).sum())
        go_on = torch.tensor(
            [within and 2 * now - t_fit - window_start <= cell.seconds],
            device=dev)
        if cell.world > 1:
            dist.broadcast(go_on, 0)
        if not bool(go_on):
            break
    steps = fits * fit.steps
    out = {"window_start": window_start, "attempted": steps,
           "metrics": {"fit_step_ms": 1e3 * (last_end - window_start)
                       / steps}}
    if cell.trace:
        summaries = []
        fit.reset()
        with session.traced(dev, summaries):
            losses = []
            for _ in range(fit.steps):
                with session.unit():
                    losses.append(fit.step())
            torch.stack(losses).cpu()
        summaries = session.gather(cell, summaries[0])
    out["memory_peak_bytes"] = max(session.gather(cell,
                                                  session.memory_peak(dev)))
    vol, tf = fit.vol, fit.tf
    del fit, losses
    session.free(dev)

    want = reference(cell, vol, tf)
    out["correct"], bad, out["checks"] = checks.judge(
        [checks.fit_numbers(first, want)], cell.spec["limits"])
    out["failed"] = failed + bad
    if cell.trace and cell.rank == 0:
        out["trace"] = {"ranks": summaries,
                        "work": fit_work(cell, vol, tf, len(summaries))}
    return out


def rank_rays(cell, device):
    """This rank's share of the view set's rays, in view, row, column
    order: the reference splits them in equal runs."""
    p = cell.params
    rays = ref.view_rays(views(cell), p["height"], p["width"],
                         cell.config["camera"], device)
    n = rays[0].shape[0]
    lo, hi = cell.rank * n // cell.world, (cell.rank + 1) * n // cell.world
    return tuple(x[lo:hi] for x in rays)


def reference(cell, vol, tf, store=None, render_store=None) -> dict:
    """The reference's first three steps of a fit, as
    :meth:`Fit.first_steps` gives them: targets by the reference march,
    the loss and its gradient by autograd, Adam written out.  On several
    ranks each takes its share of the rays and the losses and gradients
    are summed.  ``store`` computes the fit's steps in that precision and
    ``render_store`` its targets (the control)."""
    p = cell.params
    m = ref.March.of(cell.config, False)
    rays = rank_rays(cell, vol.device)
    dmin, dmax = vol.min(), vol.max()
    targets = ref.render(vol, tf, rays, dmin, dmax, m, render_store)
    norm = float(p["views"] * p["height"] * p["width"] * 4)
    grid = torch.full_like(vol, p["init"])
    opt = ref_adam.Adam(p["lr"])
    losses, grad1 = [], None
    for _ in range(3):
        loss, grad = ref.loss_and_grad(grid, tf, rays, targets, dmin, dmax,
                                       m, norm, store)
        if cell.world > 1:
            dist.all_reduce(loss)
            dist.all_reduce(grad)
        losses.append(float(loss))
        if grad1 is None:
            grad1 = float(torch.linalg.vector_norm(grad.double()))
        opt.step(grid, grad, clamp_min=0.0)
    change = torch.linalg.vector_norm((grid - p["init"]).double())
    return {"losses": losses, "grad1_norm": grad1,
            "change3_norm": float(change)}


def fit_work(cell, vol, tf, ranks: int) -> dict:
    """K1's and K2's bounds over the traced fit: the view set's samples
    (without early termination, the geometry's alone) times the steps;
    each rank's launch reads the grid."""
    p = cell.params
    m = ref.March.of(cell.config, False)
    rays = ref.view_rays(views(cell), p["height"], p["width"],
                         cell.config["camera"], vol.device)
    samples = work.sampled_steps(vol, tf, rays, vol.min(), vol.max(), m)
    n = p["steps_per_fit"]
    return {k: work.bound(k, samples * n, rays[0].shape[0] * n, vol.numel(),
                          tf.numel(), launches=ranks * n)
            for k in ("k1", "k2")}
