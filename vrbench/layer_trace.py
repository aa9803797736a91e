"""A traced run that also reads the program's own spans and counters.

    VRBENCH_PATCH=vrbench.layer_trace:install python3 -m vrbench.run \\
        --workload fit-32x256 --seed <n> --seconds 20 --trace 1

The harness reads its per-layer metrics from outside the program: a
unit's span and the device trace sorted by kernel name.  The port opens
spans at its layer boundaries (``vr.*``) and counts inside K1, K2 and the
all-reduce (``utils.metrics.counting``).  :func:`install`, a hook of
``vrbench.run`` (``VRBENCH_PATCH``, in every rank), has a traced run read
them too, and changes nothing an untraced run does:

* each rank's summary of the traced segment gains the keys of
  ``metrics.spans.summarize``;
* after a fit's profiled fit, each rank runs one more whole fit from its
  first state with the profiler off, then another under
  ``utils.metrics.counting`` (the kernels' counted instantiations), and
  its summary gains ``counters``: ``read_counters`` of the counted fit,
  its ``steps``, and the host's ms a step of both fits;
* the result line reports the metrics of :data:`PER_LAYER` in their
  cells, ``idle_gaps_by_span`` (each rank's idle gaps by the program's
  span) and ``layers``: each rank's share of busy time under a span below
  ``vr.train_step``, its device ms a step by span, its entries of each
  kind by span and its counters, the traced, timed, counted and uncounted
  step, and K2's samples a step against the frozen count's.

A program without spans or counters (one that predates them) gives no
span but ``(outside the program)`` and no counters: those metrics are left
out of the result.

This hook is a stopgap: it stands in for three edits to the harness and
eight entries of ``BENCHMARK.json``, which only a ``benchmark`` change may
make.  That change merges ``spans.summarize`` into ``session.traced``'s
summary, runs :func:`counted_fit` at the end of ``traffic/fit.run``'s
traced segment, has ``run.result`` print ``idle_gaps_by_span`` and
``layers`` (:func:`with_layers`), enters :data:`PER_LAYER`, and deletes
this file.
"""

from __future__ import annotations

import contextlib
import time

import torch

from vrbench import metrics, work
from vrbench.metrics import spans

BOTH = ["fit-32x256", "fit-8x1080p-4chip"]
#: The per-layer metrics that read the program's spans and counters, as
#: ``BENCHMARK.json`` would enter them.
PER_LAYER = [
    {"name": name, "unit": unit, "better": better, "source": source,
     "layer": layer, "moves": "fit_step_ms", "workloads": cells}
    for name, unit, better, source, layer, cells in (
        ("ray_setup_ms.fit", "ms", "lower", "device_trace", "ray setup",
         BOTH),
        ("loss_ms.fit", "ms", "lower", "device_trace", "loss", BOTH),
        ("backward_rest_ms.fit", "ms", "lower", "device_trace", "autograd",
         BOTH),
        ("k2_atomics.fit", "M", "lower", "program_counter", "kernel K2",
         BOTH),
        ("k2_flushes.fit", "M", "lower", "program_counter", "kernel K2",
         BOTH),
        ("k2_lane_pct.fit", "%", "higher", "program_counter", "kernel K2",
         BOTH),
        ("k1_lane_pct.fit", "%", "higher", "program_counter", "kernel K1",
         BOTH),
        ("nccl_busbw_gbps.fit", "GB/s", "higher", "program_counter",
         "process group", BOTH[1:]))]

#: The fits made in this process (``Fit.__init__``), for the counted fit.
_fits: list = []


def install() -> None:
    from vrbench import run, session
    from vrbench.traffic import fit

    init = fit.Fit.__init__

    def __init__(self, cell):
        init(self, cell)
        _fits.append(self)

    fit.Fit.__init__ = __init__
    summarize = metrics.summarize
    metrics.summarize = lambda events: {**summarize(events),
                                        **spans.summarize(events)}
    session.traced = with_counters(session.traced)
    bench, result = run.benchmark, run.result
    run.benchmark = lambda: with_entries(bench())
    run.result = lambda cell, out, setup_s, b: with_layers(
        cell, out, result(cell, out, setup_s, b))


def with_counters(traced):
    """``session.traced`` whose summary, in a fit, also holds
    ``counters`` (:func:`counted_fit`)."""
    @contextlib.contextmanager
    def counted(device, out: list):
        with traced(device, out):
            yield
        if _fits:
            out[-1]["counters"] = counted_fit(_fits[-1], device)
    return counted


def counted_fit(fit, device):
    """One whole fit, then one under ``counting``, each from the fit's
    first state (``Fit.fit``, which ends by reading the losses):
    ``read_counters`` of the second, its ``steps`` and both fits' host ms a
    step; None for a program that cannot count."""
    from volumetric_renderer_torch.utils import metrics as program
    if not hasattr(program, "counting"):
        return None
    # the ranks end their summaries of the profiled fit at different times:
    # start both fits together, or the first holds the others' waits
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    t0 = time.perf_counter()
    fit.fit()
    t1 = time.perf_counter()
    with program.counting():
        fit.fit()
    t2 = time.perf_counter()
    found = program.read_counters(device)
    found.update(steps=fit.steps,
                 uncounted_step_ms=1e3 * (t1 - t0) / fit.steps,
                 counted_step_ms=1e3 * (t2 - t1) / fit.steps)
    return found


def with_entries(bench: dict) -> dict:
    """``bench`` with the entries of :data:`PER_LAYER` it lacks."""
    names = {e["name"] for e in bench["per_layer"]}
    bench["per_layer"] += [dict(e) for e in PER_LAYER
                           if e["name"] not in names]
    return bench


def with_layers(cell, out: dict, res: dict) -> dict:
    """The result line ``res`` of a traced run with ``idle_gaps_by_span``
    and ``layers`` before its checks, which stay last."""
    if not cell.trace:
        return res
    ranks = out["trace"]["ranks"]
    found = [r.get("counters") for r in ranks]
    layers = {
        "span_cover": [r.get("span_cover") for r in ranks],
        "span_ms": [{k: us / r["units"] / 1e3
                     for k, us in r.get("span_us", {}).items()}
                    for r in ranks if r["units"]],
        "kind_spans": [r.get("kind_spans") for r in ranks],
        "counters": found,
        "traced_step_ms": [r["window_us"] / r["units"] / 1e3
                           for r in ranks if r["units"]],
        "timed_step_ms": out["metrics"].get("fit_step_ms")}
    bound = out["trace"].get("work", {}).get("k2")
    k2 = spans.counts(out["trace"], "k2")
    if bound and "steps_per_fit" in cell.params:
        layers["frozen_samples_per_step"] = bound["ops"] / \
            work.OPS_PER_SAMPLE["k2"] / cell.params["steps_per_fit"]
    if k2:
        layers["k2_sampled_per_step"] = k2[0]["sampled"] / k2[1]
    checks = res.pop("checks")
    res["idle_gaps_by_span"] = [r.get("idle_gaps_by_span") for r in ranks]
    res["layers"] = layers
    res["checks"] = checks
    return res
