"""Observability: throughput meters, phase timing, spans and counters.

The reference's only instrumentation is a 5-sample moving-average FPS
counter shown in the status bar (``src/application.cpp:102-122``,
``src/ui/main_window.cpp:96-103``).  Here that becomes:

* :class:`ThroughputMeter` — the same moving-average estimator, measuring
  rays/s (the north-star metric) instead of frames/s;
* :class:`PhaseTimers` — wall-clock spans per phase (render targets /
  train step), aggregated into a structured report;
* :func:`time_calls` and :func:`spread` — per-call times (CUDA events on a
  card) and their median with min, quartiles and max, for the harnesses;
* :func:`span` — a named range of a ``torch.profiler`` trace where one is
  being collected, and nothing otherwise.  The main path opens one at each
  layer boundary of a frame and a train step (``vr.train_step``,
  ``vr.ray_setup``, ``vr.k1``, ``vr.texture_fill``, ``vr.loss``,
  ``vr.backward``, ``vr.k2``, ``vr.fold``, ``vr.grad_sum``,
  ``vr.optimizer``, ``vr.clamp``), so that each device entry of a trace
  can be tied to the layer whose host code launched it;
* :func:`counting` and :func:`read_counters` — the work counted inside K1
  and K2 (their counted instantiations), the bytes handed to the
  all-reduce, and the launch counters the wrappers keep.

The meters read wall clocks.  Work queued on a CUDA device is inside a
timer's phase only once something in it waits for the device: the
optimize loop's ``float(loss)`` does, every step.  A span's device work is
found in the trace, by the profiler's link from each launch to its device
entry.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

log = logging.getLogger("volumetric_renderer_torch")


class ThroughputMeter:
    """Moving-average throughput, mirroring the reference FPS counter.

    The reference averages the last 5 frame intervals
    (``src/application.cpp:102-122``, ``FRAME_COUNT = 5``); this meter
    averages the last ``window`` (interval, items) samples and reports
    items/s — pass rays per frame to get rays/s, or 1 to get FPS.
    """

    def __init__(self, window: int = 5):
        self._samples = collections.deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self, items: float = 1.0) -> Optional[float]:
        """Record one completed unit of work; returns current items/s."""
        now = time.perf_counter()
        if self._last is not None:
            self._samples.append((now - self._last, items))
        self._last = now
        return self.rate

    @property
    def rate(self) -> Optional[float]:
        if not self._samples:
            return None
        dt = sum(s[0] for s in self._samples)
        n = sum(s[1] for s in self._samples)
        return n / dt if dt > 0 else None


def time_calls(fn, iters: int, device, warmup: int = 1) -> list:
    """Milliseconds of each of ``iters`` calls of ``fn``, after ``warmup``
    calls.  On a CUDA device each call is timed with CUDA events around it
    on the current stream (the host's time to queue it included where the
    device waits for the host), else with the host's clock."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return times


def spread(times) -> Dict[str, float]:
    """``{"median", "min", "q1", "q3", "max", "n"}`` of a list of times."""
    q1, med, q3 = (float(v) for v in np.percentile(times, [25, 50, 75]))
    return {"median": med, "min": float(min(times)), "q1": q1, "q3": q3,
            "max": float(max(times)), "n": len(times)}


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler is
    collecting, else one shared null context: with tracing off a span costs
    a flag test, and no dispatcher call or allocation.  The flag is the
    profiler's process-wide one, so a span opened on autograd's device
    thread (K2's wrapper runs there) is recorded too."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class PhaseTimers:
    """Named wall-clock accumulators for pipeline phases; each phase is
    also a :func:`span` of its name."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(1, self.counts[k])}
            for k in sorted(self.totals)
        }

    def log_report(self, extra: Optional[dict] = None) -> None:
        payload = {"phases": self.report()}
        if extra:
            payload.update(extra)
        log.info("%s", json.dumps(payload))


@contextlib.contextmanager
def counting() -> Iterator[None]:
    """Count the program's work in the block: every counter that
    :func:`read_counters` reads is reset on entry, and K1 and K2 launch
    their counted instantiations (``kernels.march.KernelCounts``) until the
    block ends.  Outside it they launch the uncounted ones."""
    from volumetric_renderer_torch.kernels import fold, march
    from volumetric_renderer_torch.parallel import render

    march.counts.reset()
    march.march_forward.launches = march.march_backward.launches = 0
    march.march_backward.grid_only_launches = 0
    march.march_forward.texture_fills = 0
    fold.fold_forward.launches = fold.fold_backward.launches = 0
    render.all_reduce_sum.bytes = 0
    march.counts.on = True
    try:
        yield
    finally:
        march.counts.on = False


def read_counters(device) -> dict:
    """The counts since :func:`counting` last reset them: ``k1`` and ``k2``,
    the kernels' counts on ``device`` (None where no counted launch ran
    there; reading them waits for the card), ``nccl_bytes``, the bytes this
    process handed to the all-reduce (``parallel.render.all_reduce_sum``),
    and the wrappers' launch counters: ``k1_launches``, ``k2_launches``,
    ``k2_grid_only_launches`` (of K2's, those of its grid-only
    instantiation), ``fold_launches`` and ``texture_fills``."""
    from volumetric_renderer_torch.kernels import fold, march
    from volumetric_renderer_torch.parallel import render

    return dict(march.counts.read(device),
                nccl_bytes=render.all_reduce_sum.bytes,
                k1_launches=march.march_forward.launches,
                k2_launches=march.march_backward.launches,
                k2_grid_only_launches=march.march_backward.grid_only_launches,
                fold_launches=(fold.fold_forward.launches
                               + fold.fold_backward.launches),
                texture_fills=march.march_forward.texture_fills)


def configure_logging(level: int = logging.INFO) -> None:
    """Structured single-line JSON-ish logging to stderr."""
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter(
        '{"ts": "%(asctime)s", "lvl": "%(levelname)s", '
        '"msg": %(message)s}'))
    log.addHandler(h)
    log.setLevel(level)
