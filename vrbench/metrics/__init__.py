"""The reading of a ``torch.profiler`` trace, and the per-layer metrics.

:func:`summarize` reduces the events of one rank's traced segment to what
the metrics read.  A unit is a frame or a training step: the host span of
a ``record_function`` range named :data:`UNIT`.  Each device entry (a
kernel, copy or fill) belongs to the unit during whose span the host
launched it, by the profiler's link from the launching runtime call
(``cudaLaunchKernel`` and the like) to the entry, which share a
correlation id; without one, by the link to the PyTorch operation that
launched it.  No wait for the card marks a unit's end.

Entries are sorted into kinds by name (:data:`DEVICE_KINDS`); an entry of
no kind that the host launched inside an ``Optimizer.step`` range is
Adam's, any other "rest".  This is ``apps/time_kernels.py``'s
``step_breakdown`` of the renderer, kept here with the benchmark.

Each per-layer metric is read by a module with ``read(run) -> float |
None``: ``metrics/<name>.py``, or where there is none, the module of the
name's first part, ``metrics/<stem>.py`` for ``<stem>.<suffix>``.  So
one reader serves a quantity split by the end-to-end metric it moves
(``idle_pct.fit``, ``idle_pct.orbit``: ``idle_pct.py``).  ``run`` holds
``ranks`` (one summary per rank, rank 0 first), ``work`` (the frozen bounds of ``vrbench.work`` over the
traced units) and what the traffic recorded on the host
(``host_issue_ms``).  A reader that finds nothing to read returns None,
and the metric is left out of the result.
"""

from __future__ import annotations

import bisect
import collections
import importlib.util
import os

#: The name of a unit's host span.
UNIT = "vrbench.unit"
#: Device entries by kind, matched in order on the lowered name.
DEVICE_KINDS = (("k1", "march_fwd_kernel"), ("k2", "march_bwd_kernel"),
                ("fold", "fold_fwd_kernel"), ("fold", "fold_bwd_kernel"),
                ("nccl", "nccl"), ("copies", "memcpy"), ("copies", "memset"))
KINDS = ("k1", "k2", "fold", "nccl", "adam", "copies", "rest")
#: Entries listed in a breakdown, and idle gaps labelled.
TOP, GAPS_LABELLED = 10, 200
#: Candidates looked at, back from a gap, for the host operation that
#: was running in it.
LOOK_BACK = 4000

HERE = os.path.dirname(os.path.abspath(__file__))


def _split(events) -> tuple:
    """``(host events, device events)``."""
    host, device = [], []
    for e in events:
        (device if e.device_type.name == "CUDA" else host).append(e)
    return host, device


def device_entries(events) -> list:
    """The device activity among ``events``: kernels, copies and fills,
    not the spans that a ``record_function`` range also leaves on the
    device's timeline (user annotations, named as on the host)."""
    host, device = _split(events)
    names = {e.name for e in host}
    return [e for e in device if not getattr(e, "is_user_annotation", False)
            and e.name not in names]


def _spans(host, pred) -> list:
    return sorted((e.time_range.start, e.time_range.end) for e in host
                  if pred(e.name))


def _inside(spans, t) -> int:
    """The index of the span of ``spans`` (sorted, disjoint) holding
    ``t``, or -1."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i if i >= 0 and spans[i][0] <= t <= spans[i][1] else -1


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, unit: str = UNIT) -> dict:
    """One rank's traced units: ``units``, ``window_us`` (from the first
    unit's host start to the end of the last of its device entries or host
    spans), ``busy_us`` (the union of the units' device entries),
    ``kind_us`` (device time by kind), ``entries`` and ``launches``
    (device entries in all and by kind), ``unattributed`` (entries with no link to a launch),
    ``device_ops`` (the entries that took most time, by name, seconds) and
    ``idle_gaps`` (idle time in the window by the host operation that was
    running, seconds, of the longest gaps); all sums over the units."""
    events = list(events)
    cpu = _split(events)[0]
    units = _spans(cpu, lambda n: n == unit)
    adam = _spans(cpu, lambda n: n.startswith("Optimizer.step"))
    runtime = {e.id: e.time_range.start for e in cpu
               if e.name.startswith("cu")}
    ops = {e.id: e.time_range.start for e in cpu
           if not e.name.startswith("cu")}
    kind_us = dict.fromkeys(KINDS, 0.0)
    counts = collections.Counter()
    by_name = collections.Counter()
    busy = []
    for e in device_entries(events):
        launch = runtime.get(e.id)
        if launch is None:
            launch = ops.get(getattr(e, "linked_correlation_id", 0))
        if launch is None:
            counts["unattributed"] += 1
            continue
        if _inside(units, launch) < 0:
            continue
        a, b = e.time_range.start, e.time_range.end
        name = e.name.lower()
        kind = next((k for k, key in DEVICE_KINDS if key in name), None)
        if kind is None:
            kind = "adam" if _inside(adam, launch) >= 0 else "rest"
        kind_us[kind] += b - a
        counts["entries"] += 1
        counts[kind] += 1
        by_name[e.name] += b - a
        busy.append((a, b))
    union = _union(busy)
    start = units[0][0] if units else 0.0
    end = max(([units[-1][1]] if units else [0.0])
              + [b for _, b in union])
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(union, union[1:])]
    if union:
        gaps += [(start, union[0][0]), (union[-1][1], end)]
    return dict(
        units=len(units), window_us=end - start,
        busy_us=sum(b - a for a, b in union), kind_us=kind_us,
        entries=counts["entries"], launches={k: counts[k] for k in KINDS},
        unattributed=counts["unattributed"],
        device_ops=[[n, us / 1e6] for n, us in by_name.most_common(TOP)],
        idle_gaps=_label_gaps(cpu, gaps))


def _label_gaps(cpu, gaps) -> list:
    """Idle seconds by the host operation running at the middle of each of
    the longest gaps: the shortest host span holding that moment."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if not e.name.startswith("cu"))
    starts = [s[0] for s in spans]
    labels = collections.Counter()
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_LABELLED]:
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for s, t, name in reversed(spans[max(0, i - LOOK_BACK):i]):
            if t >= mid and (best is None or t - s < best[0]):
                best = (t - s, name)
        labels[best[1] if best else "(no host operation)"] += b - a
    return [[n, us / 1e6] for n, us in labels.most_common(TOP)]


def reader_path(name: str) -> str:
    """``metrics/<name>.py`` where it exists, else the module of the
    name's part before its first dot."""
    path = os.path.join(HERE, name + ".py")
    if os.path.exists(path):
        return path
    return os.path.join(HERE, name.split(".")[0] + ".py")


def reader(name: str):
    """The ``read`` function of the metric ``name``'s module."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"vrbench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
