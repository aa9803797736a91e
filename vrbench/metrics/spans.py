"""The device time of a traced segment by the program's own spans.

The port opens a ``record_function`` range named ``vr.<layer>`` at each
layer boundary of a frame and a train step (``utils.metrics.span`` of
``volumetric_renderer_torch``: ``vr.train_step``, ``vr.ray_setup``,
``vr.k1``, ``vr.loss``, ``vr.backward``, ``vr.k2``, ...).  Each device
entry of a unit (as :func:`vrbench.metrics.summarize` takes them) belongs
to the innermost ``vr.*`` span that holds the host time of its launch on
the launching thread: the launch is the runtime call with the entry's
correlation id, or else the operation it is linked to, as ``summarize``
finds it.  Autograd runs a CUDA backward on its device thread while the
units' thread waits in ``vr.backward``: K2 is launched there inside
``vr.k2``, and so is not counted in ``vr.backward``; an entry launched on
another thread outside every span of that thread belongs to the span
that holds its launch on the units' thread (the backward of the loss, in
``vr.backward``).  An entry launched in no ``vr.*`` span is
:data:`OUTSIDE`, as is every entry of a program that opens none.

:func:`summarize` gives the keys each rank's summary gains.
"""

from __future__ import annotations

import collections

from vrbench import metrics

PREFIX = "vr."
#: The whole step, whose own entries no layer below it took.
STEP = "vr.train_step"
OUTSIDE = "(outside the program)"


def _innermost(spans, times) -> list:
    """For each of ``times``, the name of the innermost span of ``spans``
    (``(start, end, name)`` by start, the longer first where two start
    together; nested or disjoint, as the ranges of one thread are) that
    holds it, or None."""
    out = [None] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def summarize(events, unit: str = metrics.UNIT) -> dict:
    """One rank's units by span: ``span_us`` and ``span_entries`` (device
    time and entries by the innermost ``vr.*`` span of their launch, or
    :data:`OUTSIDE`), ``kind_spans`` (the entries of each kind of
    ``metrics.KINDS`` by span), ``span_cover`` (the share of the units'
    busy time, the union of their entries, that spans below
    :data:`STEP` launched) and ``idle_gaps_by_span`` (the longest idle
    gaps of ``summarize``'s window, seconds, by the innermost ``vr.*`` span
    on the units' thread at each gap's middle)."""
    events = list(events)
    cpu = metrics._split(events)[0]
    unit_events = [e for e in cpu if e.name == unit]
    units = metrics._spans(cpu, lambda n: n == unit)
    adam = metrics._spans(cpu, lambda n: n.startswith("Optimizer.step"))
    runtime, ops, spans = {}, {}, collections.defaultdict(list)
    for e in cpu:
        thread = getattr(e, "thread", 0)
        key = (e.time_range.start, thread)
        (runtime if e.name.startswith("cu") else ops)[e.id] = key
        if e.name.startswith(PREFIX):
            spans[thread].append((e.time_range.start, e.time_range.end,
                                  e.name))
    for found in spans.values():
        found.sort(key=lambda x: (x[0], -x[1]))   # a parent before its child

    entries = []
    for e in metrics.device_entries(events):
        launch = runtime.get(e.id) or ops.get(
            getattr(e, "linked_correlation_id", 0))
        if launch is None or metrics._inside(units, launch[0]) < 0:
            continue
        kind = next((k for k, key in metrics.DEVICE_KINDS
                     if key in e.name.lower()), None)
        if kind is None:
            kind = "adam" if metrics._inside(adam, launch[0]) >= 0 \
                else "rest"
        entries.append((e, launch, kind))
    main = getattr(unit_events[0], "thread", 0) if unit_events else None
    labels = [None] * len(entries)
    by_thread = collections.defaultdict(list)
    for i, (_, (t, thread), _) in enumerate(entries):
        by_thread[thread].append(i)
    for thread, idx in by_thread.items():
        found = _innermost(spans[thread], [entries[i][1][0] for i in idx])
        for i, name in zip(idx, found):
            labels[i] = name
    rest = [i for i, name in enumerate(labels)
            if name is None and entries[i][1][1] != main]
    found = _innermost(spans[main], [entries[i][1][0] for i in rest])
    for i, name in zip(rest, found):
        labels[i] = name
    labels = [name or OUTSIDE for name in labels]

    span_us = collections.Counter()
    span_entries = collections.Counter()
    kind_spans = collections.defaultdict(collections.Counter)
    busy, covered = [], []
    for (e, _, kind), label in zip(entries, labels):
        a, b = e.time_range.start, e.time_range.end
        span_us[label] += b - a
        span_entries[label] += 1
        kind_spans[kind][label] += 1
        busy.append((a, b))
        if label not in (OUTSIDE, STEP):
            covered.append((a, b))
    union = metrics._union(busy)
    busy_us = sum(b - a for a, b in union)
    cover_us = sum(b - a for a, b in metrics._union(covered))
    return dict(
        span_us=dict(span_us), span_entries=dict(span_entries),
        kind_spans={k: dict(v) for k, v in kind_spans.items()},
        span_cover=cover_us / busy_us if busy_us else None,
        idle_gaps_by_span=_gaps_by_span(units, union, spans.get(main, [])))


def _gaps_by_span(units, union, spans) -> list:
    """The idle gaps ``summarize`` labels (between the busy intervals
    ``union`` in the window from the first unit's start), seconds, by the
    innermost span of ``spans`` holding each gap's middle."""
    if not units:
        return []
    start, end = units[0][0], max([units[-1][1]] + [b for _, b in union])
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(union, union[1:])]
    if union:
        gaps += [(start, union[0][0]), (union[-1][1], end)]
    gaps = [g for g in sorted(gaps, key=lambda g: g[0] - g[1])
            [:metrics.GAPS_LABELLED] if g[1] > g[0]]
    found = _innermost(spans, [(a + b) / 2 for a, b in gaps])
    labels = collections.Counter()
    for (a, b), name in zip(gaps, found):
        labels[name or OUTSIDE] += b - a
    return [[n, us / 1e6] for n, us in labels.most_common(metrics.TOP)]


def step_ms(run, name: str):
    """Device ms a unit of the entries launched innermost in span ``name``,
    on the rank that spends most; None where no rank has any."""
    per = [r["span_us"].get(name, 0.0) / r["units"] / 1e3
           for r in run["ranks"] if "span_us" in r and r["units"]]
    return max(per) if per and max(per) > 0 else None


def counts(run, kernel: str):
    """The counted fit's counts of ``kernel`` (``"k1"`` or ``"k2"``)
    summed over the ranks, and its steps: ``(counts, steps)``, or None
    where a rank has none (a program without counters, or the CPU)."""
    found = [r.get("counters") for r in run["ranks"]]
    if not found or any(c is None or not c.get(kernel) for c in found):
        return None
    total = collections.Counter()
    for c in found:
        total.update(c[kernel])
    return dict(total), found[0]["steps"]
