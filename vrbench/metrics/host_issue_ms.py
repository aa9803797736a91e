"""Host time to queue a frame: the median, over the window's frames, of the
host clock around the renderer's ``render`` call, before any wait for the
card (the API, the ray setup and K1's wrapper)."""

import statistics


def read(run):
    times = run.get("host_issue_ms")
    return statistics.median(times) if times else None
