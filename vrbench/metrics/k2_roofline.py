"""K2's share of its roofline in the traced steps of a fit: the frozen
bound of the view set's samples (``vrbench.work``, one chip's worth of
time for the whole set) over the K2 device time of all ranks."""


def read(run):
    k2_us = sum(r["kind_us"]["k2"] for r in run["ranks"])
    bound = run["work"].get("k2")
    return 100.0 * 1e3 * bound["ms"] / k2_us if k2_us and bound else None
