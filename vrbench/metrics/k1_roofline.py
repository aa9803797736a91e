"""K1's share of its roofline in the traced units: the frozen bound of
the samples they need (``vrbench.work``: a fit's view set times its
steps, or each traced frame; one chip's worth of time for the whole) over
the K1 device time of all ranks."""


def read(run):
    k1_us = sum(r["kind_us"]["k1"] for r in run["ranks"])
    bound = run["work"].get("k1")
    return 100.0 * 1e3 * bound["ms"] / k1_us if k1_us and bound else None
