"""K2's TF-gradient flushes a step, all ranks, in millions: the counted
fit's ``tf_flushes`` (the warp trips that add ended TF runs to the
table) over its steps."""

from vrbench.metrics import spans


def read(run):
    found = spans.counts(run, "k2")
    return None if found is None else found[0]["tf_flushes"] / found[1] / 1e6
