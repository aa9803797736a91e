"""The loss's device ms a step: the entries launched innermost in the
program's ``vr.loss`` span (the targets packed, the squared error and its
sum), on the rank that spends most (``spans.step_ms``)."""

from vrbench.metrics import spans


def read(run):
    return spans.step_ms(run, "vr.loss")
