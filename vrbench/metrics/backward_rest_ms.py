"""The backward's device ms a step outside K2 and the fold: the entries
launched innermost in the program's ``vr.backward`` span (autograd back
through the loss, the permutes and the packing), on the rank that spends
most (``spans.step_ms``).  K2's wrapper and the fold's open spans of their
own (``vr.k2``, ``vr.fold``)."""

from vrbench.metrics import spans


def read(run):
    return spans.step_ms(run, "vr.backward")
