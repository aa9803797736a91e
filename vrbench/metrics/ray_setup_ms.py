"""The ray setup's device ms a step: the entries launched innermost in the
program's ``vr.ray_setup`` spans (the ray grid, the layout's packing, the
box entry), on the rank that spends most (``spans.step_ms``)."""

from vrbench.metrics import spans


def read(run):
    return spans.step_ms(run, "vr.ray_setup")
