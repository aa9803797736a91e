"""The share of K1's lane steps that sample, all ranks, in %: the counted
fit's ``sampled`` over its ``lane_steps`` (32 times the longest walk of
each warp's lanes)."""

from vrbench.metrics import spans


def read(run):
    found = spans.counts(run, "k1")
    if found is None or not found[0]["lane_steps"]:
        return None
    return 100.0 * found[0]["sampled"] / found[0]["lane_steps"]
