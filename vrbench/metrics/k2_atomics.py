"""K2's voxel ``atomicAdd``s a step, all ranks, in millions: the counted
fit's ``voxel_atomics`` (an in-grid corner of a sample whose density
gradient is not 0) over its steps."""

from vrbench.metrics import spans


def read(run):
    found = spans.counts(run, "k2")
    return None if found is None else \
        found[0]["voxel_atomics"] / found[1] / 1e6
