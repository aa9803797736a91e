"""NCCL's bus bandwidth in the all-reduce, GB/s: the bytes a rank hands
it a step (the counted fit's ``nccl_bytes`` over its steps) times 2(n -
1)/n, over NCCL's device time a step on the rank that spends most (what
``nccl_ms`` reads).  Nothing to read in a world of one."""

from vrbench.metrics import nccl_ms


def read(run):
    n = len(run["ranks"])
    found = [r.get("counters") for r in run["ranks"]]
    ms = nccl_ms.read(run)
    if n < 2 or ms is None or any(c is None for c in found):
        return None
    per_step = max(c["nccl_bytes"] / c["steps"] for c in found)
    return per_step * 2 * (n - 1) / n / (ms / 1e3) / 1e9 if per_step else None
