"""NCCL's device ms a step (the all-reduce of the gradients), on the rank
that spends most; nothing to read in a world of one."""


def read(run):
    if len(run["ranks"]) < 2:
        return None
    per = [r["kind_us"]["nccl"] / r["units"] / 1e3 for r in run["ranks"]
           if r["units"]]
    return max(per) if per and max(per) > 0 else None
