"""Adam's device ms a step: the entries the host launched inside
``Optimizer.step``, on the rank that spends most."""


def read(run):
    per = [r["kind_us"]["adam"] / r["units"] / 1e3 for r in run["ranks"]
           if r["units"]]
    return max(per) if per and max(per) > 0 else None
