"""Device entries (kernels, copies, fills) a unit on rank 0, outside the
kernels of a kind of their own (K1, K2, the fold, NCCL) and Adam's: the
ray setup's launches, with the copies and, in a fit, the loss and the
grid's clamp."""


def read(run):
    r = run["ranks"][0]
    n = r["launches"]["rest"] + r["launches"]["copies"]
    return n / r["units"] if r["units"] and n else None
