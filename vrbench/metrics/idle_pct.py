"""Device idle share of the traced units (frames or steps), on the rank
that idles most: one less the union of the units' device entries over the
window from the first unit's call to the end of the last unit's last
entry, in percent."""


def read(run):
    shares = [1.0 - r["busy_us"] / r["window_us"] for r in run["ranks"]
              if r["window_us"] and r["entries"]]
    return 100.0 * max(shares) if shares else None
