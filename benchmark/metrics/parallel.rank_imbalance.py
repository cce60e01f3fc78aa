"""On a split cell, the slowest rank's route-kernel device time in the
window over the mean of the ranks': 1 when the pixel split balances the
work. Moves ``msamples_per_s``."""

UNIT, LAYER, SOURCE, MOVES = "x", "parallel", "device_trace", "msamples_per_s"


def read(run):
    ss = run.traces
    if len(ss) < 2 or any(s is None for s in ss):
        return None
    t = [s["route_s"] for s in ss]
    mean = sum(t) / len(t)
    return max(t) / mean if mean > 0 else None
