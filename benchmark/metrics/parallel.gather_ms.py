"""On a split cell, per frame, the device time of the collectives (NCCL
kernels: the gather of the finished blocks and of the reject counts) on the
rank whose route kernel took longest: that rank waits on no other, so this
is the exchange itself; a faster rank's collectives also hold its wait for
the slowest. Moves ``msamples_per_s``."""

UNIT, LAYER, SOURCE, MOVES = "ms", "parallel", "device_trace", "msamples_per_s"


def read(run):
    ss = run.traces
    if len(ss) < 2 or any(s is None or not s["n_steps"] for s in ss):
        return None
    slow = max(ss, key=lambda s: s["route_s"])
    return 1e3 * slow["collective_s"] / slow["n_steps"]
