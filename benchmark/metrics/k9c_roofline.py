"""K9c's share of its roofline: the least time the card could take for one
frame's work (``rooflines/k9c.py``) over the device time of
``het_spp_persistent`` per frame on the trace, in percent. Moves
``msamples_per_s``."""

from benchmark.harness import manifest

UNIT, SOURCE, MOVES = "%", "device_trace", "msamples_per_s"
LAYER = "fused heterogeneous integrator"


def read(run):
    s = run.traces[0]
    if not s or not s["n_steps"] or s["route_s"] <= 0:
        return None
    return 100.0 * manifest.roofline("k9c").bound(run) / (s["route_s"] / s["n_steps"])
