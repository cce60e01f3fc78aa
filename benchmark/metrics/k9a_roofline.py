"""K9a's share of its roofline: the least time the card could take for
pass A of one step (``rooflines/k9a.py``) over the device time of
``het_path`` per step on the trace, in percent. Moves
``grad_steps_per_s``."""

from benchmark.harness import manifest

UNIT, SOURCE, MOVES = "%", "device_trace", "grad_steps_per_s"
LAYER = "volume gradient kernels"
KERNEL = "het_path_kernel"


def read(run):
    s = run.traces[0]
    if not s or not s["n_steps"]:
        return None
    t = sum(v for k, v in s["device_s"].items() if KERNEL in k)
    if t <= 0:
        return None
    return 100.0 * manifest.roofline("k9a").bound(run) / (t / s["n_steps"])
