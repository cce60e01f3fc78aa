"""Per step, the window's time in which no operation ran on the device: the
gradient route's host side (camera rays, keys, the residual, the product
loss, the launches) and the Adam update's launches and its verdict's wait,
(window - device busy) / steps. Moves ``grad_steps_per_s``."""

UNIT, LAYER, SOURCE, MOVES = "ms", "gradients", "program_span", "grad_steps_per_s"


def read(run):
    s = run.traces[0]
    if not s or not s["n_steps"]:
        return None
    return 1e3 * (s["window_s"] - s["busy_s"]) / s["n_steps"]
