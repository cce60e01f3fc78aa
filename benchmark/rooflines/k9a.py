"""The work pass A of one density-fitting step needs (K9a, ``het_path``
over both streams' lanes), whatever kernel does it: the paths of the
gradient-friendly estimator (roulette off, a uniform channel pick), counted
per lane and iteration as in ``k9c.py``. Bytes: per lane its ray and key in
(28) and its radiance out (12), the density grid and the supergrid once.

The counts are the plain reference's own tallies of the same steps' lanes
(every pixel of both streams), per step (``run.tally``)."""

from . import k9c, peaks


def bound(run):
    """Seconds per step."""
    cfg = run.config
    r = cfg["render"]
    lanes = 2 * int(r["width"]) * int(r["height"])
    return peaks.bound_s(lanes * (28 + 12) + k9c.grid_bytes(cfg),
                         k9c.path_flops(cfg, run.tally))
