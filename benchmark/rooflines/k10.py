"""The work pass B of one density-fitting step needs (K10,
``het_grad_path`` over both streams' lanes), whatever kernel does it: a
replay of pass A's paths on the same draws (``k9a.py``), and per collision
candidate its gradient event: 80 flop for a tracking candidate (three
channels of d p_s, the pdf's derivative, two score terms, the coefficient,
eight corner weights and eight adds) and 45 for a transmittance candidate
(three ratios' derivatives, the corners). Bytes: per lane 52 in (ray, key,
image, residual) and 12 + 12 L out (image, the L lights' Le planes), the
density grid and the supergrid read once and the gradient grid written
once.

The counts are the plain reference's own tallies of the same steps' lanes,
per step (``run.tally``)."""

import numpy as np

from . import k9c, peaks

SAMPLE_GRAD_EVENT, TR_GRAD_EVENT = 80, 45


def bound(run):
    """Seconds per step."""
    cfg = run.config
    r = cfg["render"]
    lanes = 2 * int(r["width"]) * int(r["height"])
    k = run.tally
    n_l = len(cfg["scene"]["sphere_lights"])
    flops = (k9c.path_flops(cfg, k) + k["sample_candidates"] * SAMPLE_GRAD_EVENT
             + k["tr_candidates"] * TR_GRAD_EVENT)
    cells = 4 * int(np.prod(cfg["scene"]["density_grid"]["res"]))
    n_bytes = lanes * (52 + 12 + 12 * n_l) + k9c.grid_bytes(cfg) + cells
    return peaks.bound_s(n_bytes, flops)
