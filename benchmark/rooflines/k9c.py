"""The work one frame of a whole-path heterogeneous render needs (K9c,
``het_spp_persistent``), whatever kernel does it, per path iteration:

* every lane that enters it: the sphere tests (30 flop each), the box slab
  (30) and the roulette (8);
* every lane that tracks: 32 per majorant segment its span crosses and 150
  per collision candidate (draws, logarithm, exponentials, segment
  inversion, trilinear value 45, channel pick, cross sections, weights);
* every scatter: the phase direction (45), and where the configuration's
  integrator does NEE (``reference/cloud_nee.py``'s ``NEE``) the light pick
  and cone sample (75), a second hit test and the phase value and sum (30),
  and the shadow ray's ratio tracking: 32 per segment and 70 per candidate.
  Without NEE the ratio tracking's tallies are 0.

An exponential, logarithm, sine, cosine, square root or division counts as
one operation, so the bound is a low one. Bytes: per pixel 12 in and 16
out, the density grid and the supergrid once.

Lanes, segments, candidates and scatters are the plain reference's own
tallies of its tracking loops (``run.tally``, per frame): on the check's
sample of pixels (a seeded subset of every frame, each at the full spp),
scaled to the frame by the frame's pixels over the pixels sampled; or,
where the configuration has a ``count``, on its fixed pixels at a fixed
seed, scaled to the frame's pixels and spp (``harness/check.py``
``frame_count``)."""

import numpy as np

from benchmark.reference.cloud_nee import NEE

from . import peaks

SPHERE, BOX, RR = 30, 30, 8
SEGMENT, CANDIDATE, TR_CANDIDATE = 32, 150, 70
SCATTER, CONE, NEE_REST = 45, 75, 30


def path_flops(cfg, k):
    """The operations of the paths the tallies ``k`` counted."""
    hit = len(cfg["scene"]["sphere_lights"]) * SPHERE + BOX
    nee = NEE[cfg["render"]["integrator"]]
    flops = (k["rays"] * (hit + RR)
             + k["sample_segments"] * SEGMENT
             + k["sample_candidates"] * CANDIDATE
             + k["scattered"] * (SCATTER + CONE + hit + NEE_REST if nee else SCATTER))
    if nee:
        flops = flops + k["tr_segments"] * SEGMENT + k["tr_candidates"] * TR_CANDIDATE
    return flops


def grid_bytes(cfg):
    """The density grid and its <= 8^3 supergrid, float32."""
    res = cfg["scene"]["density_grid"]["res"]
    cells = int(np.prod(res))
    blocks = int(np.prod([min(max(n - 1, 1), 8) for n in res]))
    return 4 * (cells + blocks)


def bound(run):
    """Seconds per frame."""
    cfg = run.config
    r = cfg["render"]
    n_pix = int(r["width"]) * int(r["height"])
    return peaks.bound_s(n_pix * (12 + 16) + grid_bytes(cfg), path_flops(cfg, run.tally))
