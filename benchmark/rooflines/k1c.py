"""The work one frame of a whole-path surface render needs (K1c,
``mega_spp_persistent``), whatever kernel does it: every camera, bounce and
shadow ray against every triangle of the scene, 38 flop a nearest-hit pair
test (determinant 5, u 11, v 11, t 6, sign and compares 5) and 39 an
any-hit test; an exponential, square root or division counts as one
operation, so the bound is a low one. Bytes: per pixel its coordinates and
key in (12) and its sum and reject count out (16), the triangle table once
(36 + 2 + 128 per row) and 80 per light.

The ray counts are the plain reference's own tallies on the check's sample
of pixels (a seeded subset of every frame, each at the full spp), scaled to
the frame by the frame's pixels over the pixels sampled (``run.tally``, per
frame)."""

from benchmark.reference.surface_gi import scene_arrays

from . import peaks

FLOPS_PER_TEST, FLOPS_PER_ANYHIT_TEST = 38, 39


def bound(run):
    """Seconds per frame."""
    r = run.config["render"]
    n_pix = int(r["width"]) * int(r["height"])
    scene = scene_arrays(run.config["scene"])
    t = scene["v0"].shape[0]
    rays, shadow = run.tally["rays"], run.tally["shadow_rays"]
    flops = rays * t * FLOPS_PER_TEST + shadow * t * FLOPS_PER_ANYHIT_TEST
    n_bytes = n_pix * (12 + 16) + t * (36 + 2 + 128) + len(scene["lights"]) * 80
    return peaks.bound_s(n_bytes, flops)
