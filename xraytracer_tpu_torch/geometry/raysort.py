"""Bounce-ray coherence sorting for the wavefront path.

PyTorch counterpart of ``xraytracer_tpu/geometry/raysort.py``. The sweep
kernels (``csrc/sweep.cuh``) walk the chunk table once per warp: a chunk is
visited if ANY lane of the warp wants it. Camera rays arrive Z-order
coherent, so a warp touches few chunks; BOUNCE rays are scattered over the
whole scene after one diffuse reflection, and a warp's union of chunks
covers most of the table.

So the wavefront is re-sorted between bounces, as in wavefront GPU
tracers: lanes that are spatially and directionally similar share warps
again. The key is (direction octant | origin Morton): within an octant
class, rays from the same surface patch march together. Dead lanes sort to
the END and their rays are PARKED far outside the scene bounds pointing
away, so warps of dead lanes reject every chunk at the group boxes.

Correctness is permutation-transparency: every per-lane quantity (RNG key,
throughput, radiance) travels with its lane and the final radiance is
scattered back to the original lane order, so images are BITWISE equal
with sorting on or off (tests/test_torch_raysort.py). No counterpart exists
in the reference (its ``par_unseq`` threads are per-pixel and never
interact, Src/renderer.cpp:83-99); this is scheduling, not an estimator
change.
"""

import torch

_DEAD_KEY = 0x7FFFFFFF
_BIG = 3.0e38


def scene_bounds(scene):
    """(lo, hi) AABB over all valid primitives, as (3,) float32 tensors."""
    tm = (scene.tri_obj >= 0)[:, None]
    pts_lo = []
    pts_hi = []

    def masked(p, m):
        big = torch.full_like(p, _BIG)
        lo = torch.where(m, p, big).amin(dim=0) if p.shape[0] else big.new_full((3,), _BIG)
        hi = torch.where(m, p, -big).amax(dim=0) if p.shape[0] else big.new_full((3,), -_BIG)
        return lo, hi

    for p in (
        scene.tri_v0,
        scene.tri_v0 + scene.tri_e1,
        scene.tri_v0 + scene.tri_e2,
    ):
        lo, hi = masked(p, tm)
        pts_lo.append(lo)
        pts_hi.append(hi)
    sm = (scene.sph_obj >= 0)[:, None]
    r = scene.sph_radius[:, None]
    lo, _ = masked(scene.sph_center - r, sm)
    _, hi = masked(scene.sph_center + r, sm)
    pts_lo.append(lo)
    pts_hi.append(hi)
    bm = (scene.box_obj >= 0)[:, None]
    lo, _ = masked(scene.box_min, bm)
    _, hi = masked(scene.box_max, bm)
    pts_lo.append(lo)
    pts_hi.append(hi)
    lo = torch.stack(pts_lo).amin(dim=0)
    hi = torch.stack(pts_hi).amax(dim=0)
    # degenerate / empty guard
    ok = hi >= lo
    lo = torch.where(ok, lo, torch.zeros_like(lo))
    hi = torch.where(ok, hi, torch.ones_like(hi))
    return lo, hi


def _spread3(x):
    """Spread the low 9 bits of int32 ``x`` to every 3rd bit position."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def coherence_key(o, d, active, lo, inv_ext):
    """(N,) int32 sort key: direction octant (3 bits, major) | 27-bit
    Morton code of the origin quantized into the scene bounds. Dead lanes
    get the maximal key (sort last)."""
    q = torch.clamp((o - lo) * inv_ext * 511.0, 0.0, 511.0).to(torch.int32)
    m = (
        (_spread3(q[:, 0]) << 2)
        | (_spread3(q[:, 1]) << 1)
        | _spread3(q[:, 2])
    )
    octant = (
        (d[:, 0] < 0).to(torch.int32) * 4
        + (d[:, 1] < 0).to(torch.int32) * 2
        + (d[:, 2] < 0).to(torch.int32)
    )
    key = (octant << 27) | m
    return torch.where(active, key, torch.full_like(key, _DEAD_KEY))
