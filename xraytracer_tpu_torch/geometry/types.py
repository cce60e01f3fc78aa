"""Wavefront ray / hit records (struct-of-arrays).

PyTorch counterpart of ``xraytracer_tpu/geometry/types.py`` and of the
reference's per-ray ``Ray`` / ``SurfaceInfo`` / ``IntersectInfo`` structs
(reference: Src/ray.h:5-39). A record holds a whole wavefront: every field
is an ``(N, ...)`` tensor and the ray index is the batch dimension.
``IntersectInfo.t1`` (distance to medium exit, Src/ray.h:35) is preserved
as ``Hit.t1``.
"""

from typing import NamedTuple

import torch

from ..constants import INF


class Rays(NamedTuple):
    o: torch.Tensor  # (N, 3) origins
    d: torch.Tensor  # (N, 3) unit directions

    @property
    def n(self):
        return self.o.shape[0]

    def at(self, t):
        """Point along each ray: o + t * d (reference: Src/ray.h:19)."""
        return self.o + t[..., None] * self.d


class Hit(NamedTuple):
    """Nearest-hit record for a wavefront. ``obj < 0`` means miss.

    The appearance fields (light/medium/mtype/ior/albedo) are pre-joined
    from the denormalized primitive records so integrators shade without
    further table gathers."""

    t: torch.Tensor         # (N,) distance to hit (INF on miss)
    t1: torch.Tensor        # (N,) medium exit distance (INF unless box hit)
    obj: torch.Tensor       # (N,) int32 object id, -1 on miss
    position: torch.Tensor  # (N, 3)
    ng: torch.Tensor        # (N, 3) geometric normal
    ns: torch.Tensor        # (N, 3) shading normal
    dpdu: torch.Tensor      # (N, 3) tangent
    dpdv: torch.Tensor      # (N, 3) bitangent
    uv: torch.Tensor        # (N, 2) texcoords
    bary: torch.Tensor      # (N, 2) barycentric (u, v)
    light: torch.Tensor     # (N,) int32 area-light row, -1 = none
    medium: torch.Tensor    # (N,) int32 medium row, -1 = none
    mtype: torch.Tensor     # (N,) int32 material type id, -1 = none
    ior: torch.Tensor       # (N,)
    albedo: torch.Tensor    # (N, 3)

    @property
    def hit(self):
        return self.obj >= 0


def miss_hit(n, dtype=torch.float32, device="cpu"):
    z3 = torch.zeros((n, 3), dtype=dtype, device=device)
    z2 = torch.zeros((n, 2), dtype=dtype, device=device)
    neg1 = torch.full((n,), -1, dtype=torch.int32, device=device)
    return Hit(
        t=torch.full((n,), INF, dtype=dtype, device=device),
        t1=torch.full((n,), INF, dtype=dtype, device=device),
        obj=neg1,
        position=z3,
        ng=z3,
        ns=z3,
        dpdu=z3,
        dpdv=z3,
        uv=z2,
        bary=z2,
        light=neg1,
        medium=neg1,
        mtype=neg1,
        ior=torch.ones((n,), dtype=dtype, device=device),
        albedo=z3,
    )
