"""Flat device-resident scene tables.

PyTorch counterpart of ``xraytracer_tpu/scene/tables.py`` (same fields, same
order, same packed ``tri_rec`` layout) and of the reference's pointer-linked
scene graph
(``Scene`` holding ``unordered_map<string, Object>`` with raw Material /
AreaLight / Medium pointers, reference: Src/scene.h:43-46,
Src/primitive.h:40-95). Polymorphism-by-vtable becomes integer type ids +
index tables: every primitive row carries an object id, and per-object rows
carry indices into the material / area-light / medium tables (-1 = none,
mirroring the reference's null-pointer checks ``hasSurface/hasAreaLight/
hasMedium``, Src/primitive.h:52-62).

All tables are padded (triangles to a multiple of the intersection chunk,
everything else to >= 1 row) with sentinel rows whose object/owner id is -1,
so every kernel is shape-static.
"""

from typing import NamedTuple

import torch

# material type ids (reference enum: Src/geometry.h:703)
MAT_LAMBERT = 0
MAT_MIRROR = 1   # reference declares Metals but ships no class; live here
MAT_GLASS = 2    # reference declares Glass but ships no class; live here

# area light type ids (reference: Src/light.h:79-210)
AL_TRIANGLE = 0
AL_QUAD = 1
AL_SPHERE = 2

# delta light type ids (reference: Src/light.h:28-49)
DL_POINT = 0
DL_DISTANT = 1

# medium type ids (reference: Src/medium.h:122-387)
MED_HOMOG_MIS = 0
MED_HOMOG_ACHROMATIC = 1
MED_HOMOG_NOMIS = 2
MED_HETEROGENEOUS = 3


class SceneTables(NamedTuple):
    """The whole scene as a tuple of tensors, all on one device."""

    # triangles: v0 + edge vectors (Möller-Trumbore form), per-vertex
    # normals/uvs, owning object id
    tri_v0: torch.Tensor   # (T, 3)
    tri_e1: torch.Tensor   # (T, 3)
    tri_e2: torch.Tensor   # (T, 3)
    tri_n0: torch.Tensor   # (T, 3)
    tri_n1: torch.Tensor   # (T, 3)
    tri_n2: torch.Tensor   # (T, 3)
    tri_uv0: torch.Tensor  # (T, 2)
    tri_uv1: torch.Tensor  # (T, 2)
    tri_uv2: torch.Tensor  # (T, 2)
    tri_obj: torch.Tensor  # (T,) int32
    # packed per-triangle record so the hot surface-record path does ONE
    # 128-byte row read instead of many gathers:
    # cols 0-8   n0 n1 n2        (vertex normals)
    # cols 9-14  uv0 uv1 uv2
    # cols 15-23 v0 e1 e2
    # cols 24-27 obj, light, medium, mat_type   (ints as float32, exact)
    # col  28    ior
    # cols 29-31 albedo
    # The relational obj -> material/light/medium indirection is PRE-JOINED
    # here (denormalized) so shading needs no further table gathers.
    tri_rec: torch.Tensor  # (T, 32)

    # analytic spheres
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_obj: torch.Tensor     # (S,) int32

    # medium bounding boxes
    box_min: torch.Tensor  # (B, 3)
    box_max: torch.Tensor  # (B, 3)
    box_obj: torch.Tensor  # (B,) int32

    # objects: indices into the tables below, -1 = none
    obj_mat: torch.Tensor     # (O,) int32
    obj_light: torch.Tensor   # (O,) int32
    obj_medium: torch.Tensor  # (O,) int32

    # materials
    mat_type: torch.Tensor    # (M,) int32
    mat_albedo: torch.Tensor  # (M, 3)
    mat_ior: torch.Tensor     # (M,)

    # area lights
    al_type: torch.Tensor    # (L,) int32
    al_le: torch.Tensor      # (L, 3)
    al_v0: torch.Tensor      # (L, 3) triangle/quad corner
    al_e1: torch.Tensor      # (L, 3)
    al_e2: torch.Tensor      # (L, 3)
    al_ng: torch.Tensor      # (L, 3) unnormalized cross(e1, e2)
    al_center: torch.Tensor  # (L, 3) sphere lights
    al_radius: torch.Tensor  # (L,)

    # delta lights
    dl_type: torch.Tensor       # (D,) int32
    dl_pos: torch.Tensor        # (D, 3)
    dl_dir: torch.Tensor        # (D, 3) unit, for distant lights
    dl_color: torch.Tensor      # (D, 3)
    dl_intensity: torch.Tensor  # (D,)

    # participating media
    med_type: torch.Tensor          # (Md,) int32
    med_g: torch.Tensor             # (Md,)
    med_sigma_a: torch.Tensor       # (Md, 3) homog sigma_a / hetero absorption color
    med_sigma_s: torch.Tensor       # (Md, 3) homog sigma_s / hetero scattering color
    med_majorant: torch.Tensor      # (Md,) heterogeneous majorant
    med_density_mult: torch.Tensor  # (Md,)

    # dense density grid (single per scene; heterogeneous media reference it)
    grid_density: torch.Tensor  # (Nx, Ny, Nz)
    grid_min: torch.Tensor      # (3,)
    grid_max: torch.Tensor      # (3,)
    # corner-packed grid for the tracking hot loop: row c of (Nx*Ny*Nz, 8)
    # holds the 8 cell corners (edge-clamped), so a trilinear lookup is ONE
    # row gather instead of eight scalar gathers
    grid_packed: torch.Tensor   # (Nx*Ny*Nz, 8)
    # block-max supergrid for piecewise-majorant tracking (media.py): block
    # (bx,by,bz) holds the max DENSITY over every trilinear lookup whose
    # continuous index falls in [b*B, (b+1)*B] (one-ring corner overlap, so
    # it is a true upper bound). Flat x-major; up to 8 blocks per axis
    # (<= 512 rows). Derived
    # buffer (like grid_packed): stale after grid_density edits.
    grid_super: torch.Tensor       # (nbx*nby*nbz,) block max density
    grid_super_nb: torch.Tensor    # (3,) int32 block counts per axis
    grid_super_bsize: torch.Tensor # (3,) block edge length in index units

    @property
    def n_area_lights(self):
        """Count of real (non-sentinel) area lights (synchronises when the
        tables live on the card; prefer ``scene_statics``)."""
        return int((self.al_type >= 0).sum())

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]


def rejoin_appearance(tables: "SceneTables") -> "SceneTables":
    """Recompute tri_rec's denormalized appearance columns (24-31) from the
    relational tables, differentiably.

    The builder pre-joins obj -> material/light/medium data into ``tri_rec``
    for gather-free shading; when a differentiable pipeline overrides
    relational leaves (``tables._replace(mat_albedo=...)``) the join must be
    redone with tensor ops so gradients flow into the real parameters."""
    i64 = torch.int64
    f32 = torch.float32
    neg1 = torch.full_like(tables.tri_obj, -1)
    oix = torch.clamp(tables.tri_obj, min=0).to(i64)
    has_obj = tables.tri_obj >= 0
    mat = torch.where(has_obj, tables.obj_mat[oix], neg1)
    mix = torch.clamp(mat, min=0).to(i64)
    has_mat = mat >= 0
    mtype = torch.where(has_mat, tables.mat_type[mix], neg1)
    ior = torch.where(
        has_mat, tables.mat_ior[mix], torch.ones_like(tables.mat_ior[mix])
    )
    alb = tables.mat_albedo[mix]
    albedo = torch.where(has_mat[:, None], alb, torch.zeros_like(alb))
    light = torch.where(has_obj, tables.obj_light[oix], neg1)
    medium = torch.where(has_obj, tables.obj_medium[oix], neg1)
    rec = torch.cat(
        [
            tables.tri_rec[:, :24],
            tables.tri_obj.to(f32)[:, None],
            light.to(f32)[:, None],
            medium.to(f32)[:, None],
            mtype.to(f32)[:, None],
            ior[:, None],
            albedo,
        ],
        dim=1,
    )
    return tables._replace(tri_rec=rec)
