"""Wavefront BSDF evaluation and sampling.

PyTorch counterpart of ``xraytracer_tpu/materials.py`` and of the
reference's ``Material`` hierarchy (reference: Src/material.h:6-77). Virtual
dispatch becomes integer ``mat_type`` ids + ``torch.where`` lane selection
over a whole wavefront.

The reference ships only ``Lambert`` (albedo/pi, uniform-hemisphere
sampling, Src/material.h:28-77); ``MaterialType::Metals/Glass`` are declared
(Src/geometry.h:703) but have no classes — their Whitted branches
(Src/integrator.h:344-381) are unreachable. Here Mirror and Glass are real
BSDFs so those branches are live (SURVEY.md §7 step 6), parameterized by the
Whitted branch's hard-coded constants (tint 0.8 / 0.9, ior 1.3).

All directions are in the local shading frame: +Y is the shading normal,
``wo`` points away from the surface (the reference flips the incoming ray
direction before calling these, Src/integrator.h:273-277).
"""

from typing import NamedTuple

import torch

from .constants import PI_INV, PI_MUL_2_INV
from .sampling import cosine_hemisphere, uniform_hemisphere
from .scene.tables import MAT_GLASS, MAT_LAMBERT, MAT_MIRROR


class BsdfSample(NamedTuple):
    """One sampled bounce per lane.

    ``weight`` is the full throughput factor ``f * |cos| / pdf`` (for delta
    lobes the cancelled delta is folded in, leaving just the tint), so every
    integrator updates throughput uniformly: ``T *= weight``.
    """

    wi: torch.Tensor        # (N, 3) local sampled direction
    weight: torch.Tensor    # (N, 3) f * cos / pdf
    pdf: torch.Tensor       # (N,) solid-angle pdf (1.0 on delta lanes)
    is_delta: torch.Tensor  # (N,) bool — mirror/glass lanes
    flip_side: torch.Tensor  # (N,) bool — wi is in the lower hemisphere
                             # (glass transmission): re-origin below surface


def _gather_mat(scene, obj):
    """Object id -> (mat_type, albedo, ior); missing material -> type -1."""
    i64 = torch.int64
    o = torch.clamp(obj, min=0).to(i64)
    mi = torch.where(obj >= 0, scene.obj_mat[o], torch.full_like(obj, -1))
    m = torch.clamp(mi, min=0).to(i64)
    mtype = torch.where(mi >= 0, scene.mat_type[m], torch.full_like(mi, -1))
    return mtype, scene.mat_albedo[m], scene.mat_ior[m]


def eval_bsdf_direct(mtype, albedo, wo, wi):
    """f(wo, wi) from pre-joined appearance data (no table gathers).
    Delta lobes evaluate to 0.

    Lambert: albedo/pi when both directions are above the surface
    (reference: Src/material.h:34-44 returns 0 unless cosThetaO, cosThetaI > 0).
    """
    above = (wo[:, 1] > 0.0) & (wi[:, 1] > 0.0)
    lam = albedo * PI_INV
    return torch.where(
        ((mtype == MAT_LAMBERT) & above)[:, None], lam, torch.zeros_like(lam)
    )


def eval_bsdf(scene, obj, wo, wi):
    """Object-id convenience wrapper around ``eval_bsdf_direct``."""
    mtype, albedo, _ = _gather_mat(scene, obj)
    return eval_bsdf_direct(mtype, albedo, wo, wi)


def bsdf_pdf_direct(mtype, wo, wi, cosine_sampling=False):
    """Solid-angle pdf of ``sample_bsdf`` having produced ``wi`` — needed for
    MIS. Delta lobes report 0."""
    above = (wo[:, 1] > 0.0) & (wi[:, 1] > 0.0)
    if cosine_sampling:
        p = torch.clamp(wi[:, 1], min=0.0) * PI_INV
    else:
        p = torch.full_like(wi[:, 1], PI_MUL_2_INV)
    return torch.where((mtype == MAT_LAMBERT) & above, p, torch.zeros_like(p))


def bsdf_pdf(scene, obj, wo, wi, cosine_sampling=False):
    """Object-id convenience wrapper around ``bsdf_pdf_direct``."""
    mtype, _, _ = _gather_mat(scene, obj)
    return bsdf_pdf_direct(mtype, wo, wi, cosine_sampling)


def sample_bsdf_direct(
    mtype, albedo, ior, wo, u2, u_lobe, cosine_sampling=False
) -> BsdfSample:
    """Sample one bounce direction per lane from pre-joined appearance data,
    dispatched on material type.

    * Lambert — uniform hemisphere, pdf 1/2pi (reference: Src/material.h:55-73)
      or cosine-weighted (Malley) when ``cosine_sampling`` — the
      lower-variance option.

      Documented divergence (PARITY.md "cosine normal"): the cos factor
      folded into ``weight`` is against the SHADING normal (``wi.y`` in the
      local shading frame), whereas the reference multiplies fr*cos with cos
      against the GEOMETRIC normal (dot(nextDir, ng),
      Src/integrator.h:173,277). Identical for the reference's flat-normal
      scenes (ns == ng everywhere); for smooth OBJ meshes with interpolated
      normals the shading-normal cosine is the standard (and less
      artifact-prone) choice, so we keep it deliberately.
    * Mirror — delta reflection about +Y; weight = tint.
    * Glass — Fresnel-weighted single-sample choice between reflection and
      refraction using ``u_lobe`` (the reference's Whitted queue pushes both
      branches, Src/integrator.h:355-381; one-sample selection is the
      wavefront-friendly unbiased equivalent).
    """
    n = wo.shape[0]
    dev = wo.device
    one = torch.ones((n,), device=dev)
    zero = torch.zeros((n,), device=dev)

    # --- Lambert lanes ---------------------------------------------------
    if cosine_sampling:
        wi_l = cosine_hemisphere(u2[:, 0], u2[:, 1])
        pdf_l = torch.clamp(wi_l[:, 1], min=0.0) * PI_INV
        # f*cos/pdf = (albedo/pi)*cos/(cos/pi) = albedo
        w_l = albedo
    else:
        wi_l = uniform_hemisphere(u2[:, 0], u2[:, 1])
        pdf_l = torch.full((n,), PI_MUL_2_INV, device=dev)
        # f*cos/pdf = (albedo/pi)*cos*2pi = 2*albedo*cos
        w_l = 2.0 * albedo * torch.clamp(wi_l[:, 1], min=0.0)[:, None]

    # --- Mirror lanes: wi = (-wo.x, wo.y, -wo.z) -------------------------
    wi_m = torch.stack([-wo[:, 0], wo[:, 1], -wo[:, 2]], dim=-1)

    # --- Glass lanes ------------------------------------------------------
    # Local-frame Fresnel with incident dir = -wo against +Y normal
    # (reference: Src/geometry.cpp:69-89 via Src/integrator.h:357).
    cosi = torch.clamp(-wo[:, 1], -1.0, 1.0)
    exiting = cosi > 0.0
    etai = torch.where(exiting, ior, one)
    etat = torch.where(exiting, one, ior)
    sint = etai / etat * torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=0.0))
    cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=0.0))
    cosa = torch.abs(cosi)
    rs = (etat * cosa - etai * cost) / (etat * cosa + etai * cost)
    rp = (etai * cosa - etat * cost) / (etai * cosa + etat * cost)
    kr = torch.where(sint >= 1.0, one, 0.5 * (rs * rs + rp * rp))
    # refraction of i = -wo about local normal sign(cosi-flip)
    eta = etai / etat
    nn_y = torch.where(cosi < 0.0, one, -one)
    k = 1.0 - eta * eta * (1.0 - cosa * cosa)
    refr = eta[:, None] * (-wo) + (
        eta * cosa - torch.sqrt(torch.clamp(k, min=0.0))
    )[:, None] * torch.stack([zero, nn_y, zero], dim=-1)
    pick_reflect = (u_lobe < kr) | (k <= 0.0)
    wi_g = torch.where(pick_reflect[:, None], wi_m, refr)

    is_mirror = mtype == MAT_MIRROR
    is_glass = mtype == MAT_GLASS
    is_delta = is_mirror | is_glass

    wi = torch.where(
        is_mirror[:, None], wi_m, torch.where(is_glass[:, None], wi_g, wi_l)
    )
    weight = torch.where(is_delta[:, None], albedo, w_l)
    pdf = torch.where(is_delta, one, pdf_l)
    flip_side = is_glass & ~pick_reflect
    return BsdfSample(
        wi=wi, weight=weight, pdf=pdf, is_delta=is_delta, flip_side=flip_side
    )


def sample_bsdf(scene, obj, wo, u2, u_lobe, cosine_sampling=False) -> BsdfSample:
    """Object-id convenience wrapper around ``sample_bsdf_direct``."""
    mtype, albedo, ior = _gather_mat(scene, obj)
    return sample_bsdf_direct(
        mtype, albedo, ior, wo, u2, u_lobe, cosine_sampling
    )
