"""Wavefront light sampling and emission.

PyTorch counterpart of ``xraytracer_tpu/lights.py`` (area and delta
lights) and of the reference's light hierarchy (reference:
Src/light.h:11-210, Src/light.cpp). Virtual ``AreaLight::sample`` dispatch
becomes type-id selection over flat light tables; every function is batched
over the wavefront.

pdf conventions follow the reference exactly (SURVEY.md §2.4):
  * TriangleLight: solid-angle pdf = 2 t^3 / |d . Ng|, with d and Ng both
    UNnormalized (Src/light.cpp:21-30).
  * QuadLight: pdf = t^3 / |d . Ng| (Src/light.cpp:59-68).
  * SphereLight: analytic cone solid-angle pdf = 1 / (2 pi (1 - cos_theta_max))
    — the reference's default #else branch (Src/light.h:160-198).
  * PointLight: pdf = distance^2, folding the inverse-square law into the pdf
    (Src/light.cpp:115-128).
  * DistantLight: pdf = 1, t_max = inf (Src/light.cpp:130-142).
Backfacing samples return Le = 0 (one-sided emission, Src/light.h:62-69 and
the ``d_dot_Ng >= 0`` early outs in every ``sample``).
"""

from typing import NamedTuple

import numpy as np
import torch

from .constants import INF, PI_MUL_2
from .math import dot, length, normalize, orthonormal_basis, take_rows
from .sampling import uniform_sphere, uniform_triangle
from .scene.tables import AL_SPHERE, AL_TRIANGLE, DL_POINT


class LightSample(NamedTuple):
    """One light sample per lane (NEE shadow-ray candidate)."""

    wi: torch.Tensor    # (N, 3) unit direction toward the light
    t_max: torch.Tensor  # (N,) distance to the sampled point (inf for distant)
    pdf: torch.Tensor   # (N,) per the conventions above
    le: torch.Tensor    # (N, 3) emitted radiance, 0 for backfacing samples


def sample_area_light(
    scene, light_idx, position, u2, sphere_strategy="cone"
) -> LightSample:
    """Sample one area light per lane, dispatched on its type id.

    ``light_idx``: (N,) int32 rows into the area-light table; ``position``:
    (N, 3) shading points; ``u2``: (N, 2) uniforms.

    ``sphere_strategy`` selects among the reference's three compile-time
    SphereLight strategies (Src/light.h:129-198):
      * "cone" — the default #else branch: analytic point in the subtended
        cone, pdf = 1 / (2 pi (1 - cos_theta_max));
      * "intersect" — the INTERSECT_METHOD toggle: uniform cone DIRECTION,
        then an analytic ray-sphere intersection finds the point (misses
        fall back to the closest-approach projection, interior points
        return Le = 0, Src/light.h:136-156); same cone pdf;
      * "area" — the AREA_SAMPLING toggle (Src/light.h:131-136,197-200 —
        uniform point on the sphere surface). Deliberate fix (SURVEY.md
        §2.4): the reference's AREA_SAMPLING pdf reuses the triangle form
        2t^3/|d.n| which is not energy-consistent for a sphere; here the
        correct solid-angle conversion of the uniform-area pdf is used:
        t^3 / (4 pi r^2 |d.n|).
    """
    li = torch.clamp(light_idx, min=0).to(torch.int64)
    ltype = torch.where(light_idx >= 0, scene.al_type[li], -1)
    le = take_rows(scene.al_le, li)
    v0 = scene.al_v0[li]
    e1 = scene.al_e1[li]
    e2 = scene.al_e2[li]
    ng = scene.al_ng[li]
    center = scene.al_center[li]
    radius = scene.al_radius[li]
    u, v = u2[:, 0], u2[:, 1]

    # --- triangle: sqrt-warp point (Src/light.cpp:21-47) -----------------
    p_tri = uniform_triangle(u, v, v0, v0 + e1, v0 + e2)
    # --- quad: bilinear point (Src/light.cpp:59-68) ----------------------
    p_quad = v0 + e1 * u[:, None] + e2 * v[:, None]

    d_flat = torch.where((ltype == AL_TRIANGLE)[:, None], p_tri, p_quad) - position
    t_flat = length(d_flat)
    d_dot_ng = dot(d_flat, ng)
    front_flat = d_dot_ng < 0.0
    denom = torch.abs(d_dot_ng)
    denom = torch.where(denom == 0.0, 1.0, denom)
    t3 = t_flat * t_flat * t_flat
    pdf_flat = torch.where(ltype == AL_TRIANGLE, 2.0 * t3, t3) / denom

    if sphere_strategy == "area":
        # uniform point on the sphere surface (Src/light.h:131-136)
        n_sph = uniform_sphere(u, v)
        p_sph = center + n_sph * radius[:, None]
        d_sph = p_sph - position
        t_sph = length(d_sph)
        d_dot_n = dot(d_sph, n_sph)
        front_sph = d_dot_n < 0.0
        area = 4.0 * torch.pi * radius * radius
        denom_s = torch.abs(d_dot_n) * torch.clamp(area, min=1e-12)
        pdf_sph = t_sph ** 3 / torch.where(denom_s == 0.0, 1.0, denom_s)

        is_sph = ltype == AL_SPHERE
        d = torch.where(is_sph[:, None], d_sph, d_flat)
        t_max = torch.where(is_sph, t_sph, t_flat)
        pdf = torch.where(is_sph, pdf_sph, pdf_flat)
        front = torch.where(is_sph, front_sph, front_flat) & (ltype >= 0)
        safe_t = torch.where(t_max == 0.0, 1.0, t_max)
        wi = d / safe_t[:, None]
        le = torch.where(front[:, None], le, 0.0)
        return LightSample(wi=wi, t_max=t_max, pdf=pdf, le=le)

    if sphere_strategy == "intersect":
        # uniform cone direction + analytic sphere intersection
        # (Src/light.h:136-156, the INTERSECT_METHOD toggle)
        dz_vec = center - position
        dz_len2 = dot(dz_vec, dz_vec)
        dz_len = torch.sqrt(dz_len2)
        safe_len = torch.where(dz_len == 0.0, 1.0, dz_len)
        dz = dz_vec / safe_len[:, None]          # TOWARD the sphere here
        dx, dy = orthonormal_basis(dz)
        safe_len2 = torch.where(dz_len2 == 0.0, 1.0, dz_len2)
        sin_tm2 = radius * radius / safe_len2
        cos_tm = torch.sqrt(torch.clamp(1.0 - sin_tm2, min=0.0))
        # UniformSampleCone (PBRT): cos_t lerp(1 -> cos_tm), phi uniform
        cos_t = (1.0 - u) + u * cos_tm
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = PI_MUL_2 * v
        sdir = (
            (torch.cos(phi) * sin_t)[:, None] * dx
            + (torch.sin(phi) * sin_t)[:, None] * dy
            + cos_t[:, None] * dz
        )
        # analytic nearest-positive ray-sphere t (stable q-form not needed
        # for the light's own geometry scale); miss -> closest approach
        # projection, exactly the reference fallback (Src/light.h:150-151)
        oc = position - center
        b = dot(oc, sdir)
        c = dot(oc, oc) - radius * radius
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_hit = torch.where(-b - sq > 0.0, -b - sq, -b + sq)
        miss = (disc < 0.0) | (t_hit <= 0.0)
        t_sph = torch.where(miss, dot(dz_vec, sdir), t_hit)
        p_sph = position + sdir * t_sph[:, None]
        # deliberate fix: the reference tests length(p - center) < radius
        # (Src/light.h:155), but p lies ON the sphere after a hit, so that
        # comparison is a float coin flip; its stated intent ("check for x
        # inside the sphere") is the SHADING point, tested here directly
        inside = dz_len < radius
        n_sph = normalize(p_sph - center)
        d_sph = p_sph - position
        front_sph = (dot(d_sph, n_sph) < 0.0) & ~inside
        pdf_sph = 1.0 / (PI_MUL_2 * torch.clamp(1.0 - cos_tm, min=1e-12))

        is_sph = ltype == AL_SPHERE
        d = torch.where(is_sph[:, None], d_sph, d_flat)
        t_max = torch.where(is_sph, t_sph, t_flat)
        pdf = torch.where(is_sph, pdf_sph, pdf_flat)
        front = torch.where(is_sph, front_sph, front_flat) & (ltype >= 0)
        safe_t = torch.where(t_max == 0.0, 1.0, t_max)
        wi = d / safe_t[:, None]
        le = torch.where(front[:, None], le, 0.0)
        return LightSample(wi=wi, t_max=t_max, pdf=pdf, le=le)

    # --- sphere: PBRT-style cone sampling, analytic cone pdf -------------
    # (Src/light.h:160-198, the default #else branch)
    dz_vec = center - position
    dz_len2 = dot(dz_vec, dz_vec)
    dz_len = torch.sqrt(dz_len2)
    safe_len = torch.where(dz_len == 0.0, 1.0, dz_len)
    dz = -dz_vec / safe_len[:, None]  # from center toward the shading point
    dx, dy = orthonormal_basis(dz)
    safe_len2 = torch.where(dz_len2 == 0.0, 1.0, dz_len2)
    sin_tm2 = radius * radius / safe_len2
    sin_tm = torch.sqrt(sin_tm2)
    cos_tm = torch.sqrt(torch.clamp(1.0 - sin_tm2, min=0.0))
    cos_t = 1.0 + (cos_tm - 1.0) * u
    sin_t2 = 1.0 - cos_t * cos_t
    safe_sin_tm = torch.where(sin_tm == 0.0, 1.0, sin_tm)
    safe_sin_tm2 = torch.where(sin_tm2 == 0.0, 1.0, sin_tm2)
    cos_a = sin_t2 / safe_sin_tm + cos_t * torch.sqrt(
        torch.clamp(1.0 - sin_t2 / safe_sin_tm2, min=0.0)
    )
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = PI_MUL_2 * v
    n_sph = (
        (torch.cos(phi) * sin_a)[:, None] * dx
        + (torch.sin(phi) * sin_a)[:, None] * dy
        + cos_a[:, None] * dz
    )
    p_sph = center + n_sph * radius[:, None]
    d_sph = p_sph - position
    t_sph = length(d_sph)
    front_sph = dot(d_sph, n_sph) < 0.0
    pdf_sph = 1.0 / (PI_MUL_2 * torch.clamp(1.0 - cos_tm, min=1e-12))

    is_sph = ltype == AL_SPHERE
    d = torch.where(is_sph[:, None], d_sph, d_flat)
    t_max = torch.where(is_sph, t_sph, t_flat)
    pdf = torch.where(is_sph, pdf_sph, pdf_flat)
    front = torch.where(is_sph, front_sph, front_flat) & (ltype >= 0)

    safe_t = torch.where(t_max == 0.0, 1.0, t_max)
    wi = d / safe_t[:, None]
    le = torch.where(front[:, None], le, 0.0)
    return LightSample(wi=wi, t_max=t_max, pdf=pdf, le=le)


def area_light_le(scene, light_idx, wo, ns):
    """Emitted radiance toward ``wo`` from a hit emitter — one-sided
    (reference: Src/light.h:62-69 returns 0 when dot(wo, ns) < 0).

    ``light_idx``: (N,) rows (-1 = not an emitter); ``wo``: (N, 3) direction
    from the surface back along the ray; ``ns``: (N, 3) shading normal.
    """
    li = torch.clamp(light_idx, min=0).to(torch.int64)
    le = take_rows(scene.al_le, li)
    on = (light_idx >= 0) & (dot(wo, ns) > 0.0)
    return torch.where(on[:, None], le, 0.0)


def sample_delta_light(scene, light_idx, position) -> LightSample:
    """Sample one delta light per lane (no randomness needed).

    Point light: wi toward the light, pdf = distance^2, Le = color*intensity
    (Src/light.cpp:115-128). Distant light: wi = -travel dir, pdf = 1,
    t_max = INF (Src/light.cpp:130-142). A row below 0 gives Le = 0.
    """
    li = torch.clamp(light_idx, min=0).to(torch.int64)
    dtype = torch.where(light_idx >= 0, scene.dl_type[li], -1)
    lpos = scene.dl_pos[li]
    ldir = scene.dl_dir[li]
    le = scene.dl_color[li] * scene.dl_intensity[li][:, None]

    d = lpos - position
    dist = length(d)
    safe = torch.where(dist == 0.0, 1.0, dist)
    wi_point = d / safe[:, None]
    pdf_point = dist * dist

    is_point = dtype == DL_POINT
    wi = torch.where(is_point[:, None], wi_point, -ldir)
    t_max = torch.where(is_point, dist, INF)
    pdf = torch.where(is_point, pdf_point, 1.0)
    le = torch.where((dtype >= 0)[:, None], le, 0.0)
    return LightSample(wi=wi, t_max=t_max, pdf=pdf, le=le)


def light_power_weights(scene):
    """Per-row emitted power of the area-light table as a CONCRETE float64
    numpy array — built once on the host (one read-back of the light
    table), the way the reference constructs its
    ``DiscreteEmpiricalDistribution1D`` up front (Src/sampler.h:53-70). Power = mean(Le) * area * pi (the Lambert
    emitter constant cancels in the normalization but keeps the numbers
    physical): triangle area = |Ng|/2, quad = |Ng| (Ng is the unnormalized
    cross(e1, e2)), sphere = 4 pi r^2. Invalid rows weigh 0."""
    lt = scene.al_type.cpu().numpy()
    le = scene.al_le.cpu().numpy().astype(np.float64).mean(axis=1)
    a_flat = np.linalg.norm(
        scene.al_ng.cpu().numpy().astype(np.float64), axis=1
    )
    r = scene.al_radius.cpu().numpy().astype(np.float64)
    area = np.where(
        lt == AL_TRIANGLE, 0.5 * a_flat,
        np.where(lt == AL_SPHERE, 4.0 * np.pi * r * r, a_flat),
    )
    return np.where(lt >= 0, le * area * np.pi, 0.0)


def pick_uniform_light(n_lights, u):
    """Uniform light selection index + its 1/n probability
    (reference: Src/scene.cpp:182-188 ``sampleAreaLight``). ``n_lights`` is a
    static Python int (from ``scene_statics``)."""
    idx = torch.clamp((u * n_lights).to(torch.int32), max=n_lights - 1)
    return idx, 1.0 / n_lights


def light_pdf_for_direction(scene, light_idx, position, wi, t_hit):
    """Solid-angle pdf that ``sample_area_light`` would have assigned to the
    direction ``wi`` from ``position`` hitting light ``light_idx`` at
    distance ``t_hit`` — the MIS counterpart pdf for BSDF-sampled emitter
    hits. Follows the same conventions as ``sample_area_light``:

      triangle: 2 t^2 / |wi . Ng|   (Ng unnormalized, from pdf=2t^3/|d.Ng|)
      quad:       t^2 / |wi . Ng|
      sphere:   1 / (2 pi (1 - cos_theta_max)) from ``position``

    Rows with ``light_idx < 0`` return 0.
    """
    li = torch.clamp(light_idx, min=0).to(torch.int64)
    ltype = torch.where(light_idx >= 0, scene.al_type[li], -1)
    ng = scene.al_ng[li]
    center = scene.al_center[li]
    radius = scene.al_radius[li]

    denom = torch.abs(dot(wi, ng))
    denom = torch.where(denom == 0.0, 1.0, denom)
    t2 = t_hit * t_hit
    pdf_flat = torch.where(ltype == AL_TRIANGLE, 2.0 * t2, t2) / denom

    dz_len2 = dot(center - position, center - position)
    safe_len2 = torch.where(dz_len2 == 0.0, 1.0, dz_len2)
    sin_tm2 = radius * radius / safe_len2
    cos_tm = torch.sqrt(torch.clamp(1.0 - sin_tm2, min=0.0))
    pdf_sph = 1.0 / (PI_MUL_2 * torch.clamp(1.0 - cos_tm, min=1e-12))

    pdf = torch.where(ltype == AL_SPHERE, pdf_sph, pdf_flat)
    return torch.where(ltype >= 0, pdf, 0.0)
