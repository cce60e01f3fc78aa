"""Surface integrators: Normal, Furnace, Direct, Indirect/GI, Whitted.

PyTorch counterpart of ``xraytracer_tpu/integrators/surface.py`` and of the
reference's recursive/iterative per-ray integrators (reference:
Src/integrator.h:22-398). Every integrator is a factory closing over the
scene tables and scene statics; the returned ``integrate(rays, keys) ->
(N, 3)`` runs the whole wavefront through a Python loop over bounce index
with per-lane active masks — break becomes mask-kill, Russian roulette
becomes masked kill + throughput boost (SURVEY.md §7).

RNG site layout: each bounce reserves ``SITES_PER_BOUNCE`` sites; within a
bounce, site 0 is RR, 1 is the BSDF 2-uniform, 2 the BSDF lobe choice, and
16+i the i-th light sample.
"""

import numpy as np
import torch

from ..constants import SHADOW_BIAS
from ..geometry import Rays, intersect_scene, occluded
from ..geometry.intersect import tables_present
from ..lights import (
    area_light_le,
    light_pdf_for_direction,
    light_power_weights,
    pick_uniform_light,
    sample_area_light,
    sample_delta_light,
)
from ..materials import bsdf_pdf_direct, eval_bsdf_direct, sample_bsdf_direct
from ..math import dot, local_to_world, world_to_local
from ..sampling import (
    SITES_PER_BOUNCE,
    DiscreteDistribution1D,
    uniform1,
    uniform2,
)

_SITE_RR = 0
_SITE_BSDF = 1
_SITE_LOBE = 2
_SITE_LIGHT0 = 16
_THIRD = 1.0 / 3.0   # a Python float: rounded to float32 where it multiplies

STAT_KEYS = ("rays", "shadow_rays", "rr_killed", "emitter_hits", "active_out")


def _obj_light(scene, obj):
    """Object id -> area-light row (-1 = none), the ``hasAreaLight`` check
    (reference: Src/primitive.h:56-58)."""
    row = scene.obj_light[torch.clamp(obj, min=0).to(torch.int64)]
    return torch.where(obj >= 0, row, torch.full_like(row, -1))


def make_normal_integrator(scene, tri_fn=None):
    """Normal visualization 0.5*(ns+1) (reference: Src/integrator.h:22-36).
    Black on miss."""
    present = tables_present(scene)

    def integrate(rays: Rays, keys):
        hit = intersect_scene(scene, rays, tri_fn=tri_fn, present=present)
        viz = 0.5 * (hit.ns + 1.0)
        return torch.where(hit.hit[:, None], viz, torch.zeros_like(viz))

    return integrate


def make_furnace_integrator(scene, tri_fn=None, cosine_sampling=False):
    """The reference's latent furnace test (dead code at
    Src/integrator.h:59-66), resurrected live: one BSDF sample, returns
    fr * cos / pdf whose expectation is the albedo — the analytic
    correctness gate for sampler + BSDF plumbing (SURVEY.md §4a)."""
    present = tables_present(scene)

    def integrate(rays: Rays, keys):
        hit = intersect_scene(scene, rays, tri_fn=tri_fn, present=present)
        wo = world_to_local(-rays.d, hit.dpdu, hit.ns, hit.dpdv)
        u2 = uniform2(keys, _SITE_BSDF)
        ul = uniform1(keys, _SITE_LOBE)
        bs = sample_bsdf_direct(
            hit.mtype, hit.albedo, hit.ior, wo, u2, ul, cosine_sampling
        )
        return torch.where(hit.hit[:, None], bs.weight, torch.zeros_like(bs.weight))

    return integrate


def _nee_area_lights(
    scene, statics, hit, d_in, throughput, keys, site0, tri_fn,
    active, mis=False, cosine_sampling=False, nee_mode="all", pick_dist=None,
    present=None, park=None,
):
    """Per-vertex NEE over area lights: the radiance it adds, throughput x
    the light samples' terms on the lanes in ``active`` (those that reach
    NEE at this vertex), zero on the others.

    ``nee_mode="all"`` (default) sums over ALL lights like the reference
    (Src/integrator.h:93-109 and 250-269: no light selection, no MIS) —
    cost O(n_lights) sweeps per bounce, fine for reference scenes
    (<= 2 lights).
    ``nee_mode="one"`` draws a single uniformly-picked light per vertex
    (contribution / pick probability — the volume NEE's strategy,
    Src/integrator.h:586-602) so many-light scenes run O(1) sweeps per
    bounce; same expectation, higher per-spp variance.
    ``nee_mode="power"`` is "one" with the pick probability proportional to
    each light's emitted power (mean Le x area) via the general
    ``DiscreteDistribution1D`` (``pick_dist``, built once by the factory) —
    same expectation, much lower variance when light powers are skewed.

    cos is clamped against the geometric normal and shadow rays start at
    position + 0.01 * ng with range tmax - 0.01, exactly as the reference.
    With ``mis`` each light sample is power-heuristic weighted against the
    BSDF pdf for the same direction (capability beyond the reference).

    ``park=(park_o, park_d)`` (the sorted wavefront's): a shadow ray whose
    contribution is already zero (a lane not in ``active``, a zero-pdf light
    sample, a light behind the surface) starts at ``park_o`` outside the
    scene with t_max = 0, so the any-hit sweep drops it before its walk and
    it keeps no chunk alive for the other lanes of its warp. The image does
    not change: ``vis`` is used only through (vis & ok) * cos, which is zero
    for every parked lane.
    """
    n_lights = statics["n_area_lights"]
    direct = torch.zeros_like(throughput)
    if nee_mode in ("one", "power") and n_lights > 0:
        u_pick = uniform1(keys, site0 + 0)
        if pick_dist is not None:
            # power-proportional selection through the general N-bin CDF
            # container (Src/sampler.h:53-97's intended many-light use):
            # bright lights are picked more often, contribution / pmf keeps
            # the estimator unbiased; zero-power lights are never picked.
            lidx, pick_prob = pick_dist.sample(u_pick)
        else:
            lidx, pick_prob = pick_uniform_light(n_lights, u_pick)
        u2 = uniform2(keys, site0 + 1)
        ls = sample_area_light(scene, lidx, hit.position, u2)
        ls = ls._replace(pdf=ls.pdf * pick_prob)
        light_iter = [(lidx, ls)]
    else:
        light_iter = None

    for i in range(n_lights if light_iter is None else 1):
        if light_iter is not None:
            lidx, ls = light_iter[i]
        else:
            lidx = torch.full_like(hit.obj, i)
            u2 = uniform2(keys, site0 + i)
            ls = sample_area_light(scene, lidx, hit.position, u2)
        ok = ls.pdf > 0.0
        cos = torch.clamp(dot(hit.ng, ls.wi), min=0.0)
        so = hit.position + hit.ng * SHADOW_BIAS
        sd = ls.wi
        tmax = ls.t_max - SHADOW_BIAS
        if park is not None:
            live = active & ok & (cos > 0.0)
            park_o, park_d = park
            so = torch.where(live[:, None], so, park_o)
            sd = torch.where(live[:, None], sd, park_d)
            tmax = torch.where(live, tmax, torch.zeros_like(tmax))
        srays = Rays(o=so, d=sd)
        vis = ~occluded(scene, srays, tmax, tri_fn=tri_fn, present=present)
        wo_l = world_to_local(-d_in, hit.dpdu, hit.ns, hit.dpdv)
        wi_l = world_to_local(ls.wi, hit.dpdu, hit.ns, hit.dpdv)
        fr = eval_bsdf_direct(hit.mtype, hit.albedo, wo_l, wi_l)
        pdf = torch.where(ok, ls.pdf, torch.ones_like(ls.pdf))
        contrib = (vis & ok)[:, None] * fr * ls.le * (cos / pdf)[:, None]
        if mis:
            p_b = bsdf_pdf_direct(hit.mtype, wo_l, wi_l, cosine_sampling)
            w = ls.pdf ** 2 / torch.clamp(ls.pdf ** 2 + p_b ** 2, min=1e-20)
            contrib = contrib * torch.where(ok, w, torch.ones_like(w))[:, None]
        direct = direct + contrib
    return torch.where(
        active[:, None], throughput * direct, torch.zeros_like(direct)
    )


def make_direct_integrator(scene, statics, tri_fn=None):
    """One-bounce direct lighting (reference: Src/integrator.h:76-120):
    emitter hit -> Le; surface -> NEE over all area lights; miss -> 0.18
    background."""
    present = tables_present(scene)

    def integrate(rays: Rays, keys):
        hit = intersect_scene(scene, rays, tri_fn=tri_fn, present=present)
        lrow = hit.light
        le = area_light_le(scene, lrow, -rays.d, hit.ns)
        is_emitter = lrow >= 0
        # unit throughput; the lanes that take the NEE term are the
        # non-emitter hits, the others take Le or the background below
        direct = _nee_area_lights(
            scene, statics, hit, rays.d, torch.ones_like(le), keys,
            _SITE_LIGHT0, tri_fn, hit.hit & ~is_emitter, present=present,
        )
        out = torch.where(is_emitter[:, None], le, direct)
        return torch.where(hit.hit[:, None], out, torch.full_like(le, 0.18))

    return integrate


def make_path_integrator(
    scene, statics, max_depth, nee=True, le_depth0_only=None,
    cosine_sampling=False, tri_fn=None, mis=False, with_stats=False,
    nee_mode="all", fused="auto", sort_rays="auto", pick_weights=None,
    present=None,
):
    """Indirect (``nee=False``) and GI (``nee=True``) path tracing
    (reference: Src/integrator.h:122-190 and 198-291).

    Reference semantics preserved: RR on mean throughput for depth > 0
    BEFORE the emitter check; emitter hits terminate the path; with NEE the
    emitter contributes only at depth 0 (no MIS, Src/integrator.h:236-244);
    without NEE it contributes at every depth; background is black;
    re-origin at +0.01*ng (flipped for glass transmission — live Mirror /
    Glass materials are an extension, see materials.py).

    ``mis=True`` (beyond the reference): NEE and BSDF light hits are
    combined with the power heuristic — emitter hits contribute at every
    depth, weighted against the light pdf for the sampled direction; light
    samples are weighted against the BSDF pdf. Lower variance than either
    strategy alone, unbiased.

    ``with_stats`` (SURVEY.md §5 metrics): ``integrate`` returns
    ``(radiance, stats)`` where stats maps each per-bounce counter
    ("rays", "shadow_rays", "rr_killed", "emitter_hits", "active_out")
    to a ``(max_depth,)`` int32 tensor summed over the wavefront — the
    renderer accumulates these across spp into ``RenderResult.stats``.

    ``fused="auto"`` (the default) hands an eligible scene on the card
    (triangles, Lambert, flat area lights; ``megakernel._eligible``) to the
    whole-path kernel: the returned ``integrate`` then runs every bounce in
    one launch, and carries ``fused_spec`` so that ``WavefrontRenderer`` can
    go one step further and run whole chunks of samples in one launch. Any
    other value (``"never"``, ``"off"``, ``False``) keeps the composable
    wavefront route below, as do ``tri_fn``, ``with_stats``, ``mis`` and
    tables on the CPU.

    ``sort_rays`` (scheduling, not an estimator change; see
    ``geometry/raysort.py``): re-sort the wavefront before every bounce
    after the first by (direction octant | origin Morton), park dead lanes
    and dead shadow rays outside the scene, and scatter the radiance back to
    lane order at the end, so that the sweeps' culled warp walk stays
    effective on incoherent bounce and shadow rays. Images are bitwise
    identical with it on or off. "auto" = on for a table of more than 4096
    real triangles (where the fused route's row gate sends a scene to this
    route) at ``max_depth > 1``.

    ``present``: ``tables_present(scene)`` when the caller has it (one that
    makes a factory per call on tables whose object ids stay the same, as
    ``diff.make_radiance_fn`` does); None resolves it here.
    """
    if mis:
        nee = True
        le_depth0_only = False
    if le_depth0_only is None:
        le_depth0_only = nee

    if (
        fused == "auto" and tri_fn is None and not with_stats and not mis
        and nee_mode in ("all", "one", "power")
    ):
        from .megakernel import try_make_fused_path_integrator

        spec = dict(
            scene=scene, statics=statics, max_depth=max_depth, nee=nee,
            le_depth0_only=le_depth0_only, cosine_sampling=cosine_sampling,
            nee_mode=nee_mode, pick_weights=pick_weights,
        )
        fi = try_make_fused_path_integrator(**spec)
        if fi is not None:
            # advertise the whole-render kernel to WavefrontRenderer, which
            # owns the camera and the seed
            fi.fused_spec = spec
            return fi

    n_lights = statics["n_area_lights"]
    if present is None:
        present = tables_present(scene)
    pick_dist = None
    if nee and nee_mode == "power" and n_lights > 0:
        # the pick distribution is a SAMPLING choice, detached from the
        # estimator; built once from concrete weights (the caller's, or the
        # tables' emitted power)
        if pick_weights is not None:
            w = np.asarray(pick_weights)[:n_lights]
        else:
            w = light_power_weights(scene)[:n_lights]
        pick_dist = DiscreteDistribution1D(w, device=scene.al_type.device)

    if sort_rays == "auto":
        sort_on = max_depth > 1 and int((scene.tri_obj >= 0).sum()) > 4096
    else:
        sort_on = bool(sort_rays) and max_depth > 1
    park = None
    if sort_on:
        from ..geometry.raysort import coherence_key, scene_bounds

        lo, hi = scene_bounds(scene)
        ext = torch.clamp(hi - lo, min=1e-30)
        inv_ext = 1.0 / ext
        park = (hi + 10.0 * ext,
                torch.tensor([1.0, 0.0, 0.0], device=hi.device))

    def integrate(rays: Rays, keys):
        n = rays.o.shape[0]
        dev = rays.o.device
        radiance = torch.zeros((n, 3), device=dev)
        throughput = torch.ones((n, 3), device=dev)
        o, d = rays.o, rays.d
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_pdf = torch.ones((n,), device=dev)
        prev_delta = torch.zeros((n,), dtype=torch.bool, device=dev)
        lane = torch.arange(n, device=dev) if sort_on else None
        stat_rows = []

        for depth in range(max_depth):
            if sort_on and depth > 0:
                # every per-lane quantity travels with its lane (stable, so
                # equal keys keep their order)
                perm = torch.argsort(
                    coherence_key(o, d, active, lo, inv_ext), stable=True)
                (radiance, throughput, o, d, active, prev_pdf, prev_delta,
                 keys, lane) = (
                    a[perm] for a in (radiance, throughput, o, d, active,
                                      prev_pdf, prev_delta, keys, lane))
            n_in = active.sum() if with_stats else None
            site = depth * SITES_PER_BOUNCE
            hit = intersect_scene(
                scene, Rays(o=o, d=d), tri_fn=tri_fn, present=present
            )

            # miss -> black background, kill (Src/integrator.h:216-221)
            active = active & hit.hit

            # Russian roulette for depth > 0 (Src/integrator.h:224-231)
            if depth > 0:
                # the mean throughput; order: ((r + g) + b) * f32(1 / 3), as
                # the kernels and the card's torch.mean compute it (the
                # CPU's torch.mean divides by 3). minimum / maximum, not
                # clamp: at an exact tie (a white albedo of 1 keeps the mean
                # at 1) their derivative is 1/2, as jnp.minimum's and the
                # analytic-gradient kernel's; clamp's is 1
                mean_t = (
                    (throughput[:, 0] + throughput[:, 1]) + throughput[:, 2]
                ) * _THIRD
                rr_prob = torch.minimum(mean_t, torch.ones_like(mean_t))
                u_rr = uniform1(keys, site + _SITE_RR)
                # active-masked so the stats counter only counts real kills
                killed = active & (u_rr >= rr_prob)
                active = active & ~killed
                floor = torch.full_like(rr_prob, 1e-12)
                throughput = torch.where(
                    active[:, None],
                    throughput / torch.maximum(rr_prob, floor)[:, None],
                    throughput,
                )
            else:
                killed = torch.zeros_like(active)

            # emitter hit (Src/integrator.h:234-245)
            lrow = hit.light
            is_emitter = active & (lrow >= 0)
            le = area_light_le(scene, lrow, -d, hit.ns)
            if mis:
                # power-heuristic weight vs. the NEE pdf for this direction
                if depth > 0:
                    p_l = light_pdf_for_direction(scene, lrow, o, d, hit.t)
                    w_b = prev_pdf ** 2 / torch.clamp(
                        prev_pdf ** 2 + p_l ** 2, min=1e-20
                    )
                    w_b = torch.where(prev_delta, torch.ones_like(w_b), w_b)
                    le = le * w_b[:, None]
                add_le = is_emitter
            elif le_depth0_only and depth > 0:
                add_le = torch.zeros_like(is_emitter)
            else:
                add_le = is_emitter
            radiance = radiance + torch.where(
                add_le[:, None], throughput * le, torch.zeros_like(le)
            )
            active = active & ~is_emitter

            # NEE (Src/integrator.h:250-269)
            n_nee = active.sum() if with_stats else None
            if nee and n_lights > 0:
                radiance = radiance + _nee_area_lights(
                    scene, statics, hit, d, throughput, keys,
                    site + _SITE_LIGHT0, tri_fn, active,
                    mis=mis, cosine_sampling=cosine_sampling,
                    nee_mode=nee_mode, pick_dist=pick_dist, present=present,
                    park=park,
                )

            # BSDF bounce (Src/integrator.h:271-283)
            wo_l = world_to_local(-d, hit.dpdu, hit.ns, hit.dpdv)
            u2 = uniform2(keys, site + _SITE_BSDF)
            ul = uniform1(keys, site + _SITE_LOBE)
            bs = sample_bsdf_direct(
                hit.mtype, hit.albedo, hit.ior, wo_l, u2, ul, cosine_sampling
            )
            wi = local_to_world(bs.wi, hit.dpdu, hit.ns, hit.dpdv)
            throughput = torch.where(
                active[:, None], throughput * bs.weight, throughput
            )
            # dead lanes from zero-weight bounces die too
            active = active & (throughput > 0.0).any(dim=-1)
            incoming_sign = -torch.sign(dot(d, hit.ng))
            sign = torch.where(bs.flip_side, -incoming_sign, incoming_sign)
            o = torch.where(
                active[:, None],
                hit.position + (sign * SHADOW_BIAS)[:, None] * hit.ng,
                o,
            )
            d = torch.where(active[:, None], wi, d)
            if sort_on:
                # dead lanes park outside the bounds pointing away: their
                # warps (sorted last) reject every chunk at the group boxes
                o = torch.where(active[:, None], o, park[0])
                d = torch.where(active[:, None], d, park[1])
            prev_pdf = torch.where(active, bs.pdf, prev_pdf)
            prev_delta = torch.where(active, bs.is_delta, prev_delta)
            if with_stats:
                n_shadow = n_lights if nee else 0
                if nee_mode in ("one", "power") and n_shadow > 1:
                    n_shadow = 1  # one shadow ray per vertex in this mode
                stat_rows.append(torch.stack([
                    n_in,
                    n_nee * n_shadow,
                    killed.sum(),
                    is_emitter.sum(),
                    active.sum(),
                ]).to(torch.int32))

        if sort_on:
            # each lane's radiance back to its own slot: pixel order, bitwise
            # the unsorted route's
            radiance = torch.zeros_like(radiance).index_copy(0, lane, radiance)
        if with_stats:
            stats = torch.stack(stat_rows) if stat_rows else torch.zeros(
                (0, len(STAT_KEYS)), dtype=torch.int32, device=dev
            )
            return radiance, {k: stats[:, i] for i, k in enumerate(STAT_KEYS)}
        return radiance

    integrate.sort_rays = sort_on
    return integrate


_SKY = np.array([0.235294, 0.67451, 0.843137], np.float32)


def make_whitted_integrator(scene, statics, max_depth=3, tri_fn=None):
    """Whitted-style tracing (reference: Src/integrator.h:294-398).

    The reference's BFS ray queue becomes a single wavefront ray per lane:
    Lambert terminates with delta-light NEE; Metals reflect (throughput
    x0.8); Glass picks reflect/refract stochastically by Fresnel weight
    (throughput x0.9) — the queue's both-branch splitting
    (Src/integrator.h:355-381) replaced by unbiased one-sample selection,
    which averages to the same image over spp. Sky color on miss and on
    depth overflow (Src/integrator.h:317-320,385-389). Reference quirks kept:
    shadow bias 0.1 (not 0.01), shadow range t_max (not t_max - bias), NEE
    cos against the SHADING normal (Src/integrator.h:334-339). One Python
    loop over the ``max_depth + 1`` hits, whatever the depth.
    """
    present = tables_present(scene)
    n_delta = statics["n_delta_lights"]

    def integrate(rays: Rays, keys):
        n = rays.o.shape[0]
        dev = rays.o.device
        sky = torch.from_numpy(_SKY).to(dev)
        radiance = torch.zeros((n, 3), device=dev)
        throughput = torch.ones((n, 3), device=dev)
        o, d = rays.o, rays.d
        active = torch.ones((n,), dtype=torch.bool, device=dev)

        for depth in range(max_depth + 1):
            site = depth * SITES_PER_BOUNCE
            hit = intersect_scene(
                scene, Rays(o=o, d=d), tri_fn=tri_fn, present=present
            )

            missed = active & ~hit.hit
            radiance = radiance + torch.where(
                missed[:, None], throughput * sky, 0.0
            )
            active = active & hit.hit

            # Lambert: delta-light NEE, terminate (Src/integrator.h:328-343)
            is_lambert = active & (hit.mtype == 0)
            direct = torch.zeros((n, 3), device=dev)
            wo_l = world_to_local(-d, hit.dpdu, hit.ns, hit.dpdv)
            for i in range(n_delta):
                lidx = torch.full((n,), i, dtype=torch.int32, device=dev)
                ls = sample_delta_light(scene, lidx, hit.position)
                srays = Rays(o=hit.position + hit.ng * 0.1, d=ls.wi)
                vis = ~occluded(
                    scene, srays, ls.t_max, tri_fn=tri_fn, present=present
                )
                cos = torch.clamp(dot(hit.ns, ls.wi), min=0.0)
                wi_l = world_to_local(ls.wi, hit.dpdu, hit.ns, hit.dpdv)
                fr = eval_bsdf_direct(hit.mtype, hit.albedo, wo_l, wi_l)
                pdf = torch.where(ls.pdf == 0.0, 1.0, ls.pdf)
                direct = direct + vis[:, None] * fr * ls.le * (cos / pdf)[:, None]
            radiance = radiance + torch.where(
                is_lambert[:, None], throughput * direct, 0.0
            )
            # unknown/no material also terminates (reference default: break)
            active = active & (hit.mtype >= 1)

            # Metals / Glass via the delta lobes of sample_bsdf
            u2 = uniform2(keys, site + _SITE_BSDF)
            ul = uniform1(keys, site + _SITE_LOBE)
            bs = sample_bsdf_direct(hit.mtype, hit.albedo, hit.ior, wo_l, u2, ul)
            wi = local_to_world(bs.wi, hit.dpdu, hit.ns, hit.dpdv)
            throughput = torch.where(
                active[:, None], throughput * bs.weight, throughput
            )
            incoming_sign = -torch.sign(dot(d, hit.ng))
            sign = torch.where(bs.flip_side, -incoming_sign, incoming_sign)
            o = torch.where(
                active[:, None],
                hit.position + (sign * 0.001)[:, None] * hit.ng,
                o,
            )
            d = torch.where(active[:, None], wi, d)
        # depth-overflow rays: sky (Src/integrator.h:317-320)
        return radiance + torch.where(active[:, None], throughput * sky, 0.0)

    return integrate
