"""Volumetric path tracing, with and without NEE.

PyTorch counterpart of ``xraytracer_tpu/integrators/volume.py`` and of
``VolumePathTracing`` / ``VolumePathTracingNEE`` (reference:
Src/integrator.h:401-478, 481-636). The reference's
``while (depth < maxDepth)`` loop only advances ``depth`` on a real
in-scatter event — boundary escapes re-intersect without incrementing — so
the wavefront loop runs ``2 * max_depth + 2`` fixed iterations (enough for
scatter/escape alternation through one medium box, the reference's scene
shape) with a per-lane depth counter; lanes kill when their depth reaches
``max_depth``, mirroring the loop condition.

RNG site layout per iteration (within its SITES_PER_BOUNCE block):
  0           Russian roulette
  16..        sampleMedium tracking loop (max_steps * SITES_PER_STEP sites)
  P           NEE light pick, where P = max(8192, 16 + max_steps*SITES_PER_STEP)
  P+1         NEE light-sample 2-uniform
  P+16..      NEE transmittance ratio-tracking loop

The NEE block floats above the tracking block as a function of ``max_steps``
(anchored at 8192 so every layout with max_steps <= 2044 — all goldens — is
bit-identical to the historical fixed layout).

Routes on the card (``fused="auto"``, the default): one homogeneous box with
a few flat triangles goes to the whole-path kernel of ``vol_megakernel.py``
(``kind="volume"``); a heterogeneous cloud box with emissive sphere lights
(the ``nee`` and ``volume`` presets) goes to the whole-path kernel of
``het_megakernel.py`` (``kind="het_volume"``). Any other scene with a
heterogeneous medium, and any scene under ``tri_fn`` or ``with_stats``,
keeps the wavefront loop below with the tracking kernels of
``media_kernels.py`` in place of the host-side tracking loops. Under
``differentiable`` every scene keeps the wavefront loop with the host-side
tracking loops (no kernel has a reverse mode), and under ``grad_sampling``
the homogeneous box does too (its kernel has no such estimator).
"""

import warnings

import torch

from ..geometry import Rays, intersect_scene
from ..geometry.intersect import tables_present
from ..lights import area_light_le, pick_uniform_light, sample_area_light
from ..media import (
    SITES_PER_STEP,
    _score_ratio,
    default_max_steps,
    eval_phase,
    sample_medium,
    segment_transmittance,
)
from ..sampling import SITES_PER_BOUNCE, uniform1, uniform2

_SITE_RR = 0
_SITE_MEDIUM = 16
_THIRD = 1.0 / 3.0   # a Python float: rounded to float32 where it multiplies

STAT_KEYS = ("rays", "rr_killed", "emitter_hits", "scattered", "active_out")


def _nee_site_layout(max_steps):
    """NEE RNG site offsets for a given tracking-step bound.

    Anchored at 8192 (the historical fixed offset) so layouts for
    max_steps <= 2044 are unchanged; larger bounds float the NEE block up.
    Raises a sized ValueError when the per-bounce site budget is exceeded.
    """
    pick = max(8192, _SITE_MEDIUM + max_steps * SITES_PER_STEP)
    tr = pick + 16
    if tr + max_steps > SITES_PER_BOUNCE:
        limit = (SITES_PER_BOUNCE - _SITE_MEDIUM - 16) // (SITES_PER_STEP + 1)
        raise ValueError(
            f"max_steps={max_steps} exceeds the per-bounce RNG site budget "
            f"(SITES_PER_BOUNCE={SITES_PER_BOUNCE} allows at most "
            f"{limit} tracking steps); pass a smaller max_steps or reduce "
            "the medium majorant / grid extent"
        )
    return pick, pick + 1, tr


def make_volume_integrator(
    scene, statics, max_depth, nee=False, max_steps=None, tri_fn=None,
    n_iterations=None, differentiable=False, with_stats=False, fused="auto",
    score_terms=False, grad_sampling=False,
):
    """Factory for both volume integrators (``nee`` selects the variant).

    ``differentiable``: the whole integrator is differentiable by
    ``torch.autograd`` w.r.t. ``med_sigma_a`` / ``med_sigma_s`` / ``al_le`` /
    ``grid_density`` (the tracking loops read the dense grid; the discrete
    decisions are detached through their boolean masks). It keeps the
    wavefront loop and, without a ``tri_fn``, takes the matmul-form triangle
    sweep, which has a gradient.

    ``score_terms`` (with ``differentiable``): multiply the path weights by
    ``p / p.detach()`` for every sampled parameter-dependent decision (the
    tracking's channel pick and scatter-or-null split, the roulette;
    ``media._score_ratio``): the same values, and the gradient of the full
    score-corrected estimator d/dθ E[F] = E[dF + F ∂log p], which detached
    sampling drops. The majorant tables (``grid_super``, ``med_majorant``)
    stay fixed: keep optimised densities below the majorants baked at build
    time, or the null-collision clamp biases.

    ``grad_sampling``: the gradient-friendly estimator variant: Russian
    roulette OFF and a uniform channel pick (the reference's own noMIS
    strategy, Src/medium.h:234-277). Both changes keep the estimator
    unbiased; they remove the two decisions whose probabilities depend on
    the whole throughput history. The analytic volume gradient
    (``het_megakernel.try_make_fused_het_value_and_grad``) differentiates
    this estimator.

    ``with_stats`` (SURVEY.md §5 metrics): ``integrate`` returns
    ``(radiance, stats)`` with per-iteration int32 counters ("rays",
    "rr_killed", "emitter_hits", "scattered", "active_out"), each of shape
    ``(n_iterations,)``, summed over the wavefront.

    ``fused="auto"``: see the module docstring; any other value keeps the
    wavefront loop with the host-side tracking loops, as do tables on the
    CPU. ``tri_fn`` and ``with_stats`` keep the wavefront loop but, like the
    JAX package, still take the tracking kernels. The heterogeneous
    whole-path kernel takes ``grad_sampling`` as a launch flag (the JAX
    package does not pass it to its fused route); the homogeneous one has
    no such estimator, so ``grad_sampling`` keeps such a scene on the
    wavefront loop.
    """
    # single-kernel route (vol_megakernel.py): on the card, for eligible
    # scenes (one homogeneous box + a few flat triangles + flat area lights
    # — the reference vpt workload), the whole volume path runs in ONE
    # launch; everything else keeps the wavefront loop
    if (fused == "auto" and tri_fn is None and not with_stats
            and not differentiable and not grad_sampling):
        from .vol_megakernel import try_make_fused_volume_integrator

        spec = dict(
            scene=scene, statics=statics, max_depth=max_depth, nee=nee,
            max_steps=max_steps, n_iterations=n_iterations,
        )
        fi = try_make_fused_volume_integrator(**spec)
        if fi is not None:
            fi.fused_spec = dict(kind="volume", **spec)
            return fi

    if max_steps is None:
        max_steps = default_max_steps(scene)
    # single-kernel heterogeneous route (het_megakernel.py): on the card, a
    # cloud box with emissive sphere lights (the reference's volume.cpp /
    # nee.cpp workloads) runs its whole path in ONE launch
    if (fused == "auto" and tri_fn is None and not with_stats
            and not differentiable and statics["has_heterogeneous"]):
        from .het_megakernel import try_make_fused_het_path_integrator

        spec = dict(
            scene=scene, statics=statics, max_depth=max_depth, nee=nee,
            max_steps=max_steps, n_iterations=n_iterations,
            grad_sampling=grad_sampling,
        )
        fi = try_make_fused_het_path_integrator(**spec)
        if fi is not None:
            fi.fused_spec = dict(kind="het_volume", **spec)
            return fi
    # tracking kernels (media_kernels.py): on the card the delta-tracking
    # sample and the NEE ratio-tracking transmittance each run as ONE launch
    # per wavefront instead of a host loop over candidate steps
    het_fn = het_tr_fn = None
    if fused == "auto" and not differentiable and statics["has_heterogeneous"]:
        from ..media_kernels import (
            try_make_fused_het_sampler,
            try_make_fused_het_transmittance,
        )

        het_fn = try_make_fused_het_sampler(
            scene, max_steps, chan_uniform=grad_sampling
        )
        het_tr_fn = try_make_fused_het_transmittance(scene, max_steps)
        if het_fn is None and scene.grid_density.is_cuda:
            # the kernels serve exactly one heterogeneous medium
            warnings.warn(
                "volume integrator: this scene's heterogeneous media do not "
                "qualify for the tracking kernels; delta and ratio tracking "
                "run as host-side loops of tensor operations on the card",
                stacklevel=2,
            )
    if differentiable and tri_fn is None:
        # the sweep kernels have no reverse mode: the matmul-form sweep
        from ..geometry.intersect import intersect_triangles_mm

        tri_fn = intersect_triangles_mm
    if n_iterations is None:
        n_iterations = 2 * max_depth + 2
    site_pick, site_light, site_tr = _nee_site_layout(max_steps)
    n_lights = statics["n_area_lights"]
    present = tables_present(scene)

    def integrate(rays: Rays, keys):
        n = rays.o.shape[0]
        dev = rays.o.device
        radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
        o, d = rays.o, rays.d
        depth = torch.zeros((n,), dtype=torch.int32, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        neg1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
        stat_rows = []

        for it in range(n_iterations):
            site = it * SITES_PER_BOUNCE
            cur = Rays(o=o, d=d)

            # loop condition (Src/integrator.h:412,498)
            active = active & (depth < max_depth)
            n_in = active.sum() if with_stats else None

            hit = intersect_scene(scene, cur, tri_fn=tri_fn, present=present)
            # miss -> black background (only depth != 0 in the reference,
            # but background is 0: Src/integrator.h:425-428), kill
            active = active & hit.hit

            # Russian roulette for depth > 0 (Src/integrator.h:431-438)
            # the mean throughput; order: ((r + g) + b) * f32(1 / 3), as the
            # kernels and the card's torch.mean compute it (the CPU's
            # torch.mean divides by 3); torch.minimum / torch.maximum, whose
            # derivative at a tie is 1/2 as JAX's (torch.clamp's is 1)
            mean_t = ((throughput[:, 0] + throughput[:, 1]) + throughput[:, 2]) * _THIRD
            rr_prob = torch.minimum(mean_t, torch.ones_like(mean_t))
            u_rr = uniform1(keys, site + _SITE_RR)
            do_rr = active & (depth > 0)
            if grad_sampling:
                do_rr = torch.zeros_like(do_rr)   # RR off (see docstring)
            killed = do_rr & (u_rr >= rr_prob)
            active = active & ~killed
            boost = 1.0 / torch.maximum(rr_prob, torch.full_like(rr_prob, 1e-12))
            if score_terms:
                # the survival probability depends on the parameters through
                # the throughput: its score (lanes clamped at 1 carry none)
                boost = boost * _score_ratio(rr_prob)
            throughput = torch.where(
                (do_rr & active)[:, None],
                throughput * boost[:, None],
                throughput,
            )

            # emitter hit (Src/integrator.h:441-446; NEE variant adds Le only
            # at depth 0, Src/integrator.h:517-526)
            lrow = hit.light
            is_emitter = active & (lrow >= 0)
            le = area_light_le(scene, lrow, -d, hit.ns)
            add_le = is_emitter & (depth == 0) if nee else is_emitter
            radiance = radiance + torch.where(
                add_le[:, None], throughput * le, torch.zeros_like(le)
            )
            active = active & ~is_emitter

            # medium sampling (Src/integrator.h:449-468)
            med_idx = hit.medium
            has_med = active & (med_idx >= 0)
            ms = sample_medium(
                scene, torch.where(has_med, med_idx, neg1), cur, hit.t, hit.t1,
                throughput, keys, site + _SITE_MEDIUM, max_steps=max_steps,
                has_heterogeneous=statics["has_heterogeneous"],
                differentiable=differentiable, het_fn=het_fn,
                score_terms=score_terms, chan_uniform=grad_sampling,
            )
            scattered = has_med & ms.scattered

            # NEE at the scatter vertex (Src/integrator.h:538-567)
            if nee and n_lights > 0:
                u_pick = uniform1(keys, site + site_pick)
                lidx, pick_prob = pick_uniform_light(n_lights, u_pick)
                u2 = uniform2(keys, site + site_light)
                ls = sample_area_light(scene, lidx, ms.pos, u2)
                pdf = pick_prob * ls.pdf
                ok = scattered & (pdf > 0.0)
                # isVisible (Src/integrator.h:604-631): one intersect; a
                # surface blocks, a medium multiplies ratio-tracked
                # transmittance over its [t, t1] span, anything else passes.
                srays = Rays(o=ms.pos, d=ls.wi)
                shit = intersect_scene(scene, srays, tri_fn=tri_fn, present=present)
                s_has_surface = (shit.obj >= 0) & (shit.mtype >= 0)
                s_med = shit.medium
                t1_fin = torch.where(torch.isfinite(shit.t1), shit.t1, shit.t)
                tr = segment_transmittance(
                    scene,
                    torch.where(ok & (s_med >= 0), s_med, neg1),
                    srays.at(shit.t), srays.at(t1_fin),
                    keys, site + site_tr, max_steps=max_steps,
                    differentiable=differentiable, het_tr_fn=het_tr_fn,
                )
                visible = ok & ~s_has_surface
                f = eval_phase(
                    scene, torch.where(has_med, med_idx, torch.zeros_like(med_idx)),
                    d, ls.wi,
                )
                safe_pdf = torch.where(pdf == 0.0, torch.ones_like(pdf), pdf)
                ls_contrib = tr * f * ls.le / safe_pdf[:, None]
                radiance = radiance + torch.where(
                    visible[:, None], throughput * ms.weight * ls_contrib,
                    torch.zeros_like(ls_contrib),
                )

            # advance ray + throughput (Src/integrator.h:456-467)
            o = torch.where(has_med[:, None], ms.pos, o)
            d = torch.where(has_med[:, None], ms.dir, d)
            throughput = torch.where(
                has_med[:, None], throughput * ms.weight, throughput
            )
            depth = depth + scattered.to(torch.int32)
            # plain surface with no medium and no light: the reference would
            # loop forever (Src/integrator.h:449 never advances); kill.
            active = active & has_med
            active = active & (throughput > 0.0).any(dim=-1)
            if with_stats:
                stat_rows.append(torch.stack([
                    n_in, killed.sum(), is_emitter.sum(), scattered.sum(),
                    active.sum(),
                ]).to(torch.int32))

        if with_stats:
            stats = torch.stack(stat_rows) if stat_rows else torch.zeros(
                (0, len(STAT_KEYS)), dtype=torch.int32, device=dev
            )
            return radiance, {k: stats[:, i] for i, k in enumerate(STAT_KEYS)}
        return radiance

    return integrate
