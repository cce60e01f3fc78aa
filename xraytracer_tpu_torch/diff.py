"""Differentiable rendering: gradients of radiance w.r.t. scene parameters.

PyTorch counterpart of ``xraytracer_tpu/diff.py``, surface half. The surface
path integrator is a Python loop of tensor operations, so ``torch.autograd``
differentiates it w.r.t. any ``SceneTables`` field (albedo, emission).
Discrete sampling decisions (roulette kill, light pick, lobe choice) enter
only through boolean masks, so autograd treats them as detached and
differentiates the continuous integrand factors alone (the
detached-sampling estimator).

Two routes to ``(loss, grads)``:

* autograd (``make_loss_fn`` / ``make_train_step`` / ``value_and_grad``)
  through the wavefront integrator. On the card its nearest-hit sweep is
  ``kernels.SweepStopGrad`` (the K2 kernel, zero gradients for rays and
  geometry) and its shadow sweep the any-hit kernel K4 with detached inputs
  (``detached_ok``); ``geometry_grads=True`` and CPU tables take the matmul
  sweep ``intersect_triangles_mm``, which differentiates w.r.t. vertices.
* ``try_make_fast_value_and_grad``: the analytic forward-pass gradient, one
  launch of ``megakernel.mega_grad_path`` (K5) per sample; for a cloud box
  lit by emissive spheres, two launches per sample
  (``het_megakernel.try_make_fused_het_value_and_grad``: pass A ``het_path``,
  pass B ``het_grad_path``).

For scenes with media, ``make_radiance_fn`` differentiates the volume
integrator (``make_volume_integrator(differentiable=True)``) w.r.t.
``med_sigma_a`` / ``med_sigma_s`` / ``al_le`` / ``grid_density``.
"""

import torch

from .geometry.intersect import tables_present
from .integrators import make_path_integrator, make_volume_integrator
from .renderer import CAMERA_SITE
from .sampling import path_keys, uniform2


def _diff_tri_fn(geometry_grads=False, device=None):
    """Triangle sweep for autograd pipelines: the stopgrad K2 sweep for
    tables on the card; the matmul sweep, whose outputs differentiate
    w.r.t. vertex positions too, on the CPU or with ``geometry_grads``."""
    from .geometry.intersect import intersect_triangles_mm

    if geometry_grads or device is None or torch.device(device).type != "cuda":
        return intersect_triangles_mm
    from .geometry.kernels import sweep_nearest_stopgrad_tri_fn

    return sweep_nearest_stopgrad_tri_fn


def make_radiance_fn(
    tables, statics, camera, width, height, max_depth=3, nee=True,
    cosine_sampling=True, seed=0, geometry_grads=False, tri_fn=None,
    nee_mode="all", max_steps=None, score_terms=False, grad_sampling=False,
):
    """Returns ``radiance(params, pixel_ids, pixel_xy, sample_idx) -> (N,3)``
    where ``params`` is a dict of SceneTables overrides (e.g.
    ``{"mat_albedo": ..., "al_le": ...}``), the differentiable inputs.

    A ``tri_fn`` is always passed to the integrator, so it never takes the
    whole-path kernel K1, which has no gradient. A scene with media renders
    through ``make_volume_integrator(differentiable=True)`` with ``nee``,
    ``max_steps``, ``score_terms`` and ``grad_sampling`` (the surface options
    do not apply there)."""
    dev = tables.tri_v0.device
    wh = torch.tensor([float(width), float(height)], device=dev)
    if tri_fn is None:
        tri_fn = _diff_tri_fn(geometry_grads, dev)
    pick_w = None
    if nee_mode == "power":
        # the pick distribution bakes from the CONCRETE base tables (as the
        # analytic kernel's does): it is a detached sampling choice, and
        # overridden tables that carry gradients cannot be read back
        from .lights import light_power_weights

        pick_w = light_power_weights(tables)
    # the scene's masks and table flags, made once: ``params`` holds
    # differentiable (float) fields, never the object ids they are made of
    present = tables_present(tables)

    def radiance(params, pixel_ids, pixel_xy, sample_idx):
        from .scene.tables import rejoin_appearance

        # re-derive the denormalized per-triangle appearance columns from
        # the overridden relational params so gradients reach them
        scene = rejoin_appearance(tables._replace(**params))
        if statics["has_media"]:
            integrate = make_volume_integrator(
                scene, statics, max_depth, nee=nee, max_steps=max_steps,
                tri_fn=tri_fn, differentiable=True, score_terms=score_terms,
                grad_sampling=grad_sampling, present=present,
            )
        else:
            integrate = make_path_integrator(
                scene, statics, max_depth, nee=nee,
                cosine_sampling=cosine_sampling, tri_fn=tri_fn,
                nee_mode=nee_mode, pick_weights=pick_w, present=present,
            )
        keys = path_keys(seed, pixel_ids, sample_idx)
        u = uniform2(keys, CAMERA_SITE)
        rays = camera.sample_rays((pixel_xy + u) / wh)
        return integrate(rays, keys)

    return radiance


def make_loss_fn(radiance_fn):
    """L2 image loss against a target; mean over lanes and channels."""

    def loss(params, pixel_ids, pixel_xy, target, sample_idx):
        img = radiance_fn(params, pixel_ids, pixel_xy, sample_idx)
        return torch.mean((img - target) ** 2)

    return loss


def value_and_grad(fn):
    """``fn(params, *args) -> scalar`` to ``(value, grads)`` with one
    gradient per key of ``params`` (the counterpart of
    ``jax.value_and_grad`` for a dict of tensors)."""

    def vg(params, *args):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        val = fn(leaves, *args)
        gs = torch.autograd.grad(val, list(leaves.values()))
        return val.detach(), dict(zip(leaves, gs))

    return vg


def make_train_step(radiance_fn, lr=0.05):
    """One SGD step on the differentiable scene params, on one device."""
    grad_fn = value_and_grad(make_loss_fn(radiance_fn))

    def step(params, pixel_ids, pixel_xy, target, sample_idx):
        val, g = grad_fn(params, pixel_ids, pixel_xy, target, sample_idx)
        new = {k: (v.detach() - lr * g[k]) for k, v in params.items()}
        return val, new, g

    return step


def try_make_fast_value_and_grad(
    tables, statics, camera, width, height, max_depth=3, nee=True,
    cosine_sampling=True, seed=0, force=False, le_grads=False,
    nee_mode="all",
):
    """Forward-pass ANALYTIC value and gradient of the L2 image loss: the
    kernel K5 (``megakernel.try_make_fused_grad_path``) accumulates per-lane
    ∂img/∂mat_albedo and ∂img/∂al_le beside the radiance, so the whole
    "forward + backward" is one launch: no tape, no transpose.

    Same call signature as ``value_and_grad(make_loss_fn(...))``:
    ``step(params, pixel_ids, pixel_xy, target, sample_idx) ->
    (loss, grads)`` with grads for ``params`` keys; a dict passed as
    ``aux`` also receives the rendered image (N, 3) under "img". "mat_albedo" (through
    the per-call rejoined ``tri_rec``) and "al_le" (through the light
    table's Le columns, written per call) are LIVE: new values take effect
    without a rebake. ``le_grads=True`` also returns ``grads["al_le"]`` when
    al_le is not among ``params``. Returns None when the scene is not
    eligible, and for tables on the CPU unless ``force`` (which runs the
    plain version). A scene K5 refuses falls through to the heterogeneous
    analytic route (``het_megakernel.try_make_fused_het_value_and_grad``,
    grads for "grid_density" and "al_le", and ``step.step_pair``), which
    returns None for scenes it does not serve either (``vpt``, a
    homogeneous box)."""
    from .integrators.megakernel import try_make_fused_grad_path
    from .scene.tables import rejoin_appearance

    fg = try_make_fused_grad_path(
        tables, statics, max_depth, nee=nee,
        cosine_sampling=cosine_sampling, force=force, nee_mode=nee_mode,
    )
    if fg is None:
        from .integrators.het_megakernel import (
            try_make_fused_het_value_and_grad,
        )

        return try_make_fused_het_value_and_grad(
            tables, statics, camera, width, height, max_depth, nee=nee,
            seed=seed, force=force,
        )
    dev = tables.tri_v0.device
    wh = torch.tensor([float(width), float(height)], device=dev)

    @torch.no_grad()
    def step(params, pixel_ids, pixel_xy, target, sample_idx, aux=None):
        rec_params = {k: v for k, v in params.items() if k != "al_le"}
        scene = rejoin_appearance(tables._replace(**rec_params))
        keys = path_keys(seed, pixel_ids, sample_idx)
        u = uniform2(keys, CAMERA_SITE)
        rays = camera.sample_rays((pixel_xy + u) / wh)
        img, galb, gle = fg(
            rays, keys, tri_rec=scene.tri_rec, al_le=params.get("al_le")
        )
        n = img.shape[0]
        loss = torch.mean((img - target) ** 2)
        r = 2.0 * (img - target) / (n * 3)
        grads = {}
        if "mat_albedo" in params:
            grads["mat_albedo"] = torch.einsum("nc,nckm->mk", r, galb)
        if le_grads or "al_le" in params:
            gl = torch.einsum("nc,ncl->lc", r, gle)
            base = params.get("al_le", tables.al_le)
            g = torch.zeros_like(base)
            g[: gl.shape[0]] = gl
            grads["al_le"] = g
        if aux is not None:
            aux["img"] = img
        return loss, grads

    return step
