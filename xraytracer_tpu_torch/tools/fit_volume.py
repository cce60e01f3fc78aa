"""Inverse VOLUME rendering demo: recover a 16^3 density blob from target
renders by gradient descent through the heterogeneous whole path.

PyTorch counterpart of ``xraytracer_tpu/tools/fit_volume.py``. Density
gradients come from the analytic two-pass route
(``het_megakernel.try_make_fused_het_value_and_grad``: pass A ``het_path``,
pass B ``het_grad_path``; on the CPU their plain versions, autograd through
the wavefront route), through its two-sample product-loss step
(``step_pair``: E[(a - t)(b - t)] over independent renders lacks the
Var(img) term that a plain L2 drives down by emptying the grid) with the
score-corrected grad-sampling estimator. Three views, one step function
each; their gradients are averaged into one Adam step (global-norm
clipping at 1, cosine schedule to 0.05 lr). The density is a sigmoid of the
optimised logits and stays a live float32 dense grid.

Usage:
    python -m xraytracer_tpu_torch.tools.fit_volume --steps 600 -o fit_vol.npz
    python -m xraytracer_tpu_torch.tools.fit_volume --device cpu --steps 3 \\
        --width 12 --height 9 --max-depth 2 --target-pairs 2
"""

import argparse
import json
import math
import time

import numpy as np
import torch

RES = 16
MAX_DEPTH = 6
EVAL_SAMPLE = 20_000   # the fixed draws of stats["eval_loss"]


def _blob_target():
    tgt = np.full((RES, RES, RES), 0.25, np.float32)
    c0, c1 = RES // 4, 3 * RES // 4
    tgt[c0:c1, c0:c1, c0:c1] = 0.85
    return tgt


def _cameras(width, height, device, dist=540.0):
    from ..camera import PinholeCamera
    from ..math import from_rows

    rows = (
        (1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 40.0, dist, 1),
        (0, 0, -1.0, 0, 0, 1.0, 0, 0, 1.0, 0, 0, 0, dist, 40.0, 0, 1),
        (1.0, 0, 0, 0, 0, 0, -1.0, 0, 0, 1.0, 0, 0, 0, dist, 0, 1),
    )
    return [PinholeCamera.make(width / height, c2w=from_rows(*r), fov_deg=55.0,
                               device=device) for r in rows]


def build_scene(device=None):
    """The demo's cloud box under one sphere light. The majorants are baked
    from a ones grid, so they bound any density in [0, 1] (the score terms
    hold the majorants fixed). Optically THIN coefficients: at the cloud's
    ~330-unit extent sigma_t = 0.005 puts the blob at tau ~ 0.8, so every
    voxel is seen from every view (sigma_t = 0.1 gives tau ~ 15: interior
    gradients vanish and descent stalls)."""
    from ..scene.presets import build_volume_scene

    return build_volume_scene(
        res=(RES, RES, RES), density=np.ones((RES, RES, RES), np.float32),
        absorption=(0.001, 0.001, 0.001), scattering=(0.004, 0.004, 0.004),
        le=120.0, light_center=(0.0, 400.0, 0.0),
    ).build(device)


def fit(width=96, height=72, steps=600, lr=0.1, max_depth=MAX_DEPTH, pairs=2,
        target_pairs=64, seed=0, verbose=False, device=None, stats=None):
    """Run the demo. Returns (loss_history, fitted_density, target_density),
    the densities as numpy; the loss of a step is the product loss it
    descends, summed over views and pairs, each on fresh streams. A dict
    passed as ``stats`` receives "step_seconds" (each step, ended by a
    device synchronisation), "mae" (the density's mean absolute error before
    the first step and after each), "eval_loss" (before each step, the L2
    error of one render per view against the TRUE blob's render with the
    same draws, summed over the views: with common random numbers most of
    the Monte-Carlo noise cancels, and the error goes to 0 as the density
    does to the blob, where the step losses' noise hides any trend),
    "n_rejected" (lanes of the target's and the steps' renders with a NaN,
    Inf or negative channel) and "grads_finite"."""
    from ..device import resolve_device
    from ..integrators.het_megakernel import try_make_fused_het_value_and_grad
    from ..renderer import pixel_grid
    from ..scene.builder import scene_statics

    device = resolve_device(device)
    tables = build_scene(device)
    statics = scene_statics(tables)
    tgt_grid = _blob_target()
    pixel_ids, pixel_xy = pixel_grid(width, height, device=device)
    force = device.type != "cuda"     # the CPU runs the plain versions

    step_fns = []
    for ci, cam in enumerate(_cameras(width, height, device)):
        st = try_make_fused_het_value_and_grad(
            tables, statics, cam, width, height, max_depth, nee=True,
            seed=seed + 1000 * ci, force=force,
        )
        if st is None:
            raise RuntimeError("fit_volume: the scene does not take the "
                               "analytic heterogeneous gradient route")
        step_fns.append(st)

    rejected = []

    def rejects(img):
        rejected.append((~torch.isfinite(img) | (img < 0.0)).any(dim=-1).sum())

    # targets: the mean of many renders of the TRUE blob by the same
    # grad-sampling forward pass, at samples above every step's
    tgt_t = torch.from_numpy(tgt_grid).to(device)
    targets = []
    for st in step_fns:
        acc = torch.zeros((pixel_ids.shape[0], 3), device=device)
        for s in range(target_pairs):
            img = st.render(tgt_t, pixel_ids, pixel_xy, 10_000 + s)
            rejects(img)
            acc = acc + img
        targets.append(acc / target_pairs)

    z = torch.zeros((RES, RES, RES), device=device, requires_grad=True)
    opt = torch.optim.Adam([z], lr=lr)
    alpha = 0.05
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))
        + alpha)

    def mae():
        return float(np.abs(torch.sigmoid(z).detach().cpu().numpy() - tgt_grid).mean())

    eval_targets = [st.render(tgt_t, pixel_ids, pixel_xy, EVAL_SAMPLE) for st in step_fns]

    def eval_loss(dens):
        out = torch.zeros((), device=device)
        for st, target in zip(step_fns, eval_targets):
            img = st.render(dens, pixel_ids, pixel_xy, EVAL_SAMPLE)
            out = out + torch.mean((img - target) ** 2)
        return out

    history, step_s, maes, evals = [], [], [mae()], []
    grads_finite = torch.ones((), dtype=torch.bool, device=device)
    for it in range(steps):
        with torch.no_grad():
            dens = torch.sigmoid(z)
        evals.append(eval_loss(dens))
        t0 = time.perf_counter()
        g_total = torch.zeros_like(z)
        loss_sum = torch.zeros((), device=device)
        for st, target in zip(step_fns, targets):
            for pr in range(pairs):
                s = 2 * (it * pairs + pr)
                aux = {}
                loss, grads = st.step_pair({"grid_density": dens}, pixel_ids,
                                           pixel_xy, target, s, s + 1, aux=aux)
                rejects(aux["img"])
                rejects(aux["img_b"])
                # the chain rule through the sigmoid
                g_total = g_total + grads["grid_density"] * (dens * (1.0 - dens))
                loss_sum = loss_sum + loss
        g_total = g_total / (len(step_fns) * pairs)
        grads_finite = grads_finite & torch.isfinite(g_total).all()
        z.grad = g_total
        torch.nn.utils.clip_grad_norm_([z], 1.0)
        opt.step()
        sched.step()
        history.append(float(loss_sum))   # synchronises with the device
        step_s.append(time.perf_counter() - t0)
        maes.append(mae())
        if verbose and (it % 25 == 0 or it == steps - 1):
            print(json.dumps({"step": it, "loss": history[-1],
                              "eval_loss": float(evals[-1]), "mae": maes[-1]}),
                  flush=True)
    if stats is not None:
        stats.update(step_seconds=step_s, mae=maes,
                     eval_loss=[float(v) for v in evals],
                     n_rejected=int(sum(int(r) for r in rejected)),
                     grads_finite=bool(grads_finite))
    return history, torch.sigmoid(z).detach().cpu().numpy(), tgt_grid


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=72)
    ap.add_argument("--max-depth", type=int, default=MAX_DEPTH)
    ap.add_argument("--target-pairs", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the plain path)")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    a = ap.parse_args(argv)
    stats = {}
    hist, fitted, tgt = fit(
        width=a.width, height=a.height, steps=a.steps, lr=a.lr,
        max_depth=a.max_depth, pairs=a.pairs, target_pairs=a.target_pairs,
        verbose=a.verbose, device=a.device, stats=stats,
    )
    c0, c1 = RES // 4, 3 * RES // 4
    n_in = (c1 - c0) ** 3
    center = float(fitted[c0:c1, c0:c1, c0:c1].mean())
    outer = float((fitted.sum() - fitted[c0:c1, c0:c1, c0:c1].sum())
                  / (fitted.size - n_in))
    print(json.dumps({
        "mae": stats["mae"][-1], "mae_start": stats["mae"][0],
        "center": center, "outer": outer, "center_target": 0.85,
        "outer_target": 0.25, "final_loss": hist[-1],
        "seconds_per_step": float(np.median(stats["step_seconds"])),
    }))
    if a.out:
        np.savez(a.out, fitted=fitted, target=tgt, history=np.asarray(hist))


if __name__ == "__main__":
    main()
