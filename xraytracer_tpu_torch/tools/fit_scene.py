"""Inverse rendering demo: recover material albedos and lamp emission of
the Cornell box from target renders by gradient descent.

PyTorch counterpart of ``xraytracer_tpu/tools/fit_scene.py``: the
differentiable surface path (``diff.py``) end to end.

Estimator note: the path integrator samples directions from the COSINE
hemisphere and lights uniformly; neither distribution depends on albedo or
Le, so the detached-sampling gradient is an unbiased estimator of the
gradient of the expected image and plain stochastic descent converges.
Where the scene qualifies (on the card: triangles, Lambert, flat lights),
each step takes the analytic forward-pass gradient of one launch of the
kernel K5 per sample (``diff.try_make_fast_value_and_grad``); otherwise
autograd runs through the wavefront integrator over ``spp`` renders.

Usage:
    python -m xraytracer_tpu_torch.tools.fit_scene --steps 80 -o fit.npz
    python -m xraytracer_tpu_torch.tools.fit_scene --device cpu --steps 150 \\
        --width 24 --height 18
"""

import argparse
import time

import numpy as np
import torch


def fit(
    width=32, height=24, steps=300, lr=0.1, max_depth=2, spp=2,
    target_spp=16, seed=0, verbose=False, device=None, stats=None,
):
    """Run the demo. Returns (loss_history, fitted_params, true_params), the
    params as numpy. A dict passed as ``stats`` receives "route" ("analytic"
    or "autograd"), "step_seconds" (each step, ended by a device
    synchronisation), "n_rejected" (lanes of the target's and the steps'
    renders with a NaN, Inf or negative channel) and "grads_finite"."""
    from ..camera import PinholeCamera
    from ..device import resolve_device
    from ..diff import (
        make_radiance_fn,
        try_make_fast_value_and_grad,
        value_and_grad,
    )
    from ..renderer import pixel_grid
    from ..scene.builder import scene_statics
    from ..scene.presets import build_cornell_box, cornell_camera

    device = resolve_device(device)
    tables = build_cornell_box().build(device)
    statics = scene_statics(tables)
    camera = PinholeCamera.make(width / height, device=device, **cornell_camera())
    pixel_ids, pixel_xy = pixel_grid(width, height, device=device)
    radiance = make_radiance_fn(
        tables, statics, camera, width, height, max_depth=max_depth,
        seed=seed,
    )
    true_params = {
        "mat_albedo": tables.mat_albedo.cpu().numpy(),
        "al_le": tables.al_le.cpu().numpy(),
    }
    rejected = []

    def rejects(img):
        rejected.append((~torch.isfinite(img) | (img < 0.0)).any(dim=-1).sum())

    def render_avg(params, sample_base, count):
        out = torch.zeros((pixel_ids.shape[0], 3), device=device)
        for k in range(count):
            img = radiance(params, pixel_ids, pixel_xy, sample_base + k)
            rejects(img.detach())
            out = out + img
        return out / count

    # target rendered once, well averaged, from the TRUE scene at a sample
    # block strictly above every optimization step's stream (steps use
    # indices < steps * spp): sharing a stream would let the optimizer fit
    # the target's residual noise
    with torch.no_grad():
        img_t = render_avg(
            {"mat_albedo": tables.mat_albedo, "al_le": tables.al_le},
            steps * spp, target_spp,
        )

    # the analytic route when the scene qualifies; the averaged
    # single-sample losses keep a Var(img)/spp term that the averaged-render
    # loss lacks, benign for these bounded surface parameters
    fast_step = try_make_fast_value_and_grad(
        tables, statics, camera, width, height, max_depth=max_depth,
        nee=True, cosine_sampling=True, seed=seed,
    )

    def loss_of(params, s):
        img = render_avg(params, s * spp, spp)
        return torch.mean((img - img_t) ** 2)

    autograd_step = value_and_grad(loss_of)

    # blind start: every material mid-gray, lamp dim
    params = {
        "mat_albedo": torch.full_like(tables.mat_albedo, 0.5).requires_grad_(True),
        "al_le": torch.full_like(tables.al_le, 5.0).requires_grad_(True),
    }
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    history, step_s = [], []
    grads_finite = torch.ones((), dtype=torch.bool, device=device)
    for s in range(steps):
        t0 = time.perf_counter()
        if fast_step is not None:
            # average ``spp`` single-sample analytic (loss, grad) estimates
            val = torch.zeros((), device=device)
            grad = {k: torch.zeros_like(v) for k, v in params.items()}
            for k in range(spp):
                aux = {}
                v, g = fast_step(params, pixel_ids, pixel_xy, img_t,
                                 s * spp + k, aux=aux)
                rejects(aux["img"])
                val = val + v
                for key in grad:
                    grad[key] = grad[key] + g[key]
            val = val / spp
            grad = {k: g / spp for k, g in grad.items()}
        else:
            val, grad = autograd_step(params, s)
        for key, p in params.items():
            grads_finite = grads_finite & torch.isfinite(grad[key]).all()
            p.grad = grad[key]
        opt.step()
        with torch.no_grad():
            # physical ranges: albedo in [0, 1], emission nonnegative
            params["mat_albedo"].clamp_(0.0, 1.0)
            params["al_le"].clamp_(min=0.0)
        history.append(float(val))  # synchronises with the device
        step_s.append(time.perf_counter() - t0)
        if verbose and (s % 10 == 0 or s == steps - 1):
            alb_err = float(np.abs(
                params["mat_albedo"].detach().cpu().numpy()
                - true_params["mat_albedo"]).mean())
            le_err = float(np.abs(
                params["al_le"].detach().cpu().numpy()
                - true_params["al_le"]).mean())
            print(f"step {s:3d}  loss {history[-1]:.5f}  albedo MAE "
                  f"{alb_err:.4f}  Le MAE {le_err:.3f}", flush=True)
    fitted = {k: v.detach().cpu().numpy() for k, v in params.items()}
    if stats is not None:
        stats.update(
            route="analytic" if fast_step is not None else "autograd",
            step_seconds=step_s,
            n_rejected=int(sum(int(r) for r in rejected)),
            grads_finite=bool(grads_finite),
        )
    return history, fitted, true_params


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    p.add_argument("-o", "--out", default=None,
                   help="save fitted + true params to this .npz")
    a = p.parse_args(argv)
    stats = {}
    hist, fitted, true_params = fit(
        width=a.width, height=a.height, steps=a.steps, lr=a.lr, spp=a.spp,
        verbose=True, device=a.device, stats=stats,
    )
    alb_err = np.abs(fitted["mat_albedo"] - true_params["mat_albedo"]).mean()
    print(f"loss {np.mean(hist[:5]):.5f} -> {np.mean(hist[-5:]):.5f}, "
          f"albedo MAE {alb_err:.4f} ({stats['route']} gradients, "
          f"{np.median(stats['step_seconds']):.4f} s per step)")
    if a.out:
        np.savez(a.out, loss=np.asarray(hist),
                 **{f"fit_{k}": v for k, v in fitted.items()},
                 **{f"true_{k}": v for k, v in true_params.items()})
        print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
