"""Plain reference of the density-fitting step on the cloud: the loss, the
images and the density gradient of the two-sample product loss, by
``torch.autograd`` through the plain cloud estimator, and Adam over the
density logits.

The estimator is ``cloud_nee``'s in its gradient-friendly variant (roulette
off, a uniform channel pick) with the score terms of the scatter-or-null
split, over majorants taken from the grid the scene was built with (fixed
under differentiation). A step at sample indices (a, b) renders every
pixel once in each of two streams (frame seeds s and s + 7919, sample a
resp. b), and the loss is ``mean((img_a - target) (img_b - target))`` over
pixels and channels; its gradient is that of each stream's image against the
other stream's residual. The density is ``true * sigmoid(z)``; Adam (beta
0.9, 0.999, eps 1e-8) takes the gradient w.r.t. z clipped to a global norm
of 1, at a cosine schedule of the learning rate to 5% over a horizon.
"""

import math

import numpy as np
import torch

from .cloud_nee import CloudNEE
from .common import MASK

STREAM_B = 7919          # the second stream's seed offset


class CloudGradStep:
    """The steps of one fit. ``true_grid``: the (nx, ny, nz) density the
    scene was built with."""

    def __init__(self, config, true_grid, device, dt=torch.float32):
        self.est = CloudNEE(config, true_grid, device, dt, grad_sampling=True,
                            score_terms=True)
        self.dev = self.est.dev
        self.dt = dt
        self.true = torch.as_tensor(np.asarray(true_grid, np.float32)).to(self.dev).to(dt)
        self.n_pix = self.est.width * self.est.height
        self.pixels = torch.arange(self.n_pix, device=self.dev)
        self.tally = self.est.tally

    def _lanes(self, seed, sample):
        seeds = torch.full((self.n_pix,), int(seed) & MASK, dtype=torch.int64, device=self.dev)
        return seeds, self.pixels, torch.full_like(self.pixels, int(sample))

    def image(self, grid, seed, sample):
        """One stream's image (N, 3) of ``grid``, without gradient."""
        self.est.grid = grid.to(self.dt).reshape(-1)
        with torch.no_grad():
            rad, _ = self.est._paths(*self._lanes(seed, sample))
        return rad

    def value_and_grad(self, grid, target, seed, sample_a, sample_b):
        """(loss, d loss / d grid, img_a, img_b) of one step."""
        g = grid.detach().to(self.dt).clone().requires_grad_(True)
        self.est.grid = g.reshape(-1)
        sa, pa, qa = self._lanes(seed, sample_a)
        sb, pb, qb = self._lanes(seed + STREAM_B, sample_b)
        rad, _ = self.est._paths(torch.cat([sa, sb]), torch.cat([pa, pb]),
                                 torch.cat([qa, qb]))
        n = self.n_pix
        a, b = rad[:n], rad[n:]
        t = target.to(self.dt)
        loss = torch.mean((a.detach() - t) * (b.detach() - t))
        rfac = torch.cat([b.detach() - t, a.detach() - t]) / (n * 3)
        (rad * rfac).sum().backward()
        return loss.detach(), g.grad.detach(), a.detach(), b.detach()


def adam_fit(step, z0, target, seed, samples, lr, horizon, alpha=0.05,
             max_norm=1.0):
    """Run the steps at ``samples`` ((a, b) pairs) from logits ``z0``; returns
    per step (loss, img_a, img_b), the gradient w.r.t. z as Adam got it at
    the first step (from its first moment), and the logits after the last."""
    z = z0.detach().to(step.dt).clone().requires_grad_(True)
    opt = torch.optim.Adam([z], lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * min(t, horizon) / horizon))
        + alpha)
    out, first_grad = [], None
    for k, (sa, sb) in enumerate(samples):
        with torch.no_grad():
            s = torch.sigmoid(z)
            dens = step.true * s
        loss, g, a, b = step.value_and_grad(dens, target, seed, sa, sb)
        z.grad = g * step.true * (s * (1.0 - s))
        torch.nn.utils.clip_grad_norm_([z], max_norm)
        opt.step()
        sched.step()
        if k == 0:
            first_grad = opt.state[z]["exp_avg"].detach() / (1.0 - 0.9)
        out.append((loss, a, b))
    return out, first_grad, z.detach()


def adam_step(step, state, target, seed, sample_a, sample_b, max_norm=1.0,
              betas=(0.9, 0.999), eps=1e-8):
    """One step of the fit from a given state (``state``: the logits ``z``,
    Adam's ``exp_avg`` and ``exp_avg_sq``, its ``step`` count and the ``lr``
    of the step), written out: the density gradient, its chain to z, the
    global-norm clip, Adam's moments and bias corrections. Returns (loss,
    img_a, img_b, d loss / d density, z after)."""
    dev, dt = step.dev, step.dt
    z = torch.as_tensor(state["z"]).to(dev).to(dt)
    m = torch.as_tensor(state["exp_avg"]).to(dev).to(dt)
    v = torch.as_tensor(state["exp_avg_sq"]).to(dev).to(dt)
    b1, b2 = betas
    s = torch.sigmoid(z)
    loss, g, a, b = step.value_and_grad(step.true * s, target, seed, sample_a, sample_b)
    gz = g * step.true * (s * (1.0 - s))
    gz = gz * min(1.0, max_norm / (float(torch.linalg.vector_norm(gz.float())) + 1e-6))
    t = float(state["step"]) + 1.0
    m = b1 * m + (1.0 - b1) * gz
    v = b2 * v + (1.0 - b2) * gz * gz
    denom = v.sqrt() / math.sqrt(1.0 - b2 ** t) + eps
    z = z - float(state["lr"]) / (1.0 - b1 ** t) * m / denom
    return loss, a, b, g, z


def make(config, grid, device, dt=torch.float32):
    return CloudGradStep(config, grid, device, dt)
