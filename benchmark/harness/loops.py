"""The general loops that traffic mixes parameterise, and the measured
window that drives them.

A traffic file names its ``loop``; ``LOOPS`` maps that name to a class with
``warm_up()``, ``step(i)`` (one unit of the window's work: a frame, a fit
step), ``record(i, start, end, out, error)``, ``release()`` (the program's
state goes, the check's inputs stay) and ``first_index`` (the window's first
unit). The window is a closed loop with one unit in flight: the next starts
when the previous has returned with its result on the host.
"""

import contextlib
import math
import time

import numpy as np

from . import inputs, port


class RenderLoop:
    """Frames of one configuration, back to back: each ``render`` call is
    the one-shot entry the CLI uses, at the preset's full spp, with the
    frame's own seed, so it pays the renderer's construction and the
    image's assembly on the host as a caller does. ``sharding``: the pixel
    split over a process group (every rank runs the same frames)."""

    # the warm-up frame's index: its seed is no frame of the window
    WARM_UP = 1 << 30

    first_index = 0

    def __init__(self, cell, seed, device, sharding=None):
        self.config = cfg = cell["config"]
        self.seed = int(seed)
        self.grid = inputs.density_grid(cfg)
        self.tables, _, self.camera, self.integ = port.build_scene(
            cfg, self.grid, device)
        r = cfg["render"]
        self.width, self.height, self.spp = int(r["width"]), int(r["height"]), int(r["spp"])
        self.n_pix = self.width * self.height
        self.sharding = sharding
        self.strata = inputs.pixel_strata(cfg) if "strata" in cfg["check"] else None

    def warm_up(self):
        self.step(self.WARM_UP)

    def step(self, i):
        from xraytracer_tpu_torch.renderer import render

        res = render(self.tables, self.camera, self.integ, self.width,
                     self.height, self.spp, seed=inputs.frame_seed(self.seed, i),
                     sharding=self.sharding)
        return res.image, res.n_rejected

    def record(self, i, start, end, out, error):
        rec = {"index": i, "start": start, "end": end, "error": error,
               "samples": self.n_pix * self.spp if error is None else 0}
        if error is not None:
            rec["ok"] = False
            return rec
        image, n_rej = out
        px = inputs.frame_pixels(self.config, self.strata, self.seed, i)
        vals = image.reshape(-1, 3)[px].astype(np.float32)
        rec.update(seed=inputs.frame_seed(self.seed, i), pixels=px, values=vals,
                   rejected=int(n_rej), ok=bool(np.isfinite(vals).all()) and n_rej == 0)
        return rec

    def release(self):
        self.tables = self.camera = self.integ = None


class GradLoop:
    """Steps of a density fit, back to back: each is the analytic
    value-and-gradient step of the two-sample product loss
    (``diff.try_make_fast_value_and_grad``'s ``step_pair``: both streams'
    pass A and pass B in one launch each) at fresh sample indices, then the
    Adam update of the density logits, as ``tools/fit_volume.py`` runs them:
    global-norm clipping, a cosine schedule. The density is ``true *
    sigmoid(z)``, so it stays at or below the grid the scene was built with,
    whose majorants the step keeps; z starts from the seed. The target is the
    true cloud's image, rendered in set-up by the step's own pass A. The
    first ``first_steps`` steps run in set-up through the same call; what
    they return is kept for the check. So is the window's last step: before
    each timed step the logits and Adam's state are copied into buffers made
    in set-up (three copies on the card), and the step's loss, images and
    density gradient are kept, so that the check can run the reference's
    step from the same state once the window has closed."""

    def __init__(self, cell, seed, device, sharding=None):
        import torch

        from xraytracer_tpu_torch.diff import try_make_fast_value_and_grad
        from xraytracer_tpu_torch.renderer import pixel_grid

        self.config = cfg = cell["config"]
        self.traffic = tr = cell["traffic"]
        self.seed = int(seed)
        self.grid = inputs.density_grid(cfg)
        self.tables, statics, self.camera, _ = port.build_scene(cfg, self.grid, device)
        r = cfg["render"]
        w, h = int(r["width"]), int(r["height"])
        self.step_seed = inputs.frame_seed(seed, 0)
        self.fn = try_make_fast_value_and_grad(
            self.tables, statics, self.camera, w, h, int(r["max_depth"]),
            nee=True, seed=self.step_seed,
            force=torch.device(device).type != "cuda")   # the CPU: plain versions
        if self.fn is None:
            raise RuntimeError("the scene does not take the analytic gradient route")
        self.ids, self.xy = pixel_grid(w, h, device=device)
        self.true = torch.from_numpy(self.grid).to(device)
        self.z0 = inputs.start_logits(self.grid.shape, seed, tr, device)
        self.z = self.z0.clone().requires_grad_(True)
        self.opt = torch.optim.Adam([self.z], lr=float(tr["lr"]))
        horizon, alpha = int(tr["horizon"]), float(tr["alpha"])
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda t: (1.0 - alpha) * 0.5
            * (1.0 + math.cos(math.pi * min(t, horizon) / horizon)) + alpha)
        self.target = self.fn.render(self.true, self.ids, self.xy, int(tr["target_sample"]))
        self.first = {}
        self.first_index = int(tr["first_steps"])
        self.snap = None      # the state before the latest timed step
        self.last = None      # that step's outputs, then the check's copy

    def warm_up(self):
        """The first steps, through the window's own call."""
        losses = []
        for i in range(self.first_index):
            out = self.step(i)
            losses.append(float(out["loss"]))
            if i == 0:
                # copies: the later steps update the optimizer's state in place
                self.first["img_a"] = out["img_a"].cpu().numpy().copy()
                self.first["img_b"] = out["img_b"].cpu().numpy().copy()
                m = self.opt.state[self.z]["exp_avg"]
                self.first["grad"] = (m / (1.0 - 0.9)).cpu().numpy().copy()
        self.first["losses"] = losses
        self.first["z"] = self.z.detach().cpu().numpy().copy()
        st = self.opt.state[self.z]
        self.snap = {"z": self.z.detach().clone(), "exp_avg": st["exp_avg"].clone(),
                     "exp_avg_sq": st["exp_avg_sq"].clone()}

    def _snapshot(self, i):
        st = self.opt.state[self.z]
        self.snap["z"].copy_(self.z.detach())
        self.snap["exp_avg"].copy_(st["exp_avg"])
        self.snap["exp_avg_sq"].copy_(st["exp_avg_sq"])
        self.snap.update(index=i, step=float(st["step"]),
                         lr=float(self.opt.param_groups[0]["lr"]))

    def step(self, i):
        import torch

        if i >= self.first_index:
            self._snapshot(i)
        with torch.no_grad():
            s = torch.sigmoid(self.z)
            dens = self.true * s
        aux = {}
        loss, grads = self.fn.step_pair({"grid_density": dens}, self.ids, self.xy,
                                        self.target, 2 * i, 2 * i + 1, aux=aux)
        dgrad = grads["grid_density"]
        self.z.grad = dgrad * self.true * (s * (1.0 - s))
        ok = torch.isfinite(loss) & torch.isfinite(self.z.grad).all()
        for img in (aux["img"], aux["img_b"]):
            ok = ok & (torch.isfinite(img) & (img >= 0.0)).all()
        torch.nn.utils.clip_grad_norm_([self.z], float(self.traffic["max_norm"]))
        self.opt.step()
        self.sched.step()
        # the step ends with its update done and its verdict on the host
        return {"loss": loss, "ok": bool(ok), "img_a": aux["img"], "img_b": aux["img_b"],
                "grad": dgrad}

    def record(self, i, start, end, out, error):
        if error is None and i >= self.first_index:
            self.last = dict(out, index=i)
        return {"index": i, "start": start, "end": end, "error": error,
                "ok": error is None and out["ok"]}

    def release(self):
        """The program's state goes; what the check needs comes to the host:
        the start, and the last timed step with the state it started from
        (None where that step did not return)."""
        last, snap = self.last, self.snap
        self.last = None
        if last is not None and snap is not None and snap.get("index") == last["index"]:
            host = lambda t: t.detach().float().cpu().numpy().copy()  # noqa: E731
            self.last = {
                "index": last["index"], "step": snap["step"], "lr": snap["lr"],
                "z": host(snap["z"]), "exp_avg": host(snap["exp_avg"]),
                "exp_avg_sq": host(snap["exp_avg_sq"]), "z_after": host(self.z),
                "loss": float(last["loss"]), "img_a": host(last["img_a"]),
                "img_b": host(last["img_b"]), "grad": host(last["grad"])}
        self.snap = None
        self.z0 = self.z0.cpu().numpy()
        self.tables = self.camera = self.fn = self.ids = self.xy = None
        self.true = self.target = self.z = self.opt = self.sched = None


LOOPS = {"render": RenderLoop, "grad": GradLoop}


def run_window(loop, seconds, span=None, stop=None):
    """Drive ``loop.step`` for ``seconds``: returns (t0, records), t0 the
    window's start on ``time.perf_counter``. ``span(name)`` opens a traced
    span around each step; ``stop(local_decision)`` lets a process group
    agree on when the window ends (rank 0's clock decides)."""
    span = span or (lambda name: contextlib.nullcontext())
    records = []
    t0 = time.perf_counter()
    i = loop.first_index
    while True:
        a = time.perf_counter()
        out, err = None, None
        try:
            with span("bench.step"):
                out = loop.step(i)
        except Exception as exc:     # a failed unit counts in `failed`
            err = f"{type(exc).__name__}: {exc}"
        b = time.perf_counter()
        records.append(loop.record(i, a, b, out, err))
        i += 1
        done = b - t0 >= seconds
        if stop is not None:
            done = stop(done)
        if done:
            return t0, records


def samples_rate(run):
    """Millions of camera samples a second: every completed frame's samples
    over the window's start to the last frame's end."""
    done = [r for r in run.records if r["error"] is None]
    if not done:
        return None
    last = max(r["end"] for r in run.records)
    return sum(r["samples"] for r in done) / (last - run.t0) / 1e6
