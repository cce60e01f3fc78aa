"""Whether what the timed path produced is correct, against the plain
reference, computed once the window has closed and the program's state is
freed.

A render loop: the sampled pixels of every frame of the window, program
and reference both the mean of the frame's full spp at the frame's seed;
the number compared is ``img_rel_l1``, the sum over the checked pixels and
channels of |program - reference| over the sum of |reference| (limit:
``check.limit``). A configuration with ``check.strata`` draws its pixels by
what they see (``inputs.pixel_strata``): ``img_rel_l1`` then pools the
pixels that see no light, and the pixels that see a light are held to
``light_gap_samples`` (limit: ``check.light_limit``), since a light seen
directly holds nearly all of a pooled sum and hides the rest. A fit loop:
its first steps from the seed's start, and the window's last step from the
state it started from (``compare_grad``; limits: ``check.grad_limits``).
``PERF.md`` gives the readings the limits were set from.
"""

import numpy as np
import torch

from . import inputs, manifest


def pixel_batch(records):
    """(seeds, pixel ids, program values) of every frame that returned."""
    recs = [r for r in records if r.get("values") is not None]
    if not recs:
        return [], np.zeros(0, np.int64), np.zeros((0, 3), np.float32)
    seeds = [r["seed"] for r in recs for _ in r["pixels"]]
    pixels = np.concatenate([r["pixels"] for r in recs])
    values = np.concatenate([r["values"] for r in recs])
    return seeds, pixels, values


def rel_l1(values, expect):
    den = float(np.abs(expect).sum())
    return float(np.abs(values.astype(np.float64) - expect).sum()) / max(den, 1e-30)


def light_gap(values, expect, config):
    """The widest gap over the checked pixels that see a light, in samples:
    the L1 over the channels of |program - reference| over one sample's
    share (1 / spp) of the brightest light's Le; 0 with no such pixel."""
    if len(values) == 0:
        return 0.0
    le = max(float(np.sum(x["le"])) for x in config["scene"]["sphere_lights"])
    gap = np.abs(values.astype(np.float64) - expect).sum(-1)
    return float(gap.max()) * int(config["render"]["spp"]) / le


def render_limits(config):
    """{number: limit} of a render loop's check."""
    chk = config["check"]
    out = {"img_rel_l1": float(chk["limit"])}
    if "strata" in chk:
        out["light_gap_samples"] = float(chk["light_limit"])
    return out


def compare(cell, loop, records, device):
    """(numbers, tally): numbers = {name: (value, limit)} of the loop's
    check, tally the reference's counts per unit of the window's work (a
    frame, a step) for the rooflines."""
    if cell["traffic"]["loop"] == "grad":
        return compare_grad(cell, loop, device)
    cfg = cell["config"]
    numbers, ref = compare_render(cfg, loop.grid, records, device)
    r = cfg["render"]
    n_pix = int(r["width"]) * int(r["height"])
    if "count" in cfg:
        return numbers, frame_count(cfg, ref)
    n_checked = sum(len(rec.get("pixels", ())) for rec in records)
    scale = n_pix / max(n_checked, 1)
    return numbers, {k: v * scale for k, v in ref.tally.items()}


def frame_count(config, ref):
    """The reference's counts for one frame, from a pass that only counts:
    the fixed pixels of ``inputs.count_pixels`` at ``count.spp`` samples and
    seed 0, scaled to the frame's pixels and spp. The same in every run,
    whatever ``--seed`` draws."""
    r, spp = config["render"], int(config["count"]["spp"])
    px = inputs.count_pixels(config)
    for k in ref.tally:
        ref.tally[k] = 0
    with torch.no_grad():
        ref.render_pixels([0] * len(px), px, spp)
    scale = int(r["width"]) * int(r["height"]) * int(r["spp"]) / (len(px) * spp)
    return {k: v * scale for k, v in ref.tally.items()}


def compare_render(config, grid, records, device, dt=torch.float32):
    """(numbers, reference) of a render loop's frames."""
    ref = manifest.reference(config["reference"]).make(config, grid, device, dt)
    seeds, pixels, values = pixel_batch(records)
    limits = render_limits(config)
    if len(pixels) == 0:
        return {name: (float("inf"), lim) for name, lim in limits.items()}, ref
    with torch.no_grad():
        expect, _ = ref.render_pixels(seeds, pixels, int(config["render"]["spp"]))
    expect = expect.cpu().numpy()
    if "strata" not in config["check"]:
        return {"img_rel_l1": (rel_l1(values, expect), limits["img_rel_l1"])}, ref
    light = np.isin(pixels, inputs.pixel_strata(config)["lights"])
    return {"img_rel_l1": (rel_l1(values[~light], expect[~light]), limits["img_rel_l1"]),
            "light_gap_samples": (light_gap(values[light], expect[light], config),
                                  limits["light_gap_samples"])}, ref


def compare_grad(cell, loop, device):
    """A fit against the reference (``reference/cloud_grad.py``), in two
    parts. The first steps, which set-up ran through the window's own call,
    against the reference's from the same start: each step's loss, step 1's
    images of pass A, the gradient as Adam got it at step 1 (from its first
    moment) and the logits' change after the last. And the window's last
    step against the reference's one step from the state that step started
    from (``last_numbers``). Each number is a gap relative to the
    reference's scale (see ``PERF.md``). Returns (numbers, the reference's
    counts per step)."""
    cfg, tr = cell["config"], cell["traffic"]
    lim = cfg["check"]["grad_limits"]
    mod = manifest.reference(cfg["grad_reference"])
    ref = mod.make(cfg, loop.grid, device)
    target = ref.image(ref.true, loop.step_seed, int(tr["target_sample"]))
    for k in ref.tally:
        ref.tally[k] = 0
    n = int(tr["first_steps"])
    steps, g1, z_last = mod.adam_fit(
        ref, torch.as_tensor(loop.z0).to(ref.dev), target, loop.step_seed,
        [(2 * i, 2 * i + 1) for i in range(n)], float(tr["lr"]),
        int(tr["horizon"]), float(tr["alpha"]), float(tr["max_norm"]))
    per_step = {k: v / n for k, v in ref.tally.items()}
    first = loop.first
    loss_gap = 0.0
    for (loss_r, a, b), loss_p in zip(steps, first["losses"]):
        loss_gap = max(loss_gap, _loss_gap(loss_p, loss_r, a, b, target))
    a0, b0 = steps[0][1], steps[0][2]
    img = rel_l1(np.concatenate([first["img_a"], first["img_b"]]),
                 torch.cat([a0, b0]).double().cpu().numpy())
    z0 = np.asarray(loop.z0)
    numbers = {
        "loss_gap": (loss_gap, float(lim["loss_gap"])),
        "img_rel_l1": (img, float(lim["img_rel_l1"])),
        "grad_gap": (_norm_gap(first["grad"], g1.cpu().numpy()), float(lim["grad_gap"])),
        "step_gap": (_norm_gap(first["z"] - z0, z_last.cpu().numpy() - z0),
                     float(lim["step_gap"])),
    }
    expect = None
    if loop.last is not None:
        expect = reference_last_step(cell, ref, mod, loop.last, target, loop.step_seed)
    for name, value in last_numbers(loop.last, expect, target).items():
        numbers[name] = (value, float(lim[name]))
    return numbers, per_step


def reference_last_step(cell, ref, mod, last, target, step_seed):
    """The reference's one step (``mod.adam_step``) from the state the
    window's last step started from, at that step's sample indices."""
    i = int(last["index"])
    return mod.adam_step(ref, last, target, step_seed, 2 * i, 2 * i + 1,
                         float(cell["traffic"]["max_norm"]))


def last_numbers(last, expect, target):
    """The last step's numbers: its loss, both streams' images, the density
    gradient the step returned, and the logits' change by Adam, against the
    reference's ``expect`` = (loss, img_a, img_b, gradient, z after); all
    infinite where the window's last step did not return."""
    names = ("last_loss_gap", "last_img_rel_l1", "last_grad_gap", "last_step_gap")
    if last is None or expect is None:
        return dict.fromkeys(names, float("inf"))
    loss_r, a, b, g, z_r = expect
    z = np.asarray(last["z"], np.float64)
    img = rel_l1(np.concatenate([last["img_a"], last["img_b"]]),
                 torch.cat([a, b]).double().cpu().numpy())
    return dict(zip(names, (
        _loss_gap(last["loss"], loss_r, a, b, target),
        img,
        _norm_gap(last["grad"], g.double().cpu().numpy()),
        _norm_gap(np.asarray(last["z_after"], np.float64) - z,
                  z_r.double().cpu().numpy() - z))))


def _loss_gap(loss_p, loss_r, a, b, target):
    """|loss - loss_ref| over the reference's mean |a - t| |b - t| (the
    product loss is a mean of signed terms and can be ~0)."""
    scale = float(torch.mean((a.float() - target.float()).abs()
                             * (b.float() - target.float()).abs()))
    return abs(float(loss_p) - float(loss_r)) / max(scale, 1e-30)


def _norm_gap(p, r):
    nr = float(np.linalg.norm(r))
    return abs(float(np.linalg.norm(p)) - nr) / max(nr, 1e-30)
