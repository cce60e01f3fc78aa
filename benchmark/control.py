"""The control of a cell's correctness check: the plain reference computed in
the precision below the configuration's (bfloat16 for float32), put in the
program's place, at the cell's own size: the same frames' seeds and checked
pixels as a run of ``--frames`` frames, at the full spp. Prints one JSON line
per seed with the numbers the check compares. The benchmark's own runs do
not run it; ``PERF.md`` gives its readings beside the program's.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 --frames 40

A fit's window's last step (``--last-step``): the program runs the cell's
window for ``--seconds``; the reference then takes the program's place in
its last step, from the state that step started from, in bfloat16 and, in
float32, with each fault planted; the program's own numbers are printed
beside them.

    python3 benchmark/control.py --workload cloud_nee.grad --seeds 11,12,13 --last-step --seconds 2
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


FAULTS = ("answer_altered", "half_batch")


def control_numbers(cell, seed, n_frames, device, dt=None, fault=None):
    """The check's numbers when the ``dt`` reference stands in for the
    program over ``n_frames`` frames of the run with ``seed`` (a fit: its
    first steps). ``fault``: instead, the float32 reference with a fault
    planted: its answer one percent off where it is produced
    ("answer_altered"), or half of the batch left out and the mean taken
    over the rest ("half_batch": half the samples of a pixel, half the
    pixels of a step)."""
    import numpy as np
    import torch

    from benchmark.harness import check, inputs, manifest

    if fault is not None:
        dt = torch.float32
    dt = dt or torch.bfloat16
    if cell["traffic"]["loop"] == "grad":
        return _grad_control(cell, seed, device, dt, fault)
    cfg = cell["config"]
    r = cfg["render"]
    strata = inputs.pixel_strata(cfg) if "strata" in cfg["check"] else None
    grid = inputs.density_grid(cfg)
    low = manifest.reference(cfg["reference"]).make(cfg, grid, device, dt)
    records = [{"seed": inputs.frame_seed(seed, i),
                "pixels": inputs.frame_pixels(cfg, strata, seed, i)}
               for i in range(n_frames)]
    seeds = [rec["seed"] for rec in records for _ in rec["pixels"]]
    pixels = np.concatenate([rec["pixels"] for rec in records])
    spp = int(r["spp"]) // (2 if fault == "half_batch" else 1)
    with torch.no_grad():
        vals, _ = low.render_pixels(seeds, pixels, spp)
    vals = vals.float().cpu().numpy() * (1.01 if fault == "answer_altered" else 1.0)
    start = 0
    for rec in records:
        rec["values"] = vals[start:start + len(rec["pixels"])]
        start += len(rec["pixels"])
    numbers, _ = check.compare_render(cfg, grid, records, device)
    return {name: v for name, (v, _) in numbers.items()}


def _grad_control(cell, seed, device, dt, fault):
    from types import SimpleNamespace

    from benchmark.harness import check, inputs, manifest

    cfg, tr = cell["config"], cell["traffic"]
    grid = inputs.density_grid(cfg)
    mod = manifest.reference(cfg["grad_reference"])
    low = mod.make(cfg, grid, device, dt)
    if fault is not None:
        _plant(low, fault)
    step_seed = inputs.frame_seed(seed, 0)
    z0 = inputs.start_logits(grid.shape, seed, tr, device)
    target = low.image(low.true, step_seed, int(tr["target_sample"]))
    n = int(tr["first_steps"])
    steps, g1, z_last = mod.adam_fit(
        low, z0, target, step_seed, [(2 * i, 2 * i + 1) for i in range(n)],
        float(tr["lr"]), int(tr["horizon"]), float(tr["alpha"]), float(tr["max_norm"]))
    first = {"losses": [float(l) for l, _, _ in steps],
             "img_a": steps[0][1].float().cpu().numpy(),
             "img_b": steps[0][2].float().cpu().numpy(),
             "grad": g1.float().cpu().numpy(), "z": z_last.float().cpu().numpy()}
    # the first steps only: ``last_step_controls`` reads the window's last
    loop = SimpleNamespace(grid=grid, z0=z0.cpu().numpy(), step_seed=step_seed, first=first,
                           last=None)
    numbers, _ = check.compare_grad(cell, loop, device)
    return {name: v for name, (v, _) in numbers.items() if not name.startswith("last_")}


def last_step_controls(cell, seed, seconds, device):
    """The last-step numbers of a fit: {"program": ..., "bfloat16": ...,
    <fault>: ...} for one run of ``seconds`` with ``seed``."""
    import torch

    from benchmark.harness import check, loops, manifest

    cfg, tr = cell["config"], cell["traffic"]
    loop = loops.GradLoop(cell, seed, device)
    loop.warm_up()
    loops.run_window(loop, seconds)
    loop.release()
    last = loop.last
    if device != "cpu":
        torch.cuda.empty_cache()
    mod = manifest.reference(cfg["grad_reference"])
    ref = mod.make(cfg, loop.grid, device)
    target = ref.image(ref.true, loop.step_seed, int(tr["target_sample"]))
    expect = check.reference_last_step(cell, ref, mod, last, target, loop.step_seed)
    out = {"program": check.last_numbers(last, expect, target), "index": last["index"]}
    for kind in ("bfloat16",) + FAULTS:
        low = mod.make(cfg, loop.grid, device,
                       torch.bfloat16 if kind == "bfloat16" else torch.float32)
        if kind != "bfloat16":
            _plant(low, kind)
        low_target = target.to(low.dt)
        loss, a, b, g, z = check.reference_last_step(cell, low, mod, last, low_target,
                                                     loop.step_seed)
        f = lambda t: t.float().cpu().numpy()  # noqa: E731
        mine = dict(last, loss=float(loss), img_a=f(a), img_b=f(b), grad=f(g), z_after=f(z))
        out[kind] = check.last_numbers(mine, expect, target)
    return out


def _plant(step, fault):
    """The fault in a reference step (``reference/cloud_grad.py``)."""
    import torch

    orig = step.value_and_grad
    n = step.n_pix
    if fault == "answer_altered":
        def value_and_grad(grid, target, seed, sa, sb):
            loss, g, a, b = orig(grid, target, seed, sa, sb)
            return loss, g * 1.01, a, b
    elif fault == "half_batch":
        step.pixels = step.pixels[:n // 2]
        step.n_pix = n // 2

        def value_and_grad(grid, target, seed, sa, sb):
            loss, g, a, b = orig(grid, target[:n // 2], seed, sa, sb)
            return loss, g, torch.cat([a, a]), torch.cat([b, b])
    else:
        raise ValueError(fault)
    step.value_and_grad = value_and_grad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--last-step", action="store_true")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", choices=FAULTS, default=None)
    args = p.parse_args(argv)
    from benchmark.harness import manifest

    cell = manifest.cell(manifest.load(), args.workload)
    for s in args.seeds.split(","):
        t = time.perf_counter()
        if args.last_step:
            nums = last_step_controls(cell, int(s), args.seconds, args.device)
            print(json.dumps({"workload": args.workload, "seed": int(s),
                              "seconds_window": args.seconds, "last_step": nums,
                              "seconds": time.perf_counter() - t}), flush=True)
            continue
        nums = control_numbers(cell, int(s), args.frames, args.device, fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "frames": args.frames,
                          "control": args.fault or "bfloat16",
                          "numbers": nums,
                          "config_check": cell["config"]["check"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
