#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card, nvcc and the checkout
    python3 chip_smoke.py --fmad-ab  # also compiles csrc/sweep.cu with
                                     # -fmad=false itself and runs the kernel
                                     # checks on that library as well
    python3 chip_smoke.py --profile  # also traces 2 samples of the main path
                                     # with torch.profiler (device time by kernel)

Builds the CUDA kernels of ``xraytracer_tpu_torch/csrc`` from source, holds
each kernel against its plain PyTorch version on the card at the shapes the
main path gives it, reproduces the CPU golden image through the kernels,
then drives the main path (the ``cornellbox_gi`` preset, 780x585, depth 3)
(once by its default route, record sweep + any-hit sweep, and once by its
``tri_fn`` route, which sends both sweeps through ``sweep_nearest``) and the
13k-triangle mesh GI scene through the port's public entry points. Every
launch count is set to 0 just before each of these three runs and read just
after it; the script checks that every sweep of the run went through its
kernel and none through a plain version. In the ``kernels`` line
``launches_by_path`` holds these three readings and ``launches`` is their
sum. There is no fallback: without a card, or when any phase fails, the
script exits non-zero and prints no result line.

Output: one JSON object per line (``device``, ``build``, ``kernel_checks``,
``golden``, ``main_path``, ``mesh_path``), then ``{"kernels": [...]}`` with
one entry per kernel, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Bounds. ``bound_ms`` is the least time the card could take for a sweep: the
larger of (bytes that must move: every input read once, every output
written once) / 3.35 TB/s and (pair tests needed x flops per test) /
67 TFLOP/s float32 outside the tensor cores — the H100 SXM data-sheet
peaks. The nearest-hit sweeps need all N*T pair tests; the any-hit sweep
needs, per ray with t_max > 0, the tests up to and including its first
blocking triangle in table order (all T when nothing blocks), counted from
this run's rays.
"""

import argparse
import json
import os
import subprocess
import sys
import time

WIDTH, HEIGHT, DEPTH = 780, 585, 3
MAIN_SPP = 16          # cornellbox_gi is 512 spp; cut to fit the smoke
STATS_SPP = 4
MESH_SPP = 4
MESH_SIZE = (82, 80)   # the "13k" lat-long sphere mesh
REF_W, REF_H = 128, 96

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FLOPS_PER_TEST = 38     # det 5, u 11, v 11, t 6, sign/compare arithmetic 5
FLOPS_PER_ANYHIT_TEST = 39

# tolerances, kernel vs plain version on the same inputs
IDX_MISMATCH_SHARE = 1e-4   # idx mismatches outside the tie band / rays
TIE_BAND = 2.0 ** -15       # relative t gap inside which either winner is right
T_RTOL, T_ATOL = 1e-4, 1e-5  # winner t on lanes that agree on idx
# u, v lie in [0, 1] but are sums of products ~|o - v0| |e| / det that
# cancel: rounding differences (FMA contraction in the kernel) grow with the
# scene's coordinates (the Cornell box spans ~1300 units from the camera)
# and with 1/|cos| at grazing incidence
UV_RTOL, UV_ATOL = 2e-3, 1e-4
REC_ATOL = 1e-6
# shadow rays swept by sweep_nearest (the tri_fn route) start on a surface
# and may run almost inside a blocker's plane (a ceiling point looking at the
# ceiling light): t = (distance to the plane) / cos, both the small remainder
# of a cancellation, so the winner's t carries an error of a few float32 ulps
# of |o - v0| / |cos| whatever the order of operations. Those cases add this
# many ulps of that bound to the t limit (and / |e| to the u, v limits); the
# path itself consumes only t < t_max there, which is compared exactly.
GRAZING_ULPS = 4
BLOCKED_MISMATCH_SHARE = 1e-4
MEAN_BAND_KERNEL_VS_PLAIN = 1e-3  # same seeds, same size: only edge flips differ
# pixels of the reference-size render (kernels vs plain path, same seeds)
# beyond rtol 1e-4 / atol 1e-6: only a path whose edge-grazing hit flipped
# may differ, about one ray in 2e5 on the mesh
REF_PIXEL_DIFF_SHARE = 2e-4
MEAN_BAND_FULL_VS_REF = 0.05      # other resolution: Monte-Carlo noise

_HERE = os.path.dirname(os.path.abspath(__file__))


def emit(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def median_ms(fn, reps, flush):
    """Median over ``reps`` single launches timed with CUDA events, after
    one warm-up; ``flush`` is rewritten before each so L2 starts cold."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def mesh_scene(device):
    """The mesh GI scene of bench_mesh.py: lat-long sphere mesh + floor +
    quad light, built with the port's SceneBuilder."""
    import numpy as np

    from xraytracer_tpu_torch.math import from_rows
    from xraytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, *MESH_SIZE, material=white)
    floor = np.asarray(
        [
            [[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
            [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=white)
    b.add_quad_light(
        (-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
        (10.0, 10.0, 10.0),
    )
    c2w = from_rows(
        1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, 1.0, 0,
        0, 0.6, 4.0, 1,
    )
    return b.build(device), dict(c2w=c2w, fov_deg=45.0)


def capture_sweep_inputs(renderer):
    """Render one sample and keep the rays each sweep was given: the
    nearest-hit rays and the shadow rays (with t_max) of every bounce."""
    from xraytracer_tpu_torch.geometry import kernels

    got = {"nearest": [], "shadow": []}
    orig_rec, orig_occ = kernels.sweep_nearest_rec, kernels.occluded_anyhit

    def rec(o, d, *rest):
        got["nearest"].append((o.clone(), d.clone()))
        return orig_rec(o, d, *rest)

    def occ(o, d, v0, e1, e2, blocks, t_max):
        got["shadow"].append((o.clone(), d.clone(), t_max.clone()))
        return orig_occ(o, d, v0, e1, e2, blocks, t_max)

    kernels.sweep_nearest_rec, kernels.occluded_anyhit = rec, occ
    try:
        renderer.render(1)
    finally:
        kernels.sweep_nearest_rec, kernels.occluded_anyhit = orig_rec, orig_occ
    return got


def anyhit_tests_needed(o, d, v0, e1, e2, blocks, t_max):
    """Pair tests an any-hit sweep needs for these rays: per ray with
    t_max > 0, up to and including its first blocking triangle in table
    order, all T when none blocks; 0 for parked rays (t_max <= 0)."""
    import torch

    from xraytracer_tpu_torch.geometry import intersect as ix

    t_total = v0.shape[0]
    center = torch.mean(v0, dim=0)
    g = ix._tri_features(v0 - center, e1, e2).T.reshape(t_total, 4, 10)
    f_all = ix._ray_features(o - center, d)
    vf = blocks.to(torch.float32)
    total = 0
    for r0 in range(0, o.shape[0], ix.RAY_BLOCK_MM):
        f = f_all[r0:r0 + ix.RAY_BLOCK_MM]
        tm = t_max[r0:r0 + ix.RAY_BLOCK_MM]
        first = torch.full((f.shape[0],), t_total, dtype=torch.int64,
                           device=o.device)
        for s in range(0, t_total, ix.TRI_CHUNK_MM):
            e = min(s + ix.TRI_CHUNK_MM, t_total)
            ok, _, _, t_s, absd = ix._mm_hit_test(f, g[s:e], vf[s:e])
            blk = ok & (t_s < tm[:, None] * absd)
            has = blk.any(dim=1)
            loc = torch.argmax(blk.to(torch.int8), dim=1) + s + 1
            first = torch.where(has & (first == t_total), loc, first)
        total += int(torch.where(tm > 0.0, first, torch.zeros_like(first)).sum())
    return total


def bound_ms(n_bytes, n_tests, flops_per_test):
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_tests * flops_per_test / PEAK_F32_FLOPS * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def grazing_slack(o, d, v0, e1, e2, idx):
    """Per-ray error bounds (for t, for u and v) of the winner epilogue from
    its conditioning alone: GRAZING_ULPS float32 ulps of |o - v0| / |cos|."""
    import torch

    ix = torch.clamp(idx, min=0).to(torch.int64)
    w_e1, w_e2 = e1[ix], e2[ix]
    ng = torch.linalg.cross(w_e1, w_e2)
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    cos = torch.abs((d * ng).sum(-1)) / torch.clamp(norm(d) * norm(ng), min=1e-30)
    slack_t = GRAZING_ULPS * 2.0 ** -23 * norm(o - v0[ix]) / torch.clamp(cos, min=1e-12)
    edge = torch.clamp(torch.minimum(norm(w_e1), norm(w_e2)), min=1e-30)
    return slack_t, slack_t / edge


def compare_nearest(got, ref, with_rec, slack=None):
    """Kernel vs plain nearest-hit outputs -> dict of counts and max errors;
    fails on anything outside the stated tolerances. ``slack`` =
    ``grazing_slack(...)`` widens the t and u, v limits per ray."""
    import torch

    kt, ki, ku, kv = got[:4]
    pt, pi, pu, pv = ref[:4]
    n = kt.shape[0]
    mism = ki != pi
    flips = (ki >= 0) != (pi >= 0)
    both = (ki >= 0) & (pi >= 0)
    rel = torch.abs(kt - pt) / torch.clamp(torch.abs(pt), min=1e-9)
    in_band = mism & both & (rel < TIE_BAND)
    out_band = mism & ~in_band
    agree = both & ~mism

    def max_err(a, b, rtol, atol, what, extra=None):
        if not bool(agree.any()):
            return 0.0
        err = torch.abs(a - b)[agree]
        lim = atol + rtol * torch.abs(b)
        if extra is not None:
            lim = lim + extra
        lim = lim[agree]
        over = int((err > lim).sum())
        worst = int(torch.argmax(err - lim))
        check(over == 0,
              f"{what}: {over} lanes beyond rtol {rtol} atol {atol}; worst "
              f"kernel {float(a[agree][worst])} plain {float(b[agree][worst])}")
        return float(err.max())

    out = dict(
        n=n,
        hits=int((pi >= 0).sum()),
        idx_mismatch=int(mism.sum()),
        idx_mismatch_in_tie_band=int(in_band.sum()),
        idx_mismatch_outside=int(out_band.sum()),
        hit_miss_flips=int(flips.sum()),
        flip_share=float(flips.sum()) / max(n, 1),
        t_max_abs_err=max_err(kt, pt, T_RTOL, T_ATOL, "t",
                              None if slack is None else slack[0]),
        u_max_abs_err=max_err(ku, pu, UV_RTOL, UV_ATOL, "u",
                              None if slack is None else slack[1]),
        v_max_abs_err=max_err(kv, pv, UV_RTOL, UV_ATOL, "v",
                              None if slack is None else slack[1]),
    )
    if slack is not None:
        # how many lanes needed the widening at all
        plain_lim = T_ATOL + T_RTOL * torch.abs(pt)
        out["t_lanes_beyond_plain_limit"] = int(
            ((torch.abs(kt - pt) > plain_lim) & agree).sum())
    check(
        out["idx_mismatch_outside"] <= max(1, IDX_MISMATCH_SHARE * n),
        f"idx mismatches outside the tie band: {out['idx_mismatch_outside']} of {n}",
    )
    miss_k = ki < 0
    check(bool((kt[miss_k] > 3.0e38).all()) and bool((ku[miss_k] == 0).all())
          and bool((kv[miss_k] == 0).all()), "miss lanes must be (INF, -1, 0, 0)")
    if with_rec:
        krec, prec = got[4], ref[4]
        err = torch.abs(krec - prec)[agree | ((ki < 0) & (pi < 0))]
        out["rec_max_abs_err"] = float(err.max()) if err.numel() else 0.0
        check(out["rec_max_abs_err"] <= REC_ATOL,
              f"rec differs by {out['rec_max_abs_err']}")
        check(bool((krec[miss_k] == 0).all()), "rec must be zero on miss")
    return out


def kernel_cases(tables, rays_sets, flush, reps):
    """Run the three kernels and their plain versions on every ray set of
    one scene table. Returns {kernel: [case dict, ...]}."""
    import torch

    from xraytracer_tpu_torch.geometry import kernels

    v0, e1, e2 = tables.tri_v0, tables.tri_e1, tables.tri_e2
    valid = tables.tri_obj >= 0
    light = tables.obj_light[torch.clamp(tables.tri_obj, min=0).to(torch.int64)]
    blocks = valid & (light < 0)
    rec_tab = tables.tri_rec
    t_total = v0.shape[0]
    tri_bytes = t_total * (36 + 1) + 12
    out = {k: [] for k in kernels.KERNEL_NAMES}

    for label, (o, d) in rays_sets["nearest"].items():
        n = o.shape[0]
        for name, with_rec in (("sweep_nearest", False), ("sweep_nearest_rec", True)):
            if with_rec:
                run_k = lambda: kernels.sweep_nearest_rec(o, d, v0, e1, e2, valid, rec_tab)
                run_p = lambda: kernels.sweep_nearest_rec_plain(o, d, v0, e1, e2, valid, rec_tab)
                n_bytes = n * (24 + 16 + 128) + tri_bytes + t_total * 128
            else:
                run_k = lambda: kernels.sweep_nearest(o, d, v0, e1, e2, valid)
                run_p = lambda: kernels.sweep_nearest_plain(o, d, v0, e1, e2, valid)
                n_bytes = n * (24 + 16) + tri_bytes
            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            case = compare_nearest(got, ref, with_rec)
            del got, ref
            b_ms, b_by = bound_ms(n_bytes, n * t_total, FLOPS_PER_TEST)
            case.update(
                case=label, t_total=t_total,
                ms=median_ms(run_k, reps, flush),
                plain_ms=median_ms(run_p, reps, flush),
                bound_ms=b_ms, bound_by=b_by,
            )
            out[name].append(case)

    for label, (o, d, tm) in rays_sets["shadow"].items():
        n = o.shape[0]
        run_k = lambda: kernels.occluded_anyhit(o, d, v0, e1, e2, blocks, tm)
        run_p = lambda: kernels.occluded_anyhit_plain(o, d, v0, e1, e2, blocks, tm)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        check(mism <= max(1, BLOCKED_MISMATCH_SHARE * n),
              f"occluded_anyhit {label}: {mism} of {n} lanes disagree")
        check(not bool(got[tm <= 0].any()), "a lane with t_max <= 0 was blocked")
        # the tri_fn route sweeps the same rays with sweep_nearest over the
        # blocks mask and derives blocked = t < t_max
        run_k2 = lambda: kernels.sweep_nearest(o, d, v0, e1, e2, blocks)
        run_p2 = lambda: kernels.sweep_nearest_plain(o, d, v0, e1, e2, blocks)
        got2, ref2 = run_k2(), run_p2()
        torch.cuda.synchronize()
        case2 = compare_nearest(
            got2, ref2, False, grazing_slack(o, d, v0, e1, e2, ref2[1]))
        mism2 = int(((got2[0] < tm) != (ref2[0] < tm)).sum())
        check(mism2 <= max(1, BLOCKED_MISMATCH_SHARE * n),
              f"sweep_nearest {label}: {mism2} of {n} derived blocked flags disagree")
        mism24 = int(((got2[0] < tm) != got).sum())
        check(mism24 <= max(1, BLOCKED_MISMATCH_SHARE * n),
              f"sweep_nearest {label}: {mism24} of {n} derived blocked flags "
              f"differ from occluded_anyhit's")
        del got2, ref2
        b_ms, b_by = bound_ms(n * (24 + 16) + tri_bytes, n * t_total, FLOPS_PER_TEST)
        case2.update(
            case=f"{label}, blocks mask", t_total=t_total,
            derived_blocked_mismatch=mism2,
            derived_blocked_vs_anyhit_kernel=mism24,
            ms=median_ms(run_k2, reps, flush),
            plain_ms=median_ms(run_p2, reps, flush),
            bound_ms=b_ms, bound_by=b_by,
        )
        out["sweep_nearest"].append(case2)
        tests = anyhit_tests_needed(o, d, v0, e1, e2, blocks, tm)
        b_ms, b_by = bound_ms(n * (24 + 4 + 1) + tri_bytes, tests,
                              FLOPS_PER_ANYHIT_TEST)
        out["occluded_anyhit"].append(dict(
            case=label, n=n, t_total=t_total,
            blocked=int(ref.sum()), parked=int((tm <= 0).sum()),
            blocked_mismatch=mism, mismatch_share=mism / max(n, 1),
            tests_needed=tests, tests_brute=n * t_total,
            ms=median_ms(run_k, reps, flush),
            plain_ms=median_ms(run_p, reps, flush),
            bound_ms=b_ms, bound_by=b_by,
        ))
    return out


def edge_cases(device):
    """Small and ragged shapes, masked tiles, parked lanes, parallel rays."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch.geometry import kernels

    def tris(t_total, seed, scale=4.0):
        rng = np.random.default_rng(seed)
        mk = lambda a: torch.as_tensor(a.astype(np.float32)).to(device)
        return (mk(rng.uniform(-scale, scale, (t_total, 3))),
                mk(rng.uniform(-1.5, 1.5, (t_total, 3))),
                mk(rng.uniform(-1.5, 1.5, (t_total, 3))))

    def rays(n, seed, scale=6.0):
        rng = np.random.default_rng(seed)
        o = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return torch.as_tensor(o).to(device), torch.as_tensor(d).to(device)

    done = []
    for t_total, n, note in ((8, 1, "T=8 N=1"), (8, 4097, "T=8 N=4097"),
                             (300, 4097, "ragged T=300 N=4097")):
        v0, e1, e2 = tris(t_total, seed=t_total)
        o, d = rays(n, seed=n)
        valid = torch.ones((t_total,), dtype=torch.bool, device=device)
        rec_tab = torch.arange(t_total * 32, dtype=torch.float32,
                               device=device).reshape(t_total, 32)
        got = kernels.sweep_nearest_rec(o, d, v0, e1, e2, valid, rec_tab)
        ref = kernels.sweep_nearest_rec_plain(o, d, v0, e1, e2, valid, rec_tab)
        c = compare_nearest(got, ref, True)
        got2 = kernels.sweep_nearest(o, d, v0, e1, e2, valid)
        check(bool((got2[1] == got[1]).all()), f"{note}: K2 and K3 idx differ")
        tm = torch.full((n,), 5.0, device=device)
        tm[::2] = 0.0
        blk = kernels.occluded_anyhit(o, d, v0, e1, e2, valid, tm)
        ref_b = kernels.occluded_anyhit_plain(o, d, v0, e1, e2, valid, tm)
        check(not bool(blk[::2].any()), f"{note}: parked lane blocked")
        check(int((blk != ref_b).sum()) <= max(1, BLOCKED_MISMATCH_SHARE * n),
              f"{note}: blocked mismatch")
        done.append(dict(case=note, hits=c["hits"],
                         idx_mismatch=c["idx_mismatch"],
                         blocked=int(blk.sum())))

    # one tile fully masked out, then the whole table masked out
    v0, e1, e2 = tris(256, seed=5)
    o, d = rays(2000, seed=6)
    valid = torch.ones((256,), dtype=torch.bool, device=device)
    valid[128:] = False
    got = kernels.sweep_nearest(o, d, v0, e1, e2, valid)
    ref = kernels.sweep_nearest_plain(o, d, v0, e1, e2, valid)
    c = compare_nearest(got, ref, False)
    check(int(got[1].max()) < 128, "a masked-out triangle was hit")
    none = torch.zeros_like(valid)
    got = kernels.sweep_nearest(o, d, v0, e1, e2, none)
    check(bool((got[1] == -1).all()), "hit in an all-invalid table")
    tm = torch.full((2000,), 1e9, device=device)
    check(not bool(kernels.occluded_anyhit(o, d, v0, e1, e2, none, tm).any()),
          "blocked by an all-invalid table")
    done.append(dict(case="masked tile / all-invalid table", hits=c["hits"]))

    # rays parallel to (and in the plane of) a triangle never hit it
    v0 = torch.tensor([[0.0, 0.0, 0.0]] * 8, device=device)
    e1 = torch.tensor([[1.0, 0.0, 0.0]] * 8, device=device)
    e2 = torch.tensor([[0.0, 1.0, 0.0]] * 8, device=device)
    o = torch.tensor([[-1.0, 0.2, 0.0], [-1.0, 0.2, 0.5], [0.2, 0.2, 1.0]],
                     device=device)
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]],
                     device=device)
    valid = torch.ones((8,), dtype=torch.bool, device=device)
    t, idx, _, _ = kernels.sweep_nearest(o, d, v0, e1, e2, valid)
    check(idx.tolist() == [-1, -1, 0] and abs(float(t[2]) - 1.0) < 1e-6,
          f"parallel rays: idx {idx.tolist()} t {t.tolist()}")
    done.append(dict(case="rays parallel to a triangle", idx=idx.tolist()))
    torch.cuda.synchronize()
    return done


def summarize(cases_by_kernel, headline):
    """The contract's per-kernel entry from the headline case."""
    from xraytracer_tpu_torch.geometry import kernels

    meta = {
        "sweep_nearest": "xraytracer_tpu/geometry/pallas_kernels.py:51",
        "sweep_nearest_rec": "xraytracer_tpu/geometry/pallas_kernels.py:67",
        "occluded_anyhit": "xraytracer_tpu/geometry/pallas_kernels.py:420",
    }
    entries = []
    for name in kernels.KERNEL_NAMES:
        cases = cases_by_kernel[name]
        head = next(c for c in cases if c["case"] == headline[name])
        if name == "occluded_anyhit":
            err = max(c["mismatch_share"] for c in cases)
        else:
            err = max(c["t_max_abs_err"] for c in cases)
        entries.append(dict(
            name=name, route="cuda",
            source="xraytracer_tpu_torch/csrc/sweep.cu",
            replaces=meta[name],
            launches=None,  # filled from the driven paths' own counts
            launches_by_path=None,
            max_abs_err=err,
            err_of=("share of lanes whose blocked flag differs, worst case"
                    if name == "occluded_anyhit"
                    else "winner t on lanes that agree on idx, worst case"),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None,
            shape=f"{head['case']}: N={head['n']} T={head['t_total']}",
            cases=[{k: c[k] for k in ("case", "n", "t_total", "ms", "plain_ms",
                                      "bound_ms", "bound_by")} for c in cases],
        ))
    return entries


def render_checks(label, result, n_lights, spp, counts, ref_kernel, ref_plain):
    """The checks every driven path must pass; returns the line's fields."""
    import numpy as np

    check(result.image.shape == (HEIGHT, WIDTH, 3), f"{label}: image shape")
    check(bool(np.isfinite(result.image).all()), f"{label}: non-finite pixels")
    check(result.n_rejected == 0, f"{label}: {result.n_rejected} rejected samples")
    k3 = counts["sweep_nearest_rec"]
    k4 = counts["occluded_anyhit"]
    check(k3["launches"] == spp * DEPTH,
          f"{label}: sweep_nearest_rec launched {k3['launches']}x, expected {spp * DEPTH}")
    check(k4["launches"] == spp * DEPTH * n_lights,
          f"{label}: occluded_anyhit launched {k4['launches']}x, expected {spp * DEPTH * n_lights}")
    plain = sum(c["plain_calls"] for c in counts.values())
    check(plain == 0, f"{label}: {plain} plain-version calls on the card")
    m_full = float(result.image.mean())
    m_k = float(ref_kernel.image.mean())
    m_p = float(ref_plain.image.mean())
    check(abs(m_k - m_p) <= MEAN_BAND_KERNEL_VS_PLAIN * m_p,
          f"{label}: {REF_W}x{REF_H} mean {m_k} (kernels) vs {m_p} (plain)")
    check(abs(m_full - m_p) <= MEAN_BAND_FULL_VS_REF * m_p,
          f"{label}: full-size mean {m_full} vs plain reference {m_p}")
    diff = np.abs(ref_kernel.image - ref_plain.image)
    lim = 1e-6 + 1e-4 * np.abs(ref_plain.image)
    n_diff = int((diff > lim).any(axis=-1).sum())
    check(n_diff <= REF_PIXEL_DIFF_SHARE * REF_W * REF_H,
          f"{label}: {n_diff} of {REF_W * REF_H} reference pixels differ "
          f"between the kernels and the plain path")
    return dict(
        width=WIDTH, height=HEIGHT, depth=DEPTH, spp=spp,
        seconds=result.seconds,
        msamples_per_s=result.samples_per_sec / 1e6,
        n_rejected=result.n_rejected,
        mean_radiance=m_full,
        ref_mean_kernels=m_k, ref_mean_plain=m_p,
        ref_pixels_differing=n_diff,
        ref_pixels=REF_W * REF_H,
        ref_pixels_differing_limit=int(REF_PIXEL_DIFF_SHARE * REF_W * REF_H),
        launches={k: v["launches"] for k, v in counts.items()},
        plain_calls=plain,
    )


def reference_renders(tables, cam_kwargs, statics, spp, cosine, device):
    """The same scene at the reference size, same seed and spp: once through
    the kernels, once through the plain path (``tri_fn`` = the plain
    matmul-form sweep, so no kernel runs)."""
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry.intersect import intersect_triangles_mm
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import render

    cam = PinholeCamera.make(REF_W / REF_H, device=device, **cam_kwargs)
    out = []
    for tri_fn in (None, intersect_triangles_mm):
        integ = make_path_integrator(tables, statics, DEPTH, nee=True,
                                     cosine_sampling=cosine, tri_fn=tri_fn)
        out.append(render(tables, cam, integ, REF_W, REF_H, spp, seed=0))
    return out


def load_sweep_without_fma():
    """Compile ``csrc/sweep.cu`` once more with ``-fmad=false`` (no
    contraction of multiply-adds) next to the package's own library and
    return (ctypes handle, build seconds). The package builds and loads only
    its one flag set; this second library exists for the A/B alone."""
    import ctypes

    from xraytracer_tpu_torch import _build
    from xraytracer_tpu_torch.geometry import kernels

    t0 = time.perf_counter()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, "libsweep_fmad_false.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-fmad=false", "-o", out,
           os.path.join(_build.CSRC_DIR, "sweep.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    check(proc.returncode == 0, f"-fmad=false build failed:\n{proc.stderr}")
    return kernels._bind(ctypes.CDLL(out)), time.perf_counter() - t0


def phase_kernels(device, scenes_in, reps, fmad_ab):
    """Capture the sweeps' real inputs, then hold every kernel against its
    plain version on them and on the edge cases."""
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry import kernels
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    scenes = {}
    for label, (tables, camk, cosine) in scenes_in.items():
        st = scene_statics(tables)
        cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)
        integ = make_path_integrator(tables, st, DEPTH, nee=True,
                                     cosine_sampling=cosine)
        r = WavefrontRenderer(tables, cam, integ, WIDTH, HEIGHT, seed=0)
        got = capture_sweep_inputs(r)
        check(len(got["nearest"]) == DEPTH and len(got["shadow"]) == DEPTH,
              f"{label}: expected {DEPTH} sweeps of each kind in one sample")
        scenes[label] = (tables, dict(
            nearest={f"{label} depth-0 camera rays": got["nearest"][0],
                     f"{label} depth-1 bounce rays": got["nearest"][1]},
            shadow={f"{label} depth-0 shadow rays": got["shadow"][0],
                    f"{label} depth-1 shadow rays": got["shadow"][1]},
        ))

    def run_all_cases():
        merged = {k: [] for k in kernels.KERNEL_NAMES}
        for tables, sets in scenes.values():
            for k, v in kernel_cases(tables, sets, flush, reps).items():
                merged[k].extend(v)
        return merged

    cases = run_all_cases()
    edges = edge_cases(device)
    emit("kernel_checks", flags=[], cases=cases,
         edge_cases=edges, reps=reps, tolerances=dict(
             idx_mismatch_share_outside_tie_band=IDX_MISMATCH_SHARE,
             tie_band_rel_t=TIE_BAND, t=[T_RTOL, T_ATOL],
             uv=[UV_RTOL, UV_ATOL], rec_atol=REC_ATOL,
             blocked_mismatch_share=BLOCKED_MISMATCH_SHARE))
    if fmad_ab:
        lib, ab_build_s = load_sweep_without_fma()
        package_lib = kernels._lib
        kernels._lib = lambda: lib
        try:
            emit("kernel_checks", flags=["-fmad=false"],
                 build_seconds=ab_build_s, cases=run_all_cases(), reps=reps)
        finally:
            kernels._lib = package_lib
    return summarize(cases, {
        "sweep_nearest": "cornell depth-0 camera rays",
        "sweep_nearest_rec": "cornell depth-0 camera rays",
        "occluded_anyhit": "cornell depth-0 shadow rays",
    })


def phase_golden(device):
    """The CPU golden image, reproduced through the kernels."""
    import numpy as np

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry import kernels
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import render
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.scene.presets import build_cornell_box, cornell_camera

    golden = np.load(os.path.join(_HERE, "tests", "golden",
                                  "cornell_gi_32x24_8spp_seed0.npy"))
    gt = build_cornell_box().build(device)
    gcam = PinholeCamera.make(32 / 24, device=device, **cornell_camera())
    kernels.reset_counts()
    gr = render(gt, gcam, make_path_integrator(gt, scene_statics(gt), 3, nee=True),
                32, 24, 8, seed=0)
    gdiff = np.abs(gr.image - golden)
    gover = int((gdiff > 1e-6 + 1e-5 * np.abs(golden)).sum())
    emit("golden", max_abs_diff=float(gdiff.max()), values_over_gate=gover,
         values=int(golden.size), gate="rtol 1e-5 atol 1e-6",
         n_rejected=gr.n_rejected, launches=kernels.counts())
    check(gover == 0 and gr.n_rejected == 0,
          f"golden: {gover} values beyond rtol 1e-5 / atol 1e-6")


def phase_main(device, cfg, cornell, cornell_cam):
    """cornellbox_gi at full width through the entry points a user calls:
    its default route, then its ``tri_fn`` route. Returns the launch counts
    of each run, ``{"main_path": ..., "tri_fn_path": ...}``, each counted
    from 0 set just before the run and read just after it."""
    import numpy as np

    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry import kernels
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    statics = scene_statics(cornell)
    n_lights = statics["n_area_lights"]
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **cornell_cam)
    integ = cli.make_integrator(cfg, cornell, statics)
    renderer = WavefrontRenderer(cornell, cam, integ, cfg.width, cfg.height,
                                 seed=cfg.seed)
    renderer.render(1)  # warm-up: the first launches load the library
    ref_k, ref_p = reference_renders(cornell, cornell_cam, statics, cfg.spp,
                                     cfg.cosine_sampling, device)
    kernels.reset_counts()
    result = renderer.render(cfg.spp)
    counts_main = kernels.counts()
    line = render_checks("main_path", result, n_lights, cfg.spp,
                         counts_main, ref_k, ref_p)
    check(counts_main["sweep_nearest"]["launches"] == 0,
          "main_path: sweep_nearest launched on the default route")
    # the tri_fn route of the same path, with per-bounce counters: both
    # sweeps go through sweep_nearest, none through the other two kernels
    integ_s = make_path_integrator(
        cornell, statics, cfg.max_depth, nee=True, with_stats=True,
        tri_fn=kernels.sweep_nearest_tri_fn,
    )
    renderer_s = WavefrontRenderer(cornell, cam, integ_s, cfg.width, cfg.height,
                                   seed=cfg.seed)
    kernels.reset_counts()
    res_s = renderer_s.render(STATS_SPP)
    counts_tri = kernels.counts()
    check(res_s.n_rejected == 0, "tri_fn_path: rejected samples")
    check(bool(np.isfinite(res_s.image).all()), "tri_fn_path: non-finite pixels")
    k2_expected = STATS_SPP * DEPTH * (1 + n_lights)
    check(counts_tri["sweep_nearest"]["launches"] == k2_expected,
          f"tri_fn_path: sweep_nearest launched "
          f"{counts_tri['sweep_nearest']['launches']}x, expected {k2_expected}")
    check(counts_tri["sweep_nearest_rec"]["launches"] == 0
          and counts_tri["occluded_anyhit"]["launches"] == 0,
          "tri_fn_path: a sweep went through another kernel than sweep_nearest")
    check(sum(c["plain_calls"] for c in counts_tri.values()) == 0,
          "tri_fn_path: plain-version calls on the card")
    m_tri, m_main = float(res_s.image.mean()), float(result.image.mean())
    check(abs(m_tri - m_main) <= MEAN_BAND_FULL_VS_REF * m_main,
          f"tri_fn_path: mean {m_tri} vs main path {m_main}")
    line.update(
        preset="cornellbox_gi",
        stats_run=dict(
            spp=STATS_SPP, tri_fn="sweep_nearest", seconds=res_s.seconds,
            total_rays=res_s.total_rays,
            mrays_per_s=res_s.total_rays / res_s.seconds / 1e6,
            rays=res_s.stats["rays"].tolist(),
            shadow_rays=res_s.stats["shadow_rays"].tolist(),
            mean_radiance=m_tri,
            launches={k: v["launches"] for k, v in counts_tri.items()},
        ),
    )
    emit("main_path", **line)
    return {"main_path": counts_main, "tri_fn_path": counts_tri}


def phase_profile(device, cfg, cornell, cornell_cam, n_spp=2, top=12):
    """Trace ``n_spp`` samples of the main path: device busy share and the
    kernels that take most of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    statics = scene_statics(cornell)
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **cornell_cam)
    renderer = WavefrontRenderer(cornell, cam, cli.make_integrator(cfg, cornell, statics),
                                 cfg.width, cfg.height, seed=cfg.seed)
    renderer.render(1)
    plain = renderer.render(n_spp).seconds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = renderer.render(n_spp).seconds
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us and getattr(e, "device_type", None) is not None and \
                "cuda" in str(e.device_type).lower():
            rows.append((e.key, float(dev_us), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    emit("profile", spp=n_spp, seconds_untraced=plain, seconds_traced=traced,
         device_kernels=sum(r[2] for r in rows),
         device_busy_ms=busy_ms if rows else "not measured",
         device_busy_share=(busy_ms / (traced * 1e3)) if rows else "not measured",
         top=[dict(kernel=k[:90], ms=us / 1e3, launches=c) for k, us, c in rows[:top]])


def phase_mesh(device, mesh, mesh_cam):
    """The 13k-triangle mesh GI scene at full width. Returns the run's
    launch counts."""
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry import kernels
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    statics = scene_statics(mesh)
    cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **mesh_cam)
    integ = make_path_integrator(mesh, statics, DEPTH, nee=True,
                                 cosine_sampling=True)
    renderer = WavefrontRenderer(mesh, cam, integ, WIDTH, HEIGHT, seed=0)
    renderer.render(1)  # warm-up
    ref_k, ref_p = reference_renders(mesh, mesh_cam, statics, MESH_SPP, True,
                                     device)
    kernels.reset_counts()
    result = renderer.render(MESH_SPP)
    counts = kernels.counts()
    line = render_checks("mesh_path", result, statics["n_area_lights"],
                         MESH_SPP, counts, ref_k, ref_p)
    line.update(scene="lat-long sphere mesh %dx%d + floor + quad light" % MESH_SIZE,
                triangles=int((mesh.tri_obj >= 0).sum()),
                table_rows=int(mesh.tri_v0.shape[0]), cosine_sampling=True,
                pixel_order=renderer.pixel_order)
    emit("mesh_path", **line)
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fmad-ab", action="store_true",
                    help="also build and check the sweeps with -fmad=false")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 2 samples of the main path with torch.profiler")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed launches per kernel and case (median)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script never falls back to the CPU",
              file=sys.stderr)
        return 1

    from xraytracer_tpu_torch import _build, cli
    from xraytracer_tpu_torch.config import get_preset

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off")

    t_build = time.perf_counter()
    paths = _build.build(verbose=True)
    build_s = time.perf_counter() - t_build
    emit("build", seconds=build_s, libraries=sorted(
        os.path.relpath(p, _HERE) for p in paths.values()),
        flags=" ".join(_build.NVCC_FLAGS))

    cfg = get_preset("cornellbox_gi", width=WIDTH, height=HEIGHT, spp=MAIN_SPP)
    check((cfg.width, cfg.height, cfg.max_depth, cfg.integrator) ==
          (WIDTH, HEIGHT, DEPTH, "gi"), "cornellbox_gi preset changed")
    cornell, cornell_cam = cli.build_scene(cfg, device=device)
    mesh, mesh_cam = mesh_scene(device)

    entries = phase_kernels(device, {
        "cornell": (cornell, cornell_cam, False),
        "mesh13k": (mesh, mesh_cam, True),
    }, args.reps, args.fmad_ab)
    phase_golden(device)
    by_path = phase_main(device, cfg, cornell, cornell_cam)
    by_path["mesh_path"] = phase_mesh(device, mesh, mesh_cam)
    # the path on which each kernel must have run, by that path's own count
    runs_on = {"sweep_nearest": "tri_fn_path", "sweep_nearest_rec": "main_path",
               "occluded_anyhit": "main_path"}
    for e in entries:
        e["launches_by_path"] = {
            path: counts[e["name"]]["launches"] for path, counts in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        check(e["launches_by_path"][runs_on[e["name"]]] > 0,
              f"{e['name']} was never launched on {runs_on[e['name']]}")
    if args.profile:
        phase_profile(device, cfg, cornell, cornell_cam)

    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
