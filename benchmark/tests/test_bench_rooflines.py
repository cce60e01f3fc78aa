"""Each roofline count against a hand count on a tiny scene."""

from types import SimpleNamespace

import pytest

from benchmark.harness import manifest
from benchmark.rooflines import peaks
from tiny import tiny_config


def test_k1c_hand_count():
    cfg = tiny_config("cornell_gi")             # 16 x 12 pixels, 36 triangles (34 + the light's 2)
    run = SimpleNamespace(config=cfg, tally={"rays": 1000, "shadow_rays": 300})
    flops = (1000 * 36 * 38) + (300 * 36 * 39)
    n_bytes = 192 * 28 + 36 * 166 + 80
    expect = max(flops / 67e12, n_bytes / 3.35e12)
    assert manifest.roofline("k1c").bound(run) == pytest.approx(expect, rel=1e-12)


def test_k9c_hand_count():
    cfg = tiny_config("cloud_nee")              # 12 x 9 pixels, one sphere light
    tally = dict(rays=100, scattered=10, sample_lanes=50, sample_segments=400,
                 sample_candidates=300, tr_lanes=10, tr_segments=80, tr_candidates=60)
    run = SimpleNamespace(config=cfg, tally=tally)
    flops = (100 * (30 + 30 + 8) + 400 * 32 + 300 * 150
             + 10 * (45 + 75 + 60 + 30) + 80 * 32 + 60 * 70)
    n_bytes = 108 * 28 + 4 * (64 ** 3 + 8 ** 3)
    expect = max(flops / 67e12, n_bytes / 3.35e12)
    assert manifest.roofline("k9c").bound(run) == pytest.approx(expect, rel=1e-12)
    # the count before NEE's terms were made conditional, and the bound's bits
    assert manifest.roofline("k9c").path_flops(cfg, tally) == flops == 73460
    assert manifest.roofline("k9c").bound(run).hex() == "0x1.51b71773cbef4p-22"


def test_k9c_hand_count_without_nee():
    """Without NEE a scatter costs its phase direction alone, and no shadow
    ray is tracked."""
    cfg = tiny_config("cloud_volume")           # 8 x 8 pixels, one sphere light
    assert cfg["render"]["integrator"] == "vpt"
    tally = dict(rays=100, scattered=10, sample_lanes=50, sample_segments=400,
                 sample_candidates=300, tr_lanes=0, tr_segments=0, tr_candidates=0)
    flops = 100 * (30 + 30 + 8) + 400 * 32 + 300 * 150 + 10 * 45
    k9c = manifest.roofline("k9c")
    assert k9c.path_flops(cfg, tally) == flops
    # stray shadow-ray tallies are not counted without NEE
    assert k9c.path_flops(cfg, dict(tally, tr_segments=80, tr_candidates=60)) == flops
    run = SimpleNamespace(config=cfg, tally={k: v * 1e6 for k, v in tally.items()})
    n_bytes = 64 * 28 + 4 * (64 ** 3 + 8 ** 3)
    expect = max(flops * 1e6 / 67e12, n_bytes / 3.35e12)
    assert k9c.bound(run) == pytest.approx(expect, rel=1e-12)


def test_frame_count_does_not_follow_the_seed():
    """A configuration's ``count``: the tallies the rooflines read come from
    fixed pixels at a fixed seed, the same whatever ``--seed`` draws."""
    import numpy as np
    import torch

    from benchmark.harness import check, inputs
    from tiny import tiny_cell

    torch.set_num_threads(2)
    cell = tiny_cell("cloud_volume.render")
    cfg = cell["config"]
    cfg["count"]["stride"] = 2             # 16 of the tiny frame's 64 pixels
    grid = inputs.density_grid(cfg)
    strata = inputs.pixel_strata(cfg)
    tallies = []
    for seed in (2**31 + 1, 2**40 + 7):
        px = inputs.frame_pixels(cfg, strata, seed, 0)
        recs = [{"seed": inputs.frame_seed(seed, 0), "pixels": px,
                 "values": np.zeros((len(px), 3), np.float32)}]
        tallies.append(check.compare(cell, SimpleNamespace(grid=grid), recs, "cpu")[1])
    assert tallies[0] == tallies[1] and tallies[0]["sample_candidates"] > 0


def test_peaks_bound_is_the_larger():
    assert peaks.bound_s(3.35e12, 0) == 1.0
    assert peaks.bound_s(0, 134e12) == 2.0


def test_k9a_and_k10_hand_counts():
    cfg = tiny_config("cloud_nee")              # 2 x 108 lanes a step
    tally = dict(rays=100, scattered=10, sample_lanes=50, sample_segments=400,
                 sample_candidates=300, tr_lanes=10, tr_segments=80, tr_candidates=60)
    run = SimpleNamespace(config=cfg, tally=tally)
    paths = (100 * (30 + 30 + 8) + 400 * 32 + 300 * 150
             + 10 * (45 + 75 + 60 + 30) + 80 * 32 + 60 * 70)
    grid = 4 * (64 ** 3 + 8 ** 3)
    a = max(paths / 67e12, (216 * 40 + grid) / 3.35e12)
    assert manifest.roofline("k9a").bound(run) == pytest.approx(a, rel=1e-12)
    b = max((paths + 300 * 80 + 60 * 45) / 67e12,
            (216 * (52 + 12 + 12) + grid + 4 * 64 ** 3) / 3.35e12)
    assert manifest.roofline("k10").bound(run) == pytest.approx(b, rel=1e-12)
