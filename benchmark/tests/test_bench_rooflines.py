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
