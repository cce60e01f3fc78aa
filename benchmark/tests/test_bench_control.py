"""The control: the plain reference in bfloat16, the precision below the
configurations' float32, put in the program's place, has to come out as
not correct under each configuration's limit."""

import pytest
import torch

from benchmark.control import control_numbers
from tiny import tiny_cell


@pytest.mark.parametrize("workload", ["cornell_gi.render", "cloud_nee.render",
                                      "cloud_volume.render"])
def test_bfloat16_control_fails_the_check(workload):
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    nums = control_numbers(cell, 2**31 + 5, 3, "cpu")
    assert nums["img_rel_l1"] > cell["config"]["check"]["limit"]


@pytest.mark.parametrize("workload", ["cornell_gi.render", "cloud_nee.render",
                                      "cloud_volume.render"])
def test_float32_in_the_programs_place_passes(workload):
    cell = tiny_cell(workload)
    nums = control_numbers(cell, 2**31 + 5, 2, "cpu", dt=torch.float32)
    assert nums["img_rel_l1"] < 1e-6     # float32 values against float64 sums


def test_bfloat16_control_fails_the_fit_check():
    torch.set_num_threads(2)
    cell = tiny_cell("cloud_nee.grad")
    nums = control_numbers(cell, 2**31 + 5, 0, "cpu")
    lim = cell["config"]["check"]["grad_limits"]
    assert any(nums[k] > lim[k] for k in lim), nums


def test_last_step_control_fails_and_the_program_passes():
    """The window's last step: the program passes; the bfloat16 reference
    and each planted fault in its place fail one of the last-step numbers."""
    from benchmark.control import last_step_controls

    torch.set_num_threads(2)
    cell = tiny_cell("cloud_nee.grad")
    lim = cell["config"]["check"]["grad_limits"]
    out = last_step_controls(cell, 2**31 + 9, 0.2, "cpu")
    assert out["index"] >= cell["traffic"]["first_steps"]
    assert all(v <= lim[k] for k, v in out["program"].items()), out["program"]
    for kind in ("bfloat16", "answer_altered", "half_batch"):
        assert any(v > lim[k] for k, v in out[kind].items()), (kind, out[kind])


def test_light_gap_counts_samples():
    """``light_gap_samples``: a pixel that sees the light and parts from the
    reference by one camera sample reads 1, wherever it lies among the
    checked light pixels; an answer 1% off reads about 1% of the spp; no
    light pixel reads 0. ``img_rel_l1`` of the other pixels is not moved by
    the light's pixels."""
    import numpy as np

    from benchmark.harness.check import light_gap, rel_l1
    from tiny import tiny_config

    cfg = tiny_config("cloud_volume")
    cfg["render"]["spp"] = 10240
    le = np.array([10.0] * 3)
    expect = np.array([le, le * 0.5, le * 9530 / 10240])
    parted = expect.astype(np.float32).copy()
    parted[2] += le / 10240
    assert light_gap(parted, expect, cfg) == pytest.approx(1.0, rel=1e-3)
    assert light_gap(parted[::-1], expect[::-1], cfg) == pytest.approx(1.0, rel=1e-3)
    assert light_gap((expect * 1.01).astype(np.float32), expect, cfg) == pytest.approx(
        102.4, rel=1e-3)
    assert light_gap(parted[:0], expect[:0], cfg) == 0.0
    cloud = np.array([[0.02] * 3, [0.0] * 3])
    assert rel_l1((cloud * 1.01).astype(np.float32), cloud) == pytest.approx(0.01, rel=1e-4)
