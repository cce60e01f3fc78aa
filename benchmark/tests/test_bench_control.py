"""The control: the plain reference in bfloat16, the precision below the
configurations' float32, put in the program's place, has to come out as
not correct under each configuration's limit."""

import pytest
import torch

from benchmark.control import control_numbers
from tiny import tiny_cell


@pytest.mark.parametrize("workload", ["cornell_gi.render", "cloud_nee.render"])
def test_bfloat16_control_fails_the_check(workload):
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    nums = control_numbers(cell, 2**31 + 5, 3, "cpu")
    assert nums["img_rel_l1"] > cell["config"]["check"]["limit"]


@pytest.mark.parametrize("workload", ["cornell_gi.render", "cloud_nee.render"])
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
