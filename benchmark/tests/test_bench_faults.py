"""A run with the timed path broken underneath has to come out as not
correct, once for each fault a render cell can have; the same run unbroken
comes out correct. The harness's look for a card is the only step skipped:
the runs are on the CPU at a small size, through the program's plain route."""

import multiprocessing
import socket
import time

import pytest
import torch

import faults
from benchmark.harness import run_cell
from split_worker import worker
from tiny import tiny_cell


def _run(workload, fault, monkeypatch):
    from xraytracer_tpu_torch import renderer
    from xraytracer_tpu_torch.integrators import het_megakernel

    torch.set_num_threads(2)
    monkeypatch.setattr(renderer.WavefrontRenderer, "render",
                        renderer.WavefrontRenderer.render)
    monkeypatch.setattr(renderer, "gather_rows", renderer.gather_rows)
    monkeypatch.setattr(het_megakernel, "try_make_fused_het_value_and_grad",
                        het_megakernel.try_make_fused_het_value_and_grad)
    faults.apply(fault)
    return run_cell.execute(tiny_cell(workload), 2**31 + 3, 0.3, 0, time.time(),
                            "cpu", require_route=False)


@pytest.mark.parametrize("workload", ["cornell_gi.render", "cloud_nee.render",
                                      "cloud_volume.render", "cloud_nee.grad"])
def test_unbroken_run_is_correct(workload, monkeypatch):
    res = _run(workload, None, monkeypatch)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("workload", ["cornell_gi.render", "cloud_nee.render",
                                      "cloud_volume.render"])
def test_broken_run_is_not_correct(workload, fault, monkeypatch):
    res = _run(workload, fault, monkeypatch)
    assert not res["correct"]
    assert res["checks"]["img_rel_l1"]["value"] > res["checks"]["img_rel_l1"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_broken_fit_step_is_not_correct(fault, monkeypatch):
    res = _run("cloud_nee.grad", "grad." + fault, monkeypatch)
    assert not res["correct"]
    failing = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failing, res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_in_the_timed_steps_alone_is_not_correct(fault, monkeypatch):
    """The first steps run unbroken; the window's last step is compared."""
    res = _run("cloud_nee.grad", "grad.late." + fault, monkeypatch)
    assert not res["correct"]
    first = ("loss_gap", "img_rel_l1", "grad_gap", "step_gap")
    assert all(res["checks"][k]["value"] <= res["checks"][k]["limit"] for k in first)
    failing = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failing and all(k.startswith("last_") for k in failing), res["checks"]


def _split(fault):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, 2, port, "cloud_nee.render.x4", fault, q))
             for r in range(2)]
    for p in procs:
        p.start()
    res = q.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    return res


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_split_run_without_its_exchange_is_not_correct(fault):
    res = _split(fault)
    assert res["correct"] == (fault is None)
