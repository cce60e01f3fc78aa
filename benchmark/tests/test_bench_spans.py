"""Reading the program's own spans in a trace (``harness/spans.py``): self
time under nested spans; idle time put down to the span the host was in
while the device waited, on the host's clock, where the device's converted
timestamps sit 30 ms late; the clock check; and a run of the tiny cell
whose trace and record hold the renderer's spans once a frame."""

import copy
import json
import os
import subprocess
import sys

from benchmark.harness import spans, trace

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(TESTS))
SKEW = 30000.0      # us: the device's timestamps, converted, sit this late


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def frame_trace(skew=SKEW, launched=True):
    """A window of 100 ms: the host assembles the last frame (0-20 ms),
    builds the next (20-40), launches its kernel at 40.5 ms and waits for
    it; the device ran the last frame's kernel to 0 and runs the next one
    from 40.52 ms, both stamped ``skew`` late."""
    corr = {"correlation": 1} if launched else {}
    return [
        ev("bench.window", "user_annotation", 0, 100000),
        ev("renderer.scatter", "user_annotation", 0, 20000),
        ev("renderer.build", "user_annotation", 20000, 20000),
        ev("renderer.launch", "user_annotation", 40000, 1000),
        ev("cudaLaunchKernel", "cuda_runtime", 40500, 20, **corr),
        ev("renderer.wait", "user_annotation", 41000, 59000),
        ev("cudaDeviceSynchronize", "cuda_runtime", 41000, 58000),
        ev("cudaLaunchKernel", "cuda_runtime", -60010, 20, correlation=0),
        ev("mega_spp_persistent", "kernel", -60000 + skew, 60000, tid=7, correlation=0),
        ev("mega_spp_persistent", "kernel", 40520 + skew, 59480, tid=7, **corr),
    ]


def test_idle_is_put_on_the_span_the_host_was_in():
    events = frame_trace()
    got = spans.idle_by_span(events, 0, 100000)
    # the gap (30, 70.52 ms) on the device's stamps is the 40.52 ms before
    # the launch on the host's clock
    want = {spans.NO_SPAN: 0.02, "renderer.scatter": 20.0, "renderer.build": 20.0,
            "renderer.launch": 0.5}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) < 1e-9, k
    # the same trace unskewed gives the same split
    unskewed = spans.idle_by_span(frame_trace(skew=0.0), 0, 100000)
    assert all(abs(unskewed[k] - v) < 1e-9 for k, v in want.items())
    # the midpoint of the skewed gap falls in the host's wait
    s = trace.summarize(events, "mega_spp_persistent")
    assert s["idle_gaps"][0][0] == "cudaDeviceSynchronize"
    assert abs(s["idle_gaps"][0][1] - 40520 / 1e6) < 1e-12


def test_a_gap_without_a_launch_is_named_at_its_middle():
    got = spans.idle_by_span(frame_trace(launched=False), 0, 100000)
    assert list(got) == ["renderer.wait"] and abs(got["renderer.wait"] - 40.52) < 1e-9


def test_self_time_of_a_parent_with_two_children():
    events = [
        ev("bench.window", "user_annotation", 0, 1000),
        ev("bench.step", "user_annotation", 0, 1000),
        ev("renderer.render", "user_annotation", 0, 100),
        ev("renderer.build", "user_annotation", 0, 30),       # starts with its parent
        ev("renderer.scatter", "user_annotation", 50, 40),
        ev("renderer.inner", "user_annotation", 60, 10),      # inside scatter
        ev("other.thread", "user_annotation", 20, 60, tid=2),
        ev("renderer.render", "user_annotation", 200, 10),
        ev("after.window", "user_annotation", 990, 20),
    ]
    got = spans.summarize(events)["spans"]
    assert set(got) == {"renderer.render", "renderer.build", "renderer.scatter",
                        "renderer.inner", "other.thread"}
    count, total, own = got["renderer.render"]
    assert count == 2 and abs(total - 0.110) < 1e-12
    assert abs(own - (0.100 - 0.030 - 0.040 + 0.010)) < 1e-12
    assert got["renderer.scatter"] == [1, 0.04, 0.03]
    assert got["other.thread"] == [1, 0.06, 0.06]


def test_program_spans_change_no_summary_key_but_the_gaps_names():
    base = [
        ev("bench.window", "user_annotation", 0, 1000),
        ev("bench.step", "user_annotation", 0, 500),
        ev("bench.step", "user_annotation", 500, 500),
        ev("cudaDeviceSynchronize", "cuda_runtime", 40, 270),
        ev("cudaStreamSynchronize", "cuda_runtime", 320, 80),
        ev("cudaDeviceSynchronize", "cuda_runtime", 550, 360),
        ev("fill_kernel", "kernel", 20, 30),
        ev("het_spp_persistent_kernel(X)", "kernel", 40, 260),
        ev("Memcpy DtoH", "gpu_memcpy", 310, 100),
        ev("het_spp_persistent_kernel(X)", "kernel", 600, 300),
    ]
    program = [ev("renderer.render", "user_annotation", 1, 498),
               ev("renderer.scatter", "user_annotation", 410, 88),
               ev("renderer.render", "user_annotation", 501, 498),
               ev("renderer.wait", "user_annotation", 550, 361)]
    a = trace.summarize(copy.deepcopy(base), "het_spp_persistent")
    b = trace.summarize(base + program, "het_spp_persistent")
    assert a.keys() == b.keys()
    for k in a:
        if k != "idle_gaps":
            assert a[k] == b[k], k
    assert [g[1] for g in a["idle_gaps"]] == [g[1] for g in b["idle_gaps"]]
    assert a["idle_gaps"][0][0] == "(no host event)"
    assert b["idle_gaps"][0][0] == "renderer.render"     # its middle, 505


def test_clock_check_counts_operations_before_their_launch():
    late = spans.clock_check(frame_trace())
    assert late["count"] == 2 and late["before_launch"] == 0
    assert abs(late["min_us"] - (SKEW + 10)) < 1e-9 and abs(late["max_us"] - (SKEW + 20)) < 1e-9
    # stamped early, the last frame's kernel ends before the window
    early = spans.clock_check(frame_trace(skew=-SKEW))
    assert early["count"] == early["before_launch"] == 1 and early["max_us"] < 0


RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from benchmark import trace_report
from tiny import tiny_cell
res, per_unit = trace_report.report(tiny_cell("cornell_gi.render"), 5, 0.3, 1, True, "cpu",
                                    require_route=False)
print(json.dumps({{"correct": res["correct"], "per_unit": per_unit}}))
"""


def test_a_traced_and_recorded_run_holds_the_renderer_spans_once_a_frame():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(root=ROOT, tests=TESTS)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    per_unit = got["per_unit"]
    assert per_unit["units"] >= 1
    for sink in ("spans", "record"):
        rows = per_unit[sink]
        for name in ("renderer.render", "renderer.build", "renderer.pixel_grid",
                     "renderer.launch", "renderer.wait", "renderer.readback",
                     "renderer.scatter"):
            count, total, own = rows[name]
            assert count == 1.0 and total >= own >= 0.0, (sink, name)
        # the whole frame's host time is the top span's, its children inside it
        top = rows["renderer.render"]
        inner = sum(rows[n][1] for n in ("renderer.build", "renderer.launch",
                                         "renderer.wait", "renderer.readback",
                                         "renderer.scatter"))
        assert inner <= top[1] + 1e-9
        assert abs(top[1] - top[2] - inner) < 1e-6 * max(top[1], 1.0)
    # on the CPU the profiler sees no device operation: no gap has a launch
    assert per_unit["clock"] == {"count": 0}
