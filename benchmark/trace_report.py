"""One run of a one-card cell as ``benchmark/run.py`` makes it, and beside its
result line what the window held of the program's own spans, per unit of
work (a frame, a fit step):

    python3 benchmark/trace_report.py --workload cornell_gi.render --seed 11 --seconds 10 --trace 1 --record

``--trace 1``: the profiler over the window, as ``run.py --trace 1``; from
its trace, ``harness/spans.py``'s ``spans`` ([count, total ms, self ms]
per unit) and ``idle_by_span`` (idle ms per unit), and the clock check
(device start less its launch, us). ``--record``: the window inside the
port's ``tracing.record()``, the spans' [count, total ms, self ms] per unit
on the host's clock, with or without the profiler. Prints one JSON line,
``{"result": ..., "per_unit": ...}``. The benchmark's own runs do not run
it; ``PERF.md`` gives its readings.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _per_unit(totals, units):
    return {k: [c / units, t / units, s / units] for k, (c, t, s) in sorted(totals.items())}


def report(cell, seed, seconds, trace, record, device, require_route=True):
    """``run_cell.execute``'s result and the spans of its window."""
    from benchmark.harness import loops, run_cell, spans
    from benchmark.harness import trace as summary

    got = {}
    summarize, run_window = summary.summarize, loops.run_window

    def summarize_with_spans(events, *a, **k):
        got["spans"] = spans.summarize(events)
        got["clock"] = spans.clock_check(events)
        return summarize(events, *a, **k)

    def run_window_recorded(*a, **k):
        from xraytracer_tpu_torch import tracing

        with tracing.record() as kept:
            out = run_window(*a, **k)
        got["record"] = kept
        return out

    summary.summarize = summarize_with_spans
    if record:
        loops.run_window = run_window_recorded
    try:
        result = run_cell.execute(cell, seed, seconds, trace, time.time(), device,
                                  require_route=require_route)
    finally:
        summary.summarize, loops.run_window = summarize, run_window
    units = max(result["attempted"], 1)
    per_unit = {"units": result["attempted"]}
    if got.get("spans"):
        per_unit["spans"] = _per_unit(got["spans"]["spans"], units)
        per_unit["idle_by_span"] = {k: v / units for k, v in
                                    sorted(got["spans"]["idle_by_span"].items())}
        per_unit["clock"] = got["clock"]
    if "record" in got:
        kept = sorted(((s / 1e3, e / 1e3, name, 0) for name, _, s, e, _ in got["record"]),
                      key=lambda x: (x[0], -x[1]))
        per_unit["record"] = _per_unit(spans.span_totals(kept), units)
    return result, per_unit


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", action="store_true")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import manifest

    cell = manifest.cell(manifest.load(), args.workload)
    if cell["chips"] != 1 or not torch.cuda.is_available():
        print(f"{args.workload}: a one-card cell on a CUDA card only", file=sys.stderr)
        return 2
    result, per_unit = report(cell, args.seed, args.seconds, args.trace, args.record,
                              "cuda:0")
    print(json.dumps({"result": result, "per_unit": per_unit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
