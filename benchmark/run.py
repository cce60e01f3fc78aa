"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the run makes its inputs from
``--seed``, builds the scene through the port, warms up, measures for
``--seconds``, checks the window's output against the plain reference and
prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and ``checks`` (each
number compared, with its limit). It exits non-zero, printing no result,
without as many CUDA cards as the cell asks for, or when JAX or the JAX
package was loaded. A cell on several cards spawns one process per card.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a split cell, spawned by this script itself
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    p.add_argument("--t-process", type=float, default=None, dest="t_process",
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def emit(result):
    """The checks as the last lines of standard error, then the line."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)


def main(argv=None):
    args = parse(argv)
    import torch

    from benchmark.harness import manifest, multirank, run_cell

    cell = manifest.cell(manifest.load(), args.workload)
    chips = cell["chips"]
    if args.rank is not None:
        if args.rank == 0:
            print(f"rank 0: started {time.time() - args.t_process:.3f} s after the "
                  "launcher", file=sys.stderr)
        group = multirank.rank_group(args.rank, args.world, args.rendezvous)
        if args.rank == 0:
            print(f"rank 0: in the group {time.time() - args.t_process:.3f} s after "
                  "the launcher", file=sys.stderr)
        result = run_cell.execute(cell, args.seed, args.seconds, args.trace,
                                  args.t_process, group.device, group=group)
        import torch.distributed as dist

        dist.destroy_process_group()
        if result is not None:
            bad = run_cell.forbidden_modules()
            if bad:
                print(f"loaded: {', '.join(bad)}", file=sys.stderr)
                return 3
            print(json.dumps(result), flush=True)
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1:
        from xraytracer_tpu_torch import _build

        _build.build()      # once, before the ranks look for the libraries
        line = multirank.launch(os.path.abspath(__file__), args, chips, T_PROCESS)
        if line is None:
            return 1
        result = json.loads(line)
    else:
        result = run_cell.execute(cell, args.seed, args.seconds, args.trace,
                                  T_PROCESS, "cuda:0")
    bad = run_cell.forbidden_modules()
    if bad:
        print(f"loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
