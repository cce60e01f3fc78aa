"""One run of one cell in this process: set-up, warm-up, the measured
window (traced with ``--trace 1``), the route check, the correctness check
and the metrics. A split cell runs this on every rank of its process group;
rank 0 gathers what the others measured and makes the result."""

import contextlib
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from . import check, loops, manifest, port, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "xraytracer_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _traced(enabled, device):
    if not enabled:
        return contextlib.nullcontext(None), (lambda name: contextlib.nullcontext())
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts), record_function


def _summary(prof, route_kernel):
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tracing.summarize(tracing.load_events(path), route_kernel)
    finally:
        os.remove(path)


def execute(cell, seed, seconds, trace, t_process, device, group=None,
            require_route=True):
    """Run the cell; returns the result dict on rank 0 (None elsewhere)."""
    device = torch.device(device)
    lead = group is None or group.rank == 0
    loop_cls = loops.LOOPS[cell["traffic"]["loop"]]
    t_build = time.time()
    loop = loop_cls(cell, seed, device, sharding=group)
    t_warm = time.time()
    loop.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if lead:
        print(f"set-up: {t_build - t_process:.3f} s to the scene, {t_warm - t_build:.3f} s "
              f"scene and inputs, {time.time() - t_warm:.3f} s warm-up", file=sys.stderr)
    route = cell["config"]["route"][cell["traffic"]["loop"]]
    route_kernel = next(iter(route))

    stop = None
    if group is not None and group.world > 1:
        import torch.distributed as dist

        flag = torch.zeros(1, dtype=torch.int32, device=device)

        def stop(done):
            flag.fill_(int(done))
            dist.broadcast(flag, src=0)
            return bool(flag.item())

        dist.barrier()
    prof_cm, span = _traced(bool(trace), device)
    port.reset_counts()
    with prof_cm as prof:
        with span("bench.window"):
            t_window = time.time()
            t0, records = loops.run_window(loop, seconds, span=span, stop=stop)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    counts = port.counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = _summary(prof, route_kernel) if trace else None

    n_steps = len(records)
    launches = {k: counts.get(k, (0, 0))[0] for k in route}
    plain = sum(p for _, p in counts.values())
    mine = {"peak": peak, "summary": summary, "launches": launches,
            "plain": plain}
    if group is not None and group.world > 1:
        import torch.distributed as dist

        every = [None] * group.world
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    if not lead:
        return None

    # the program's state goes before the reference runs on the device
    loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, tally = check.compare(cell, loop, records, device)
    print(f"{cell['name']}: {len(records)} steps; setup {t_window - t_process:.3f} s; "
          f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    if require_route:
        for k, per_step in route.items():
            numbers[f"launches.{k}"] = (min(m["launches"][k] for m in every),
                                        n_steps * int(per_step))
        numbers["plain_calls"] = (sum(m["plain"] for m in every), 0)

    run = SimpleNamespace(
        cell=cell, config=cell["config"], records=records, t0=t0,
        setup_s=t_window - t_process, traces=[m["summary"] for m in every],
        tally=tally, chips=cell["chips"])
    metrics = {}
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    for m in wanted:
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    failed = sum(1 for r in records if not r["ok"])
    correct = failed == 0 and bool(records) and all(
        _within(name, v, lim) for name, (v, lim) in numbers.items())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": max(m["peak"] for m in every)}
    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and all(s is not None for s in run.traces):
        dev["busy_s"] = sum(s["busy_s"] for s in run.traces) / len(run.traces)
        dev["window_s"] = sum(s["window_s"] for s in run.traces) / len(run.traces)
        result["breakdown"] = {"device_ops": run.traces[0]["device_ops"],
                               "idle_gaps": run.traces[0]["idle_gaps"]}
    errors = sorted({r["error"] for r in records if r.get("error")})
    for e in errors[:5]:
        print(f"frame error: {e}", file=sys.stderr)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in numbers.items()}
    return result


def _within(name, value, limit):
    if name.startswith("launches."):
        return value == limit
    return value <= limit
