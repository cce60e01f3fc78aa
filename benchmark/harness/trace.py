"""Reading a ``torch.profiler`` trace: the device's operations on the
trace's own timeline, the benchmark's spans, and what one rank's run did.

The summary of a rank (``summarize``) is a plain dict, so the ranks of a
split run can send theirs to rank 0:

* ``window_s``: the length of the benchmark's ``bench.window`` span;
* ``busy_s``: the union of the device's operations (kernels, copies,
  fills) inside that window, overlapping intervals counted once;
  ``work_s`` the same union without the collectives (NCCL kernels), whose
  time on a rank is mostly its wait for the slowest rank;
* ``frames``: per ``bench.step`` span, ``lead_ms`` (span start to the start
  of the host's longest wait on the device inside it: the wait for the
  step's main kernel) and ``tail_ms`` (that wait's end to the span's end),
  None where the span holds no wait. Both are read on the host's own clock:
  the device's timestamps, converted to the host's timeline, were seen off
  by ~30 ms late in a 30-s window, so no number here subtracts a host time
  from a device time;
* ``route_s``: the route kernel's device time in the window, ``n_steps``
  the spans;
* ``collective_s``: the collectives' (NCCL kernels') device time;
* ``device_s``: device seconds in the window by operation name;
  ``device_ops`` the ten largest;
* ``idle_gaps``: the ten longest gaps between device operations inside the
  window, each named by the innermost host event open at its middle.
"""

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def load_events(path):
    with open(path) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def _label(host, t):
    """The innermost (latest-starting) host event open at time ``t``."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "(no host event)"


def summarize(events, route_kernel, window_name="bench.window",
              step_name="bench.step"):
    """One rank's summary of a trace (see the module docstring); times in
    the trace are microseconds."""
    windows = [e for e in events if e.get("name") == window_name
               and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    w = windows[0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
           for e in events if e.get("cat") in DEVICE_CATS]
    dev = [d for d in dev if d[1] > lo and d[0] < hi]
    merged = union([(s, e) for s, e, _ in dev])
    inside = clip(merged, lo, hi)
    busy = sum(e - s for s, e in inside)
    work = sum(e - s for s, e in clip(union([(s, e) for s, e, n in dev
                                              if not _collective(n)]), lo, hi))
    route = [(s, e) for s, e, n in dev if route_kernel in n]
    waits = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in HOST_CATS
                   and "Synchronize" in e.get("name", ""))
    starts = [s for s, _ in waits]
    frames = []
    for ev in events:
        if ev.get("name") != step_name or ev.get("cat") != "user_annotation":
            continue
        s0, s1 = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        mine = waits[bisect.bisect_left(starts, s0):bisect.bisect_right(starts, s1)]
        f = {"lead_ms": None, "tail_ms": None}
        if mine:
            a, b = max(mine, key=lambda w: w[1] - w[0])
            f = {"lead_ms": (a - s0) / 1e3, "tail_ms": (s1 - b) / 1e3}
        frames.append(f)
    by_name = {}
    for s, e, n in dev:
        s, e = max(s, lo), min(e, hi)
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
            for e in events if e.get("cat") in HOST_CATS
            and e.get("name") not in (window_name, step_name)]
    gaps = []
    prev = lo
    for s, e in inside:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "work_s": work / 1e6,
        "frames": frames,
        "n_steps": len(frames),
        "route_s": sum(min(e, hi) - max(s, lo) for s, e in route) / 1e6,
        "collective_s": sum(min(e, hi) - max(s, lo) for s, e, n in dev
                            if _collective(n)) / 1e6,
        "device_s": by_name,
        "device_ops": sorted(([n, v] for n, v in by_name.items()),
                             key=lambda kv: kv[1], reverse=True)[:10],
        "idle_gaps": [[_label(host, 0.5 * (a + b)), (b - a) / 1e6]
                      for a, b in gaps[:10]],
    }


def _collective(name):
    return name.lower().startswith("nccl")


def mean_frame_ms(run, key):
    """The mean over rank 0's frames of ``lead_ms`` or ``tail_ms``."""
    s = run.traces[0]
    vals = [f[key] for f in (s or {}).get("frames", ()) if f[key] is not None]
    return sum(vals) / len(vals) if vals else None


def idle_percent(run):
    """The traced window's share in which the device ran no operation but a
    collective, mean over ranks: a rank that waits in the gather for the
    slowest rank counts as idle (the exchange itself is
    ``parallel.gather_ms``'s)."""
    if not run.traces or any(s is None or s["window_s"] <= 0 for s in run.traces):
        return None
    return 100.0 * sum(1.0 - s["work_s"] / s["window_s"] for s in run.traces) / len(run.traces)
