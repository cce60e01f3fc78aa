"""The program's own spans in a ``torch.profiler`` trace (the port's
``tracing.span``: ``user_annotation`` events named ``layer.phase``), read
on the host's clock. ``trace.summarize`` does not call this module; a
summary that adds ``summarize(events)``'s two keys keeps every key it has.

* ``spans``: per span name inside the benchmark's window (its own
  ``bench.window`` / ``bench.step`` left out), ``[count, total_ms,
  self_ms]``; self time is the duration less the part that spans nested in
  it on the same thread cover.
* ``idle_by_span``: the window's idle time put down to the program's spans.
  For each gap ``(a, b)`` between the device's merged operations (the gaps
  of ``trace.summarize``'s ``idle_gaps``), the operation that starts at
  ``b`` was launched on the host at ``L`` (the runtime call with the same
  ``args.correlation``); the host interval ``[L - (b - a), L]`` is what the
  host did while the device waited, and it is split over the innermost
  program span open at each instant, ``(no program span)`` where none is.
  Only a duration crosses from the device's clock to the host's. A gap
  whose operation has no correlated launch (the window's last gap) is named
  by the innermost span open at its middle, as ``idle_gaps`` does.

``clock_check(events)`` gives the other side of that choice: for every
device operation in the window with a correlated launch, its start less
the launch's, in microseconds. A negative offset is an operation that the
trace puts before its own launch: the converted device timeline is late or
early by at least that much.
"""

import bisect

from . import trace

NO_SPAN = "(no program span)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _window(events, window_name):
    for e in events:
        if e.get("name") == window_name and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def _interval(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def program_spans(events, lo, hi, skip=("bench.window", "bench.step")):
    """(start, end, name, tid) of the program's spans inside ``[lo, hi]``,
    sorted by start, a parent before a child that starts with it."""
    out = []
    for e in events:
        if e.get("cat") != "user_annotation" or e.get("name") in skip:
            continue
        s, t = _interval(e)
        if s >= lo and t <= hi:
            out.append((s, t, e.get("name", ""), e.get("tid")))
    out.sort(key=lambda x: (x[0], -x[1]))
    return out


class _Open:
    """The innermost span open at an instant: the latest-starting span that
    holds it. Spans nest within a call, so none lasts longer than
    ``longest``: only those starting that far back are looked at."""

    def __init__(self, spans):
        self.spans = spans
        self.starts = [s for s, *_ in spans]
        self.longest = max((t - s for s, t, *_ in spans), default=0.0)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t)
        j = bisect.bisect_left(self.starts, t - self.longest)
        best = None
        for s, e, name, _ in self.spans[j:i]:
            if s <= t <= e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else NO_SPAN

    def split(self, x, y, into):
        """Add the host interval ``[x, y]`` to ``into`` by the innermost span
        open over each piece of it."""
        i = bisect.bisect_right(self.starts, y)
        j = bisect.bisect_left(self.starts, x - self.longest)
        cuts = {x, y}
        for s, e, *_ in self.spans[j:i]:
            cuts.update(c for c in (s, e) if x < c < y)
        cuts = sorted(cuts)
        for p, q in zip(cuts, cuts[1:]):
            name = self.at(0.5 * (p + q))
            into[name] = into.get(name, 0.0) + (q - p) / 1e3


def span_totals(spans):
    """name -> [count, total_ms, self_ms] of ``program_spans``' spans."""
    out = {}
    starts = [s for s, *_ in spans]
    for k, (s, e, name, tid) in enumerate(spans):
        inner = [(s2, e2) for s2, e2, _, tid2 in spans[k + 1:bisect.bisect_right(starts, e)]
                 if tid2 == tid and e2 <= e]
        covered = sum(b - a for a, b in trace.union(inner))
        row = out.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e3
        row[2] += (e - s - covered) / 1e3
    return out


def _gaps(dev, lo, hi):
    """The gaps between the merged device operations inside the window, as
    ``trace.summarize`` finds them."""
    inside = trace.clip(trace.union([(s, e) for s, e, *_ in dev]), lo, hi)
    gaps, prev = [], lo
    for s, e in inside:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    return gaps


def _device_and_launches(events, lo, hi):
    dev = [(*_interval(e), _correlation(e)) for e in events
           if e.get("cat") in trace.DEVICE_CATS]
    dev = [d for d in dev if d[1] > lo and d[0] < hi]
    launch = {_correlation(e): float(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS and _correlation(e) is not None}
    return dev, launch


def idle_by_span(events, lo, hi, spans=None):
    """name -> idle ms of the window put down to it (see the module
    docstring)."""
    spans = program_spans(events, lo, hi) if spans is None else spans
    dev, launch = _device_and_launches(events, lo, hi)
    starting = {}
    for s, _, c in dev:
        if c in launch:
            starting.setdefault(s, launch[c])
    opened = _Open(spans)
    out = {}
    for a, b in _gaps(dev, lo, hi):
        if b in starting:
            at = starting[b]
            opened.split(at - (b - a), at, out)
        else:
            name = opened.at(0.5 * (a + b))
            out[name] = out.get(name, 0.0) + (b - a) / 1e3
    return out


def clock_check(events, window_name="bench.window"):
    """Device start less its launch's start (us), for every device
    operation in the window with a correlated launch: the count, the count
    below zero, and the quantiles 0, 5, 50, 95 and 100%."""
    w = _window(events, window_name)
    if w is None:
        return None
    dev, launch = _device_and_launches(events, *w)
    offs = sorted(s - launch[c] for s, _, c in dev if c in launch)
    if not offs:
        return {"count": 0}
    at = [offs[min(len(offs) - 1, int(p * len(offs)))] for p in (0.05, 0.5, 0.95)]
    return {"count": len(offs), "before_launch": sum(o < 0 for o in offs),
            "min_us": offs[0], "p5_us": at[0], "median_us": at[1], "p95_us": at[2],
            "max_us": offs[-1]}


def summarize(events, window_name="bench.window"):
    """``{"spans": ..., "idle_by_span": ...}`` of one rank's trace, None
    without the window."""
    w = _window(events, window_name)
    if w is None:
        return None
    spans = program_spans(events, *w)
    return {"spans": span_totals(spans), "idle_by_span": idle_by_span(events, *w, spans)}
