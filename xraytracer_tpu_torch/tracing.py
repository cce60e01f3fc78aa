"""Spans: named stretches of the port's host work, ``layer.phase``.

``span(name, args=())`` is a context manager with three sinks:

* off (no ``torch.profiler`` recording, no ``record()`` open): one shared
  no-op object, after one flag test: no allocation, no dispatcher call, no
  clock read;
* under ``torch.profiler``: a ``record_function`` span on the host timeline
  of the trace's launches and device operations (``user_annotation`` in a
  Chrome trace); ``args`` (integers, or tensors) are its inputs, which the
  trace shows where the profiler records shapes;
* under ``record()``: ``(name, args, start_ns, end_ns, depth)`` on
  ``time.perf_counter_ns``, kept in memory and returned when ``record()``
  closes. This times the phases without a profiler.

Both sinks take a span when both are on. The top span of a call carries
its identifier in ``args`` (a render's seed, a gradient step's sample
indices), so the spans of one frame can be told apart in either sink.
``record()`` collects the spans of every thread of the process.
"""

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

_recorder = None   # the open record()'s list of spans
_depth = 0         # spans open in that record


OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "args", "handle", "sink", "depth", "start")

    def __init__(self, name, args):
        self.name, self.args = name, tuple(args)
        self.handle = self.sink = None

    def __enter__(self):
        global _depth
        if _profiler._is_profiler_enabled:
            self.handle = torch.autograd._record_function_with_args_enter(
                self.name, *(a if torch.is_tensor(a) else int(a) for a in self.args))
        if _recorder is not None:
            self.sink, self.depth = _recorder, _depth
            _depth += 1
            self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        global _depth
        if self.sink is not None:
            end = time.perf_counter_ns()
            if self.sink is _recorder:
                _depth -= 1
            self.sink.append((self.name, self.args, self.start, end, self.depth))
        if self.handle is not None:
            torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name, args=()):
    """A span named ``name`` (``layer.phase``) with integer ``args``."""
    if _recorder is None and not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, args)


@contextlib.contextmanager
def record():
    """Keep the spans closed inside the block: yields the list that holds
    them, ``(name, args, start_ns, end_ns, depth)`` in the order they
    closed (a child before its parent), ``depth`` 0 for a span opened with
    none open."""
    global _recorder, _depth
    prev = _recorder, _depth
    _recorder, _depth = [], 0
    try:
        yield _recorder
    finally:
        _recorder, _depth = prev
