"""The share of the traced window in which the device ran no operation but
a collective: one minus the union of the device's kernels, copies and fills
other than NCCL's inside the window over its length, in percent; the mean
over the ranks of a split cell (a rank waiting in the gather for the slowest
rank counts as idle). Moves ``msamples_per_s``."""

from benchmark.harness import trace

UNIT, LAYER, SOURCE, MOVES = "%", "device", "device_trace", "msamples_per_s"


def read(run):
    return trace.idle_percent(run)
