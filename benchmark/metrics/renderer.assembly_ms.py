"""Per frame, on the host's clock, from the end of the host's wait for the
frame's kernel to the end of the benchmark's span around ``render``: the
sums to the host, the scatter into the image and the division. Mean over
the window's frames. Moves ``msamples_per_s``."""

from benchmark.harness import trace

UNIT, LAYER, SOURCE, MOVES = "ms", "renderer", "program_span", "msamples_per_s"


def read(run):
    return trace.mean_frame_ms(run, "tail_ms")
