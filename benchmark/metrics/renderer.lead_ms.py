"""Per frame, on the host's clock, from the start of the benchmark's span
around ``render`` to the start of the host's wait for the frame's kernel:
the renderer's construction, its accumulator and the launch. Mean over the
window's frames. Moves ``msamples_per_s``."""

from benchmark.harness import trace

UNIT, LAYER, SOURCE, MOVES = "ms", "renderer", "program_span", "msamples_per_s"


def read(run):
    return trace.mean_frame_ms(run, "lead_ms")
