"""Seconds from the process's start (the first line of ``run.py``) to the
window's start: imports, the CUDA context, the scene, the libraries (built
by nvcc in a checkout's first run) and the warm-up. Host clock."""

UNIT, LAYER, SOURCE = "s", "end to end", "host_clock"


def read(run):
    return run.setup_s
