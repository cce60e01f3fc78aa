"""Camera samples (pixels x spp) of every frame completed in the window,
over the time from the window's start to the last frame's end, in millions
per second. Host clock; every frame counts, the slow ones too. The volume
cells' rate (``msamples_per_s.surface`` is the same rate in the cells whose
frames are host-paced and spread ~20x wider from run to run)."""

from benchmark.harness import loops

UNIT, LAYER, SOURCE = "Msamples/s", "end to end", "host_clock"


def read(run):
    return loops.samples_rate(run)
