"""``msamples_per_s`` in the surface cells: the same rate, kept apart
because their frames are host-paced (a Cornell frame spends ~40% of its
time on the host) and spread ~20x wider from run to run than the volume
cells", so the two need bounds of their own."""

from benchmark.harness import manifest

UNIT, LAYER, SOURCE = "Msamples/s", "end to end", "host_clock"

read = manifest.reader("msamples_per_s").read
