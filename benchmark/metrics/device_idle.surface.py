"""``device_idle.render`` in the cells whose rate is ``msamples_per_s.surface``."""

from benchmark.harness import manifest

UNIT, LAYER, SOURCE, MOVES = "%", "device", "device_trace", "msamples_per_s.surface"

read = manifest.reader("device_idle.render").read
