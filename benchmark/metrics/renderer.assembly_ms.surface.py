"""``renderer.assembly_ms`` in the cells whose rate is ``msamples_per_s.surface``."""

from benchmark.harness import manifest

UNIT, LAYER, SOURCE, MOVES = "ms", "renderer", "program_span", "msamples_per_s.surface"

read = manifest.reader("renderer.assembly_ms").read
