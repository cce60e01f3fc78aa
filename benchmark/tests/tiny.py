"""Cells of the manifest cut to a size the CPU tests can hold."""

import copy

from benchmark.harness import manifest

SIZES = {
    "cornell_gi": dict(width=16, height=12, spp=4),
    "cloud_nee": dict(width=12, height=9, spp=2, max_depth=4),
}


def tiny_cell(name, pixels_per_frame=8):
    cell = copy.deepcopy(manifest.cell(manifest.load(), name))
    cfg = cell["config"]
    cfg["render"].update(SIZES[cfg["name"]])
    cfg["check"]["pixels_per_frame"] = pixels_per_frame
    return cell


def tiny_config(name):
    return tiny_cell(name + ".render")["config"]
