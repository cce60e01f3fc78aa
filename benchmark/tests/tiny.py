"""Cells of the manifest cut to a size the CPU tests can hold."""

import copy

from benchmark.harness import manifest

SIZES = {
    "cornell_gi": dict(width=16, height=12, spp=4),
    "cloud_nee": dict(width=12, height=9, spp=2, max_depth=4),
    # square, as the published 512x512 frame
    "cloud_volume": dict(width=8, height=8, spp=32, max_depth=4),
}

# Scene changes where a tiny frame would show nothing of what the cell
# measures. Without NEE, no path of a tiny cloud_volume frame reaches the
# published light (radius 50, in the frame's top edge) after a scatter, so
# the light grows and moves behind the camera: every lit pixel is then Le
# added past depth 0, the branch that estimator adds.
SCENES = {
    "cloud_volume": {"sphere_lights": [
        {"center": [0.0, 150.0, 900.0], "radius": 300.0, "le": [10.0, 10.0, 10.0]}]},
}



def tiny_cell(name, pixels_per_frame=8):
    cell = copy.deepcopy(manifest.cell(manifest.load(), name))
    cfg = cell["config"]
    cfg["render"].update(SIZES[cfg["name"]])
    cfg["scene"].update(copy.deepcopy(SCENES.get(cfg["name"], {})))
    if "strata" in cfg["check"]:
        # a tiny frame has few lit pixels: every pixel of each stratum
        n = cfg["render"]["width"] * cfg["render"]["height"]
        cfg["check"]["strata"] = dict.fromkeys(cfg["check"]["strata"], n)
    else:
        cfg["check"]["pixels_per_frame"] = pixels_per_frame
    return cell


def tiny_config(name):
    return tiny_cell(name + ".render")["config"]
