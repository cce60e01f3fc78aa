"""The harness is driven by data: a configuration, a traffic mix, a metric
and a cell added as files and manifest entries alone are picked up, with no
file of the harness edited. And the manifest keeps to its own rules."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import manifest

ROOT = manifest.ROOT

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from benchmark.harness import manifest, run_cell
assert manifest.ROOT == {root!r}
cell = manifest.cell(manifest.load(), "{name}.render_short")
res = run_cell.execute(cell, 11, 0.2, 0, time.time(), "cpu", require_route=False)
print(json.dumps(res))
"""

TESTS = os.path.dirname(os.path.abspath(__file__))


def _cornell_copy():
    with open(os.path.join(ROOT, "benchmark", "configs", "cornell_gi.json")) as f:
        cfg = json.load(f)
    cfg["scene"]["quad_lights"][0]["le"] = [5.0, 5.0, 5.0]
    cfg["render"].update(width=8, height=6, spp=2, max_depth=2)
    return cfg, None


def _cloud_without_nee():
    """The published cloud without NEE, lit as ``tiny.py`` lights it."""
    from tiny import tiny_config

    return tiny_config("cloud_volume"), None


def _box_without_nee():
    """The vpt preset's homogeneous box under its quad light
    (``scene/presets.py`` ``build_vpt_scene``, ``preset_vpt``'s camera),
    with a reference of its own (``box_reference.py``)."""
    cfg = {
        "scene": {
            "media": [{"kind": "homogeneous", "g": 0.0, "absorption": [0.5] * 3,
                       "scattering": [0.5] * 3, "bmin": [-1.0] * 3, "bmax": [1.0] * 3}],
            "quad_lights": [{"v0": [0.5, 1.4, 0.5], "v1": [-0.5, 1.4, 0.5],
                             "v2": [0.5, 1.4, -0.5], "le": [10.0] * 3}]},
        "camera": {"c2w": [1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 5.0, 1],
                   "fov_deg": 2.0 * 180.0 * math.atan(1.0 / 3.0) / math.pi},
        "render": {"width": 12, "height": 12, "spp": 4, "max_depth": 4, "integrator": "vpt"},
        "route": {"render": {"vol_spp_persistent": 1}},
        "check": {"pixels_per_frame": 144, "limit": 0.005},
    }
    return cfg, os.path.join(TESTS, "box_reference.py")


@pytest.mark.parametrize("make", [_cornell_copy, _cloud_without_nee, _box_without_nee],
                         ids=["cornell_copy", "cloud_without_nee", "box_without_nee"])
def test_a_cell_added_by_files_alone_runs(tmp_path, make):
    """A configuration (with its plain reference, where it needs a new one),
    a traffic mix, a metric and a cell, added as files and manifest entries
    alone, run correct."""
    root = str(tmp_path)
    os.symlink(os.path.join(ROOT, "xraytracer_tpu_torch"), os.path.join(root, "xraytracer_tpu_torch"))
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = os.path.join(root, "benchmark")
    cfg, reference = make()
    name = "dummy_" + make.__name__.strip("_")
    cfg["name"] = name
    if reference is not None:
        cfg["reference"] = name
        shutil.copy(reference, os.path.join(bench, "reference", name + ".py"))
    with open(os.path.join(bench, "configs", name + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "render_short.json"), "w") as f:
        json.dump({"loop": "render", "why": "a test mix"}, f)
    with open(os.path.join(bench, "metrics", "frames_done.py"), "w") as f:
        f.write('UNIT = "frames"\n\n\ndef read(run):\n    return len(run.records)\n')
    m = manifest.load()
    m["configs"].append({"name": name, "source": "a test", "file": f"benchmark/configs/{name}.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": name + ".render_short", "config": name,
                           "traffic": "render_short", "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": [name + ".render_short"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", RUN.format(root=root, name=name)], cwd=root,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["metrics"]["frames_done"]["value"] == res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_done", "setup_s"}   # the others list their cells


@pytest.mark.parametrize("name, preset", [
    ("cornell_gi", "preset_cornellbox"), ("cloud_nee", "preset_nee"),
    ("cloud_volume", "preset_volume"), ("vpt_box", "preset_vpt")])
def test_configurations_build_their_presets_tables(name, preset):
    """Each configuration's scene, as ``build_scene`` builds it, is the
    port's preset's, bit for bit; the box is a file of the test's own."""
    from xraytracer_tpu_torch.scene import presets

    from benchmark.harness import inputs, port

    if name == "vpt_box":
        cfg = _box_without_nee()[0]
    else:
        with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
            cfg = json.load(f)
    tables = port.build_scene(cfg, inputs.density_grid(cfg), "cpu")[0]
    expect = getattr(presets, preset)("cpu")[0]
    for field, x, y in zip(expect._fields, tables, expect):
        assert x.dtype == y.dtype and torch.equal(x, y), field


@pytest.mark.parametrize("where, key, value", [
    ("render", "integrator", "vpt_mis"), ("media", "kind", "homogenous"),
    ("media", "variant", "achromatic"), ("scene", "spheres", [])])
def test_build_scene_refuses_what_it_does_not_know(where, key, value):
    from benchmark.harness import port

    cfg = _box_without_nee()[0]
    if where == "media":
        cfg["scene"]["media"][0][key] = value
    else:
        cfg[where][key] = value
    with pytest.raises(ValueError):
        port.build_scene(cfg, None, "cpu")


def test_manifest_rules():
    m = manifest.load()
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    metrics = m["end_to_end"] + m["per_layer"]
    names += [x["name"] for x in metrics]
    assert len(names) == len(set(names))
    assert "setup_s" in [x["name"] for x in m["end_to_end"]]
    cells = {w["name"]: w for w in m["workloads"]}
    for metric in metrics:
        for cell in metric.get("workloads", cells):
            assert cell in cells
    for w in m["workloads"]:
        c = manifest.cell(m, w["name"])
        e2e = {x["name"] for x in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
        for x in c["per_layer"]:
            assert x["moves"] in e2e
    for metric in metrics:
        mod = manifest.reader(metric["name"])
        assert mod.UNIT == metric["unit"]
        if "MOVES" in dir(mod):
            assert mod.MOVES == metric["moves"] and mod.LAYER == metric["layer"]
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) <= 64 * 1024


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.\-]{1,16}"
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_form():
    import re

    m = manifest.load()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(m["paths"]) <= 16 and 1 <= len(m["command"]) <= 32
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p.split("/")
    assert all(_line(word) and not word.startswith("/") for word in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.fullmatch(NAME, c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in m["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert re.fullmatch(NAME, key)
            assert not key.endswith(("_dim", "_rank", "_size"))
            assert not any(word in key for word in WIDTH_WORDS)
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs)), "a pair of configuration and traffic is one cell"
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.fullmatch(NAME, w["name"]) and re.fullmatch(NAME, w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    layers = {}
    for x in m["end_to_end"] + m["per_layer"]:
        per_layer = "bound" not in x
        keys = {"name", "unit", "better", "source", "workloads"}
        keys |= {"layer", "moves"} if per_layer else {"bound"}
        assert set(x) <= keys and set(x) >= keys - {"workloads"}, x["name"]
        assert re.fullmatch(NAME, x["name"]) and re.fullmatch(UNIT, x["unit"])
        assert x["better"] in ("lower", "higher")
        assert set(x.get("workloads", cells)) <= cells
        if per_layer:
            assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert _line(x["layer"]) and x["moves"] in e2e
            moved = set(e2e[x["moves"]].get("workloads", cells))
            assert set(x.get("workloads", cells)) <= moved, x["name"]
            layers.setdefault(x["layer"].lower(), set()).add(x["layer"])
        else:
            assert x["source"] in ("host_clock", "device_trace")
            assert 0.01 <= x["bound"] <= 0.25
    assert all(len(spelt) == 1 for spelt in layers.values())
