"""The benchmark's manifest (``BENCHMARK.json`` at the root of the checkout)
and the files it names. Everything that belongs to one configuration, one
traffic mix, one metric or one roofline is found by its name:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<name>.json``, parameters read by the general
  loops of ``harness/loops.py``;
* a metric: ``metrics/<name>.py``, a reader with ``read(run)``;
* a roofline count: ``rooflines/<name>.py``, with ``bound(run)``;
* a plain reference: ``reference/<name>.py``, with ``make(config, grid,
  device, dt)``.
"""

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(entry, cell_name):
    return "workloads" not in entry or cell_name in entry["workloads"]


def load_file_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest, name, root=ROOT):
    """Everything one cell needs, resolved from the manifest by name."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return {
        "name": name,
        "workload": w,
        "config": config,
        "traffic": traffic,
        "chips": int(w["chips"]),
        "end_to_end": [m for m in manifest["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in manifest["per_layer"] if _applies(m, name)],
    }


def reader(metric_name):
    return load_file_module("metrics", metric_name)


def roofline(name):
    return importlib.import_module(f"benchmark.rooflines.{name}")


def reference(name):
    return importlib.import_module(f"benchmark.reference.{name}")
