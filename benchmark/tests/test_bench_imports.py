"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or the JAX package's ``xraytracer_tpu`` (compared whole: the
port's ``xraytracer_tpu_torch`` is no match), and the plain references
load nothing of the port."""

import json
import os
import subprocess
import sys

from benchmark.harness import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN_TINY = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from benchmark.harness import run_cell
from tiny import tiny_cell
res = run_cell.execute(tiny_cell("cornell_gi.render"), 5, 0.2, 1, time.time(), "cpu",
                       require_route=False)
print(json.dumps({{"loaded": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "correct": res["correct"]}}))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.surface_gi, benchmark.reference.cloud_nee
import benchmark.rooflines.k1c, benchmark.rooflines.k9c
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    got = _python(RUN_TINY.format(root=ROOT, tests=os.path.dirname(__file__)))
    assert got["correct"]
    assert "xraytracer_tpu_torch" in got["loaded"]
    for name in run_cell.FORBIDDEN:
        assert name not in got["loaded"]


def test_the_references_load_nothing_of_the_port():
    loaded = _python(REFERENCE_ONLY.format(root=ROOT))
    for name in ("xraytracer_tpu_torch", "xraytracer_tpu", "jax", "jaxlib", "flax"):
        assert name not in loaded


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "xraytracer_tpu_torch_fake", sys)
    assert "xraytracer_tpu" not in run_cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "xraytracer_tpu.fake", sys)
    assert "xraytracer_tpu" in run_cell.forbidden_modules()
