"""On a card: a short run of each one-card cell through ``run.py`` ends
with a contract line whose ``correct`` is true. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("workload", ["cornell_gi.render", "cloud_nee.render", "cloud_nee.grad",
                                      "cloud_volume.render"])
def test_short_run_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", str(2**31 + 101), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
