"""The window's end-to-end metrics are taken over all of its frames: a
stall in the middle counts in the rate."""

import time
from types import SimpleNamespace

import pytest

from benchmark.harness import loops, manifest


class FakeLoop:
    """Frames of 10 ms, the fourth of them a 200 ms stall."""

    first_index = 0

    def step(self, i):
        time.sleep(0.2 if i == 3 else 0.01)
        return i

    def record(self, i, start, end, out, error):
        return {"index": i, "start": start, "end": end, "error": error,
                "samples": 1000, "ok": error is None}


def _run(records, t0):
    return SimpleNamespace(records=records, t0=t0, setup_s=1.0)


def test_window_runs_until_its_time_and_keeps_every_frame():
    t0, recs = loops.run_window(FakeLoop(), 0.3)
    assert recs[-1]["end"] - t0 >= 0.3
    assert [r["index"] for r in recs] == list(range(len(recs)))


@pytest.mark.parametrize("metric", ["msamples_per_s", "msamples_per_s.surface"])
def test_rate_over_all_frames_with_a_stall(metric):
    # synthetic frames: 99 of 10 ms and one stall of 500 ms, back to back
    t, recs = 0.0, []
    for i in range(100):
        d = 0.5 if i == 50 else 0.01
        recs.append({"index": i, "start": t, "end": t + d, "error": None,
                     "samples": 1_000_000, "ok": True})
        t += d
    rate = manifest.reader(metric).read(_run(recs, 0.0))
    assert abs(rate - 100 / (99 * 0.01 + 0.5)) < 1e-9        # not 100 / 0.99


def test_a_failed_frame_adds_no_samples_but_its_time():
    recs = [{"index": 0, "start": 0.0, "end": 1.0, "error": None, "samples": 2_000_000, "ok": True},
            {"index": 1, "start": 1.0, "end": 2.0, "error": "RuntimeError: x", "samples": 0, "ok": False}]
    assert manifest.reader("msamples_per_s").read(_run(recs, 0.0)) == 1.0
