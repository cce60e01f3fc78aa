"""Value-and-gradient steps, each with its Adam update, completed in the
window over the time from the window's start to the last step's end. Host
clock; every step counts."""

UNIT, LAYER, SOURCE = "steps/s", "end to end", "host_clock"


def read(run):
    done = [r for r in run.records if r["error"] is None]
    if not done:
        return None
    return len(done) / (max(r["end"] for r in run.records) - run.t0)
