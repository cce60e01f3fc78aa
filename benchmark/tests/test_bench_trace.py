"""Reading the profiler's trace: idle time is what the union of the
device's (overlapping) operations leaves of the window; a frame's lead and
tail are measured to its route kernel."""

from types import SimpleNamespace

from benchmark.harness import manifest, trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_union_of_overlapping_intervals():
    assert trace.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 11)]) == [[0, 3], [5, 9], [10, 11]]


def test_summary_idle_lead_tail():
    events = [
        ev("bench.window", "user_annotation", 0, 1000),
        ev("bench.step", "user_annotation", 0, 500),
        ev("bench.step", "user_annotation", 500, 500),
        ev("aten::copy_", "cpu_op", 300, 150),
        ev("cudaDeviceSynchronize", "cuda_runtime", 10, 5),      # a short wait
        ev("cudaDeviceSynchronize", "cuda_runtime", 40, 270),    # the kernel's wait
        ev("cudaStreamSynchronize", "cuda_runtime", 320, 80),    # the copy's
        ev("cudaDeviceSynchronize", "cuda_runtime", 550, 360),
        ev("fill_kernel", "kernel", 20, 30),                   # 20-50
        ev("het_spp_persistent_kernel(X)", "kernel", 40, 260),  # 40-300: overlaps
        ev("Memcpy DtoH", "gpu_memcpy", 310, 100),             # 310-410
        ev("het_spp_persistent_kernel(X)", "kernel", 600, 300),  # 600-900
        ev("ncclDevKernel_AllGather", "kernel", 905, 10),
        ev("outside", "kernel", 1500, 100),                     # outside the window
    ]
    s = trace.summarize(events, "het_spp_persistent")
    assert s["window_s"] == 1000 / 1e6
    busy = (300 - 20) + 100 + 300 + 10
    assert abs(s["busy_s"] - busy / 1e6) < 1e-15
    work = busy - 10                      # the collective is no work
    assert abs(s["work_s"] - work / 1e6) < 1e-15
    assert s["n_steps"] == 2
    # lead and tail on the host's clock, around each span's longest wait
    assert s["frames"][0] == {"lead_ms": 0.04, "tail_ms": 0.19}
    assert s["frames"][1] == {"lead_ms": 0.05, "tail_ms": 0.09}
    assert abs(s["route_s"] - 560 / 1e6) < 1e-15
    assert abs(s["collective_s"] - 10 / 1e6) < 1e-15
    # the longest gap (410-600): no host event is open at its middle
    assert s["idle_gaps"][0] == ["(no host event)", 190 / 1e6]
    run = SimpleNamespace(traces=[s])
    idle = manifest.reader("device_idle.render").read(run)
    assert abs(idle - 100 * (1 - work / 1000)) < 1e-9
    assert manifest.reader("device_idle.surface").read(run) == idle
    assert abs(manifest.reader("renderer.lead_ms").read(run) - 0.045) < 1e-12
    assert abs(manifest.reader("renderer.assembly_ms.surface").read(run) - 0.14) < 1e-12
    assert abs(manifest.reader("grad.host_ms").read(run) - (1000 - busy) / 2 / 1e3) < 1e-12


def test_gap_named_by_the_innermost_host_event():
    events = [
        ev("bench.window", "user_annotation", 0, 100),
        ev("k", "kernel", 0, 10),
        ev("outer", "cpu_op", 10, 90),
        ev("cudaStreamSynchronize", "cuda_runtime", 40, 20),
        ev("k", "kernel", 90, 10),
    ]
    s = trace.summarize(events, "k")
    assert s["idle_gaps"][0] == ["cudaStreamSynchronize", 80 / 1e6]


def test_idle_counts_a_rank_waiting_in_the_gather():
    """Two ranks: one renders the whole window, the other renders a tenth of
    it and waits in the all-gather for the rest."""
    def rank(k_end, gather_start):
        return trace.summarize([
            ev("bench.window", "user_annotation", 0, 1000),
            ev("het_spp_persistent_kernel", "kernel", 0, k_end),
            ev("ncclDevKernel_AllGather_RING_LL", "kernel", gather_start, 1000 - gather_start),
        ], "het_spp_persistent")
    run = SimpleNamespace(traces=[rank(990, 990), rank(100, 100)])
    assert [s["busy_s"] for s in run.traces] == [1000 / 1e6, 1000 / 1e6]
    idle = manifest.reader("device_idle.render").read(run)
    assert abs(idle - 100 * (0.01 + 0.9) / 2) < 1e-9


def test_split_cell_readers():
    def rank(route_s, coll_s):
        return {"route_s": route_s, "collective_s": coll_s, "n_steps": 10,
                "busy_s": route_s, "window_s": 1.0}
    run = SimpleNamespace(traces=[rank(0.1, 0.5), rank(0.2, 0.4), rank(0.6, 0.02), rank(0.3, 0.3)])
    assert abs(manifest.reader("parallel.rank_imbalance").read(run) - 0.6 / 0.3) < 1e-12
    assert abs(manifest.reader("parallel.gather_ms").read(run) - 2.0) < 1e-12
    one = SimpleNamespace(traces=[rank(0.1, 0.0)])
    assert manifest.reader("parallel.rank_imbalance").read(one) is None
