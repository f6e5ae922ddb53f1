"""The trace arithmetic and the per-layer readers on synthetic events, and
the problem counts behind the rooflines."""

from __future__ import annotations

import pytest

from portbench import peaks, spec, trace
from portbench.run import Run


def test_union_counts_overlaps_once_and_clips_to_the_window():
    busy, gaps = trace.union([(5, 15), (10, 20), (30, 40), (38, 45), (50, 70), (-5, 2)], 0, 60)
    assert busy == 2 + 15 + 15 + 10
    assert gaps == [(2, 5), (20, 30), (45, 50)]
    assert trace.union([], 0, 10) == (0, [(0, 10)])
    assert trace.union([(3, 4), (3, 4), (1, 2)], 0, 5) == (2, [(0, 1), (2, 3), (4, 5)])


def test_innermost_names_the_deepest_range():
    host = [("window", 0, 100), ("api.query", 10, 50), ("aten::cat", 20, 30),
            ("cudaMemcpyAsync", 24, 28), ("api.query", 60, 90)]
    got = trace.innermost(host, [5, 15, 25, 29, 55, 70, 95, 150])
    assert got == ["window", "api.query", "cudaMemcpyAsync", "aten::cat", "window",
                   "api.query", "window", None]


def _trace():
    device = [("cell_scan_kernel<256, 2>", 10, 30), ("copy", 25, 35),
              ("void phase1_wgmma_kernel<1, 128, false>", 50, 80), ("late", 120, 130)]
    host = [(trace.WINDOW, 0, 100), ("api.query_many", 6, 95), ("stage", 36, 48)]
    return trace.summarize((0, 100), device, host)


def test_summarize_and_breakdown():
    t = _trace()
    assert [op[0] for op in t.ops] == ["cell_scan_kernel<256, 2>", "copy",
                                       "void phase1_wgmma_kernel<1, 128, false>"]
    assert t.busy_ns == 25 + 30
    assert t.gaps == [(trace.WINDOW, 10), ("stage", 15), ("api.query_many", 20)]
    assert t.device_s("cell_scan") == pytest.approx(20e-9)
    assert t.device_s("phase1_") == pytest.approx(30e-9)
    b = t.breakdown(top=2)
    assert b["device_ops"] == [["void phase1_wgmma_kernel<1, 128, false>", 30e-9],
                               ["cell_scan_kernel<256, 2>", 20e-9]]
    assert b["idle_gaps"] == [["api.query_many", 20e-9], ["stage", 15e-9]]


def _run(t, **kw):
    config = {"n": 1 << 20, "k": 3}
    traffic = {"rows": 10000, "batches_per_call": 64}
    run = Run(config, traffic, trace=t)
    for key, value in kw.items():
        setattr(run, key, value)
    return run


def test_device_readers():
    t = _trace()
    run = _run(t, queries=2000, calls=1, units=1)
    assert spec.reader("device_idle_share")(run) == pytest.approx(45.0)
    assert spec.reader("device_ops_per_kq")(run) == pytest.approx(1.5)
    assert spec.reader("device_idle_share")(_run(None, queries=1)) is None
    assert spec.reader("scan_roofline")(_run(trace.summarize((0, 10), [], []), units=3)) is None


def test_rooflines_count_the_problem():
    n, k, m = 1 << 20, 3, 10000
    assert peaks.nn_bytes(m, n, k) == 4 * n * k + 4 * m * k + 8 * m
    floor = (4 * n * k + 4 * m * k + 8 * m) / 3.35e12
    scan_ns = 40_000  # 40 us of cell_scan per batch, 5 batches
    t = trace.summarize((0, 10 ** 6), [("cell_scan_kernel", i * 50_000, i * 50_000 + scan_ns)
                                       for i in range(5)], [])
    got = spec.reader("scan_roofline")(_run(t, units=5, queries=5 * m))
    assert got == pytest.approx(100 * floor / 40e-6)

    k, w = 16, 8
    flops = 2 * (w * m) * n * k
    floor = max(flops / 989e12, peaks.nn_bytes(w * m, n, k) / 3.35e12)
    assert floor == pytest.approx(flops / 989e12)
    t = trace.summarize((0, 10 ** 9), [("phase1_wgmma_kernel", 0, 30_000_000),
                                       ("phase1_merge_kernel", 30_000_000, 31_000_000)], [])
    run = Run({"n": n, "k": k}, {"rows": m, "batches_per_call": w}, trace=t, calls=1)
    assert spec.reader("phase1_roofline")(run) == pytest.approx(100 * floor / 31e-3)


def test_end_to_end_readers():
    run = _run(None, queries=30000, window_s=2.0, call_s=[0.01 * i for i in range(1, 101)],
               build_ms=[3.0, 1.0, 2.0], setup_s=7.5)
    assert spec.reader("qps")(run) == 15000
    assert spec.reader("call_p95_ms")(run) == pytest.approx(950.5)
    assert spec.reader("build_ms")(run) == 2.0
    assert spec.reader("setup_s")(run) == 7.5


class _Event:
    """A profiler event as ``trace.from_events`` reads it."""

    def __init__(self, name, kind, start, end, device="DeviceType.CUDA", tid=1):
        self._v = (name, kind, start, end - start, device, tid)

    def name(self):
        return self._v[0]

    def is_user_annotation(self):
        return self._v[1] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def test_device_operations_are_chosen_by_kind_not_by_name():
    """Host ranges mirrored onto the device's timeline, whatever their
    names (the program's spans as well as the harness's), are no device
    operations."""
    host = "DeviceType.CPU"
    events = [
        _Event(trace.WINDOW, "user_annotation", 0, 100, host),
        _Event("api.query_many", "user_annotation", 5, 95, host),
        _Event("CellListEngine.query_staged", "user_annotation", 10, 90, host),
        _Event("aten::index", "cpu_op", 40, 45, host),
        _Event("aten::index", "cpu_op", 40, 45, host, tid=2),
        _Event(trace.WINDOW, "gpu_user_annotation", 0, 100),
        _Event("CellListEngine.query_staged", "gpu_user_annotation", 10, 90),
        _Event("MXUExpansion._phase12 cell_scan phase1_", "gpu_user_annotation", 10, 90),
        _Event("cell_scan_kernel<128, 5>", "kernel", 20, 30),
        _Event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 30, 35),
        _Event("Memset (Device)", "gpu_memset", 60, 62),
        _Event("cudaLaunchKernel", "cuda_runtime", 18, 20, host),
    ]
    t = trace.from_events(events)
    assert [op[0] for op in t.ops] == ["cell_scan_kernel<128, 5>",
                                       "Memcpy HtoD (Pinned -> Device)", "Memset (Device)"]
    assert t.busy_ns == 17 and t.window_ns == (0, 100)
    assert t.device_s("cell_scan") == pytest.approx(10e-9)
    assert t.device_s("phase1_") == 0
    # Gaps 0..20, 35..60 and 62..100, named by the innermost host range of the
    # window's thread at their midpoints.
    assert t.gaps == [("CellListEngine.query_staged", 20),
                      ("CellListEngine.query_staged", 25),
                      ("CellListEngine.query_staged", 38)]
    run = _run(t, queries=1000, calls=1, units=1)
    assert spec.reader("device_ops_per_kq")(run) == pytest.approx(3.0)
    assert spec.reader("device_idle_share")(run) == pytest.approx(83.0)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.from_events([_Event("cell_scan_kernel", "kernel", 0, 5)])
