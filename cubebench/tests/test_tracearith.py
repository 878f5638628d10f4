"""The frozen trace arithmetic on a small synthetic Chrome trace: the
window, the busy union, the idle gaps, and each span's device time from
the work launched inside it, matched by correlation id."""

import pytest

from cubebench import harness
from cubebench.tracearith import summarize, union

W = "cubebench.cube"


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    return [
        _x(W, "user_annotation", 0, 100, **{"External id": 1}),
        # span a: launches kernels k1 (corr 10) and k2 (corr 11)
        _x("span.a", "user_annotation", 5, 30),
        _x("aten::add", "cpu_op", 6, 4, **{"External id": 2}),
        _x("cudaLaunchKernel", "cuda_runtime", 7, 1, correlation=10),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 1, correlation=11),
        _x("k1", "kernel", 10, 20, device=0, correlation=10),
        _x("k2", "kernel", 25, 15, device=0, correlation=11),
        # outside any span: a copy launched at 50, run at 60-70
        _x("host_work", "cpu_op", 40, 50),
        _x("cudaMemcpyAsync", "cuda_runtime", 50, 1, correlation=12),
        _x("Memcpy DtoH", "gpu_memcpy", 60, 10, device=0, correlation=12),
        # span b: host work alone
        _x("span.b", "user_annotation", 75, 20),
        # a kernel on another device is not this device's
        _x("k3", "kernel", 80, 50, device=1, correlation=13),
    ]


def test_union():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def test_window_busy_and_gaps():
    s = summarize(_trace(), W, ("span.a", "span.b", "span.c"))
    assert s["window"] == 100
    # k1 and k2 overlap: 10-40, the copy 60-70
    assert s["busy"] == 40
    assert s["ops"] == {"k1": 20, "k2": 15, "Memcpy DtoH": 10}
    lengths = sorted(g[0] for g in s["gaps"])
    assert lengths == [10, 20, 30]
    longest = max(s["gaps"])
    assert longest == (30, "host_work")


def test_span_device_time_by_correlation():
    s = summarize(_trace(), W, ("span.a", "span.b", "span.c"))
    assert s["spans"]["span.a"] == (30, 30)
    assert s["spans"]["span.b"] == (20, 0)
    assert "span.c" not in s["spans"]


def test_readings_per_cube(bench, root):
    cell = harness.load_cell("alma.pipeline", root)
    one = summarize(_trace(), W, ("span.a", "span.b"))
    r = harness.Readings([one, one], cell)
    assert r.idle_share == pytest.approx(0.6)
    assert r.span("span.a").device_ms == pytest.approx(0.030)
    assert r.span("span.b").host_ms == pytest.approx(0.020)
    assert r.span("span.c") is None
    assert r.roofline_pct("span.c", "convolve_to") is None


def test_one_window_annotation_is_required():
    with pytest.raises(ValueError):
        summarize([e for e in _trace() if e["name"] != W], W)
