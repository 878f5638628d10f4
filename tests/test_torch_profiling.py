"""Torch port, ``profiling``: each name held against the JAX module on the
same inputs, as ``tests/test_aux.py`` drives it, on the CPU.

``ProgressCallback`` and ``OpTimer.report`` must match the JAX text byte
for byte; ``OpTimer.time`` fills its records as the JAX tests assert;
``device_memory_stats`` gives the JAX function's keys for a CPU device;
``trace`` writes a Chrome trace that names the op run inside it.  With no
device, ``trace``, ``device_memory_stats`` and ``measure_dispatch_rtt``
take the card and raise where CUDA is absent.  The trace's analysis
(``device_summary``) and its hold against the launch counters
(``trace_mismatches``) run on hand-made events.
"""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_cube_tpu import profiling as J

from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch import profiling as P

from conftest import make_cube_file


@pytest.mark.parametrize("stream", [False, True])
def test_progress_callback_matches_jax(stream):
    outs, hits = {}, {}
    for name, mod in (("jax", J), ("torch", P)):
        buf = io.StringIO() if stream else None
        hits[name] = []
        cb = mod.ProgressCallback(7, desc="work", stream=buf,
                                  update_function=lambda h=hits[name]:
                                  h.append(1))
        for n in (1, 2, 1, 3, 1):
            cb(n)
        cb.close()
        outs[name] = (cb.count, buf.getvalue() if stream else None)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == 8
    assert len(hits["torch"]) == len(hits["jax"]) == 5
    if stream:
        assert "work" in outs["torch"][1] and outs["torch"][1].endswith("\n")


def test_op_timer_report_matches_jax():
    reports = []
    for mod in (J, P):
        timer = mod.OpTimer()
        for name, calls, total, best in (("square", 3, 0.0123456, 0.0031),
                                         ("a_longer_name_of_an_op", 1,
                                          1.5, 1.5),
                                         ("never", 0, 0.0, float("inf"))):
            timer.records[name] = mod.OpRecord(name, calls, total, best)
        reports.append(timer.report())
    assert reports[1] == reports[0]
    assert P.OpRecord("x", 4, 2.0).mean_s == J.OpRecord("x", 4, 2.0).mean_s


@pytest.mark.parametrize("loop_reps", [1, 3])
def test_op_timer_fills_records_as_jax(loop_reps):
    recs = []
    for mod, x in ((J, jnp.ones((32, 32))), (P, torch.ones(32, 32))):
        timer = mod.OpTimer()
        t = timer.time("matmul", lambda v: v @ v, x, loop_reps=loop_reps)
        assert t >= 0
        rec = timer.records["matmul"]
        assert rec.calls == 1 and rec.best_s == t
        assert rec.mean_s == pytest.approx(t)
        t2 = timer.time("matmul", lambda v: v @ v, x, loop_reps=loop_reps)
        assert rec.calls == 2 and rec.best_s == min(t, t2)
        assert rec.total_s == pytest.approx(t + t2)
        rep = timer.report()
        assert "matmul" in rep and "ms" in rep
        recs.append((sorted(timer.records), rec.calls,
                     len(rep.splitlines())))
    assert recs[1] == recs[0]


def test_op_timer_follows_the_arguments_device(monkeypatch):
    """CPU tensors take the host clock whatever the machine has; the round
    trip is measured on the arguments' device and subtracted once."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    timer = P.OpTimer()
    t = timer.time("scale", lambda s, b: s * b, 2.0, torch.ones(8),
                   loop_reps=4)
    assert t >= 0 and "cpu" in timer._rtt
    assert timer.measure_dispatch_rtt("cpu") >= 0
    assert timer.time("no tensor", lambda: sum(range(100))) >= 0


def test_device_memory_stats_cpu_matches_jax():
    import jax
    want = J.device_memory_stats(jax.devices("cpu")[0])
    assert P.device_memory_stats("cpu") == want == {}
    assert P.device_memory_stats(torch.device("cpu")) == {}


def test_trace_cpu_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with P.trace(logdir, device="cpu") as d:
        x = torch.ones(16, 16)
        (x @ x).sum()
    assert d == logdir
    found = [os.path.join(root, f) for root, _, files in os.walk(logdir)
             for f in files]
    assert found == [P.trace.last.path]
    assert os.path.getsize(found[0]) > 0
    with open(found[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and P.WINDOW in names
    assert P.trace.last.events == events
    s = P.device_summary(events)
    assert s["device_events"] == 0 and s["kernels"] == {}
    assert s["window_ms"] > 0 and s["busy_ms"] == 0.0


def test_trace_with_stack_records_python_functions(tmp_path):
    def outer_step(x):
        return (x * 2).sum()

    with P.trace(str(tmp_path), device="cpu", with_stack=True):
        outer_step(torch.ones(4))
    names = [e.get("name", "") for e in P.trace.last.events
             if e.get("cat") == "python_function"]
    assert any("outer_step" in n for n in names)


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with P.trace(str(tmp_path)):
            pass
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.device_memory_stats()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.OpTimer().measure_dispatch_rtt()
    assert not os.listdir(tmp_path)


@pytest.mark.filterwarnings("ignore:CUDA is not available")
def test_trace_without_device_activity_raises(monkeypatch, tmp_path):
    """A CUDA trace in which the port launched kernels but the profiler
    saw no device event (here: CUDA tracing unavailable) is refused, not
    read as an idle card."""
    monkeypatch.setattr(P, "_sync", lambda dev: None)
    n0 = K.moments.moments_planes.launches
    try:
        with pytest.raises(RuntimeError, match="no device activity"):
            with P.trace(str(tmp_path), device="cuda"):
                torch.ones(4) + 1
                K.moments.moments_planes.launches += 1
    finally:
        K.moments.moments_planes.launches = n0
    # nothing launched: an empty device timeline is no fault
    with P.trace(str(tmp_path), device="cuda"):
        torch.ones(4) + 1
    assert P.device_summary(P.trace.last.events)["device_events"] == 0


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def test_device_summary_on_hand_made_events():
    """Window from the annotation, busy as the union over streams, the
    top operations by total time with the host op that launched them,
    and the idle gaps, each with the innermost host operation open at its
    start and the innermost Python function open over all of it."""
    ev = [
        {"ph": "M", "name": "process_name", "args": {"name": "x"}},
        _x("PyTorch Profiler (0)", "Trace", 0.0, 1000.0),
        _x(P.WINDOW, "user_annotation", 100.0, 200.0),
        # the annotation's mirror on the device timeline is no device work
        _x(P.WINDOW, "gpu_user_annotation", 110.0, 170.0, device=0),
        _x("run", "python_function", 100.0, 220.0),
        _x("aten::add", "cpu_op", 105.0, 10.0, **{"External id": 1}),
        _x("maps", "python_function", 140.0, 120.0),
        _x("aten::copy_", "cpu_op", 150.0, 5.0, **{"External id": 2}),
        _x("tail", "python_function", 280.0, 10.0),
        _x("k1", "kernel", 110.0, 20.0, device=0, stream=7,
           **{"External id": 1}),
        _x("k2", "kernel", 120.0, 20.0, device=0, stream=8),
        _x("Memcpy HtoD", "gpu_memcpy", 250.0, 10.0, device=0, stream=7,
           **{"External id": 2}),
        _x("k1", "kernel", 270.0, 10.0, device=0, stream=7,
           **{"External id": 1}),
        _x("k3", "kernel", 150.0, 90.0, device=1, stream=7),
        _x("Memset", "gpu_memset", 310.0, 10.0, device=0, stream=7),
    ]
    s = P.device_summary(ev)
    # window [100, 320): the annotation stretched to the last device event
    assert s["window_ms"] == pytest.approx(0.220)
    # busy: [110, 140) + [250, 260) + [270, 280) + [310, 320)
    assert s["busy_ms"] == pytest.approx(0.060)
    assert s["idle_share"] == pytest.approx(1 - 60 / 220)
    assert s["device_events"] == 5
    assert s["kernels"] == {"k1": 2, "k2": 1}
    assert s["top"] == [("k1", 2, pytest.approx(0.030), "aten::add"),
                        ("k2", 1, pytest.approx(0.020), None),
                        ("Memcpy HtoD", 1, pytest.approx(0.010),
                         "aten::copy_"),
                        ("Memset", 1, pytest.approx(0.010), None)]
    # gaps: [140, 250) in "maps"; [280, 310) starts in "tail" but only
    # "run" spans it; [100, 110) and [260, 270) in "run" (aten::add
    # starts at 105, after the first gap's start)
    ms = pytest.approx
    assert s["gaps"] == [(ms(0.040), ms(0.110), "maps", "maps"),
                         (ms(0.180), ms(0.030), "tail", "run"),
                         (ms(0.0), ms(0.010), "run", "run"),
                         (ms(0.160), ms(0.010), "run", "run")]
    # an op inside a Python function is the innermost host operation
    ev.append(_x("aten::item", "cpu_op", 140.0, 50.0))
    assert P.device_summary(ev)["gaps"][0] == (ms(0.040), ms(0.110),
                                               "aten::item", "maps")
    assert P.device_summary(ev, device_index=1)["busy_ms"] == ms(0.090)


def test_read_trace_reads_gzip(tmp_path):
    import gzip
    ev = [_x("k", "kernel", 0.0, 1.0, device=0)]
    path = tmp_path / "t.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    assert P.read_trace(str(path)) == ev
    with pytest.raises(ValueError, match="annotation"):
        P.device_summary(ev)


# demangled names as a profiler gives them, one per __global__ kernel
_NAMES = {
    "moments": "void (anonymous namespace)::moments_kernel<true, 0>"
               "(float const*, float const*, unsigned char const*, int)",
    "channel_flags": "void (anonymous namespace)::channel_flags_kernel"
                     "(float const*, long long, int, int*)",
    "conv_sep": "void (anonymous namespace)::conv_sep_kernel<5>(float "
                "const*)",
    "resample2": "void (anonymous namespace)::resample2_kernel<4, true, "
                 "false>(SctResample2)",
    "resample2_filled": "void (anonymous namespace)::resample2_kernel<4, "
                        "false, true>(SctResample2)",
    "sigma_clip_reg": "void (anonymous namespace)::sigma_clip_reg_kernel<16>"
                      "(float const*, int)",
    "sigma_clip": "void (anonymous namespace)::sigma_clip_kernel<false>"
                  "(float const*, int)",
    "smooth_interp": "void (anonymous namespace)::smooth_interp_kernel<true>"
                     "(float const*)",
    "chan_flags": "void (anonymous namespace)::chan_flags_kernel(float "
                  "const*, long long, int, int*)",
    "mode0": "void (anonymous namespace)::conv_reproject_kernel<0, 5>"
             "(SctConvReproject)",
    "mode1": "void (anonymous namespace)::conv_reproject_kernel<1, 5>"
             "(SctConvReproject)",
    "mode2": "void (anonymous namespace)::conv_reproject_kernel<2, 5>"
             "(SctConvReproject)",
    "banded_matmul": "void (anonymous namespace)::banded_matmul_kernel<8, 4>"
                     "(SctBandedMatmul)",
    "torch": "void at::native::vectorized_elementwise_kernel<4>(int)",
}


def test_trace_mismatches_hold_every_wrapper():
    counts = {"moments": 2, "conv_sep": 1, "resample2": 3,
              "resample2_filled": 1, "sigma_clip": 2, "smooth_interp": 1,
              "conv_reproject": 2, "plain_strips": 1, "pipeline_fused": 1,
              "banded_matmul": 2}
    assert set(counts) == set(K.WRAPPERS) == set(K.DEVICE_KERNELS)
    traced = {_NAMES["moments"]: 2, _NAMES["channel_flags"]: 1,
              _NAMES["conv_sep"]: 1, _NAMES["resample2"]: 3,
              _NAMES["resample2_filled"]: 1, _NAMES["sigma_clip_reg"]: 1,
              _NAMES["sigma_clip"]: 1, _NAMES["smooth_interp"]: 1,
              _NAMES["chan_flags"]: 3, _NAMES["mode0"]: 2,
              _NAMES["mode1"]: 1, _NAMES["mode2"]: 1,
              _NAMES["banded_matmul"]: 2, _NAMES["torch"]: 40}
    assert P.trace_mismatches(traced, counts) == {}
    # one launch missing, one too many, a kernel the counters never saw
    short = dict(traced, **{_NAMES["mode1"]: 0, _NAMES["moments"]: 3})
    assert P.trace_mismatches(short, counts) == {
        K.DEVICE_KERNELS["plain_strips"][0]: (1, 0),
        K.DEVICE_KERNELS["moments"][0]: (2, 3)}
    assert P.trace_mismatches(traced, dict.fromkeys(counts, 0)) != {}
    # each kernel name matches its own wrapper's patterns only
    for key, name in _NAMES.items():
        hits = {w for w, pats in K.DEVICE_KERNELS.items()
                for p in pats if __import__("re").search(p, name)}
        assert (key == "torch") == (not hits), (key, hits)


def test_progress_callback_drives_a_cube_method(tmp_path):
    """A cube method's update_function hook takes a ProgressCallback: one
    call a spaxel, as the JAX package's method makes."""
    import spectral_cube_tpu as JS
    import spectral_cube_tpu_torch as T
    path, _ = make_cube_file(tmp_path, shape=(12, 5, 6), seed=3)
    counts, texts = [], []
    for mod, cube in ((P, T.SpectralCube.read(path, device="cpu")),
                      (J, JS.SpectralCube.read(path))):
        buf = io.StringIO()
        cb = mod.ProgressCallback(30, desc="clip", stream=buf)
        cube.sigma_clip_spectrally(2.0, update_function=cb)
        cb.close()
        counts.append(cb.count)
        texts.append(buf.getvalue())
    assert counts == [30, 30]
    assert texts[0] == texts[1] and "100.0%" in texts[0]
