"""Profiling, progress, and per-op device-time metrics (the port of
``spectral_cube_tpu/profiling.py``).

The reference has no tracing subsystem (SURVEY §5: progress via tqdm
callbacks only).  On the card this is a first-class concern, so this
module provides:

- :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace of the block (TensorBoard's profiler plugin and Perfetto
  read it); :func:`read_trace` reads its events back,
  :func:`device_summary` turns them into the device's busy time, idle
  share, top operations and longest idle gaps, and
  :func:`trace_mismatches` holds its kernel launches against the port's
  launch counters;
- :class:`OpTimer` — device time of a callable: CUDA events on the card,
  the host clock less one dispatch round trip on the CPU;
- :class:`ProgressCallback` — the analog of the reference's
  ``update_function`` hooks (spectral_cube.py:2984-3012);
- :func:`device_memory_stats` — the card's memory footprint.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import tempfile
import time
from collections import Counter, namedtuple
from dataclasses import dataclass

import torch

from .cube import default_device
from .kernels import DEVICE_KERNELS, launch_counts

__all__ = ["trace", "OpTimer", "ProgressCallback", "device_memory_stats"]

#: the user annotation that brackets a traced block; its span is the
#: window :func:`device_summary` reads
WINDOW = "spectral_cube_tpu_torch.profiling.trace"

#: Chrome-trace categories of the device's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of host operations, in which an idle gap can start
HOST_CATEGORIES = ("cpu_op", "python_function", "user_annotation")
#: what :func:`device_summary` lists: the device operations of most total
#: time, and the longest idle gaps
TOP_OPS = 8
LONGEST_GAPS = 5
#: host-side launch calls: kernels were sent to the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")

#: what :func:`trace` leaves in ``trace.last``: the file written and its
#: events (:func:`read_trace`)
TraceFile = namedtuple("TraceFile", "path events")


def _device(device):
    """``device`` as a torch device; None means the port's default device,
    the card, which raises where CUDA is absent."""
    return default_device() if device is None else torch.device(device)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _port_launches():
    return sum(launch_counts().values())


@contextlib.contextmanager
def trace(logdir=None, device=None, with_stack=False):
    """Capture a ``torch.profiler`` trace of the block and write it into
    ``logdir`` (default ``<tempdir>/spectral_cube_tpu_torch_trace``) as a
    Chrome trace, ``<pid>.<ns>.pt.trace.json``, which TensorBoard and
    Perfetto read.  Yields ``logdir``, as the JAX ``trace`` does.

    On a CUDA ``device`` (None: the card, raising without CUDA) the trace
    holds the host's operations and the device's kernels, copies and sets,
    the device synchronized at both ends; on the CPU, only when asked for,
    the host's operations alone.  ``with_stack`` also records every Python
    function call (it slows the host).  The block runs inside the user
    annotation :data:`WINDOW`.  Afterwards ``trace.last`` is a
    :data:`TraceFile` whose ``events`` are :func:`read_trace`'s of the
    file.

    Raises RuntimeError after a block on a CUDA device whose trace holds no
    device activity though kernels were launched in it (the port's launch
    counters rose, or the trace records launch calls): the profiler's
    CUPTI tracing is missing, and a trace without the device would read as
    an idle card."""
    dev = _device(device)
    cuda = dev.type == "cuda"
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "spectral_cube_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    launched = _port_launches()
    _sync(dev)
    prof = torch.profiler.profile(activities=activities,
                                  with_stack=with_stack)
    path = os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}"
                                ".pt.trace.json")
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW):
            yield logdir
            _sync(dev)
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
    events = read_trace(path)
    trace.last = TraceFile(path, events)
    if cuda and not any(_is_device(e) for e in events):
        if _port_launches() > launched or any(
                e.get("name") in LAUNCH_CALLS for e in events):
            raise RuntimeError(
                f"the trace {path} holds no device activity though kernels "
                "were launched in it: the profiler cannot trace the card "
                "(CUPTI missing?)")


trace.last = None


def read_trace(path):
    """The events (``traceEvents``) of a Chrome trace that :func:`trace`
    wrote, or a gzipped one (``.gz``)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _cat(e):
    return str(e.get("cat", "")).lower()


def _is_device(e, index=None):
    return (e.get("ph") == "X" and _cat(e) in DEVICE_CATEGORIES
            and (index is None or e.get("args", {}).get("device") == index))


def _union(intervals):
    """Sorted, disjoint cover of ``(start, end)`` intervals."""
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _stream(e):
    return e.get("args", {}).get("stream", e.get("tid"))


def _overlapping_pairs(intervals):
    """How many pairs of ``(start, end, stream)`` intervals on two
    different streams overlap in time (the kernels of a mesh's positions
    running at once)."""
    pairs, active = 0, []
    for s, t, stream in sorted(intervals):
        active = [(t2, s2) for t2, s2 in active if t2 > s]
        pairs += sum(s2 != stream for _, s2 in active)
        active.append((t, stream))
    return pairs


def _innermost(ops, a, b):
    """Name of the innermost of ``ops`` ((start, length, name)) open over
    all of ``[a, b]`` (the one that started last, of those the shortest),
    or None."""
    best = None
    for s, d, name in ops:
        if s <= a < s + d and b <= s + d and (best is None
                                              or (s, -d) > best[0]):
            best = ((s, -d), name)
    return best and best[1]


def device_summary(events, device_index=0):
    """What the device did in a trace's window.

    ``events``: :func:`read_trace`'s list of a :func:`trace`.  The window is
    the span of its :data:`WINDOW` annotation, stretched to the last device
    event.  Busy: the union of the kernel, copy and set
    intervals on device ``device_index``.  Returns a dict:
    ``window_ms``, ``busy_ms``, ``idle_share`` (1 - busy / window; the
    union counts time that kernels on several streams share once),
    ``device_events``, ``kernels`` ({name: launches}), ``streams`` (the
    streams that ran a kernel), ``overlapping_kernel_pairs`` (pairs of
    kernels on two streams that ran at the same time,
    :func:`_overlapping_pairs`), ``top``
    ([(name, launches, total ms, the host operation that launched most of
    them)] of the :data:`TOP_OPS` device operations of most total time)
    and ``gaps`` ([(start ms into the window, length ms, the innermost
    host operation open at its start, the innermost Python function open
    over the whole gap)] of the :data:`LONGEST_GAPS` longest idle gaps; a
    Python function only where the trace was taken ``with_stack``)."""
    dev = [e for e in events if _is_device(e, device_index)]
    complete = [e for e in events if e.get("ph") == "X"
                and _cat(e) not in ("trace", "overhead")]
    # the host's annotation; a CUDA trace mirrors it on the device's
    # timeline as a gpu_user_annotation
    marks = [e for e in complete if e.get("name") == WINDOW
             and _cat(e) == "user_annotation"]
    if len(marks) != 1:
        raise ValueError(f"a trace of profiling.trace holds one {WINDOW} "
                         f"annotation; this one holds {len(marks)}")
    t0 = float(marks[0]["ts"])
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in marks + dev)
    busy = _union((max(float(e["ts"]), t0),
                   min(float(e["ts"]) + float(e.get("dur", 0)), t1))
                  for e in dev)
    busy_us = sum(t - s for s, t in busy if t > s)
    # a device event and the host op that launched it share an external id
    launcher = {e["args"]["External id"]: e["name"] for e in complete
                if _cat(e) == "cpu_op" and "External id" in e.get("args", {})}
    by_name, kernels = {}, {}
    for e in dev:
        n, tot, ops = by_name.get(e["name"], (0, 0.0, Counter()))
        ops[launcher.get(e.get("args", {}).get("External id"))] += 1
        by_name[e["name"]] = (n + 1, tot + float(e.get("dur", 0)), ops)
        if _cat(e) == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_OPS]
    edges = [t0] + [x for s, t in busy for x in (s, t)] + [t1]
    idle = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:LONGEST_GAPS]
    on_host = [e for e in complete if _cat(e) in HOST_CATEGORIES
               and e.get("name") != WINDOW]
    host = [(float(e["ts"]), float(e.get("dur", 0)), e.get("name"))
            for e in on_host]
    python = [h for h, e in zip(host, on_host)
              if _cat(e) == "python_function"]
    window = t1 - t0
    ran = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            _stream(e)) for e in dev if _cat(e) == "kernel"]
    return {
        "window_ms": window / 1e3,
        "busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / window if window > 0 else 0.0,
        "device_events": len(dev),
        "kernels": kernels,
        "streams": len({st for _, _, st in ran}),
        "overlapping_kernel_pairs": _overlapping_pairs(ran),
        "top": [(name, n, tot / 1e3, ops.most_common(1)[0][0])
                for name, (n, tot, ops) in ranked],
        "gaps": [((a - t0) / 1e3, (b - a) / 1e3, _innermost(host, a, a),
                  _innermost(python, a, b)) for a, b in idle],
    }


def trace_mismatches(kernels, counts):
    """Where a trace's kernel launches disagree with the launch counters.
    ``kernels``: {demangled kernel name: launches} of the trace
    (:func:`device_summary`'s ``"kernels"``); ``counts``: the counters over
    the same window (``kernels.launch_counts()``).  For each pattern of
    ``kernels.DEVICE_KERNELS``, the launches the counters imply (the sum
    over the wrappers that launch it) against the trace's launches of
    kernels that match it; returns {pattern: (implied, traced)} where they
    differ."""
    implied = {}
    for name, patterns in DEVICE_KERNELS.items():
        for p in patterns:
            implied[p] = implied.get(p, 0) + counts.get(name, 0)
    traced = {p: sum(n for k, n in kernels.items() if re.search(p, k))
              for p in implied}
    return {p: (implied[p], traced[p]) for p in implied
            if implied[p] != traced[p]}


@dataclass
class OpRecord:
    name: str
    calls: int = 0
    total_s: float = 0.0
    best_s: float = float("inf")

    @property
    def mean_s(self):
        return self.total_s / max(self.calls, 1)


def _args_device(args):
    """The device of the first tensor in ``args``, else the CPU."""
    return next((a.device for a in args if isinstance(a, torch.Tensor)),
                torch.device("cpu"))


class OpTimer:
    """Measure the device time of callables.

    The route follows the device of the tensors in ``args``, never what the
    machine has.  On a CUDA device: one warm-up call (the kernels' build at
    first use, the caching allocator), then two CUDA events around 1, or
    ``loop_reps`` back to back, calls, divided by the count; the events
    bracket the device's work, not the host's dispatch, so nothing is
    subtracted.  On the CPU: one warm-up call, then the host clock, and
    with ``loop_reps > 1`` the loop's time less one dispatch round trip
    (:meth:`measure_dispatch_rtt`), clamped at 0, divided by the count, as
    the JAX ``OpTimer`` does.
    """

    def __init__(self):
        self.records: dict[str, OpRecord] = {}
        self._rtt = {}

    def measure_dispatch_rtt(self, device=None):
        """Host seconds of one trivial op on ``device`` (None: the card)
        and, on a CUDA device, the ``torch.cuda.synchronize()`` that waits
        for it."""
        dev = _device(device)
        x = torch.zeros(8, device=dev)
        x * 1.0
        _sync(dev)
        t0 = time.perf_counter()
        x * 1.0
        _sync(dev)
        self._rtt[str(dev)] = time.perf_counter() - t0
        return self._rtt[str(dev)]

    def time(self, name, fn, *args, loop_reps=1):
        rec = self.records.setdefault(name, OpRecord(name))
        dev = _args_device(args)
        reps = max(int(loop_reps), 1)
        fn(*args)  # warm-up
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn(*args)
                end.record()
                end.synchronize()
            per = start.elapsed_time(end) / 1e3 / reps
        elif reps > 1:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*args)
            elapsed = time.perf_counter() - t0
            rtt = self._rtt.get(str(dev))
            if rtt is None:
                rtt = self.measure_dispatch_rtt(dev)
            per = max((elapsed - rtt) / reps, 0.0)
        else:
            t0 = time.perf_counter()
            fn(*args)
            per = time.perf_counter() - t0
        rec.calls += 1
        rec.total_s += per
        rec.best_s = min(rec.best_s, per)
        return per

    def report(self):
        lines = [f"{'op':30s} {'calls':>6s} {'best':>10s} {'mean':>10s}"]
        for rec in self.records.values():
            lines.append(f"{rec.name:30s} {rec.calls:6d} "
                         f"{rec.best_s * 1e3:9.3f}ms "
                         f"{rec.mean_s * 1e3:9.3f}ms")
        return "\n".join(lines)


class ProgressCallback:
    """Simple callable progress reporter (update_function analog)."""

    def __init__(self, total, desc="", stream=None, update_function=None):
        self.total = total
        self.count = 0
        self.desc = desc
        self.update_function = update_function
        self._t0 = time.perf_counter()
        self._stream = stream

    def __call__(self, n=1):
        self.count += n
        if self.update_function is not None:
            self.update_function()
        if self._stream is not None:
            pct = 100.0 * self.count / max(self.total, 1)
            self._stream.write(f"\r{self.desc} {pct:5.1f}%")
            self._stream.flush()

    def close(self):
        if self._stream is not None:
            self._stream.write("\n")


def device_memory_stats(device=None):
    """The device's memory footprint (HBM footprint assertions, the analog
    of the reference's tracemalloc bounds, test_performance.py): on a CUDA
    device (None: the card, raising without CUDA) ``bytes_in_use``
    (``torch.cuda.memory_allocated``), ``peak_bytes_in_use``
    (``max_memory_allocated``) and ``bytes_limit`` (the card's total, from
    ``mem_get_info``); ``{}`` for the CPU, as the JAX function gives for a
    device without memory stats."""
    dev = _device(device)
    if dev.type != "cuda":
        return {}
    _, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": total}
