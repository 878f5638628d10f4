"""What the device did in a traced cube, from the profiler's Chrome trace.

Frozen copy of the interval arithmetic of
``spectral_cube_tpu_torch/profiling.py:142-262`` (``_cat``, ``_is_device``,
``_union``, ``_innermost`` and ``device_summary``'s busy union, idle share
and gaps, commit 9f9bf87), kept here so that the yardstick does not move
with the program.  Added: the device time of a span, the union of the
device intervals of the work launched inside it, matched to its launch
call by the trace's correlation id.
"""

from __future__ import annotations

import json
from collections import defaultdict

#: Chrome-trace categories of the device's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of host operations, in which an idle gap can start
HOST_CATEGORIES = ("cpu_op", "python_function", "user_annotation")
#: host categories of the runtime calls that put work on the device
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
#: the idle gaps named, longest first
LONGEST_GAPS = 10


def read_trace(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _cat(e):
    return str(e.get("cat", "")).lower()


def _is_device(e, index=None):
    return (e.get("ph") == "X" and _cat(e) in DEVICE_CATEGORIES
            and (index is None or e.get("args", {}).get("device") == index))


def union(intervals):
    """Sorted, disjoint cover of ``(start, end)`` intervals."""
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


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


def _end(e):
    return float(e["ts"]) + float(e.get("dur", 0))


def summarize(events, window_name, spans=(), device_index=0):
    """The device's work in the window of the user annotation
    ``window_name`` (stretched to the last device event), in microseconds:
    ``window``, ``busy`` (the union of kernel, copy and set intervals),
    ``ops`` ({name: total device time}), ``gaps`` ([(length, the innermost
    host operation open at its start)] of the :data:`LONGEST_GAPS`
    longest) and ``spans`` ({name: (host time, device time)} for each
    user annotation named in ``spans``, summed over its occurrences; a
    span's device time is the union of the device intervals whose launch
    call lies inside it)."""
    dev = [e for e in events if _is_device(e, device_index)]
    complete = [e for e in events if e.get("ph") == "X"
                and _cat(e) not in ("trace", "overhead")]
    marks = [e for e in complete if e.get("name") == window_name
             and _cat(e) == "user_annotation"]
    if len(marks) != 1:
        raise ValueError(f"the trace holds {len(marks)} {window_name} "
                         "annotations, not one")
    t0 = float(marks[0]["ts"])
    t1 = max(_end(e) for e in marks + dev)
    busy = union((max(float(e["ts"]), t0), min(_end(e), t1)) for e in dev)
    busy_us = sum(t - s for s, t in busy if t > s)
    ops = defaultdict(float)
    for e in dev:
        ops[e["name"]] += float(e.get("dur", 0))
    edges = [t0] + [x for s, t in busy for x in (s, t)] + [t1]
    idle = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    host = [(float(e["ts"]), float(e.get("dur", 0)), e.get("name"))
            for e in complete if _cat(e) in HOST_CATEGORIES
            and e.get("name") != window_name]
    gaps = [(b - a, _innermost(host, a, a)) for a, b in idle[:LONGEST_GAPS]]
    launched = {}
    for e in complete:
        corr = e.get("args", {}).get("correlation")
        if _cat(e) in RUNTIME_CATEGORIES and corr is not None:
            launched[corr] = float(e["ts"])
    by_span = {}
    for name in spans:
        occ = [e for e in complete if e.get("name") == name
               and _cat(e) == "user_annotation"]
        if not occ:
            continue
        host_us, inside = 0.0, []
        for s in occ:
            a, b = float(s["ts"]), _end(s)
            host_us += b - a
            for e in dev:
                at = launched.get(e.get("args", {}).get("correlation"))
                if at is not None and a <= at <= b:
                    inside.append((float(e["ts"]), _end(e)))
        by_span[name] = (host_us, sum(t - s for s, t in union(inside)))
    return {"window": t1 - t0, "busy": busy_us, "ops": dict(ops),
            "gaps": gaps, "spans": by_span}
