"""Where a benchmark cell's cube spends its time, by the program's own
spans (``profiling.span``), on one card.

    python3 tools/cell_spans.py --workload <cell> [--seed N] [--cubes 3]
        [--keep DIR]
    python3 tools/cell_spans.py --overhead

The first form makes the cell's input and chain as ``cubebench/`` does
(its configuration, mix and seed), runs one warm cube, then ``--cubes``
cubes, each under ``profiling.trace``, and prints one JSON line a cube:
``profiling.device_summary``'s window, busy time, host waits and spans
({name: [calls, host ms, device ms, idle ms, waits]}); ``children``, the
share of the busy time that the device work launched inside the cube's
top-level spans covers (the pipeline's children, or the spectral chain's
methods); every idle gap of 0.5 ms or more with the innermost host
operation and ``sct.`` span open at its start and the ``sct.`` spans that
overlap it (their share of the gap); and for each of the device
operations of most time, its device ms by the innermost ``sct.`` span
open at its launch.  ``--keep`` writes each cube's Chrome trace into
``DIR``, gzipped.  ``--overhead`` prints the host's nanoseconds a span
costs with no profiler recording, as a context manager and as a
decorator, each less a bare call.  Needs one CUDA device for the first
form.
"""

import argparse
import bisect
import gzip
import json
import os
import shutil
import sys
import tempfile
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: idle gaps listed: those of at least this many ms
GAP_MS = 0.5
#: device operations placed by span
TOP = 8


def overhead(number=1000000, repeat=7):
    from spectral_cube_tpu_torch import profiling as P

    def bare():
        return None

    def context():
        with P.span("sct.probe"):
            return None
    decorated = P.spanned("sct.probe")(bare)

    def ns(fn):
        return min(timeit.repeat(fn, number=number, repeat=repeat)) \
            / number * 1e9
    base = ns(bare)
    return {"bare_call_ns": base, "span_ns": ns(context) - base,
            "spanned_ns": ns(decorated) - base}


def _open_at(spans, t):
    """The innermost of ``spans`` ((start, end, name)) open at ``t``."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, name)
    return best and best[1]


def analyse(events, top_level):
    from spectral_cube_tpu_torch import profiling as P
    s = P.device_summary(events)
    cat = P._cat
    dev = [e for e in events if P._is_device(e, 0)]
    complete = [e for e in events if e.get("ph") == "X"]
    window = [e for e in complete if e.get("name") == P.WINDOW
              and cat(e) == "user_annotation"][0]
    t0 = float(window["ts"])
    t1 = max([t0 + float(window["dur"])]
             + [float(e["ts"]) + float(e.get("dur", 0)) for e in dev])
    ours = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in complete
                  if cat(e) == "user_annotation"
                  and e["name"].startswith(P.SPAN_PREFIX))
    host = [(float(e["ts"]), float(e.get("dur", 0)), e.get("name"))
            for e in complete if cat(e) in P.HOST_CATEGORIES
            and e.get("name") != P.WINDOW]
    launched = {}
    for e in complete:
        corr = e.get("args", {}).get("correlation")
        if cat(e) in P.RUNTIME_CATEGORIES and corr is not None:
            launched[corr] = float(e["ts"])
    busy = P._union((max(float(e["ts"]), t0),
                     min(float(e["ts"]) + float(e.get("dur", 0)), t1))
                    for e in dev)
    busy_us = sum(b - a for a, b in busy)
    # the device work launched inside the top-level spans
    tops = [(a, b) for a, b, name in ours if top_level(name, ours, a, b)]
    tops_u = P._union(tops)
    starts = [a for a, _ in tops_u]
    inside = []
    by_op = {}
    for e in dev:
        at = launched.get(e.get("args", {}).get("correlation"))
        iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if at is not None:
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= tops_u[i][1]:
                inside.append(iv)
        where = _open_at(ours, at) if at is not None else None
        ops = by_op.setdefault(e["name"], {})
        ops[where] = ops.get(where, 0.0) + (iv[1] - iv[0]) / 1e3
    covered = sum(b - a for a, b in P._union(
        (max(a, t0), min(b, t1)) for a, b in inside))
    edges = [t0] + [x for a, b in busy for x in (a, b)] + [t1]
    gaps = []
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b - a < GAP_MS * 1e3:
            continue
        over = {}
        for s_, e_, name in ours:
            o = min(b, e_) - max(a, s_)
            if o > 0:
                over[name] = round(max(over.get(name, 0.0), o) / (b - a), 4)
        share = sum(y - x for x, y in P._union(
            (max(a, s_), min(b, e_)) for s_, e_, _ in ours
            if min(b, e_) > max(a, s_))) / (b - a)
        gaps.append({"at_ms": (a - t0) / 1e3, "ms": (b - a) / 1e3,
                     "host_op": P._innermost(host, a, a),
                     "span": _open_at(ours, a), "in_spans": round(share, 4),
                     "spans": over})
    top = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))[:TOP]
    return {"window_ms": s["window_ms"], "busy_ms": s["busy_ms"],
            "idle_share": s["idle_share"], "waits": s["waits"],
            "n_spans": len(ours),
            "children": covered / busy_us if busy_us else None,
            "spans": {k: list(v) for k, v in s["spans"].items()},
            "gaps": gaps,
            "ops": [[n[:120], {str(k): round(v, 3) for k, v in d.items()}]
                    for n, d in top]}


def _pipeline_child(name, ours, a, b):
    """A span whose innermost ``sct.`` parent is ``sct.pipeline``."""
    around = [(s, n) for s, e, n in ours
              if s <= a and b <= e and (s, e, n) != (a, b, name)]
    return bool(around) and max(around)[1] == "sct.pipeline"


SPECTRAL = ("sct.cube.spectral_smooth", "sct.cube.spectral_interpolate",
            "sct.cube.sigma_clip_spectrally")


def run(workload, seed, cubes, keep=None):
    import torch
    from spectral_cube_tpu_torch import profiling as P
    from cubebench.harness import load_cell, card_line
    from cubebench.chains import Chain
    from cubebench.cubegen import make_cube
    from pathlib import Path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cell = load_cell(workload, Path(ROOT))
    inp = make_cube(cell.shape, seed, dev)
    chain = Chain(cell.config, cell.mix, seed, inp)
    top_level = _pipeline_child if cell.mix["name"] == "pipeline" \
        else (lambda name, *_: name in SPECTRAL)
    print(json.dumps({"card": card_line(), "workload": workload,
                      "seed": seed, "torch": torch.__version__}), flush=True)
    logdir = tempfile.mkdtemp()
    try:
        chain.run(chain.draw())
        torch.cuda.synchronize(dev)
        for i in range(cubes):
            draw = chain.draw()
            with P.trace(logdir, device=dev):
                chain.run(draw)
            events = P.trace.last.events
            if keep:
                os.makedirs(keep, exist_ok=True)
                with open(P.trace.last.path, "rb") as src, gzip.open(
                        os.path.join(keep, f"{workload}.{i}.pt.trace.json.gz"),
                        "wb", compresslevel=1) as dst:
                    shutil.copyfileobj(src, dst)
            os.unlink(P.trace.last.path)
            P.trace.last = None
            out = analyse(events, top_level)
            del events
            out["cube"] = i
            print(json.dumps(out), flush=True)
    finally:
        chain.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=1234567)
    p.add_argument("--cubes", type=int, default=3)
    p.add_argument("--keep")
    p.add_argument("--overhead", action="store_true")
    a = p.parse_args(argv)
    if a.overhead:
        print(json.dumps(overhead()), flush=True)
        return 0
    run(a.workload, a.seed, a.cubes, a.keep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
