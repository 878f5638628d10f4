"""One run of one cell: set-up, the measured window (or the traced cubes),
the check against the plain reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``mixes/<traffic>.json``) with a program step (``ops/<op>.py``) and a
reference step (``reference/ops/<op>.py``) for each operation, the
readers of its per-layer metrics (``metrics/<metric>.py``, or the reader
of the name without its last ``.``-part, as ``device.idle_share`` reads
``device.idle_share.pipeline``), the spans those readers name
(``spans/<span>.json``), the stages' counts (``roofline/<stage>.py``) and
the limits of its check (``limits/<cell>.json``).
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import found

HERE = Path(__file__).resolve().parent
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "spectral_cube_tpu")
#: the user annotation around a traced cube
WINDOW = "cubebench.cube"
#: cubes traced in a --trace 1 run, one profiler session each
TRACED_CUBES = 3
#: entries of each list of the breakdown
BREAKDOWN = 10
GIB = 2 ** 30


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with everything found by its names."""

    def __init__(self, bench, name, root):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _load_json(root / self.config_entry["file"])
        self.mix = _load_json(HERE / "mixes" / f"{self.workload['traffic']}"
                                               ".json")
        self.chips = int(self.workload["chips"])

        def mine(metric):
            return name in metric.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        limits = HERE / "limits" / f"{name}.json"
        self.limits = _load_json(limits)["limits"] if limits.exists() \
            else {}

    @property
    def shape(self):
        return tuple(int(n) for n in self.config["shape"])


def load_cell(name, root):
    return Cell(_load_json(root / "BENCHMARK.json"), name, root)


def metric_module(metric_name):
    """The reader module of a per-layer metric: ``metrics/<name>.py``, or
    that of the name without its last ``.``-part, and so on (a metric
    split by the end-to-end metric it moves shares its reader)."""
    name = metric_name
    while True:
        mod = found("metrics", name)
        if mod is not None:
            return mod
        if "." not in name:
            raise KeyError(f"no reader metrics/<name>.py for {metric_name}")
        name = name.rsplit(".", 1)[0]


def reader(metric_name):
    """``read(readings)`` of the metric's reader."""
    return metric_module(metric_name).read


def spans_read(metrics):
    """The spans the readers of ``metrics`` name (their ``SPANS``)."""
    names = []
    for m in metrics:
        for span in getattr(metric_module(m["name"]), "SPANS", ()):
            if span not in names:
                names.append(span)
    return names


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def install_spans(names):
    """Wrap the boundary that each ``spans/<name>.json`` of ``names``
    names (``{"target": "module:qualname"}``) in a ``record_function`` of
    that name, calling the original and waiting for nothing.  Returns
    (names installed, names whose boundary no longer exists, undo)."""
    import torch
    installed, missing, undo = [], [], []
    for name in names:
        path = HERE / "spans" / f"{name}.json"
        if not path.is_file():
            missing.append(name)
            continue
        module, _, qual = _load_json(path)["target"].partition(":")
        try:
            owner = importlib.import_module(module)
            parts = qual.split(".")
            for part in parts[:-1]:
                owner = getattr(owner, part)
            fn = getattr(owner, parts[-1])
        except (ImportError, AttributeError):
            missing.append(name)
            continue

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)
        had = parts[-1] in vars(owner)
        setattr(owner, parts[-1], wrapped)
        undo.append((owner, parts[-1], fn if had else None))
        installed.append(name)

    def remove():
        for owner, attr, fn in reversed(undo):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
    return installed, missing, remove


class Span:
    def __init__(self, host_us, device_us, cubes):
        self.host_ms = host_us / cubes / 1e3
        self.device_ms = device_us / cubes / 1e3


class Readings:
    """What the metric readers read: the traced cubes' summaries
    (``tracearith.summarize``) and the cell."""

    def __init__(self, summaries, cell):
        self.cell = cell
        self.cubes = len(summaries)
        self.window_us = sum(s["window"] for s in summaries)
        self.busy_us = sum(s["busy"] for s in summaries)
        self.spans = {}
        for s in summaries:
            for name, (h, d) in s["spans"].items():
                a, b = self.spans.get(name, (0.0, 0.0))
                self.spans[name] = (a + h, b + d)

    @property
    def idle_share(self):
        return 1.0 - self.busy_us / self.window_us

    def span(self, name):
        if name not in self.spans:
            return None
        return Span(*self.spans[name], self.cubes)

    def roofline_pct(self, span_name, stage):
        from .roofline import least_seconds
        span = self.span(span_name)
        least = least_seconds(stage, self.cell.config, self.cell.mix,
                              self.cell.shape)
        if span is None or least is None or span.device_ms <= 0:
            return None
        return 100.0 * least[0] * 1e3 / span.device_ms


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def card_line():
    """The card's name and power limit, from nvidia-smi (None without
    it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def _drop(dev, release=False):
    """Collect what was dropped and wait for the device; ``release`` also
    hands the allocator's cached blocks back (before the reference, whose
    blocks differ; not after the warm cube, whose blocks the window's cubes
    reuse)."""
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        if release:
            torch.cuda.empty_cache()


def _window(chain, seconds):
    """Cubes one after another until ``seconds`` have passed at the end of
    one: (cubes, window seconds, the last cube's products and draw)."""
    walls = []
    products = draw = None
    t0 = now = time.perf_counter()
    while True:
        draw = chain.draw()
        products = None
        products = chain.run(draw)
        t, now = now, time.perf_counter()
        walls.append(now - t)
        if now - t0 >= seconds:
            break
    log("cubebench: host seconds a cube: "
        + " ".join(f"{w:.4f}" for w in walls[:400]))
    return len(walls), now - t0, products, draw


def _traced(chain, dev, spans):
    """:data:`TRACED_CUBES` cubes, each in its own profiler session, with
    ``spans`` installed: (summaries, the last products and draw, spans
    missing)."""
    import torch
    from .tracearith import read_trace, summarize
    installed, missing, remove = install_spans(spans)
    summaries = []
    products = draw = None
    try:
        for _ in range(TRACED_CUBES):
            draw = chain.draw()
            products = None
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            try:
                with torch.profiler.record_function(WINDOW):
                    products = chain.run(draw)
            finally:
                prof.stop()
            fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                events = read_trace(path)
            finally:
                os.unlink(path)
            summaries.append(summarize(events, WINDOW, installed,
                                       dev.index or 0))
            del events, prof
    finally:
        remove()
    return summaries, products, draw, missing


def _breakdown(summaries):
    ops, gaps = {}, []
    for s in summaries:
        for name, us in s["ops"].items():
            ops[name] = ops.get(name, 0.0) + us
        gaps += s["gaps"]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:BREAKDOWN]
    longest = sorted(gaps, key=lambda g: -g[0])[:BREAKDOWN]
    return {"device_ops": [[n[:160], us / 1e6] for n, us in top],
            "idle_gaps": [[str(n)[:160], us / 1e6] for us, n in longest]}


def check(cell, inp, products, draws):
    """(correct, {name: {"value", "limit"}}, {what was left out}) of the
    program's ``products`` against the reference on ``inp`` and the
    cube's ``draws``."""
    from .reference import chains as ref
    want = ref.products(cell.config, cell.mix, inp, draws)
    numbers, left_out = ref.compare(products, want)
    del want
    compared = {}
    correct = True
    for name, value in numbers.items():
        limit = cell.limits.get(name)
        ok = limit is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        compared[name] = {"value": value, "limit": limit}
    if not numbers:
        correct = False
    return correct, compared, left_out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell, seed, seconds, trace, dev, t_start):
    """One run of ``cell`` on ``dev``: the result dict the last line
    prints.  On a device other than CUDA (the CPU tests) it reports no
    device metric."""
    import torch
    from .chains import Chain
    from .cubegen import make_cube
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = make_cube(cell.shape, seed, dev)
    chain = Chain(cell.config, cell.mix, seed, inp)
    try:
        chain.run(chain.draw())
        _drop(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start
        log(f"cubebench: {cell.name} seed {seed}: set-up {setup_s:.3f} s")
        metrics, device = {}, {}
        breakdown = None
        if trace:
            summaries, products, draw, missing = _traced(
                chain, dev, spans_read(cell.per_layer))
            attempted = len(summaries)
            if missing:
                log(f"cubebench: spans whose boundary is gone: {missing}")
        else:
            attempted, elapsed, products, draw = _window(chain, seconds)
            log(f"cubebench: {attempted} cubes in {elapsed:.3f} s")
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        if cuda:
            ms = torch.cuda.memory_stats(dev)
            log("cubebench: allocator: " + ", ".join(
                f"{k} {ms.get(k)}" for k in (
                    "num_alloc_retries", "num_device_alloc",
                    "num_device_free", "num_ooms")))
        _drop(dev, release=True)
        if trace:
            readings = Readings(summaries, cell)
            for m in cell.per_layer:
                v = reader(m["name"])(readings)
                if v is not None and cuda:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if cuda:
                device.update(busy_s=readings.busy_us / 1e6,
                              window_s=readings.window_us / 1e6)
                breakdown = _breakdown(summaries)
        else:
            values = {"cube_s": elapsed / attempted, "setup_s": setup_s}
            if cuda:
                values["peak_gib"] = peak / GIB
            # an end-to-end metric is named by what it measures, and split
            # by a suffix where cells of another kind keep a bound of
            # their own (``cube_s.pipeline``)
            for m in cell.end_to_end:
                v = values.get(m["name"].split(".")[0])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    finally:
        chain.close()
    correct, compared, left_out = check(cell, inp, products, draw)
    log(f"cubebench: left out of the comparison: {left_out}")
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else 1, "metrics": metrics}
    if cuda:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "count": cell.chips, "memory_peak_bytes": int(peak),
                  **device}
    result["device"] = device
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def main(argv, root, t_start):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload, root)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"cubebench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"cubebench: card {card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, args.trace, dev,
                      t_start)
    found = forbidden_modules()
    if found:
        log(f"cubebench: the run loaded {found}, which no run may load")
        return 3
    for name, c in result["compared"].items():
        log(f"compared {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
