"""Time two versions of the port's memory-bound kernels (moments, the raw
and the filled resample, and the banded product) in turns on one GPU.

    git archive REV | tar -x -C OLD      # OLD listed in .gitignore
    python3 tools/memory_ab.py --parent OLD [--ptxas] [--only KERNEL]
    python3 tools/memory_ab.py --probe [--ptxas] [--only KERNEL]

KERNEL is one of moments, resample2, resample2_filled, banded_matmul.
``OLD`` is an unpacked checkout of another commit (for example the parent
of a change to ``csrc/moments.cu``, ``csrc/resample2.cu`` or
``csrc/banded_matmul.cu``).  Its kernels are driven through its own
wrappers (``kernels/*.py`` of that tree, built there as that package
builds), in a worker process whose import path starts at ``OLD``, since
the C interfaces of the two versions may differ.  This process drives the
package it belongs to.  Both make ``chip_smoke.py``'s inputs on the card
from its seeds, each kernel's only when it runs: the 623 x 768 x 768 cube
with its NaN border ("nan") and with every NaN set to 0 ("clean"),
resampled onto the pipeline's shifted grid (a translation) and onto the
700 x 700 grid of 1.07x pixels; the moments phase's masked cubes (the
border plus 40 NaN rows and one NaN plane) at 623 and 1024 channels, with
the fused comparison (> 0.75) or the same predicate as a bool include
mask, with and without statistics; the filled resample of the spectral
cube (NaN border and holes) onto 311 channels and the shifted grid, as
``cube.reproject`` forms its inputs (every channel flagged); and bench
config 2's banded operator (512 -> 256) on the first 512 channels of the
cube viewed as (512, 589824), clean, with its NaN border, and with every
row cut to its first tap ("len1": a row's copies and stores with one FMA,
though a row then spans fewer input rows).

For each case it times the parent and the package with CUDA events in the
order parent, package, package, parent (each time a wrapper call, host
work included), then each one's kernel alone (its device time in a
torch.profiler trace), checks that the moments planes and counts and the
filled resample are bitwise equal between the two and that the raw
resample's and the banded product's NaN patterns are equal, and prints
their largest value difference from the parent.  Exits 1 if a check
fails.  ``--ptxas`` prints the registers, spills and
shared memory of both versions' kernels first (``nvcc -Xptxas -v``) and
the package's SASS instruction counts per kernel.
``--probe`` times only the package's kernels on inputs and plans that take
parts of their work away: the raw resample's wrapper against its launch
alone (taps already on the card), every channel invalid (writes only), one
output column (the whole compute, almost nothing staged or written),
scalar against 16-byte stores, and rings of 1 to 3 steps in flight; the
filled resample's wrapper against its launch alone, every channel
unflagged (no wz staged), every channel invalid, one output column, rings
of 1 and 3 steps and 64-column strips; the banded product's wrapper
against its launch alone, its tables cut to one record a group (the same
copies and stores, one FMA a row), one output row stored (the same copies
and FMAs), a ring of 2 steps (one block an SM) and its other shapes; the
moments kernel on an all-NaN cube (copies and stores only), with the mask
fused or as an include array, with 4-byte copies and with rings of 3 and
4 stages.  Each probe time is given three ways: single calls between CUDA
events (host work included), calls queued back to back, and the kernel's
device time in a torch.profiler trace.  Prints the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from spectral_ab import _digest, ptxas, sass_counts  # noqa: E402

CASES = tuple(
    [("moments", str(n), mask, stats) for n in (623, 1024)
     for mask in ("fused", "include") for stats in ("nostats", "stats")]
    + [("resample2", label, kind, "-") for label in ("translation",
                                                      "scaled")
       for kind in ("nan", "clean")]
    + [("resample2_filled", "spectral", "nan", "-")]
    + [("banded_matmul", "config2", kind, "-")
       for kind in ("clean", "nan", "len1")])
KERNELS = ("moments", "resample2", "resample2_filled", "banded_matmul")
SOURCES = ("moments.cu", "resample2.cu", "banded_matmul.cu")
#: each case's kernel, as the profiler names it (a name the kernels of
#: both versions hold)
KERNEL_NAMES = {"moments": "moments_kernel", "resample2": "resample2_kernel",
                "resample2_filled": "resample2",
                "banded_matmul": "banded_matmul_kernel"}
#: kernels whose outputs must be bitwise equal to the parent's
BITWISE = ("moments", "resample2_filled")


def _chip_smoke():
    """This tree's chip_smoke.py, whatever the import path holds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Inputs:
    """The cases' inputs, made on the card at first use."""

    def __init__(self, cs):
        self.cs = cs
        self._made = {}

    def _get(self, name, make):
        if name not in self._made:
            self._made[name] = make()
        return self._made[name]

    @property
    def raw(self):
        import torch
        cs = self.cs

        def make():
            nan = torch.as_tensor(cs.synth_cube(cs.NCHAN, cs.NY, cs.NX,
                                                cs.SEED), device="cuda")
            return {"nan": nan, "clean": torch.nan_to_num(nan, nan=0.0)}
        return self._get("raw", make)

    @property
    def targets(self):
        cs = self.cs
        return self._get("targets", lambda: {
            label: (taps, valid, maps[0]) for label, taps, valid, maps
            in cs.resample_cases(cs.synth_header(cs.NCHAN, cs.NY, cs.NX))})

    @property
    def mom(self):
        import torch
        cs = self.cs

        def make():
            masked = self.raw["nan"].clone()
            big = torch.as_tensor(cs.synth_cube(1024, cs.NY, cs.NX,
                                                cs.SEED + 2), device="cuda")
            for x in (masked, big):
                x[:, :40] = float("nan")
                x[7] = float("nan")
            return {623: masked, 1024: big}
        return self._get("mom", make)

    @property
    def inc(self):
        return self._get("inc", lambda: {n: x > 0.75
                                         for n, x in self.mom.items()})

    @property
    def coords(self):
        return {n: np.arange(x.shape[0]) * 0.25 for n, x in self.mom.items()}

    @property
    def filled(self):
        """(fz, wz, wz_any, taps, valid, zvalid) of the spectral cube onto
        chip_smoke.py's 311-channel target."""
        cs = self.cs

        def make():
            import spectral_cube_tpu_torch as T
            from spectral_cube_tpu_torch.wcs import WCS
            h = cs.synth_header(cs.NCHAN, cs.NY, cs.NX)
            data = cs.add_holes(cs.synth_cube(cs.NCHAN, cs.NY, cs.NX,
                                              cs.SEED + 3), cs.SEED + 4)
            cube = T.SpectralCube(data, WCS(header=h), header=h,
                                  device="cuda")
            return cs.filled_inputs(cube, cs.spectral_target(h))
        return self._get("filled", make)

    @property
    def banded(self):
        """bench config 2's operator: its bands, the bands cut to one tap
        a row, and the (512, 589824) clean and NaN-border data."""
        import torch
        cs = self.cs

        def make():
            from spectral_cube_tpu_torch.kernels import banded_matmul as kb
            bands = kb.row_bands(cs.config2_operator(cs.BM_NIN))
            one = kb.RowBands(bands.start, np.minimum(bands.length, 1),
                              np.ascontiguousarray(bands.taps[:, :1]),
                              bands.nin)
            nan = self.raw["nan"][:cs.BM_NIN].reshape(cs.BM_NIN, -1)
            return {"bands": bands, "len1": one, "nan": nan,
                    "clean": torch.nan_to_num(nan, nan=0.0)}
        return self._get("banded", make)

    def call(self, kernel, a, b, c):
        """The case's launch through this process's package."""
        from spectral_cube_tpu_torch.kernels import banded_matmul as kb
        from spectral_cube_tpu_torch.kernels import moments as km
        from spectral_cube_tpu_torch.kernels import resample2 as kr
        if kernel == "moments":
            n, stats = int(a), c == "stats"
            x, xc = self.mom[n], self.coords[n]
            if b == "fused":
                return lambda: km.moments_planes(x, xc, 1, 0.75, None, stats)
            inc = self.inc[n]
            return lambda: km.moments_planes(x, xc, 0, 0.0, inc, stats)
        if kernel == "resample2_filled":
            fz, wz, wz_any, taps, valid, zvalid = self.filled
            return lambda: kr.resample2_filled(fz, wz, wz_any, *taps, valid,
                                               zvalid)
        if kernel == "banded_matmul":
            d = self.banded
            bands = d["len1"] if b == "len1" else d["bands"]
            x = d["clean" if b == "len1" else b]
            return lambda: kb.banded_matmul(x, bands)
        taps, valid, zvalid = self.targets[a]
        x = self.raw[b]
        return lambda: kr.resample2(x, *taps, valid, zvalid)

    @staticmethod
    def summary(kernel, out, path):
        """Digests of the output's bits; the resample's NaN pattern, and
        its values written to ``path`` for the difference."""
        import torch
        if kernel == "moments":
            return {"bits": _digest(out[0]), "count": _digest(out[1])}
        out.cpu().numpy().tofile(path + ".f32")
        return {"bits": _digest(out),
                "nan": _digest(torch.isnan(out).to(torch.int32))}


def worker(parent):
    """Serve requests on stdin for the parent's package: lines
    ``KERNEL A B C PATH`` (run, save the summary) or ``time KERNEL A B C``."""
    import torch
    inp = Inputs(_chip_smoke())
    print("ready", flush=True)
    for line in sys.stdin:
        words = line.split()
        if not words:
            continue
        if words[0] == "quit":
            break
        if words[0] == "time":
            fn = inp.call(*words[1:5])
            print(f"ms {inp.cs.cuda_ms(fn, 5)!r}", flush=True)
            continue
        if words[0] == "device":
            ms = device_ms(inp.call(*words[1:5]), KERNEL_NAMES[words[1]])
            print(f"ms {float('nan') if ms is None else ms!r}", flush=True)
            continue
        try:
            out = inp.call(*words[:4])()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            print(f"refused {e}".replace("\n", " "), flush=True)
            continue
        torch.save(inp.summary(words[0], out, words[4]), words[4])
        del out
        print("saved", flush=True)
    return 0


class Parent:
    def __init__(self, tree):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        self.p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env, cwd=os.path.abspath(tree))
        line = self.p.stdout.readline()
        if not line.startswith("ready"):
            raise RuntimeError(f"parent worker: {line!r}")

    def ask(self, cmd):
        self.p.stdin.write(cmd + "\n")
        self.p.stdin.flush()
        return self.p.stdout.readline().strip()

    def close(self):
        self.ask("quit")
        self.p.wait(timeout=120)


def compare(kernel, out, want, path):
    """(checks passed, note) for one case: the package's output against
    the parent's summary (bits for BITWISE kernels, else the NaN
    pattern)."""
    import torch
    if kernel == "moments":
        same = _digest(out[0]) == want["bits"]
        count = _digest(out[1]) == want["count"]
        return same and count, (f"planes bitwise equal {same}, counts "
                                f"bitwise equal {count}")
    nan_same = _digest(torch.isnan(out).to(torch.int32)) == want["nan"]
    same = _digest(out) == want["bits"]
    old = torch.from_numpy(np.fromfile(path + ".f32", np.float32)).to(
        out.device).reshape(out.shape)
    os.unlink(path + ".f32")
    diff = torch.nan_to_num(out) - torch.nan_to_num(old)
    worst = float(diff.abs().max())
    scale = float(torch.nan_to_num(old).abs().max())
    passed = same if kernel in BITWISE else nan_same
    return passed, (f"NaN patterns equal {nan_same}, bitwise equal "
                      f"{same}, max |diff| {worst:.3e} ({worst / scale:.2e}"
                      f" of the largest value)")


def queued_ms(fn, n=10):
    """Milliseconds a call of ``fn`` over ``n`` calls queued back to back
    between two CUDA events: the host's work hides behind the card's
    where it is the shorter."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, name, n=5):
    """Device milliseconds a launch of the kernels whose name holds
    ``name``, averaged over the launches a torch.profiler trace of ``n``
    calls holds, or None where it holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key:
            us += getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
            count += e.count
    return us / count / 1e3 if count else None


def _timer(cs):
    """``timed(label, fn)``: logs ``fn``'s time as the median of single
    calls between two CUDA events (host work included), queued back to
    back, and the kernel's device time in a profiler trace (the kernel
    named by the label's first word)."""
    def timed(label, fn):
        dev = device_ms(fn, KERNEL_NAMES[label.split()[0]])
        cs.log(f"  probe {label}: {cs.cuda_ms(fn, 7):.3f} ms, queued "
               f"{queued_ms(fn):.3f} ms, device "
               + ("not in the trace" if dev is None else f"{dev:.3f} ms"))
    return timed


def probe_resample2(cs, inp):
    """The raw resample on partial work (see the module's docstring)."""
    from spectral_cube_tpu_torch.kernels import resample2 as kr
    timed = _timer(cs)
    (y0, wy, x0, wx), valid, zvalid = inp.targets["translation"]
    x = inp.raw["nan"]
    timed("resample2 translation nan, wrapper",
          lambda: kr.resample2(x, y0, wy, x0, wx, valid, zvalid))
    timed("resample2 translation clean, wrapper",
          lambda: kr.resample2(inp.raw["clean"], y0, wy, x0, wx, valid,
                               zvalid))
    prep = kr.prepare(x, y0, wy, x0, wx, valid, zvalid)
    cs.log(f"  probe resample2 plan {prep.packed.plan}")
    timed("resample2 translation nan, launch alone",
          lambda: kr.launch(x, prep))
    timed("resample2 translation clean, launch alone",
          lambda: kr.launch(inp.raw["clean"], prep))
    none = kr.prepare(x, y0, wy, x0, wx, valid, np.zeros_like(zvalid))
    timed("resample2 every channel invalid (writes only), launch alone",
          lambda: kr.launch(x, none))
    one = kr.prepare(x, y0, wy, x0[:1], wx[:1], valid[:, :1], zvalid)
    timed("resample2 one output column, launch alone",
          lambda: kr.launch(x, one))
    chosen, depth = kr.plan, kr.DEPTH

    def scalar(*args, **kw):
        p = chosen(*args, **kw)
        return p._replace(store16=False, smem=p.smem - kr.WARPS * 128 * 4) \
            if p.store16 else p

    for label, plan, d in (("scalar stores", scalar, depth),
                           ("depth 1", chosen, 1), ("depth 3", chosen, 3)):
        kr.plan, kr.DEPTH = plan, d
        kr._PREPARED.clear()
        try:
            p = kr.prepare(x, y0, wy, x0, wx, valid, zvalid)
            timed(f"resample2 translation nan, {label} ({p.packed.plan}), "
                  "launch alone", lambda: kr.launch(x, p))
        finally:
            kr.plan, kr.DEPTH = chosen, depth
            kr._PREPARED.clear()


def probe_moments(cs, inp):
    """The moments kernel on partial work (see the module's docstring)."""
    import torch
    from spectral_cube_tpu_torch.kernels import moments as km
    timed = _timer(cs)
    m, xc = inp.mom[623], inp.coords[623]
    allnan = torch.full_like(m, float("nan"))
    timed("moments 623 fused", lambda: km.moments_planes(m, xc, 1, 0.75))
    timed("moments 1024 fused", lambda: km.moments_planes(
        inp.mom[1024], inp.coords[1024], 1, 0.75))
    timed("moments 623 all-NaN (copies and stores only)",
          lambda: km.moments_planes(allnan, xc, 1, 0.75))
    del allnan
    inc = inp.inc[623]
    timed("moments 623 include (bool)",
          lambda: km.moments_planes(m, xc, 0, 0.0, inc))
    inc8 = inc.to(torch.uint8)
    timed("moments 623 include (uint8)",
          lambda: km.moments_planes(m, xc, 0, 0.0, inc8))
    chosen, stages = km.plan, km.STAGES

    def copies4(*args, **kw):
        return chosen(*args, **kw)._replace(staging="cp.async4")

    for label, plan, st in (("4-byte copies", copies4, stages),
                            ("3 stages", chosen, 3), ("4 stages", chosen, 4)):
        km.plan, km.STAGES = plan, st
        try:
            timed(f"moments 623 fused, {label}",
                  lambda: km.moments_planes(m, xc, 1, 0.75))
        finally:
            km.plan, km.STAGES = chosen, stages


def probe_resample2_filled(cs, inp):
    """The filled resample on partial work (see the module's docstring)."""
    import torch
    from spectral_cube_tpu_torch.kernels import resample2 as kr
    timed = _timer(cs)
    fz, wz, wz_any, (y0, wy, x0, wx), valid, zvalid = inp.filled
    cs.log(f"  probe resample2_filled: {int(wz_any.sum())} of "
           f"{wz_any.numel()} channels flagged")
    timed("resample2_filled path, wrapper",
          lambda: kr.resample2_filled(fz, wz, wz_any, y0, wy, x0, wx, valid,
                                      zvalid))

    def alone(label, yx=(y0, wy, x0, wx), vp=valid, zv=zvalid,
              flags=wz_any):
        p = kr.prepare(fz, *yx, vp, zv, wz=wz, wz_any=flags)
        timed(f"resample2_filled {label} ({p.packed.plan}), launch alone",
              lambda: kr.launch(fz, p, wz))

    alone("path")
    alone("every channel unflagged (fz only)",
          flags=torch.zeros_like(wz_any))
    alone("every channel invalid (writes only)", zv=np.zeros_like(zvalid))
    alone("one output column", yx=(y0, wy, x0[:1], wx[:1]),
          vp=valid[:, :1])
    chosen, depth = kr.plan, kr.DEPTH

    def width64(y0_, x0_, ny_in, nx_in, nchan, aligned=True, planes=1):
        saved = kr.WIDTHS
        kr.WIDTHS = (64,)
        try:
            return chosen(y0_, x0_, ny_in, nx_in, nchan, aligned, planes)
        finally:
            kr.WIDTHS = saved

    for label, plan, d in (("depth 1", chosen, 1), ("depth 3", chosen, 3),
                           ("64-column strips", width64, depth)):
        kr.plan, kr.DEPTH = plan, d
        kr._PREPARED.clear()
        try:
            alone(label)
        finally:
            kr.plan, kr.DEPTH = chosen, depth
            kr._PREPARED.clear()


def probe_banded_matmul(cs, inp):
    """The banded product on partial work (see the module's docstring)."""
    import torch
    from spectral_cube_tpu_torch.kernels import banded_matmul as kb
    timed = _timer(cs)
    d = inp.banded
    bands, x = d["bands"], d["clean"]
    timed("banded_matmul config2, wrapper",
          lambda: kb.banded_matmul(x, bands))
    prep = kb.prepare(x, bands)
    p = prep.packed.plan
    timed(f"banded_matmul config2 ({p}), launch alone",
          lambda: kb.launch(x, prep))
    # one record a group: the same copies and stores, one FMA a row
    words = prep.packed.words.reshape(p.steps, p.table_words).copy()
    goff = 4 + -(-2 * p.max_loads // 4) * 4
    for w in range(kb.WARPS):
        at = goff + w * p.group_words
        words[:, at] = np.minimum(words[:, at], 1)
    one = prep._replace(words=torch.from_numpy(words.ravel()).to(x.device))
    timed("banded_matmul one record a group (copies and stores), launch "
          "alone", lambda: kb.launch(x, one))
    # one output row stored: the same copies and FMAs
    timed("banded_matmul one output row stored (copies and FMAs), launch "
          "alone", lambda: kb.launch(x, prep._replace(nout=1)))
    shapes, depths = kb.SHAPES, kb.DEPTHS
    for label, sh, dp in (("depth 2", shapes[:1], (2,)),
                          ("rows 1, 128 columns", ((1, 4),), depths),
                          ("rows 1, 32 columns", ((1, 1),), depths)):
        kb.SHAPES, kb.DEPTHS = sh, dp
        kb._PREPARED.clear()
        try:
            q = kb.prepare(x, bands)
            timed(f"banded_matmul {label} ({q.packed.plan}), launch alone",
                  lambda: kb.launch(x, q))
        finally:
            kb.SHAPES, kb.DEPTHS = shapes, depths
            kb._PREPARED.clear()


PROBES = {"moments": probe_moments, "resample2": probe_resample2,
          "resample2_filled": probe_resample2_filled,
          "banded_matmul": probe_banded_matmul}


def ab(cs, inp, tree, only=None):
    """The cases in turns, parent (the checkout ``tree``, in a worker
    process) against the package; True when every bitwise check passed."""
    import torch
    parent = Parent(tree)
    ok = True
    with tempfile.TemporaryDirectory() as d:
        for case in CASES:
            if only and case[0] != only:
                continue
            words = " ".join(case)
            path = os.path.join(d, "case.pt")
            said = parent.ask(f"{words} {path}")
            fn = inp.call(*case)
            out = fn()
            torch.cuda.synchronize()
            if said == "saved":
                passed, note = compare(case[0], out, torch.load(path), path)
                ok &= passed
            else:
                note = f"parent: {said}"
            del out
            times = {"parent": [], "package": []}
            for who in ("parent", "package", "package", "parent"):
                if who == "package":
                    times[who].append(cs.cuda_ms(fn, 5))
                elif said == "saved":
                    times[who].append(float(parent.ask(
                        f"time {words}").split()[1]))
            dev = {"package": device_ms(fn, KERNEL_NAMES[case[0]])}
            if said == "saved":
                dev["parent"] = float(
                    parent.ask(f"device {words}").split()[1])
            cs.log(f"  {words}: ms in turns parent {times['parent']}, "
                   f"package {times['package']}; device ms parent "
                   f"{dev.get('parent')}, package {dev['package']}; {note}")
    parent.close()
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of the version "
                    "to compare with")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="time the package's kernels on partial work only")
    ap.add_argument("--only", choices=KERNELS,
                    help="compare or probe one kernel's cases only")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.worker))
        return worker(args.worker)
    import torch
    if not torch.cuda.is_available():
        print("memory_ab: CUDA is not available", file=sys.stderr)
        return 1
    if not args.parent and not args.probe:
        ap.error("--parent or --probe is required")
    sys.path.insert(0, ROOT)
    cs = _chip_smoke()
    from spectral_cube_tpu_torch.kernels import _build
    cs.log(f"card: {cs.card_line()}")
    if args.ptxas:
        trees = (("parent", args.parent),) if args.parent else ()
        for name, tree in trees + (("package", ROOT),):
            for src in SOURCES:
                path = os.path.join(tree, "spectral_cube_tpu_torch", "csrc",
                                    src)
                cs.log(f"ptxas, {name} {src}:\n{ptxas(path)}")
        for src in SOURCES:
            path = os.path.join(ROOT, "spectral_cube_tpu_torch", "csrc", src)
            cs.log(f"SASS instructions, package {src}:\n{sass_counts(path)}")
    _build.load_library()
    inp = Inputs(cs)
    ok = ab(cs, inp, args.parent, args.only) if args.parent else True
    # the probe's profiler sessions come after the worker's have ended
    if args.probe:
        for name in KERNELS:
            if args.only in (None, name):
                PROBES[name](cs, inp)
    print(cs.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
