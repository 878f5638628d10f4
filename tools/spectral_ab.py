"""Time two versions of the spectral path's kernels (sigma_clip and
smooth_interp) in turns on one GPU.

    git archive REV | tar -x -C OLD      # OLD listed in .gitignore
    python3 tools/spectral_ab.py --parent OLD [--ptxas] [--only KERNEL]
    python3 tools/spectral_ab.py --probe [--ptxas]

``OLD`` is an unpacked checkout of another commit (for example the parent
of a change to ``csrc/sigma_clip.cu`` or ``csrc/smooth_interp.cu``).  Its
kernels are driven through its own wrappers (``kernels/sigma_clip.py`` and
``kernels/smooth_interp.py`` of that tree, built there as that package
builds), in a worker process whose import path starts at ``OLD``, since
the C interfaces of the two versions may differ.  This process drives the
package it belongs to.  Both make the inputs of ``chip_smoke.py``'s
spectral phase on the card from its seeds: the 623 x 768 x 768 cube (a
Gaussian line on unit noise, NaN outside a circular primary-beam cutoff,
40 NaN holes inside spectra), and its every second channel for 312
channels; "clean" sets every NaN to 0.  sigma_clip clips each at 1 sigma,
5 iterations, median centre.  smooth_interp takes the path's operators
(17-tap Gaussian smooth, every second channel) from 623 or 312 channels.

For each case it times the parent and the package with CUDA events in
the order parent, package, package, parent, and checks that sigma_clip's
outputs and smooth_interp's outputs on the spectra without NaN are
bitwise equal between the two (digests of the bits on the card), that
smooth_interp's NaN patterns are equal, and prints the largest difference
on the spectra with NaN.  Exits 1 if a bitwise check fails.  ``--ptxas``
prints the registers, spills and shared memory of both versions' kernels
first (``nvcc -Xptxas -v``) and the package's SASS instruction counts per
kernel (``cuobjdump -sass``: all, and the shuffles, shared loads and
stores, min/max and branches).  ``--probe`` times only the package's
kernels on inputs that take parts of their work away: sigma_clip with 5,
1 and 0 band iterations and on an all-NaN cube (staging and writes
only), smooth_interp on an all-NaN cube and with a single output row
(staging and the finiteness pass only), and with each staging form
(16-byte and 4-byte cp.async) on the same tile and ring.  Prints the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = tuple((kernel, nchan, label)
              for kernel in ("sigma_clip", "smooth_interp")
              for nchan in (312, 623) for label in ("clean", "holes"))
SOURCES = ("sigma_clip.cu", "smooth_interp.cu")


def _chip_smoke():
    """This tree's chip_smoke.py, whatever the import path holds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(src):
    """``nvcc -Xptxas -v`` of ``src``: one line per kernel (registers,
    spills, shared memory)."""
    from spectral_cube_tpu_torch.kernels import _build
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                              "-Xptxas", "-v", "-c", "-o",
                              os.path.join(d, "k.o"), src],
                             capture_output=True, text=True, check=True)
    lines, name = [], None
    for line in out.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            m = re.search(r"\d+(\w+_kernel)(?:IL[ib](\d+)E)?", name)
            label = name if m is None else (
                m.group(1) + (f"<{m.group(2)}>" if m.group(2) else ""))
            lines.append(f"  {label}: {line.split(':', 1)[-1].strip()}")
    return "\n".join(lines)


def sass_counts(src):
    """Static SASS instruction counts of each kernel of ``src``: all of
    them, and the shuffles, shared loads, shared stores, float min/max
    and branches."""
    from spectral_cube_tpu_torch.kernels import _build
    ops = ("SHFL", "LDS", "STS", "FMNMX", "BRA")
    with tempfile.TemporaryDirectory() as d:
        obj = os.path.join(d, "k.o")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", obj,
                        src], capture_output=True, check=True)
        dump = subprocess.run(
            [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
             "-sass", obj], capture_output=True, text=True, check=True).stdout
    lines, name, counts = [], None, {}

    def flush():
        if name:
            lines.append(f"  {name}: " + ", ".join(
                f"{k} {v}" for k, v in counts.items()))

    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            m2 = re.search(r"\d+(\w+_kernel)(?:IL[ib](\d+)E)?", m.group(1))
            name = m.group(1) if m2 is None else (
                m2.group(1) + (f"<{m2.group(2)}>" if m2.group(2) else ""))
            counts = dict.fromkeys(("all",) + ops, 0)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if name and m:
            counts["all"] += 1
            op = m.group(1).split(".")[0]
            if op in counts:
                counts[op] += 1
    flush()
    return "\n".join(lines)


def probe(cs, inp):
    """Times of the package's kernels on inputs that take parts of their
    work away (see the module's docstring)."""
    import torch
    from spectral_cube_tpu_torch.kernels import sigma_clip as kc
    from spectral_cube_tpu_torch.kernels import smooth_interp as ks
    for nchan in (312, 623):
        x = inp.x[nchan, "holes"]
        live = int(torch.isfinite(x).any(0).sum())
        nan = torch.full_like(x, float("nan"))
        for label, data, iters in (("holes", x, 5), ("holes", x, 1),
                                   ("holes", x, 0),
                                   ("clean", inp.x[nchan, "clean"], 0),
                                   ("all-NaN", nan, 5)):
            ms = cs.cuda_ms(lambda: kc.sigma_clip(data, cs.CLIP_SIGMA, iters,
                                                  False), 5)
            cs.log(f"  probe sigma_clip {nchan} {label}, {iters} band "
                   f"iterations: {ms:.3f} ms ({live} live spaxels in holes)")
        del nan
    x = inp.x[623, "holes"]
    S, I, M, bands = inp.ops[623]
    nan = torch.full_like(x, float("nan"))
    M1, I1 = (np.ascontiguousarray(a[:1]) for a in (M, I))
    bands1 = [ks.band_rows(A) for A in (M1, S, I1)]
    for label, fn in (
            ("holes", lambda: ks.smooth_interp(x, M, S, I, bands)),
            ("all-NaN", lambda: ks.smooth_interp(nan, M, S, I, bands)),
            ("clean, 1 output row", lambda: ks.smooth_interp(
                inp.x[623, "clean"], M1, S, I1, bands1))):
        cs.log(f"  probe smooth_interp 623 {label}: "
               f"{cs.cuda_ms(fn, 5):.3f} ms")
    # the same tile and ring, each staging form
    chosen = ks.plan
    for staging in ("cp.async4", "cp.async16"):
        def forced(nin, ncol, aligned=True, staging=staging):
            return chosen(nin, ncol, aligned)._replace(staging=staging)
        ks.plan = forced
        try:
            ms = cs.cuda_ms(lambda: ks.smooth_interp(x, M, S, I, bands), 5)
        finally:
            ks.plan = chosen
        cs.log(f"  probe smooth_interp 623 holes, staging {staging}: "
               f"{ms:.3f} ms")


class Inputs:
    """The cases' inputs and operators, on the card."""

    def __init__(self, cs):
        import torch
        from spectral_cube_tpu_torch.ops import interpolate as oi
        from spectral_cube_tpu_torch.ops import smoothing as osm
        dev = torch.device("cuda", 0)
        raw = cs.add_holes(cs.synth_cube(cs.NCHAN, cs.NY, cs.NX,
                                         cs.SEED + 3), cs.SEED + 4)
        holes = {623: torch.as_tensor(raw, device=dev)}
        del raw
        holes[312] = holes[623][::2].contiguous()
        self.x = {}
        for nchan, x in holes.items():
            self.x[nchan, "holes"] = x
            self.x[nchan, "clean"] = torch.nan_to_num(x, nan=0.0)
        kern = osm.gaussian_kernel1d(cs.SMOOTH_STDDEV)
        self.ops = {}
        for nchan in holes:
            inaxis = np.arange(nchan) * 250.0
            idx, frac = oi.interp_weights(inaxis, inaxis[::2])
            self.ops[nchan] = oi._si_operators(kern / kern.sum(), idx, frac,
                                               nchan)
        self.cs = cs

    def call(self, kernel, nchan, label):
        """The case's launch through this process's package."""
        from spectral_cube_tpu_torch.kernels import sigma_clip as kc
        from spectral_cube_tpu_torch.kernels import smooth_interp as ks
        x = self.x[nchan, label]
        if kernel == "sigma_clip":
            cs = self.cs
            return lambda: kc.sigma_clip(x, cs.CLIP_SIGMA, cs.CLIP_ITERS,
                                         False)
        S, I, M, bands = self.ops[nchan]
        return lambda: ks.smooth_interp(x, M, S, I, bands)

    def summary(self, kernel, nchan, label, out):
        """Digests of the output's bits (all of them for sigma_clip, the
        spectra without NaN for smooth_interp), of its NaN pattern, and
        smooth_interp's outputs on the spectra with NaN."""
        import torch
        x = self.x[nchan, label].reshape(nchan, -1)
        flat = out.reshape(out.shape[0], -1)
        fin = torch.isfinite(x)
        res = {"nan": _digest(torch.isnan(flat).to(torch.int32))}
        if kernel == "sigma_clip":
            res["bits"] = _digest(flat)
            return res
        res["bits"] = _digest(flat[:, fin.all(0)].contiguous())
        dirty = fin.any(0) & ~fin.all(0)
        res["dirty"] = flat[:, dirty].cpu()
        return res


def _digest(t):
    """Two position-weighted sums of the 32-bit words of ``t``."""
    import torch
    words = t.reshape(-1).view(torch.int32)
    sums = [0, 0]
    for i0 in range(0, words.numel(), 1 << 26):
        w = words[i0:i0 + (1 << 26)].to(torch.int64)
        pos = torch.arange(i0, i0 + w.numel(), device=w.device) % 1000003
        sums[0] += int(w.sum())
        sums[1] += int((w * (pos + 1)).sum())
    return sums


def worker(parent):
    """Serve requests on stdin for the parent's package: lines
    ``KERNEL NCHAN LABEL PATH`` (run, save the summary) or
    ``time KERNEL NCHAN LABEL``."""
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
            fn = inp.call(words[1], int(words[2]), words[3])
            print(f"ms {inp.cs.cuda_ms(fn, 5)!r}", flush=True)
            continue
        kernel, nchan, label = words[0], int(words[1]), words[2]
        try:
            out = inp.call(kernel, nchan, label)()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            print(f"refused {e}".replace("\n", " "), flush=True)
            continue
        torch.save(inp.summary(kernel, nchan, label, out), words[3])
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


def compare(kernel, got, want):
    """(bitwise checks passed, note) for one case's two summaries."""
    import torch
    same = got["bits"] == want["bits"]
    nan_same = got["nan"] == want["nan"]
    what = "outputs" if kernel == "sigma_clip" else "clean spectra"
    note = f"{what} bitwise equal {same}, NaN patterns equal {nan_same}"
    if kernel == "smooth_interp":
        a, b = got["dirty"], want["dirty"]
        diff = float((torch.nan_to_num(a) - torch.nan_to_num(b)).abs().max()) \
            if a.numel() else 0.0
        note += f", {a.shape[1]} spectra with NaN: max diff {diff:.3e}"
    return same and nan_same, note


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of the version "
                    "to compare with")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="time the package's kernels on partial work only")
    ap.add_argument("--only", choices=("sigma_clip", "smooth_interp"),
                    help="compare one kernel's cases only")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.worker))
        return worker(args.worker)
    import torch
    if not torch.cuda.is_available():
        print("spectral_ab: CUDA is not available", file=sys.stderr)
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
    if args.probe:
        probe(cs, Inputs(cs))
        print(cs.card_line())
        return 0
    parent = Parent(args.parent)
    inp = Inputs(cs)
    ok = True
    with tempfile.TemporaryDirectory() as d:
        for kernel, nchan, label in CASES:
            if args.only and kernel != args.only:
                continue
            case = f"{kernel} {nchan} {label}"
            path = os.path.join(d, "case.pt")
            said = parent.ask(f"{case} {path}")
            fn = inp.call(kernel, nchan, label)
            got = inp.summary(kernel, nchan, label, fn())
            torch.cuda.synchronize()
            if said == "saved":
                passed, note = compare(kernel, got, torch.load(path))
                ok &= passed
            else:
                note = f"parent: {said}"
            times = {"parent": [], "package": []}
            for who in ("parent", "package", "package", "parent"):
                if who == "package":
                    times[who].append(cs.cuda_ms(fn, 5))
                elif said == "saved":
                    times[who].append(float(parent.ask(
                        f"time {case}").split()[1]))
            cs.log(f"  {case}: ms in turns parent {times['parent']}, "
                   f"package {times['package']}; {note}")
    parent.close()
    print(cs.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
