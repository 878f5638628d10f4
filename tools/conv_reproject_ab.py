"""Time two versions of the fused convolve + reproject kernel in turns on one
GPU.

    git archive REV | tar -x -C OLD      # OLD listed in .gitignore
    python3 tools/conv_reproject_ab.py --parent OLD [--ptxas]

``OLD`` is an unpacked checkout of another commit (for example the parent
of a change to ``csrc/conv_reproject.cu``).  Its kernel is driven through
its own wrapper (``spectral_cube_tpu_torch.kernels.conv_reproject`` and
``pipeline_fused`` of that tree, built there as that package builds), in a
worker process whose import path starts at ``OLD``, since the C layout of
the two versions may differ.  This process drives the package it belongs
to.  Both make the inputs of ``chip_smoke.py``'s conv_reproject phase on
the card from its seeds: bench config 5's clean cube (a) and the
NaN-bordered pipeline cube (b), 623 x 768 x 768, the 19 x 19 kernel from a
6" x 4.5" beam at PA 30 deg to 12" (rank 5), a grid shifted by (0.37,
-0.61) px.  For each cube and mode (0: ``conv_reproject``, 1:
``plain_strips``, 2: ``pipeline_fused``) it times the parent and the
package with CUDA events in the order parent, package, package, parent,
and holds the package's output against the parent's on three channels
(NaN patterns equal, the largest difference printed; mode 2 also its
planes and counts bitwise).  ``--ptxas`` prints the registers, spills and
shared memory of both sources' kernels first (``nvcc -Xptxas -v``).
Prints the card's name and power limit.
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
CASES = tuple((label, mode) for label in ("a", "b") for mode in (0, 1, 2))
SAMPLE = (0, 311, 622)


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
            m = re.search(r"conv_reproject_kernelILi(\d+)E(?:Li(\d+)E)?",
                          name)
            label = name.split("_cu_")[-1][:40] if m is None else (
                f"mode {m.group(1)}"
                + (f" rank {m.group(2)}" if m.group(2) else ""))
            lines.append(f"  {label}: {line.split(':', 1)[-1].strip()}")
    return "\n".join(lines)


class Inputs:
    """The phase's cubes and operators, on the card."""

    def __init__(self, cs):
        import torch
        from spectral_cube_tpu_torch.ops import regrid as og
        dev = torch.device("cuda", 0)
        cube_beam, target_beam = cs.beams()
        kern = target_beam.deconvolve(cube_beam).as_kernel(
            np.radians(cs.PIX_ARCSEC / 3600.0))
        ys, xs = cs.axis_maps(cs.NY, cs.NX, 1.0, cs.SHIFT[0], 1.0,
                              cs.SHIFT[1])
        self.cubes = {
            "a": cs.synth_config5(cs.NCHAN, cs.NY, cs.NX, cs.SEED + 7, dev),
            "b": torch.as_tensor(cs.synth_cube(cs.NCHAN, cs.NY, cs.NX,
                                               cs.SEED), device=dev)}
        self.ops = og._conv_reproject_operators(
            self.cubes["a"].shape, kern, ys, xs)
        self.xc = np.arange(cs.NCHAN) * 0.25
        self.xc = self.xc - self.xc.mean()
        self.thr = cs.FUSED_THRESHOLD

    def call(self, label, mode):
        """The case's launch through this process's package: a function
        returning its outputs."""
        from spectral_cube_tpu_torch.kernels import conv_reproject as kcr
        from spectral_cube_tpu_torch.kernels import pipeline_fused as kpf
        x, o = self.cubes[label], self.ops
        args = (o.gy, o.gx, o.my, o.mx, o.ry, o.rx, o.valid)
        if mode == 0:
            return lambda: (kcr.conv_reproject(x, *args),)
        if mode == 1:
            gi = np.zeros(x.shape[0], np.int32)
            return lambda: (kcr.plain_strips(x, o.gy, o.gx, gi),)
        return lambda: kpf.pipeline_fused(x, *args, self.xc, 1, self.thr)


def _sample(outs):
    """The cube's SAMPLE channels and any planes, on the host."""
    return [outs[0][list(SAMPLE)].cpu()] + [t.cpu() for t in outs[1:]]


def worker(parent):
    """Serve timing requests on stdin for the parent's package: lines
    ``LABEL MODE`` (run and save the sample) or ``time LABEL MODE``."""
    import torch
    cs = _chip_smoke()
    cs.no_tf32()
    inp = Inputs(cs)
    print("ready", flush=True)
    for line in sys.stdin:
        words = line.split()
        if not words:
            continue
        if words[0] == "quit":
            break
        if words[0] == "time":
            fn = inp.call(words[1], int(words[2]))
            print(f"ms {cs.cuda_ms(fn, 5)!r}", flush=True)
            continue
        fn = inp.call(words[0], int(words[1]))
        try:
            outs = fn()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            print(f"refused {e}".replace("\n", " "), flush=True)
            continue
        torch.save(_sample(outs), words[2])
        print("saved", flush=True)
    return 0


class Parent:
    def __init__(self, tree):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        self.p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env, cwd=os.path.abspath(tree))
        self._expect("ready")

    def _expect(self, word):
        line = self.p.stdout.readline()
        if not line.startswith(word):
            raise RuntimeError(f"parent worker: {line!r}")
        return line

    def ask(self, cmd):
        self.p.stdin.write(cmd + "\n")
        self.p.stdin.flush()
        return self.p.stdout.readline().strip()

    def close(self):
        self.ask("quit")
        self.p.wait(timeout=120)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of the version "
                    "to compare with")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.worker))
        return worker(args.worker)
    import torch
    if not torch.cuda.is_available():
        print("conv_reproject_ab: CUDA is not available", file=sys.stderr)
        return 1
    if not args.parent:
        ap.error("--parent is required")
    sys.path.insert(0, ROOT)
    cs = _chip_smoke()
    from spectral_cube_tpu_torch.kernels import _build
    cs.log(f"card: {cs.card_line()}")
    src = "spectral_cube_tpu_torch/csrc/conv_reproject.cu"
    if args.ptxas:
        for name, tree in (("parent", args.parent), ("package", ROOT)):
            cs.log(f"ptxas, {name}:\n{ptxas(os.path.join(tree, src))}")
    cs.no_tf32()
    _build.load_library()
    parent = Parent(args.parent)
    inp = Inputs(cs)
    with tempfile.TemporaryDirectory() as d:
        for label, mode in CASES:
            path = os.path.join(d, f"{label}{mode}.pt")
            said = parent.ask(f"{label} {mode} {path}")
            fn = inp.call(label, mode)
            got = _sample(fn())
            torch.cuda.synchronize()
            if said == "saved":
                want = torch.load(path)
                nan_same = bool(torch.equal(torch.isnan(got[0]),
                                            torch.isnan(want[0])))
                diff = float((torch.nan_to_num(got[0])
                              - torch.nan_to_num(want[0])).abs().max())
                note = f"NaN patterns equal {nan_same}, max diff {diff:.3e}"
                if mode == 2:
                    note += (", planes and counts bitwise "
                             f"{all(torch.equal(u, v) for u, v in zip(got[1:], want[1:]))}")
            else:
                note = f"parent: {said}"
            times = {"parent": [], "package": []}
            for who in ("parent", "package", "package", "parent"):
                if who == "package":
                    times[who].append(cs.cuda_ms(fn, 5))
                elif said == "saved":
                    times[who].append(float(parent.ask(
                        f"time {label} {mode}").split()[1]))
            cs.log(f"  ({label}) mode {mode}: ms in turns parent "
                   f"{times['parent']}, package {times['package']}; {note}")
    parent.close()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
