"""Time the spectral path of two or more checkouts in turns on one GPU.

    git archive REV | tar -x -C OLD      # OLD listed in .gitignore
    python3 tools/spectral_path_ab.py OLD [OTHER ...] [--rounds N]

Each checkout (``OLD``, ``OTHER``, ... and the one this script belongs
to, last) runs ``chip_smoke.py``'s spectral path in a process of its own
whose import path starts at that checkout: the 623 x 768 x 768 cube of
the spectral phase (a Gaussian line on unit noise, NaN outside a circular
primary-beam cutoff, 40 NaN holes inside spectra), written once to FITS
by this checkout and read by each with ``SpectralCube.read``, then
``spectral_smooth`` (17-tap Gaussian, ``convolve1d_nan``),
``spectral_interpolate`` onto every second channel with that smoothing
kernel (smooth_interp) and ``sigma_clip_spectrally`` (sigma_clip), as
the phase runs them: a first call and four more, each stage synchronised
on the host clock, with the peak device memory of the first.  The
kernels are built and loaded before the first call, as ``chip_smoke.py``
builds them before its phases.  One round runs the checkouts in order
and then in reverse (parent, change, change, parent for two), ``--rounds``
times.  Prints the card's name and power limit, one JSON line a process
and a table of the first calls and of the medians of the later ones.
The checkouts share the kernels' library where their sources are the
same (it is copied into their ``_build``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("spectral_smooth", "spectral_interpolate", "sigma_clip_spectrally")


def worker(tree, path, calls):
    sys.path.insert(0, tree)
    import time

    import torch
    import chip_smoke as cs
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.kernels import _build
    from spectral_cube_tpu_torch.ops import smoothing as osm
    assert os.path.realpath(T.__file__).startswith(
        os.path.realpath(tree) + os.sep), T.__file__
    _build.load_library()
    cs.no_tf32()
    cube = T.SpectralCube.read(path)
    kern = osm.gaussian_kernel1d(cs.SMOOTH_STDDEV)
    grid = cube.spectral_axis[::2]
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(calls):
        times = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            val = fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t) * 1e3
            return val
        sm = timed("spectral_smooth", lambda: cube.spectral_smooth(kern))
        si = timed("spectral_interpolate", lambda: sm.spectral_interpolate(
            grid, smooth_kernel=kern))
        timed("sigma_clip_spectrally",
              lambda: si.sigma_clip_spectrally(cs.CLIP_SIGMA))
        if i == 0:
            peak = torch.cuda.max_memory_allocated()
        runs.append(times)
        del sm, si
    print(json.dumps({"tree": tree, "runs": runs, "peak_gib": peak / 2**30}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "FITS"))
    a = ap.parse_args()
    if a.worker:
        worker(a.worker[0], a.worker[1], a.calls)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("spectral_path_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    from spectral_cube_tpu_torch.kernels import _build
    print("card:", cs.card_line(), flush=True)
    trees = [os.path.abspath(t) for t in a.trees] + [ROOT]
    _build.load_library()
    for t in trees[:-1]:
        shutil.copytree(_build.BUILD_DIR, os.path.join(
            t, "spectral_cube_tpu_torch", "_build"), dirs_exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "spectral.fits")
        data = cs.add_holes(cs.synth_cube(cs.NCHAN, cs.NY, cs.NX,
                                          cs.SEED + 3), cs.SEED + 4)
        write_fits(path, [HDU(data=data, header=cs.synth_header(
            cs.NCHAN, cs.NY, cs.NX))])
        del data
        order = (trees + trees[::-1]) * a.rounds
        out = {t: [] for t in trees}
        for t in order:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", t,
                 path, "--calls", str(a.calls)], cwd=t, capture_output=True,
                text=True, timeout=600)
            line = res.stdout.strip().splitlines()[-1:] or [""]
            print(line[0], flush=True)
            if res.returncode:
                print(res.stderr[-4000:], file=sys.stderr)
                return res.returncode
            out[t].append(json.loads(line[0]))
    print("tree | first call: " + ", ".join(STAGES)
          + ", total ms | later calls (median): same | peak GiB")
    for t in trees:
        for r in out[t]:
            first = [r["runs"][0][s] for s in STAGES]
            later = [statistics.median(x[s] for x in r["runs"][1:])
                     for s in STAGES]
            print(f"{os.path.relpath(t, ROOT) or '.'} | "
                  + ", ".join(f"{v:.1f}" for v in first)
                  + f", {sum(first):.1f} | "
                  + ", ".join(f"{v:.1f}" for v in later)
                  + f", {sum(later):.1f} | {r['peak_gib']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
