"""Find what the first ``run_pipeline`` call of a process pays once.

    python3 tools/first_call_probe.py [--parent DIR]   # from the repo root

Writes ``chip_smoke.py``'s 623 x 768 x 768 FITS cube once, then for each
case starts a fresh process that does what ``chip_smoke.py``'s pipeline
phase does (loads the kernels' library, reads the file onto the card,
calls ``run_pipeline`` with the phase's beam, SNR threshold and target)
three times: the first and second calls under ``cProfile``, the third
alone.  It prints each call's time and the functions whose host time fell
most from the first call to the second (the one-time costs).  Cases, in
turns (``DIR``, an unpacked ``git archive`` of another commit, runs its
own package):

- ``tree``: the package as it is;
- ``pieces``: ``ops/reductions.SORT_CHUNK`` lowered to 2**27, so the
  cube's order statistics take three pieces and the keyed bisection;
- ``pieces_host_select``: that, with each bisection step read to the
  host;
- ``isfinite``: ``ops/reductions.finite`` replaced by ``torch.isfinite``
  where the mask, the reductions and ``reproject`` call it;
- ``sympy``: ``reductions.valid_mask`` asking ``torch.broadcast_shapes``
  first, as it did before fault F22 was repaired;
- ``profiled``: the package as it is, the first call under
  ``torch.profiler`` (its ten costliest operations by host time);
- ``parent``: ``DIR``'s package, when given.

Builds the kernels' library first (minutes with nvcc) and hands ``DIR``
the built library when its sources are the same.  Needs one card.
"""

import argparse
import cProfile
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def patch(case):
    import torch
    from spectral_cube_tpu_torch import masks
    from spectral_cube_tpu_torch.ops import reductions, regrid
    if case.startswith("pieces"):
        reductions.SORT_CHUNK = 1 << 27
    if case == "isfinite":
        for mod in (masks, reductions, regrid):
            mod.finite = torch.isfinite
    elif case == "sympy":
        valid_mask = reductions.valid_mask

        def asks_torch(data, include=None):
            if include is not None:
                torch.broadcast_shapes(data.shape, include.shape)
            return valid_mask(data, include)
        reductions.valid_mask = asks_torch
    elif case == "pieces_host_select":
        def select(keys, k):
            # the bisection with the range read to the host at every step
            dev = keys[0].device
            lo = min(int(kk[0]) for kk in keys if kk.numel())
            hi = max(int(kk[-1]) for kk in keys if kk.numel())
            while lo < hi:
                mid = (lo + hi) // 2
                q = torch.tensor(mid, dtype=torch.int64, device=dev)
                if int(reductions._count_le(keys, q)) >= k + 1:
                    hi = mid
                else:
                    lo = mid + 1
            return torch.tensor(lo, dtype=torch.int64, device=dev)
        reductions._select = select


def one_time_costs(first, second, n=10):
    """The ``n`` functions whose own host time fell most from the first
    profile to the second: ``(name, first ms, second ms)``."""
    a, b = pstats.Stats(first).stats, pstats.Stats(second).stats
    rows = []
    for key, st in a.items():
        tt2 = b.get(key, (0, 0, 0.0))[2]
        name = f"{os.path.basename(key[0])}:{key[1]}({key[2]})"
        rows.append((st[2] - tt2, name, st[2] * 1e3, tt2 * 1e3))
    rows.sort(reverse=True)
    return [(name, round(t1, 1), round(t2, 1))
            for _, name, t1, t2 in rows[:n]]


def child(tree, case, path):
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.kernels import _build
    assert T.__file__.startswith(tree), T.__file__
    _build.load_library()
    if case != "parent":
        patch(case)
    dev = torch.device("cuda", 0)
    cube = T.SpectralCube.read(path, device=dev)
    torch.cuda.synchronize()
    _, beam = cs.beams()
    target = cs.shifted_header(cube.header, *cs.SHIFT)

    def call():
        T.run_pipeline(cube, snr_threshold=cs.SNR, target_beam=beam,
                       target_header=target)
        torch.cuda.synchronize()

    out = {"case": case, "ms": [], "top": None}
    profiles = []
    for i in range(3):
        prof = None
        if case == "profiled" and i == 0:
            from torch.profiler import profile, ProfilerActivity
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        elif i < 2:
            prof = cProfile.Profile()
        t0 = time.perf_counter()
        if prof is None:
            call()
        else:
            with prof:
                call()
        out["ms"].append(round((time.perf_counter() - t0) * 1e3, 1))
        if isinstance(prof, cProfile.Profile):
            profiles.append(prof)
        elif prof is not None:
            ops = sorted(prof.key_averages(),
                         key=lambda e: -e.self_cpu_time_total)[:10]
            out["ops"] = [(e.key, e.count,
                           round(e.self_cpu_time_total / 1e3, 1))
                          for e in ops]
    if len(profiles) == 2:
        out["top"] = one_time_costs(*profiles)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another commit's unpacked tree")
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(*args.child)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    from spectral_cube_tpu_torch.kernels import _build
    print(f"card: {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"library built in {time.perf_counter() - t0:.1f} s", flush=True)
    cases = [(HERE, c) for c in ("tree", "pieces", "pieces_host_select",
                                 "isfinite", "sympy", "profiled")]
    if args.parent:
        parent = os.path.abspath(args.parent)
        lib = _build._library_path()
        mine = os.path.join(parent, "spectral_cube_tpu_torch", "_build")
        os.makedirs(mine, exist_ok=True)
        shutil.copy(lib, mine)
        cases = [(parent, "parent")] + cases + [(HERE, "tree"),
                                                (parent, "parent")]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cube.fits")
        write_fits(path, [HDU(data=cs.synth_cube(cs.NCHAN, cs.NY, cs.NX,
                                                 cs.SEED),
                              header=cs.synth_header(cs.NCHAN, cs.NY,
                                                     cs.NX))])
        for tree, case in cases:
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--child", tree, case, path],
                                 capture_output=True, text=True)
            line = (run.stdout.strip().splitlines() or [""])[-1]
            print(line if run.returncode == 0 else
                  f"{case}: exit {run.returncode}: {run.stderr[-2000:]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
