"""A reckoning on the CPU, before a card run, of each card-scale stage's
rise: the peak of the bytes a stage allocates and holds at once, over the
cube's bytes.

    python3 tools/ms_rise_reckoning.py [--tree DIR] [--shape C,Y,X]
        [--mesh unsharded,M1,M4] [--only TEXT]

Runs ``chip_smoke.card_ms_stages`` (the spectral path's, S's and R's
stages) on a cube of P's kind (``chip_smoke.card_cube``, written as FITS
and read back) of ``--shape`` (default 288 x 24 x 24) on the CPU: the
unsharded cube, and its shards on a mesh of one position (M1) and on a
2 x 2 mesh (M4) read by ``io.streaming.read_sharded_cube``.  The piece
sizes (``ops/regrid.SLAB_VOXELS``, ``ops/reductions.SORT_CHUNK``,
``SORT_PIECE``, ``SUM_CHUNK``, ``parallel.sharded._CHUNK_VOXELS``) are
scaled by the cube's voxels over P's, so that a slab, piece or tile is
the same share of the cube as at P.  Each kernel's plain version counts
as its output alone (the card's kernel allocates nothing else).  The
allocations come from the CPU profiler (``profile_memory``), in time
order; host numpy arrays are not counted.  ``--tree DIR`` imports the
port from DIR (an unpacked ``git archive`` of another commit).  A
reckoning, not a measurement: the card's caching allocator and its
libraries' workspaces are not in it.
"""

import argparse
import functools
import importlib
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN = "plain version"


def plain_outputs(kernel_modules, sizes):
    """Wrap every ``*_plain`` function of ``kernel_modules`` in a profiler
    range named PLAIN, its output's bytes appended to ``sizes``."""
    import torch
    from torch.profiler import record_function
    for mod in kernel_modules:
        for attr, fn in list(vars(mod).items()):
            if not (attr.endswith("_plain") and callable(fn)):
                continue

            def wrap(*a, _fn=fn, **kw):
                with record_function(PLAIN):
                    out = _fn(*a, **kw)
                    outs = out if isinstance(out, (tuple, list)) else [out]
                    sizes.append(sum(o.numel() * o.element_size()
                                     for o in outs
                                     if isinstance(o, torch.Tensor)))
                return out
            setattr(mod, attr, functools.wraps(fn)(wrap))


def peak_bytes(fn, sizes):
    """``(fn(), the peak of its live allocations)``: each event's own
    allocations and frees in time order, a plain version's replaced by
    its output's bytes."""
    from torch.profiler import profile, ProfilerActivity
    del sizes[:]
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        val = fn()
    events = list(prof.events())
    plains = sorted((e.time_range.start, e.time_range.end)
                    for e in events if e.name == PLAIN)
    items = [(e.time_range.start, e.self_cpu_memory_usage) for e in events
             if e.self_cpu_memory_usage and e.name != PLAIN
             and not any(a <= e.time_range.start <= b for a, b in plains)]
    items += [(a, n) for (a, _), n in zip(plains, sizes)]
    live = peak = 0
    for _, n in sorted(items):
        live += n
        peak = max(peak, live)
    return val, peak


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--shape", default="288,24,24")
    ap.add_argument("--mesh", default="unsharded,M1,M4")
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.io import streaming
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    from spectral_cube_tpu_torch.ops import reductions as rd
    from spectral_cube_tpu_torch.ops import regrid as og
    from spectral_cube_tpu_torch.parallel import sharded as tsh
    shape = tuple(int(n) for n in args.shape.split(","))
    share = np.prod(shape) / np.prod(cs.CARD_P)
    og.SLAB_VOXELS = max(1, int(2 ** 27 * share))
    rd.SORT_CHUNK = max(1, int(2 ** 29 * share))
    rd.SORT_PIECE = max(1, int(2 ** 27 * share))
    rd.SUM_CHUNK = max(1, int(2 ** 24 * share))
    tsh._CHUNK_VOXELS = max(1, int(2 ** 22 * share))
    sizes = []
    plain_outputs([importlib.import_module(
        f"spectral_cube_tpu_torch.kernels.{k}") for k in (
            "moments", "conv_sep", "resample2", "sigma_clip",
            "smooth_interp", "banded_matmul")], sizes)
    print(f"port {T.__file__}; {shape}, piece sizes scaled by {share:.3g}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        data = cs.card_cube(*shape, cs.SEED, torch.device("cpu")).numpy()
        path = os.path.join(tmp, "p.fits")
        write_fits(path, [HDU(data=data, header=cs.synth_header(*shape))])
        cube = T.SpectralCube.read(path, device="cpu")
        meshes = {"unsharded": None, "M1": T.CubeMesh(devices=["cpu"]),
                  "M4": T.CubeMesh(devices=["cpu"] * 4, shape=(2, 2))}
        for tag in args.mesh.split(","):
            cmesh = meshes[tag]
            c = cube if cmesh is None \
                else streaming.read_sharded_cube(path, cmesh)
            for name, call, _ in cs.card_ms_stages(c):
                if args.only and args.only not in name:
                    continue
                if cmesh is not None:
                    cmesh.reset_counters()
                val, peak = peak_bytes(lambda: call(c), sizes)
                del val
                counters = "" if cmesh is None else f"; {cmesh.counters}"
                print(f"{tag} {name}: rise {peak / data.nbytes:.3f}"
                      f"{counters}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
