"""Time a ShardedCube's region cut and ``flattened`` on one GPU, at the
piece sizes the mask is evaluated in, and profile the cut.

    python3 tools/sharded_cut_probe.py      # from the repository root

Builds ``chip_smoke.py``'s 623 x 768 x 768 cube on the card, shards it
over a 2 x 2 mesh of that card under the read's finiteness mask and a
3-sigma threshold, then for pieces of 4, 8 and 16 Mi voxels
(``parallel.sharded._CHUNK_VOXELS``) prints the best of three host-clock
times of a DS9 circle cut (radius 40 px where the four shards meet) and
of ``flattened()``, and the cut's peak above the memory allocated before
it.  Then one cut at the default piece size under ``torch.profiler``
(host and device time by operation) and under ``cProfile`` (host time
by Python function).  Prints the card's name and power limit first;
needs no kernel build (the cut and ``flattened`` launch none of the
port's kernels).
"""

import cProfile
import os
import pstats
import sys
import time
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import spectral_cube_tpu_torch as T  # noqa: E402
from spectral_cube_tpu_torch.parallel import sharded as tsh  # noqa: E402

REGION = "image; circle(384.5, 384.5, 40)"
PIECES = (1 << 22, 1 << 23, 1 << 24)


def best_ms(fn, n=3):
    """The best of ``n`` host-clock times of ``fn``, synchronised."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return min(times)


def main():
    if not torch.cuda.is_available():
        print("sharded_cut_probe: CUDA is not available", file=sys.stderr)
        return 1
    warnings.simplefilter("ignore")
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    h = cs.synth_header(cs.NCHAN, cs.NY, cs.NX)
    cube = T.SpectralCube(data=cs.synth_cube(cs.NCHAN, cs.NY, cs.NX,
                                             cs.SEED),
                          wcs=T.WCS(header=h), header=h, device=dev)
    cube = cube.with_mask(T.LazyMask(torch.isfinite, shape=cube.shape))
    cmesh = T.CubeMesh(devices=[dev] * 4, shape=(2, 2))
    sc = T.ShardedCube(cube, cmesh)
    fs = sc.with_mask(sc > T.Quantity(3.0, sc.unit))
    fs.allow_huge_operations = True
    default = tsh._CHUNK_VOXELS
    try:
        for piece in PIECES:
            tsh._CHUNK_VOXELS = piece
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fs.subcube_from_ds9region(REGION)
            rise = (torch.cuda.max_memory_allocated() - base) / 2**20
            cut = best_ms(lambda: fs.subcube_from_ds9region(REGION))
            flat = best_ms(fs.flattened)
            print(f"pieces of {piece} voxels: region cut {cut:.1f} ms, "
                  f"peak above the resident cubes {rise:.1f} MiB; "
                  f"flattened {flat:.1f} ms", flush=True)
    finally:
        tsh._CHUNK_VOXELS = default
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fs.subcube_from_ds9region(REGION)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=25))
    pr = cProfile.Profile()
    pr.enable()
    fs.subcube_from_ds9region(REGION)
    torch.cuda.synchronize()
    pr.disable()
    pstats.Stats(pr).sort_stats("cumulative").print_stats(25)
    return 0


if __name__ == "__main__":
    sys.exit(main())
