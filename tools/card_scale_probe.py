"""What a device sort allows past 2**31 elements, and what the whole-cube
``mad_std`` takes in one sort and in pieces of three sizes.

    python3 tools/card_scale_probe.py      # from the repository root

Prints the card's name and power limit and the host's memory, then:

1. ``torch.sort`` of a 1-D uint8 tensor of 2**31 + 64 elements, and a
   boolean index of a 1-D float32 tensor of that length by a mask with
   64 true entries: each call's result or the error it raises.
2. The peak above the memory allocated before it of ``torch.sort`` and
   of ``ops/reductions._sorted_keys`` on ``SORT_PIECE`` float32 values,
   in bytes a value.
3. On ``chip_smoke.card_cube`` at 2304 x 1024 x 1024 (P) and on
   ``chip_smoke.headline_cube`` at 1280 x 2048 x 2048 under ``> 0.25``
   (H): ``ops/reductions.masked_mad_std`` with ``SORT_PIECE`` 2**27,
   2**28 and 2**29, two calls each (host-clock time, synchronised; the
   peak above the cube and its validity mask over the cube's bytes),
   then ``chip_smoke.one_sort_mad_std``, the one-sort form, with its
   peak or the error it raises; every value printed.

Needs one card and no kernel build: nothing here launches the port's
kernels.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from spectral_cube_tpu_torch.ops import reductions as rd  # noqa: E402

GiB = 2 ** 30


def attempt(name, fn, nbytes=None):
    """Run ``fn`` synchronised; print its time and its peak above the
    memory allocated before it (over ``nbytes`` too), or the error it
    raised.  Returns ``(result, peak)`` or None."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
        msg = " ".join(str(err).split())[:400]
        print(f"  {name}: {type(err).__name__}: {msg}", flush=True)
        torch.cuda.empty_cache()
        return None
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    rise = "" if nbytes is None else f" ({peak / nbytes:.3f} cube bytes)"
    print(f"  {name}: {ms:.1f} ms, peak above the resident "
          f"{peak / GiB:.2f} GiB{rise}", flush=True)
    return out, peak


def limits(dev):
    n = 2 ** 31 + 64
    x = torch.randint(0, 250, (n,), dtype=torch.uint8, device=dev)
    attempt(f"torch.sort of {n} uint8", lambda: torch.sort(x).values[-1])
    del x
    x = torch.zeros(n, dtype=torch.float32, device=dev)
    m = torch.zeros(n, dtype=torch.bool, device=dev)
    m[::n // 64] = True
    got = attempt(f"boolean index of {n} float32", lambda: x[m].numel())
    if got is not None:
        print(f"    picked {int(got[0])} values", flush=True)
    n = rd.SORT_PIECE
    x = torch.randn(n, device=dev)
    for name, fn in (("torch.sort", lambda: torch.sort(x)),
                     ("_sorted_keys", lambda: rd._sorted_keys(x))):
        got = attempt(f"{name} of {n} float32", fn)
        if got is not None:
            print(f"    {got[1] / n:.1f} bytes a value", flush=True)


def cube_case(tag, data, valid):
    nbytes = data.numel() * data.element_size()
    print(f"{tag}: {tuple(data.shape)}, {data.numel()} voxels, "
          f"{nbytes / GiB:.2f} GiB, {int(valid.sum())} valid", flush=True)
    keep = rd.SORT_PIECE
    try:
        for log2 in (27, 28, 29):
            rd.SORT_PIECE = 1 << log2
            for call in (1, 2):
                got = attempt(f"masked_mad_std in pieces of 2**{log2}, "
                              f"call {call}",
                              lambda: float(rd.masked_mad_std(data, valid)),
                              nbytes)
            if got is not None:
                print(f"    value {got[0]!r}", flush=True)
    finally:
        rd.SORT_PIECE = keep
    got = attempt("one_sort_mad_std", lambda: float(cs.one_sort_mad_std(
        data, valid)), nbytes)
    if got is not None:
        print(f"    value {got[0]!r}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("card_scale_probe: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; device memory "
          f"{torch.cuda.get_device_properties(0).total_memory / GiB:.2f} "
          f"GiB; host memory {cs.host_memory_line()}", flush=True)
    limits(dev)
    data = cs.card_cube(*cs.CARD_P, cs.SEED, dev)
    cube_case("P", data, rd.finite(data))
    del data
    torch.cuda.empty_cache()
    data = cs.headline_cube(*cs.CARD_H, cs.SEED, dev)
    cube_case("H", data, rd.finite(data) & (data > cs.CARD_H_THRESHOLD))
    return 0


if __name__ == "__main__":
    sys.exit(main())
