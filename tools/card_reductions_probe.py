"""``chip_smoke.py``'s card-scale stages of the cube's other reductions and
of the spectral path, run on the port of another checkout, each stage's
error printed where it raises one.

    python3 tools/card_reductions_probe.py [--tree DIR] [--kernels]

``--tree DIR`` imports ``spectral_cube_tpu_torch`` from DIR (an unpacked
``git archive`` of another commit) instead of this checkout; the stages
are this checkout's (``chip_smoke.CARD_ALONG``, ``CARD_WHOLE`` and
``card_spectral_stages``), timed and measured by ``chip_smoke.staged_call``
(host clock, synchronised; the peak, and its rise above the memory in use
before it over the cube's bytes).  Prints the card's name and power
limit, then:

1. H, ``chip_smoke.headline_cube`` at 1280 x 2048 x 2048 under ``> 0.25``:
   every reduction of ``CARD_ALONG`` and ``CARD_WHOLE``.
2. P, ``chip_smoke.card_cube`` at 2304 x 1024 x 1024 under the finiteness
   mask a read gives: the spectral stages that launch no kernel, and with
   ``--kernels`` (which builds the kernels) also those that do.

Needs one card.
"""

import argparse
import importlib.util
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.masks import LazyMask
    from spectral_cube_tpu_torch.wcs import WCS
    if not torch.cuda.is_available():
        print("card_reductions_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}; port {T.__file__}", flush=True)
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_properties(dev).total_memory
    if args.kernels:
        from spectral_cube_tpu_torch.kernels import _build
        _build.load_library()
    cs.no_tf32()
    stages = {}

    def attempt(tag, name, nbytes, fn):
        torch.cuda.empty_cache()
        try:
            cs.staged_call(dev, stages, tag, name, nbytes, fn)
        except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
            msg = " ".join(str(err).split())[:300]
            cs.log(f"  {tag} {name}: FAILED {type(err).__name__}: {msg}")
            return
        cs.log(f"  {tag} {name}: peak {stages[f'{tag} {name}'][1] / card:.1%}"
               " of the card")

    nchan, ny, nx = cs.CARD_H
    data = cs.headline_cube(nchan, ny, nx, cs.SEED, dev)
    h = cs.synth_header(nchan, ny, nx)
    cube = T.SpectralCube(data, WCS(header=h), header=h)
    masked = cube.with_mask(cube > T.Quantity(cs.CARD_H_THRESHOLD,
                                              cube.unit))
    cs.log(f"H {nchan}x{ny}x{nx}:")
    for name, fn in {**cs.CARD_ALONG, **cs.CARD_WHOLE}.items():
        attempt("H", name, data.numel() * 4, lambda: fn(masked))
    del masked, cube, data

    nchan, ny, nx = cs.CARD_P
    data = cs.card_cube(nchan, ny, nx, cs.SEED, dev)
    h = cs.synth_header(nchan, ny, nx)
    wcs = WCS(header=h)
    cube = T.SpectralCube(data, wcs, header=h,
                          mask=LazyMask(torch.isfinite, data=data, wcs=wcs))
    cs.log(f"P {nchan}x{ny}x{nx}:")
    for name, call, kernel in cs.card_spectral_stages(cube):
        if kernel is None or args.kernels:
            attempt("P", name, data.numel() * 4, lambda: call(cube))
    return 0


if __name__ == "__main__":
    sys.exit(main())
