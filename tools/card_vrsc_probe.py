"""``chip_smoke.py``'s card-scale stages of the varying-resolution path,
of the reprojection onto a new spectral axis and of a float64 cube's
``statistics()``, run on the port of another checkout, each stage's error
printed where it raises one.

    python3 tools/card_vrsc_probe.py [--tree DIR]

``--tree DIR`` imports ``spectral_cube_tpu_torch`` from DIR (an unpacked
``git archive`` of another commit) instead of this checkout, and builds
its kernels; the stages are this checkout's (``chip_smoke.card_vr_cube``,
``card_vr_stages``, ``card_vr_grouped``, ``card_s_stages``,
``card_f64_cube``), timed and measured by ``chip_smoke.staged_call``
(host clock, synchronised; the peak, and its rise above the memory in
use before it over the cube's bytes).  Prints the card's name and power
limit, then on P (``chip_smoke.card_cube`` at 2304 x 1024 x 1024):

1. V (a): P written as a 4-D FITS file with a BEAMS table and read back,
   ``run_pipeline`` onto the grid rotated by ``VR_ROTATION``, then its
   stages one by one;
2. V (b): ``convolve_to`` a 12" beam from PA-0 beams in 4-channel groups;
3. S: ``reproject`` onto a new spectral axis, bilinear and bicubic;
4. ``statistics()`` of a float64 copy of P (18 GiB).

Needs one card and ~10 GiB of disk for the FITS file.
"""

import argparse
import importlib.util
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import _build
    from spectral_cube_tpu_torch.ops import convolve as oc
    if not torch.cuda.is_available():
        print("card_vrsc_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}; port {T.__file__}", flush=True)
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_properties(dev).total_memory
    _build.load_library()
    cs.no_tf32()
    stages = {}

    def attempt(tag, name, fn):
        torch.cuda.empty_cache()
        try:
            return fn()
        except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
            msg = " ".join(str(err).split())[:300]
            cs.log(f"  {tag} {name}: FAILED {type(err).__name__}: {msg}")
            return None
        finally:
            torch.cuda.empty_cache()

    def staged(tag, nbytes):
        def run(name, fn):
            K.reset_launch_counts()
            oc.convolve_cube_to_beam.last = {}
            val = cs.staged_call(dev, stages, tag, name, nbytes, fn)
            route = oc.convolve_cube_to_beam.last
            launched = {k: n for k, n in K.launch_counts().items() if n}
            cs.log(f"  {tag} {name}: peak "
                   f"{stages[f'{tag} {name}'][1] / card:.1%} of the card; "
                   f"launches {launched}"
                   + (f"; route {route['route']}, {route['groups']} beam "
                      "groups" if route else ""))
            return val
        return run

    nchan, ny, nx = cs.CARD_P
    data = cs.card_cube(nchan, ny, nx, cs.SEED, dev)
    nbytes = data.numel() * 4
    host = data.cpu().numpy()
    del data
    with tempfile.TemporaryDirectory() as workdir:
        cube, wrote, read = cs.card_vr_cube(host, workdir)
    del host
    cs.log(f"V {cube}: written {wrote:.2f} s, read {read:.2f} s")
    target = cs.rotated_header(cube.header, cs.VR_ROTATION)
    run = staged("V", nbytes)
    attempt("V", "run_pipeline", lambda: run("run_pipeline", lambda: (
        T.run_pipeline(cube, snr_threshold=cs.SNR, target_header=target),
        None)[1]))
    attempt("V", "stages", lambda: (
        cs.card_vr_stages(cube, target, run), None)[1])
    _, target_beam = cs.beams()
    grouped = cs.card_vr_grouped(cube)
    attempt("V", "convolve_to (b)", lambda: (run(
        "convolve_to (b)", lambda: grouped.convolve_to(target_beam)),
        None)[1])
    data = cube._data
    del grouped, cube
    h = cs.synth_header(nchan, ny, nx)
    wcs = T.WCS(header=h)
    cube = T.SpectralCube(data, wcs, header=h,
                          mask=T.LazyMask(torch.isfinite, data=data, wcs=wcs))
    run = staged("S", nbytes)
    for name, call, _ in cs.card_s_stages(cube):
        attempt("S", name, lambda: (run(name, lambda: call(cube)), None)[1])
    f64 = cs.card_f64_cube(cube)
    run = staged("F", 2 * nbytes)
    attempt("F", "statistics float64", lambda: (
        run("statistics float64", f64.statistics), None)[1])
    cs.log("stages " + ", ".join(
        f"{k} {ms:.1f} ms / {p / 2**30:.2f} GiB / {r:.3f}"
        for k, (ms, p, r) in stages.items())
        + " (time, peak, rise over cube bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
