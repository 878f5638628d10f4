"""``chip_smoke.py``'s card-scale stages M (the sharded path past 2**31
voxels) and MS (the sharded spectral path and spline reprojections past
2**31 voxels), run on the port of another checkout, each stage's error
printed where it raises one.

    python3 tools/card_sharded_probe.py [--tree DIR] [--files DIR]
        [--part M|MS]

``--tree DIR`` imports ``spectral_cube_tpu_torch`` from DIR (an unpacked
``git archive`` of another commit) instead of this checkout, and builds
its kernels; the stages are this checkout's (``chip_smoke.card_m_run`` on
``chip_smoke.card_m_meshes``: M1, the default mesh of the one card, and
M4, a 2 x 2 mesh of four positions of it), timed and measured by
``chip_smoke.staged_call`` (host clock, synchronised; the peak, and its
rise above the memory in use before it over the cube's bytes), each with
the mesh's counters and the launches its wrappers counted.  Prints the
card's name and power limit, then for each mesh: the read of P's FITS
file onto it, ``run_pipeline(cmesh=)``, the reductions, V (a) (the 4-D
file read, ``to_sharded`` and ``run_pipeline(cmesh=)`` onto a rotated
grid) and a float64 read's ``statistics()`` (M); on the same shards of P,
``chip_smoke.card_ms_stages``: the spectral path's six stages, S's two
reprojections onto 2303 channels and R's two onto the rotated grid (MS),
each kernel's inputs' elements beside its launches.  ``--part`` runs M or
MS alone (default: both; MS alone needs no 4-D file).

``--files DIR`` keeps P's FITS file and V's 4-D file in DIR, made there
(P by ``chip_smoke.card_cube`` at 2304 x 1024 x 1024 on the card) when
they are absent, so that two runs in one call write them once; default:
a temporary directory.  Needs one card and ~19 GiB of disk.
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
    ap.add_argument("--files", default=None)
    ap.add_argument("--part", choices=("M", "MS"), default=None)
    args = ap.parse_args()
    parts = ("M", "MS") if args.part is None else (args.part,)
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    from spectral_cube_tpu_torch.kernels import _build
    if not torch.cuda.is_available():
        print("card_sharded_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}; port {T.__file__}", flush=True)
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_properties(dev).total_memory
    _build.load_library()
    cs.no_tf32()
    with tempfile.TemporaryDirectory() as tmp:
        files = args.files or tmp
        os.makedirs(files, exist_ok=True)
        nchan, ny, nx = cs.CARD_P
        p_path = os.path.join(files, "card_p.fits")
        vr_path = os.path.join(files, "card_v.fits")
        want_vr = "M" in parts
        if not (os.path.exists(p_path)
                and (os.path.exists(vr_path) or not want_vr)):
            host = cs.card_cube(nchan, ny, nx, cs.SEED, dev).cpu().numpy()
            torch.cuda.empty_cache()
            write_fits(p_path, [HDU(data=host, header=cs.synth_header(
                nchan, ny, nx))])
            if want_vr:
                cs.write_vr_fits(vr_path, host, cs.vr_beams(
                    nchan, flagged=cs.VR_FLAGGED))
            del host
        nbytes = nchan * ny * nx * 4
        stages = {}
        names = sorted(set(cs.CARD_KERNELS["M"] + cs.CARD_KERNELS["MS"]))
        for tag, cmesh in cs.card_m_meshes(dev).items():
            cs.log(f"{tag}: {cmesh}")

            def run(name, fn, scale, tag=tag, cmesh=cmesh):
                torch.cuda.empty_cache()
                cmesh.reset_counters()
                K.reset_launch_counts()
                try:
                    with cs.recorded_calls(
                            names, lambda a, kw: a[0].numel()) as sizes:
                        val = cs.staged_call(dev, stages, tag, name,
                                             nbytes * scale, fn)
                except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
                    msg = " ".join(str(err).split())[:300]
                    cs.log(f"  {tag} {name}: FAILED {type(err).__name__}: "
                           f"{msg}")
                    torch.cuda.empty_cache()
                    return None
                launched = {k: (n, sizes[k]) if k in sizes else n
                            for k, n in K.launch_counts().items() if n}
                cs.log(f"  {tag} {name}: peak "
                       f"{stages[f'{tag} {name}'][1] / card:.1%} of the "
                       f"card; counters {dict(cmesh.counters)}; launches "
                       f"{launched}")
                return val
            try:
                cs.card_m_run(cmesh, p_path, vr_path, run, parts=parts)
            except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
                msg = " ".join(str(err).split())[:300]
                cs.log(f"  {tag}: FAILED outside a stage "
                       f"{type(err).__name__}: {msg}")
            torch.cuda.empty_cache()
        cs.log("stages " + ", ".join(
            f"{k} {ms:.1f} ms / {p / 2**30:.2f} GiB / {r:.3f}"
            for k, (ms, p, r) in stages.items())
            + " (time, peak, rise over cube bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
