"""``chip_smoke.py``'s card-scale stages R (rotated spline reprojection) and
C (the fused convolve + reproject kernels #8-#10), run on the port of
another checkout, each stage's error printed where it raises one.

    python3 tools/card_rotated_fused_probe.py [--tree DIR]

``--tree DIR`` imports ``spectral_cube_tpu_torch`` from DIR (an unpacked
``git archive`` of another commit) instead of this checkout, and builds
its kernels; the stages are this checkout's (``chip_smoke.card_r_stages``,
``card_c_stages``), timed and measured by ``chip_smoke.staged_call`` (host
clock, synchronised; the peak, and its rise above the memory in use
before it over the cube's bytes), each with the launches its wrappers
counted and, for C, the route.  Prints the card's name and power limit,
then on P (``chip_smoke.card_cube`` at 2304 x 1024 x 1024, made on the
card, under a finiteness mask):

1. R: ``reproject`` onto the grid rotated by ``VR_ROTATION``, biquadratic
   with P's own spectral axis and bicubic onto 2303 channels;
2. R's parts on one slab of the path (``ops/regrid._slabs``) of the
   biquadratic call, CUDA-event medians: the host maps and taps, one
   prefilter (``spline_coefficients``), the 9 tap gathers as the path runs
   them (``spline_gathers``) and the same gathers with their weights
   already on the card;
3. C on (a) bench config 5's clean synthesis at P's shape and on (b) P:
   ``convolve_reproject_separable``, ``plain_strips`` (a) and
   ``moments_conv_reproject_fused``.

Needs one card; no disk.
"""

import argparse
import importlib.util
import os
import sys
import time

import numpy as np
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
    from spectral_cube_tpu_torch.ops import regrid as og
    if not torch.cuda.is_available():
        print("card_rotated_fused_probe: CUDA is not available",
              file=sys.stderr)
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

    def run(tag, name, nbytes, fn):
        K.reset_launch_counts()
        og.convolve_reproject_separable.last = {}
        val = cs.staged_call(dev, stages, tag, name, nbytes, fn)
        route = og.convolve_reproject_separable.last
        launched = {k: n for k, n in K.launch_counts().items() if n}
        cs.log(f"  {tag} {name}: peak "
               f"{stages[f'{tag} {name}'][1] / card:.1%} of the card; "
               f"launches {launched}"
               + (f"; route {route['route']}" if route else "")
               + ("; returned None" if val is None else ""))
        return val

    nchan, ny, nx = cs.CARD_P
    data = cs.card_cube(nchan, ny, nx, cs.SEED, dev)
    nbytes = data.numel() * 4
    h = cs.synth_header(nchan, ny, nx)
    wcs = T.WCS(header=h)
    cube = T.SpectralCube(data, wcs, header=h,
                          mask=T.LazyMask(torch.isfinite, data=data, wcs=wcs))
    r_stages = cs.card_r_stages(cube)
    for name, call, _, _, _ in r_stages:
        attempt("R", name, lambda: (run("R", name, nbytes,
                                        lambda: call(cube)), None)[1])

    def parts():
        target = r_stages[0][4]
        t = time.perf_counter()
        zs, ys, xs, _ = og.reproject_mappings(
            cube.wcs, target, nchan,
            spectral_values_in=np.asarray(cube.spectral_axis.value))
        m = og.spline_host_maps(zs, ys, xs, nchan, ny, nx)
        maps = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        plan = og.spline_taps(m.ycl, m.xcl, 2, ny, nx, dev)
        torch.cuda.synchronize()
        taps = (time.perf_counter() - t) * 1e3
        slabs = og._slabs(nchan, ny * nx)
        k0, k1 = slabs[len(slabs) // 2]
        src = torch.nan_to_num(cube._get_filled_data((slice(k0, k1),),
                                                     fill=np.nan))
        coef = cs.cuda_ms(lambda: og.spline_coefficients(src, plan, False),
                          3)
        flat = og.spline_coefficients(src, plan, False)
        path = cs.cuda_ms(lambda: og.spline_gathers(flat, plan, False), 3)
        weights = [torch.as_tensor(w, device=dev)[:, None]
                   for _, w in plan.taps]

        def on_card():
            acc = torch.zeros((plan.taps[0][0].shape[0], flat.shape[1]),
                              device=dev)
            part = torch.empty_like(acc)
            for (idx, _), w in zip(plan.taps, weights):
                torch.index_select(flat, 0, idx, out=part)
                acc.addcmul_(part, w)
            return acc
        card_w = cs.cuda_ms(on_card, 3)
        cs.log(f"  R biquadratic parts: host maps {maps:.1f} ms, taps "
               f"{taps:.1f} ms; on output channels {k0}-{k1 - 1} (one of "
               f"{len(slabs)} slabs, each prefiltered and gathered twice): "
               f"spline_coefficients {coef:.3f} ms, spline_gathers "
               f"{path:.3f} ms, the same gathers with the weights on the "
               f"card {card_w:.3f} ms")
    attempt("R", "parts", parts)
    c_stages = cs.card_c_stages(cs.card_c_operators(cube.shape))
    for label in ("a", "b"):
        x = cs.synth_config5(nchan, ny, nx, cs.SEED + 7, dev) \
            if label == "a" else data
        for name, call, kernel in c_stages:
            if label == "b" and kernel == "plain_strips":
                continue
            tag = f"{name} ({label})"
            attempt("C", tag, lambda: (run("C", tag, nbytes,
                                           lambda: call(x)), None)[1])
        del x
    cs.log("stages " + ", ".join(
        f"{k} {ms:.1f} ms / {p / 2**30:.2f} GiB / {r:.3f}"
        for k, (ms, p, r) in stages.items())
        + " (time, peak, rise over cube bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
