"""Digests of the sharded path's results on the CPU, to hold one commit's
port bit for bit against another's.

    python3 tools/sharded_bits.py [--tree DIR] [--virtual]

``--tree DIR`` imports ``spectral_cube_tpu_torch`` from DIR (an unpacked
``git archive`` of another commit) instead of this checkout.  On 2x4,
2x2 and 1x2 meshes of the host (``["cpu"] * n``; with ``--virtual`` of
distinct virtual devices, ``tests/torch_vdev.py``) it runs a small cube
(``chip_smoke.synth_cube``, a NaN border, 24 x 40 x 48) through
``run_pipeline(cmesh=)`` onto a shifted and a rotated grid, the sharded
reductions along every axis, a tuple and the whole cube, the moments,
``statistics()``, the spectral path, the spatial smoothing, the spline
and bilinear reprojections, the cuts and indexers, ``flattened`` and the
apply functions, and prints one line per call: its name and the SHA-256
of its host values' bytes (with their shapes and dtypes) and of the
mesh's counters.  Two trees' outputs are equal line for line exactly
when every result and every counter is.
"""

import argparse
import hashlib
import os
import sys
import tempfile
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (24, 40, 48)


def digest(val):
    """SHA-256 of a result's host values (arrays, numbers, dicts, tuples,
    Quantities, cubes) in a fixed order."""
    import torch
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                h.update(str(k).encode())
                walk(v[k])
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif hasattr(v, "_data") and hasattr(v, "cmesh"):       # ShardedCube
            walk(v.cube._get_filled_data(fill=np.nan))
        elif hasattr(v, "_get_filled_data"):                   # a cube
            walk(v._get_filled_data(fill=np.nan))
        elif hasattr(v, "blocks") and hasattr(v, "gather"):    # ShardedArray
            walk(v.gather(torch.device("cpu")))
        elif isinstance(v, torch.Tensor):
            walk(v.detach().cpu().numpy())
        elif hasattr(v, "value") and hasattr(v, "unit"):       # Quantity
            h.update(str(v.unit).encode())
            walk(np.asarray(v.value))
        else:
            a = np.asarray(v)
            h.update(f"{a.shape}{a.dtype}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    walk(val)
    return h.hexdigest()[:20]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--virtual", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    sys.path.insert(1, ROOT)
    sys.path.insert(2, os.path.join(ROOT, "tests"))
    warnings.simplefilter("ignore")
    import chip_smoke as cs
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.io import streaming
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    print(f"port {T.__file__}")
    nchan, ny, nx = SHAPE
    data = cs.synth_cube(nchan, ny, nx, cs.SEED)
    data[:, :2, :] = np.nan
    _, beam = cs.beams()
    kernel = np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cube.fits")
        write_fits(path, [HDU(data=data, header=cs.synth_header(nchan, ny,
                                                                nx))])
        for grid in ((2, 4), (2, 2), (1, 2)):
            n = grid[0] * grid[1]
            if args.virtual:
                from torch_vdev import vdev, virtual_devices
                devices, mode = [vdev(k) for k in range(1, n + 1)], \
                    virtual_devices()
            else:
                import contextlib
                devices, mode = ["cpu"] * n, contextlib.nullcontext()
            with mode:
                cmesh = T.CubeMesh(devices=devices, shape=grid)
                sc = streaming.read_sharded_cube(path, cmesh)
                masked = sc.with_mask(sc > T.Quantity(0.5, sc.unit))
                shifted = cs.shifted_header(sc.header, *cs.SHIFT)
                rotated = cs.rotated_header(sc.header, 3.0)
                calls = {
                    "run_pipeline shifted": lambda: T.run_pipeline(
                        sc, cmesh, snr_threshold=cs.SNR, target_beam=beam,
                        target_header=shifted),
                    "run_pipeline rotated": lambda: T.run_pipeline(
                        sc, cmesh, snr_threshold=cs.SNR, target_beam=beam,
                        target_header=rotated),
                    "moment_maps": masked.moment_maps,
                    "moment3": lambda: masked.moment(order=3),
                    "moment1 axis 2": lambda: masked.moment(order=1, axis=2),
                    "statistics": masked.statistics,
                    "argmax": masked.argmax,
                    "argmin axis 1": lambda: masked.argmin(axis=1),
                    "argmax_world": masked.argmax_world,
                    "spectral_smooth": lambda: masked.spectral_smooth(
                        np.array([0.25, 0.5, 0.25])),
                    "spectral_interpolate smoothed": lambda: masked
                    .spectral_interpolate(sc.spectral_axis[::2],
                                          smooth_kernel=np.array(
                                              [0.25, 0.5, 0.25])),
                    "sigma_clip_spectrally": lambda: sc
                    .sigma_clip_spectrally(3.0),
                    "spatial_smooth": lambda: sc.spatial_smooth(kernel),
                    "spatial_smooth_median": lambda: sc
                    .spatial_smooth_median(3, raise_error_jybm=False),
                    "downsample_axis": lambda: masked.downsample_axis(2, 1),
                    "reproject bicubic": lambda: sc.reproject(
                        shifted, order="bicubic"),
                    "reproject biquadratic rotated": lambda: sc.reproject(
                        rotated, order="biquadratic"),
                    "reproject nearest rotated": lambda: sc.reproject(
                        rotated, order="nearest-neighbor"),
                    "minimal_subcube": lambda: masked.minimal_subcube(),
                    "subcube": lambda: sc.subcube(xlo=5, xhi=30, ylo=7,
                                                  yhi=33, zlo=2, zhi=20),
                    "filled_data box": lambda: masked.filled_data[
                        3:17, 5:33, ::-3],
                    "flattened": lambda: masked.flattened(),
                    "apply spectral": lambda: sc
                    .apply_function_parallel_spectral(lambda s: s * 2),
                    "apply spatial": lambda: sc
                    .apply_function_parallel_spatial(lambda s: s + 1),
                    "to K": lambda: sc.to("K"),
                }
                for name in ("sum", "mean", "std", "max", "min", "median",
                             "mad_std"):
                    for axis in (None, 0, 1, 2, (1, 2), (0, 1), (0, 2)):
                        calls[f"{name} axis {axis}"] = (
                            lambda name=name, axis=axis: getattr(
                                masked, name)(axis=axis))
                calls["percentile 10 axis (0, 1)"] = lambda: \
                    masked.percentile(10, axis=(0, 1))
                for name, fn in calls.items():
                    cmesh.reset_counters()
                    val = fn()
                    print(f"{grid} {name}: {digest(val)} counters "
                          f"{digest(sorted(cmesh.counters.items()))}",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
