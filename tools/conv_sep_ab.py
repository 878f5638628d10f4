"""Time two builds of the separable-convolution kernel in turns on one GPU.

    python3 tools/conv_sep_ab.py --baseline OLD.cu [--ptxas]

``OLD.cu`` is another version of ``csrc/conv_sep.cu`` with the same C entry
point (``sct_conv_sep``), for example an earlier commit's, written out with
``git show REV:spectral_cube_tpu_torch/csrc/conv_sep.cu > OLD.cu``.  The
script builds it into a library of its own and the package's kernels as
the package builds them, then on the 623 x 768 x 768 cube of
``chip_smoke.py`` (a Gaussian line on unit noise, NaN outside a circular
primary-beam cutoff) convolves from the 6" x 4.5" beam to 12" (19 taps,
rank 5), clean (NaN set to 0) and with the NaN border, and to 90" (153
taps, rank 3) with the NaN border.  Each case holds both builds against
``conv_sep_plain`` (``chip_smoke.compare_conv``: NaN patterns equal where
den > 1e-5, den-weighted error within 1e-5) and times them with CUDA
events in the order baseline, package, package, baseline.  A build that
refuses a case (the earlier kernel's shared-memory limit) is reported as
such.  ``--ptxas`` prints ``nvcc -Xptxas -v`` for both sources first
(registers, spills, shared memory per kernel).  Prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

#: (label, target beam arcsec, NaN border kept)
CASES = (("12in clean", 12.0, False), ("12in nan", 12.0, True),
         ("90in nan", 90.0, True))


def ptxas(src):
    from spectral_cube_tpu_torch.kernels import _build
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                              "-Xptxas", "-v", "-c", "-o",
                              os.path.join(d, "k.o"), src],
                             capture_output=True, text=True, check=True)
    return out.stderr


def build_baseline(src, workdir):
    from spectral_cube_tpu_torch.kernels import _build
    so = os.path.join(workdir, "libbaseline.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    src], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sct_conv_sep.argtypes = [P, P, P, P, P] + [I] * 8 + [P, P]
    lib.sct_conv_sep.restype = I
    return lib


def launcher(lib, x, ys, xs, hy, hx, gi):
    """A call of ``lib``'s kernel on these inputs; returns (fn, out)."""
    import torch
    from spectral_cube_tpu_torch.kernels._build import ptr, stream_ptr
    nchan, ny, nx = x.shape
    _, r, ly = ys.shape
    flags = torch.empty(nchan, dtype=torch.int32, device=x.device)
    out = torch.empty_like(x)

    def fn():
        err = lib.sct_conv_sep(ptr(x), ptr(ys), ptr(xs), ptr(gi), ptr(flags),
                               nchan, ny, nx, r, ly, xs.shape[2], hy, hx,
                               ptr(out), stream_ptr(x.device))
        if err:
            raise RuntimeError(f"sct_conv_sep: CUDA error {err}")
    return fn, out


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_sep_ab: CUDA is not available", file=sys.stderr)
        return 1
    from spectral_cube_tpu_torch.kernels import _build
    from spectral_cube_tpu_torch.kernels import conv_sep as kc
    from spectral_cube_tpu_torch.ops import convolve as oc
    import spectral_cube_tpu_torch as T
    cs.log(f"card: {cs.card_line()}")
    new_src = str(_build.CSRC / "conv_sep.cu")
    if args.ptxas:
        for name, src in (("baseline", args.baseline), ("package", new_src)):
            cs.log(f"ptxas, {name} ({src}):\n{ptxas(src)}")
    cs.no_tf32()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as workdir:
        base = build_baseline(args.baseline, workdir)
        pkg = _build.load_library()
        data = torch.as_tensor(cs.synth_cube(cs.NCHAN, cs.NY, cs.NX, cs.SEED),
                               device=dev)
        cube_beam, _ = cs.beams()
        pix = np.radians(cs.PIX_ARCSEC / 3600.0)
        gi = torch.zeros(cs.NCHAN, dtype=torch.int32, device=dev)
        for label, target, nan in CASES:
            tb = T.Beam(T.Quantity(target, "arcsec"),
                        T.Quantity(target, "arcsec"), T.Quantity(0, "deg"))
            kern = tb.deconvolve(cube_beam).as_kernel(pix)
            yt, xt = oc.separable_factors(kern)
            ys, hy = oc._tap_stack([yt])
            xs, hx = oc._tap_stack([xt])
            ys = torch.as_tensor(ys, device=dev)
            xs = torch.as_tensor(xs, device=dev)
            x = data if nan else torch.nan_to_num(data, nan=0.0)
            want = kc.conv_sep_plain(x, ys, xs, hy, hx, gi)
            fns = {}
            for name, lib in (("baseline", base), ("package", pkg)):
                fn, out = launcher(lib, x, ys, xs, hy, hx, gi)
                try:
                    fn()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    cs.log(f"  {label} {name}: refused ({e})")
                    continue
                cs.compare_conv(f"{label} {name} vs plain", out, want, x, ys,
                                xs, hy, hx, 1e-5)
                fns[name] = fn
            del want
            times = {name: [] for name in fns}
            for name in ("baseline", "package", "package", "baseline"):
                if name in fns:
                    times[name].append(cs.cuda_ms(fns[name], 5))
            nb, flops = 2 * x.numel() * 4, 2 * ys.shape[1] * (
                ys.shape[2] + xs.shape[2]) * x.numel()
            bms, by = cs.bound(nb, flops)
            cs.log(f"  {label}: kernel {kern.shape[0]}x{kern.shape[1]} rank "
                   f"{ys.shape[1]}; ms in turns "
                   + "; ".join(f"{k} {v}" for k, v in times.items())
                   + f"; bound {bms:.3f} ms ({by})")
            del x
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
