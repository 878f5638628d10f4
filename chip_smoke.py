"""Smoke run of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; one GPU

1. Requires CUDA (exits non-zero without it) and prints the card and its
   power limit.
2. Builds the CUDA kernels from ``spectral_cube_tpu_torch/csrc/`` (one
   ``nvcc`` per source, all at once).
3. Writes a 623 x 768 x 768 cube (a Gaussian line on noise with a NaN
   border, an elliptical rotated beam) to FITS, reads it onto the card and
   runs ``run_pipeline`` (convolve to a larger beam, SNR mask, moments and
   statistics, reproject onto a CRPIX-shifted grid) with every launch
   counter at 0 before and the path's kernels > 0 after; then checks each
   stage against the plain functions on the card.
4. Writes a second 623 x 768 x 768 cube (the same kind, plus NaN holes
   inside spectra), reads it with no device argument (the default is the
   card) and runs the spectral path: ``spectral_smooth`` (17-tap
   Gaussian), ``spectral_interpolate`` onto every second channel with the
   same smooth kernel (312 channels), ``sigma_clip_spectrally(1.0)``, with
   the counters at 0 before and the smooth_interp and sigma_clip counts > 0
   after; checks each stage against the plain functions on the card.
5. Reads that second cube again with no device argument and reprojects it
   onto a target with 311 channels at twice the channel width, starting a
   quarter channel in, on a grid shifted by (0.37, -0.61) pixel
   (``cube.reproject``: spectral lerp, then the filled resample), with the
   counters at 0 before and the resample2_filled count > 0 after.
6. Runs the fused convolve + reproject on two 623 x 768 x 768 cubes, bench
   config 5's clean synthesis and the pipeline's NaN-bordered cube, with
   the pipeline's common-beam kernel and axis maps shifted by (0.37, -0.61)
   pixel (bench config 5's form):
   ``convolve_reproject_separable``, the clean branch on its own
   (``plain_strips``) and ``moments_conv_reproject_fused`` with bench
   config 5's data-local mask (> 0.25), counters at 0 before and the
   conv_reproject, plain_strips and pipeline_fused counts > 0 after; holds
   the fused op against the two-kernel chain (moments kernel +
   ``convolve_reproject_separable``) and runs a target with 1.5x larger
   pixels at 64 channels.  Then the plan the fused kernel declines: a
   100" target beam (171 taps) on 64 channels of the NaN-bordered cube,
   counters at 0 before, after them conv_sep and resample2 once and
   conv_reproject never (the two-stage chain), and
   ``moments_conv_reproject_fused`` returns None.
7. Varying-resolution cubes: writes a third 623 x 768 x 768 cube of the
   pipeline's kind as 4-D FITS with a degenerate STOKES axis and a
   CASA-layout BEAMS table (beams drifting 6.0"->6.6" by 4.5"->4.95" at
   PA 30->34 deg, channels 100-101 flagged with NaN beams), reads it with
   no device argument and runs (a) ``run_pipeline`` (common beam, SNR
   mask, moments, statistics, reproject onto the grid rotated by 3 deg:
   the FFT route and the four-corner gather), flagged planes NaN in the
   output; and (b) the same data with PA 0 beams in 4-channel groups
   (156 beam groups), ``convolve_to`` a 12" beam (the per-channel
   separable route, conv_sep count > 0), held against conv_sep's plain
   version.  Logs each route, the host time of the beam grouping and
   kernels, the transfers' build on the card, the stages' times (first
   and second call) and the peak memory.
8. The cube's everyday API on the pipeline's FITS file (623 x 768 x 768,
   nothing cut) and on the varying-resolution file (a): the spectral
   axis converted to km/s and to GHz (radio), WCS cards as a small CPU
   cube's; a 300-channel velocity slab cut spatially to 640 x 576 (a
   copy into a contiguous tensor), masked at 3 sigma (``mad_std`` of the
   whole cube), its moments through the moments kernel (the plain
   versions refused while it runs), equal to the same crop of the
   slab's; ``cube[::-1]``'s moment 1 as the forward cube's; ``to(K)`` and
   back, ``cube - cube``, ``(cube * 2) / 2``, ``argmax`` and
   ``argmax_world`` against a float64 numpy argmax on the host (and
   ``torch.argmax`` on the card against the CPU on ties and all -inf);
   a spectrum, a channel map and ``minimal_subcube``; channels 100-399 of
   the varying-resolution cube with their beams, ``jtok_factors``,
   ``to(K)`` and moments; a StokesSpectralCube of four such cubes made on
   the card, ``transform_basis`` to linear feeds and back, its I
   moment 0, and a 4-D FITS round trip of 64 of its channels (cut for
   the host's write time).  Logs each step's time (second call), the
   peak memory and the time of the spatial cut's copy.
9. On the pipeline's FITS file and the varying-resolution file (a):
   (a) ``cube.reproject(order="bicubic")`` onto the 311-channel target of
   step 5 (the spectral spline operator and its absolute value through
   banded_matmul, #14's first caller on a path: counters at 0 before and
   2 launches after, then the separable spatial products), its stages
   timed (host operators, #14, spatial matmuls, poison) and held bit for
   bit against the call, and #14 on that operator against its plain
   version, timed beside ``torch.matmul`` in IEEE float32; (b)
   ``order="biquadratic"`` onto the grid rotated by 3 deg (prefilter, 9
   tap gathers into one reused buffer, the poison pass), its stages
   timed and held bit for bit; (c) ``mosaic_cubes`` of the cube and a
   copy shifted by (200, 0.37) pixel onto the widened grid (resample2
   twice), the overlap bitwise the mean of the two reprojections, and
   its moment 0 through the moments kernel; (d)
   ``apply_function_parallel_spectral`` (a baseline subtraction, vmapped)
   and ``_spatial`` at full width against the same arithmetic done
   directly, ``apply_function(np.nanmax, axis=0)`` on a 64 x 64 cut (the
   host ray loop), ``sum(axis=(1, 2))`` against float64, and
   ``spectral_smooth(save_to_tmp_dir=True)`` bitwise against the call
   without it, with its moment 0; (e) ``stack_spectra`` of every spectrum
   with the synthetic line's drift as the velocity surface (the stacked
   line at v0), and ``stack_cube`` of two lines on the varying-resolution
   cube convolved to 12" (its route logged); then small cubes on the
   card against the CPU.  Logs each step's time, launches and peak.
10. Runs ``banded_matmul_strips`` (#14) with bench config 2's composed
   operator (17-tap Gaussian, then every second channel, 512 -> 256) on a
   512 x 768 x 768 cube viewed as (512, 589824), counters at 0 before and
   the banded_matmul count > 0 after.
10b. I/O and regions on a fourth 623 x 768 x 768 cube (the pipeline's kind
   with NaN holes, its spectral axis in Hz): written as a CASA image in one
   tile (format from the ``.image`` suffix) and in 64 x 64 x 1 x 16 tiles
   (5616 tiles), and as FITS, each read back with its format detected onto
   the card and held bit for bit against the source (data, NaN pattern,
   include mask; WCS cards as the FITS read's; beam within 1e-12); an SNR
   mask (> 3 sigma, ``mad_std`` on the card) appended with
   ``make_casa_mask`` reads back bit for bit; a varying-resolution image
   with 623 per-plane beams and a 4 x 64 x 768 x 768 IQUV image round-trip;
   a type-2 CLASS .lmv cube of the same data reads onto the card equal to
   its CPU read; then a DS9 cut (an fk5 circle, an image-frame polygon, an
   exclusion circle) and a CRTF box with a velocity range of the CASA read,
   their shapes and masks held against the host rasteriser, and
   ``run_pipeline`` on the DS9 cut (counters at 0 before, moments, conv_sep
   and resample2 > 0 after) against the same cut of the FITS read.  Each
   file set is deleted once checked.
11. Holds each kernel against its plain PyTorch version on the card at the
   paths' shapes, with and without NaN, and times the kernel, the plain
   version and, where one exists, a single PyTorch call computing the same
   function (CUDA events); conv_sep also at 153 taps (the cube beam to a
   90" beam) on the NaN-bordered cube; moments also with a bool include
   mask in place of the fused comparison; resample2 and
   resample2_filled (held bit for bit) and banded_matmul also as their
   launches alone, their packed taps or step tables already on the card.  Each
   kernel's bound is the larger of its bytes over 3.35 TB/s and its
   float32 operations over 67 TFLOP/s (H100 SXM).
12. Runs a small pipeline, a small varying-resolution pipeline on both
    convolution routes and a small spectral path on the card and on the
    CPU and compares them.

Prints one JSON line with each kernel's numbers, the card line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

SEED = 20261016
NCHAN, NY, NX = 623, 768, 768
PIX_ARCSEC = 2.0
CUBE_BEAM = (6.0, 4.5, 30.0)       # arcsec, arcsec, deg (elliptical)
TARGET_BEAM = 12.0                 # arcsec, circular
SNR = 3.0
SHIFT = (0.37, -0.61)              # CRPIX1, CRPIX2 shift of the target

# the kernels each path runs
PIPELINE_KERNELS = ("moments", "conv_sep", "resample2")
SPECTRAL_KERNELS = ("sigma_clip", "smooth_interp")
REPROJECT_SPECTRAL_KERNELS = ("resample2_filled",)
CONV_REPROJECT_KERNELS = ("conv_reproject", "plain_strips", "pipeline_fused")
VRSC_KERNELS = ("moments", "conv_sep")
BANDED_MATMUL_KERNELS = ("banded_matmul",)

# varying-resolution cell: beams drifting linearly over the channels
# (arcsec, arcsec, deg: start, end), the flagged planes (NaN beams), the
# rotation of the reprojection target (bench config 7, bench.py:564-633)
# and the channels a beam holds for in the separable case (b)
VR_MAJOR, VR_MINOR, VR_PA = (6.0, 6.6), (4.5, 4.95), (30.0, 34.0)
VR_FLAGGED = (100, 101)
VR_ROTATION = 3.0
VR_GROUP = 4
# bench config 2's composed operator, 512 -> 256 channels (bench.py:178-211)
BM_NIN = 512
# cube API phase: the velocity slab's first and last channel (300
# channels), the spatial cut (xlo, xhi, ylo, yhi), the channel map, the
# channel range cut from the varying-resolution cube, and the channels of
# the Stokes FITS round trip (cut for the host's write time)
API_SLAB = (160, 459)
API_CUT = (64, 704, 96, 672)
API_PLANE = 300
API_VR_CUT = (100, 400)
API_VR_THRESHOLD = 0.1
API_STOKES_NCHAN = 64
# I/O and regions phase: its cube's seed, the CASA tiling of the second
# image (CASA order [x, y, stokes, chan]: 12 x 12 x 1 x 39 = 5616 tiles at
# 623 x 768 x 768), the channels of the IQUV image, the SNR of the
# appended mask, and the velocity range (km/s, radio) of the CRTF box
IO_SEED = SEED + 30
IO_TILE = (64, 64, 1, 16)
IO_STOKES_NCHAN = 64
IO_MASK_SNR = 3.0
IO_VELOCITY_RANGE = (-10.0, 10.0)
IO_KERNELS = ("moments", "conv_sep", "resample2")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# spectral path: Gaussian smoothing kernel (stddev in channels), clip
SMOOTH_STDDEV = 2.0
CLIP_SIGMA = 1.0
CLIP_ITERS = 5

# reprojection onto a new spectral axis: output channels, width and start
# in input channels
SPECTRAL_TARGET = (311, 2.0, 0.25)
# fused convolve + reproject: bench config 5's data-local mask
# (bench.py:413-414) and the channels of the 1.5x rescaled target
FUSED_THRESHOLD = 0.25
RESCALED_NCHAN = 64
# the spline phase: the mosaic copy's shift (pixels), the 64 x 64 cut of
# the host ray loop, the channels of the baseline mean, and stack_cube's
# velocity window (km/s) and second line's offset (km/s)
MOSAIC_SHIFT = (200.0, 0.37)
APPLY_CUT = (352, 416)
APPLY_BASELINE = 64
STACK_WINDOW = (-10.0, 50.0)
STACK_LINE_SHIFT = -30.0
# long taps: the target beam (arcsec) of kernel 2's long-tap case (153
# taps at 2" pixels) and of the fused convolve + reproject's declined plan
# (171 taps, past what one block's window holds), at RESCALED_NCHAN
# channels
F1_BEAM = 90.0
F2_BEAM = 100.0

# name -> (source, TPU kernels it replaces)
KERNELS = {
    "moments": ("spectral_cube_tpu_torch/csrc/moments.cu",
                "spectral_cube_tpu/ops/moments.py:129 moments_012_pallas; "
                "spectral_cube_tpu/ops/moments.py:288 "
                "_moments_pallas_chunked"),
    "conv_sep": ("spectral_cube_tpu_torch/csrc/conv_sep.cu",
                 "spectral_cube_tpu/ops/banded_pallas.py:491 "
                 "per_channel_conv_strips; "
                 "spectral_cube_tpu/ops/banded_pallas.py:617 "
                 "per_channel_conv_strips_blocked"),
    "resample2": ("spectral_cube_tpu_torch/csrc/resample2.cu",
                  "spectral_cube_tpu/ops/banded_pallas.py:913 "
                  "per_channel_resample_raw_strips; "
                  "spectral_cube_tpu/ops/banded_pallas.py:1500 "
                  "per_channel_shift_lerp"),
    "sigma_clip": ("spectral_cube_tpu_torch/csrc/sigma_clip.cu",
                   "spectral_cube_tpu/ops/clip_pallas.py:126 "
                   "sigma_clip_fused"),
    "smooth_interp": ("spectral_cube_tpu_torch/csrc/smooth_interp.cu",
                      "spectral_cube_tpu/ops/banded_pallas.py:364 "
                      "smooth_interp_strips_3d; "
                      "spectral_cube_tpu/ops/banded_pallas.py:266 "
                      "smooth_interp_strips"),
    "resample2_filled": ("spectral_cube_tpu_torch/csrc/resample2.cu",
                         "spectral_cube_tpu/ops/banded_pallas.py:809 "
                         "per_channel_resample_strips"),
    "conv_reproject": ("spectral_cube_tpu_torch/csrc/conv_reproject.cu",
                       "spectral_cube_tpu/ops/banded_pallas.py:1043 "
                       "conv_reproject_raw_strips; "
                       "spectral_cube_tpu/ops/banded_pallas.py:1599 "
                       "per_channel_plain_strips"),
    "pipeline_fused": ("spectral_cube_tpu_torch/csrc/conv_reproject.cu",
                       "spectral_cube_tpu/ops/banded_pallas.py:1220 "
                       "pipeline_fused_raw_strips"),
    "banded_matmul": ("spectral_cube_tpu_torch/csrc/banded_matmul.cu",
                      "spectral_cube_tpu/ops/banded_pallas.py:222 "
                      "banded_matmul_strips"),
}

# launch counters summed into each kernel's "launches": the conv_reproject
# source serves #8 and its clean branch #9 through two wrappers
COUNTED = {"conv_reproject": ("conv_reproject", "plain_strips")}


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    each bracketed by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def no_tf32():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compare(name, got, want, rtol):
    """NaN patterns equal, then max |got - want| within ``rtol`` of the
    largest |want|.  Returns (max_abs_err, relative error)."""
    import torch
    got, want = got.float(), want.float()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        raise AssertionError(f"{name}: NaN patterns differ in "
                             f"{int((nan_g != nan_w).sum())} places")
    fin = ~nan_w
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((got[fin] - want[fin]).abs().max())
    scale = float(want[fin].abs().max())
    rel = err / max(scale, 1e-30)
    log(f"  {name}: max_abs_err={err:.3e} rel={rel:.3e} (tol {rtol:g}) "
        f"nan_equal=True")
    if rel > rtol:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {rtol:g}")
    return err, rel


def compare_conv(name, got, want, x, ys, xs, hy, hx, rtol):
    """Kernel 2 against its plain version.  The normalized convolution is
    num / den with den = 1 - K*isnan, the valid fraction of the kernel's
    footprint, so float32 rounding in num and den is amplified by 1/den:
    where den is tiny the NaN test (den > 1e-6) is rounding itself.  den
    comes here from a float64 evaluation.  NaN patterns must agree wherever
    den > 1e-5, and max |got - want| * den must stay within ``rtol`` of the
    largest |want|.  Returns the max |got - want| where den >= 0.1."""
    import torch
    from spectral_cube_tpu_torch.kernels.conv_sep import _apply
    den = torch.empty_like(x)
    for c0 in range(0, x.shape[0], 64):
        bad = (~torch.isfinite(x[c0:c0 + 64])).double()
        den[c0:c0 + 64] = (1.0 - _apply(bad, ys[0].double(), xs[0].double(),
                                        hy, hx)).float()
    flip = torch.isnan(got) != torch.isnan(want)
    if bool((flip & (den > 1e-5)).any()):
        raise AssertionError(f"{name}: NaN patterns differ where the "
                             "convolution is well conditioned")
    both = ~torch.isnan(got) & ~torch.isnan(want)
    diff = torch.where(both, (got - want).abs(), 0.0)
    scale = float(torch.where(both, want.abs(), 0.0).max())
    weighted = float((diff * den.clamp(max=1.0)).max()) / max(scale, 1e-30)
    err = float(torch.where(den >= 0.1, diff, 0.0).max())
    log(f"  {name}: max_abs_err(den >= 0.1)={err:.3e} "
        f"max|diff|*den/scale={weighted:.3e} (tol {rtol:g}); "
        f"{int(flip.sum())} NaN flips, all at den <= 1e-5")
    if weighted > rtol:
        raise AssertionError(f"{name}: {weighted:.3e} > {rtol:g}")
    return err, weighted


def synth_header(nchan, ny, nx):
    from spectral_cube_tpu_torch.io.fits_low import Header
    h = Header()
    for key, val in (
            ("SIMPLE", True), ("BITPIX", -32), ("NAXIS", 3),
            ("NAXIS1", nx), ("NAXIS2", ny), ("NAXIS3", nchan),
            ("CTYPE1", "RA---SIN"), ("CRVAL1", 83.82), ("CUNIT1", "deg"),
            ("CDELT1", -PIX_ARCSEC / 3600.0), ("CRPIX1", nx / 2 + 0.5),
            ("CTYPE2", "DEC--SIN"), ("CRVAL2", -5.39), ("CUNIT2", "deg"),
            ("CDELT2", PIX_ARCSEC / 3600.0), ("CRPIX2", ny / 2 + 0.5),
            ("CTYPE3", "VRAD"), ("CRVAL3", -20000.0), ("CUNIT3", "m/s"),
            ("CDELT3", 250.0), ("CRPIX3", 1.0), ("RESTFRQ", 2.30538e11),
            ("SPECSYS", "LSRK"), ("BUNIT", "Jy/beam"),
            ("BMAJ", CUBE_BEAM[0] / 3600.0), ("BMIN", CUBE_BEAM[1] / 3600.0),
            ("BPA", CUBE_BEAM[2])):
        h[key] = val
    return h


def synth_cube(nchan, ny, nx, seed, cutoff=True):
    """float32 cube from numpy.random.RandomState(seed): a Gaussian line
    whose centre drifts across the field, on unit noise, NaN outside a
    circular primary-beam cutoff (``cutoff``) or in a 2-pixel frame."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float32)
    ry, rx = (yy - ny / 2) / ny, (xx - nx / 2) / nx
    amp = 6.0 * np.exp(-0.5 * ((ry / 0.2) ** 2 + (rx / 0.25) ** 2))
    centre = nchan / 2 + 0.15 * nchan * rx
    if cutoff:
        cut = (ry / 0.47) ** 2 + (rx / 0.47) ** 2 > 1.0
    else:
        cut = np.zeros((ny, nx), bool)
        cut[:2] = cut[-2:] = cut[:, :2] = cut[:, -2:] = True
    data = np.empty((nchan, ny, nx), np.float32)
    for c in range(nchan):
        plane = amp * np.exp(-0.5 * ((c - centre) / (0.02 * nchan)) ** 2)
        plane += rng.standard_normal((ny, nx)).astype(np.float32)
        plane[cut] = np.nan
        data[c] = plane
    return data


def shifted_header(h, dx, dy):
    t = h.__class__(h)
    t["CRPIX1"] = float(h["CRPIX1"]) + dx
    t["CRPIX2"] = float(h["CRPIX2"]) + dy
    return t


def beams():
    import spectral_cube_tpu_torch as T
    cube_beam = T.Beam(T.Quantity(CUBE_BEAM[0], "arcsec"),
                       T.Quantity(CUBE_BEAM[1], "arcsec"),
                       T.Quantity(CUBE_BEAM[2], "deg"))
    target = T.Beam(T.Quantity(TARGET_BEAM, "arcsec"),
                    T.Quantity(TARGET_BEAM, "arcsec"), T.Quantity(0, "deg"))
    return cube_beam, target


def phase_moments(dev, data, results):
    import torch
    from spectral_cube_tpu_torch.kernels import moments as km
    log("phase moments (kernel 1)")
    for label, cube in (("623ch", data), ("1024ch", None)):
        if cube is None:
            cube = torch.as_tensor(synth_cube(1024, NY, NX, SEED + 2),
                                   device=dev)
        for nan in (False, True):
            x = cube
            if nan:
                x = cube.clone()
                x[:, :40] = float("nan")
                x[7] = float("nan")
            coords = np.arange(x.shape[0]) * 0.25
            for stats in (False, True):
                tag = f"{label} nan={nan} with_stats={stats}"
                want = km.moments_planes_plain(x, coords, 1, 0.75, None,
                                               stats)
                got = km.moments_planes(x, coords, 1, 0.75, None, stats)
                if not torch.equal(got[1], want[1]):
                    raise AssertionError(f"moments {tag}: counts differ")
                fg = _finalize(got, stats)
                fw = _finalize(want, stats)
                errs = [compare(f"moments {tag} mom{i}", a, b,
                                2e-6 if i < 2 else 1e-5)
                        for i, (a, b) in enumerate(zip(fg[:3], fw[:3]))]
                if stats:
                    for key in ("mean", "sigma", "sum", "rms", "min", "max"):
                        a, b = float(fg[3][key]), float(fw[3][key])
                        if abs(a - b) > 2e-5 * abs(b):
                            raise AssertionError(f"statistics {key}: {a} "
                                                 f"vs {b}")
                if label == "623ch" and nan and not stats:
                    ms = cuda_ms(lambda: km.moments_planes(
                        x, coords, 1, 0.75, None, False), 7)
                    pms = cuda_ms(lambda: km.moments_planes_plain(
                        x, coords, 1, 0.75, None, False), 3)
                    # one read of the cube, six planes and the counts
                    # written; ~8 flops per voxel (two passes)
                    bms, by = bound(x.numel() * 4 + 28 * NY * NX,
                                    8 * x.numel())
                    results["moments"] = dict(
                        max_abs_err=max(e[0] for e in errs), ms=ms,
                        plain_ms=pms, bound_ms=bms, bound_by=by,
                        library_ms=None)
                    log(f"  moments 623x768x768 masked: kernel {ms:.3f} ms,"
                        f" plain {pms:.3f} ms, bound {bms:.3f} ms ({by}), "
                        f"plan {km.plan(NY * NX, True, False)}")
                    phase_moments_include(x, coords)
                if label == "1024ch" and nan and not stats:
                    ms = cuda_ms(lambda: km.moments_planes(
                        x, coords, 1, 0.75, None, False), 5)
                    pms = cuda_ms(lambda: km.moments_planes_plain(
                        x, coords, 1, 0.75, None, False), 3)
                    bms, by = bound(x.numel() * 4 + 28 * NY * NX,
                                    8 * x.numel())
                    log(f"  moments 1024x768x768 masked: kernel {ms:.3f} ms,"
                        f" plain {pms:.3f} ms, bound {bms:.3f} ms ({by})")
    del cube


def phase_moments_include(x, coords):
    """Kernel 1 with an include mask (a bool array, read as its bytes) in
    place of the fused comparison: held against the plain version and
    timed; its bound reads 5 bytes a voxel."""
    import torch
    from spectral_cube_tpu_torch.kernels import moments as km
    inc = x > 0.75
    want = km.moments_planes_plain(x, coords, 0, 0.0, inc, False)
    got = km.moments_planes(x, coords, 0, 0.0, inc, False)
    if not torch.equal(got[1], want[1]):
        raise AssertionError("moments with an include mask: counts differ")
    for i, (a, b) in enumerate(zip(_finalize(got, False)[:3],
                                   _finalize(want, False)[:3])):
        compare(f"moments include mom{i}", a, b, 2e-6 if i < 2 else 1e-5)
    ms = cuda_ms(lambda: km.moments_planes(x, coords, 0, 0.0, inc, False), 7)
    bms, by = bound(x.numel() * 5 + 28 * NY * NX, 8 * x.numel())
    log(f"  moments 623x768x768 include mask: kernel {ms:.3f} ms, bound "
        f"{bms:.3f} ms ({by}), plan "
        f"{km.plan(NY * NX, True, True, inc.data_ptr() % 16 == 0)}")


def _finalize(res, stats):
    from spectral_cube_tpu_torch.ops import moments as om
    return om.finalize_planes(*res, 0.0, 1.0, stats)


def phase_conv(dev, data, results):
    import torch
    import torch.nn.functional as F
    from spectral_cube_tpu_torch.kernels import conv_sep as kc
    from spectral_cube_tpu_torch.ops import convolve as oc
    log("phase convolution (kernel 2)")
    cube_beam, target = beams()
    pix = np.radians(PIX_ARCSEC / 3600.0)
    kern = target.deconvolve(cube_beam).as_kernel(pix)
    yt, xt = oc.separable_factors(kern)
    ys, hy = oc._tap_stack([yt])
    xs, hx = oc._tap_stack([xt])
    log(f"  kernel {kern.shape[0]}x{kern.shape[1]}, SVD rank r={yt.shape[1]}")
    ys, xs = torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev)
    gi = torch.zeros(NCHAN, dtype=torch.int32, device=dev)
    # the library call: one conv2d with the full 2-D kernel, TF32 off
    ky, kx = kern.shape
    weight = torch.as_tensor(np.ascontiguousarray(kern[::-1, ::-1]),
                             dtype=torch.float32, device=dev)[None, None]
    pad = (kx - 1 - (kx - 1) // 2, (kx - 1) // 2,
           ky - 1 - (ky - 1) // 2, (ky - 1) // 2)
    lib_ms = None
    for nan in (False, True):
        x = torch.nan_to_num(data, nan=0.0) if not nan else data
        got = kc.conv_sep(x, ys, xs, hy, hx, gi)
        want = kc.conv_sep_plain(x, ys, xs, hy, hx, gi)
        err, _ = compare_conv(f"conv nan={nan}", got, want, x, ys, xs, hy,
                              hx, 1e-5)
        del got, want
        if nan:
            ms = cuda_ms(lambda: kc.conv_sep(x, ys, xs, hy, hx, gi), 5)
            pms = cuda_ms(lambda: kc.conv_sep_plain(x, ys, xs, hy, hx, gi),
                          2)
            # one read and one write; the numerator's r (ly + lx) FMAs per
            # voxel (the denominator that NaN footprints add is not counted)
            bms, by = bound(2 * x.numel() * 4, 2 * ys.shape[1]
                            * (ys.shape[2] + xs.shape[2]) * x.numel())
            results["conv_sep"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound_ms=bms, bound_by=by,
                                       library_ms=lib_ms)
            log(f"  conv 623x768x768 r={yt.shape[1]} with NaN: kernel "
                f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms "
                f"({by})")
        else:
            ms = cuda_ms(lambda: kc.conv_sep(x, ys, xs, hy, hx, gi), 5)
            pms = cuda_ms(lambda: kc.conv_sep_plain(x, ys, xs, hy, hx, gi),
                          2)
            lib_ms = cuda_ms(lambda: F.conv2d(F.pad(x[:, None], pad),
                                              weight), 3)
            log(f"  conv 623x768x768 clean: kernel {ms:.3f} ms, plain "
                f"{pms:.3f} ms, conv2d {kx}x{ky} {lib_ms:.3f} ms")
        del x
    f1 = phase_conv_long_taps(dev, data, cube_beam, pix, gi)
    return yt.shape[1], f1


def phase_conv_long_taps(dev, data, cube_beam, pix, gi):
    """Kernel 2 at long taps: the NaN-bordered cube convolved from the cube
    beam to F1_BEAM (153 taps at 2" pixels) through
    ``convolve2d_separable``, one launch, held against the plain version
    and timed.  Returns (taps, rank, ms, bound_ms, max_abs_err)."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.kernels import conv_sep as kc
    from spectral_cube_tpu_torch.ops import convolve as oc
    target = T.Beam(T.Quantity(F1_BEAM, "arcsec"),
                    T.Quantity(F1_BEAM, "arcsec"), T.Quantity(0, "deg"))
    kern = target.deconvolve(cube_beam).as_kernel(pix)
    yt, xt = oc.separable_factors(kern)
    ys, hy = oc._tap_stack([yt])
    xs, hx = oc._tap_stack([xt])
    ys, xs = torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev)
    n0 = kc.conv_sep.launches
    got = oc.convolve2d_separable(data, kern)
    torch.cuda.synchronize()
    if kc.conv_sep.launches != n0 + 1:
        raise AssertionError("convolve2d_separable did not launch conv_sep "
                             "at long taps")
    want = kc.conv_sep_plain(data, ys, xs, hy, hx, gi)
    err, _ = compare_conv(f"conv {kern.shape[0]} taps (F1 input)", got, want,
                          data, ys, xs, hy, hx, 1e-5)
    del got, want
    ms = cuda_ms(lambda: kc.conv_sep(data, ys, xs, hy, hx, gi), 3)
    bms, by = bound(2 * data.numel() * 4, 2 * ys.shape[1]
                    * (ys.shape[2] + xs.shape[2]) * data.numel())
    log(f"  conv {'x'.join(map(str, data.shape))} {kern.shape[0]}x"
        f"{kern.shape[1]} taps r={yt.shape[1]} with NaN: kernel {ms:.3f} ms, "
        f"bound {bms:.3f} ms ({by})")
    torch.cuda.empty_cache()
    return kern.shape[0], yt.shape[1], ms, bms, err


def grid_sample_call(x, taps):
    """One ``grid_sample`` (bilinear, zero padding) computing the resample
    of clean data ``x`` at the taps' sample points: the library call the
    resample kernel is timed against."""
    import torch
    import torch.nn.functional as F
    y0, wy, x0, wx = taps
    _, ny_in, nx_in = x.shape
    dev = x.device
    ypos = torch.as_tensor(np.asarray(y0) + np.asarray(wy), device=dev)
    xpos = torch.as_tensor(np.asarray(x0) + np.asarray(wx), device=dev)
    gy = (2.0 * ypos / (ny_in - 1) - 1.0).float()
    gx = (2.0 * xpos / (nx_in - 1) - 1.0).float()
    grid = torch.stack(torch.meshgrid(gy, gx, indexing="ij")[::-1], -1)[None]
    return lambda: F.grid_sample(x[None], grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def resample_cases(header):
    """Kernel 3's two targets for the cube of ``header``: the pipeline's
    CRPIX shift (a translation) and a 700 x 700 grid of 1.07x larger
    pixels.  Yields (label, taps (y0, wy, x0, wx), valid plane, maps)."""
    from spectral_cube_tpu_torch.ops import regrid as og
    from spectral_cube_tpu_torch.wcs import WCS
    wcs = WCS(header=header)
    scaled = header.__class__(header)
    scaled["NAXIS1"] = scaled["NAXIS2"] = 700
    scaled["CDELT1"] = header["CDELT1"] * 1.07
    scaled["CDELT2"] = header["CDELT2"] * 1.07
    scaled["CRPIX1"] = scaled["CRPIX2"] = 350.5
    for label, target in (("translation", shifted_header(header, *SHIFT)),
                          ("scaled", scaled)):
        zs, ys, xs, _ = og.reproject_mappings(wcs, target, NCHAN)
        tr = og._translation_params(ys, xs, NY, NX)
        if (label == "translation") != (tr is not None):
            raise AssertionError(f"{label}: translation detection {tr}")
        maps = og.bilinear_host_maps(zs, ys, xs, NCHAN, NY, NX, 1)
        taps = og._axis_aligned_taps(ys, xs, NY, NX)
        if taps is None:
            raise AssertionError(f"{label}: target not axis-aligned")
        yield label, taps, maps[4] & maps[5], maps


def phase_resample(dev, data, header, results):
    import torch
    from spectral_cube_tpu_torch.kernels import resample2 as kr
    log("phase reproject (kernel 3)")
    lib_ms = None
    for label, taps, valid, maps in resample_cases(header):
        for nan in (False, True):
            x = torch.nan_to_num(data, nan=0.0) if not nan else data
            got = kr.resample2(x, *taps, valid, maps[0])
            want = kr.resample2_plain(x, *taps, valid, maps[0])
            err, _ = compare(f"resample {label} nan={nan}", got, want, 1e-6)
            # the raw kernel adds in the plain version's order: bit for bit
            if not torch.equal(torch.nan_to_num(got),
                               torch.nan_to_num(want)):
                raise AssertionError(f"resample {label} nan={nan}: not "
                                     "bitwise equal to the plain version")
            del got, want
            ms = cuda_ms(lambda: kr.resample2(x, *taps, valid, maps[0]), 7)
            pms = cuda_ms(lambda: kr.resample2_plain(x, *taps, valid,
                                                     maps[0]), 3)
            # the launch alone, its taps already on the card
            prep = kr.prepare(x, *taps, valid, maps[0])
            lms = cuda_ms(lambda: kr.launch(x, prep), 7)
            log(f"  resample {label} nan={nan}: kernel {ms:.3f} ms (launch "
                f"alone {lms:.3f} ms), plain {pms:.3f} ms, plan "
                f"{prep.packed.plan}")
            if not nan:
                lib_ms = cuda_ms(grid_sample_call(x, taps), 3)
                log(f"  resample {label}: grid_sample bilinear "
                    f"{lib_ms:.3f} ms")
            else:
                # one read and one write; ~12 flops per output voxel
                n_out = NCHAN * valid.size
                bms, by = bound(x.numel() * 4 + n_out * 4, 12 * n_out)
                log(f"  resample {label}: bound {bms:.3f} ms ({by})")
            if label == "translation" and nan:
                results["resample2"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=pms, bound_ms=bms,
                                            bound_by=by, library_ms=lib_ms)
            del x


def hold_stages(tag, cube, target_beam, target_header, res, dev, timed):
    """``run_pipeline``'s stages on ``cube`` (convolve_to, mad_std, the
    SNR-masked moments and statistics, reproject), each timed with
    ``timed(name, fn)`` and held on the card against its plain function at
    the cube's own shape, and against the pipeline's result ``res``."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.kernels import conv_sep as kc
    from spectral_cube_tpu_torch.kernels import resample2 as kr
    from spectral_cube_tpu_torch.ops import convolve as oc
    from spectral_cube_tpu_torch.ops import moments as om
    from spectral_cube_tpu_torch.ops import reductions as rd
    from spectral_cube_tpu_torch.ops import regrid as og
    nchan, ny, nx = cube.shape
    conv = timed("convolve_to", lambda: cube.convolve_to(target_beam))
    noise = timed("mad_std", lambda: float(conv.mad_std().value))
    masked = conv.with_mask(conv > T.Quantity(SNR * noise, conv.unit))
    mom = timed("moments", lambda: masked._moments012())
    stats = timed("statistics", masked.statistics)
    rep = timed("reproject", lambda: masked._reproject(target_header))

    # the pixel scale as convolve_to takes it from the cube's WCS
    pixscale = float(np.mean(np.abs(
        cube.wcs.celestial.proj_plane_pixel_scales()))) * np.pi / 180.0
    kern = target_beam.deconvolve(cube.beam).as_kernel(pixscale)
    yt, xt = oc.separable_factors(kern)
    ys, hy = oc._tap_stack([yt])
    xs, hx = oc._tap_stack([xt])
    ys, xs = torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev)
    filled = cube._get_filled_data(fill=np.nan)
    plain_conv = kc.conv_sep_plain(filled, ys, xs, hy, hx,
                                   torch.zeros(nchan, dtype=torch.int32,
                                               device=dev))
    # Jy/beam data scale with the beam area (ops/convolve.beam_unit_factor)
    plain_conv *= oc.beam_unit_factor(cube.unit, cube.beam, target_beam)
    compare_conv(f"{tag} convolve_to vs plain", conv._data, plain_conv,
                 filled, ys, xs, hy, hx, 1e-5)
    del filled, plain_conv
    plain_mad = float(rd.masked_mad_std(conv._data, rd.valid_mask(
        conv._data, conv.mask.include(data=conv._data))))
    if abs(plain_mad - noise) > 1e-6 * abs(noise):
        raise AssertionError(f"{tag} mad_std {noise} vs {plain_mad}")
    include = masked.mask.include(data=masked._data)
    pm = om.moments_012(masked._data, masked._spectral_offsets(),
                        masked._spectral_pix_size(), include=include)
    sv0 = float(np.asarray(masked.spectral_axis.value)[0])
    for i, (a, b) in enumerate(zip(mom, pm)):
        compare(f"{tag} moment{i} vs plain expression", torch.as_tensor(a),
                (b + sv0 if i == 1 else b).cpu(), 3e-6 if i < 2 else 5e-5)
    for i in (0, 1):
        compare(f"{tag} moment{i} vs run_pipeline", torch.as_tensor(mom[i]),
                torch.as_tensor(np.asarray(res["moments"][i].value)), 0.0)
    ps = rd.masked_statistics(masked._data, rd.valid_mask(masked._data,
                                                          include))
    del include
    st = res["statistics"]
    if stats["npts"] != int(ps["npts"]) or stats["npts"] != st["npts"]:
        raise AssertionError(f"{tag} statistics npts")
    for key in ("mean", "sigma", "sum", "rms", "min", "max"):
        a, b = float(stats[key].value), float(ps[key])
        if abs(a - b) > 2e-5 * abs(b):
            raise AssertionError(f"{tag} statistics {key}: {a} vs {b}")
    zs, ysm, xsm, _ = og.reproject_mappings(masked.wcs, target_header, nchan)
    maps = og.bilinear_host_maps(zs, ysm, xsm, nchan, ny, nx, 1)
    taps = og._axis_aligned_taps(ysm, xsm, ny, nx)
    src = masked._get_filled_data(fill=np.nan)
    plain_rep = kr.resample2_plain(src, *taps, maps[4] & maps[5], maps[0])
    del src
    compare(f"{tag} reproject vs plain", rep._data, plain_rep, 1e-6)
    compare(f"{tag} reproject vs run_pipeline", rep._data,
            res["cube"]._data, 0.0)
    del plain_rep, rep, conv, masked
    torch.cuda.empty_cache()


def phase_pipeline(dev, workdir):
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    log("phase pipeline")
    t0 = time.perf_counter()
    data = synth_cube(NCHAN, NY, NX, SEED)
    header = synth_header(NCHAN, NY, NX)
    path = os.path.join(workdir, "cube.fits")
    write_fits(path, [HDU(data=data, header=header)])
    del data
    log(f"  synthesized and wrote {path} in {time.perf_counter() - t0:.1f} s"
        f" ({os.path.getsize(path) / 2**30:.2f} GiB)")
    t0 = time.perf_counter()
    cube = T.SpectralCube.read(path, device=dev)
    torch.cuda.synchronize()
    log(f"  read onto {cube.device} in {time.perf_counter() - t0:.2f} s: "
        f"{cube}")
    _, target_beam = beams()
    target_header = shifted_header(cube.header, *SHIFT)

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = T.run_pipeline(cube, snr_threshold=SNR, target_beam=target_beam,
                         target_header=target_header)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  run_pipeline: {total * 1e3:.1f} ms end to end, peak device "
        f"memory {peak / 2**30:.2f} GiB, launches {counts}")
    counts = {k: counts[k] for k in PIPELINE_KERNELS}
    if not all(n > 0 for n in counts.values()):
        raise AssertionError(f"a kernel of the main path never ran: {counts}")
    # the first run pays one-time CUDA and library initialization; a second
    # run of the same call gives the steady-state time
    t0 = time.perf_counter()
    T.run_pipeline(cube, snr_threshold=SNR, target_beam=target_beam,
                   target_header=target_header)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"  run_pipeline again: {warm * 1e3:.1f} ms end to end")

    m0 = np.asarray(res["moments"][0].value)
    out = res["cube"]
    st = res["statistics"]
    if m0.shape != (NY, NX) or out.shape != (NCHAN, NY, NX):
        raise AssertionError("pipeline output shapes")
    frac = float(np.isfinite(m0).mean())
    log(f"  mom0 finite fraction {frac:.3f}; statistics npts={st['npts']} "
        f"mean={float(st['mean'].value):.6g} "
        f"sigma={float(st['sigma'].value):.6g}")
    if not 0.05 < frac < 0.95 or st["npts"] <= 0:
        raise AssertionError("pipeline outputs implausible")

    # stage by stage, timed, each checked against the plain functions on
    # the card
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return val

    hold_stages("stage", cube, target_beam, target_header, res, dev, timed)
    for name, ms in stages.items():
        log(f"  stage {name}: {ms:.1f} ms")
    del out, res, cube
    torch.cuda.empty_cache()
    return total * 1e3, warm * 1e3, peak, counts, stages


def add_holes(data, seed):
    """NaN holes inside spectra: 40 spaxels lose 3-12 consecutive channels
    each, inside the primary-beam cutoff."""
    rng = np.random.RandomState(seed)
    nchan, ny, nx = data.shape
    for _ in range(40):
        y = rng.randint(ny // 3, 2 * ny // 3)
        x = rng.randint(nx // 3, 2 * nx // 3)
        c = rng.randint(0, nchan - 12)
        data[c:c + rng.randint(3, 13), y, x] = np.nan
    return data


def band_thresholds64(spec, sigma, maxiters, use_mean):
    """The clip thresholds of every band iteration of one spectrum,
    computed in float64 from its sorted finite values."""
    s = np.sort(spec[np.isfinite(spec)].astype(np.float64))
    lo, hi, out = 0, s.size, []
    for _ in range(maxiters):
        cnt = hi - lo
        if cnt <= 0:
            break
        band = s[lo:hi]
        mean = band.mean()
        centre = mean if use_mean else 0.5 * (band[(cnt - 1) // 2]
                                              + band[cnt // 2])
        std = np.sqrt(((band - mean) ** 2).mean())
        lo_v, hi_v = centre - sigma * std, centre + sigma * std
        out += [lo_v, hi_v]
        lo = max(lo, int(np.searchsorted(s, lo_v, "left")))
        hi = min(hi, int(np.searchsorted(s, hi_v, "right")))
    return out


def compare_clip(name, got, want, x, sigma, maxiters, use_mean):
    """Kept values bitwise equal; samples kept by one and clipped by the
    other at most 1e-6 of the voxels, each within 4 float32 ulp of a clip
    threshold recomputed in float64 from the plain version's bands."""
    import torch
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    both = ~nan_g & ~nan_w
    if not torch.equal(got[both], want[both]):
        raise AssertionError(f"{name}: kept values differ")
    differ = torch.nonzero(nan_g != nan_w)
    nd = differ.shape[0]
    log(f"  {name}: {nd} samples kept/clipped differently "
        f"(limit {1e-6 * x.numel():.0f}); kept values bitwise equal; "
        f"{float(nan_w.float().mean()):.4f} clipped or missing")
    if nd > 1e-6 * x.numel():
        raise AssertionError(f"{name}: {nd} keep/clip differences")
    for c, y, xx in differ.tolist():
        v = float(x[c, y, xx])
        thr = band_thresholds64(x[:, y, xx].cpu().numpy(), sigma, maxiters,
                                use_mean)
        gap = min(abs(v - t) / np.spacing(np.float32(t)) for t in thr)
        if gap > 4:
            raise AssertionError(f"{name}: sample {v} at ({c},{y},{xx}) "
                                 f"flips {gap:.1f} ulp from a threshold")
    return 0.0


def clip_bound(x, maxiters):
    """One read and one write of the cube; the operations of a bitonic
    sort padded to a power of two (a min and a max per compare-exchange)
    and of the band iterations (~3 per sample each), for the spectra
    that hold a finite value."""
    import torch
    nchan = x.shape[0]
    npad = 1 << max(int(np.ceil(np.log2(max(nchan, 1)))), 0)
    stages = int(np.log2(npad)) * (int(np.log2(npad)) + 1) // 2
    live = int(torch.isfinite(x).any(0).sum())
    flops = live * (stages * npad + 3 * maxiters * nchan)
    return bound(2 * x.numel() * 4, flops)


def si_bound(x, M, S, I):
    """One read of the input and one write of the output; the composed
    band's FMAs for clean spectra and the chain's for spectra with NaN."""
    import torch
    from spectral_cube_tpu_torch.kernels.smooth_interp import band_rows
    nin, nout = M.shape[1], M.shape[0]
    fin = torch.isfinite(x.reshape(nin, -1))
    some, allf = fin.any(0), fin.all(0)
    clean = int(allf.sum())
    dirty = int((some & ~allf).sum())
    wm, ws, wi = (band_rows(A)[1].shape[1] for A in (M, S, I))
    flops = 2 * nout * (clean * wm + dirty * wi * (2 * ws + 1))
    return bound((x.numel() + nout * fin.shape[1]) * 4, flops)


def compare_si(name, got, want, x, S, I):
    """NaN patterns equal; max |got - want| within 3e-5 of the largest
    |want| over the outputs whose smoothing windows all have den > 1e-3
    (the chain divides by den, so rounding is amplified by 1/den
    elsewhere).  Returns (max_abs_err there, relative error)."""
    import torch
    nin = x.shape[0]
    dev = x.device
    bad = (~torch.isfinite(x.reshape(nin, -1))).float()
    with_weak = torch.as_tensor(I, device=dev) @ (
        1.0 - torch.as_tensor(S, device=dev) @ bad <= 1e-3).float() > 0
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        raise AssertionError(f"{name}: NaN patterns differ in "
                             f"{int((nan_g != nan_w).sum())} places")
    strong = ~nan_w & ~with_weak.reshape(want.shape)
    if not bool(strong.any()):
        return 0.0, 0.0
    err = float((got - want)[strong].abs().max())
    rel = err / max(float(want[strong].abs().max()), 1e-30)
    log(f"  {name}: NaN patterns equal; max_abs_err {err:.3e}, relative "
        f"{rel:.3e} where den > 1e-3 (tol 3e-5)")
    if rel > 3e-5:
        raise AssertionError(f"{name}: relative error {rel:.3e} > 3e-5")
    return err, rel


def phase_spectral(dev, workdir, results):
    """The spectral path at 623 x 768 x 768 through the cube methods, with
    the cube read from FITS without a device argument."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    from spectral_cube_tpu_torch.kernels import sigma_clip as kc
    from spectral_cube_tpu_torch.kernels import smooth_interp as ks
    from spectral_cube_tpu_torch.ops import interpolate as oi
    from spectral_cube_tpu_torch.ops import smoothing as osm
    log("phase spectral path (kernels sigma_clip and smooth_interp)")
    t0 = time.perf_counter()
    data = add_holes(synth_cube(NCHAN, NY, NX, SEED + 3), SEED + 4)
    path = os.path.join(workdir, "spectral.fits")
    write_fits(path, [HDU(data=data, header=synth_header(NCHAN, NY, NX))])
    del data
    log(f"  synthesized and wrote {path} in {time.perf_counter() - t0:.1f} s")
    cube = T.SpectralCube.read(path)
    if cube.device.type != "cuda":
        raise AssertionError(f"read without a device gave {cube.device}")
    log(f"  read with no device argument onto {cube.device}: {cube}")
    kern = osm.gaussian_kernel1d(SMOOTH_STDDEV)
    grid = cube.spectral_axis[::2]

    def run():
        times = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            val = fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t) * 1e3
            return val

        sm = timed("spectral_smooth", lambda: cube.spectral_smooth(kern))
        si = timed("spectral_interpolate", lambda: sm.spectral_interpolate(
            grid, smooth_kernel=kern))
        sc = timed("sigma_clip_spectrally",
                   lambda: si.sigma_clip_spectrally(CLIP_SIGMA))
        return sm, si, sc, times

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    sm, si, sc, first = run()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  spectral path, first call: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in first.items())
        + f"; peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    if counts["smooth_interp"] <= 0 or counts["sigma_clip"] <= 0:
        raise AssertionError(f"a kernel of the spectral path never ran: "
                             f"{counts}")
    del sm, si, sc
    sm, si, sc, steady = run()
    log(f"  spectral path, second call: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in steady.items())
        + f" (total {sum(steady.values()):.1f} ms)")
    nout = (NCHAN + 1) // 2
    if si.shape != (nout, NY, NX) or sc.shape != (nout, NY, NX):
        raise AssertionError(f"spectral path shapes {si.shape} {sc.shape}")
    kept = float(torch.isfinite(sc._data).float().mean())
    log(f"  interpolated to {si.shape}; sigma clip keeps {kept:.3f} of "
        f"the voxels")
    # five 1-sigma clips keep ~8% of a Gaussian's samples
    if not 0.01 < kept < 0.5:
        raise AssertionError("sigma clip output implausible")
    clip623 = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    cube.sigma_clip_spectrally(CLIP_SIGMA)
    torch.cuda.synchronize()
    clip623["sigma_clip_spectrally(623 ch)"] = (time.perf_counter() - t) * 1e3
    log(f"  sigma_clip_spectrally({CLIP_SIGMA}) on the 623-channel cube: "
        f"{clip623['sigma_clip_spectrally(623 ch)']:.1f} ms")

    # each stage against the plain functions on the card
    torch.cuda.synchronize()
    t = time.perf_counter()
    filled = sm._get_filled_data(fill=np.nan)
    torch.cuda.synchronize()
    fill_ms = (time.perf_counter() - t) * 1e3
    inaxis = np.asarray(cube.spectral_axis.value, dtype=float)
    idx, frac = oi.interp_weights(inaxis, np.asarray(grid.value))
    S, I, M, bands = oi._si_operators(kern / kern.sum(), idx, frac, NCHAN)
    want = ks.smooth_interp_plain(filled, M, S, I)
    compare_si("stage spectral_interpolate vs plain", si._data, want,
               filled, S, I)
    want = kc.sigma_clip_plain(si._data, CLIP_SIGMA, CLIP_ITERS, False)
    compare_clip("stage sigma_clip vs plain", sc._data, want, si._data,
                 CLIP_SIGMA, CLIP_ITERS, False)
    del want

    # kernel against plain version, clean and with NaN, and timed
    log("  smooth_interp kernel vs plain")
    raw = cube._data
    lib_ms = None
    for label, x in (("clean", torch.nan_to_num(raw, nan=0.0)),
                     ("holes (raw cube)", raw), ("main path input", filled)):
        got = ks.smooth_interp(x, M, S, I, bands)
        want = ks.smooth_interp_plain(x, M, S, I)
        err, rel = compare_si(f"smooth_interp {label}", got, want, x, S, I)
        ms = cuda_ms(lambda: ks.smooth_interp(x, M, S, I, bands), 7)
        pms = cuda_ms(lambda: ks.smooth_interp_plain(x, M, S, I), 3)
        if label == "clean":
            Mt = torch.as_tensor(M, device=dev)
            flat = x.reshape(NCHAN, -1)
            lib_ms = cuda_ms(lambda: torch.matmul(Mt, flat), 5)
            log(f"  smooth_interp clean: torch.matmul(M, flat) "
                f"{lib_ms:.3f} ms")
            del Mt, flat
        bms, by = si_bound(x, M, S, I)
        log(f"  smooth_interp {label}: kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, bound {bms:.3f} ms ({by}); plan "
            f"{ks.plan(NCHAN, x.numel() // NCHAN, x.data_ptr() % 16 == 0)}")
        if label == "main path input":
            results["smooth_interp"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
            stage = steady["spectral_interpolate"]
            log(f"  spectral_interpolate stage (second call) {stage:.1f} ms: "
                f"the smooth_interp kernel {ms:.3f} ms (CUDA events, the "
                f"stage's input), the filled copy {fill_ms:.3f} ms (host "
                f"clock), the rest {stage - ms - fill_ms:.1f} ms (host "
                f"operators, band uploads, mask)")
        del got, want, x
    log("  sigma_clip kernel vs plain")
    si_data = si._data
    for label, x in (("623 ch clean", torch.nan_to_num(raw, nan=0.0)),
                     ("623 ch raw cube", raw),
                     ("main path input (312 ch)", si_data)):
        got = kc.sigma_clip(x, CLIP_SIGMA, CLIP_ITERS, False)
        want = kc.sigma_clip_plain(x, CLIP_SIGMA, CLIP_ITERS, False)
        err = compare_clip(f"sigma_clip {label}", got, want, x, CLIP_SIGMA,
                           CLIP_ITERS, False)
        del got, want
        ms = cuda_ms(lambda: kc.sigma_clip(x, CLIP_SIGMA, CLIP_ITERS,
                                           False), 5)
        pms = cuda_ms(lambda: kc.sigma_clip_plain(x, CLIP_SIGMA, CLIP_ITERS,
                                                  False), 2)
        bms, by = clip_bound(x, CLIP_ITERS)
        log(f"  sigma_clip {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms,"
            f" bound {bms:.3f} ms ({by}); plan {kc.plan(x.shape[0])}")
        if label.startswith("main path"):
            results["sigma_clip"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None)
        del x
    del sm, si, sc, cube, raw, filled, si_data
    torch.cuda.empty_cache()
    return counts, peak, first, steady, clip623


def spectral_target(header):
    """The header of a target with SPECTRAL_TARGET's channels (twice the
    input's width, starting a quarter channel in) on the grid shifted by
    SHIFT."""
    nz, step, start = SPECTRAL_TARGET
    t = shifted_header(header, *SHIFT)
    t["NAXIS3"] = nz
    t["CDELT3"] = float(header["CDELT3"]) * step
    t["CRVAL3"] = float(header["CRVAL3"]) + start * float(header["CDELT3"])
    return t


def filled_bound(fz, wz_any, n_out):
    """fz read once, wz read for the channels whose weights are not all
    zero, the output written once; ~12 flops per output value and as many
    again for each poison test of a flagged channel."""
    plane = fz.shape[1] * fz.shape[2]
    flagged = int(wz_any.sum())
    per_out = n_out // fz.shape[0]
    return bound((fz.numel() + flagged * plane + n_out) * 4,
                 12 * n_out + 12 * flagged * per_out)


def filled_inputs(cube, target):
    """The filled resample's inputs on ``cube``'s path onto ``target``, as
    ``cube.reproject`` forms them: (fz, wz, wz_any, taps, valid plane,
    zvalid)."""
    from spectral_cube_tpu_torch.ops import regrid as og
    nchan, ny, nx = cube.shape
    src = cube._get_filled_data(fill=np.nan)
    zs, ys, xs, _ = og.reproject_mappings(
        cube.wcs, target, nchan,
        spectral_values_in=np.asarray(cube.spectral_axis.value))
    maps = og.bilinear_host_maps(zs, ys, xs, nchan, ny, nx, 1)
    zvalid, z0, zf = maps[:3]
    if not zvalid.all() or abs(float(zf.min()) - 0.25) > 1e-6:
        raise AssertionError(f"spectral mapping: zf {zf.min()}..{zf.max()}")
    taps = og._axis_aligned_taps(ys, xs, ny, nx)
    fz, wz, wz_any = og._zlerp_filled(src, z0, zf)
    return fz, wz, wz_any, taps, maps[4] & maps[5], zvalid


def phase_reproject_spectral(dev, workdir, results):
    """Reprojection of the hole-bearing 623-channel cube, read from FITS
    with no device argument, onto a new spectral axis and a shifted grid."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import resample2 as kr
    log("phase reproject onto a new spectral axis (kernel resample2_filled)")
    cube = T.SpectralCube.read(os.path.join(workdir, "spectral.fits"))
    if cube.device.type != "cuda":
        raise AssertionError(f"read without a device gave {cube.device}")
    # reproject, like the reference, refuses a cube this size unless asked
    cube.allow_huge_operations = True
    target = spectral_target(cube.header)
    nz = SPECTRAL_TARGET[0]

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = cube.reproject(target)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    rep, first = run()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  reproject onto {nz} channels: {first:.1f} ms first call, peak "
        f"device memory {peak / 2**30:.2f} GiB, launches {counts}")
    if counts["resample2_filled"] <= 0:
        raise AssertionError(f"the filled resample never ran: {counts}")
    del rep
    rep, steady = run()
    log(f"  reproject again: {steady:.1f} ms")
    if rep.shape != (nz, NY, NX):
        raise AssertionError(f"spectral reproject shape {rep.shape}")
    frac = float(torch.isfinite(rep._data).float().mean())
    log(f"  finite fraction {frac:.3f}")
    if not 0.5 < frac < 0.75:
        raise AssertionError("spectral reproject output implausible")

    # the stage against the plain functions on the card, then the kernel
    # against its plain version on the path's inputs, timed
    fz, wz, wz_any, taps, valid, zvalid = filled_inputs(cube, target)
    # the kernel reads wz only in flagged channels: the flags must be
    # exactly the channels whose weight plane is not all zero
    if not torch.equal(wz_any, (wz != 0).flatten(1).any(1)):
        raise AssertionError("weight flags differ from the weight planes")
    want = kr.resample2_filled_plain(fz, wz, wz_any, *taps, valid, zvalid)
    compare("stage reproject (new spectral axis) vs plain", rep._data, want,
            0.0)
    got = kr.resample2_filled(fz, wz, wz_any, *taps, valid, zvalid)
    err, _ = compare("resample2_filled vs plain", got, want, 0.0)
    del got, want, rep
    ms = cuda_ms(lambda: kr.resample2_filled(fz, wz, wz_any, *taps, valid,
                                             zvalid), 7)
    # the launch alone, its packed taps and flags already on the card
    prep = kr.prepare(fz, *taps, valid, zvalid, wz=wz, wz_any=wz_any)
    lms = cuda_ms(lambda: kr.launch(fz, prep, wz), 7)
    pms = cuda_ms(lambda: kr.resample2_filled_plain(fz, wz, wz_any, *taps,
                                                    valid, zvalid), 3)
    lib_ms = cuda_ms(grid_sample_call(fz, taps), 3)
    bms, by = filled_bound(fz, wz_any, nz * valid.size)
    log(f"  resample2_filled {nz}x{NY}x{NX} ({int(wz_any.sum())} channels "
        f"with NaN weights): kernel {ms:.3f} ms (launch alone {lms:.3f} "
        f"ms), plain {pms:.3f} ms, grid_sample {lib_ms:.3f} ms, bound "
        f"{bms:.3f} ms ({by}), plan {prep.packed.plan}")
    results["resample2_filled"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound_ms=bms, bound_by=by,
                                       library_ms=lib_ms, launch_ms=lms)
    del fz, wz, cube
    torch.cuda.empty_cache()
    return counts, peak, first, steady


def synth_config5(nchan, ny, nx, seed, dev):
    """bench config 5's clean synthesis (bench.py:392-396) at this size, on
    the card from a seeded generator: a Gaussian line of 16 channels sigma
    at the centre channel times a uniform plane, plus 0.1 unit noise."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.arange(nchan, dtype=torch.float64, device=dev)
    line = torch.exp(-0.5 * ((v - nchan / 2) / 16.0) ** 2).float()
    plane = torch.rand((1, ny, nx), generator=g, device=dev)
    data = 0.1 * torch.randn((nchan, ny, nx), generator=g, device=dev)
    data += line[:, None, None] * plane
    return data


def composed_conv2d(kern, ops, x):
    """One ``F.conv2d`` computing the fused convolve + reproject of clean
    data ``x`` onto a translated target: the common-beam kernel composed
    with the target's 2 x 2 bilinear stencil into one (L + 1)^2 weight,
    the input padded so output (i, j) lands where the fused operator puts
    it.  Returns the call (the library time's yardstick)."""
    import torch
    import torch.nn.functional as F
    kf = (kern / kern.sum())[::-1, ::-1]
    L = kf.shape[0]
    half = L - 1 - (L - 1) // 2
    sy = int(ops.ry.i0[1]) - 1
    sx = int(ops.rx.i0[1]) - 1
    wy = (float(ops.ry.w0[1]), float(ops.ry.w1[1]))
    wx = (float(ops.rx.w0[1]), float(ops.rx.w1[1]))
    W = np.zeros((L + 1, L + 1))
    for a in (0, 1):
        for b in (0, 1):
            W[a:a + L, b:b + L] += wy[a] * wx[b] * kf
    weight = torch.as_tensor(W, dtype=torch.float32,
                             device=x.device)[None, None]
    top, left = half - sy, half - sx
    pad = (left, L - left, top, L - top)
    return lambda: F.conv2d(F.pad(x[:, None], pad), weight)[:, 0]


def conv_reproject_work(x, ops, n_out, chain):
    """(bytes, flops) of the fused convolve + reproject: input read and
    output written once; the composed operator's 2 r (Wy nx_in + Wx
    nx_out) flops per output row of a clean channel; on a NaN channel the
    normalized convolution's numerator at every input voxel, its
    denominator where the kernel's footprint holds a NaN, and the 2 x 2
    resample of value and flag."""
    import torch
    import torch.nn.functional as F
    nchan, ny_in, nx_in = x.shape
    r = ops.rank
    ny_out, nx_out = ops.gy.start.shape[1], ops.gx.start.shape[1]
    wy, wx = ops.gy.taps.shape[3], ops.gx.taps.shape[3]
    if not chain:
        flops = 2 * r * nchan * ny_out * (wy * nx_in + wx * nx_out)
    else:
        ly, lx = ops.my.taps.shape[1], ops.mx.taps.shape[1]
        near = 0
        for c0 in range(0, nchan, 64):
            bad = torch.isnan(x[c0:c0 + 64])[:, None].float()
            near += int(F.max_pool2d(bad, (ly, lx), 1,
                                     (ly // 2, lx // 2)).sum())
        flops = 2 * r * (ly + lx) * (x.numel() + near) + 24 * n_out
    return (x.numel() + n_out) * 4, flops


def axis_maps(ny_out, nx_out, ay, by, ax, bx):
    """(ys, xs) of an axis-aligned target: output row i samples input row
    ay * i + by, column j input column ax * j + bx (the form of bench
    config 5's maps, bench.py:399-402)."""
    ys = np.broadcast_to((np.arange(ny_out) * ay + by)[:, None],
                         (ny_out, nx_out))
    xs = np.broadcast_to((np.arange(nx_out) * ax + bx)[None, :],
                         (ny_out, nx_out))
    return ys.astype(np.float64), xs.astype(np.float64)


def compare_moments(name, got, want, rtol):
    """Moment maps: NaN patterns equal, then each within ``rtol`` of the
    other's magnitude (floor 1e-3 of the map's scale).  Returns the
    largest relative error and whether all three maps are bitwise equal."""
    import torch
    worst, same = 0.0, True
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{name} mom{i}: NaN patterns differ")
        fin = ~torch.isnan(b)
        same = same and torch.equal(a[fin], b[fin])
        if not bool(fin.any()):
            continue
        scale = float(b[fin].abs().max())
        rel = float(((a - b).abs()[fin]
                     / torch.clamp(b.abs()[fin], min=1e-3 * scale)).max())
        worst = max(worst, rel)
    log(f"  {name}: moments max rel {worst:.3e} (tol {rtol:g}), NaN "
        f"patterns equal, bitwise {same}")
    if worst > rtol:
        raise AssertionError(f"{name}: moments differ by {worst:.3e}")
    return worst, same


def phase_conv_reproject(dev, data, results):
    """Fused convolve + reproject (#8, its clean branch #9) and the
    whole-pipeline fusion (#10) on bench config 5's clean cube (a) and the
    pipeline's NaN-bordered cube (b)."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import conv_reproject as kcr
    from spectral_cube_tpu_torch.kernels import pipeline_fused as kpf
    from spectral_cube_tpu_torch.ops import moments as om
    from spectral_cube_tpu_torch.ops import pipeline_fused as opf
    from spectral_cube_tpu_torch.ops import regrid as og
    log("phase conv_reproject (kernels conv_reproject, plain_strips, "
        "pipeline_fused)")
    cube_beam, target_beam = beams()
    kern = target_beam.deconvolve(cube_beam).as_kernel(
        np.radians(PIX_ARCSEC / 3600.0))
    ys, xs = axis_maps(NY, NX, 1.0, SHIFT[0], 1.0, SHIFT[1])
    ops = og._conv_reproject_operators(data.shape, kern, ys, xs)
    if ops is None:
        raise AssertionError("fused operators declined the pipeline target")
    log(f"  kernel {kern.shape[0]}x{kern.shape[1]}, rank {ops.rank}, G bands "
        f"{ops.gy.taps.shape[3]}/{ops.gx.taps.shape[3]} taps")
    a = synth_config5(NCHAN, NY, NX, SEED + 7, dev)
    b = data
    coords = np.arange(NCHAN) * 0.25
    dx = 0.25
    mask = T.LazyComparisonMask(torch.gt, FUSED_THRESHOLD, shape=a.shape)
    gi = np.zeros(NCHAN, np.int32)

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep_a = og.convolve_reproject_separable(a, kern, ys, xs)
    rep_b = og.convolve_reproject_separable(b, kern, ys, xs)
    strips_a = kcr.plain_strips(a, ops.gy, ops.gx, gi)
    fused = {label: opf.moments_conv_reproject_fused(
        x, kern, ys, xs, coords, dx, mask_expr=mask)
        for label, x in (("a", a), ("b", b))}
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    counts = K.launch_counts()
    log(f"  main path: {total:.1f} ms, launches {counts}")
    if not all(counts[k] > 0 for k in CONV_REPROJECT_KERNELS):
        raise AssertionError(f"a kernel of the fused path never ran: "
                             f"{counts}")
    for label, rep in (("a", rep_a), ("b", rep_b)):
        if rep.shape != (NCHAN, NY, NX):
            raise AssertionError(f"fused output shape {rep.shape}")
        log(f"  cube ({label}): finite fraction "
            f"{float(torch.isfinite(rep).float().mean()):.3f}")

    args = (ops.gy, ops.gx, ops.my, ops.mx, ops.ry, ops.rx, ops.valid)
    # the fused op against the two-kernel chain on the card
    for label, x in (("a", a), ("b", b)):
        out, m0, m1, m2, st = fused[label]
        c0, c1, c2, cst = om.moments_012_kernel(x, coords, dx,
                                                mask_expr=mask,
                                                with_stats=True)
        _, same = compare_moments(f"fused ({label}) vs moments kernel",
                                  (m0, m1, m2), (c0, c1, c2), 3e-6)
        for key in ("npts", "mean", "sigma", "min", "max", "sum"):
            u, v = float(st[key]), float(cst[key])
            if abs(u - v) > 3e-6 * abs(v):
                raise AssertionError(f"fused ({label}) statistics {key}: "
                                     f"{u} vs {v}")
        rep = rep_a if label == "a" else rep_b
        compare(f"fused ({label}) cube vs convolve_reproject_separable",
                out, rep, 0.0)
        log(f"  fused ({label}) cube bitwise equal to the chain's: "
            f"{bool(torch.equal(torch.nan_to_num(out), torch.nan_to_num(rep)))}")
    del fused

    # each kernel against its plain version, timed
    lib_ms = None
    for label, x, rep in (("a", a, rep_a), ("b", b, rep_b)):
        want = kcr.conv_reproject_plain(x, *args)
        err, _ = compare(f"conv_reproject ({label}) vs plain", rep, want,
                         1e-5)
        del want
        ms = cuda_ms(lambda: kcr.conv_reproject(x, *args), 5)
        pms = cuda_ms(lambda: kcr.conv_reproject_plain(x, *args), 2)
        bms, by = bound(*conv_reproject_work(x, ops, rep.numel(),
                                             label == "b"))
        if label == "a":
            with torch.no_grad():
                lib = composed_conv2d(kern, ops, x)
                ref = lib()
                inner = (slice(None), slice(20, -20), slice(20, -20))
                compare("one conv2d with the composed kernel vs "
                        "conv_reproject (interior)", ref[inner], rep[inner],
                        1e-5)
                del ref
                lib_ms = cuda_ms(lib, 3)
            results["conv_reproject"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
        log(f"  conv_reproject ({label}): kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, bound {bms:.3f} ms ({by})"
            + (f", conv2d {lib_ms:.3f} ms" if label == "a" else ""))
    want = kcr.plain_strips_plain(a, ops.gy, ops.gx, gi)
    compare("plain_strips vs plain", strips_a, want, 1e-5)
    ok = torch.as_tensor(ops.valid, device=dev)
    same = bool(torch.equal(strips_a[:, ok], rep_a[:, ok]))
    log(f"  plain_strips equals conv_reproject's clean branch where valid: "
        f"{same}")
    if not same:
        raise AssertionError("plain_strips and the clean branch differ")
    del want, strips_a
    ms = cuda_ms(lambda: kcr.plain_strips(a, ops.gy, ops.gx, gi), 5)
    log(f"  plain_strips (a): kernel {ms:.3f} ms")

    op, thr = 1, FUSED_THRESHOLD
    xc = coords - coords.mean()
    for label, x in (("a", a), ("b", b)):
        out, planes, cnt = kpf.pipeline_fused(x, *args, xc, op, thr)
        wout, wplanes, wcnt = kpf.pipeline_fused_plain(x, *args, xc, op, thr)
        err, _ = compare(f"pipeline_fused ({label}) cube vs plain", out,
                         wout, 1e-5)
        if not torch.equal(cnt, wcnt):
            raise AssertionError("pipeline_fused counts differ from plain")
        # the planes are the moments kernel's: its tolerances against the
        # plain planes (phase moments), relative to each map's scale
        for i, (u, v, tol) in enumerate(zip(
                om.finalize_planes(planes, cnt, 0.0, dx, True)[:3],
                om.finalize_planes(wplanes, wcnt, 0.0, dx, True)[:3],
                (2e-6, 2e-6, 1e-5))):
            compare(f"pipeline_fused ({label}) mom{i} vs plain", u, v, tol)
        del out, planes, wout, wplanes
        ms = cuda_ms(lambda: kpf.pipeline_fused(x, *args, xc, op, thr), 5)
        pms = cuda_ms(lambda: kpf.pipeline_fused_plain(x, *args, xc, op,
                                                       thr), 2)
        nbytes, flops = conv_reproject_work(x, ops, rep_a.numel(),
                                            label == "b")
        # plus the planes written and ~8 flops per voxel for the moments
        bms, by = bound(nbytes + 11 * NY * NX * 4, flops + 8 * x.numel())
        log(f"  pipeline_fused ({label}): kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, bound {bms:.3f} ms ({by})")
        if label == "a":
            results["pipeline_fused"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None)
    del rep_a, rep_b

    # a target with 1.5x larger pixels over the same field (centres
    # aligned) at RESCALED_NCHAN channels
    ys2, xs2 = axis_maps(NY * 2 // 3, NX * 2 // 3, 1.5, 0.25, 1.5, 0.25)
    for label, x in (("a", a[:RESCALED_NCHAN]), ("b", b[:RESCALED_NCHAN])):
        x = x.contiguous()
        ops2 = og._conv_reproject_operators(x.shape, kern, ys2, xs2)
        if ops2 is None:
            raise AssertionError("fused operators declined the 1.5x target")
        args2 = (ops2.gy, ops2.gx, ops2.my, ops2.mx, ops2.ry, ops2.rx,
                 ops2.valid)
        got = kcr.conv_reproject(x, *args2)
        compare(f"conv_reproject 1.5x ({label}) vs plain", got,
                kcr.conv_reproject_plain(x, *args2), 1e-5)
        xc2 = xc[:RESCALED_NCHAN] - xc[:RESCALED_NCHAN].mean()
        out, planes, cnt = kpf.pipeline_fused(x, *args2, xc2, op, thr)
        kp, kc = K.moments.moments_planes(x, xc2, op, thr, None, True)
        if not (torch.equal(planes, kp) and torch.equal(cnt, kc)):
            raise AssertionError("pipeline_fused 1.5x planes differ from "
                                 "the moments kernel's")
        compare(f"pipeline_fused 1.5x ({label}) cube vs conv_reproject",
                out, got, 0.0)
        ms = cuda_ms(lambda: kcr.conv_reproject(x, *args2), 5)
        log(f"  conv_reproject 1.5x ({label}) {tuple(got.shape)}: kernel "
            f"{ms:.3f} ms; pipeline_fused planes bitwise equal to the "
            f"moments kernel's")
        del got, out
    del a
    declined = phase_fused_declined(dev, b, cube_beam, ys, xs)
    torch.cuda.empty_cache()
    return counts, total, declined


def phase_fused_declined(dev, data, cube_beam, ys, xs):
    """The fused convolve + reproject where its plan does not fit: the
    NaN-bordered cube's first RESCALED_NCHAN channels with the F2_BEAM
    kernel (171 taps).  ``convolve_reproject_separable`` takes the
    two-stage chain (conv_sep, then resample2; no conv_reproject launch)
    and ``moments_conv_reproject_fused`` returns None.  The chain's
    convolution is held against conv_sep's plain version and its result
    against resample2's plain version of that convolution.  Returns the
    chain's milliseconds."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import conv_sep as kc
    from spectral_cube_tpu_torch.kernels import resample2 as kr
    from spectral_cube_tpu_torch.ops import convolve as oc
    from spectral_cube_tpu_torch.ops import pipeline_fused as opf
    from spectral_cube_tpu_torch.ops import regrid as og
    target = T.Beam(T.Quantity(F2_BEAM, "arcsec"),
                    T.Quantity(F2_BEAM, "arcsec"), T.Quantity(0, "deg"))
    kern = target.deconvolve(cube_beam).as_kernel(
        np.radians(PIX_ARCSEC / 3600.0))
    x = data[:RESCALED_NCHAN].contiguous()
    nchan = x.shape[0]
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = og.convolve_reproject_separable(x, kern, ys, xs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = K.launch_counts()
    route = og.convolve_reproject_separable.last["route"]
    log(f"  declined plan, {kern.shape[0]}x{kern.shape[1]} kernel on "
        f"{tuple(x.shape)}: route {route}, {ms:.1f} ms, launches {counts}")
    if route != "chain" or counts["conv_reproject"] != 0 \
            or counts["conv_sep"] != 1 or counts["resample2"] != 1:
        raise AssertionError(f"declined plan: route {route}, {counts}")
    if opf.moments_conv_reproject_fused(
            x, kern, ys, xs, np.arange(nchan) * 0.25, 0.25) is not None:
        raise AssertionError("moments_conv_reproject_fused took a plan that "
                             "does not fit")
    if rep.shape != (nchan, NY, NX):
        raise AssertionError(f"declined plan: shape {tuple(rep.shape)}")
    yt, xt = oc.separable_factors(kern / kern.sum())
    fy, hy = oc._tap_stack([yt])
    fx, hx = oc._tap_stack([xt])
    fy, fx = torch.as_tensor(fy, device=dev), torch.as_tensor(fx, device=dev)
    gi = torch.zeros(nchan, dtype=torch.int32, device=dev)
    conv = kc.conv_sep(x, fy, fx, hy, hx, gi)
    compare_conv("declined plan: convolution vs plain", conv,
                 kc.conv_sep_plain(x, fy, fx, hy, hx, gi), x, fy, fx, hy, hx,
                 1e-5)
    maps = og.bilinear_host_maps(np.arange(nchan, dtype=np.float64), ys, xs,
                                 nchan, NY, NX, 1)
    taps = og._axis_aligned_taps(ys, xs, NY, NX)
    compare("declined plan: result vs resample2_plain of the convolution",
            rep, kr.resample2_plain(conv, *taps, maps[4] & maps[5], maps[0]),
            1e-6)
    return ms


def vr_beams(nchan, pa=VR_PA, group=1, flagged=()):
    """(major, minor, pa) columns of a BEAMS table: the beams drift
    linearly from the first to the last channel, constant over runs of
    ``group`` channels, NaN in the ``flagged`` planes."""
    t = (np.arange(nchan) // group) * group / (nchan - 1)
    cols = [np.asarray(a + (b - a) * t, np.float32)
            for a, b in (VR_MAJOR, VR_MINOR, pa)]
    for c in flagged:
        cols[0][c] = cols[1][c] = np.nan
    return cols


def write_vr_fits(path, data, beam_cols):
    """``data`` as a 4-D FITS cube with a degenerate STOKES axis and a
    CASA-layout BEAMS table (BMAJ/BMIN in arcsec, BPA in deg, CHAN, POL;
    NCHAN, NPOL = 1), as CASA ``tclean`` writes per-plane beams."""
    from collections import OrderedDict
    from spectral_cube_tpu_torch.io.fits_low import (HDU, BinTableHDU,
                                                      write_fits)
    nchan, ny, nx = data.shape
    h = synth_header(nchan, ny, nx)
    for key in ("BMAJ", "BMIN", "BPA"):
        del h[key]
    h["NAXIS"] = 4
    h["NAXIS4"] = 1
    h["CTYPE4"], h["CRVAL4"], h["CDELT4"], h["CRPIX4"] = \
        "STOKES", 1.0, 1.0, 1.0
    h["CASAMBM"] = True
    major, minor, pa = beam_cols
    bt = BinTableHDU(columns=OrderedDict(
        BMAJ=major, BMIN=minor, BPA=pa,
        CHAN=np.arange(nchan, dtype=np.int32),
        POL=np.zeros(nchan, dtype=np.int32)), name="BEAMS",
        units={"BMAJ": "arcsec", "BMIN": "arcsec", "BPA": "deg"})
    bt.header["NCHAN"] = nchan
    bt.header["NPOL"] = 1
    write_fits(path, [HDU(data=data[None], header=h), bt])


def rotated_header(h, deg):
    """``h`` with its celestial grid rotated by ``deg`` about its centre
    (CRPIX): the same projection and pixel size."""
    t = h.__class__(h)
    th = np.deg2rad(deg)
    c, s = float(np.cos(th)), float(np.sin(th))
    t["PC1_1"], t["PC1_2"], t["PC2_1"], t["PC2_2"] = c, -s, s, c
    return t


def phase_vrsc(dev, workdir, results):
    """Varying-resolution cubes at 623 x 768 x 768: (a) run_pipeline on a
    4-D file with per-plane beams at PA 30-34 deg (FFT route) onto a
    rotated grid; (b) convolve_to a 12" beam with PA 0 beams in 4-channel
    groups (per-channel separable route, kernel conv_sep)."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import conv_sep as kc
    from spectral_cube_tpu_torch.ops import convolve as oc
    from spectral_cube_tpu_torch.ops import moments as om
    from spectral_cube_tpu_torch.ops import regrid as og
    log("phase varying-resolution pipeline")
    t0 = time.perf_counter()
    data = synth_cube(NCHAN, NY, NX, SEED + 9)
    path_a = os.path.join(workdir, "vr_a.fits")
    path_b = os.path.join(workdir, "vr_b.fits")
    write_vr_fits(path_a, data, vr_beams(NCHAN, flagged=VR_FLAGGED))
    write_vr_fits(path_b, data, vr_beams(NCHAN, pa=(0.0, 0.0),
                                         group=VR_GROUP))
    del data
    log(f"  synthesized and wrote two 4-D files with BEAMS tables in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}

    def timed(times, name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return val

    # (a): the FFT route, onto the grid rotated by VR_ROTATION deg
    t0 = time.perf_counter()
    cube = T.SpectralCube.read(path_a)
    torch.cuda.synchronize()
    if not isinstance(cube, T.VaryingResolutionSpectralCube) \
            or cube.device.type != "cuda" or cube.shape != (NCHAN, NY, NX):
        raise AssertionError(f"read without a device gave {cube!r}")
    log(f"  (a) read with no device argument in "
        f"{time.perf_counter() - t0:.2f} s: {cube}, "
        f"{int((~cube.goodbeams_mask).sum())} flagged planes")
    target = rotated_header(cube.header, VR_ROTATION)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = T.run_pipeline(cube, snr_threshold=SNR, target_header=target)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    last = dict(oc.convolve_cube_to_beam.last)
    log(f"  (a) run_pipeline: {first:.1f} ms first call, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches {counts}; convolution route "
        f"{last['route']}, {last['groups']} beam groups, host grouping "
        f"{last['grouping_s'] * 1e3:.1f} ms, kernels and route choice "
        f"{last['kernels_s'] * 1e3:.1f} ms")
    if last["route"] != "fft" or counts["moments"] <= 0:
        raise AssertionError(f"(a) route {last['route']}, counts {counts}")
    t0 = time.perf_counter()
    T.run_pipeline(cube, snr_threshold=SNR, target_header=target)
    torch.cuda.synchronize()
    second = (time.perf_counter() - t0) * 1e3
    log(f"  (a) run_pipeline again: {second:.1f} ms")
    m0, m1, _ = (np.asarray(p.value) for p in res["moments"])
    rep = res["cube"]._data
    if rep.shape != (NCHAN, NY, NX) or m0.shape != (NY, NX):
        raise AssertionError("(a) output shapes")
    for c in VR_FLAGGED:
        if not bool(torch.isnan(rep[c]).all()):
            raise AssertionError(f"(a) flagged plane {c} is not NaN")
    frac = float(np.isfinite(m0).mean())
    log(f"  (a) mom0 finite fraction {frac:.3f}, statistics npts="
        f"{res['statistics']['npts']}; flagged planes NaN in the output")
    if not 0.05 < frac < 0.95:
        raise AssertionError("(a) outputs implausible")

    stages = {}
    for call in ("first", "second"):
        times = {}
        cb = timed(times, "common_beam", cube.common_beam)
        conv = timed(times, "convolve_to", lambda: cube.convolve_to(cb))
        noise = timed(times, "mad_std", lambda: float(conv.mad_std().value))
        masked = conv.with_mask(conv > T.Quantity(SNR * noise, conv.unit))
        mom = timed(times, "moments", masked._moments012)
        timed(times, "statistics", masked.statistics)
        timed(times, "reproject", lambda: masked._reproject(target))
        stages[call] = times
        log(f"  (a) stages, {call} call: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items()))
    # the FFT route's parts, each timed on its own
    vbeams = [b if g else cb for b, g in zip(cube.unmasked_beams,
                                            cube.goodbeams_mask)]
    pix = np.radians(PIX_ARCSEC / 3600.0)
    tr_times = {}
    groups, gidx = timed(tr_times, "grouping",
                         lambda: oc.beam_groups(vbeams))
    kernels = timed(tr_times, "kernels", lambda: [
        None if cb.deconvolve(b).major_rad <= 0
        else cb.deconvolve(b).as_kernel(pix) for b in groups])
    shapes = [k.shape for k in kernels if k is not None] or [(1, 1)]
    fy, fx = oc._padded_shape((NY, NX), tuple(np.max(shapes, axis=0)))
    transfers = timed(tr_times, "transfers", lambda: oc._transfers(
        kernels, fy, fx, dev))
    filled = cube._get_filled_data(fill=np.nan)
    timed(tr_times, "fft_convolution", lambda: oc._convolve_planes(
        filled, transfers, gidx))
    del transfers, filled
    # the rotated reprojection's parts: the host WCS maps, then the
    # four-corner gather on the card with its peak memory above the input
    src = masked._get_filled_data(fill=np.nan)
    zs, ysm, xsm, _ = timed(tr_times, "reproject_maps", lambda: (
        og.reproject_mappings(masked.wcs, target, NCHAN,
                              spectral_values_in=np.asarray(
                                  masked.spectral_axis.value))))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    timed(tr_times, "gather", lambda: og._bilinear_spatial_then_linear_z(
        src, zs, ysm, xsm, 1))
    gather_peak = torch.cuda.max_memory_allocated() - base
    del src
    log(f"  (a) rotated reprojection: host WCS maps "
        f"{tr_times['reproject_maps']:.1f} ms, four-corner gather on the "
        f"card {tr_times['gather']:.1f} ms, its peak "
        f"{gather_peak / 2**30:.2f} GiB above its input "
        f"({gather_peak / (NCHAN * NY * NX * 4):.2f} cubes)")
    log(f"  (a) FFT route: beam grouping {tr_times['grouping']:.1f} ms, "
        f"{len(kernels)} kernels on the host {tr_times['kernels']:.1f} ms, "
        f"transfers {len(kernels)} x {fy} x {fx // 2 + 1} built on the card "
        f"{tr_times['transfers']:.1f} ms (float64 rfft2, cast), batched "
        f"rfft2/irfft2 convolution {tr_times['fft_convolution']:.1f} ms")
    include = masked.mask.include(data=masked._data)
    pm = om.moments_012(masked._data, masked._spectral_offsets(),
                        masked._spectral_pix_size(), include=include)
    del include
    sv0 = float(np.asarray(masked.spectral_axis.value)[0])
    for i, (a, b) in enumerate(zip(mom, pm)):
        compare(f"(a) moment{i} vs plain expression", torch.as_tensor(a),
                (b + sv0 if i == 1 else b).cpu(), 3e-6 if i < 2 else 5e-5)
    compare("(a) stage moment0 vs run_pipeline", torch.as_tensor(mom[0]),
            torch.as_tensor(m0), 1e-6)
    out["a"] = dict(first=first, second=second, peak=peak, counts=counts,
                    route=last, stages=stages, fft_parts=tr_times,
                    gather_peak=gather_peak)
    del res, rep, conv, masked, cube, pm
    torch.cuda.empty_cache()

    # (b): the per-channel separable route, 12" circular target
    cube = T.SpectralCube.read(path_b)
    _, target_beam = beams()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    times = {}
    conv = timed(times, "first", lambda: cube.convolve_to(target_beam))
    counts_b = K.launch_counts()
    peak_b = torch.cuda.max_memory_allocated()
    last = dict(oc.convolve_cube_to_beam.last)
    timed(times, "second", lambda: cube.convolve_to(target_beam))
    log(f"  (b) convolve_to 12\": {times['first']:.1f} ms first call, "
        f"{times['second']:.1f} ms second, peak {peak_b / 2**30:.2f} GiB, "
        f"route {last['route']}, {last['groups']} beam groups, host "
        f"grouping {last['grouping_s'] * 1e3:.1f} ms, kernels and SVDs "
        f"{last['kernels_s'] * 1e3:.1f} ms, launches {counts_b}")
    ngroups = -(-NCHAN // VR_GROUP)
    if last["route"] != "per_channel_separable" \
            or last["groups"] != ngroups or counts_b["conv_sep"] <= 0:
        raise AssertionError(f"(b) route {last}, counts {counts_b}")
    ytaps, xtaps, gidx = [], [], np.zeros(NCHAN, np.int32)
    for g in range(ngroups):
        b = cube.unmasked_beams[g * VR_GROUP]
        yt, xt = oc.separable_factors(target_beam.deconvolve(b).as_kernel(
            pix), max_rank=4)
        ytaps.append(yt)
        xtaps.append(xt)
        gidx[g * VR_GROUP:(g + 1) * VR_GROUP] = g
    ys, hy = oc._tap_stack(ytaps)
    xs, hx = oc._tap_stack(xtaps)
    ys, xs = torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev)
    gi = torch.as_tensor(gidx, device=dev)
    filled = cube._get_filled_data(fill=np.nan)
    plain = kc.conv_sep_plain(filled, ys, xs, hy, hx, gi)
    factors = torch.as_tensor([oc.beam_unit_factor(cube.unit, b, target_beam)
                               for b in cube.unmasked_beams],
                              dtype=torch.float32, device=dev)
    plain *= factors[:, None, None]
    compare_conv("(b) convolve_to vs conv_sep_plain", conv._data, plain,
                 filled, ys, xs, hy, hx, 1e-5)
    out["b"] = dict(first=times["first"], second=times["second"],
                    peak=peak_b, counts=counts_b, route=last)
    del plain, filled, conv, cube
    torch.cuda.empty_cache()
    return out


class _Refused:
    """Stands in for a plain version that must not run."""

    def __init__(self, name):
        self.name = name

    def __call__(self, *args, **kwargs):
        raise AssertionError(f"{self.name}, the plain version, ran on a "
                             "path that must take the kernel")


def phase_cube_api(dev, workdir):
    """The cube's everyday API at 623 x 768 x 768 on the pipeline phase's
    FITS file and the varying-resolution phase's file (a), nothing cut.
    Returns (step times of the second call in ms, peak device memory,
    the spatial cut's copy time in ms, moments launches per step)."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch import units as u
    from spectral_cube_tpu_torch.kernels import moments as km
    from spectral_cube_tpu_torch.masks import fused_predicate
    from spectral_cube_tpu_torch.ops import moments as om
    from spectral_cube_tpu_torch.ops import reductions as rd
    from spectral_cube_tpu_torch.wcs import WCS
    log("phase cube API")
    times, launches = {}, {}

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return val

    def counted(name, fn):
        """``fn`` once with the counters at 0 before and the plain
        moments versions refused; the moments launches after."""
        K.reset_launch_counts()
        saved = km.moments_planes_plain, om.moments_012
        km.moments_planes_plain = _Refused("moments_planes_plain")
        om.moments_012 = _Refused("ops.moments.moments_012")
        try:
            val = fn()
        finally:
            km.moments_planes_plain, om.moments_012 = saved
        launches[name] = K.launch_counts()["moments"]
        if launches[name] < 1:
            raise AssertionError(f"{name}: the moments kernel never ran")
        return val

    def moments(c):
        return tuple(np.asarray(m.value) for m in
                     (c.moment0(), c.moment1(), c.moment2()))

    cube = T.SpectralCube.read(os.path.join(workdir, "cube.fits"))
    if cube.device.type != "cuda" or cube.shape != (NCHAN, NY, NX):
        raise AssertionError(f"read without a device gave {cube!r}")
    cube.allow_huge_operations = True
    x = cube._data
    fin = torch.isfinite(x)
    torch.cuda.reset_peak_memory_stats()

    # 1. the spectral axis, both ways; the cards as a small CPU cube's
    vc, fc = timed("with_spectral_unit", lambda: (
        cube.with_spectral_unit(u.km_s),
        cube.with_spectral_unit(u.GHz, velocity_convention="radio")))
    small = T.SpectralCube(np.zeros((NCHAN, 2, 2), np.float32),
                           WCS(header=synth_header(NCHAN, NY, NX)),
                           device="cpu")
    for got, unit, conv in ((vc, u.km_s, None), (fc, u.GHz, "radio")):
        want = small.with_spectral_unit(unit, velocity_convention=conv)
        if got.wcs.to_header() != want.wcs.to_header():
            raise AssertionError(f"{unit} WCS cards differ from the CPU's")
    sv = np.asarray(cube.spectral_axis.value)
    back = np.asarray(fc.with_spectral_unit(
        u.m_s, velocity_convention="radio").spectral_axis.value)
    kms = np.asarray(vc.spectral_axis.value) * 1e3
    err = max(np.abs(back - sv).max(), np.abs(kms - sv).max()) \
        / np.abs(sv).max()
    log(f"  spectral axis m/s -> GHz -> m/s and km/s: max rel err "
        f"{err:.2e} (tol 1e-10)")
    if err > 1e-10:
        raise AssertionError("spectral axis conversion")

    # 2. a velocity slab, cut spatially, masked at 3 sigma; its moments
    # through the kernel against the same crop of the whole slab's
    lo, hi = API_SLAB
    svk = vc.spectral_axis
    xlo, xhi, ylo, yhi = API_CUT

    def cut():
        slab = vc.spectral_slab(svk[lo], svk[hi])
        return slab, slab.subcube(xlo=xlo, xhi=xhi, ylo=ylo, yhi=yhi)

    slab, sub = timed("spectral_slab + subcube", cut)
    if slab.shape != (hi - lo + 1, NY, NX) \
            or slab._data.data_ptr() != x[lo].data_ptr() \
            or sub.shape != (hi - lo + 1, yhi - ylo, xhi - xlo) \
            or not sub._data.is_contiguous():
        raise AssertionError(f"slab {slab.shape}, subcube {sub.shape}")
    copy_ms = cuda_ms(lambda: slab._data[:, ylo:yhi, xlo:xhi].contiguous(),
                      10)
    copy_bytes = 2 * sub._data.numel() * 4
    log(f"  spatial cut {sub.shape}: copy {copy_ms:.3f} ms "
        f"({copy_bytes / copy_ms / 1e6:.0f} GB/s read + written)")
    sigma = float(cube.mad_std().value)
    thr = T.Quantity(SNR * sigma, cube.unit)
    masked_sub = sub.with_mask(sub > thr)
    if fused_predicate(masked_sub.mask) is None:
        raise AssertionError("the subcube's mask is not fused")
    msub = counted("subcube moments", lambda: moments(masked_sub))
    timed("mask + moments (subcube)",
          lambda: counted("subcube moments",
                          lambda: moments(sub.with_mask(sub > thr))))
    whole = vc[lo:hi + 1]
    mslab = moments(whole.with_mask(whole > thr))
    for i, (a, b) in enumerate(zip(msub, mslab)):
        compare(f"subcube moment{i} vs the slab's crop", torch.as_tensor(a),
                torch.as_tensor(b[ylo:yhi, xlo:xhi]), 1e-6)
    del slab, sub, masked_sub, whole, mslab

    # 3. the reversed cube's moment 1
    masked = cube.with_mask(cube > thr)
    fwd = masked.moment1().value
    rev = timed("cube[::-1] + moment1",
                lambda: counted("reversed moments",
                                lambda: masked[::-1].moment1().value))
    compare("cube[::-1] moment1 vs forward", torch.as_tensor(rev),
            torch.as_tensor(fwd), 1e-6)

    # 4. brightness units and arithmetic
    kc, kb = timed("to(K) and back", lambda: (
        lambda k: (k, k.to(cube.unit)))(cube.to(u.K)))
    if kc.unit != u.K or kb._data.dtype != torch.float32:
        raise AssertionError("to(K)")
    nz = fin & (x != 0)
    rel = float(((kb._data - x).abs()[nz] / x.abs()[nz]).max())
    c = (NCHAN // 2, NY // 2, NX // 2)
    log(f"  to(K) and back: max rel err {rel:.2e} (tol 1e-6), K factor "
        f"{float(kc._data[c] / x[c]):.6g}")
    if rel > 1e-6 or not torch.equal(torch.isnan(kb._data), ~fin):
        raise AssertionError("to(K) and back")
    del kc, kb
    diff = timed("cube - cube", lambda: cube - cube)
    if not bool((diff._data[fin] == 0).all()) \
            or not bool(torch.isnan(diff._data[~fin]).all()):
        raise AssertionError("cube - cube is not zero where finite")
    del diff
    twice = timed("(cube * 2) / 2", lambda: (cube * 2) / 2)
    if not torch.equal(twice._data[fin], x[fin]) \
            or not bool(torch.isnan(twice._data[~fin]).all()):
        raise AssertionError("(cube * 2) / 2 is not the input")
    del twice
    am = timed("argmax(axis=0)", lambda: cube.argmax(axis=0))
    amw = timed("argmax_world(axis=0)", lambda: cube.argmax_world(axis=0))
    host = x.cpu().numpy().astype(np.float64)
    ok = np.isfinite(host)
    idx = np.where(ok, host, -np.inf).argmax(axis=0)
    any_ok = ok.any(axis=0)
    del host, ok
    world = sv[idx]
    world[~any_ok] = np.nan
    if not np.array_equal(am, idx) \
            or not np.array_equal(np.asarray(amw.value), world,
                                  equal_nan=True):
        raise AssertionError("argmax / argmax_world differ from numpy")
    log(f"  argmax(axis=0), argmax_world(axis=0): equal to numpy's "
        f"float64 argmax ({int((~any_ok).sum())} spaxels without data)")
    ties = torch.tensor([[1.0, 3.0, 3.0, 2.0], [np.nan] * 4, [5.0] * 4,
                         [-np.inf, 2.0, np.nan, 2.0], [np.inf, np.inf, 1.0,
                                                      np.inf]]).T
    for fn in (rd.masked_argmax, rd.masked_argmin):
        for axis in (0, 1):
            a = fn(ties, torch.isfinite(ties), axis=axis)
            b = fn(ties.to(dev), torch.isfinite(ties).to(dev), axis=axis)
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"{fn.__name__} card {b} vs CPU {a}")
    log("  masked_argmax/argmin on ties and all -inf: card equals CPU")

    # 5. results of lower dimension
    spec = timed("cube[:, y, x]", lambda: cube[:, NY // 2, NX // 2])
    plane = timed("cube[c]", lambda: cube[API_PLANE])
    mini = timed("minimal_subcube", masked.minimal_subcube)
    if not isinstance(spec, T.OneDSpectrum) \
            or not isinstance(plane, T.Slice) \
            or not isinstance(mini, T.SpectralCube) \
            or not np.array_equal(spec.value,
                                  x[:, NY // 2, NX // 2].cpu().numpy(),
                                  equal_nan=True) \
            or not np.array_equal(plane.value, x[API_PLANE].cpu().numpy(),
                                  equal_nan=True) \
            or int(mini._valid_view().sum()) \
            != int(masked._valid_view().sum()):
        raise AssertionError("spectrum, channel map or minimal_subcube")
    log(f"  minimal_subcube of the 3 sigma mask: {mini.shape}")
    del mini, masked

    # 6. a cut of the varying-resolution cube
    vr = T.SpectralCube.read(os.path.join(workdir, "vr_a.fits"))
    vr.allow_huge_operations = True
    vlo, vhi = API_VR_CUT
    vcut = timed(f"VRSC[{vlo}:{vhi}]", lambda: vr[vlo:vhi])
    mj = vr.unmasked_beams.major.value
    if not isinstance(vcut, T.VaryingResolutionSpectralCube) \
            or not np.array_equal(vcut.unmasked_beams.major.value,
                                  mj[vlo:vhi], equal_nan=True) \
            or not np.array_equal(vcut.goodbeams_mask,
                                  vr.goodbeams_mask[vlo:vhi]):
        raise AssertionError("the beams were not cut with the data")
    jt = timed("jtok_factors", vcut.jtok_factors)
    if not np.array_equal(jt, vr.jtok_factors()[vlo:vhi], equal_nan=True):
        raise AssertionError("jtok_factors of the cut")
    kv = timed("VRSC to(K)", lambda: vcut.to(u.K))
    # a flagged plane's NaN beam gives a NaN factor, as in the JAX package
    want = vcut._data * torch.as_tensor(jt, dtype=torch.float32,
                                        device=dev)[:, None, None]
    wfin = torch.isfinite(want) & (want != 0)
    rel = float(((kv._data - want).abs()[wfin] / want.abs()[wfin]).max())
    log(f"  VRSC to(K): per-channel factors {jt[2]:.6g}..{jt[-1]:.6g}, "
        f"max rel err {rel:.2e} (tol 1e-6)")
    if kv._data.dtype != torch.float32 or rel > 1e-6 or not torch.equal(
            torch.isfinite(kv._data), torch.isfinite(want)):
        raise AssertionError("per-channel to(K)")
    del kv, want, wfin
    # the beams of channels 100-399 differ by ~10% in area: the moments'
    # beam check is loosened as a user would; the 3 sigma mask keeps the
    # moment-1 denominators away from 0, where the plain float32
    # expression loses its digits
    vcut.beam_threshold = API_VR_THRESHOLD
    vthr = T.Quantity(SNR * float(vcut.mad_std().value), vcut.unit)
    vm = timed("VRSC cut moments", lambda: counted(
        "VRSC cut moments", lambda: moments(vcut.with_mask(vcut > vthr))))
    vmasked = vcut.with_mask(vcut > vthr)
    include = vmasked.mask.include(data=vcut._data)
    pm = om.moments_012(vcut._data, vcut._spectral_offsets(),
                        vcut._spectral_pix_size(), include=include)
    sv0 = float(vcut.spectral_axis.value[0])
    for i, (a, b) in enumerate(zip(vm, pm)):
        compare(f"VRSC cut moment{i} vs plain expression",
                torch.as_tensor(a), (b + sv0 if i == 1 else b).cpu(),
                3e-6 if i < 2 else 5e-5)
    del vr, vcut, vmasked, include, pm

    # 7. a Stokes cube of four cubes made on the card
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)

    def component(data):
        return T.SpectralCube(data, cube.wcs, header=cube._header,
                              mask=T.LazyMask(torch.isfinite, data=data,
                                              wcs=cube.wcs),
                              allow_huge_operations=True)

    comps = {"I": component(x)}
    for name, scale in (("Q", 0.2), ("U", 0.1), ("V", 0.05)):
        comps[name] = component(scale * x + torch.randn(
            x.shape, generator=gen, device=dev))
    st = T.StokesSpectralCube(comps)
    lin = timed("transform_basis Linear", lambda: st.transform_basis(
        "Linear"))
    sky = timed("transform_basis Sky", lambda: lin.transform_basis("Sky"))
    for name in "IQUV":
        compare(f"Stokes {name}: Sky(Linear(x)) vs x / 2", sky[name]._data,
                0.5 * st[name]._data, 1e-6)
    del lin, sky
    m0 = counted("stokes.I.moment0()", lambda: st.I.moment0())
    compare("stokes.I.moment0() vs the cube's", torch.as_tensor(m0.value),
            torch.as_tensor(cube.moment0().value), 0.0)
    common = st.with_mask(T.LazyMask(torch.isfinite, data=x))
    timed("stokes.I.moment0()", lambda: counted(
        "stokes.I.moment0()", lambda: common.I.moment0()))
    part = st[:API_STOKES_NCHAN]
    path = os.path.join(workdir, "iquv.fits")

    def roundtrip():
        part.write(path, overwrite=True)
        return T.StokesSpectralCube.read(path)

    rt = timed(f"Stokes FITS write + read (4 x {API_STOKES_NCHAN} ch)",
               roundtrip)
    for name in "IQUV":
        got, want = rt[name]._data, part[name]._get_filled_data()
        nan = torch.isnan(want)
        if got.device.type != "cuda" \
                or not torch.equal(torch.isnan(got), nan) \
                or not torch.equal(got[~nan], want[~nan]):
            raise AssertionError(f"Stokes FITS round trip, {name}")
    log(f"  Stokes FITS round trip ({os.path.getsize(path) / 2**20:.0f} "
        "MiB): bitwise equal")
    peak = torch.cuda.max_memory_allocated()
    del rt, part, common, st, comps, cube, vc, fc, x, fin
    torch.cuda.empty_cache()
    for name, ms in times.items():
        log(f"  step {name}: {ms:.1f} ms")
    return times, peak, copy_ms, launches


def spline_stack_surface(header):
    """The synthetic line's centre velocity at each spaxel (m/s):
    ``synth_cube`` puts it at channel nchan/2 + 0.15 nchan (x - nx/2)/nx,
    and the spectral axis starts at CRVAL3 (CRPIX3 = 1) in steps of
    CDELT3."""
    nchan, ny, nx = (int(header[k]) for k in ("NAXIS3", "NAXIS2",
                                              "NAXIS1"))
    rx = (np.arange(nx, dtype=np.float64) - nx / 2) / nx
    centre = nchan / 2 + 0.15 * nchan * rx
    vel = float(header["CRVAL3"]) + centre * float(header["CDELT3"])
    return np.broadcast_to(vel[None, :], (ny, nx)).copy()


def mosaic_header(header, dx, dy):
    """The pipeline grid widened by ``dx`` columns on the left, so that it
    holds the cube and its copy shifted by (dx, dy) pixel on one
    projection: both map onto it by a translation."""
    t = header.__class__(header)
    t["NAXIS1"] = int(header["NAXIS1"]) + int(dx)
    t["CRPIX1"] = float(header["CRPIX1"]) + dx
    return t


def nan_flips_within(name, got, want, frac):
    """Card against CPU where a NaN test sits on float32 rounding (a
    weight against 1e-6): NaN patterns may differ in at most ``frac`` of
    the samples, and the values both have agree to 1e-5 of the largest."""
    import torch
    got, want = got.cpu().float(), want.cpu().float()
    flips = int((torch.isnan(got) != torch.isnan(want)).sum())
    both = ~torch.isnan(got) & ~torch.isnan(want)
    err = float((got[both] - want[both]).abs().max())
    scale = float(want[both].abs().max())
    log(f"  {name}: {flips} NaN flips of {want.numel()}, max_abs_err "
        f"{err:.3e} (scale {scale:.3e}, tol 1e-5)")
    if flips > frac * want.numel() or err > 1e-5 * scale:
        raise AssertionError(f"{name}: card and CPU differ")


def phase_spline_transforms(dev, workdir, results):
    """Spline reprojection, a mosaic, the transform engine and stacking on
    the pipeline phase's FITS file (623 x 768 x 768, its NaN cutoff) and
    the varying-resolution file (a).  Returns a dict of step times (ms),
    launch counts of the path steps, peaks and logged facts."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import cube_utils as cu
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.analysis_utilities import (
        _fourier_shift_batch as fourier_batch, stack_cube, stack_spectra)
    from spectral_cube_tpu_torch.cube import _vmapped
    from spectral_cube_tpu_torch.kernels import banded_matmul as kb
    from spectral_cube_tpu_torch.ops import convolve as oc
    from spectral_cube_tpu_torch.ops import regrid as og
    from spectral_cube_tpu_torch.ops.smoothing import gaussian_kernel1d
    from spectral_cube_tpu_torch.utils import ieee_fp32
    from spectral_cube_tpu_torch.wcs import WCS
    log("phase spline reprojection, mosaic, transform engine, stacking")
    times, counts, peaks = {}, {}, {}
    nan = float("nan")

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return val

    def path(name, fn):
        """``fn`` with every counter at 0 before and the peak reset; the
        counts and the peak after."""
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        val = timed(name, fn)
        counts[name] = K.launch_counts()
        peaks[name] = torch.cuda.max_memory_allocated()
        return val

    def same(name, got, want):
        """Bitwise equal, NaN for NaN."""
        if got.shape != want.shape or not torch.equal(
                torch.isnan(got), torch.isnan(want)) or not torch.equal(
                torch.nan_to_num(got), torch.nan_to_num(want)):
            raise AssertionError(f"{name}: not bitwise equal")
        log(f"  {name}: bitwise equal")

    cube = T.SpectralCube.read(os.path.join(workdir, "cube.fits"))
    if cube.device.type != "cuda" or cube.shape != (NCHAN, NY, NX):
        raise AssertionError(f"read without a device gave {cube!r}")
    cube.allow_huge_operations = True
    header = cube.header
    sv = np.asarray(cube.spectral_axis.value)
    S = NY * NX

    # (a) bicubic onto a new spectral axis: #14 on tz and |tz|, then the
    # separable spatial products
    target = spectral_target(header)
    nz = SPECTRAL_TARGET[0]
    og._SPLINE_OPS.clear()
    rep = path("a reproject bicubic", lambda: cube.reproject(
        target, order="bicubic"))
    ca = counts["a reproject bicubic"]
    log(f"  (a) bicubic onto {nz} channels: "
        f"{times['a reproject bicubic']:.1f} ms first call, peak "
        f"{peaks['a reproject bicubic'] / 2**30:.2f} GiB, banded_matmul "
        f"launches {ca['banded_matmul']}, spectral route "
        f"{og._spectral_product.last}, declined plans "
        f"{og._spectral_product.declined}")
    if ca["banded_matmul"] != 2 or og._spectral_product.last != \
            "banded_matmul":
        raise AssertionError(f"the spline operator missed #14: {ca}")
    timed("a reproject bicubic (second call)", lambda: cube.reproject(
        target, order="bicubic"))
    if rep.shape != (nz, NY, NX):
        raise AssertionError(f"bicubic reproject shape {rep.shape}")
    frac = float(torch.isfinite(rep._data).float().mean())
    log(f"  finite fraction {frac:.3f}")
    if not 0.5 < frac < 0.75:
        raise AssertionError("bicubic reproject output implausible")

    # the same run in stages (host operators rebuilt; #14's step tables
    # stay cached on the card from the call above)
    src = cube._get_filled_data(fill=nan)
    zs, ys, xs, _ = og.reproject_mappings(cube.wcs, target, NCHAN,
                                          spectral_values_in=sv)
    zc = np.nan_to_num(zs)
    ycl, xcl = np.nan_to_num(ys), np.nan_to_num(xs)
    og._SPLINE_OPS.clear()

    def host_operators():
        tz = og._spline_1d_matrix(NCHAN, zc, 3)
        for M in (tz, np.abs(tz)):
            og._spectral_route(M)
        og._spline_1d_matrix(NY, ycl[:, 0], 3)
        og._spline_1d_matrix(NX, xcl[0, :], 3)
        return tz

    tz = timed("a host operators", host_operators)
    filled = torch.nan_to_num(src)
    nanmask = torch.isnan(src).to(torch.float32)
    fz, wz = timed("a banded_matmul (tz, |tz|)", lambda: (
        og._spectral_product(tz, filled),
        og._spectral_product(np.abs(tz), nanmask)))
    out, wn = timed("a spatial matmuls", lambda:
                    og._spline_separable_resample(fz, wz, ycl, xcl, 3))
    del fz, wz

    def poison():
        out.masked_fill_(wn > 1e-6, nan)
        yv = np.isfinite(ys) & (ys >= -1e-3) & (ys <= NY - 1 + 1e-3)
        xv = np.isfinite(xs) & (xs >= -1e-3) & (xs <= NX - 1 + 1e-3)
        zv = np.isfinite(zs) & (zs >= -1e-3) & (zs <= NCHAN - 1 + 1e-3)
        valid = torch.as_tensor((yv & xv)[None], device=dev) \
            & torch.as_tensor(zv, device=dev)[:, None, None]
        return out.masked_fill_(~valid, nan)

    staged = timed("a poison + validity", poison)
    same("(a) reproject against its stages", rep._data, staged)
    del out, wn, staged, rep

    # #14 on the spline operator against its plain version, timed
    flat = filled.reshape(NCHAN, S)
    bands = kb.row_bands(tz)
    got = kb.banded_matmul(flat, bands)
    want = kb.banded_matmul_plain(flat, bands)
    err, _ = compare("banded_matmul vs plain (spline tz)", got, want, 1e-6)
    del got, want
    ms = cuda_ms(lambda: kb.banded_matmul(flat, bands), 7)
    prep = kb.prepare(flat, bands)
    lms = cuda_ms(lambda: kb.launch(flat, prep), 7)
    pms = cuda_ms(lambda: kb.banded_matmul_plain(flat, bands), 3)
    Mt = torch.as_tensor(tz, device=dev)
    with ieee_fp32():
        lib_ms = cuda_ms(lambda: torch.matmul(Mt, flat), 5)
    bms, by = bound((NCHAN + nz) * S * 4, 2 * int(bands.length.sum()) * S)
    log(f"  banded_matmul {nz}x{NCHAN} spline operator (bands "
        f"{int(bands.length.min())}-{int(bands.length.max())}) on {S} "
        f"columns: kernel {ms:.3f} ms (launch alone {lms:.3f} ms), plain "
        f"{pms:.3f} ms, torch.matmul (IEEE fp32) {lib_ms:.3f} ms, bound "
        f"{bms:.3f} ms ({by}), plan {prep.packed.plan}")
    results["banded_matmul"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                    bound_ms=bms, bound_by=by,
                                    library_ms=lib_ms, launch_ms=lms)
    del flat, Mt, prep

    # (b) biquadratic onto the rotated grid: prefilter, 9 tap gathers,
    # the poison pass
    target_b = rotated_header(header, VR_ROTATION)
    rep = path("b reproject biquadratic rotated", lambda: cube.reproject(
        target_b, order="biquadratic"))
    log(f"  (b) biquadratic onto the grid rotated by {VR_ROTATION} deg: "
        f"{times['b reproject biquadratic rotated']:.1f} ms first call, "
        f"peak {peaks['b reproject biquadratic rotated'] / 2**30:.2f} GiB")
    timed("b reproject biquadratic rotated (second call)",
          lambda: cube.reproject(target_b, order="biquadratic"))
    frac = float(torch.isfinite(rep._data).float().mean())
    log(f"  finite fraction {frac:.3f}")
    if rep.shape != (NCHAN, NY, NX) or not 0.5 < frac < 0.75:
        raise AssertionError(f"rotated spline output implausible: "
                             f"{rep.shape}, {frac:.3f}")
    _, ys, xs, _ = og.reproject_mappings(cube.wcs, target_b, NCHAN,
                                         spectral_values_in=sv)
    plan = timed("b host taps", lambda: og.spline_taps(ys, xs, 2, NY, NX,
                                                       dev))
    coeff = timed("b prefilter", lambda: og.spline_coefficients(
        filled, plan, False))
    acc = timed("b gathers (9 taps)", lambda: og.spline_gathers(
        coeff, plan, False))
    del coeff
    wn = timed("b poison pass", lambda: og.spline_gathers(
        og.spline_coefficients(nanmask, plan, True), plan, True))
    acc.masked_fill_(wn > 1e-6, nan)
    del wn
    staged = acc.t().reshape(NCHAN, NY, NX)
    yv = np.isfinite(ys) & (ys >= -1e-3) & (ys <= NY - 1 + 1e-3)
    xv = np.isfinite(xs) & (xs >= -1e-3) & (xs <= NX - 1 + 1e-3)
    staged = staged.masked_fill(~torch.as_tensor(yv & xv, device=dev), nan)
    same("(b) reproject against its stages", rep._data, staged)
    del acc, staged, rep, plan, filled, nanmask, src
    torch.cuda.empty_cache()

    # (c) a mosaic of the cube and its copy shifted by (200, 0.37) pixel
    h2 = shifted_header(header, *MOSAIC_SHIFT)
    cube2 = T.SpectralCube(cube._data, WCS(header=h2), header=h2)
    mh = mosaic_header(header, *MOSAIC_SHIFT)
    combined = cu.combine_headers(header, h2)
    log(f"  (c) combine_headers: {combined['NAXIS1']} x "
        f"{combined['NAXIS2']} on a new tangent point (not a translation "
        f"of the inputs: the gather); the mosaic uses the widened grid "
        f"{mh['NAXIS1']} x {mh['NAXIS2']}")
    mos = path("c mosaic_cubes", lambda: cu.mosaic_cubes(
        [cube, cube2], target_header=mh))
    cc = counts["c mosaic_cubes"]
    log(f"  mosaic_cubes: {times['c mosaic_cubes']:.1f} ms, peak "
        f"{peaks['c mosaic_cubes'] / 2**30:.2f} GiB, resample2 launches "
        f"{cc['resample2']}")
    if cc["resample2"] < 2:
        raise AssertionError(f"the mosaic missed resample2: {cc}")
    m0 = path("c moment0 of the mosaic", lambda: mos.moment0())
    if counts["c moment0 of the mosaic"]["moments"] < 1:
        raise AssertionError("the mosaic's moments missed the kernel")
    r1 = og.reproject_cube(cube._get_filled_data(fill=nan), cube.wcs, mh,
                           spectral_values_in=sv)[0]
    r2 = og.reproject_cube(cube2._get_filled_data(fill=nan), cube2.wcs, mh,
                           spectral_values_in=sv)[0]
    f1, f2 = torch.isfinite(r1), torch.isfinite(r2)
    both, only1 = f1 & f2, f1 & ~f2
    md = mos._data
    if not torch.equal(md[both], ((r1 + r2) / 2)[both]) \
            or not torch.equal(md[only1], r1[only1]) \
            or not bool(torch.isnan(md[~f1 & ~f2]).all()):
        raise AssertionError("the mosaic is not the mean of the "
                             "reprojections")
    log(f"  overlap ({int(both[0].sum())} pixels a plane) equals the mean "
        f"of the two reprojections bitwise")
    del r1, r2, f1, f2, both, only1, md
    dv = abs(float(header["CDELT3"]))
    s0 = torch.as_tensor(np.asarray(mos.sum(axis=0).value) * dv)
    compare("mosaic moment0 vs its sum x dv", torch.as_tensor(
        np.asarray(m0.value)), s0, 1e-5)
    del mos, m0, cube2
    torch.cuda.empty_cache()

    # (d) the transform engine
    def baseline(spec):
        return spec - torch.nan_to_num(spec[:APPLY_BASELINE]).mean()

    data = cube._get_filled_data(fill=nan)
    if _vmapped(baseline, data[:, :2, :2].reshape(NCHAN, 4), 1, 1) is None:
        raise AssertionError("the baseline function does not vmap")
    res = path("d apply_function_parallel_spectral",
               lambda: cube.apply_function_parallel_spectral(baseline))
    want = data - torch.nan_to_num(data[:APPLY_BASELINE]).mean(0,
                                                               keepdim=True)
    compare("apply_function_parallel_spectral vs direct", res._data, want,
            1e-6)
    res = path("d apply_function_parallel_spatial",
               lambda: cube.apply_function_parallel_spatial(
                   lambda img: torch.nan_to_num(img) * 2.0 + 1.0))
    same("apply_function_parallel_spatial vs direct", res._data,
         torch.nan_to_num(data) * 2.0 + 1.0)
    del res, want
    y0, y1 = APPLY_CUT
    sub = cube[:, y0:y1, y0:y1]
    got = timed("d apply_function(np.nanmax) 64x64", lambda:
                sub.apply_function(np.nanmax, axis=0))
    host = sub._data.cpu().numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.nanmax(host, axis=0)
    if not np.array_equal(got, want, equal_nan=True):
        raise AssertionError("apply_function differs from np.nanmax")
    log(f"  apply_function(np.nanmax, axis=0) on a {y1 - y0}x{y1 - y0} "
        f"cut: {times['d apply_function(np.nanmax) 64x64']:.1f} ms (the "
        f"host ray loop, the reference's own cost model), equal to "
        f"np.nanmax")
    spec = timed("d sum(axis=(1, 2))", lambda: cube.sum(axis=(1, 2)))
    if type(spec).__name__ != "OneDSpectrum" or spec.shape != (NCHAN,):
        raise AssertionError(f"sum over the sky gave {spec!r}")
    d64 = data.double()
    want = torch.where(torch.isfinite(d64), d64, 0.0).sum((1, 2))
    compare("sum(axis=(1, 2)) vs float64", torch.as_tensor(
        np.asarray(spec.value)), want.cpu(), 1e-5)
    del d64, want, data
    kern = gaussian_kernel1d(SMOOTH_STDDEV)
    plain = cube.spectral_smooth(kern)
    saved = path("d spectral_smooth(save_to_tmp_dir=True)",
                 lambda: cube.spectral_smooth(kern, save_to_tmp_dir=True))
    same("save_to_tmp_dir vs without", saved._data,
         plain._get_filled_data(fill=nan))
    ma = plain.moment0()
    mb = path("d moment0 of the stored result", lambda: saved.moment0())
    if counts["d moment0 of the stored result"]["moments"] < 1:
        raise AssertionError("the stored result's moments missed the "
                             "kernel")
    compare("moment0 of the stored result vs of the unstored",
            torch.as_tensor(np.asarray(mb.value)),
            torch.as_tensor(np.asarray(ma.value)), 1e-6)
    del plain, saved
    torch.cuda.empty_cache()

    # (e) stacking
    vel = spline_stack_surface(header)
    v0 = float(header["CRVAL3"]) + NCHAN / 2 * float(header["CDELT3"])
    st = path("e stack_spectra", lambda: stack_spectra(
        cube, T.Quantity(vel, "m/s"), v0=T.Quantity(v0, "m/s")))
    # its parts: the batched shift on the card, then the host's nanmean
    specs = cube._get_filled_data(fill=nan).permute(1, 2, 0).reshape(S, -1)
    shifts = torch.as_tensor(-(vel.ravel() - v0) / float(header["CDELT3"]),
                             dtype=torch.float32, device=dev)
    timed("e stack_spectra: the shifts on the card", lambda: fourier_batch(
        specs, shifts))
    del specs, shifts
    vals = np.asarray(st.value)
    svs = np.asarray(st.spectral_axis.value)
    peak_v = svs[np.nanargmax(vals)]
    log(f"  stack_spectra of {NY * NX} spectra: "
        f"{times['e stack_spectra']:.1f} ms, peak "
        f"{peaks['e stack_spectra'] / 2**30:.2f} GiB, {vals.size} "
        f"channels, peak {np.nanmax(vals):.3f} at {peak_v:.1f} m/s "
        f"(v0 {v0:.1f})")
    if abs(peak_v - v0) > abs(float(header["CDELT3"])) \
            or not np.nanmax(vals) > 0.5:
        raise AssertionError("the stacked line is not at v0")
    del cube
    torch.cuda.empty_cache()
    vr = T.SpectralCube.read(os.path.join(workdir, "vr_a.fits"))
    f0 = float(vr.header["RESTFRQ"])
    f1 = f0 * (1.0 + STACK_LINE_SHIFT / 299792.458)
    _, target_beam = beams()
    Q = T.Quantity
    sc = path("e stack_cube (VRSC, 2 lines)", lambda: stack_cube(
        vr, [Q(f0, "Hz"), Q(f1, "Hz")], vmin=Q(STACK_WINDOW[0], "km/s"),
        vmax=Q(STACK_WINDOW[1], "km/s"), convolve_beam=target_beam))
    route = oc.convolve_cube_to_beam.last
    frac = float(torch.isfinite(sc._data).float().mean())
    log(f"  stack_cube of two lines on the varying-resolution cube: "
        f"{times['e stack_cube (VRSC, 2 lines)']:.1f} ms, peak "
        f"{peaks['e stack_cube (VRSC, 2 lines)'] / 2**30:.2f} GiB, shape "
        f"{sc.shape}, convolve route {route['route']}, finite fraction "
        f"{frac:.3f}, launches {counts['e stack_cube (VRSC, 2 lines)']}")
    # the convolution fills the NaN cutoff (normalized convolution, as in
    # the JAX package), so most samples are finite
    if len(sc.meta["stacked_lines"]) != 2 or not frac > 0.4 \
            or abs(sc.beam.major_rad - target_beam.major_rad) > 1e-12:
        raise AssertionError("stack_cube output implausible")
    del vr, sc
    torch.cuda.empty_cache()

    # small inputs: the card against the CPU
    h = synth_header(48, 64, 72)
    small = add_holes(synth_cube(48, 64, 72, SEED + 11), SEED + 12)
    runs = {}
    for d in ("cpu", dev):
        c = T.SpectralCube(small, WCS(header=h), header=h, device=d)
        c = c.with_mask(T.LazyMask(torch.isfinite, cube=c))
        t = h.__class__(h)
        t["NAXIS3"], t["CDELT3"] = 23, float(h["CDELT3"]) * 2.0
        t["CRVAL3"] = float(h["CRVAL3"]) + 0.25 * float(h["CDELT3"])
        runs[str(d)] = (
            c.reproject(shifted_header(t, *SHIFT), order="bicubic")._data,
            c.reproject(rotated_header(h, VR_ROTATION),
                        order="biquadratic")._data,
            torch.as_tensor(np.asarray(stack_spectra(
                c, spline_stack_surface(h)).value)))
    for name, a, b in zip(("small bicubic", "small biquadratic rotated",
                           "small stack_spectra"), runs["cpu"],
                          runs[str(dev)]):
        nan_flips_within(name + " (card vs CPU)", b, a, 1e-3)
    return {"times": times, "counts": counts, "peaks": peaks}


def config2_operator(nchan):
    """bench config 2's composed operator (bench.py:205-211): a 17-tap
    Gaussian (sigma 2 channels), then every second channel; float64
    composition cast to float32."""
    from spectral_cube_tpu_torch.ops import interpolate as oi
    from spectral_cube_tpu_torch.ops import smoothing as osm
    coords = np.arange(nchan, dtype=np.float64)
    k = osm.gaussian_kernel1d(SMOOTH_STDDEV)
    M = (oi._interp_matrix(*oi.interp_weights(coords, coords[::2]), nchan)
         .astype(np.float64)
         @ osm._banded_conv_matrix(nchan, k / k.sum()).astype(np.float64))
    return M.astype(np.float32)


def phase_banded_matmul(dev, data, results):
    """Kernel banded_matmul (#14) at bench config 2's size: its operator
    on a 512 x 768 x 768 cube viewed as (512, 589824).  The JAX package
    calls #14 from no path, so its path here is its public function,
    ``banded_matmul_strips``, called as a user would."""
    import torch
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import banded_matmul as kb
    log("phase banded_matmul (kernel banded_matmul)")
    M = config2_operator(BM_NIN)
    bands = kb.row_bands(M)
    x = torch.nan_to_num(data[:BM_NIN], nan=0.0).reshape(BM_NIN, -1)
    S = x.shape[1]
    K.reset_launch_counts()
    torch.cuda.synchronize()
    got = kb.banded_matmul_strips(M, x)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    log(f"  banded_matmul_strips({M.shape[0]}x{M.shape[1]} operator, "
        f"{BM_NIN}x{S}): launches {counts}")
    if got is None or counts["banded_matmul"] <= 0:
        raise AssertionError(f"banded_matmul never ran: {counts}")
    want = kb.banded_matmul_plain(x, bands)
    err, _ = compare("banded_matmul vs plain (finite)", got, want, 2e-6)
    Mt = torch.as_tensor(M, device=dev)
    dense = torch.matmul(Mt, x)
    compare("banded_matmul vs torch.matmul (finite)", got, dense, 2e-6)
    del got, want, dense
    raw = data[:BM_NIN].reshape(BM_NIN, -1)
    compare("banded_matmul vs plain (NaN border)", kb.banded_matmul(
        raw, bands), kb.banded_matmul_plain(raw, bands), 2e-6)
    del raw
    ms = cuda_ms(lambda: kb.banded_matmul(x, bands), 7)
    # the launch alone, its step tables already on the card
    prep = kb.prepare(x, bands)
    lms = cuda_ms(lambda: kb.launch(x, prep), 7)
    pms = cuda_ms(lambda: kb.banded_matmul_plain(x, bands), 3)
    lib_ms = cuda_ms(lambda: torch.matmul(Mt, x), 5)
    # each input read once, each output written once; 2 flops per tap of
    # each row's band per column
    bms, by = bound((BM_NIN + M.shape[0]) * S * 4,
                    2 * int(bands.length.sum()) * S)
    log(f"  banded_matmul {M.shape[0]}x{BM_NIN} on {S} columns: kernel "
        f"{ms:.3f} ms (launch alone {lms:.3f} ms), plain {pms:.3f} ms, "
        f"torch.matmul {lib_ms:.3f} ms, bound {bms:.3f} ms ({by}), plan "
        f"{prep.packed.plan}")
    # the kernels line carries #14 at the spline path's operator
    # (phase_spline_transforms); bench config 2's numbers are logged
    results["banded_matmul_config2"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms, launch_ms=lms)
    del x, Mt
    torch.cuda.empty_cache()
    return counts


def io_header(nchan, ny, nx):
    """The pipeline's header with a frequency axis in Hz and the celestial
    cards a CASA image keeps (FK5, equinox, poles), so that a cube written
    as a CASA image reads back with the same WCS cards as its FITS file."""
    h = synth_header(nchan, ny, nx)
    rest = float(h["RESTFRQ"])
    h["CTYPE3"], h["CUNIT3"] = "FREQ", "Hz"
    h["CRVAL3"] = rest * (1.0 - float(h["CRVAL3"]) / 299792458.0)
    h["CDELT3"] = -rest * float(h["CDELT3"]) / 299792458.0
    h["RADESYS"], h["EQUINOX"] = "FK5", 2000.0
    h["LONPOLE"], h["LATPOLE"] = 180.0, float(h["CRVAL2"])
    return h


def lmv_bytes_header(shape, bval, ref_deg, pix_arcsec, velocity):
    """The two 512-byte header blocks of a little-endian GILDAS type-2
    (version 20) .lmv cube of ``shape`` (nchan, ny, nx): a SIN projection
    centred on ``ref_deg`` (RA, Dec in deg) at the cube's centre pixel,
    ``pix_arcsec`` pixels, a VELOCITY axis (start, step in km/s), blanking
    value ``bval``, and the spectroscopy and resolution sections.  The
    field walk is that of ``io/class_lmv._read_type2``."""
    import struct
    nchan, ny, nx = shape
    out = bytearray(1024)

    def put(off, fmt, *vals):
        struct.pack_into("<" + fmt, out, off, *vals)
        return off + struct.calcsize("<" + fmt)

    rad = np.pi / 180.0
    inc = pix_arcsec / 3600.0 * rad
    out[0:12] = b"GILDAS<IMAGE"
    o = put(12, "iqiiiiii", 0, 1, 2, 0, 20, 0, 0, 0)
    o = put(64, "iiii", 0, 0, 7, 3)
    o = put(o, "7q", nx, ny, nchan, 0, 0, 0, 0)
    o = put(o, "ii", 0, 0)
    o = put(o, "ff", bval, 0.0)
    o = put(o, "ii", 0, 0)
    o = put(o, "2f", 0.0, 1.0)
    o = put(o, "2q", 0, 0)
    o = put(o, "ii", 0, 0)
    conv = [nx / 2 + 0.5, 0.0, -inc, ny / 2 + 0.5, 0.0, inc,
            1.0, velocity[0], velocity[1]]
    o = put(o, "21d", *(conv + [0.0] * 12))
    o = put(o, "ii", 0, 0)
    for text in ["Jy/beam", "RA", "DEC", "VELOCITY", "", "", "", ""]:
        out[o:o + 12] = text.ljust(12).encode("ascii")
        o += 12
    o = put(512, "ii", 0, 0)
    out[o:o + 24] = b"SYNTH       EQUATORIAL  "
    o += 24
    o = put(o, "2d", ref_deg[0] * rad, ref_deg[1] * rad)
    o = put(o, "2d", 0.0, 0.0)
    o = put(o, "f", 2000.0)
    o = put(o, "ii", 9, 0)
    o = put(o, "3d", ref_deg[0] * rad, ref_deg[1] * rad, 0.0)
    o = put(o, "3i", 2, 1, 2)                       # SIN, x axis 1, y 2
    o = put(o, "ii", 14, 0)
    o = put(o, "ddd", -0.19, 230538.0, 230538.0)    # MHz
    o = put(o, "fff", velocity[1], 0.0, 1.0)
    o = put(o, "i", 3)
    out[o:o + 12] = b"CO(2-1)     "
    o = put(o + 12, "i", 1)
    o = put(o, "ii", 3, 0)
    o = put(o, "3f", CUBE_BEAM[0] / 3600.0 * rad, CUBE_BEAM[1] / 3600.0 * rad,
            CUBE_BEAM[2] * rad)
    put(o, "ii", 0, 0)
    return bytes(out)


def write_lmv(path, data, **header):
    """``data`` (nchan, ny, nx float32, NaN blanked) as a type-2 .lmv file:
    the header blocks, then the data in FITS order with NaN as the
    blanking value, written a channel at a time."""
    bval = -1000.0
    with open(path, "wb") as fh:
        fh.write(lmv_bytes_header(data.shape, bval, **header))
        for plane in data:
            fh.write(np.where(np.isnan(plane), np.float32(bval),
                              plane).astype("<f4").tobytes())


def bits_equal(a, b):
    """Two float32 tensors are the same bits (the NaN pattern included)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def phase_io_regions(dev, workdir):
    """CASA images written and read back at the full size (one tile and a
    CASA tiling), the FITS file beside them, an appended SNR mask, a
    varying-resolution image with 623 per-plane beams, an IQUV image, a
    CLASS .lmv cube, then DS9 and CRTF region cuts of the cube read from
    the CASA image and ``run_pipeline`` on the DS9 cut, held against the
    same cut of the FITS read."""
    import resource
    import shutil
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.io import _detect_format
    from spectral_cube_tpu_torch.io import native
    from spectral_cube_tpu_torch.io.casa_low import read_casa_image_parts
    from spectral_cube_tpu_torch.io.casa_masks import make_casa_mask
    from spectral_cube_tpu_torch.io.casa_writer import write_casa_image
    from spectral_cube_tpu_torch.masks import LazyMask
    from spectral_cube_tpu_torch.region import (parse_ds9_region,
                                                parse_crtf_region,
                                                region_to_mask)
    from spectral_cube_tpu_torch.units import Quantity
    log("phase io and regions")
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return val

    def check(name, ok):
        if not ok:
            raise AssertionError(f"io and regions: {name}")
        log(f"  {name}: ok")

    torch.cuda.reset_peak_memory_stats()
    data = synth_cube(NCHAN, NY, NX, IO_SEED)
    add_holes(data, IO_SEED)
    header = io_header(NCHAN, NY, NX)
    wcs = T.WCS(header=header)
    x = torch.as_tensor(data, device=dev)
    src = T.SpectralCube(x, wcs, mask=LazyMask(torch.isfinite, data=x,
                                               wcs=wcs),
                         header=header, allow_huge_operations=True)
    src_include = src.mask.include(data=x)
    log(f"  source {src} ({float(src_include.float().mean()):.3f} "
        f"included); C++ tile assembler: {native.native_available()}")

    # 1. CASA images (one tile, then a CASA tiling) and the FITS file,
    # each read back with its format detected
    paths = {"single": os.path.join(workdir, "io.image"),
             "tiled": os.path.join(workdir, "io_tiled.image"),
             "fits": os.path.join(workdir, "io.fits")}
    timed("write CASA, one tile", lambda: src.write(paths["single"]))
    timed("write CASA, tiled", lambda: write_casa_image(
        src, paths["tiled"], tile_shape=IO_TILE))
    timed("write FITS", lambda: src.write(paths["fits"]))
    parts = timed("read CASA tiled: parse", lambda: read_casa_image_parts(
        paths["tiled"]))
    timed("read CASA tiled: upload", lambda: torch.as_tensor(
        np.ascontiguousarray(parts[0][:, 0]), device=dev))
    del parts
    cubes = {}
    for kind, path in paths.items():
        cube = timed(f"read {kind}", lambda: T.SpectralCube.read(path))
        log(f"  {kind}: format {_detect_format(path)}, {cube.device}, "
            f"{cube}")
        check(f"{kind} read lands on the card", cube.device.type == "cuda")
        check(f"{kind} data bitwise", bits_equal(cube._data, x))
        check(f"{kind} include mask", torch.equal(
            cube.mask.include(data=cube._data), src_include))
        check(f"{kind} unit", cube.unit == src.unit)
        rel = max(abs(getattr(cube.beam, a).to_value("deg")
                      / getattr(src.beam, a).to_value("deg") - 1.0)
                  for a in ("major", "minor", "pa"))
        check(f"{kind} beam within {rel:.1e} (1e-12)", rel < 1e-12)
        cubes[kind] = cube
    for kind in ("single", "tiled"):
        check(f"{kind} WCS cards as the FITS read's",
              cubes[kind].wcs.to_header() == cubes["fits"].wcs.to_header())
    del cubes["tiled"]
    shutil.rmtree(paths["tiled"])

    # 2. an SNR mask appended to the one-tile image
    sigma = float(src.mad_std().value)
    snr = src.with_mask(src > Quantity(IO_MASK_SNR * sigma, src.unit))
    timed("append mask", lambda: make_casa_mask(
        snr, os.path.join(workdir, "io_snr_mask", "snr"),
        append_to_image=True, img=paths["single"]))
    masked = timed("read with the appended mask",
                   lambda: T.SpectralCube.read(paths["single"]))
    check(f"appended mask read back bitwise (sigma {sigma:.4f})",
          torch.equal(masked.mask.include(data=masked._data),
                      snr.mask.include(data=x)))
    del masked, snr
    shutil.rmtree(os.path.join(workdir, "io_snr_mask"))

    # 3. 623 per-plane beams, and an IQUV image
    major, minor, pa = vr_beams(NCHAN)
    plane_beams = T.Beams(major=Quantity(major.astype(float), "arcsec"),
                    minor=Quantity(minor.astype(float), "arcsec"),
                    pa=Quantity(pa.astype(float), "deg"))
    vr = T.VaryingResolutionSpectralCube(x, wcs, mask=src.mask,
                                         beams=plane_beams,
                                         header=header,
                                         allow_huge_operations=True)
    vr_path = os.path.join(workdir, "io_vr.image")
    timed("write CASA, per-plane beams", lambda: vr.write(vr_path))
    vr_back = timed("read CASA, per-plane beams",
                    lambda: T.SpectralCube.read(vr_path))
    check("per-plane beams read back as a VRSC",
          isinstance(vr_back, T.VaryingResolutionSpectralCube)
          and bits_equal(vr_back._data, x))
    worst = 0.0
    for attr in ("major", "minor", "pa"):
        a = np.asarray(getattr(vr_back.unmasked_beams, attr).to_value(
            "arcsec" if attr != "pa" else "deg"))
        b = np.asarray(getattr(plane_beams, attr).to_value(
            "arcsec" if attr != "pa" else "deg"))
        worst = max(worst, float(np.max(np.abs(a / b - 1.0))))
    check(f"{NCHAN} beams within {worst:.1e} (1e-12)", worst < 1e-12)
    del vr, vr_back
    shutil.rmtree(vr_path)
    n = IO_STOKES_NCHAN
    wcs_n = src[:n].wcs
    comps = {}
    for k, name in enumerate("IQUV"):
        t = x[k * n:(k + 1) * n].clone()
        comps[name] = T.SpectralCube(t, wcs_n, mask=LazyMask(
            torch.isfinite, data=t, wcs=wcs_n), header=header)
    stokes = T.StokesSpectralCube(comps)
    st_path = os.path.join(workdir, "io_iquv.image")
    timed("write CASA, IQUV", lambda: write_casa_image(stokes, st_path))
    back = timed("read CASA, IQUV",
                 lambda: T.StokesSpectralCube.read(st_path))
    check("IQUV components bitwise", back.components == list("IQUV") and all(
        bits_equal(back[c]._data, comps[c]._data) and torch.equal(
            back[c].mask.include(data=back[c]._data),
            torch.isfinite(comps[c]._data)) for c in "IQUV"))
    del stokes, back, comps
    shutil.rmtree(st_path)

    # 4. a CLASS .lmv cube at the full size, read onto the card and on
    # the host
    lmv_path = os.path.join(workdir, "io.lmv")
    timed("write LMV", lambda: write_lmv(
        lmv_path, data, ref_deg=(float(header["CRVAL1"]),
                                 float(header["CRVAL2"])),
        pix_arcsec=PIX_ARCSEC, velocity=(-20.0, 0.25)))
    lmv = timed("read LMV", lambda: T.SpectralCube.read(lmv_path))
    lmv_cpu = T.SpectralCube.read(lmv_path, device="cpu")
    check("LMV read lands on the card", lmv.device.type == "cuda")
    check("LMV on the card bitwise its CPU read, and the source",
          bits_equal(lmv._data.cpu(), lmv_cpu._data)
          and bits_equal(lmv._data, x)
          and lmv.wcs.to_header() == lmv_cpu.wcs.to_header())
    log(f"  LMV: {lmv}, WCS {lmv.wcs.ctype}")
    del lmv, lmv_cpu
    os.unlink(lmv_path)

    # 5. region cuts of the CASA read, then run_pipeline on the DS9 cut
    casa, fits = cubes["single"], cubes["fits"]
    # at 768 x 768: an fk5 circle of 120 px about pixel (300, 430), a
    # polygon overlapping it, a 40 px hole in the circle; the CRTF box
    # corners at pixels (250, 200) and (560, 600)
    cx, cy = round(0.39 * NX), round(0.56 * NY)
    lon, lat = casa.wcs.celestial.pix2world(np.array([float(cx)]),
                                            np.array([float(cy)]))
    lon, lat = float(np.asarray(lon)[0]), float(np.asarray(lat)[0])
    poly = ",".join(str(round(f * n)) for f, n in zip(
        (0.55, 0.33, 0.78, 0.39, 0.73, 0.68, 0.59, 0.61), (NX, NY) * 4))
    ds9 = (f'fk5; circle({lon:.7f}, {lat:.7f}, '
           f'{0.156 * NX * PIX_ARCSEC:.2f}"); image; polygon({poly}); '
           f"-circle({cx + 1},{cy + 1},{round(0.052 * NX)})")
    crtf = (f"box[[{round(0.33 * NX)}pix, {round(0.26 * NY)}pix], "
            f"[{round(0.73 * NX)}pix, {round(0.78 * NY)}pix]]")
    log(f"  DS9: {ds9}; CRTF: {crtf}, range {IO_VELOCITY_RANGE} km/s")
    regions = parse_ds9_region(ds9)
    plane = timed("region rasterise", lambda: _region_plane(
        regions, casa, region_to_mask))
    finite_any = np.isfinite(data).any(axis=0)
    keep = plane & finite_any
    ys, xs = np.flatnonzero(keep.any(axis=1)), np.flatnonzero(keep.any(axis=0))
    bounds = (slice(ys[0], ys[-1] + 1), slice(xs[0], xs[-1] + 1))
    cut = timed("subcube DS9", lambda: casa.subcube_from_ds9region(ds9))
    expect_shape = (NCHAN, ys[-1] - ys[0] + 1, xs[-1] - xs[0] + 1)
    check(f"DS9 cut shape {cut.shape} as the host bounds",
          cut.shape == expect_shape)
    stored = cut.mask._mask2._mask
    check(f"DS9 region kept as one {tuple(stored.shape)} "
          f"{stored.dtype} plane on {stored.device}",
          tuple(stored.shape) == (1,) + expect_shape[1:]
          and stored.device == cut.device)
    region_cut = torch.as_tensor(plane[bounds], device=dev)
    check("DS9 cut mask as region_to_mask's composition", torch.equal(
        cut.mask.include(data=cut._data),
        torch.isfinite(cut._data) & region_cut[None]))
    box = parse_crtf_region(crtf)[0]
    box.meta["range"] = [Quantity(v, "km/s") for v in IO_VELOCITY_RANGE]
    box.meta["veltype"] = "RADIO"
    box_cut = timed("subcube CRTF with a velocity range",
                    lambda: casa.subcube_from_regions([box]))
    freq = np.asarray(casa.spectral_axis.value)
    rest = float(header["RESTFRQ"])
    ends = [int(np.argmin(np.abs(freq - rest * (1.0 - v * 1e3 / 299792458.0))))
            for v in IO_VELOCITY_RANGE]
    lo, hi = min(ends), max(ends)
    bmask = region_to_mask(box, casa.wcs, casa.shape) & \
        np.isfinite(data[lo:hi + 1]).any(axis=0)
    bys, bxs = np.flatnonzero(bmask.any(axis=1)), \
        np.flatnonzero(bmask.any(axis=0))
    check(f"CRTF cut shape {box_cut.shape} as the host slab and bounds",
          box_cut.shape == (hi - lo + 1, bys[-1] - bys[0] + 1,
                            bxs[-1] - bxs[0] + 1)
          and bits_equal(box_cut._data, x[lo:hi + 1, bys[0]:bys[-1] + 1,
                                          bxs[0]:bxs[-1] + 1]))
    del box_cut
    # a CASA image's stored mask (mask0) stays with the cube through
    # convolve_to, as in the JAX package, where a FITS read's finiteness
    # mask follows the convolved data: the FITS read gets the same stored
    # mask before its cut
    fits_cut = fits.with_mask(fits.mask.include(data=fits._data)) \
        .subcube_from_ds9region(ds9)
    check("the FITS read's cut is the same cut",
          fits_cut.shape == cut.shape and bits_equal(fits_cut._data,
                                                     cut._data)
          and torch.equal(fits_cut.mask.include(data=fits_cut._data),
                          cut.mask.include(data=cut._data)))
    _, target_beam = beams()
    target_header = shifted_header(cut.header, *SHIFT)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    res = timed("run_pipeline on the DS9 cut", lambda: T.run_pipeline(
        cut, snr_threshold=SNR, target_beam=target_beam,
        target_header=target_header))
    counts = K.launch_counts()
    log(f"  launches {counts}")
    counts = {k: counts[k] for k in IO_KERNELS}
    if not all(n > 0 for n in counts.values()):
        raise AssertionError(f"a kernel of the path never ran: {counts}")
    timed("run_pipeline again", lambda: T.run_pipeline(
        cut, snr_threshold=SNR, target_beam=target_beam,
        target_header=target_header))
    ref = T.run_pipeline(fits_cut, snr_threshold=SNR, target_beam=target_beam,
                         target_header=target_header)
    for i, (a, b) in enumerate(zip(res["moments"], ref["moments"])):
        compare(f"pipeline on the CASA cut, moment {i} vs the FITS cut's",
                torch.as_tensor(np.asarray(a.value)),
                torch.as_tensor(np.asarray(b.value)),
                3e-6 if i < 2 else 5e-5)
    check("pipeline cubes equal", bits_equal(res["cube"]._data,
                                             ref["cube"]._data))
    # each kernel of the path against its plain version at the cut's own
    # shape, where the CASA-against-FITS check runs the same kernels on
    # both sides
    hold_stages("DS9 cut", cut, target_beam, target_header, res, dev,
                lambda name, fn: timed(f"DS9 cut {name}", fn))
    frac = float(np.isfinite(np.asarray(res["moments"][0].value)).mean())
    check(f"cut's moment 0 finite fraction {frac:.3f}", 0.02 < frac < 1.0)
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    device_peak = torch.cuda.max_memory_allocated() / 2**30
    del res, ref, cut, fits_cut, cubes, casa, fits, src, x
    for path in (paths["single"], paths["fits"]):
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.unlink(path)
    torch.cuda.empty_cache()
    log("summary: io and regions (CUDA-synchronized): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items())
        + f"; host peak (process, ru_maxrss) {host_peak:.2f} GiB, device "
        f"peak {device_peak:.2f} GiB; launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return counts


def _region_plane(regions, cube, region_to_mask):
    """The union of the include regions less the exclusions, on the host
    (the composition ``region._extract`` makes)."""
    plane = np.zeros(cube.shape[1:], bool)
    for reg in regions:
        if not reg.exclude:
            plane |= region_to_mask(reg, cube.wcs, cube.shape)
    for reg in regions:
        if reg.exclude:
            plane &= ~region_to_mask(reg, cube.wcs, cube.shape)
    return plane


def phase_small_reference(dev):
    """A small pipeline, a small varying-resolution pipeline on both
    convolution routes and a small spectral path, each on the card against
    the same run on the CPU, whose plain versions the CPU tests hold
    against the JAX package."""
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.wcs import WCS
    log("phase small reference (card vs CPU)")
    nchan, ny, nx = 48, 64, 72
    data = synth_cube(nchan, ny, nx, SEED + 1, cutoff=False)
    h = synth_header(nchan, ny, nx)
    _, target_beam = beams()
    out = {}
    for d in ("cpu", dev):
        cube = T.SpectralCube(data, WCS(header=h), header=h, device=d)
        out[str(d)] = T.run_pipeline(cube, snr_threshold=SNR,
                                     target_beam=target_beam,
                                     target_header=shifted_header(h, *SHIFT))
    a, b = out["cpu"], out[str(dev)]
    if a["statistics"]["npts"] != b["statistics"]["npts"]:
        raise AssertionError("small pipeline npts differ")
    for pa, pb in zip(a["moments"][:2], b["moments"][:2]):
        import torch
        compare("small pipeline moment", torch.as_tensor(np.asarray(pb.value)),
                torch.as_tensor(np.asarray(pa.value)), 1e-4)
    compare("small pipeline cube", b["cube"]._data.cpu(), a["cube"]._data,
            1e-5)

    import torch
    for route, pa, group in (("fft", VR_PA, 1),
                             ("per_channel_separable", (0.0, 0.0), 2)):
        log(f"phase small reference, varying-resolution pipeline ({route})")
        data = synth_cube(nchan, ny, nx, SEED + 8, cutoff=False)
        flagged = ()
        if route == "fft":
            # no NaN frame: the common beam's sub-pixel kernels divide by a
            # denominator near its 1e-6 floor there, where cuFFT's and the
            # CPU FFT's roundings part; a flagged plane instead
            data = np.nan_to_num(data, nan=0.0)
            flagged = (5,)
        major, minor, bpa = vr_beams(nchan, pa=pa, group=group,
                                     flagged=flagged)
        vb = T.Beams(major=T.Quantity(major, "arcsec"),
                     minor=T.Quantity(minor, "arcsec"),
                     pa=T.Quantity(bpa, "deg"))
        hv = h.__class__(h)
        for key in ("BMAJ", "BMIN", "BPA"):
            del hv[key]
        out = {}
        for d in ("cpu", dev):
            cube = T.VaryingResolutionSpectralCube(data, WCS(header=hv),
                                                   header=hv, beams=vb,
                                                   device=d)
            cube = cube.with_mask(T.LazyMask(torch.isfinite, cube=cube))
            out[str(d)] = T.run_pipeline(
                cube, snr_threshold=SNR,
                target_header=rotated_header(hv, VR_ROTATION))
            from spectral_cube_tpu_torch.ops import convolve as oc
            if oc.convolve_cube_to_beam.last["route"] != route:
                raise AssertionError(f"small VRSC route "
                                     f"{oc.convolve_cube_to_beam.last}")
        a, b = out["cpu"], out[str(dev)]
        if a["statistics"]["npts"] != b["statistics"]["npts"]:
            raise AssertionError("small VRSC pipeline npts differ")
        for pa_, pb in zip(a["moments"][:2], b["moments"][:2]):
            compare(f"small VRSC ({route}) moment",
                    torch.as_tensor(np.asarray(pb.value)),
                    torch.as_tensor(np.asarray(pa_.value)), 1e-4)
        compare(f"small VRSC ({route}) cube", b["cube"]._data.cpu(),
                a["cube"]._data, 1e-5)

    log("phase small reference, spectral path (card vs CPU)")
    import torch
    from spectral_cube_tpu_torch.ops.smoothing import gaussian_kernel1d
    data = add_holes(synth_cube(nchan, ny, nx, SEED + 5), SEED + 6)
    kern = gaussian_kernel1d(SMOOTH_STDDEV)
    out = {}
    for d in ("cpu", dev):
        cube = T.SpectralCube(data, WCS(header=h), header=h, device=d)
        cube = cube.with_mask(T.LazyMask(torch.isfinite, cube=cube))
        sm = cube.spectral_smooth(kern)
        si = sm.spectral_interpolate(sm.spectral_axis[::2],
                                     smooth_kernel=kern)
        out[str(d)] = (si._data.cpu(),
                       si.sigma_clip_spectrally(CLIP_SIGMA)._data.cpu())
    (ia, ca), (ib, cb) = out["cpu"], out[str(dev)]
    compare("small spectral_interpolate", ib, ia, 1e-5)
    # the devices' smoothing products round differently, so a sample
    # within rounding of a clip threshold may fall either way
    flips = int((torch.isnan(ca) != torch.isnan(cb)).sum())
    both = ~torch.isnan(ca) & ~torch.isnan(cb)
    err = float((ca[both] - cb[both]).abs().max())
    log(f"  small sigma clip: {flips} keep/clip flips of {ca.numel()}, "
        f"max |diff| of kept values {err:.3e}")
    if flips > 1e-3 * ca.numel() or err > 1e-5 * float(ca[both].abs().max()):
        raise AssertionError("small spectral path differs")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import spectral_cube_tpu_torch  # noqa: F401  (fails outside the repo)
    from spectral_cube_tpu_torch.kernels import _build
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; device count "
        f"{torch.cuda.device_count()}")
    log(f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.last_build['seconds']:.1f} s): "
        f"{_build.last_build['path']}")
    no_tf32()

    warnings.simplefilter("ignore")
    results = {}
    walls = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        val = fn(*args)
        walls[name] = time.perf_counter() - t
        return val

    with tempfile.TemporaryDirectory() as workdir:
        total_ms, warm_ms, peak, counts, stages = phase(
            "pipeline", phase_pipeline, dev, workdir)
        (sp_counts, sp_peak, sp_first, sp_steady,
         clip623) = phase("spectral", phase_spectral, dev, workdir, results)
        rs_counts, rs_peak, rs_first, rs_steady = phase(
            "reproject spectral", phase_reproject_spectral, dev, workdir,
            results)
        vr = phase("varying-resolution", phase_vrsc, dev, workdir, results)
        api = phase("cube API", phase_cube_api, dev, workdir)
        spline = phase("spline and transforms", phase_spline_transforms,
                       dev, workdir, results)
        io_counts = phase("io and regions", phase_io_regions, dev, workdir)
    counts.update({k: sp_counts[k] for k in SPECTRAL_KERNELS})
    counts.update({k: rs_counts[k] for k in REPROJECT_SPECTRAL_KERNELS})
    data = torch.as_tensor(synth_cube(NCHAN, NY, NX, SEED), device=dev)
    phase("moments", phase_moments, dev, data, results)
    rank, f1 = phase("conv", phase_conv, dev, data, results)
    phase("resample", phase_resample, dev, data,
          synth_header(NCHAN, NY, NX), results)
    cr_counts, cr_ms, declined_ms = phase(
        "conv_reproject", phase_conv_reproject, dev, data, results)
    counts.update({k: cr_counts[k] for k in CONV_REPROJECT_KERNELS})
    bm_counts = phase("banded_matmul", phase_banded_matmul, dev, data,
                      results)
    counts.update({k: bm_counts[k] for k in BANDED_MATMUL_KERNELS})
    # the spline phase's path steps launch #14 (its first caller on a
    # path), resample2 (the mosaic) and moments
    for step in spline["counts"].values():
        for k, n in step.items():
            counts[k] = counts.get(k, 0) + n
    del data
    torch.cuda.empty_cache()
    phase("small reference", phase_small_reference, dev)
    log("summary: phase wall times "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))

    log(f"summary: pipeline {total_ms:.1f} ms (first call), {warm_ms:.1f} ms "
        f"(second), peak {peak / 2**30:.2f} GiB, "
        f"conv rank {rank}, stages "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()))
    log(f"summary: spectral path {sum(sp_first.values()):.1f} ms (first "
        f"call), {sum(sp_steady.values()):.1f} ms (second), peak "
        f"{sp_peak / 2**30:.2f} GiB, stages "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sp_steady.items())
        + "; " + ", ".join(f"{k} {v:.1f} ms" for k, v in clip623.items()))
    log(f"summary: reproject onto a new spectral axis {rs_first:.1f} ms "
        f"(first call), {rs_steady:.1f} ms (second), peak "
        f"{rs_peak / 2**30:.2f} GiB; fused conv_reproject path "
        f"{cr_ms:.1f} ms (first calls), its declined plan through the "
        f"chain {declined_ms:.1f} ms (first call)")
    log(f"summary: conv_sep at {f1[0]} taps, rank {f1[1]}, NaN border: "
        f"{f1[2]:.3f} ms, bound {f1[3]:.3f} ms, max_abs_err(den >= 0.1) "
        f"{f1[4]:.3e}")
    va, vb = vr["a"], vr["b"]
    log(f"summary: varying-resolution (a) run_pipeline {va['first']:.1f} ms "
        f"(first call), {va['second']:.1f} ms (second), peak "
        f"{va['peak'] / 2**30:.2f} GiB, route {va['route']['route']} with "
        f"{va['route']['groups']} groups ("
        + ", ".join(f"{k} {v:.1f} ms" for k, v in va["fft_parts"].items())
        + "), stages (second call) "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in va["stages"]["second"]
                    .items())
        + f"; (b) convolve_to {vb['first']:.1f} / {vb['second']:.1f} ms, "
        f"route {vb['route']['route']} with {vb['route']['groups']} groups, "
        f"conv_sep launches {vb['counts']['conv_sep']}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        launches = sum(counts[k] for k in COUNTED.get(name, (name,)))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log("summary: launch alone against the wrapper call: "
        + ", ".join(f"{k} {results[k]['launch_ms']:.3f} / "
                    f"{results[k]['ms']:.3f} ms"
                    for k in ("resample2_filled", "banded_matmul",
                              "banded_matmul_config2")))
    c2 = results["banded_matmul_config2"]
    log(f"summary: banded_matmul at bench config 2 (256x512, public "
        f"function): kernel {c2['ms']:.3f} ms, plain {c2['plain_ms']:.3f} "
        f"ms, torch.matmul {c2['library_ms']:.3f} ms, bound "
        f"{c2['bound_ms']:.3f} ms, launches {bm_counts['banded_matmul']}")
    log("summary: spline and transforms (CUDA-synchronized): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in spline["times"].items())
        + "; peaks " + ", ".join(f"{k} {v / 2**30:.2f} GiB"
                                 for k, v in spline["peaks"].items())
        + "; launches on the path (added into the kernels line) "
        + "; ".join(f"{step}: " + ", ".join(f"{k} {n}" for k, n in c.items()
                                            if n)
                    for step, c in spline["counts"].items()))
    api_times, api_peak, api_copy, api_launches = api
    log("summary: cube API (second call, CUDA-synchronized): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in api_times.items())
        + f"; peak {api_peak / 2**30:.2f} GiB; spatial cut copy "
        f"{api_copy:.3f} ms; moments launches "
        + ", ".join(f"{k} {v}" for k, v in api_launches.items()))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
