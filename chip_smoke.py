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
10c. The multi-device layer on a 2 x 2 mesh of four shards on the card
   (``CubeMesh(devices=[cuda:0] * 4, shape=(2, 2))``; the default mesh
   spans the device count): (a) the pipeline's FITS file streamed onto it
   (``io.streaming.read_sharded_cube``, four (623, 384, 384) blocks) and
   ``run_pipeline(cmesh=)`` onto the shifted grid, halo exchanges > 0,
   all-to-alls and gathers 0, moments, conv_sep and resample2 once a shard
   at least, then its stages one by one; (b) the varying-resolution file
   (a) onto the rotated grid (the FFT reshard, the reshard reprojection:
   all-to-alls > 0, gathers 0); (c) the spectral file's interpolate with
   the smoothing kernel, sigma clip and moments shard by shard
   (smooth_interp, sigma_clip, moments >= 4 launches); (d) 64 channels
   of that cube written as a CASA image in 64 x 64 x 1 x 16 tiles and
   streamed onto
   the mesh (``read_sharded_casa``) bit for bit ``SpectralCube.read``'s;
   (e) before (a)'s cube is let go, the cube methods a ShardedCube runs
   shard by shard on it under (a)'s SNR mask: metadata and element-wise
   steps, reductions along the spectral axis and over the cube, the
   moments (the kernel once a shard for the first, none after), the
   spectral smoothing family, the spatial axes through the spectral
   layout (all-to-alls > 0 for those alone), gathers 0 throughout; the
   host and median filters on a 16-channel slab; ``minimal_subcube`` of
   a box (no all-to-all: each block of the box assembled from the blocks
   that overlap it); a 64-channel float64 slab's ``mad_std`` and
   ``run_pipeline(cmesh=)``; (f) then the methods that gathered the cube
   until they ran shard by shard, on the same cube and mask: ``subcube``
   by world bounds, a DS9 circle where the four shards meet,
   ``subcube_from_mask``, ``mask_channels``, ``with_beam``,
   ``unmasked_copy``, ``sigma_clip``, ``argmax_world``, the
   ``filled_data``/``unmasked_data`` indexers (a spectrum, a plane, a box
   across the four shards, negative steps), ``flattened``, the parallel
   apply functions, the smoothed ``spectral_interpolate`` under the mask,
   and the spline ``reproject`` (bicubic onto the 311-channel target:
   banded_matmul 8 launches, two a shard, its first and last launch held
   against the plain version and timed at the tile shape; biquadratic
   onto the rotated grid); gathers 0 in every call, a spectrum, a plane,
   a box and a region cut each under 64 MiB above the resident cubes; one
   "summary: sharded (f)" line.  Each held against the unsharded call on
   the card at the JAX tests' tolerances ((e), (f): bit for bit, sums
   within 1e-6, products whose plan follows the batch within 1e-6 and
   atol 1e-6), NaN patterns equal; counters and launches reset just
   before each sharded run; one "summary: sharded" line (its launches not
   in the kernels line).
10c'. The sharded path on meshes of distinct devices
   (``phase_distinct_mesh``): D4, a 2 x 2 mesh with the card on the
   diagonal and the host on the other two positions (every halo exchange
   and all-to-all crosses devices along both axes), and D2, ``[card,
   host]``; the host's positions run the plain versions.  On each, and on
   the same grid of the card alone first: dryrun_multichip's six steps
   and its product pipeline, a 16 x 768 x 768 cube of the pipeline's kind
   streamed onto the mesh, ``convolve_to`` and ``run_pipeline`` of the
   card alone's convolved cube onto the shifted grid; on D4 also
   ``run_pipeline`` end to end, the reductions, the spectral path, S and
   R on the shards, and V (a) through ``to_sharded``, its convolution and
   pipeline onto the rotated grid.  Each stage held against the card
   alone's: counters equal with no gather, each kernel launched the
   card's positions' share of the card alone's launches, every block on
   its position's device, values bit for bit, within 1e-6 (sums) or
   within the kernels' tolerance against their plain versions with NaN
   patterns exact, the normalized convolutions by ``compare_conv``'s rule
   (NaN states free where the float64 den <= 1e-5); one "summary:
   distinct mesh" line (its launches not in the kernels line).
10d. Card scale, past 2**31 voxels (``phase_card_scale``): on P (2304 x
   1024 x 1024, read from FITS) ``run_pipeline`` and its stages, the
   spectral path, the reprojection onto a new spectral axis (S), the
   rotated spline reprojection (R, biquadratic on P's own spectral axis,
   bicubic onto 2303 channels) and the fused convolve + reproject (C:
   #8, #9 and #10 on a clean cube of P's shape and on P), the sharded
   path on the card's two meshes (M: the default mesh, one position on
   one card whose shard is the whole cube, and a 2 x 2 mesh of the card;
   P's FITS file read onto each, ``run_pipeline(cmesh=)``, the
   reductions over the mesh, P as a varying-resolution cube through
   ``to_sharded`` and ``run_pipeline(cmesh=)`` onto a rotated grid, a
   float64 read's statistics; and MS on the same shards of P: the
   spectral path, S and R shard by shard, held against the unsharded
   stages' tiles and slabs), P as a varying-resolution cube (V); on H
   (1280 x 2048 x 2048) the moments, statistics and reductions.  Each
   stage's peak and rise logged and held, each kernel launched on more
   than 2**31 elements and counted over its own stage, results held on
   tiles and slabs; one "summary: card scale" line.
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
13. Runs the port's test batteries (``BATTERY_FILES``: the JAX package's
    reference, lower-dimensional, fuzz, docs, beam, unit, auxiliary,
    cube, mask, I/O, WCS, multi-device (on a mesh of 8 positions of the
    card) and operation tests through the port, the numpy interop tests,
    the sharded store's and the indexers' host arrays, F23) and then the
    kernel tests (``tests/test_torch_kernels_cuda.py``), each in a pytest
    process of its own (``python -m pytest --noconftest -m cuda``, the
    kernels already built; ``-p chip_smoke`` loads the hook that adds up
    the process's kernel launches test by test into a file): every
    ``cuda`` case must run and pass, none may fail, error or skip.  One
    "summary: batteries" line with the outcomes by file, the seconds and
    each kernel's launches in each process.

Profiler traces (``spectral_cube_tpu_torch.profiling``): after the timed
calls of the pipeline (3), the spectral path (4), varying-resolution (a)
(7) and sharded (a) (10c), one extra call of each runs under
``profiling.trace`` with the launch counters reset just before, then once
more with Python frames.  Each gives one "summary: trace" line (the
window, the device-busy time, the idle share, the top 8 device operations
and the 5 longest idle gaps with the host operation open at each gap's
start and the Python function it falls in), printed again before the
kernels line; each wrapper's counter
must equal its kernels' launches in the trace.  The gzipped Chrome traces
land in ``chiprun_out/traces/`` beside this script.  Also: ``OpTimer`` on
the moments wrapper at the pipeline's shape (1 and 5 calls) within 2x of
its CUDA-event median, ``device_memory_stats`` after the pipeline's
traced call against the device's properties, the tensors it holds and a
fresh allocation, and a ``ProgressCallback`` driven
through ``sigma_clip_spectrally(update_function=)`` on a 64 x 64 cut.

Prints one JSON line with each kernel's numbers, the card line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
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
#: the slab of V (a)'s kind whose FFT-route NaN decisions are held against
#: float64 (:func:`vr_flip_slab`): channels of P's 2304, and the seed
VR_FLIP_CHANNELS = (0, 1, 1151, 2303)
VR_FLIP_SEED = 29
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

# sharded phase: the mesh (one card, four shards) and the kernels each of
# its paths must launch once a shard at least
MESH_GRID = (2, 2)
#: the channels of (d)'s tiled CASA image, a slab of the spectral cube (the
#: I/O phase writes and reads the whole cube in tiles)
D_NCHAN = 64
SHARDED_KERNELS = {"a": ("moments", "conv_sep", "resample2"),
                   "c": ("smooth_interp", "sigma_clip", "moments"),
                   "e": ("moments",),
                   "f": ("banded_matmul",)}
# (e), the cube methods a ShardedCube runs shard by shard: the channels of
# the slab the host filters and the median filters run on (no host copy of
# the whole cube), the box of the mask minimal_subcube cuts to (channels,
# rows, columns), the channels of the float64 cube of the F5 case
E_SLAB = 16
E_BOX = (100, 400, 200, 600, 150, 500)
E_F64_NCHAN = 64
# (f), the methods that gathered the cube before they ran shard by shard:
# the world box of ``subcube`` (pixels: channels, rows, columns, read back
# as world bounds), the DS9 circle's radius (pixels, centred where the
# four shards meet), the sigma_clip threshold, the spectrum and the plane
# the indexers read, the channels and the half width of the box they read
# across the four shards, and the most a spectrum, a plane, a box or a
# region cut may add above the resident cubes
F_WORLD_BOX = (100, 400, 250, 500, 200, 520)
F_REGION_RADIUS = 40
F_CLIP = 3.0
F_SPAXEL = (300, 420)
F_PLANE = 311
F_BOX_NCHAN = 16
F_BOX_HALF = 32
F_PEAK_RISE = 64 * 2**20

# distinct-mesh phase: meshes whose positions lie on distinct devices, the
# card and the host (whose positions run the plain versions), so that
# every halo exchange, all-to-all, tree step and gather crosses devices;
# the channels of its files (cut from NCHAN so that the host's positions,
# which run every plain version on the host's cores, keep the phase near
# 40 s: it runs twice, the concurrent-positions phase runs it again under
# the stream-delay probe), the shape of dryrun_multichip's steps, and the
# tolerances (rtol of the largest magnitude, atol) a result of the mixed
# mesh is held to against the same call on the card alone: bit for bit, a
# sum's, the kernels' against their plain versions
DM_NCHAN = 16
DM_DRYRUN_SHAPE = (32, 384, 384)
DM_TOLERANCES = {"exact": (0.0, 0.0), "sum": (1e-6, 0.0),
                 "kernel": (2e-5, 1e-6)}

# concurrent-positions phase: the stream-delay probe's unit (clock cycles,
# ~0.1 ms at the card's 1.98 GHz; position p's stream sleeps p + 1 units
# before each of its calls, so that the positions finish in another order
# than they start), and the cube of the sanitizer's M4 run_pipeline
STREAM_DELAY_CYCLES = 200_000
SANITIZER_SHAPE = (16, 128, 128)

# card-scale phase: P, run_pipeline's cube past 2**31 voxels (2304 x 1024
# x 1024, 9.0 GiB, 11% of an H100), written to FITS and read back, then
# the spectral path; H, bench config 8's counterpart (bench.py:636-660) at
# the share its cube takes of a v5e (1280 x 2048 x 2048, 20.0 GiB), built
# on the card, and the cube's reductions; the tiles (pixels) and slabs
# (channels) the results are held on where no plain version fits; H's
# threshold; the limits: the pipeline's and each spectral stage's peak as
# a share of the card, each reduction's peak above the resident data in
# cube bytes; the kernels each cube must launch on its more than 2**31
# elements (S, R: P reprojected onto a new spectral axis and onto a
# rotated grid; C: the fused convolve + reproject on P's grid)
CARD_P = (2304, 1024, 1024)
CARD_H = (1280, 2048, 2048)
CARD_TILE = 128
CARD_SLAB = 8
CARD_H_THRESHOLD = 0.25
CARD_PEAK_SHARE = 0.9
CARD_MAD_RATIO = 2.0
CARD_KERNELS = {"P": ("moments", "conv_sep", "resample2", "smooth_interp",
                      "sigma_clip"),
                "H": ("moments",), "V": ("moments", "conv_sep"),
                "S": ("resample2_filled", "banded_matmul"),
                "R": ("banded_matmul",),
                "C": ("conv_reproject", "plain_strips", "pipeline_fused"),
                "M": ("moments", "conv_sep", "resample2"),
                "MS": ("smooth_interp", "sigma_clip", "resample2_filled",
                       "banded_matmul")}
# S: P reprojected onto a new spectral axis of one channel fewer than
# P's, each channel this many input channels wide, starting this far (in
# input channels) in: every output channel a lerp of two input channels,
# so that each kernel input on the way passes 2**31 elements
CARD_S_STEP = (1.0, 0.25)
# the beam groups V (a)'s FFT route must take at least (its beams drift
# over every channel)
CARD_VR_MIN_GROUPS = 2000
# the spectral median filter's width at P, and the percentile the H
# reductions take along the spectral axis
CARD_MEDIAN_WIDTH = 5
CARD_PERCENTILE = 10.0
CARD_MIN_ELEMENTS = 2 ** 31

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# spectral path: Gaussian smoothing kernel (stddev in channels), clip
SMOOTH_STDDEV = 2.0
CLIP_SIGMA = 1.0
CLIP_ITERS = 5
# the spatial cut whose spectra drive a ProgressCallback (one call each)
PROGRESS_CUT = 64
# the allocation that device_memory_stats must count to the byte (64 MiB,
# a whole number of the allocator's 512-byte blocks)
MEMORY_PROBE = 64 * 2**20

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

# the profiler traces of the four main paths, gzipped Chrome traces (one
# plain, one with Python frames each), and their "summary: trace" lines
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chiprun_out", "traces")
TRACE_LINES = []

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

HERE = os.path.dirname(os.path.abspath(__file__))
#: the JAX package's user-facing tests through the port, and the kernel
#: tests: phase_batteries runs their ``cuda`` cases on the card
BATTERY_FILES = ("tests/test_torch_ref_battery.py",
                 "tests/test_torch_projection_battery.py",
                 "tests/test_torch_fuzz_chains.py",
                 "tests/test_torch_docs.py",
                 "tests/test_torch_beams_units.py",
                 "tests/test_torch_cube_battery.py",
                 "tests/test_torch_io_battery.py",
                 "tests/test_torch_wcs_battery.py",
                 "tests/test_torch_mesh_battery.py",
                 "tests/test_torch_ops_battery.py",
                 "tests/test_torch_numpy_interop.py",
                 "tests/test_torch_sharded_store.py",
                 "tests/test_torch_f23_indexers.py",
                 "tests/test_torch_public_cube.py",
                 "tests/test_torch_public_vrsc.py",
                 "tests/test_torch_public_lower_dim.py",
                 "tests/test_torch_public_stokes.py",
                 "tests/test_torch_public_sharded.py",
                 "tests/test_torch_public_io.py")
KERNEL_TEST_FILES = ("tests/test_torch_kernels_cuda.py",)
#: seconds a pytest process of phase_batteries may take
BATTERY_TIMEOUT = 600
#: the environment variable naming the file the pytest hook writes
COUNTS_ENV = "CHIP_SMOKE_LAUNCHES"


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


def _short(name, width=72):
    """A device operation's or host frame's name, cut for a log line."""
    if name is None:
        return "-"
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    if ".py(" in name:  # a Python frame, "path.py(line): function"
        name = "/".join(name.split("/")[-2:])
    else:
        name = name.split("(")[0]
    return name if len(name) <= width else name[:width - 3] + "..."


def traced_path(tag, dev, fn, min_overlaps=0):
    """One extra, untimed call of ``fn`` under ``profiling.trace``, the
    launch counters reset just before: its window, device-busy time, idle
    share, top device operations and longest idle gaps, the streams that
    ran kernels and the pairs of kernels on two streams that overlapped in
    time (at least ``min_overlaps``: a mesh's positions running at once),
    and each wrapper's counter held against its kernels' launches in the
    trace (equal, or the run fails; a trace with no device event fails
    too).  Then the call once
    more traced with Python frames, for the Python function each gap falls
    in (that trace's host runs slower, so its idle share reads higher).
    The traces are written gzipped to TRACE_DIR; one "summary: trace" line
    goes to TRACE_LINES."""
    import gzip
    import shutil
    import torch
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch import profiling
    slug = "".join(c if c.isalnum() else "_" for c in tag).strip("_")
    t = time.perf_counter()
    summaries = {}
    for stack in (False, True):
        K.reset_launch_counts()
        with profiling.trace(TRACE_DIR, device=dev, with_stack=stack):
            fn()
        counts = K.launch_counts()
        tr = profiling.trace.last
        s = profiling.device_summary(tr.events, device_index=dev.index or 0)
        dest = os.path.join(TRACE_DIR, slug + (".stack" if stack else "")
                            + ".pt.trace.json.gz")
        with open(tr.path, "rb") as src, gzip.open(dest, "wb",
                                                   compresslevel=1) as out:
            shutil.copyfileobj(src, out)
        os.remove(tr.path)
        profiling.trace.last = None
        if s["device_events"] == 0:
            raise AssertionError(f"trace {tag}: no device event in {dest}")
        bad = profiling.trace_mismatches(s["kernels"], counts)
        if bad:
            raise AssertionError(
                f"trace {tag}{' (with Python frames)' if stack else ''}: "
                f"launch counters against the trace's kernel launches "
                f"(pattern: (counters, trace)) {bad}; counters {counts}")
        s["counts"] = {k: v for k, v in counts.items() if v}
        summaries[stack] = s
        del tr
    if summaries[False]["overlapping_kernel_pairs"] < min_overlaps:
        raise AssertionError(
            f"trace {tag}: {summaries[False]['overlapping_kernel_pairs']} "
            f"pairs of kernels on two streams overlap, not {min_overlaps}")
    torch.cuda.empty_cache()
    s, p = summaries[False], summaries[True]
    line = (f"summary: trace {tag}: window {s['window_ms']:.1f} ms, device "
            f"busy {s['busy_ms']:.1f} ms, idle share {s['idle_share']:.3f}, "
            f"{s['device_events']} device events; kernels on "
            f"{s['streams']} streams, {s['overlapping_kernel_pairs']} pairs "
            f"of kernels on two streams overlapping in time; launches "
            + ", ".join(f"{k} {v}" for k, v in s["counts"].items())
            + " (counters = the trace's kernels); top "
            + "; ".join(f"{_short(n)} [{_short(op, 24)}] x{c} {ms:.2f} ms"
                        for n, c, ms, op in s["top"])
            + "; longest gaps " + "; ".join(
                f"{d:.2f} ms at {t0:.1f} ms, {_short(op)} open at its start"
                for t0, d, op, _ in s["gaps"])
            + f"; with Python frames: window {p['window_ms']:.1f} ms, idle "
            f"share {p['idle_share']:.3f}, longest gaps " + "; ".join(
                f"{d:.2f} ms at {t0:.1f} ms inside {_short(fr)} "
                f"({_short(op)} open at its start)"
                for t0, d, op, fr in p["gaps"])
            + f"; traced, exported and read in "
            f"{time.perf_counter() - t:.1f} s")
    log("  " + line)
    TRACE_LINES.append(line)


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


def card_cube(nchan, ny, nx, seed, dev):
    """:func:`synth_cube`'s kind of cube (the drifting line, unit noise,
    the NaN primary-beam cutoff) made on the card from
    ``torch.Generator(device=dev)`` seeded with ``seed``, a slab of
    channels at a time."""
    import torch
    f32 = torch.float32
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ry = (torch.arange(ny, dtype=f32, device=dev)[:, None] - ny / 2) / ny
    rx = (torch.arange(nx, dtype=f32, device=dev)[None, :] - nx / 2) / nx
    amp = 6.0 * torch.exp(-0.5 * ((ry / 0.2) ** 2 + (rx / 0.25) ** 2))
    centre = nchan / 2 + 0.15 * nchan * rx
    cut = (ry / 0.47) ** 2 + (rx / 0.47) ** 2 > 1.0
    data = torch.empty((nchan, ny, nx), dtype=f32, device=dev)
    step = max(1, 2 ** 26 // (ny * nx))
    for c0 in range(0, nchan, step):
        blk = data[c0:c0 + step]
        torch.randn(blk.shape, generator=g, dtype=f32, device=dev, out=blk)
        c = torch.arange(c0, c0 + blk.shape[0], dtype=f32,
                         device=dev)[:, None, None]
        blk += amp * torch.exp(-0.5 * ((c - centre) / (0.02 * nchan)) ** 2)
        blk.masked_fill_(cut, float("nan"))
    return data


def headline_cube(nchan, ny, nx, seed, dev):
    """Bench config 8's cube (``bench.py:652-658``) made on the card: a
    Gaussian line of sigma nchan / 16 channels times a uniform draw, plus
    0.1, a slab of channels at a time."""
    import torch
    f32 = torch.float32
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    v = (torch.arange(nchan, dtype=f32, device=dev) - nchan / 2) \
        / (nchan / 16)
    line = torch.exp(-0.5 * v * v)[:, None, None]
    data = torch.empty((nchan, ny, nx), dtype=f32, device=dev)
    step = max(1, 2 ** 26 // (ny * nx))
    for c0 in range(0, nchan, step):
        blk = data[c0:c0 + step]
        torch.rand(blk.shape, generator=g, dtype=f32, device=dev, out=blk)
        blk.mul_(line[c0:c0 + step]).add_(0.1)
    return data


def one_sort_mad_std(data, valid):
    """``mad_std`` over the whole array in one sort of the included values
    and one of their deviations from the whole-array temporary
    ``|data - median|``: the port's ``masked_mad_std`` before its pieces
    (``ops/reductions.SORT_CHUNK``), kept to hold that its value below the
    piece size is this one's bit for bit."""
    import torch
    from spectral_cube_tpu_torch.ops import reductions as rd

    def median(x):
        vals = x[valid]
        n = vals.numel()
        if n == 0:
            return torch.tensor(float("nan"), dtype=x.dtype,
                                device=x.device)
        s = torch.sort(vals).values
        pos = 0.5 * (n - 1)
        lo = int(np.floor(pos))
        return rd._lerp_sorted(s[lo], s[min(lo + 1, n - 1)], pos - lo)
    med = median(data)
    return rd.MAD_STD_FACTOR * median(torch.abs(data - med))


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
                    op_timer_hold(ms, km.moments_planes, x, coords)
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


def op_timer_hold(ms, fn, x, coords):
    """``profiling.OpTimer`` on the moments wrapper at the pipeline's shape,
    1 and 5 calls between its CUDA events, against ``cuda_ms``'s median
    ``ms`` of the same call: within a factor of 2."""
    from spectral_cube_tpu_torch import profiling
    timer = profiling.OpTimer()
    got = {reps: timer.time(f"moments loop_reps={reps}", fn, x, coords, 1,
                            0.75, None, False, loop_reps=reps) * 1e3
           for reps in (1, 5)}
    log("  OpTimer on the moments wrapper (623x768x768, NaN border): "
        + ", ".join(f"loop_reps {r}: {t:.3f} ms" for r, t in got.items())
        + f"; cuda_ms {ms:.3f} ms\n" + timer.report())
    for reps, t in got.items():
        if not ms / 2 <= t <= 2 * ms:
            raise AssertionError(f"OpTimer loop_reps={reps} {t:.3f} ms "
                                 f"against cuda_ms {ms:.3f} ms")


def memory_stats_hold(dev, held):
    """``profiling.device_memory_stats(dev)`` held against sources of its
    own: the peak equal to ``torch.cuda.max_memory_allocated``, the limit
    equal to the total of the device's properties, the bytes in use at
    least ``held`` (tensors known to live on the card) and no more than the
    peak, and a fresh allocation of MEMORY_PROBE bytes adding exactly that
    to the bytes in use, within the peak."""
    import torch
    from spectral_cube_tpu_torch import profiling
    mem = profiling.device_memory_stats(dev)
    x = torch.empty(MEMORY_PROBE // 4, device=dev)
    grown = profiling.device_memory_stats(dev)
    del x
    log(f"  device_memory_stats after the traced call: {mem}; with "
        f"{MEMORY_PROBE} bytes more: {grown}")
    if mem["peak_bytes_in_use"] != torch.cuda.max_memory_allocated(dev) \
            or mem["bytes_limit"] != \
            torch.cuda.get_device_properties(dev).total_memory \
            or not held <= mem["bytes_in_use"] <= mem["peak_bytes_in_use"] \
            or grown["bytes_in_use"] - mem["bytes_in_use"] != MEMORY_PROBE \
            or grown["peak_bytes_in_use"] < grown["bytes_in_use"]:
        raise AssertionError(f"device_memory_stats {mem}, then {grown}; "
                             f"{held} bytes held on the card")


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
    traced_path("run_pipeline", dev, lambda: T.run_pipeline(
        cube, snr_threshold=SNR, target_beam=target_beam,
        target_header=target_header))
    memory_stats_hold(dev, cube._data.nbytes + res["cube"]._data.nbytes)

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
    from spectral_cube_tpu_torch import profiling
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
    traced_path("spectral path", dev, lambda: cube.spectral_smooth(kern)
                .spectral_interpolate(grid, smooth_kernel=kern)
                .sigma_clip_spectrally(CLIP_SIGMA))
    # a ProgressCallback through a cube method's update_function hook: one
    # call a spaxel
    buf = io.StringIO()
    cut = cube[:, :PROGRESS_CUT, :PROGRESS_CUT]
    cb = profiling.ProgressCallback(PROGRESS_CUT ** 2, desc="sigma clip",
                                    stream=buf)
    cut.sigma_clip_spectrally(CLIP_SIGMA, update_function=cb)
    cb.close()
    if cb.count != PROGRESS_CUT ** 2 or not buf.getvalue().endswith(
            "sigma clip 100.0%\n"):
        raise AssertionError(f"ProgressCallback: count {cb.count}, "
                             f"{buf.getvalue()[-40:]!r}")
    log(f"  ProgressCallback through sigma_clip_spectrally(update_function=)"
        f" on a {cut.shape} cut: {cb.count} calls, stream ends "
        f"{buf.getvalue()[-19:]!r}")
    del cut
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
    hold_tiles_at_path_shape(cube, kern)

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


def hold_tiles_at_path_shape(cube, kern):
    """At the spectral path's shape, each operation that runs on tiles of
    whole lanes past ``ops/reductions.SORT_CHUNK`` voxels is its one call
    bit for bit: the order statistics and arg-extrema along the spectral
    axis, the mad_std clip (``sigma_clip_plain``) with SORT_CHUNK a fifth
    of the cube (tiles of at most that many voxels), the median filter
    (tiles already: its stack holds five cubes) against the whole stack
    sorted at once, and ``convolve1d_nan``'s blocks against the
    whole-cube formula (:func:`untiled_convolve1d_nan`)."""
    import torch
    from spectral_cube_tpu_torch.kernels import sigma_clip as kc
    from spectral_cube_tpu_torch.ops import reductions as rd
    from spectral_cube_tpu_torch.ops import smoothing as osm
    data, valid = cube._data, cube._valid_view()
    x = cube._get_filled_data(fill=np.nan)
    calls = {
        "median(axis=0)": lambda: rd.masked_median(data, valid, axis=0),
        "mad_std(axis=0)": lambda: rd.masked_mad_std(data, valid, axis=0),
        "argmax(axis=0)": lambda: rd.masked_argmax(data, valid, axis=0),
        "max(axis=0)": lambda: rd.masked_max(data, valid, axis=0),
        "sigma_clip_plain mad_std": lambda: kc.sigma_clip_plain(
            x, CLIP_SIGMA, CLIP_ITERS, False, True)}
    held = []
    for name, fn in calls.items():
        one = fn()
        keep = rd.SORT_CHUNK
        rd.SORT_CHUNK = data.numel() // 5
        try:
            tiles = len(list(rd.lane_tiles(data.shape, (0,))))
            tiled = fn()
        finally:
            rd.SORT_CHUNK = keep
        if tiles < 2 or not equal_nan(tiled, one):
            raise AssertionError(f"{name} in {tiles} tiles is not its one "
                                 "call bit for bit")
        held.append(f"{name} ({tiles} tiles)")
        del one, tiled
    tiles = len(list(rd.lane_tiles(x.shape, (0,), weight=CARD_MEDIAN_WIDTH)))
    one = osm._median0(osm._sliding_stack(x, CARD_MEDIAN_WIDTH, axis=0))
    if tiles < 2 or not equal_nan(osm.spectral_median_filter_cube(
            x, CARD_MEDIAN_WIDTH), one):
        raise AssertionError("the median filter's tiles are not the whole "
                             "stack's bit for bit")
    held.append(f"spectral_median_filter_cube({CARD_MEDIAN_WIDTH}) "
                f"({tiles} tiles)")
    del one
    karr = np.asarray(kern, dtype=float)
    if not equal_nan(osm.convolve1d_nan(x, karr),
                     untiled_convolve1d_nan(x, karr)):
        raise AssertionError("convolve1d_nan's blocks are not the whole-cube "
                             "formula's bit for bit")
    held.append("convolve1d_nan (banded blocks)")
    log("  at the path's shape, bit for bit the one call: "
        + ", ".join(held))
    del x, valid
    torch.cuda.empty_cache()


def spectral_target(header, target=SPECTRAL_TARGET):
    """The header of a target with ``target``'s channels (SPECTRAL_TARGET:
    twice the input's width, starting a quarter channel in) on the grid
    shifted by SHIFT."""
    nz, step, start = target
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
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import conv_reproject as kcr
    from spectral_cube_tpu_torch.kernels import pipeline_fused as kpf
    from spectral_cube_tpu_torch.ops import moments as om
    from spectral_cube_tpu_torch.ops import pipeline_fused as opf
    from spectral_cube_tpu_torch.ops import regrid as og
    log("phase conv_reproject (kernels conv_reproject, plain_strips, "
        "pipeline_fused)")
    cube_beam, _ = beams()
    kern, ys, xs, ops, coords, dx, mask = card_c_operators(data.shape)
    log(f"  kernel {kern.shape[0]}x{kern.shape[1]}, rank {ops.rank}, G bands "
        f"{ops.gy.taps.shape[3]}/{ops.gx.taps.shape[3]} taps")
    a = synth_config5(NCHAN, NY, NX, SEED + 7, dev)
    b = data
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
    traced_path("VRSC (a)", dev, lambda: T.run_pipeline(
        cube, snr_threshold=SNR, target_header=target))
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


def close_arrays(name, got, want, rtol, atol):
    """``got`` and ``want`` (host arrays or tensors) have equal NaN
    patterns and agree within rtol/atol where finite; returns the largest
    absolute difference."""
    import torch
    if isinstance(got, torch.Tensor) and isinstance(want, torch.Tensor) \
            and got.dtype == want.dtype == torch.float32 \
            and got.device == want.device and got.is_contiguous() \
            and want.is_contiguous() and bits_equal(got, want):
        # the same bits (NaN where NaN): every tolerance holds, and the
        # check reads no cube on the host
        return 0.0
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shapes {g.shape} vs {w.shape}")
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError(f"{name}: NaN patterns differ in "
                             f"{int((np.isnan(g) != np.isnan(w)).sum())} "
                             "places")
    fin = ~np.isnan(w)
    err = float(np.abs(g[fin] - w[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(g[fin], w[fin], rtol=rtol, atol=atol,
                               err_msg=name)
    return err


#: (rtol, atol) of a sharded ``run_pipeline`` result against the unsharded
#: one: the JAX package's (tests/test_parallel.py:770-785), the cube the
#: reprojection test's
PIPELINE_TOLERANCES = {"mom0": (3e-5, 1e-6), "mom1": (3e-5, 1e-4),
                       "linewidth": (1e-4, 1e-4), "cube": (1e-5, 1e-6)}


def hold_pipeline(tag, res, ref):
    """A sharded ``run_pipeline`` result against the unsharded one at
    PIPELINE_TOLERANCES: moments, linewidth and statistics, then the
    reprojected cube, NaN patterns equal.  Returns the largest errors."""
    errs = {}
    for i, name in enumerate(("mom0", "mom1", "linewidth")):
        errs[name] = close_arrays(f"{tag} {name}",
                                  np.asarray(res["moments"][i].value),
                                  np.asarray(ref["moments"][i].value),
                                  *PIPELINE_TOLERANCES[name])
    st, sr = res["statistics"], ref["statistics"]
    if st["npts"] != sr["npts"]:
        raise AssertionError(f"{tag} statistics npts {st['npts']} vs "
                             f"{sr['npts']}")
    for key in ("mean", "sigma", "sum", "max", "min", "rms"):
        a, b = float(st[key].value), float(sr[key].value)
        if abs(a - b) > 2e-5 * abs(b) + 1e-7:
            raise AssertionError(f"{tag} statistics {key}: {a} vs {b}")
    errs["cube"] = close_arrays(f"{tag} reprojected cube",
                                res["cube"].cube._data, ref["cube"]._data,
                                *PIPELINE_TOLERANCES["cube"])
    return errs


class _Recorder:
    """Stands in, in the port's modules, for a kernel wrapper: keeps
    ``record(args, kwargs)`` of its first and its last call in ``calls``
    (the arguments themselves by default), then calls it.  ``launches``
    reads and writes the wrapper's own count, which the wrapper's body
    adds to through its module's name."""

    def __init__(self, fn, calls, record):
        self.fn = fn
        self.calls = calls
        self.record = record
        self.lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        # a mesh's positions call at once, each on its own worker
        with self.lock:
            self.calls[1 if self.calls else 0:] = [self.record(args, kwargs)]
        return self.fn(*args, **kwargs)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


@contextlib.contextmanager
def recorded_calls(names, record=lambda args, kwargs: (args, kwargs)):
    """Inside the block every module of the port that holds one of the
    kernel wrappers ``names`` (keys of ``kernels.WRAPPERS``) holds a
    :class:`_Recorder` of it instead.  Yields ``{name: [record of the
    first call, of the last call]}``, by default ``(args, kwargs)``."""
    from spectral_cube_tpu_torch import kernels as K
    calls = {n: [] for n in names}
    subs = {id(K.WRAPPERS[n]): _Recorder(K.WRAPPERS[n], calls[n], record)
            for n in names}
    patched = []
    for mname, mod in list(sys.modules.items()):
        if mod is None or not mname.startswith("spectral_cube_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            rec = subs.get(id(val))
            if rec is not None and rec.fn is val:
                setattr(mod, attr, rec)
                patched.append((mod, attr, val))
    try:
        yield calls
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def _bind(fn, args, kwargs):
    """``args``/``kwargs`` of a call of ``fn`` by parameter name, in the
    parameters' order (a wrapper takes them positionally: its device
    guard names its first parameter ``x``)."""
    ba = inspect.signature(fn).bind(*args, **kwargs)
    ba.apply_defaults()
    return dict(ba.arguments)


def moment_term_scales(x, xc, valid):
    """Per spaxel, in float64, the sums of the absolute values of the
    terms that kernel 1's chunked two-pass sums add (csrc/moments.cu):
    per chunk of ``kernels.moments.CHUNK`` channels, with w the included
    values, m = s1/s0 the chunk's centre and d = x - m, s0 adds w, s1
    adds s0*m and w*d, s2 adds s0*m^2, 2*m*w*d and w*d^2, and the
    with-stats sum of squares adds (w - s0/n)^2 and s0^2/n.  Where a
    chunk's s0 nearly cancels (a clipped spectrum's few values of both
    signs), m, and with it these scales, grow large."""
    import torch
    from spectral_cube_tpu_torch.kernels.moments import CHUNK
    t = [0.0] * 4
    for c0 in range(0, x.shape[0], CHUNK):
        ok = valid[c0:c0 + CHUNK]
        w = torch.where(ok, x[c0:c0 + CHUNK], 0.0).double()
        xx = xc[c0:c0 + CHUNK, None, None]
        s0 = w.sum(0)
        m = (w * xx).sum(0) / torch.where(s0 == 0, 1.0, s0)
        aw, d = w.abs(), (xx - m).abs()
        awd = (aw * d).sum(0)
        n = ok.sum(0).clamp(min=1).double()
        t[0] = t[0] + aw.sum(0)
        t[1] = t[1] + (s0 * m).abs() + awd
        t[2] = t[2] + s0.abs() * m * m + 2 * m.abs() * awd \
            + (aw * d * d).sum(0)
        t[3] = t[3] + torch.where(ok, (aw + (s0 / n).abs()) ** 2, 0.0) \
            .sum(0) + s0 * s0 / n
    return t


def compare_moment_planes(name, got, want, a):
    """Kernel 1's output against its plain version's on the inputs ``a``:
    the counts equal, the minimum and maximum planes (with stats) equal
    where a spaxel counts a value, and each pair-summed plane (s0, s1,
    s2, and the sum of squares with stats) within 2 * (CHUNK + 2) * u
    (u = eps / 2, float32's unit roundoff) of the absolute sum of its
    terms (:func:`moment_term_scales`): a term is at most two roundings
    from exact and a float32 sum of k terms adds at most k, so two
    evaluations in different orders differ by at most twice (k + 2) * u
    of that sum; the pairs carry the chunks' sums with no further loss
    at this scale.  Returns the largest |got - want| / terms over the
    planes."""
    import torch
    from spectral_cube_tpu_torch.kernels.moments import CHUNK, CMP_OPS
    (gp, gc), (wp, wc) = got, want
    if not torch.equal(gc, wc):
        raise AssertionError(f"{name}: counts differ")
    x = a["data"]
    valid = torch.isfinite(x)
    if a["cmp_op"]:
        valid &= CMP_OPS[a["cmp_op"]](x, torch.tensor(
            a["threshold"], dtype=torch.float32, device=x.device))
    if a["include"] is not None:
        valid &= a["include"].to(x.device).bool()
    xc = torch.as_tensor(np.asarray(a["xc"], np.float64), device=x.device)
    scales = moment_term_scales(x, xc, valid)
    del valid
    tol = (CHUNK + 2) * float(np.finfo(np.float32).eps)
    names = ("s0", "s1", "s2", "sumsq")[:4 if a["with_stats"] else 3]
    worst = 0.0
    for k, plane in enumerate(names):
        g = gp[2 * k].double() + gp[2 * k + 1].double()
        w = wp[2 * k].double() + wp[2 * k + 1].double()
        ratio = (g - w).abs() / scales[k].clamp(min=1e-300)
        r = float(torch.where(gc > 0, ratio, 0.0).max())
        log(f"  {name} {plane}: max |got - want| / terms {r:.3e} "
            f"(tol {tol:.3e})")
        if r > tol:
            raise AssertionError(f"{name} {plane}: {r:.3e} > {tol:.3e}")
        worst = max(worst, r)
    if a["with_stats"]:
        has = gc > 0
        for k, plane in ((8, "min"), (9, "max")):
            if not torch.equal(gp[k][has], wp[k][has]):
                raise AssertionError(f"{name}: the {plane} planes differ")
    return worst


def hold_call(name, label, args, kwargs):
    """One recorded call of the wrapper ``name`` repeated through the
    wrapper and its plain version on the same inputs, held at the
    tolerances the kernel's own phase holds it to.  Returns the largest
    absolute error (where the kernel's check defines one)."""
    import torch
    from spectral_cube_tpu_torch.kernels import banded_matmul as kb
    from spectral_cube_tpu_torch.kernels import conv_sep as kc
    from spectral_cube_tpu_torch.kernels import moments as km
    from spectral_cube_tpu_torch.kernels import resample2 as kr
    from spectral_cube_tpu_torch.kernels import sigma_clip as kcl
    from spectral_cube_tpu_torch.kernels import smooth_interp as ks
    tag = f"{label} {name}"
    if name == "conv_sep":
        a = _bind(kc.conv_sep_plain, args, kwargs)
        x = a["data"]
        ys, xs = a["ytaps"].to(x.device), a["xtaps"].to(x.device)
        if int(torch.as_tensor(a["group_idx"]).max()) != 0:
            raise AssertionError(f"{tag}: the hold expects one beam group")
        got = kc.conv_sep(*a.values())
        want = kc.conv_sep_plain(**a)
        log(f"  {tag} on {tuple(x.shape)}:")
        return compare_conv(f"{tag} vs plain", got, want, x, ys, xs,
                            a["hy"], a["hx"], 1e-5)[0]
    if name == "moments":
        a = _bind(km.moments_planes_plain, args, kwargs)
        got = km.moments_planes(*a.values())
        want = km.moments_planes_plain(**a)
        stats = a["with_stats"]
        log(f"  {tag} on {tuple(a['data'].shape)} (op {a['cmp_op']}, "
            f"include {a['include'] is not None}, with_stats {stats}):")
        err = compare_moment_planes(f"{tag} vs plain", got, want, a)
        if stats:
            fg, fw = _finalize(got, stats), _finalize(want, stats)
            for key in ("mean", "sigma", "sum", "rms", "min", "max"):
                g, w = float(fg[3][key]), float(fw[3][key])
                if abs(g - w) > 2e-5 * abs(w):
                    raise AssertionError(f"{tag} statistics {key}: {g} vs "
                                         f"{w}")
        return err
    if name == "resample2":
        a = _bind(kr.resample2_plain, args, kwargs)
        log(f"  {tag} on {tuple(a['raw'].shape)}:")
        return compare(f"{tag} vs plain", kr.resample2(*a.values()),
                       kr.resample2_plain(**a), 1e-6)[0]
    if name == "sigma_clip":
        a = _bind(kcl.sigma_clip_plain, args, kwargs)
        x = a["data"]
        log(f"  {tag} on {tuple(x.shape)}:")
        return compare_clip(f"{tag} vs plain", kcl.sigma_clip(
            x, a["sigma"], a["maxiters"], a["use_mean_center"]),
            kcl.sigma_clip_plain(**a), x, a["sigma"], a["maxiters"],
            a["use_mean_center"])
    if name == "banded_matmul":
        a = _bind(kb.banded_matmul_plain, args, kwargs)
        log(f"  {tag} on {tuple(a['flat'].shape)}:")
        return compare(f"{tag} vs plain", kb.banded_matmul(*a.values()),
                       kb.banded_matmul_plain(**a), 1e-6)[0]
    if name == "smooth_interp":
        a = _bind(ks.smooth_interp, args, kwargs)
        x = a["data"]
        log(f"  {tag} on {tuple(x.shape)}:")
        return compare_si(f"{tag} vs plain", ks.smooth_interp(*a.values()),
                          ks.smooth_interp_plain(x, a["M"], a["S"], a["I"]),
                          x, a["S"], a["I"])[0]
    raise AssertionError(f"no hold for the kernel {name}")


def equal_nan(a, b):
    """Two tensors of one shape hold the same values, NaN where NaN."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0, a), torch.where(nb, 0, b)))


def hold_result(tag, got, want, kind):
    """A ShardedCube method's result against the unsharded call's by the
    contract ``kind``: "exact" bit for bit (NaN where NaN), "sum" within
    rtol 1e-6, "product" within rtol 1e-6 and atol 1e-6 (a product or a
    reduction whose plan follows the batch, on unit-noise data), NaN
    patterns equal.  A cube result: its shape, unit, WCS cards and
    include equal, its NaN-filled data held so (on the card).  Returns the
    largest absolute difference."""
    import torch
    import spectral_cube_tpu_torch as T
    rtol, atol = {"exact": (0.0, 0.0), "sum": (1e-6, 0.0),
                  "product": (1e-6, 1e-6)}[kind]
    if isinstance(got, T.ShardedCube):
        g = got.cube
        if g.shape != want.shape or str(g.unit) != str(want.unit) \
                or g.wcs.to_header() != want.wcs.to_header() \
                or not np.array_equal(g._fill_value, want._fill_value,
                                      equal_nan=True):
            raise AssertionError(f"{tag}: the cube's shape, unit, WCS or "
                                 "fill value")
        if not torch.equal(g._include_view().expand(g.shape),
                           want._include_view().expand(want.shape)):
            raise AssertionError(f"{tag}: the masks differ")
        gd, wd = g._get_filled_data(), want._get_filled_data()
        del g
        if kind == "exact":
            if not equal_nan(gd, wd):
                raise AssertionError(f"{tag}: not bit for bit")
            return 0.0
        return close_arrays(tag, gd, wd, rtol, atol)
    if isinstance(got, tuple):
        if tuple(int(i) for i in got) != tuple(int(i) for i in want):
            raise AssertionError(f"{tag}: {got} vs {want}")
        return 0.0
    g, w = (getattr(x, "value", x) for x in (got, want))
    g, w = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (g, w))
    if g.dtype != w.dtype:
        raise AssertionError(f"{tag}: {g.dtype} vs {w.dtype}")
    if g.shape != w.shape:
        raise AssertionError(f"{tag}: shapes {g.shape} vs {w.shape}")
    if kind == "exact":
        if not np.array_equal(g, w, equal_nan=g.dtype.kind == "f"):
            raise AssertionError(f"{tag}: not bit for bit")
        return 0.0
    return close_arrays(tag, g, w, rtol, atol)


def sharded_methods(cmesh, sc, cube, noise, sharded, timed, counters,
                    launches):
    """(e): the cube methods a ShardedCube runs shard by shard, on the
    streamed 623 x 768 x 768 cube of (a) under (a)'s SNR mask (four
    (623, 384, 384) shards): (a) metadata and element-wise steps, (b)
    reductions along the spectral axis and over the cube and the moments,
    (c) the spectral smoothing family, (d) the spatial axes through the
    spectral layout.  The host filters and the median filters run on an
    ``E_SLAB``-channel slab; ``minimal_subcube`` under the mask of the
    box ``E_BOX`` too.  Each call with the counters, launches and peak
    reset just before (``sharded``): gathers 0, all-to-alls > 0 exactly
    for (d), the moments kernel 4 launches for the cube's first spectral
    moment and none after; then the unsharded call on the card, timed,
    and the two held by :func:`hold_result`; then each call once more,
    timed (the steady reading).  Last the F5 case: the
    float64 copy of ``E_F64_NCHAN`` channels, its ``mad_std`` and
    ``run_pipeline(cmesh=)`` with the SNR threshold against the unsharded
    runs.  Returns the largest errors."""
    import torch
    import scipy.ndimage as ndi
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.ops import smoothing as osm
    q = T.Quantity(SNR * noise, sc.unit)
    es = sc.with_mask(sc > q)
    eu = cube.with_mask(cube > q)
    eu.allow_huge_operations = True
    sv = np.asarray(cube.spectral_axis.value)
    unit = cube.spectral_unit
    c0 = NCHAN // 2 - E_SLAB // 2

    def chans(a, b):
        return T.Quantity(sv[a], unit), T.Quantity(sv[b - 1], unit)
    kern = osm.gaussian_kernel1d(SMOOTH_STDDEV)
    box = torch.zeros(cube.shape, dtype=torch.bool, device=cube.device)
    box[E_BOX[0]:E_BOX[1], E_BOX[2]:E_BOX[3], E_BOX[4]:E_BOX[5]] = True
    errs = {}

    def run(step, name, call, kind):
        """``call(cube)`` on the sharded and on the unsharded cube, each
        once more after the hold for its steady time."""
        tag = f"e {step} {name}"
        got = sharded(tag, lambda: call(es))
        c = counters[tag]
        if c["gathers"] or (c["all_to_alls"] > 0) != (step == "d"):
            raise AssertionError(f"(e) {name}: counters {c}")
        want = timed(tag + " unsharded", lambda: call(eu))
        errs[name] = hold_result(f"(e) {name}", got, want, kind)
        del got, want
        timed(tag + " (second call)", lambda: call(es))
        timed(tag + " unsharded (second call)", lambda: call(eu))

    # the slab the host filters and the median filters take
    run("a", "spectral_slab 16", lambda c: c.spectral_slab(
        *chans(c0, c0 + E_SLAB)), "exact")
    slab_s = es.spectral_slab(*chans(c0, c0 + E_SLAB))
    slab_u = eu.spectral_slab(*chans(c0, c0 + E_SLAB))

    def on_slab(call):
        return lambda c: call(slab_s if c is es else slab_u)
    log(f"  (e) host filters and median filters on channels {c0}:"
        f"{c0 + E_SLAB} ({E_SLAB} x {NY} x {NX}), the rest on the whole "
        "cube")

    # (a) metadata and element-wise steps
    run("a", "with_fill_value", lambda c: c.with_fill_value(0.0), "exact")
    run("a", "with_spectral_unit", lambda c: c.with_spectral_unit("m/s"),
        "exact")
    run("a", "to K", lambda c: c.to("K"), "exact")
    run("a", "spectral_slab half", lambda c: c.spectral_slab(
        *chans(NCHAN // 4, 3 * NCHAN // 4)), "exact")
    run("a", "world_extrema", lambda c: c.world_extrema, "exact")
    # (b) along the spectral axis, over the cube, the moments
    for name in ("moment0", "moment1", "moment2", "linewidth_sigma",
                 "linewidth_fwhm"):
        run("b", name, lambda c, n=name: getattr(c, n)(), "exact")
        want = {"moments": cmesh.n_devices} if name == "moment0" else {}
        if launches[f"e b {name}"] != want:
            raise AssertionError(f"(e) {name}: launches "
                                 f"{launches[f'e b {name}']}, not {want}")
    for axis in (0, None, (1, 2)):
        for name in ("sum", "mean", "std", "max", "min"):
            run("b", f"{name}({axis})", lambda c, n=name, a=axis: getattr(
                c, n)(axis=a), "sum" if name in ("sum", "mean", "std")
                else "exact")
    for axis in (0, None):
        for name in ("median", "mad_std", "argmax", "argmin"):
            run("b", f"{name}({axis})", lambda c, n=name, a=axis: getattr(
                c, n)(axis=a), "exact")
        run("b", f"percentile(90, {axis})",
            lambda c, a=axis: c.percentile(90, axis=a), "exact")
    # (c) the spectral smoothing family
    run("c", "spectral_smooth", lambda c: c.spectral_smooth(kern), "sum")
    run("c", "downsample_axis(2, 0)", lambda c: c.downsample_axis(2, 0),
        "exact")
    run("c", "spectral_smooth_median slab", on_slab(
        lambda c: c.spectral_smooth_median(3, raise_error_jybm=False)),
        "exact")
    run("c", "spectral_filter slab", on_slab(
        lambda c: c.spectral_filter(3, ndi.uniform_filter)), "exact")
    # (d) the spatial axes through the spectral layout
    for axis in (1, 2):
        for name in ("sum", "max", "median", "argmax"):
            run("d", f"{name}({axis})", lambda c, n=name, a=axis: getattr(
                c, n)(axis=a), "sum" if name == "sum" else "exact")
    for name in ("mean", "std", "min", "mad_std", "argmin"):
        run("d", f"{name}(1)", lambda c, n=name: getattr(c, n)(axis=1),
            "sum" if name in ("mean", "std") else "exact")
    run("d", "percentile(10, 2)", lambda c: c.percentile(10, axis=2),
        "exact")
    for name in ("median", "mad_std"):
        run("d", f"{name}((1, 2))", lambda c, n=name: getattr(c, n)(
            axis=(1, 2)), "exact")
    run("d", "std((0, 1))", lambda c: c.std(axis=(0, 1)), "sum")
    run("d", "median((0, 2))", lambda c: c.median(axis=(0, 2)), "exact")
    run("d", "max((0, 1))", lambda c: c.max(axis=(0, 1)), "exact")
    for order, axis in ((0, 1), (1, 2), (2, 1)):
        run("d", f"moment({order}, {axis})", lambda c, o=order, a=axis:
            c.moment(order=o, axis=a), "sum")
    run("d", "downsample_axis(2, 1)", lambda c: c.downsample_axis(2, 1),
        "exact")
    run("d", "downsample_axis(3, 2, max)", lambda c: c.downsample_axis(
        3, 2, estimator="max"), "exact")
    run("d", "spatial_smooth_median slab", on_slab(
        lambda c: c.spatial_smooth_median(3, raise_error_jybm=False)),
        "exact")
    run("d", "spatial_filter slab", on_slab(
        lambda c: c.spatial_filter(3, ndi.maximum_filter,
                                   raise_error_jybm=False)), "exact")
    # a spatial cut assembles each block of the box from the blocks that
    # overlap it: no all-to-all
    run("cut", "minimal_subcube box", lambda c: c.with_mask(
        box).minimal_subcube(), "exact")
    del slab_s, slab_u, es, eu, box
    torch.cuda.empty_cache()
    # F5: a float64 cube (the port's unsharded cube keeps a float64 tensor)
    u64 = cube[:E_F64_NCHAN]._new_cube_with(
        data=cube._data[:E_F64_NCHAN].double())
    s64 = T.ShardedCube(u64, cmesh)
    got = sharded("e F5 mad_std float64", s64.mad_std)
    want = timed("e F5 mad_std float64 unsharded", u64.mad_std)
    if float(got.value) != float(want.value) or counters[
            "e F5 mad_std float64"]["gathers"]:
        raise AssertionError(f"(e) F5 mad_std {got} vs {want}, counters "
                             f"{counters['e F5 mad_std float64']}")
    res = sharded("e F5 run_pipeline float64", lambda: T.run_pipeline(
        u64, cmesh, snr_threshold=SNR))
    if counters["e F5 run_pipeline float64"]["gathers"]:
        raise AssertionError("(e) F5 run_pipeline gathered the cube")
    ref = timed("e F5 run_pipeline float64 unsharded",
                lambda: T.run_pipeline(u64, snr_threshold=SNR))
    for i, name in enumerate(("mom0", "mom1", "linewidth")):
        errs[f"F5 {name}"] = close_arrays(
            f"(e) F5 {name}", np.asarray(res["moments"][i].value),
            np.asarray(ref["moments"][i].value), 1e-6, 0.0)
    st, sr = res["statistics"], ref["statistics"]
    if st["npts"] != sr["npts"] or any(
            abs(float(st[k].value) - float(sr[k].value))
            > 1e-5 * abs(float(sr[k].value))
            for k in ("mean", "sigma", "sum", "max", "min", "rms")):
        raise AssertionError(f"(e) F5 statistics {st} vs {sr}")
    log(f"  (e) F5: float64 mad_std {float(got.value)!r} both ways; "
        "run_pipeline(cmesh=) on the float64 cube held against the "
        "unsharded run")
    return errs


def dense_operator(bands):
    """The (nout, nin) float32 operator that ``RowBands`` ``bands`` hold."""
    nout = bands.taps.shape[0]
    M = np.zeros((nout, bands.nin), np.float32)
    for i in range(nout):
        n = int(bands.length[i])
        M[i, bands.start[i]:bands.start[i] + n] = bands.taps[i, :n]
    return M


def sharded_gathers(cmesh, sc, cube, noise, sharded, timed, times,
                    counters, launches, peaks):
    """(f): the ShardedCube methods that gathered the cube until they ran
    shard by shard, on the streamed 623 x 768 x 768 cube of (a) under
    (a)'s SNR mask (four (623, 384, 384) shards): the cuts (``subcube`` by
    the world bounds of ``F_WORLD_BOX``, a DS9 circle where the four
    shards meet, ``subcube_from_mask``), the edits (``mask_channels``,
    ``with_beam``, ``unmasked_copy``), ``sigma_clip``, ``argmax_world``,
    the indexers (a spectrum, a plane, a box across the four shards, a
    view with negative steps), ``flattened``, the parallel apply
    functions (a baseline subtraction per spectrum, vmapped; each plane
    over its peak), ``spectral_interpolate`` with the smoothing kernel
    under the SNR mask, and the spline ``reproject`` (bicubic onto
    ``SPECTRAL_TARGET`` on the shifted grid: banded_matmul twice a shard;
    biquadratic onto the rotated grid).  Each call with the counters,
    launches and peak reset just before (``sharded``): gathers 0, then the
    unsharded call on the card and the two held by :func:`hold_result`,
    then each once more (the steady reading); the spectrum, the plane,
    the box, the negative-step view and the region cut each add less than
    ``F_PEAK_RISE`` above the memory allocated before the call.  #14's
    first and last launch of the bicubic call are held against its plain
    version and the first timed at the tile shape.  Prints the "summary:
    sharded (f)" line; returns the largest errors and #14's hold."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import banded_matmul as kb
    from spectral_cube_tpu_torch.ops import smoothing as osm
    from spectral_cube_tpu_torch.utils import ieee_fp32
    q = T.Quantity(SNR * noise, sc.unit)
    fs = sc.with_mask(sc > q)
    fs.allow_huge_operations = True
    fu = cube.with_mask(cube > q)
    fu.allow_huge_operations = True
    header = cube.header
    errs, rises = {}, {}
    tags = []

    def run(name, call, kind, rise=False):
        """``call`` on the sharded and on the unsharded cube; the sharded
        call's peak above the memory allocated before it."""
        tag = f"f {name}"
        tags.append(tag)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        got = sharded(tag, lambda: call(fs))
        rises[tag] = peaks[tag] - base
        if counters[tag]["gathers"]:
            raise AssertionError(f"(f) {name}: counters {counters[tag]}")
        if rise and rises[tag] >= F_PEAK_RISE:
            raise AssertionError(f"(f) {name}: the peak rose by "
                                 f"{rises[tag] / 2**20:.1f} MiB")
        want = timed(tag + " unsharded", lambda: call(fu))
        errs[name] = hold_result(f"(f) {name}", got, want, kind)
        del got, want
        timed(tag + " (second call)", lambda: call(fs))
        timed(tag + " unsharded (second call)", lambda: call(fu))
        return tag

    # the cuts
    c0, c1, y0, y1, x0, x1 = F_WORLD_BOX
    sv = np.asarray(cube.spectral_axis.value)
    _, lat, lon = cube.world[0, :, :]
    lat, lon = np.asarray(lat.value), np.asarray(lon.value)
    deg, unit = "deg", cube.spectral_unit
    box = dict(xlo=T.Quantity(lon[NY // 2, x0], deg),
               xhi=T.Quantity(lon[NY // 2, x1 - 1], deg),
               ylo=T.Quantity(lat[y0, NX // 2], deg),
               yhi=T.Quantity(lat[y1 - 1, NX // 2], deg),
               zlo=T.Quantity(sv[c0], unit),
               zhi=T.Quantity(sv[c1 - 1], unit))
    run("subcube world box", lambda c: c.subcube(**box), "exact")
    region = (f"image; circle({NX / 2 + 0.5}, {NY / 2 + 0.5}, "
              f"{F_REGION_RADIUS})")
    run("subcube_from_ds9region circle", lambda c: c.subcube_from_ds9region(
        region), "exact", rise=True)
    plane = torch.zeros((1, NY, NX), dtype=torch.bool, device=cube.device)
    plane[:, y0:y1, x0:x1] = True
    region_mask = T.BooleanArrayMask(plane, shape=cube.shape)
    run("subcube_from_mask", lambda c: c.subcube_from_mask(region_mask),
        "exact")
    # the edits
    run("mask_channels", lambda c: c.mask_channels(
        np.arange(NCHAN) % 5 != 0), "exact")
    run("with_beam", lambda c: c.with_beam(T.Beam.make(
        T.Quantity(TARGET_BEAM, "arcsec"))), "exact")
    run("unmasked_copy", lambda c: c.unmasked_copy(), "exact")
    run("sigma_clip", lambda c: c.sigma_clip(F_CLIP), "exact")
    run("argmax_world", lambda c: c.argmax_world(), "exact")
    # the indexers
    y, x = F_SPAXEL
    run("filled_data spectrum", lambda c: c.filled_data[:, y, x], "exact",
        rise=True)
    run("filled_data plane", lambda c: c.filled_data[F_PLANE], "exact",
        rise=True)
    h = F_BOX_HALF
    run("filled_data box", lambda c: c.filled_data[
        F_PLANE:F_PLANE + F_BOX_NCHAN, NY // 2 - h:NY // 2 + h,
        NX // 2 - h:NX // 2 + h], "exact", rise=True)
    run("unmasked_data negative steps", lambda c: c.unmasked_data[
        ::-1, NY // 2, ::-3], "exact", rise=True)
    run("flattened", lambda c: c.flattened(), "exact")
    # the parallel apply functions
    run("apply_function_parallel_spectral baseline", lambda c:
        c.apply_function_parallel_spectral(
            lambda s: s - torch.nan_to_num(s[:APPLY_BASELINE]).mean()),
        "product")
    # a plane over its peak: a maximum is the same in any order, so the
    # result, and the data-local mask evaluated on it, hold bit for bit
    run("apply_function_parallel_spatial peak", lambda c:
        c.apply_function_parallel_spatial(
            lambda im: im / torch.nan_to_num(im).amax()), "exact")
    # the smoothed interpolation under the SNR mask
    kern = osm.gaussian_kernel1d(SMOOTH_STDDEV)
    grid = cube.spectral_axis[::2]
    run("spectral_interpolate smoothed", lambda c: c.spectral_interpolate(
        grid, smooth_kernel=kern), "sum")
    # the spline orders: #14 twice a shard for the bicubic spectral step
    target = spectral_target(header)
    bicubic = run("reproject bicubic", lambda c: c.reproject(
        target, order="bicubic"), "product")
    want = {"banded_matmul": 2 * cmesh.n_devices}
    if launches[bicubic] != want:
        raise AssertionError(f"(f) bicubic: launches {launches[bicubic]}, "
                             f"not {want}")
    run("reproject biquadratic rotated", lambda c: c.reproject(
        rotated_header(header, VR_ROTATION), order="biquadratic"),
        "product")
    # #14 at the tile shape: the bicubic call once more, its launches
    # recorded, the first and last held against the plain version
    K.reset_launch_counts()
    with recorded_calls(SHARDED_KERNELS["f"]) as calls:
        fs.reproject(target, order="bicubic")
    if {k: v for k, v in K.launch_counts().items() if v} != want:
        raise AssertionError(f"(f) the recorded bicubic call launched "
                             f"{K.launch_counts()}")
    bm_err = max(hold_call("banded_matmul", f"(f) {which} launch", *c)
                 for which, c in zip(("first", "last"),
                                     calls["banded_matmul"]))
    a = _bind(kb.banded_matmul_plain, *calls["banded_matmul"][0])
    del calls
    flat, bands = a["flat"], a["bands"]
    nin, ncol = flat.shape
    nout = int(bands.length.shape[0])
    ms = cuda_ms(lambda: kb.banded_matmul(flat, bands), 7)
    pms = cuda_ms(lambda: kb.banded_matmul_plain(flat, bands), 3)
    Mt = torch.as_tensor(dense_operator(bands), device=flat.device)
    with ieee_fp32():
        lib_ms = cuda_ms(lambda: torch.matmul(Mt, flat), 5)
    bms, by = bound((nin + nout) * ncol * 4,
                    2 * int(bands.length.sum()) * ncol)
    tile = {"shape": [nout, nin, ncol], "max_abs_err": bm_err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}
    del a, flat, bands, Mt
    del fs, fu
    torch.cuda.empty_cache()
    log(f"summary: sharded (f) ({cmesh.grid[0]}x{cmesh.grid[1]} mesh on "
        f"{cube.device}; sharded / unsharded ms): "
        + ", ".join(f"{t[2:]} {times[t]:.1f} / {times[t + ' unsharded']:.1f}"
                    f" ms (second calls {times[t + ' (second call)']:.1f} / "
                    f"{times[t + ' unsharded (second call)']:.1f})"
                    for t in tags)
        + "; counters " + "; ".join(f"{t[2:]}: {counters[t]}" for t in tags)
        + "; launches " + "; ".join(f"{t[2:]}: {launches[t]}" for t in tags
                                    if launches[t])
        + "; peak above the resident cubes " + ", ".join(
            f"{t[2:]} {rises[t] / 2**20:.1f} MiB" for t in tags)
        + "; largest errors " + json.dumps(errs)
        + "; banded_matmul at the tile shape " + json.dumps(tile))
    return errs, tile


def phase_sharded(dev, workdir, traced=True):
    """The multi-device layer on a 2 x 2 mesh of four shards on one card
    (``parallel``): (a) the pipeline's FITS file streamed onto the mesh
    and ``run_pipeline`` onto the shifted grid (halo exchanges only); (b)
    VRSC file (a) onto the rotated grid (the FFT reshard and the reshard
    reprojection); (c) the spectral path's cube: smooth + interpolate,
    sigma clip and moments shard by shard; (d) a tiled CASA image of
    D_NCHAN of its channels streamed onto the mesh; (e) the cube methods shard by shard on (a)'s
    cube (:func:`sharded_methods`); (f) the methods that gathered the
    cube until they ran shard by shard (:func:`sharded_gathers`).  Each
    held against the unsharded call on the same card; counters and
    launches reset just before each sharded run and read just after.
    ``traced``: (a)'s traced call (its positions' kernels must overlap on
    their streams), which the concurrent-positions phase's second run
    leaves out."""
    import shutil
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.io import streaming
    from spectral_cube_tpu_torch.io.casa_writer import write_casa_image
    from spectral_cube_tpu_torch.ops import smoothing as osm
    log(f"phase sharded ({MESH_GRID[0]}x{MESH_GRID[1]} mesh, "
        f"{MESH_GRID[0] * MESH_GRID[1]} shards on {dev})")
    t_phase = time.perf_counter()
    cmesh = T.CubeMesh(devices=[dev] * (MESH_GRID[0] * MESH_GRID[1]),
                       shape=MESH_GRID)
    if T.default_mesh().n_devices != torch.cuda.device_count():
        raise AssertionError("the default mesh does not span the cards")
    times, counters, launches, peaks, errs = {}, {}, {}, {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return val

    def sharded(name, fn):
        """``fn`` timed with the mesh's counters, the launch counts and
        the device peak reset just before and read just after."""
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        cmesh.reset_counters()
        val = timed(name, fn)
        counters[name] = dict(cmesh.counters)
        launches[name] = {k: v for k, v in K.launch_counts().items() if v}
        peaks[name] = torch.cuda.max_memory_allocated()
        log(f"  {name}: {times[name]:.1f} ms, counters {counters[name]}, "
            f"launches {launches[name]}, peak {peaks[name] / 2**30:.2f} GiB")
        return val

    def check_shards(tag, sc):
        shards = sc._data.addressable_shards
        want = (sc.shape[0], sc.shape[1] // MESH_GRID[0],
                sc.shape[2] // MESH_GRID[1])
        if len(shards) != cmesh.n_devices or any(
                tuple(s.data.shape) != want or s.data.device != dev
                for s in shards):
            raise AssertionError(f"{tag}: shards "
                                 f"{[tuple(s.data.shape) for s in shards]}")
        # the read held one decoded block and its read buffer (the
        # file's block, float32 here) at once, never the cube
        held = streaming.HOST_BUFFERS["held_bytes"]
        block = streaming.HOST_BUFFERS["block_bytes"]
        log(f"  {tag}: {len(shards)} shards of {want} on {dev}; host "
            f"buffers held at once {held / 2**20:.1f} MiB (a block "
            f"{block / 2**20:.1f} MiB)")
        if held > 2 * block:
            raise AssertionError(f"{tag}: the read held more than a block "
                                 "and its read buffer")

    def held_run(tag, name, fn, kernels):
        """``fn`` once more, untimed, with the first and the last launch
        of each kernel ``kernels`` recorded (the first shard's and the
        last's), its launches as the counted run's; then each recorded
        call repeated through the wrapper and its plain version on the
        same inputs.  Those launches count nowhere."""
        K.reset_launch_counts()
        with recorded_calls(kernels) as calls:
            fn()
        n = {k: v for k, v in K.launch_counts().items() if v}
        if n != launches[name]:
            raise AssertionError(f"{tag}: the recorded run launched {n}, "
                                 f"the counted run {launches[name]}")
        errs = {}
        for k in kernels:
            if len(calls[k]) != 2:
                raise AssertionError(f"{tag}: {k} recorded {len(calls[k])} "
                                     "launches")
            errs[k] = max(hold_call(k, f"({tag}) {which} launch", *c)
                          for which, c in zip(("first", "last"), calls[k]))
        del calls
        torch.cuda.empty_cache()
        log(f"  ({tag}) each kernel's first and last launch against its "
            f"plain version: largest errors {errs}")
        return errs

    def check_counts(tag, name, halo=None, a2a=None, kernels=()):
        c, n = counters[name], launches[name]
        ok = c["gathers"] == 0 and (halo is None or (c["halo_exchanges"] > 0)
                                    == halo) \
            and (a2a is None or (c["all_to_alls"] > 0) == a2a) \
            and all(n.get(k, 0) >= cmesh.n_devices for k in kernels)
        if not ok:
            raise AssertionError(f"{tag}: counters {c}, launches {n}")

    # (a) the pipeline's file streamed onto the mesh: halo exchanges only
    _, target_beam = beams()
    path = os.path.join(workdir, "cube.fits")
    sc = timed("a read_sharded_cube", lambda: streaming.read_sharded_cube(
        path, cmesh))
    check_shards("a", sc)
    target = shifted_header(sc.header, *SHIFT)
    kw = dict(snr_threshold=SNR, target_beam=target_beam,
              target_header=target)
    res = sharded("a run_pipeline sharded",
                  lambda: T.run_pipeline(sc, cmesh, **kw))
    check_counts("a", "a run_pipeline sharded", halo=True, a2a=False,
                 kernels=SHARDED_KERNELS["a"])
    del res
    res = sharded("a run_pipeline sharded (second call)",
                  lambda: T.run_pipeline(sc, cmesh, **kw))
    if traced:
        traced_path("sharded (a)", dev,
                    lambda: T.run_pipeline(sc, cmesh, **kw), min_overlaps=1)
    kernel_errs = {"a": held_run("a", "a run_pipeline sharded",
                                 lambda: T.run_pipeline(sc, cmesh, **kw),
                                 SHARDED_KERNELS["a"])}
    # the sharded pipeline's stages one by one (the pipeline phase's
    # "stage" lines time the unsharded ones)
    conv = timed("a stage convolve_to", lambda: sc.convolve_to(target_beam))
    noise = timed("a stage mad_std", lambda: float(conv.mad_std().value))
    masked = conv.with_mask(conv > T.Quantity(SNR * noise, conv.unit))
    timed("a stage moment_maps", masked.moment_maps)
    timed("a stage statistics", masked.statistics)
    timed("a stage reproject", lambda: masked.reproject(target))
    del conv, masked
    cube = T.SpectralCube.read(path, device=dev)
    timed("a run_pipeline unsharded", lambda: T.run_pipeline(cube, **kw))
    ref = timed("a run_pipeline unsharded (second call)",
                lambda: T.run_pipeline(cube, **kw))
    errs["a"] = hold_pipeline("(a)", res, ref)
    log(f"  (a) against the unsharded run: largest errors {errs['a']}")
    del res, ref
    torch.cuda.empty_cache()
    t_e = time.perf_counter()
    errs["e"] = sharded_methods(cmesh, sc, cube, noise, sharded, timed,
                                counters, launches)
    q = T.Quantity(SNR * noise, sc.unit)
    kernel_errs["e"] = held_run("e", "e b moment0",
                                lambda: sc.with_mask(sc > q).moment0(),
                                SHARDED_KERNELS["e"])
    times["e wall"] = (time.perf_counter() - t_e) * 1e3
    log(f"  (e) the cube methods shard by shard against the unsharded "
        f"calls, wall {times['e wall'] / 1e3:.1f} s: largest errors "
        f"{errs['e']}")
    t_f = time.perf_counter()
    errs["f"], kernel_errs["f"] = sharded_gathers(
        cmesh, sc, cube, noise, sharded, timed, times, counters, launches,
        peaks)
    times["f wall"] = (time.perf_counter() - t_f) * 1e3
    log(f"  (f) the methods that gathered the cube, shard by shard, wall "
        f"{times['f wall'] / 1e3:.1f} s")
    del sc, cube
    torch.cuda.empty_cache()

    # (b) VRSC file (a): the FFT route and the reshard reprojection
    vr = T.SpectralCube.read(os.path.join(workdir, "vr_a.fits"), device=dev)
    target = rotated_header(vr.header, VR_ROTATION)
    res = sharded("b run_pipeline sharded", lambda: T.run_pipeline(
        vr, cmesh, snr_threshold=SNR, target_header=target))
    check_counts("b", "b run_pipeline sharded", a2a=True)
    del res
    res = sharded("b run_pipeline sharded (second call)",
                  lambda: T.run_pipeline(vr, cmesh, snr_threshold=SNR,
                                         target_header=target))
    ref = timed("b run_pipeline unsharded", lambda: T.run_pipeline(
        vr, snr_threshold=SNR, target_header=target))
    errs["b"] = hold_pipeline("(b)", res, ref)
    log(f"  (b) against the unsharded run: largest errors {errs['b']}")
    del vr, res, ref
    torch.cuda.empty_cache()

    # (c) the spectral path's cube, shard by shard
    path_s = os.path.join(workdir, "spectral.fits")
    scs = timed("c read_sharded_cube", lambda: streaming.read_sharded_cube(
        path_s, cmesh))
    check_shards("c", scs)
    kern = osm.gaussian_kernel1d(SMOOTH_STDDEV)
    grid = scs.spectral_axis[::2]

    def spectral(src):
        si = src.spectral_interpolate(grid, smooth_kernel=kern)
        cl = si.sigma_clip_spectrally(CLIP_SIGMA)
        moms = cl.moment_maps() if isinstance(cl, T.ShardedCube) else (
            cl.moment0(), cl.moment1())
        return si, cl, moms

    out = sharded("c spectral path sharded", lambda: spectral(scs))
    check_counts("c", "c spectral path sharded", halo=False, a2a=False,
                 kernels=SHARDED_KERNELS["c"])
    del out
    si, cl, moms = sharded("c spectral path sharded (second call)",
                           lambda: spectral(scs))
    kernel_errs["c"] = held_run("c", "c spectral path sharded",
                                lambda: spectral(scs), SHARDED_KERNELS["c"])
    cube = T.SpectralCube.read(path_s, device=dev)
    timed("c spectral path unsharded", lambda: spectral(cube))
    rsi, rcl, rmoms = timed("c spectral path unsharded (second call)",
                            lambda: spectral(cube))
    errs["c"] = {
        "interpolated": close_arrays("(c) spectral_interpolate",
                                     si.cube._get_filled_data(fill=np.nan),
                                     rsi._get_filled_data(fill=np.nan),
                                     2e-5, 1e-6),
        "clipped": close_arrays("(c) sigma_clip_spectrally",
                                cl.cube._data, rcl._data, 1e-5, 0.0),
        "mom0": close_arrays("(c) mom0", moms[0].value, rmoms[0].value,
                             3e-5, 1e-6),
        "mom1": close_arrays("(c) mom1", moms[1].value, rmoms[1].value,
                             3e-5, 1e-4)}
    log(f"  (c) against the unsharded calls: largest errors {errs['c']}")
    del si, cl, moms, rsi, rcl, rmoms, scs
    torch.cuda.empty_cache()

    # (d) a tiled CASA image of a slab of that cube streamed onto the mesh
    casa = os.path.join(workdir, "sharded.image")
    slab = cube[:D_NCHAN]
    del cube
    timed("d write CASA, tiled", lambda: write_casa_image(
        slab, casa, tile_shape=IO_TILE))
    del slab
    scd = timed("d read_sharded_casa", lambda: streaming.read_sharded_casa(
        casa, cmesh))
    check_shards("d", scd)
    want = timed("d SpectralCube.read (CASA)", lambda: T.SpectralCube.read(
        casa, device=dev))
    got = scd.cube
    if not (bits_equal(got._data, want._data) and torch.equal(
            got.mask.include(data=got._data).expand(want.shape),
            want.mask.include(data=want._data).expand(want.shape))):
        raise AssertionError("(d) the sharded CASA read is not the read's "
                             "bits and mask")
    if got.wcs.to_header() != want.wcs.to_header() \
            or str(got.unit) != str(want.unit) or got.beam != want.beam:
        raise AssertionError("(d) the sharded CASA read's metadata")
    log("  (d) read_sharded_casa bit for bit the CASA read (data, mask, "
        "WCS cards, unit, beam)")
    del scd, want, got
    shutil.rmtree(casa)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"summary: sharded ({MESH_GRID[0]}x{MESH_GRID[1]} mesh, "
        f"{cmesh.n_devices} shards on {dev}): phase {wall:.1f} s; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items())
        + "; counters " + "; ".join(f"{k}: {v}" for k, v in counters.items())
        + "; peaks " + ", ".join(f"{k} {v / 2**30:.2f} GiB"
                                 for k, v in peaks.items())
        + "; launches " + "; ".join(
            f"{k}: " + ", ".join(f"{n} {c}" for n, c in v.items())
            for k, v in launches.items())
        + "; largest errors " + json.dumps(errs)
        + "; kernels against their plain versions at the shard shapes, "
        "largest errors " + json.dumps(kernel_errs))
    return times, counters, launches


#: dryrun_multichip's 3 x 3 smoothing kernel (``__graft_entry__.py``)
DRYRUN_KERNEL = np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25])


def dryrun_inputs(shape, seed=0):
    """The three float32 cubes ``dryrun_multichip`` draws from
    ``RandomState(seed)``, in its order: the step 1-4 cube, the separable
    convolution's and the smooth + interpolate's."""
    rng = np.random.RandomState(seed)
    return tuple(np.asarray(rng.rand(*shape), dtype=np.float32)
                 for _ in range(3))


def dryrun_steps(cmesh, shape):
    """The port's form of ``dryrun_multichip``'s six steps on ``cmesh``
    at ``shape``: (1) masked moments (include > 0.3) of the sharded cube;
    (2) the global mean of the included voxels, a tree over the mesh; (3)
    the included values (zero elsewhere) smoothed by the 3 x 3 kernel in
    a halo exchange (``halo_pad`` by one row and column, a valid
    ``conv2d`` on each block); (4) that result through the FFT route with
    a transfer of ones (two all-to-alls each way); (5) the per-channel
    separable convolution of a second cube with the kernel and the
    identity in alternate channels (the halo route); (6) the fused
    spectral smooth + interpolation of a third cube onto every second
    channel.  Returns {step: result}, the maps and cubes ShardedArrays,
    the mean a float."""
    import torch
    import torch.nn.functional as F
    from spectral_cube_tpu_torch import parallel as par
    nchan, ny, nx = shape
    coords = np.arange(nchan, dtype=np.float64) * 0.5
    data, data2, data3 = dryrun_inputs(shape)
    include = data > 0.3
    src = cmesh.shard(data, "spatial")
    out = {"moments": par.sharded_moments(src, coords, 0.5, cmesh,
                                          include=include),
           "mean": par.sharded_statistics(src, cmesh,
                                          include=include)["mean"]}
    filled = src.map(lambda d: torch.where(d > 0.3, d, 0.0))
    kern = torch.as_tensor(DRYRUN_KERNEL[::-1, ::-1].copy(),
                           dtype=torch.float32)
    with_halo = par.halo_pad(cmesh._tile(filled, "spatial", 0.0), cmesh,
                             1, 1)
    smooth = cmesh._from_spatial(
        [F.conv2d(b[:, None], kern.to(b.device)[None, None])[:, 0]
         for b in with_halo], shape)
    del with_halo
    out["halo smooth"] = smooth
    ones = np.ones((1, ny + 2, (nx + 2) // 2 + 1), np.complex64)
    out["fft"] = par.sharded_spectral_convolve_fft(
        smooth, ones, np.zeros(nchan, np.int32), cmesh)
    out["separable"] = par.sharded_convolve_per_channel_separable(
        data2, [DRYRUN_KERNEL / DRYRUN_KERNEL.sum(), None],
        (np.arange(nchan) % 2).astype(np.int32), cmesh)
    out["smooth_interpolate"] = par.sharded_smooth_interpolate(
        data3, np.array([0.25, 0.5, 0.25]), coords, coords[::2], cmesh)[0]
    return out


def dryrun_pipeline_cube(shape, device):
    """``_dryrun_product_pipeline``'s cube (``__graft_entry__.py``) on
    ``device``: rand from ``RandomState(5)`` with one NaN, 2" pixels, a
    4-pixel beam, NaN fill; and its target header, shifted by (0.37,
    0.61) pixels."""
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.io.fits_low import Header, HDU
    nchan, ny, nx = shape
    h = Header()
    for key, val in (
            ("SIMPLE", True), ("BITPIX", -32), ("NAXIS", 3),
            ("NAXIS1", nx), ("NAXIS2", ny), ("NAXIS3", nchan),
            ("CTYPE1", "RA---SIN"), ("CRVAL1", 23.18), ("CDELT1", -5.556e-4),
            ("CRPIX1", 2.0), ("CUNIT1", "deg"),
            ("CTYPE2", "DEC--SIN"), ("CRVAL2", 30.58), ("CDELT2", 5.556e-4),
            ("CRPIX2", 2.0), ("CUNIT2", "deg"),
            ("CTYPE3", "VRAD"), ("CRVAL3", -321.2), ("CDELT3", 1.28),
            ("CRPIX3", 1.0), ("CUNIT3", "km/s"),
            ("RESTFRQ", 1.42040571841e9), ("SPECSYS", "BARYCENT"),
            ("BUNIT", "K"), ("BMAJ", 5.556e-4 * 4), ("BMIN", 5.556e-4 * 4),
            ("BPA", 0.0)):
        h[key] = val
    rng = np.random.RandomState(5)
    data = rng.rand(nchan, ny, nx).astype(np.float32)
    data[1, 1, 1] = np.nan
    cube = T.SpectralCube.read(HDU(data=data, header=h), device=device) \
        .with_fill_value(np.nan)
    th = cube.header
    th["CRVAL1"] = float(th["CRVAL1"]) + 0.37 * float(th["CDELT1"])
    th["CRVAL2"] = float(th["CRVAL2"]) + 0.61 * float(th["CDELT2"])
    return cube, th


def dryrun_pipeline(cmesh, shape=(48, 80, 96), device="cpu"):
    """``_dryrun_product_pipeline``'s call on ``cmesh``: ``run_pipeline``
    of its cube sharded on the mesh (a ShardedCube) to a 40" beam (a halo
    wider than a tile: the FFT reshard), SNR 1 over a noise of 0.28 K,
    onto the shifted grid (the halo reprojection).  Returns the sharded
    cube and the result."""
    import spectral_cube_tpu_torch as T
    cube, th = dryrun_pipeline_cube(shape, device)
    sc = T.ShardedCube(cube, cmesh)
    del cube
    res = T.run_pipeline(sc, cmesh, snr_threshold=1.0,
                         target_beam=T.Beam(T.Quantity(40.0, "arcsec"),
                                            T.Quantity(40.0, "arcsec"),
                                            T.Quantity(0.0, "deg")),
                         noise_estimate=T.Quantity(0.28, "K"),
                         target_header=th)
    return sc, res


def distinct_meshes(dev):
    """The distinct-mesh phase's meshes, each beside the same grid of
    ``dev`` alone: D4, a 2 x 2 mesh with ``dev`` on the diagonal and the
    host on the other two positions (every neighbour along either mesh
    axis on the other device), and D2, ``[dev, host]``.  ``{name: (mesh,
    reference mesh)}``."""
    import torch
    import spectral_cube_tpu_torch as T
    host = torch.device("cpu")
    return {"D4": (T.CubeMesh(devices=[dev, host, host, dev], shape=(2, 2)),
                   T.CubeMesh(devices=[dev] * 4, shape=(2, 2))),
            "D2": (T.CubeMesh(devices=[dev, host], shape=(1, 2)),
                   T.CubeMesh(devices=[dev] * 2, shape=(1, 2)))}


def placement_errors(val, cmesh):
    """The blocks of the ShardedArrays and ShardedCubes in ``val`` (a
    result: nested tuples, lists and dicts) that do not lie on their mesh
    position's device: a list of (position, device, wanted)."""
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.parallel import ShardedArray
    bad = []
    if isinstance(val, T.ShardedCube):
        arrays = [val._data] + ([] if val._include is None
                                else [val._include])
    elif isinstance(val, ShardedArray):
        arrays = [val]
    elif isinstance(val, dict):
        return [b for v in val.values() for b in placement_errors(v, cmesh)]
    elif isinstance(val, (tuple, list)):
        return [b for v in val for b in placement_errors(v, cmesh)]
    else:
        return bad
    for arr in arrays:
        if arr.cmesh is not cmesh:
            bad.append(("mesh", arr.cmesh, cmesh))
            continue
        for p, (b, want) in enumerate(zip(arr.blocks, cmesh.devices)):
            if b.device != want:
                bad.append((p, b.device, want))
    return bad


def host_values(val):
    """A result as host values, for holding two meshes' results against
    each other: a ShardedCube its NaN-filled data (``filled_data``, shard
    by shard) and its unit, a ShardedArray its host gather, a Quantity,
    Projection or tensor its values as numpy, Python numbers as they are;
    tuples, lists and dicts element by element."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.parallel import ShardedArray
    if isinstance(val, T.ShardedCube):
        return (str(val.unit), np.asarray(val.filled_data[:].value))
    if isinstance(val, ShardedArray):
        return val.gather(torch.device("cpu")).numpy()
    if isinstance(val, dict):
        return {k: host_values(v) for k, v in val.items()}
    if isinstance(val, (tuple, list)):
        return tuple(host_values(v) for v in val)
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    if hasattr(val, "value") and hasattr(val, "unit"):
        return (str(val.unit), np.asarray(val.value))
    return val


def hold_values(tag, got, want, tol):
    """Host values of one call on two meshes (:func:`host_values`): equal
    structure, units and integers, NaN patterns exact, floats within
    ``tol`` (rtol, atol; rtol of the largest magnitude).  Returns the
    largest absolute difference."""
    rtol, atol = tol
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{tag}: keys {sorted(got)} vs "
                                 f"{sorted(want)}")
        return max([hold_values(f"{tag}[{k!r}]", got[k], want[k], tol)
                    for k in want], default=0.0)
    if isinstance(want, tuple):
        if not isinstance(got, tuple) or len(got) != len(want):
            raise AssertionError(f"{tag}: {type(got)} vs a tuple of "
                                 f"{len(want)}")
        return max([hold_values(f"{tag}[{i}]", g, w, tol)
                    for i, (g, w) in enumerate(zip(got, want))],
                   default=0.0)
    if isinstance(want, str) or want is None:
        if got != want:
            raise AssertionError(f"{tag}: {got!r} vs {want!r}")
        return 0.0
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape or g.dtype.kind != w.dtype.kind:
        raise AssertionError(f"{tag}: {g.dtype}{g.shape} vs "
                             f"{w.dtype}{w.shape}")
    if w.dtype.kind not in "fc":
        if not np.array_equal(g, w):
            raise AssertionError(f"{tag}: {g} vs {w}")
        return 0.0
    gn, wn = np.isnan(g), np.isnan(w)
    if not np.array_equal(gn, wn):
        raise AssertionError(f"{tag}: NaN patterns differ in "
                             f"{int((gn != wn).sum())} places")
    if not (~wn).any():
        return 0.0
    diff = np.abs(g[~wn].astype(np.float64) - w[~wn])
    scale = float(np.abs(w[~wn]).max())
    err = float(diff.max())
    if err > rtol * scale + atol:
        raise AssertionError(f"{tag}: {err:.3e} apart, limit "
                             f"{rtol:g} x {scale:.3e} + {atol:g}")
    return err


def hold_structure(tag, got, want):
    """Host values of one call on two meshes held by their structure
    alone: keys, lengths, units and array shapes equal.  Returns the
    largest absolute difference of the floats both hold finite and the
    count of NaN states that differ (logged, not held)."""
    if isinstance(want, dict) or isinstance(want, tuple):
        keys = sorted(want) if isinstance(want, dict) else range(len(want))
        if (sorted(got) if isinstance(got, dict) else range(len(got))) \
                != keys:
            raise AssertionError(f"{tag}: {got!r} vs {want!r}")
        out = [hold_structure(f"{tag}[{k!r}]", got[k], want[k])
               for k in keys]
        return (max([e for e, _ in out], default=0.0),
                sum(n for _, n in out))
    if isinstance(want, str) or want is None:
        if got != want:
            raise AssertionError(f"{tag}: {got!r} vs {want!r}")
        return 0.0, 0
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape:
        raise AssertionError(f"{tag}: shapes {g.shape} vs {w.shape}")
    if w.dtype.kind != "f":
        return float(np.abs(g.astype(np.float64) - w).max()) if w.size \
            else 0.0, 0
    both = ~np.isnan(g) & ~np.isnan(w)
    err = float(np.abs(g[both].astype(np.float64) - w[both]).max()) \
        if both.any() else 0.0
    return err, int((np.isnan(g) != np.isnan(w)).sum())


def conv_den64(cube, beam):
    """Each voxel's float64 denominator 1 - K*~finite of
    ``cube.convolve_to(beam)`` (a cube on the card, single-beam or
    varying-resolution): the valid share of the kernel's footprint, by
    which the normalized convolution's float32 rounding is divided.  The
    FFT form of the same kernels (zero outside the plane, as both routes
    take it); a host array."""
    import torch
    from spectral_cube_tpu_torch.ops import convolve as oc
    from spectral_cube_tpu_torch.ops import reductions as rd
    nchan = cube.shape[0]
    vr = getattr(cube, "_beams", None) is not None
    beams = list(cube.unmasked_beams) if vr else [cube.beam] * nchan
    good = np.asarray(cube.goodbeams_mask) if vr else np.ones(nchan, bool)
    beams = [b if g else beam for b, g in zip(beams, good)]
    groups, gidx = oc.beam_groups(beams)
    pix = float(np.mean(np.abs(
        cube.wcs.celestial.proj_plane_pixel_scales()))) * np.pi / 180.0
    kernels = [None if beam.deconvolve(b).major_rad <= 0
               else beam.deconvolve(b).as_kernel(pix) for b in groups]
    bad = (~rd.finite(cube._get_filled_data(fill=np.nan))).double()
    fy, fx = oc._padded_shape(bad.shape[1:], tuple(np.max(
        [k.shape for k in kernels if k is not None] or [(1, 1)], axis=0)))
    tr = oc._transfers(kernels, fy, fx, bad.device, torch.complex128)
    den = 1.0 - oc._convolve_planes(bad, tr, gidx)
    del bad, tr
    return den.cpu().numpy()


def dm_stages(dev, cmesh, p_path, vr_path, run, convolved, full=True):
    """The distinct-mesh phase's stages on ``cmesh``, each through
    ``run(name, fn, kind)`` (``kind``: how its result is held, see
    :func:`phase_distinct_mesh`): dryrun_multichip's six steps at
    DM_DRYRUN_SHAPE (:func:`dryrun_steps`, run as one call, held step by
    step) and its product pipeline (:func:`dryrun_pipeline`); the
    DM_NCHAN-channel cube of ``p_path`` streamed onto the mesh and
    ``run_pipeline`` at SNR onto the shifted grid of ``convolved["p"]``,
    its unsharded convolution on the card (the same input on every
    mesh).  With ``full``, also that cube's ``convolve_to`` on the mesh,
    ``run_pipeline`` end to end, M's reductions and MS's stages
    (:func:`card_ms_stages`) on the read, and V (a): the 4-D file
    ``vr_path`` read onto the card, ``to_sharded``, its convolution to
    the common beam (the FFT route), ``run_pipeline`` of
    ``convolved["v"]`` onto the rotated grid and end to end; last a
    float64 read's ``statistics()``."""
    import numpy as np
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.io import streaming
    steps = {}

    def step(name):
        def fn():
            if not steps:
                steps.update(dryrun_steps(cmesh, DM_DRYRUN_SHAPE))
            return steps[name]
        return fn
    run("dryrun steps", step("moments"), "kernel")
    for name in ("moments", "mean", "halo smooth", "fft", "separable",
                 "smooth_interpolate"):
        run(f"dryrun {name}", step(name), "step")
    steps.clear()
    run("dryrun pipeline", lambda: dryrun_pipeline(
        cmesh, (48, 80, 96), dev)[1], "kernel")
    _, target_beam = beams()
    sc = run("read", lambda: streaming.read_sharded_cube(p_path, cmesh),
             "exact")
    target = shifted_header(sc.header, *SHIFT)
    run("run_pipeline of the convolved cube", lambda: T.run_pipeline(
        convolved["p"], cmesh, snr_threshold=SNR, target_header=target),
        "kernel")
    if not full:
        return
    run("convolve_to", lambda: sc.convolve_to(target_beam), "conditioned")
    run("run_pipeline", lambda: T.run_pipeline(
        sc, cmesh, snr_threshold=SNR, target_beam=target_beam,
        target_header=target), "structure")
    for name, fn in CARD_M_REDUCTIONS.items():
        run(name, lambda: fn(sc), "exact" if name in CARD_M_EXACT
            else "kernel" if name.startswith("statistics") else "sum")
    for name, fn, _ in card_ms_stages(sc):
        run(name, lambda: fn(sc), "kernel")
    del sc
    torch.cuda.empty_cache()
    vr = T.SpectralCube.read(vr_path)
    vsc = run("V (a) to_sharded", lambda: vr.to_sharded(cmesh), "exact")
    del vr
    vtarget = rotated_header(vsc.header, VR_ROTATION)
    run("V (a) convolve_to", lambda: vsc.convolve_to(vsc.common_beam()),
        "conditioned")
    run("V (a) run_pipeline of the convolved cube", lambda: T.run_pipeline(
        convolved["v"], cmesh, snr_threshold=SNR, target_header=vtarget),
        "kernel")
    run("V (a) run_pipeline", lambda: T.run_pipeline(
        vsc, cmesh, snr_threshold=SNR, target_header=vtarget), "structure")
    del vsc
    torch.cuda.empty_cache()
    run("statistics() float64", lambda: statistics_values(
        streaming.read_sharded_cube(p_path, cmesh,
                                    dtype=np.float64).statistics()),
        "kernel")


def phase_distinct_mesh(dev, workdir):
    """The sharded path on meshes of distinct devices
    (:func:`distinct_meshes`: the card and the host, whose positions run
    the plain versions), the port's counterpart of the JAX package's
    ``dryrun_multichip`` on 8 devices: :func:`dm_stages` on each mesh
    (D2 without the ``full`` part) and on its reference mesh of the card
    alone, the reference first, the pipelines of the convolved cubes on
    the unsharded convolutions on the card.  Each stage's counters, launches and
    device peak reset just before it and read just after; held against
    the reference's same stage: the mesh's counters equal (gathers 0),
    each kernel launched the card's positions' share of the reference's
    launches (the card's positions run the kernels, the host's none),
    every block of a result on its position's device, and its values by
    its kind: "exact" bit for bit, "sum" within 1e-6 and "kernel" within
    the kernels' tolerance against their plain versions (DM_TOLERANCES,
    rtol of the largest magnitude), NaN patterns exact; "step" as
    "kernel", one step of a call already counted; "conditioned" (a
    normalized convolution, whose float32 rounding is divided by its
    denominator den: :func:`conv_den64`) by :func:`compare_conv`'s rule,
    NaN states free only where den <= 1e-5 and the differences times den
    within 1e-5; "structure" (a pipeline end to end, whose SNR mask
    follows the convolution's rounding across its threshold) its keys,
    shapes and units, its NaN flips and largest difference logged.
    Returns the summary line."""
    import torch
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    log(f"phase distinct mesh ({DM_NCHAN} x {NY} x {NX} files, "
        f"dryrun steps at {DM_DRYRUN_SHAPE})")
    t_phase = time.perf_counter()
    data = synth_cube(DM_NCHAN, NY, NX, SEED + 40)
    p_path = os.path.join(workdir, "dm_cube.fits")
    write_fits(p_path, [HDU(data=data, header=synth_header(DM_NCHAN, NY,
                                                           NX))])
    vr_path = os.path.join(workdir, "dm_vr.fits")
    flagged = (DM_NCHAN // 2, DM_NCHAN // 2 + 1)
    data[list(flagged)] = np.nan
    write_vr_fits(vr_path, data, vr_beams(DM_NCHAN, flagged=flagged))
    del data
    import spectral_cube_tpu_torch as T
    _, target_beam = beams()
    cube = T.SpectralCube.read(p_path, device=dev)
    vr = T.SpectralCube.read(vr_path, device=dev)
    dens = {"convolve_to": conv_den64(cube, target_beam),
            "V (a) convolve_to": conv_den64(vr, vr.common_beam())}
    convolved = {"p": cube.convolve_to(target_beam),
                 "v": vr.convolve_to(vr.common_beam())}
    del cube, vr
    torch.cuda.empty_cache()
    meshes = distinct_meshes(dev)
    times, holds, launches, counters, worst, flips = {}, 0, {}, {}, {}, {}
    peak = 0

    for mname, (cmesh, ref_mesh) in meshes.items():
        ref = {}
        cuda_share = (sum(d.type == "cuda" for d in cmesh.devices),
                      cmesh.n_devices)

        def run(name, fn, mesh):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            mesh.reset_counters()
            t = time.perf_counter()
            val = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            c = dict(mesh.counters)
            n = {k: v for k, v in K.launch_counts().items() if v}
            bad = placement_errors(val, mesh)
            return val, ms, c, n, bad, host_values(val)

        def ref_run(name, fn, kind):
            val, ms, c, n, bad, hv = run(name, fn, ref_mesh)
            if bad:
                raise AssertionError(f"{mname} reference {name}: blocks "
                                     f"off their positions {bad}")
            ref[name] = (ms, c, n, hv)
            return val

        def mixed_run(name, fn, kind):
            nonlocal holds, peak
            val, ms, c, n, bad, hv = run(name, fn, cmesh)
            peak = max(peak, torch.cuda.max_memory_allocated())
            rms, rc, rn, rhv = ref[name]
            tag = f"{mname} {name}"
            if bad:
                raise AssertionError(f"{tag}: blocks off their positions "
                                     f"{bad}")
            if kind != "step":
                times[tag] = (ms, rms)
                counters[tag] = c
                launches[tag] = n
                if c != rc or c["gathers"] != 0:
                    raise AssertionError(f"{tag}: counters {c}, on the "
                                         f"card alone {rc}")
                share = {k: v * cuda_share[0] // cuda_share[1]
                         for k, v in rn.items()}
                if any(v * cuda_share[0] % cuda_share[1]
                       for v in rn.values()) or n != {
                           k: v for k, v in share.items() if v}:
                    raise AssertionError(
                        f"{tag}: launches {n}, the card's positions' share "
                        f"of the card alone's {rn} is {share}")
            if kind == "conditioned":
                ok, err, nflip = near_float64(
                    hv[1], rhv[1], dens[name] <= 1e-5,
                    np.minimum(dens[name], 1.0), DM_TOLERANCES["kernel"][0])
                if not ok or hv[0] != rhv[0]:
                    raise AssertionError(
                        f"{tag}: {err:.3e} of the largest |value| (times "
                        f"den), {nflip} NaN flips, some where den > 1e-5")
                flips[tag] = nflip
                note = (f"differences times den {err:.3e} of the largest "
                        f"|value|, {nflip} NaN flips at den <= 1e-5")
            elif kind == "structure":
                err, nflip = hold_structure(tag, hv, rhv)
                flips[tag] = nflip
                note = (f"structure equal; {nflip} NaN flips, largest "
                        f"difference {err:.3e} (not held)")
            else:
                err = hold_values(tag, hv, rhv, DM_TOLERANCES[
                    "kernel" if kind == "step" else kind])
                note = f"largest error {err:.3e}"
            if kind != "structure":
                worst[tag] = err
            holds += 1
            log(f"  {tag}: {ms:.1f} ms (card alone {rms:.1f} ms), counters "
                f"{c}, launches {n} (card alone {rn}), {note}")
            return val

        full = mname == "D4"
        t_mesh = time.perf_counter()
        dm_stages(dev, ref_mesh, p_path, vr_path, ref_run, convolved, full)
        times[f"{mname} reference wall"] = time.perf_counter() - t_mesh
        torch.cuda.empty_cache()
        t_mesh = time.perf_counter()
        dm_stages(dev, cmesh, p_path, vr_path, mixed_run, convolved, full)
        times[f"{mname} wall"] = time.perf_counter() - t_mesh
        del ref
        torch.cuda.empty_cache()
    del convolved
    wall = time.perf_counter() - t_phase
    walls = {k: v for k, v in times.items() if k.endswith("wall")}
    stages = {k: v for k, v in times.items() if k not in walls}
    line = (f"summary: distinct mesh (" + "; ".join(
        f"{k} {m.grid[0]}x{m.grid[1]} [" + ", ".join(
            str(d) for d in m.devices) + "]" for k, (m, _) in meshes.items())
        + f"; {DM_NCHAN} x {NY} x {NX}): phase {wall:.1f} s; " + ", ".join(
            f"{k} {v:.1f} s" for k, v in walls.items())
        + "; stage ms (mixed / card alone) " + ", ".join(
            f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in stages.items())
        + f"; {holds} holds, largest error {max(worst.values()):.3e} ("
        + max(worst, key=worst.get) + "); NaN flips " + ", ".join(
            f"{k} {v}" for k, v in flips.items()) + "; launches " + "; ".join(
            f"{k}: " + ", ".join(f"{n} {c}" for n, c in v.items())
            for k, v in launches.items() if v)
        + "; gathers " + str(sum(c["gathers"] for c in counters.values()))
        + f"; peak {peak / 2**30:.2f} GiB")
    log(line)
    return line


@contextlib.contextmanager
def stream_delays(cycles=STREAM_DELAY_CYCLES):
    """The stream-delay probe: inside the block the mesh executor's fork
    (``CubeMesh._fork``, wrapped here, through no switch of the package)
    queues ``torch.cuda._sleep`` of (p + 1) * ``cycles`` clock cycles on
    each CUDA position p's stream after the fork's wait and before the
    position's work.  The positions then finish in another order than
    they start, and an order missing between two streams (a read of a
    block before its writer's stream has written it, a block handed out
    again while another stream reads it) shows as a wrong value.  Yields
    ``{"delays": how many it queued}``."""
    import torch
    from spectral_cube_tpu_torch.parallel import mesh as tmesh
    fork = tmesh.CubeMesh._fork
    queued = {"delays": 0}

    def delayed(self, positions):
        callers = fork(self, positions)
        for p in positions:
            stream = self._streams[p]
            if stream is not None:
                with torch.cuda.stream(stream):
                    torch.cuda._sleep(int(cycles * (p + 1)))
                queued["delays"] += 1
        return callers
    tmesh.CubeMesh._fork = delayed
    try:
        yield queued
    finally:
        tmesh.CubeMesh._fork = fork


def sanitized_pipeline(workdir):
    """One M4 ``run_pipeline(cmesh=)`` on a SANITIZER_SHAPE cube under
    PyTorch's CUDA sanitizer (``torch.cuda._sanitizer``: every PyTorch
    operator's reads and writes of each stream, the events and the
    synchronisations; the executor carries its dispatch mode into the
    workers), run by :func:`sanitizer_start` in a child process.  Prints one
    "sanitizer:" line, the races it reported or none.  The sanitizer sees
    no launch of the port's kernels (they go through ctypes), only the
    PyTorch operators around them."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.io import streaming
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    from spectral_cube_tpu_torch.kernels import _build
    import torch.cuda._sanitizer as csan
    _build.load_library()
    dev = torch.device("cuda", 0)
    nchan, ny, nx = SANITIZER_SHAPE
    path = os.path.join(workdir, "sanitized.fits")
    write_fits(path, [HDU(data=synth_cube(nchan, ny, nx, SEED + 50),
                          header=synth_header(nchan, ny, nx))])
    cmesh = T.CubeMesh(devices=[dev] * 4, shape=MESH_GRID)
    _, target_beam = beams()
    csan.enable_cuda_sanitizer()
    t = time.perf_counter()
    try:
        sc = streaming.read_sharded_cube(path, cmesh)
        res = T.run_pipeline(sc, cmesh, snr_threshold=SNR,
                             target_beam=target_beam,
                             target_header=shifted_header(sc.header, *SHIFT))
        torch.cuda.synchronize()
        finite = int(np.isfinite(np.asarray(res["moments"][0].value)).sum())
        found = (f"no race reported in {time.perf_counter() - t:.1f} s; "
                 f"mom0 finite at {finite} of {ny * nx} spaxels")
    except csan.CUDASanitizerErrors as exc:
        found = (f"{len(exc.errors)} races reported: "
                 + " | ".join(str(e).replace("\n", " ")[:600]
                              for e in exc.errors[:3]))
    print(f"sanitizer: {found}", flush=True)
    os.remove(path)
    return 0


def sanitizer_start(workdir):
    """(c) of the concurrent-positions phase: :func:`sanitized_pipeline`
    started in a child process (the sanitizer stays out of every other
    phase; the child runs beside the probe's phases).  Returns the child,
    or why it did not start."""
    import importlib.util
    if importlib.util.find_spec("torch.cuda._sanitizer") is None:
        return "torch.cuda._sanitizer is absent from this torch"
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.sanitized_pipeline(sys.argv[1]))", workdir],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def sanitizer_finish(child):
    """The "sanitizer:" line's text of a child :func:`sanitizer_start`
    started (waited for, killed past 600 s), or why there is none."""
    if isinstance(child, str):
        return child
    try:
        out, err = child.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        return "the child ran past 600 s and was stopped"
    lines = [ln for ln in out.splitlines() if ln.startswith("sanitizer:")]
    if child.returncode != 0 or not lines:
        return (f"the child exited {child.returncode}: "
                + err.strip()[-1500:].replace("\n", " | "))
    return lines[-1][len("sanitizer: "):]


def phase_concurrent(dev, workdir):
    """The mesh's positions at once (``CubeMesh._each``: a worker and, on
    the card, a stream a position) under probes.  (a), every hold of
    ``phase_sharded`` (M4, four positions on the card) and of
    ``phase_distinct_mesh`` (D4, D2) through concurrent positions, ran in
    those phases, and (d), the traced M4 ``run_pipeline`` whose
    positions' kernels must overlap, in ``phase_sharded``; here (b) both
    phases again under :func:`stream_delays`, every hold unchanged, and
    (c) the CUDA sanitizer on a small M4 ``run_pipeline``
    (:func:`sanitizer_start`, in a child beside (b)).  Returns the
    summary line."""
    log(f"phase concurrent positions: phase_sharded and phase_distinct_mesh "
        f"again, each CUDA position's stream delayed (p + 1) x "
        f"{STREAM_DELAY_CYCLES} cycles before each of its calls")
    t = time.perf_counter()
    child = sanitizer_start(workdir)
    try:
        with stream_delays() as queued:
            phase_sharded(dev, workdir, traced=False)
            phase_distinct_mesh(dev, workdir)
        probe_s = time.perf_counter() - t
    finally:
        found = sanitizer_finish(child)
    line = (f"summary: concurrent positions: stream-delay probe "
            f"({queued['delays']} delays queued): every hold of the sharded "
            f"(M4) and distinct-mesh (D4, D2) phases passed again in "
            f"{probe_s:.1f} s; CUDA sanitizer on an M4 run_pipeline at "
            f"{SANITIZER_SHAPE} (a child beside them, the port's ctypes "
            f"kernels unseen by it): {found}")
    log(line)
    return line


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


def host_memory_line():
    """The host's total and available memory (``/proc/meminfo``)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":")
            info[key] = int(val.split()[0]) * 1024
    return (f"{info['MemAvailable'] / 2**30:.1f} GiB available of "
            f"{info['MemTotal'] / 2**30:.1f}")


def host_rss():
    """The process's resident host memory, bytes: ``VmRSS`` of
    ``/proc/self/status`` where the kernel gives it (some container
    kernels do not), else the resident pages of ``/proc/self/statm``;
    None where neither is there."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


class HostPeak:
    """The peak of :func:`host_rss` while the block runs, sampled every
    5 ms by a thread (``peak`` None where the process's resident memory
    cannot be read)."""

    def __enter__(self):
        import threading
        self.peak = host_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while self.peak is not None and not self._stop.wait(0.005):
            rss = host_rss()
            self.peak = None if rss is None else max(self.peak, rss)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False

    def __str__(self):
        return host_gib(self.peak)


def host_gib(nbytes):
    """A host memory reading (bytes or None) for a log line."""
    return "not measured" if nbytes is None else f"{nbytes / 2**30:.2f} GiB"


def card_tiles(ny, nx, ok=None):
    """(y0, x0) of the CARD_TILE-square tiles the card-scale results are
    held on: the four corners, the last holding the cube's last voxel,
    and the centre; or, given ``ok`` (a host bool plane, the spaxels that
    hold finite values), the four extremes of that footprint, the tile
    after the first such spaxel, those beside the leftmost and the
    rightmost, and the tile that ends at the last (the highest flat
    spaxel index that holds values), and the centre."""
    t = CARD_TILE
    if ok is None:
        return [(0, 0), (0, nx - t), (ny - t, 0), (ny - t, nx - t),
                ((ny - t) // 2, (nx - t) // 2)]
    ys, xs = np.nonzero(ok)

    def at(y, x):
        return (int(min(max(y, 0), ny - t)), int(min(max(x, 0), nx - t)))
    left, right = int(np.argmin(xs)), int(np.argmax(xs))
    return [at(ys[0], xs[0] - t // 2), at(ys[left] - t // 2, xs[left]),
            at(ys[right] - t // 2, xs[right] - t + 1),
            at(ys[-1] - t + 1, xs[-1] - t // 2),
            ((ny - t) // 2, (nx - t) // 2)]


def stats_oracle(data, include, step=64):
    """npts and the float64 sum, mean, sigma (n - 1) and std (n) of the
    finite voxels of ``data`` that ``include(c0, x)`` keeps in the slab
    ``x`` of channels from ``c0``, accumulated on the card ``step``
    channels at a time: the sum first, then the squared deviations from
    the mean; and the largest of them with its first flat index, found in
    the same float64 slabs."""
    import torch
    f64 = torch.float64
    n = 0
    s = torch.zeros((), dtype=f64, device=data.device)
    best, at = -math.inf, 0
    plane = data[0].numel()
    for c0 in range(0, data.shape[0], step):
        x = data[c0:c0 + step]
        ok = torch.isfinite(x) & include(c0, x)
        n += int(ok.sum())
        x64 = torch.where(ok, x.to(f64), 0.0)
        s += x64.sum()
        x64.masked_fill_(~ok, -math.inf)
        i = int(torch.argmax(x64))
        if float(x64.reshape(-1)[i]) > best:
            best, at = float(x64.reshape(-1)[i]), c0 * plane + i
        del x64
    mean = s / n
    s2 = torch.zeros((), dtype=f64, device=data.device)
    for c0 in range(0, data.shape[0], step):
        x = data[c0:c0 + step]
        ok = torch.isfinite(x) & include(c0, x)
        s2 += torch.where(ok, (x.to(f64) - mean) ** 2, 0.0).sum()
    return {"npts": n, "sum": float(s), "mean": float(mean),
            "sigma": float(torch.sqrt(s2 / (n - 1))),
            "std": float(torch.sqrt(s2 / n)), "max": best, "argmax": at}


def spectrum_oracle(data, include, step=64):
    """The float64 mean over each plane of the finite voxels of ``data``
    that ``include(c0, x)`` keeps (NaN where none), ``step`` channels at a
    time on the card: ``mean(axis=(1, 2))``'s oracle."""
    import torch
    out = []
    for c0 in range(0, data.shape[0], step):
        x = data[c0:c0 + step]
        ok = torch.isfinite(x) & include(c0, x)
        s = torch.where(ok, x.double(), 0.0).sum((1, 2))
        n = ok.sum((1, 2))
        out.append(torch.where(n > 0, s / n.clamp(min=1), float("nan")))
    return torch.cat(out).cpu().numpy()


def untiled_convolve1d_nan(x, kernel):
    """``ops/smoothing.convolve1d_nan`` along axis 0 as one whole-cube
    formula, the filled data, numerator, denominator and quotient each a
    cube: the port's function before its blocks, kept to hold that the
    blocks give its values bit for bit where it fits."""
    import torch
    from spectral_cube_tpu_torch.ops import smoothing as osm
    kernel = np.asarray(kernel, dtype=float)
    kernel = kernel / kernel.sum()
    v = torch.isfinite(x)
    num = osm._conv1d_along_axis0(torch.where(v, x, 0).contiguous(), kernel)
    den = 1.0 - osm._conv1d_along_axis0((~v).to(x.dtype).contiguous(),
                                        kernel)
    ok = den > osm.DEN_EPS
    o = torch.where(ok, num / torch.where(ok, den, 1.0), float("nan"))
    return torch.where(v.any(0, keepdim=True), o, float("nan"))


def within_f64(got, want, rtol=1e-6, scale=None):
    """NaN patterns equal and |got - want| <= rtol |want| where finite (host
    arrays), or <= rtol ``scale`` where that is given; returns (ok, the
    largest error over |want| or over ``scale``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isnan(got),
                                                     np.isnan(want)):
        return False, float("inf")
    fin = ~np.isnan(want)
    if not fin.any():
        return True, 0.0
    den = np.abs(want[fin]) if scale is None else scale
    rel = np.abs(got[fin] - want[fin]) / np.maximum(den, 1e-30)
    return bool((rel <= rtol).all()), float(rel.max())


def card_spectral_stages(cube):
    """The spectral path's stages on P: ``(name, the call on a cube, the
    kernel it launches or None)``, the interpolations onto every second
    channel of ``cube``."""
    import spectral_cube_tpu_torch as T
    kern = T.Gaussian1DKernel(SMOOTH_STDDEV)
    grid = cube.spectral_axis[::2]
    return [
        ("spectral_smooth", lambda c: c.spectral_smooth(kern), None),
        ("spectral_interpolate smoothed", lambda c: c.spectral_interpolate(
            grid, smooth_kernel=kern), "smooth_interp"),
        ("spectral_interpolate", lambda c: c.spectral_interpolate(grid),
         None),
        ("sigma_clip_spectrally", lambda c: c.sigma_clip_spectrally(
            CLIP_SIGMA, maxiters=CLIP_ITERS), "sigma_clip"),
        ("sigma_clip_spectrally mad_std", lambda c: c.sigma_clip_spectrally(
            CLIP_SIGMA, maxiters=CLIP_ITERS, stdfunc="mad_std"), None),
        (f"spectral_smooth_median({CARD_MEDIAN_WIDTH})",
         lambda c: c.spectral_smooth_median(CARD_MEDIAN_WIDTH,
                                            raise_error_jybm=False), None)]


#: the cube's other reductions on H: along the spectral axis (maps), and
#: the spectrum and the whole-cube values, each a host value
CARD_ALONG = {"sum(axis=0)": lambda c: c.sum(axis=0),
              "mean(axis=0)": lambda c: c.mean(axis=0),
              "std(axis=0)": lambda c: c.std(axis=0),
              "max(axis=0)": lambda c: c.max(axis=0),
              "min(axis=0)": lambda c: c.min(axis=0),
              "median(axis=0)": lambda c: c.median(axis=0),
              f"percentile({CARD_PERCENTILE:g}, axis=0)":
                  lambda c: c.percentile(CARD_PERCENTILE, axis=0),
              "mad_std(axis=0)": lambda c: c.mad_std(axis=0)}
CARD_WHOLE = {"mean(axis=(1, 2))":
                  lambda c: np.asarray(c.mean(axis=(1, 2)).value),
              "std()": lambda c: float(c.std().value),
              "max()": lambda c: float(c.max().value),
              "argmax()": lambda c: tuple(int(i) for i in c.argmax())}


def card_vr_file(host, workdir):
    """V's file: P's host copy ``host`` written as a 4-D FITS file with a
    CASA BEAMS table (``vr_beams`` at its channels, VR_FLAGGED flagged).
    Returns its path and the seconds the write took."""
    path = os.path.join(workdir, "card_v.fits")
    t0 = time.perf_counter()
    write_vr_fits(path, host, vr_beams(host.shape[0], flagged=VR_FLAGGED))
    return path, time.perf_counter() - t0


def card_vr_read(path):
    """V's file ``path`` read back with no device argument and deleted.
    Returns the cube and the seconds the read took."""
    import torch
    import spectral_cube_tpu_torch as T
    try:
        t0 = time.perf_counter()
        cube = T.SpectralCube.read(path)
        torch.cuda.synchronize()
        read = time.perf_counter() - t0
    finally:
        os.remove(path)
    return cube, read


def card_vr_cube(host, workdir):
    """V: :func:`card_vr_file` of ``host``, read back by
    :func:`card_vr_read`.  Returns the cube and the seconds the write and
    the read took."""
    path, wrote = card_vr_file(host, workdir)
    cube, read = card_vr_read(path)
    return cube, wrote, read


def card_vr_grouped(cube):
    """V (b): ``cube``'s data and mask with PA-0 beams held over
    VR_GROUP-channel groups (``vr_beams(pa=(0, 0), group=VR_GROUP)``),
    which take the per-channel separable route."""
    import spectral_cube_tpu_torch as T
    major, minor, pa = vr_beams(cube.shape[0], pa=(0.0, 0.0), group=VR_GROUP)
    beams = T.Beams(major=T.Quantity(major, "arcsec"),
                    minor=T.Quantity(minor, "arcsec"),
                    pa=T.Quantity(pa, "deg"))
    return T.VaryingResolutionSpectralCube(cube._data, cube.wcs,
                                           mask=cube.mask,
                                           header=cube.header, beams=beams)


def card_vr_stages(cube, target, staged):
    """V (a) in ``run_pipeline``'s stages, as ``phase_vrsc`` stages them:
    ``common_beam``, ``convolve_to`` (the FFT route), ``mad_std``,
    moments, ``statistics()`` and the rotated ``reproject`` (the
    four-corner gather), each through ``staged(name, fn)``.  Returns the
    convolved cube, the noise, the masked cube, the moments, the
    statistics and the reprojected cube."""
    import spectral_cube_tpu_torch as T
    cb = staged("common_beam", cube.common_beam)
    conv = staged("convolve_to", lambda: cube.convolve_to(cb))
    noise = staged("mad_std", lambda: float(conv.mad_std().value))
    masked = conv.with_mask(conv > T.Quantity(SNR * noise, conv.unit))
    mom = staged("moments", masked._moments012)
    stats = staged("statistics", masked.statistics)
    rep = staged("reproject", lambda: masked._reproject(target))
    return conv, noise, masked, mom, stats, rep


def card_s_stages(cube):
    """S: ``cube.reproject`` onto a spectral axis of one channel fewer
    (CARD_S_STEP) on the grid shifted by SHIFT: ``(name, the call on a
    cube, the kernel it launches)``, bilinear (#7, ``resample2_filled``)
    and bicubic (#14, ``banded_matmul``, then the separable spatial
    products)."""
    def call(order):
        def run(c):
            c.allow_huge_operations = True
            return c.reproject(spectral_target(
                c.header, (c.shape[0] - 1,) + CARD_S_STEP), order=order)
        return run
    return [("reproject bilinear", call("bilinear"), "resample2_filled"),
            ("reproject bicubic", call("bicubic"), "banded_matmul")]


def card_f64_cube(cube):
    """A float64 copy of ``cube`` (read from FITS) under the finiteness
    mask a read gives."""
    import torch
    import spectral_cube_tpu_torch as T
    data = cube._data.double()
    return T.SpectralCube(data, cube.wcs, header=cube.header,
                          mask=T.LazyMask(torch.isfinite, data=data,
                                          wcs=cube.wcs))


def float64_fft_convolve_to(cube, beam):
    """``cube.convolve_to(beam)`` on the FFT route in float64 (complex128
    transfers of the same kernels), and each voxel's float64 denominator
    1 - K*~finite: host arrays, the flagged planes NaN, the Jy/beam
    factors applied."""
    import torch
    from spectral_cube_tpu_torch.ops import convolve as oc
    from spectral_cube_tpu_torch.ops import reductions as rd
    filled = cube._get_filled_data(fill=np.nan).double()
    pix = float(np.mean(np.abs(
        cube.wcs.celestial.proj_plane_pixel_scales()))) * np.pi / 180.0
    good = np.asarray(cube.goodbeams_mask)
    beams = [b if g else beam for b, g in zip(cube.unmasked_beams, good)]
    groups, gidx = oc.beam_groups(beams)
    kernels = [None if beam.deconvolve(b).major_rad <= 0
               else beam.deconvolve(b).as_kernel(pix) for b in groups]
    fy, fx = oc._padded_shape(filled.shape[1:], tuple(np.max(
        [k.shape for k in kernels if k is not None] or [(1, 1)], axis=0)))
    tr = oc._transfers(kernels, fy, fx, filled.device, torch.complex128)
    out = oc._convolve_planes(filled, tr, gidx)
    den = 1.0 - oc._convolve_planes((~rd.finite(filled)).double(), tr, gidx)
    out[torch.as_tensor(np.flatnonzero(~good), device=out.device)] = np.nan
    factors = torch.as_tensor([oc.beam_unit_factor(cube.unit, b, beam)
                               for b in beams], dtype=torch.float64,
                              device=out.device)
    out *= factors[:, None, None]
    return out.cpu().numpy(), den.cpu().numpy()


def vr_flip_slab(channels=VR_FLIP_CHANNELS, seed=VR_FLIP_SEED):
    """A slab of V (a)'s kind for the FFT route's NaN decisions, as numpy:
    P's 1024 x 1024 planes at ``channels`` of P's 2304 (:func:`synth_cube`'s
    drifting line on unit noise from ``RandomState(seed)``, NaN outside the
    primary beam), each convolved from its :func:`vr_beams` beam to the
    common beam of all 2304 (V (a)'s ``convolve_to``, the FFT route).
    Returns (data (n, ny, nx) float32, complex64 transfers (n, fy,
    fx//2+1), group_idx), the transfers as the port's ``convolve_to``
    builds them."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.ops import convolve as oc
    nchan, ny, nx = CARD_P
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float32)
    ry, rx = (yy - ny / 2) / ny, (xx - nx / 2) / nx
    amp = 6.0 * np.exp(-0.5 * ((ry / 0.2) ** 2 + (rx / 0.25) ** 2))
    centre = nchan / 2 + 0.15 * nchan * rx
    cut = (ry / 0.47) ** 2 + (rx / 0.47) ** 2 > 1.0
    data = np.empty((len(channels), ny, nx), np.float32)
    for i, c in enumerate(channels):
        plane = amp * np.exp(-0.5 * ((c - centre) / (0.02 * nchan)) ** 2)
        plane += rng.standard_normal((ny, nx)).astype(np.float32)
        plane[cut] = np.nan
        data[i] = plane
    major, minor, pa = vr_beams(nchan)
    beams = T.Beams(major=T.Quantity(major, "arcsec"),
                    minor=T.Quantity(minor, "arcsec"),
                    pa=T.Quantity(pa, "deg"))
    common = beams.common_beam()
    pix = PIX_ARCSEC / 3600.0 * np.pi / 180.0
    kernels = [common.deconvolve(beams[c]).as_kernel(pix) for c in channels]
    fy, fx = oc._padded_shape((ny, nx), tuple(np.max(
        [k.shape for k in kernels], axis=0)))
    tr = oc._transfers(kernels, fy, fx, torch.device("cpu"),
                       torch.complex64)
    return data, tr.numpy(), np.arange(len(channels), dtype=np.int32)


def fft_flips(got, data, transfers, group_idx):
    """The NaN decisions of ``got``, the FFT route's float32 result for
    ``data`` (host arrays), against the float64 route (complex128 of the
    same transfers): (the flips, the float64 den 1 - K*~finite at each,
    the voxels whose den lies within the float32 rounding of the 1e-6
    floor, den <= 1e-5)."""
    import torch
    from spectral_cube_tpu_torch.ops import convolve as oc
    x = torch.as_tensor(data, dtype=torch.float64)
    tr = torch.as_tensor(transfers).to(torch.complex128)
    want = oc._convolve_planes(x, tr, group_idx).numpy()
    den = 1.0 - oc._convolve_planes((~torch.isfinite(x)).double(), tr,
                                    group_idx).numpy()
    flip = np.isnan(np.asarray(got)) != np.isnan(want)
    return int(flip.sum()), den[flip], int((den <= 1e-5).sum())


def near_float64(got, want, free, weight=None, rtol=1e-6):
    """A float32 result ``got`` against its float64 form ``want`` (host
    arrays): NaN states equal but where ``free`` (where the NaN test sits
    inside float32 rounding of the quantity it tests), and |got - want|,
    times ``weight`` where given, within ``rtol`` of the largest |want|.
    Returns (ok, that error over the largest |want|, the NaN flips)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    flip = np.isnan(got) != np.isnan(want)
    both = ~np.isnan(got) & ~np.isnan(want)
    if not both.any():
        return not flip.any(), 0.0, int(flip.sum())
    scale = float(np.abs(want[both]).max())
    diff = np.abs(got[both] - want[both])
    if weight is not None:
        diff = diff * weight[both]
    err = float(diff.max()) / max(scale, 1e-30)
    return (not (flip & ~free).any() and err <= rtol), err, int(flip.sum())


def float64_taps(ycl, xcl, order, ny_in, nx_in, dev):
    """The (order + 1)^2 B-spline taps of the nonseparable spline path at
    the maps ``ycl``/``xcl`` with their weights in float64 (the port's
    ``ops/regrid.spline_taps`` casts them to float32): per tap the flat
    indices into the plane padded by ``order`` cells and the (ny * nx,)
    float64 weights, both on ``dev``."""
    import torch
    from spectral_cube_tpu_torch.ops import regrid as og
    nxp = nx_in + 2 * order
    base = np.round if order == 2 else np.floor
    yb, xb = base(ycl).astype(np.int64), base(xcl).astype(np.int64)
    offs = range(-1, 2) if order == 2 else range(-1, 3)
    taps = []
    for dy in offs:
        for dx in offs:
            w = og._bspline(order, ycl - yb - dy) \
                * og._bspline(order, xcl - xb - dx)
            iy = np.clip(yb + dy + order, 0, ny_in + 2 * order - 1)
            ix = np.clip(xb + dx + order, 0, nxp - 1)
            taps.append((torch.as_tensor((iy * nxp + ix).ravel(),
                                         device=dev),
                         torch.as_tensor(w.ravel(), device=dev)))
    return taps


def float64_spline(cube, target, c0, c1, order=3):
    """Output channels ``c0:c1`` of ``cube.reproject(target, order=order)``,
    every product in float64 on the card (the port's float32 operators
    taken to float64), and each voxel's float64 NaN weight: host arrays.
    The spectral operator's rows ``c0:c1`` (none on an untouched spectral
    axis); then on an axis-aligned grid the separable spatial operators,
    on any other the mirror-mode prefilters of both spatial axes, the
    padding and the taps of :func:`float64_taps`, the NaN weights through
    the prefiltered mask's absolute value and the weights' (the port's
    ``ops/regrid._spline_nonseparable_resample``)."""
    import torch
    import torch.nn.functional as F
    from spectral_cube_tpu_torch.ops import regrid as og
    f64 = torch.float64
    nchan, ny_in, nx_in = cube.shape
    zs, ys, xs, _ = og.reproject_mappings(
        cube.wcs, target, nchan,
        spectral_values_in=np.asarray(cube.spectral_axis.value))
    m = og.spline_host_maps(zs, ys, xs, nchan, ny_in, nx_in)
    ny, nx = m.ycl.shape
    if m.z_identity:
        cols, tz = np.arange(c0, c1), np.eye(c1 - c0)
    else:
        tz = og._spline_1d_matrix(nchan, m.zc, order)[c0:c1]
        cols = np.flatnonzero(np.abs(tz).sum(0))
        tz = tz[:, cols]
    data = cube._get_filled_data(fill=np.nan)[
        torch.as_tensor(cols, device=cube.device)]
    dev = data.device

    def op(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    def spectral(z, a):
        return (op(z) @ a.reshape(len(cols), -1)).reshape(-1, ny_in, nx_in)

    if m.separable:
        ty = og._spline_1d_matrix(ny_in, m.ycl[:, 0], order)
        tx = og._spline_1d_matrix(nx_in, m.xcl[0, :], order)

        def spatial(fz, absolute):
            y, x = (np.abs(ty), np.abs(tx)) if absolute else (ty, tx)
            return op(y) @ fz @ op(x).t()
    else:
        py = op(og._spline_prefilter_matrix(ny_in, order))
        px = op(og._spline_prefilter_matrix(nx_in, order))
        taps = float64_taps(m.ycl, m.xcl, order, ny_in, nx_in, dev)
        mode = "reflect" if min(ny_in, nx_in) > order else "replicate"

        def spatial(fz, absolute):
            c = py @ fz @ px.t()
            if absolute:
                c = c.abs()
            c = F.pad(c[None], (order,) * 4, mode=mode)[0]
            c = c.reshape(c.shape[0], -1)
            acc = torch.zeros((c.shape[0], ny * nx), dtype=f64, device=dev)
            for idx, w in taps:
                acc += c[:, idx] * (w.abs() if absolute else w)
            return acc.reshape(-1, ny, nx)
    out = spatial(spectral(tz, torch.nan_to_num(data.to(f64))), False)
    wn = spatial(spectral(np.abs(tz), torch.isnan(data).to(f64)), True)
    valid = torch.as_tensor((m.yvalid & m.xvalid)[None], device=dev) \
        & torch.as_tensor(m.zvalid[c0:c1], device=dev)[:, None, None]
    out = torch.where(valid & ~(wn > 1e-6), out, np.nan)
    return out.cpu().numpy(), wn.cpu().numpy()


def card_vr(cube, tiles, nbytes, card, sizes, stages, staged, hold,
            big_launches, time_first_calls, hold_tiles):
    """V on P (``cube``, a varying-resolution cube read from FITS): (a)
    ``run_pipeline`` onto the grid rotated by VR_ROTATION (the FFT route
    over its ~2303 beam groups, moments launched on the whole cube) and
    its stages (:func:`card_vr_stages`); (b) ``convolve_to`` a 12" beam
    from PA-0 beams in VR_GROUP-channel groups (conv_sep launched on the
    whole cube).  Each peak at most CARD_PEAK_SHARE of the card; the
    launches counted over their stage alone.  Held where no plain version
    fits: (a)'s moments and linewidth on the ``tiles`` bit for bit the
    same call on the tile's cut-out (``run_pipeline(noise_estimate=)``),
    the stages bit for bit ``run_pipeline``'s, and on CARD_SLAB-channel
    slabs (first, middle, last and over the flagged planes) the
    reprojected cube bit for bit the slab's (the gather runs per voxel)
    and the convolved cube within 1e-6 of the float64 form
    (:func:`near_float64` by :func:`compare_conv`'s rule: cuFFT's batched
    plans follow the batch; whether
    it is also the slab's call bit for bit is logged); (b) on the slabs
    bit for bit the slab's call.  Returns the summary part."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.ops import convolve as oc
    nchan = cube.shape[0]
    moments, conv_sep = CARD_KERNELS["V"]
    slabs = sorted({0, (nchan - CARD_SLAB) // 2, nchan - CARD_SLAB,
                    VR_FLAGGED[0] - CARD_SLAB // 2})
    target = rotated_header(cube.header, VR_ROTATION)

    def peak_held(name):
        peak = stages[f"V {name}"][1]
        hold(f"V {name} peak at most {CARD_PEAK_SHARE:.0%} of the card",
             peak <= CARD_PEAK_SHARE * card,
             f"({peak / 2**30:.2f} of {card / 2**30:.2f} GiB)",
             f"V {name} peak")

    def staged_v(name, fn):
        return staged("V", name, nbytes, fn)
    # (a) run_pipeline, moments counted over it alone
    with recorded_calls((moments,)) as calls:
        K.reset_launch_counts()
        res = staged_v("run_pipeline", lambda: T.run_pipeline(
            cube, snr_threshold=SNR, target_header=target))
    route = dict(oc.convolve_cube_to_beam.last)
    sizes[moments] = [a[0].numel() for a, _ in calls[moments]]
    launched = [big_launches("V", sizes, (moments,))]
    del calls
    peak_held("run_pipeline")
    hold(f"V (a) route fft with at least {CARD_VR_MIN_GROUPS} beam groups",
         route["route"] == "fft" and route["groups"] >= CARD_VR_MIN_GROUPS,
         f"({route['route']}, {route['groups']} groups, host grouping "
         f"{route['grouping_s'] * 1e3:.1f} ms, kernels and route choice "
         f"{route['kernels_s'] * 1e3:.1f} ms)", "V (a) route")
    conv, noise, masked, mom, stats, rep = card_vr_stages(
        cube, target, staged_v)
    for name in ("common_beam", "convolve_to", "mad_std", "moments",
                 "statistics", "reproject"):
        peak_held(name)
    full = [np.asarray(m.value) for m in res["moments"]]
    with np.errstate(invalid="ignore"):
        staged_moments = [mom[0], mom[1], np.sqrt(mom[2])]
    hold("V stages bit for bit run_pipeline's (moments, linewidth, "
         "reprojected cube, statistics)",
         all(a.tobytes() == np.asarray(b, a.dtype).tobytes()
             for a, b in zip(full, staged_moments))
         and bits_equal(rep._data, res["cube"]._data)
         and all(float(stats[k].value) == float(res["statistics"][k].value)
                 for k in ("sum", "mean", "sigma", "min", "max"))
         and stats["npts"] == res["statistics"]["npts"], "",
         "V stages = run_pipeline")
    del res
    for c in VR_FLAGGED:
        hold(f"V convolved plane {c} (flagged beam) NaN",
             bool(torch.isnan(conv._data[c]).all()), "", f"V flagged {c}")
    hold_tiles("V", full, lambda y0, x0: [
        m.value for m in T.run_pipeline(
            conv[:, y0:y0 + CARD_TILE, x0:x0 + CARD_TILE],
            snr_threshold=SNR, noise_estimate=noise)["moments"]], tiles)
    cb = cube.common_beam()
    bitwise = []
    for c0 in slabs:
        sl = slice(c0, c0 + CARD_SLAB)
        where = f"channels {c0}-{c0 + CARD_SLAB - 1}"
        got = conv._data[sl]
        some = int(torch.isfinite(got).sum())
        hold(f"V convolve_to of {where} holds finite values", some > 0,
             f"({some})", f"V convolve_to slab {c0} finite")
        same = bits_equal(cube[sl].convolve_to(cb)._data, got)
        bitwise.append(same)
        want, den = float64_fft_convolve_to(cube[sl], cb)
        # compare_conv's rule: the NaN test den > 1e-6 is float32
        # rounding itself where den <= 1e-5, and 1/den amplifies it
        ok, err, flips = near_float64(got.cpu().numpy(), want, den <= 1e-5,
                                      np.minimum(den, 1.0))
        hold(f"V convolve_to of {where} within 1e-6 of float64", ok,
             f"({err:.2e} of the largest |value|, {flips} NaN flips at den "
             f"<= 1e-5; bit for bit the slab's: {same})",
             f"V convolve_to slab {c0}")
        slab = masked[sl]
        hold(f"V reproject of {where} bit for bit the slab's",
             bits_equal(slab._reproject(rotated_header(
                 slab.header, VR_ROTATION))._data, rep._data[sl]), "",
             f"V reproject slab {c0}")
        del got, want, den, slab
    del rep, conv, masked
    torch.cuda.empty_cache()
    # the FFT route's NaN decisions on a slab of (a)'s kind, held on the
    # CPU against the JAX route's (tests/test_torch_fft_nan_flips.py): on
    # the card too every flip lies within the float32 rounding of the
    # 1e-6 floor
    data, tr, gidx = vr_flip_slab()
    dev = cube.device
    got = oc._convolve_planes(torch.as_tensor(data, device=dev),
                              torch.as_tensor(tr, device=dev),
                              gidx).cpu().numpy()
    flips, dens, free = fft_flips(got, data, tr, gidx)
    bands = np.histogram(dens, bins=(-np.inf, 1e-7, 5e-7, 1e-6, 2e-6,
                                     1e-5, np.inf))[0].tolist()
    hold("V flip slab: NaN flips only at den <= 1e-5",
         bool((dens <= 1e-5).all()),
         f"({flips} NaN flips of {data.size} voxels, channels "
         f"{VR_FLIP_CHANNELS}, float64 den at the flips < 1e-7, to 5e-7, "
         f"to 1e-6, to 2e-6, to 1e-5, above: {bands}; {free} voxels at "
         "den <= 1e-5)", "V flip slab")
    del data, tr, got
    # (b) the per-channel separable route
    grouped = card_vr_grouped(cube)
    _, target_beam = beams()
    with recorded_calls((conv_sep,)) as calls:
        K.reset_launch_counts()
        out = staged_v("convolve_to (b)",
                       lambda: grouped.convolve_to(target_beam))
    route_b = dict(oc.convolve_cube_to_beam.last)
    sizes[conv_sep] = [a[0].numel() for a, _ in calls[conv_sep]]
    launched.append(big_launches("V", sizes, (conv_sep,)))
    timed = time_first_calls("V", calls, (conv_sep,))
    del calls
    peak_held("convolve_to (b)")
    ngroups = -(-nchan // VR_GROUP)
    hold("V (b) route per_channel_separable",
         route_b["route"] == "per_channel_separable"
         and route_b["groups"] == ngroups,
         f"({route_b['route']}, {route_b['groups']} groups)", "V (b) route")
    for c0 in slabs:
        sl = slice(c0, c0 + CARD_SLAB)
        hold(f"V (b) convolve_to of channels {c0}-{c0 + CARD_SLAB - 1} bit "
             "for bit the slab's", bits_equal(
                 grouped[sl].convolve_to(target_beam)._data, out._data[sl]),
             "", f"V (b) slab {c0}")
    del out, grouped
    torch.cuda.empty_cache()
    return (f"V (a) route {route['route']}, {route['groups']} beam groups; "
            "convolve_to slabs " + ", ".join(map(str, slabs))
            + " bit for bit the slab's call: "
            + ", ".join(map(str, bitwise)) + "; launches "
            + ", ".join(launched) + "; kernel wrapper calls " + timed)


def card_s_f64(cube, nbytes, card, sizes, stages, staged, hold, big_launches,
               time_first_calls, keep):
    """S on P (``cube``, read from FITS): ``reproject`` onto a new spectral
    axis (:func:`card_s_stages`), bilinear (#7 on fz and wz, each
    2,414,870,528 elements) and bicubic (#14 on the filled data and the
    NaN mask, 2,415,919,104 elements), each peak at most CARD_PEAK_SHARE
    of the card, the launches counted over the stage alone; held on
    CARD_SLAB-channel slabs (first, middle, last) of output channels,
    each holding finite values: bilinear bit for bit the same call on the
    slab's cut-out (every kernel input per voxel), bicubic within 1e-6 of
    the largest |value| of its float64 form (:func:`float64_spline`: the
    spatial ``torch.matmul``'s plan follows the batch), and #14's output
    on a column range bit for bit the whole launch's.  Then
    ``statistics()`` of a float64 copy (:func:`card_f64_cube`): its rise
    at most CARD_MAD_RATIO cube bytes of its own, npts the float32
    kernel's exactly, mean and sigma within 1e-6 of it.  Each stage's
    slabs (and the bicubic's float64 forms with their NaN weights) are
    kept in ``keep`` as host arrays under MS's name of the stage
    (:func:`card_ms_stages`), MS's references.  Returns the summary
    part."""
    import torch
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
    from spectral_cube_tpu_torch.ops import regrid as og
    nz = cube.shape[0] - 1
    slabs = (0, (nz - CARD_SLAB) // 2, nz - CARD_SLAB)
    target = spectral_target(cube.header, (nz,) + CARD_S_STEP)
    launched, timed = [], []
    s_stages = card_s_stages(cube)
    if tuple(k for _, _, k in s_stages) != CARD_KERNELS["S"]:
        raise AssertionError(f"S stages' kernels {s_stages}")
    for (name, call, kernel), order in zip(s_stages, ("bilinear", "bicubic")):
        with recorded_calls((kernel,)) as calls:
            K.reset_launch_counts()
            out = staged("S", name, nbytes, lambda: call(cube))
        peak = stages[f"S {name}"][1]
        sizes[kernel] = [a[0].numel() for a, _ in calls[kernel]]
        launched.append(big_launches("S", sizes, (kernel,)))
        args = calls[kernel][0][0]
        if order == "bilinear":
            # fz, wz, wz_any, the taps, the valid plane
            bms, by = filled_bound(args[0], args[2],
                                   args[0].shape[0] * args[7].size)
        else:
            flat, bands = args[:2]
            bms, by = bound((flat.shape[0] + len(bands.start))
                            * flat.shape[1] * 4,
                            2 * int(bands.length.sum()) * flat.shape[1])
        timed.append(time_first_calls("S", calls, (kernel,))
                     + f" (bound {bms:.3f} ms, {by})")
        log(f"  S {kernel} bound {bms:.3f} ms ({by})")
        del calls, args
        hold(f"S {name} peak at most {CARD_PEAK_SHARE:.0%} of the card",
             peak <= CARD_PEAK_SHARE * card,
             f"({peak / 2**30:.2f} of {card / 2**30:.2f} GiB)",
             f"S {name} peak")
        if out.shape != (nz,) + cube.shape[1:]:
            raise AssertionError(f"S {name}: shape {out.shape}")
        kept = keep[f"MS S {name}"] = {"slabs": {}, "f64": {}}
        for c0 in slabs:
            where = f"output channels {c0}-{c0 + CARD_SLAB - 1}"
            got = out._data[c0:c0 + CARD_SLAB]
            kept["slabs"][c0] = got.cpu().numpy()
            some = int(torch.isfinite(got).sum())
            hold(f"S {name} {where} hold finite values", some > 0,
                 f"({some})", f"S {name} slab {c0} finite")
            cut = cube[c0:c0 + CARD_SLAB + 1]
            cut.allow_huge_operations = True
            same = bits_equal(cut.reproject(spectral_target(
                cut.header, (CARD_SLAB,) + CARD_S_STEP), order=order)._data,
                got)
            if order == "bilinear":
                hold(f"S {name} {where} bit for bit the slab's", same, "",
                     f"S {name} slab {c0}")
                continue
            want, wn = float64_spline(cube, target, c0, c0 + CARD_SLAB)
            kept["f64"][c0] = want, wn
            # a float32 sum of the NaN weights may land on either side of
            # the 1e-6 limit where it lies within 1e-6 of it
            ok, err, flips = near_float64(got.cpu().numpy(), want,
                                          np.abs(wn - 1e-6) <= 1e-6)
            hold(f"S {name} {where} within 1e-6 of float64", ok,
                 f"({err:.2e} of the largest |value|, {flips} NaN flips "
                 f"at the 1e-6 weight limit; bit for bit the slab's: "
                 f"{same})", f"S {name} slab {c0}")
        # ``got`` is a view: it holds the whole output alive
        del out, got
        torch.cuda.empty_cache()
    # #14's output on a column range against the whole launch's
    zs, ys, xs, _ = og.reproject_mappings(
        cube.wcs, target, cube.shape[0],
        spectral_values_in=np.asarray(cube.spectral_axis.value))
    m = og.spline_host_maps(zs, ys, xs, *cube.shape)
    bands = og._spectral_route(og._spline_1d_matrix(cube.shape[0], m.zc,
                                                    3))[0]
    flat = torch.nan_to_num(cube._get_filled_data(fill=np.nan)).reshape(
        cube.shape[0], -1)
    whole = kbm.banded_matmul(flat, bands)
    cols = slice(flat.shape[1] // 2, flat.shape[1] // 2 + CARD_TILE ** 2)
    hold("S banded_matmul (#14) on a column range bit for bit the whole "
         "launch's", bits_equal(kbm.banded_matmul(
             flat[:, cols].contiguous(), bands), whole[:, cols]),
         f"(columns {cols.start}-{cols.stop - 1})", "S #14 columns")
    del flat, whole
    torch.cuda.empty_cache()
    # statistics() of a float64 copy
    want = cube.statistics()
    f64 = card_f64_cube(cube)
    got = staged("F", "statistics float64", 2 * nbytes, f64.statistics)
    rise = stages["F statistics float64"][2]
    del f64
    torch.cuda.empty_cache()
    hold(f"F statistics float64 rise at most {CARD_MAD_RATIO} cube bytes",
         rise <= CARD_MAD_RATIO, f"({rise:.3f})", "F statistics rise")
    bad = [k for k in ("mean", "sigma") if abs(
        float(got[k].value) - float(want[k].value))
        > 1e-6 * abs(float(want[k].value))]
    hold("F statistics float64 npts the float32 kernel's, mean and sigma "
         "within 1e-6 of it", got["npts"] == want["npts"] and not bad,
         "(" + ", ".join(f"{k} {float(got[k].value)!r} vs "
                         f"{float(want[k].value)!r}" for k in
                         ("mean", "sigma")) + f", npts {got['npts']})",
         "F statistics")
    return ("S launches " + ", ".join(launched) + "; kernel wrapper calls "
            + ", ".join(timed))


def card_r_stages(cube):
    """R: ``cube.reproject`` onto the grid rotated by VR_ROTATION:
    ``(name, the call on a cube, the kernel it launches or None, the
    order, the target header)``.  Biquadratic with the cube's own spectral
    axis (the spline path's untouched-axis branch: the prefilters and 9
    tap gathers, no kernel), and bicubic onto a spectral axis of one
    channel fewer (CARD_S_STEP) on the grid shifted by SHIFT and rotated
    (#14, ``banded_matmul``, on the filled data and the NaN mask, then the
    prefilters and 16 tap gathers)."""
    h = cube.header
    out = []
    for name, order, target, kernel in (
            ("reproject biquadratic rotated", "biquadratic",
             rotated_header(h, VR_ROTATION), None),
            ("reproject bicubic rotated", "bicubic", rotated_header(
                spectral_target(h, (cube.shape[0] - 1,) + CARD_S_STEP),
                VR_ROTATION), "banded_matmul")):
        def run(c, target=target, order=order):
            c.allow_huge_operations = True
            return c.reproject(target, order=order)
        out.append((name, run, kernel, order, target))
    return out


def spline_slab_stages(cube, target, k0, k1, order):
    """Output channels ``k0:k1`` of the spline path onto ``target`` with
    the cube's own spectral axis, through its stages on those channels
    alone (``ops/regrid.spline_taps``, ``spline_coefficients``,
    ``spline_gathers``, the NaN-weight pass and the validity)."""
    import torch
    from spectral_cube_tpu_torch.ops import regrid as og
    nchan, ny_in, nx_in = cube.shape
    zs, ys, xs, _ = og.reproject_mappings(
        cube.wcs, target, nchan,
        spectral_values_in=np.asarray(cube.spectral_axis.value))
    m = og.spline_host_maps(zs, ys, xs, nchan, ny_in, nx_in)
    if not m.z_identity:
        raise AssertionError("spline_slab_stages: a new spectral axis")
    n = og._order_int(order)
    src = cube._get_filled_data((slice(k0, k1),), fill=np.nan)
    plan = og.spline_taps(m.ycl, m.xcl, n, ny_in, nx_in, cube.device)
    acc = og.spline_gathers(og.spline_coefficients(
        torch.nan_to_num(src), plan, False), plan, False)
    wn = og.spline_gathers(og.spline_coefficients(
        torch.isnan(src).to(torch.float32), plan, True), plan, True)
    acc.masked_fill_(wn > 1e-6, float("nan"))
    del wn
    out = acc.t().reshape((k1 - k0,) + m.ycl.shape)
    ok = torch.as_tensor(m.yvalid & m.xvalid, device=cube.device)
    return out.masked_fill(~ok, float("nan"))


def card_r(cube, nbytes, card, sizes, stages, staged, hold, big_launches,
           keep):
    """R on P (``cube``, read from FITS): :func:`card_r_stages`, each peak
    at most CARD_PEAK_SHARE of the card.  Biquadratic launches no kernel
    (every counter 0 over its stage); bicubic launches #14 on more than
    2**31 elements, counted over its stage alone, and its first operator
    is timed again at P on the filled data.  Held on CARD_SLAB-channel
    slabs (first, middle, last) of output channels, each holding finite
    values, within 1e-6 of the largest |value| of the float64 form
    (:func:`float64_spline`), the NaN states free only where the float64
    NaN weight lies within 1e-6 of the 1e-6 limit; and biquadratic's
    middle slab of the path (``ops/regrid._slabs``) bit for bit its own
    stages (:func:`spline_slab_stages`).  Each stage's slabs and their
    float64 forms with their NaN weights are kept in ``keep`` as host
    arrays under MS's name of the stage (:func:`card_ms_stages`), MS's
    references.  Returns the summary part."""
    import torch
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
    from spectral_cube_tpu_torch.ops import regrid as og
    launched, timed = [], []
    r_stages = card_r_stages(cube)
    if tuple(k for _, _, k, _, _ in r_stages if k) != CARD_KERNELS["R"]:
        raise AssertionError(f"R stages' kernels {r_stages}")
    for name, call, kernel, order, target in r_stages:
        names = (kernel,) if kernel else ()
        with recorded_calls(names, lambda a, kw: a[0].numel()) as calls:
            K.reset_launch_counts()
            out = staged("R", name, nbytes, lambda: call(cube))
        peak = stages[f"R {name}"][1]
        counts = {k: n for k, n in K.launch_counts().items() if n}
        if kernel:
            sizes[kernel] = calls[kernel]
            launched.append(big_launches("R", sizes, names))
        else:
            hold(f"R {name} launches no kernel", not counts, str(counts),
                 f"R {name} launches")
        hold(f"R {name} peak at most {CARD_PEAK_SHARE:.0%} of the card",
             peak <= CARD_PEAK_SHARE * card,
             f"({peak / 2**30:.2f} of {card / 2**30:.2f} GiB)",
             f"R {name} peak")
        nz = int(target["NAXIS3"])
        if out.shape != (nz,) + cube.shape[1:]:
            raise AssertionError(f"R {name}: shape {out.shape}")
        kept = keep[f"MS R {name}"] = {"slabs": {}, "f64": {}}
        for c0 in (0, (nz - CARD_SLAB) // 2, nz - CARD_SLAB):
            where = f"output channels {c0}-{c0 + CARD_SLAB - 1}"
            got = out._data[c0:c0 + CARD_SLAB]
            kept["slabs"][c0] = got.cpu().numpy()
            some = int(torch.isfinite(got).sum())
            hold(f"R {name} {where} hold finite values", some > 0,
                 f"({some})", f"R {name} slab {c0} finite")
            want, wn = float64_spline(cube, target, c0, c0 + CARD_SLAB,
                                      og._order_int(order))
            kept["f64"][c0] = want, wn
            # a float32 sum of the NaN weights may land on either side of
            # the 1e-6 limit where it lies within 1e-6 of it
            ok, err, flips = near_float64(got.cpu().numpy(), want,
                                          np.abs(wn - 1e-6) <= 1e-6)
            hold(f"R {name} {where} within 1e-6 of float64", ok,
                 f"({err:.2e} of the largest |value|, {flips} NaN flips "
                 "at the 1e-6 weight limit)", f"R {name} slab {c0}")
        if kernel is None:
            slabs = og._slabs(nz, cube.shape[1] * cube.shape[2])
            k0, k1 = slabs[len(slabs) // 2]
            hold(f"R {name} output channels {k0}-{k1 - 1} (a slab of the "
                 "path) bit for bit its stages", bits_equal(
                     spline_slab_stages(cube, target, k0, k1, order),
                     out._data[k0:k1]), "", f"R {name} stages")
        # ``got`` is a view: it holds the whole output alive
        del out, got
        torch.cuda.empty_cache()
    # #14's first call at P: the spline operator on the filled data
    zs, ys, xs, _ = og.reproject_mappings(
        cube.wcs, r_stages[1][4], cube.shape[0],
        spectral_values_in=np.asarray(cube.spectral_axis.value))
    m = og.spline_host_maps(zs, ys, xs, *cube.shape)
    bands = og._spectral_route(og._spline_1d_matrix(cube.shape[0], m.zc,
                                                    3))[0]
    flat = torch.nan_to_num(cube._get_filled_data(fill=np.nan)).reshape(
        cube.shape[0], -1)
    ms = cuda_ms(lambda: kbm.banded_matmul(flat, bands), 3)
    bms, by = bound((flat.shape[0] + len(bands.start)) * flat.shape[1] * 4,
                    2 * int(bands.length.sum()) * flat.shape[1])
    timed.append(f"banded_matmul {ms:.3f} ms on {flat.numel()} elements "
                 f"(bound {bms:.3f} ms, {by})")
    log(f"  R {timed[-1]}")
    del flat
    torch.cuda.empty_cache()
    return ("R launches " + ", ".join(launched) + "; kernel wrapper calls "
            + ", ".join(timed))


def card_c_operators(shape):
    """The fused convolve + reproject's inputs on a cube of ``shape`` (the
    conv_reproject phase's and C's): the kernel from CUBE_BEAM to
    TARGET_BEAM, the grid shifted by SHIFT as broadcast axis maps (the
    fused operators' exact alignment), their operators
    (``ops/regrid._conv_reproject_operators``), spectral coordinates of
    step 0.25 and that step, and bench config 5's mask."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.ops import regrid as og
    nchan, ny, nx = shape
    cube_beam, target_beam = beams()
    kern = target_beam.deconvolve(cube_beam).as_kernel(
        np.radians(PIX_ARCSEC / 3600.0))
    ys, xs = axis_maps(ny, nx, 1.0, SHIFT[0], 1.0, SHIFT[1])
    ops = og._conv_reproject_operators(shape, kern, ys, xs)
    if ops is None:
        raise AssertionError("fused operators declined the shifted grid")
    mask = T.LazyComparisonMask(torch.gt, FUSED_THRESHOLD, shape=shape)
    return kern, ys, xs, ops, np.arange(nchan) * 0.25, 0.25, mask


def card_c_stages(inputs):
    """C: ``(name, the call on a cube, its wrapper)``: the fused convolve
    + reproject (#8), its clean branch on one group (#9) and the
    whole-pipeline fusion under bench config 5's mask (#10), on
    ``inputs``, :func:`card_c_operators` of the cube's shape."""
    from spectral_cube_tpu_torch.kernels import conv_reproject as kcr
    from spectral_cube_tpu_torch.ops import pipeline_fused as opf
    from spectral_cube_tpu_torch.ops import regrid as og
    kern, ys, xs, ops, coords, dx, mask = inputs
    gi = np.zeros(mask.shape[0], np.int32)
    return [("convolve_reproject_separable",
             lambda x: og.convolve_reproject_separable(x, kern, ys, xs),
             "conv_reproject"),
            ("plain_strips",
             lambda x: kcr.plain_strips(x, ops.gy, ops.gx, gi),
             "plain_strips"),
            ("moments_conv_reproject_fused",
             lambda x: opf.moments_conv_reproject_fused(
                 x, kern, ys, xs, coords, dx, mask_expr=mask),
             "pipeline_fused")]


def card_c(cube, nbytes, card, sizes, stages, staged, hold, big_launches,
           time_first_calls):
    """C on P's grid shifted by SHIFT (:func:`card_c_stages`): on (a)
    bench config 5's clean synthesis at P's shape, made on the card and
    freed after its stages, all three; on (b) P itself (a NaN border in
    every plane: every channel takes the chain) #8 and #10.  Each peak at
    most CARD_PEAK_SHARE of the card, each kernel launched on more than
    2**31 elements, counted over its own stage alone, and its first call
    timed again with its bound (:func:`conv_reproject_work`).  Held: #8's
    route ``fused``; #8's and #9's outputs on CARD_SLAB-channel slabs
    (first, middle, last; the last past 2**31 elements) bit for bit the
    same kernel on the slab's contiguous cut-out and within 1e-5 of the
    plain version on it; #9 bit for bit (a)'s #8 where the output is in
    range; #10 not None, its cube bit for bit #8's, its planes against
    ``kernels.moments.moments_planes`` on the whole cube (bit for bit, or
    within :func:`compare_moment_planes`' bound) and its statistics (npts
    exact, the rest within 3e-6) against ``moments_012_kernel(...,
    with_stats=True)``.  Returns the summary part."""
    import torch
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.kernels import conv_reproject as kcr
    from spectral_cube_tpu_torch.kernels import pipeline_fused as kpf
    from spectral_cube_tpu_torch.ops import moments as om
    from spectral_cube_tpu_torch.ops import regrid as og
    dev = cube.device
    nchan = cube.shape[0]
    inputs = card_c_operators(cube.shape)
    _, _, _, ops, coords, dx, mask = inputs
    args = (ops.gy, ops.gx, ops.my, ops.mx, ops.ry, ops.rx, ops.valid)
    gi = np.zeros(nchan, np.int32)
    c_stages = card_c_stages(inputs)
    if tuple(k for _, _, k in c_stages) != CARD_KERNELS["C"]:
        raise AssertionError(f"C stages' kernels {c_stages}")
    slabs = (0, (nchan - CARD_SLAB) // 2, nchan - CARD_SLAB)
    ok_plane = torch.as_tensor(ops.valid, device=dev)
    launched, timed, planes_same = [], [], {}

    def hold_slabs(tag, got, x, launch, plain):
        for c0 in slabs:
            sl = slice(c0, c0 + CARD_SLAB)
            cut = x[sl].contiguous()
            where = f"channels {c0}-{c0 + CARD_SLAB - 1}"
            hold(f"C {tag} {where} bit for bit the kernel on the slab",
                 bits_equal(launch(cut), got[sl]), "",
                 f"C {tag} slab {c0}")
            err, rel = compare(f"C {tag} {where} vs plain", got[sl],
                               plain(cut), 1e-5)
            hold(f"C {tag} {where} within 1e-5 of the plain version",
                 rel <= 1e-5, f"({rel:.2e})", f"C {tag} slab {c0} plain")

    for label in ("a", "b"):
        x = synth_config5(*cube.shape, SEED + 7, dev) if label == "a" \
            else cube._data
        rep = None
        for name, call, kernel in c_stages:
            if label == "b" and kernel == "plain_strips":
                continue
            tag = f"{name} ({label})"
            with recorded_calls((kernel,)) as calls:
                K.reset_launch_counts()
                og.convolve_reproject_separable.last = {}
                got = staged("C", tag, nbytes, lambda: call(x))
            peak = stages[f"C {tag}"][1]
            sizes[kernel] = [a[0].numel() for a, _ in calls[kernel]]
            launched.append(big_launches("C", sizes, (kernel,)))
            hold(f"C {tag} peak at most {CARD_PEAK_SHARE:.0%} of the card",
                 peak <= CARD_PEAK_SHARE * card,
                 f"({peak / 2**30:.2f} of {card / 2**30:.2f} GiB)",
                 f"C {tag} peak")
            work = conv_reproject_work(x, ops, x.numel(), label == "b")
            if kernel == "pipeline_fused":
                # plus the planes written and ~8 flops a voxel for them
                work = (work[0] + 11 * x[0].numel() * 4,
                        work[1] + 8 * x.numel())
            bms, by = bound(*work)
            timed.append(f"({label}) " + time_first_calls(
                "C", calls, (kernel,)) + f" (bound {bms:.3f} ms, {by})")
            kargs, kkw = calls[kernel][0]
            del calls
            if kernel == "conv_reproject":
                route = og.convolve_reproject_separable.last.get("route")
                hold(f"C {tag} takes the fused route", route == "fused",
                     f"({route})", f"C {tag} route")
                rep = got
                hold_slabs(f"conv_reproject ({label})", rep, x,
                           lambda c: kcr.conv_reproject(c, *args),
                           lambda c: kcr.conv_reproject_plain(c, *args))
            elif kernel == "plain_strips":
                hold_slabs(f"plain_strips ({label})", got, x,
                           lambda c: kcr.plain_strips(
                               c, ops.gy, ops.gx, gi[:c.shape[0]]),
                           lambda c: kcr.plain_strips_plain(
                               c, ops.gy, ops.gx, gi[:c.shape[0]]))
                same = all(bool(torch.equal(got[c0:c0 + 64][:, ok_plane],
                                            rep[c0:c0 + 64][:, ok_plane]))
                           for c0 in range(0, nchan, 64))
                hold(f"C plain_strips ({label}) bit for bit conv_reproject's "
                     "clean branch where the output is in range", same, "",
                     f"C plain_strips ({label}) = clean branch")
            else:
                hold(f"C {tag} takes the fused kernel", got is not None, "",
                     f"C {tag} not None")
                out, stats = got[0], got[4]
                got = None
                hold(f"C {tag} cube bit for bit convolve_reproject_"
                     "separable's", bits_equal(out, rep), "",
                     f"C {tag} cube")
                del out
                _, planes, cnt = kpf.pipeline_fused(*kargs, **kkw)
                xc, op, thr, inc = kargs[8:12]
                want = K.moments.moments_planes(x, xc, op, thr, inc, True)
                same = bool(torch.equal(planes, want[0])
                            and torch.equal(cnt, want[1]))
                planes_same[label] = same
                detail = "bit for bit"
                if not same:
                    # raises past its bound
                    worst = compare_moment_planes(
                        f"C {tag} planes", (planes, cnt), want,
                        dict(data=x, cmp_op=op, threshold=thr, include=inc,
                             xc=xc, with_stats=True))
                    detail = f"within {worst:.2e} of the terms"
                hold(f"C {tag} planes the moments kernel's (bit for bit, "
                     "or within its bound)", True, f"({detail})",
                     f"C {tag} planes")
                del planes, cnt, want
                cst = om.moments_012_kernel(x, coords, dx, mask_expr=mask,
                                            with_stats=True)[3]
                bad = [k for k in ("mean", "sigma", "min", "max", "sum")
                       if abs(float(stats[k]) - float(cst[k]))
                       > 3e-6 * abs(float(cst[k]))]
                hold(f"C {tag} statistics npts exact, the rest within 3e-6 "
                     "of moments_012_kernel's", int(stats["npts"])
                     == int(cst["npts"]) and not bad,
                     f"(npts {int(stats['npts'])}, off {bad})",
                     f"C {tag} statistics")
            got = None
            torch.cuda.empty_cache()
        del x, rep
        torch.cuda.empty_cache()
    return ("C launches " + ", ".join(launched) + "; kernel wrapper calls "
            + ", ".join(timed) + "; #10's planes bit for bit the moments "
            "kernel's: " + ", ".join(f"({k}) {v}"
                                     for k, v in planes_same.items()))


#: M's reductions on P's shards, each also run on the unsharded P for its
#: reference: host values (``statistics()`` as :func:`statistics_values`)
CARD_M_REDUCTIONS = {
    "sum()": lambda c: float(c.sum().value),
    "mean()": lambda c: float(c.mean().value),
    "std()": lambda c: float(c.std().value),
    "max()": lambda c: float(c.max().value),
    "argmax()": lambda c: tuple(int(i) for i in c.argmax()),
    "mean(axis=(1, 2))": lambda c: np.asarray(c.mean(axis=(1, 2)).value),
    "std(axis=(1, 2))": lambda c: np.asarray(c.std(axis=(1, 2)).value),
    "median(axis=(1, 2))": lambda c: np.asarray(c.median(axis=(1, 2)).value),
    "median(axis=(0, 1))": lambda c: np.asarray(c.median(axis=(0, 1)).value),
    f"percentile({CARD_PERCENTILE:g})":
        lambda c: float(c.percentile(CARD_PERCENTILE).value),
    "statistics()": lambda c: statistics_values(c.statistics())}
#: M's reductions held exactly against the unsharded call; the others are
#: sums, held within 1e-6 of a float64 oracle
CARD_M_EXACT = ("max()", "argmax()", "median(axis=(1, 2))",
                "median(axis=(0, 1))", f"percentile({CARD_PERCENTILE:g})")


def statistics_values(stats):
    """``statistics()``'s result as host numbers: npts an int, the rest
    floats."""
    return {k: int(v) if k == "npts" else float(getattr(v, "value", v))
            for k, v in stats.items()}


def card_m_meshes(dev):
    """M's two meshes of the one card: M1, the default mesh (every CUDA
    device once: one position on a one-card machine, whose one shard is
    the whole cube), and M4, four positions of ``dev`` in the MESH_GRID
    grid."""
    import torch
    import spectral_cube_tpu_torch as T
    m1 = T.default_mesh()
    if m1.n_devices != torch.cuda.device_count():
        raise AssertionError(f"the default mesh {m1} does not span the "
                             f"{torch.cuda.device_count()} cards")
    return {"M1": m1, "M4": T.CubeMesh(devices=[dev] * 4, shape=MESH_GRID)}


def card_ms_stages(cube):
    """MS: the spectral path's, S's and R's stages
    (:func:`card_spectral_stages`, :func:`card_s_stages`,
    :func:`card_r_stages`) on the sharded P ``cube``: ``(name, the call on
    a cube, the kernel it launches or None)``, each name "MS " and, for S
    and R, the part's tag before the stage's."""
    return ([(f"MS {n}", c, k) for n, c, k in card_spectral_stages(cube)]
            + [(f"MS S {n}", c, k) for n, c, k in card_s_stages(cube)]
            + [(f"MS R {n}", c, k)
               for n, c, k, _, _ in card_r_stages(cube)])


def card_m_run(cmesh, p_path, vr_path, run, after=lambda name, val: None,
               parts=("M", "MS")):
    """M's stages on ``cmesh``, each through ``run(name, fn, scale)``,
    which calls ``fn`` and returns its value (``scale`` times P's float32
    bytes are the stage's cube bytes), and ``after(name, value)`` just
    after it: the read of P's FITS file ``p_path`` onto the mesh
    (``io.streaming.read_sharded_cube``); ``run_pipeline(cmesh=)`` to a
    TARGET_BEAM beam at SNR onto P's grid shifted by SHIFT (the halo
    routes); each reduction of CARD_M_REDUCTIONS on those shards; then,
    with P's shards dropped, V (a): the 4-D file ``vr_path`` read with
    ``SpectralCube.read`` (``after("V (a) read", cube)``), put on the
    mesh by ``to_sharded`` and the unsharded cube dropped, then
    ``run_pipeline(cmesh=)`` onto the grid rotated by VR_ROTATION (the FFT
    reshard and the reshard reprojection; ``after`` gets the sharded cube
    and the result); last ``statistics()`` of P read onto the mesh as
    float64.  MS, on the same shards of P before they are dropped: each
    stage of :func:`card_ms_stages`.  ``parts`` names the parts run, M
    and MS (the read of P serves both).  A stage whose ``run`` returns
    None ends the mesh's read of P, or is passed over."""
    import numpy as np
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch.io import streaming
    _, target_beam = beams()
    sc = run("read", lambda: streaming.read_sharded_cube(p_path, cmesh), 1)
    if sc is None:
        return
    after("read", sc)
    if "M" in parts:
        target = shifted_header(sc.header, *SHIFT)
        val = run("run_pipeline", lambda: T.run_pipeline(
            sc, cmesh=cmesh, snr_threshold=SNR, target_beam=target_beam,
            target_header=target), 1)
        after("run_pipeline", val)
        del val
        for name, fn in CARD_M_REDUCTIONS.items():
            after(name, run(name, lambda: fn(sc), 1))
    if "MS" in parts:
        for name, fn, _ in card_ms_stages(sc):
            after(name, run(name, lambda: fn(sc), 1))
    del sc
    torch.cuda.empty_cache()
    if "M" not in parts:
        return
    vr = T.SpectralCube.read(vr_path)
    after("V (a) read", vr)
    vsc = vr.to_sharded(cmesh)
    del vr
    torch.cuda.empty_cache()
    val = run("V (a) run_pipeline", lambda: T.run_pipeline(
        vsc, cmesh=cmesh, snr_threshold=SNR,
        target_header=rotated_header(vsc.header, VR_ROTATION)), 1)
    after("V (a) run_pipeline", (vsc, val))
    del vsc, val
    torch.cuda.empty_cache()
    f64 = streaming.read_sharded_cube(p_path, cmesh, dtype=np.float64)
    after("statistics() float64", run(
        "statistics() float64",
        lambda: statistics_values(f64.statistics()), 2))
    del f64
    torch.cuda.empty_cache()


def card_m_reference(cube, tiles):
    """M's references on the unsharded P (``cube``, read from FITS): its
    data on the CARD_TILE ``tiles`` and CARD_SLAB slabs (first, middle,
    last) of ``run_pipeline``'s reprojected cube, host arrays; the
    pipeline's moments and statistics; each reduction of
    CARD_M_REDUCTIONS; the float64 oracles of the sums
    (:func:`stats_oracle`, :func:`spectrum_oracle`, :func:`spectrum_std`)
    and the statistics of a float64 copy."""
    import torch
    import spectral_cube_tpu_torch as T
    nchan = cube.shape[0]
    t = CARD_TILE
    ref = {"tiles": {(y0, x0): cube._data[:, y0:y0 + t, x0:x0 + t]
                     .cpu().numpy() for y0, x0 in tiles},
           "slabs": (0, (nchan - CARD_SLAB) // 2, nchan - CARD_SLAB)}
    _, target_beam = beams()
    res = T.run_pipeline(cube, snr_threshold=SNR, target_beam=target_beam,
                         target_header=shifted_header(cube.header, *SHIFT))
    ref["moments"] = [np.asarray(m.value) for m in res["moments"]]
    ref["statistics"] = statistics_values(res["statistics"])
    ref["cube"] = {c0: res["cube"].filled_data[c0:c0 + CARD_SLAB].value
                   for c0 in ref["slabs"]}
    del res
    torch.cuda.empty_cache()
    ref["reductions"] = {name: fn(cube)
                         for name, fn in CARD_M_REDUCTIONS.items()}
    keep = lambda c0, x: True  # noqa: E731
    ref["oracle"] = stats_oracle(cube._data, keep)
    ref["mean(axis=(1, 2))"], ref["std(axis=(1, 2))"] = spectrum_std(
        cube._data)
    f64 = card_f64_cube(cube)
    ref["statistics() float64"] = statistics_values(f64.statistics())
    del f64
    torch.cuda.empty_cache()
    return ref


def spectrum_std(data, step=64):
    """The float64 mean and std (n) over each plane of the finite voxels
    of ``data`` (NaN where none), ``step`` channels at a time on the card:
    ``mean(axis=(1, 2))``'s and ``std(axis=(1, 2))``'s oracles."""
    import torch
    means, stds = [], []
    for c0 in range(0, data.shape[0], step):
        x = data[c0:c0 + step].double()
        ok = torch.isfinite(x)
        n = ok.sum((1, 2))
        m = torch.where(ok, x, 0.0).sum((1, 2)) / n.clamp(min=1)
        s2 = torch.where(ok, (x - m[:, None, None]) ** 2, 0.0).sum((1, 2))
        nan = torch.full_like(m, float("nan"))
        means.append(torch.where(n > 0, m, nan))
        stds.append(torch.where(n > 0, torch.sqrt(s2 / n.clamp(min=1)), nan))
        del x, ok
    return (torch.cat(means).cpu().numpy(), torch.cat(stds).cpu().numpy())


def sharded_cut_cube(sc, view, dev):
    """The unsharded cube of ``sc``'s cut ``view`` (a tuple of unit-step
    slices), its mask-filled data read through ``filled_data`` (a host
    array, no counted gather) and put on ``dev``: the cut-out a sharded
    result is held against."""
    import torch
    import spectral_cube_tpu_torch as T
    cut = sc._cut(view)
    data = torch.as_tensor(cut.filled_data[:].value, device=dev)
    return T.SpectralCube(data, cut.wcs, header=cut.header, meta=cut.meta,
                          unit=cut.unit, beam=cut._template._beam,
                          mask=T.LazyMask(torch.isfinite, data=data,
                                          wcs=cut.wcs))


def card_m(dev, p_path, vr_path, ref, nbytes, card, stages, staged, hold,
           big_launches, tiles):
    """M: the sharded path past 2**31 voxels on the card's two meshes
    (:func:`card_m_meshes`), its stages :func:`card_m_run`'s, each on M1
    and then on M4, each staged with its peak at most CARD_PEAK_SHARE of
    the card and the mesh's ``gathers`` counter 0; each reduction's rise
    at most CARD_MAD_RATIO cube bytes above the resident shards; on M1
    moments, conv_sep and resample2 (CARD_KERNELS["M"]) launched on more
    than 2**31 elements, counted over the pipeline stage alone.  Held
    against ``ref`` (:func:`card_m_reference`): the read bit for bit P's
    data on the ``tiles``, its host buffers one block and its read buffer
    at most; the pipeline's moments and linewidth on the tiles and its
    cube on CARD_SLAB slabs (``filled_data``, host arrays) at
    :func:`hold_pipeline`'s tolerances with equal NaN patterns (bit for
    bit or not, logged), its statistics by the same rule; the exact
    reductions (CARD_M_EXACT) bit for bit the unsharded call's, the sums
    within 1e-6 of the float64 oracles, the statistics' npts, min and max
    the unsharded call's and the rest within 1e-6 of float64 (of the
    float64 copy's statistics for the float64 read).  V (a): its convolved
    cube (``convolve_to`` of the common beam again on the mesh) on
    CARD_SLAB slabs (first, middle, last, over the flagged planes) within
    1e-6 of the float64 FFT form (NaN decisions free at den <= 1e-5), its
    reprojected slabs bit for bit the slab's call on the masked convolved
    cube's cut-out and its moments on the tiles bit for bit the cut-out's
    ``run_pipeline(noise_estimate=)``.  MS (:func:`card_ms_stages`, on the
    shards of M's read, after its reductions): each stage staged and held
    as M's are (peak, gathers 0); on M1 its kernel (of
    CARD_KERNELS["MS"]) launched on more than 2**31 elements, counted over
    the stage alone; each held against ``ref["MS"]``, the unsharded
    stages' tiles and slabs that :func:`card_spectral`, :func:`card_s_f64`
    and :func:`card_r` kept (:func:`hold_ms`).  Returns the summary
    part."""
    import torch
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.io import streaming
    import spectral_cube_tpu_torch as T
    t_m = time.perf_counter()
    t = CARD_TILE
    nchan = CARD_P[0]
    vr_slabs = sorted({0, (nchan - CARD_SLAB) // 2, nchan - CARD_SLAB,
                       VR_FLAGGED[0] - CARD_SLAB // 2})
    parts = []
    ms_parts = []
    for tag, cmesh in card_m_meshes(dev).items():
        t_mesh = time.perf_counter()
        counters, launched, bitwise = {}, [], {}
        ms_run = {"kernels": {}, "launched": [], "holds": [], "t0": None}

        def run(name, fn, scale, tag=tag, cmesh=cmesh, counters=counters,
                launched=launched, ms_run=ms_run):
            torch.cuda.empty_cache()
            cmesh.reset_counters()
            K.reset_launch_counts()
            is_ms = name.startswith("MS ")
            if is_ms and ms_run["t0"] is None:
                ms_run["t0"] = time.perf_counter()
            with recorded_calls(CARD_KERNELS["MS" if is_ms else "M"],
                                lambda a, kw: a[0].numel()) as sizes:
                val = staged(tag, name, nbytes * scale, fn)
            counters[name] = dict(cmesh.counters)
            ms, peak, rise = stages[f"{tag} {name}"]
            hold(f"{tag} {name} peak at most {CARD_PEAK_SHARE:.0%} of the "
                 "card, gathers 0", peak <= CARD_PEAK_SHARE * card
                 and counters[name]["gathers"] == 0,
                 f"({peak / 2**30:.2f} of {card / 2**30:.2f} GiB; counters "
                 f"{counters[name]})", f"{tag} {name} peak")
            if name in CARD_M_REDUCTIONS or name == "statistics() float64":
                hold(f"{tag} {name} rise above the resident shards at most "
                     f"{CARD_MAD_RATIO} cube bytes", rise <= CARD_MAD_RATIO,
                     f"({rise:.3f})", f"{tag} {name} rise")
            kernel = ms_run["kernels"].get(name)
            if kernel and tag == "M1":
                ms_run["launched"].append(f"{name[3:]}: " + big_launches(
                    "MS", sizes, (kernel,)))
            elif kernel:
                ms_run["launched"].append(f"{name[3:]}: {kernel} "
                                      f"{K.launch_counts()[kernel]}")
            if name == "run_pipeline":
                if tag == "M1":
                    launched.append(big_launches("M", sizes))
                else:
                    launched.append(", ".join(
                        f"{k} {n}" for k, n in K.launch_counts().items()
                        if n))
            return val

        def close(name, got, want, rtol, atol):
            err = close_arrays(f"{tag} {name}", got, want, rtol, atol)
            same = np.ascontiguousarray(got).tobytes() \
                == np.ascontiguousarray(want).tobytes()
            bitwise[name] = bitwise.get(name, True) and same
            return err

        def after(name, val, tag=tag, cmesh=cmesh, bitwise=bitwise,
                  ms_run=ms_run):
            if name == "read":
                ms_run["kernels"].update(
                    (n, k) for n, _, k in card_ms_stages(val) if k)
                shards = val._data.addressable_shards
                want = (nchan, CARD_P[1] // cmesh.grid[0],
                        CARD_P[2] // cmesh.grid[1])
                held = streaming.HOST_BUFFERS["held_bytes"]
                block = streaming.HOST_BUFFERS["block_bytes"]
                hold(f"{tag} read: {cmesh.n_devices} shards of {want} on "
                     "the card, host buffers one block and its read buffer "
                     "at most", len(shards) == cmesh.n_devices and all(
                         tuple(s.data.shape) == want and s.data.device == dev
                         for s in shards) and held <= 2 * block,
                     f"(held {held / 2**30:.2f} GiB, a block "
                     f"{block / 2**30:.2f} GiB)", f"{tag} read shards")
                hold(f"{tag} read bit for bit P's data on the tiles", all(
                    np.ascontiguousarray(val.unmasked_data[
                        :, y0:y0 + t, x0:x0 + t].value).tobytes()
                    == data.tobytes()
                    for (y0, x0), data in ref["tiles"].items()), "",
                    f"{tag} read tiles")
            elif name == "run_pipeline":
                tol = dict(PIPELINE_TOLERANCES)
                for i, key in enumerate(("mom0", "mom1", "linewidth")):
                    got = np.asarray(val["moments"][i].value)
                    for y0, x0 in tiles:
                        sl = (slice(y0, y0 + t), slice(x0, x0 + t))
                        close(key, got[sl], ref["moments"][i][sl],
                              *tol[key])
                hold_statistics(f"{tag} run_pipeline",
                                statistics_values(val["statistics"]),
                                ref["statistics"], hold)
                for c0 in ref["slabs"]:
                    close("cube", val["cube"].filled_data[
                        c0:c0 + CARD_SLAB].value, ref["cube"][c0],
                        *tol["cube"])
                hold(f"{tag} run_pipeline: moments and linewidth on the "
                     "tiles, the cube on the slabs and the statistics at "
                     "hold_pipeline's tolerances, NaN patterns equal", True,
                     f"(bit for bit: {bitwise})", f"{tag} run_pipeline")
                c = counters["run_pipeline"]
                hold(f"{tag} run_pipeline takes the halo routes",
                     c["halo_exchanges"] > 0 and c["all_to_alls"] == 0,
                     str(c), f"{tag} run_pipeline halo")
            elif name in CARD_M_REDUCTIONS:
                hold_m_reduction(tag, name, val, ref, hold)
            elif name.startswith("MS "):
                ms_run["holds"].append(hold_ms(tag, name, val,
                                               ref["MS"][name], hold))
                ms_run["t1"] = time.perf_counter()
            elif name == "V (a) read":
                cb = val.common_beam()
                ref["V"] = {c0: float64_fft_convolve_to(
                    val[c0:c0 + CARD_SLAB], cb) for c0 in vr_slabs}
            elif name == "V (a) run_pipeline":
                vsc, res = val
                hold_m_vr(tag, dev, vsc, res, ref["V"], vr_slabs, tiles,
                          counters[name], hold)
            else:
                hold_statistics(f"{tag} statistics() float64", val,
                                ref["statistics() float64"], hold, 1e-6)
        card_m_run(cmesh, p_path, vr_path, run, after)
        wall = time.perf_counter() - t_mesh
        ms_parts.append(f"{tag} ({ms_run['t1'] - ms_run['t0']:.1f} s): "
                        "launches " + "; ".join(ms_run["launched"])
                        + "; held: " + "; ".join(ms_run["holds"]))
        parts.append(f"{tag} ({cmesh.n_devices} position(s), {wall:.1f} s): "
                     "launches " + "; ".join(launched)
                     + "; bit for bit the unsharded run: "
                     + ", ".join(f"{k} {v}" for k, v in bitwise.items()))
    return (f"M (the sharded path, {time.perf_counter() - t_m:.1f} s, MS "
            "within it): " + "; ".join(parts)
            + "; MS (the sharded spectral path and spline reprojections): "
            + "; ".join(ms_parts))


def hold_statistics(tag, got, want, hold, rtol=None):
    """``statistics()`` values ``got`` against ``want`` (host numbers):
    npts exact; with ``rtol`` min and max exact and the rest within
    ``rtol``; without, :func:`hold_pipeline`'s rule."""
    keys = ("mean", "sigma", "sum", "sumsq", "max", "min", "rms")
    if rtol is None:
        bad = [k for k in keys
               if abs(got[k] - want[k]) > 2e-5 * abs(want[k]) + 1e-7]
    else:
        bad = [k for k in keys if (got[k] != want[k] if k in ("max", "min")
                                   else abs(got[k] - want[k])
                                   > rtol * abs(want[k]))]
    same = all(got[k] == want[k] for k in keys)
    hold(f"{tag} statistics npts exact, the rest "
         + ("at hold_pipeline's tolerance" if rtol is None
            else f"within {rtol:g} (min and max exact)"),
         got["npts"] == want["npts"] and not bad,
         f"(off {bad}; bit for bit {same}; npts {got['npts']} vs "
         f"{want['npts']})", f"{tag} statistics")


def hold_m_reduction(tag, name, got, ref, hold):
    """M's reduction ``name`` on the shards against ``ref``: exactly the
    unsharded call's (CARD_M_EXACT), the sums within 1e-6 of the float64
    oracles, ``statistics()`` npts, min and max the unsharded call's and
    sum, mean and sigma within 1e-6 of float64."""
    want = ref["reductions"][name]
    oracle = ref["oracle"]
    if name in CARD_M_EXACT:
        ok = np.asarray(got).tobytes() == np.asarray(want).tobytes()
        hold(f"{tag} {name} bit for bit the unsharded call's", ok,
             "" if ok else f"({got!r} vs {want!r})", f"{tag} {name}")
        return
    if name == "statistics()":
        bad = [k for k in ("sum", "mean", "sigma")
               if abs(got[k] - oracle[k]) > 1e-6 * abs(oracle[k])]
        ok = not bad and all(got[k] == want[k] for k in ("npts", "min",
                                                          "max"))
        detail = f"(off {bad}; {got} vs {want})"
    elif name in ("mean(axis=(1, 2))", "std(axis=(1, 2))"):
        ok, err = within_f64(got, ref[name])
        detail = f"({err:.2e}; bit for bit the unsharded call's: " \
            f"{np.asarray(got).tobytes() == np.asarray(want).tobytes()})"
    else:
        key = {"sum()": "sum", "mean()": "mean", "std()": "std"}[name]
        ok = abs(got - oracle[key]) <= 1e-6 * abs(oracle[key])
        detail = f"({got!r} vs {oracle[key]!r}; the unsharded call's " \
            f"{want!r})"
    hold(f"{tag} {name} within 1e-6 of float64", ok, detail,
         f"{tag} {name}")


def host_equal_nan(a, b):
    """Two host arrays of one shape and dtype hold the same values, NaN
    where NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb)
                and np.array_equal(np.where(na, 0, a), np.where(nb, 0, b)))


def hold_ms(tag, name, cube, ref, hold):
    """MS's stage ``name`` on the sharded P, its result ``cube``, against
    ``ref``, the unsharded stage's host arrays: on each CARD_TILE tile of
    whole spectra (the spectral stages) or CARD_SLAB slab of output
    channels (S, R), read through ``filled_data``, bit for bit the
    unsharded stage's; ``spectral_smooth`` also within 1e-6 of the
    largest |value| of its float64 form; the spline orders within 1e-6 of
    the largest |value| of :func:`float64_spline`'s form, NaN states free
    only where the float64 NaN weight lies within 1e-6 of the 1e-6 limit
    (the flips counted), bit for bit the unsharded stage or not, logged.
    Returns the summary's words on the stage."""
    t = CARD_TILE
    if "tiles" in ref:
        views = {k: (slice(None), slice(k[0], k[0] + t),
                     slice(k[1], k[1] + t)) for k in ref["tiles"]}
        want_of, where = ref["tiles"], "tile at"
    else:
        views = {c0: (slice(c0, c0 + CARD_SLAB),) for c0 in ref["slabs"]}
        want_of, where = ref["slabs"], "output channels from"
    spline = "bicubic" in name or "biquadratic" in name
    same, errs, flips = True, [], 0
    for key, view in views.items():
        got = np.asarray(cube.filled_data[view].value)
        want = want_of[key]
        exact = host_equal_nan(got, want)
        same = same and exact
        label = f"{tag} {name} {where} {key}"
        if spline:
            f64, wn = ref["f64"][key]
            ok, err, n = near_float64(got, f64, np.abs(wn - 1e-6) <= 1e-6)
            errs.append(err)
            flips += n
            hold(f"{label} within 1e-6 of float64", ok,
                 f"({err:.2e} of the largest |value|, {n} NaN flips at the "
                 f"1e-6 weight limit; bit for bit the unsharded stage: "
                 f"{exact})", label)
            continue
        hold(f"{label} bit for bit the unsharded stage", exact, "", label)
        if key in ref["f64"]:
            f64 = ref["f64"][key]
            fin = ~np.isnan(f64)
            ok, err = within_f64(got, f64, 1e-6, float(
                np.abs(f64[fin]).max()) if fin.any() else 1.0)
            errs.append(err)
            hold(f"{label} within 1e-6 of float64", ok,
                 f"({err:.2e} of the largest |value|)", f"{label} float64")
    out = f"{name[3:]} bit for bit {same}"
    if errs:
        out += f", {max(errs):.2e} of float64"
    if spline:
        out += f", {flips} NaN flips"
    return out


def hold_m_vr(tag, dev, vsc, res, f64, slabs, tiles, counters, hold):
    """M's V (a) on ``vsc`` (the sharded varying-resolution P) against its
    float64 forms ``f64`` ({slab start: (values, den)}): see
    :func:`card_m`."""
    import torch
    import spectral_cube_tpu_torch as T
    t = CARD_TILE
    hold(f"{tag} V (a) takes the reshard routes (all-to-alls)",
         counters["all_to_alls"] > 0, str(counters), f"{tag} V (a) reshard")
    conv = vsc.convolve_to(vsc.common_beam())
    hold(f"{tag} V (a) convolved planes {VR_FLAGGED} (flagged beams) NaN",
         all(np.isnan(conv.filled_data[c].value).all()
             for c in VR_FLAGGED), "", f"{tag} V (a) flagged")
    noise = float(conv.mad_std().value)
    masked = conv.with_mask(conv > T.Quantity(SNR * noise, conv.unit))
    for c0 in slabs:
        sl = slice(c0, c0 + CARD_SLAB)
        where = f"channels {c0}-{c0 + CARD_SLAB - 1}"
        want, den = f64[c0]
        ok, err, flips = near_float64(conv.filled_data[sl].value, want,
                                      den <= 1e-5, np.minimum(den, 1.0))
        hold(f"{tag} V (a) convolve_to of {where} within 1e-6 of float64",
             ok, f"({err:.2e} of the largest |value|, {flips} NaN flips at "
             "den <= 1e-5)", f"{tag} V (a) convolve_to slab {c0}")
        slab = sharded_cut_cube(masked, (sl,), dev)
        slab = slab.with_mask(slab > T.Quantity(SNR * noise, slab.unit))
        got = slab._reproject(rotated_header(slab.header, VR_ROTATION))
        hold(f"{tag} V (a) reproject of {where} bit for bit the slab's",
             np.ascontiguousarray(got.filled_data[:].value).tobytes()
             == np.ascontiguousarray(
                 res["cube"].filled_data[sl].value).tobytes(), "",
             f"{tag} V (a) reproject slab {c0}")
        del slab, got
    for y0, x0 in tiles:
        cut = sharded_cut_cube(conv, (slice(None), slice(y0, y0 + t),
                                      slice(x0, x0 + t)), dev)
        want = T.run_pipeline(cut, snr_threshold=SNR,
                              noise_estimate=noise)["moments"]
        hold(f"{tag} V (a) moment0/1 and linewidth on the tile at "
             f"({y0}, {x0}) bit for bit the tile's", all(
                 np.ascontiguousarray(np.asarray(g.value)[
                     y0:y0 + t, x0:x0 + t]).tobytes()
                 == np.ascontiguousarray(np.asarray(w.value)).tobytes()
                 for g, w in zip(res["moments"], want)), "",
             f"{tag} V (a) tile ({y0}, {x0})")
    del conv, masked
    torch.cuda.empty_cache()


def staged_call(dev, stages, tag, name, nbytes, fn):
    """``fn()`` on the host clock, synchronised, with the device peak and
    its rise above the bytes in use before it, in cube bytes, kept in
    ``stages`` under ``"tag name"`` and logged."""
    import torch
    from spectral_cube_tpu_torch import profiling
    torch.cuda.synchronize()
    base = profiling.device_memory_stats(dev)["bytes_in_use"]
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    val = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    peak = profiling.device_memory_stats(dev)["peak_bytes_in_use"]
    stages[f"{tag} {name}"] = (ms, peak, (peak - base) / nbytes)
    log(f"  {tag} {name}: {ms:.1f} ms, peak {peak / 2**30:.2f} GiB, "
        f"{(peak - base) / nbytes:.3f} cube bytes above the "
        f"{base / 2**30:.2f} GiB in use before it")
    return val


def card_spectral(cube, tiles, nbytes, card, sizes, staged, hold,
                  big_launches, time_first_calls, keep):
    """The spectral path on P (``cube``, read from FITS): each stage staged,
    its peak held at most CARD_PEAK_SHARE of the card, and its result held
    on the CARD_TILE ``tiles`` of whole spectra (each must hold finite
    values) against the same call on the tile's cut-out: bit for bit for
    the smoothed interpolation
    (smooth_interp, #11), the std clip (sigma_clip, #13), the mad_std clip,
    the median filter and the interpolation without smoothing; within 1e-6
    of the largest |value| of a float64 ``convolve1d_nan`` on the cut-out
    for ``spectral_smooth`` (its cuBLAS blocks; whether the tile is also
    the cut-out's bit for bit is logged).  smooth_interp's and
    sigma_clip's launches are read just after their own stage, the
    counters set to 0 just before it (``big_launches``, the elements of
    their inputs put in ``sizes``), and then their first calls are timed.
    Each stage's tiles (and ``spectral_smooth``'s float64 forms) are kept
    in ``keep`` as host arrays under MS's name of the stage
    (:func:`card_ms_stages`), MS's references.  Returns the summary
    part."""
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.ops import smoothing as osm
    karr = np.asarray(T.Gaussian1DKernel(SMOOTH_STDDEV).array, dtype=float)
    t = CARD_TILE
    timed, launched, bitwise = [], [], {}
    for name, call, kernel in card_spectral_stages(cube):
        names = (kernel,) if kernel else ()
        with recorded_calls(names) as calls:
            K.reset_launch_counts()
            out = staged("P", name, nbytes, lambda: call(cube))
        peak = torch.cuda.max_memory_allocated(cube.device)
        if kernel:
            sizes[kernel] = [a[0].numel() for a, _ in calls[kernel]]
            launched.append(big_launches("P", sizes, names))
            timed.append(time_first_calls("P", calls, names))
        del calls
        hold(f"P {name} peak at most {CARD_PEAK_SHARE:.0%} of the card",
             peak <= CARD_PEAK_SHARE * card,
             f"({peak / 2**30:.2f} of {card / 2**30:.2f} GiB)",
             f"P {name} peak")
        same = True
        kept = keep[f"MS {name}"] = {"tiles": {}, "f64": {}}
        for y0, x0 in tiles:
            view = (slice(None), slice(y0, y0 + t), slice(x0, x0 + t))
            got = out._get_filled_data(view)
            kept["tiles"][y0, x0] = got.cpu().numpy()
            want = call(cube[view])._get_filled_data()
            same = same and equal_nan(got, want)
            where = f"on the tile at ({y0}, {x0})"
            some = int(torch.isfinite(got).sum())
            hold(f"P {name} {where} holds finite values", some > 0,
                 f"({some})", f"P {name} tile ({y0}, {x0}) finite")
            if name != "spectral_smooth":
                hold(f"P {name} {where} bit for bit the tile's",
                     equal_nan(got, want), "", f"P {name} tile ({y0}, {x0})")
                continue
            ref = osm.convolve1d_nan(cube[view]._get_filled_data(
                fill=np.nan).double(), karr).cpu().numpy()
            kept["f64"][y0, x0] = ref
            fin = ~np.isnan(ref)
            ok, err = within_f64(got.cpu().numpy(), ref, 1e-6, float(
                np.abs(ref[fin]).max()) if fin.any() else 1.0)
            hold(f"P {name} {where} within 1e-6 of float64", ok,
                 f"({err:.2e} of the largest |value|; bit for bit the "
                 f"tile's: {equal_nan(got, want)})",
                 f"P {name} tile ({y0}, {x0})")
        bitwise[name] = same
        del out, got, want
        torch.cuda.empty_cache()
    return ("P spectral path: tiles " + ", ".join(map(str, tiles))
            + " bit for bit their cut-outs' "
            + ", ".join(f"{k} {v}" for k, v in bitwise.items())
            + "; launches " + ", ".join(launched)
            + "; kernel wrapper calls " + ", ".join(timed))


def card_reductions(masked, nbytes, stages, staged, hold):
    """The cube's other reductions on H (``masked``): ``sum``, ``mean``,
    ``std``, ``max``, ``min``, ``median``, ``percentile`` and ``mad_std``
    along the spectral axis, ``mean(axis=(1, 2))``, and ``std()``,
    ``max()`` and ``argmax()`` over the cube, each staged with its rise
    held at most CARD_MAD_RATIO cube bytes above the resident data.  The
    maps are held on CARD_TILE tiles (corners, centre) against the same
    call on the tile's cut-out: bit for bit for the order statistics and
    extrema; within 1e-6 of the float64 reduction of the cut-out for the
    sum, mean and std (torch may sum a lane in another order for another
    number of lanes; whether the tile is the cut-out's bit for bit is
    logged).  The spectrum and the whole-cube values are held against
    float64 oracles on the card (:func:`spectrum_oracle`,
    :func:`stats_oracle`): within 1e-6, the maximum exactly and argmax at
    the oracle's first index.  Returns the summary part."""
    from spectral_cube_tpu_torch.ops import reductions as rd
    t = CARD_TILE
    oracle = {"sum(axis=0)": rd.masked_sum, "mean(axis=0)": rd.masked_mean,
              "std(axis=0)": rd.masked_std}
    maps = {}

    def rise_held(key):
        hold(f"H {key} rise above the resident data at most "
             f"{CARD_MAD_RATIO} cube bytes", stages[f"H {key}"][2]
             <= CARD_MAD_RATIO, f"({stages[f'H {key}'][2]:.3f})",
             f"H {key} rise")
    for name, fn in CARD_ALONG.items():
        maps[name] = staged("H", name, nbytes,
                            lambda: np.asarray(fn(masked).value))
        rise_held(name)
    spec, std, mx, am = (staged("H", key, nbytes, lambda: fn(masked))
                         for key, fn in CARD_WHOLE.items())
    for key in CARD_WHOLE:
        rise_held(key)
    bitwise = {}
    for y0, x0 in card_tiles(*masked.shape[1:]):
        view = (slice(None), slice(y0, y0 + t), slice(x0, x0 + t))
        cut = masked[view]
        where = f"on the tile at ({y0}, {x0})"
        for name, fn in CARD_ALONG.items():
            got = maps[name][y0:y0 + t, x0:x0 + t]
            same = np.ascontiguousarray(got).tobytes() == np.asarray(
                fn(cut).value).tobytes()
            bitwise[name] = bitwise.get(name, True) and same
            if name not in oracle:
                hold(f"H {name} {where} bit for bit the tile's",
                     same, "", f"H {name} tile ({y0}, {x0})")
                continue
            ref = oracle[name](cut._data.double(), cut._valid_view(),
                               axis=0).cpu().numpy()
            ok, err = within_f64(got, ref)
            hold(f"H {name} {where} within 1e-6 of float64", ok,
                 f"({err:.2e}; bit for bit the tile's: {same})",
                 f"H {name} tile ({y0}, {x0})")
    keep = lambda c0, x: x > CARD_H_THRESHOLD  # noqa: E731
    ok, err = within_f64(spec, spectrum_oracle(masked._data, keep))
    hold("H mean(axis=(1, 2)) within 1e-6 of float64", ok, f"({err:.2e})",
         "H mean(axis=(1, 2))")
    want = stats_oracle(masked._data, keep)
    at = tuple(int(i) for i in np.unravel_index(want["argmax"],
                                                masked.shape))
    hold("H std() within 1e-6 of float64, max() the float64 maximum, "
         "argmax() its first index",
         abs(std - want["std"]) <= 1e-6 * abs(want["std"])
         and mx == want["max"] and am == at,
         f"(std {std!r} vs {want['std']!r}, max {mx!r} vs {want['max']!r}, "
         f"argmax {am} vs {at})", "H whole-cube std, max, argmax")
    return ("H reductions: tiles bit for bit their cut-outs' "
            + ", ".join(f"{k} {v}" for k, v in bitwise.items()))


def phase_card_scale(dev, workdir):
    """``run_pipeline`` on P (CARD_P, read from a FITS file the port wrote)
    and moments, ``statistics()`` and ``mad_std()`` on H (CARD_H, bench
    config 8's cube built on the card), both past 2**31 voxels, each stage
    timed with its peak; the kernels' launches on those cubes; and the
    results held where no plain version fits: moments and linewidth on
    CARD_TILE tiles (corners, centre) bit for bit the same call on the
    tile's cut-out, the convolved and reprojected cubes on CARD_SLAB-
    channel slabs (first, middle, last) bit for bit the same call on the
    slab, ``mad_std`` bit for bit ``sharded_mad_std`` on a MESH_GRID mesh
    of the card and, on a cut-out of ``SORT_CHUNK`` voxels, the one-sort
    form's, ``statistics()`` npts exact and sum, mean and sigma within
    1e-6 of a float64 oracle; then the spectral path on P
    (:func:`card_spectral`), P's reprojection onto a new spectral axis
    and a float64 copy's ``statistics()`` (:func:`card_s_f64`), the
    rotated spline reprojection (:func:`card_r`), the fused convolve +
    reproject (:func:`card_c`), the sharded path over the card's meshes
    on P's FITS file and V's 4-D file (:func:`card_m`, its references
    from the unsharded P first) and, on the same shards of P, the
    sharded spectral path and spline reprojections (MS, within
    :func:`card_m`, held against the tiles and slabs the spectral path, S
    and R kept), P as a varying-resolution cube
    (:func:`card_vr`), and the cube's other reductions on H
    (:func:`card_reductions`).  Returns the "summary: card scale"
    line."""
    import shutil
    import torch
    import spectral_cube_tpu_torch as T
    from spectral_cube_tpu_torch import cube as tcube
    from spectral_cube_tpu_torch import kernels as K
    from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
    from spectral_cube_tpu_torch.ops import reductions as rd
    from spectral_cube_tpu_torch.parallel import CubeMesh, sharded_mad_std
    from spectral_cube_tpu_torch.wcs import WCS
    log("phase card scale")
    card = torch.cuda.get_device_properties(dev).total_memory
    usage = shutil.disk_usage(workdir)
    log(f"  card memory {card / 2**30:.2f} GiB; {workdir}: "
        f"{usage.free / 2**30:.1f} GiB free of {usage.total / 2**30:.1f}; "
        f"host memory {host_memory_line()}")
    stages, checks, parts = {}, [], []
    torch.cuda.empty_cache()

    def staged(tag, name, nbytes, fn):
        return staged_call(dev, stages, tag, name, nbytes, fn)

    def hold(name, ok, detail="", short=None):
        checks.append(short or name)
        log(f"  {name}: {'ok' if ok else 'FAILED'} {detail}")
        if not ok:
            raise AssertionError(f"card scale: {name} {detail}")

    def big_launches(tag, sizes, names=None):
        """Each kernel of CARD_KERNELS[tag] (or of ``names``): its
        launches since the counters' reset and the elements of its first
        and last input."""
        counts = K.launch_counts()
        out = {k: (counts[k], sizes[k]) for k in names or CARD_KERNELS[tag]}
        hold(f"{tag} {', '.join(out)} launched on more than 2**31 elements",
             all(n > 0 and e and min(e) >= CARD_MIN_ELEMENTS
                 for n, e in out.values()), str(out),
             f"{tag} {'/'.join(out)} launches")
        return ", ".join(f"{k} {n} (inputs {'/'.join(map(str, e))} "
                         "elements)" for k, (n, e) in out.items())

    def numel(args, kwargs):
        return args[0].numel()

    def time_first_calls(tag, calls, names=None):
        """CUDA-event median of three more wrapper calls with the
        arguments of each kernel's first call (of CARD_KERNELS[tag], or of
        ``names``)."""
        out = []
        for k in names or CARD_KERNELS[tag]:
            args, kwargs = calls[k][0]
            ms = cuda_ms(lambda: K.WRAPPERS[k](*args, **kwargs), 3)
            out.append(f"{k} {ms:.3f} ms on {args[0].numel()} elements")
            log(f"  {tag} {out[-1]}")
        return ", ".join(out)

    def hold_mad_cutout(tag, data, valid):
        """On the middle SORT_CHUNK voxels' channels: masked_mad_std bit
        for bit the one-sort form's, and again with SORT_CHUNK a fifth of
        the cut-out, so that it is cut into pieces of that size at most
        (the keyed bisection on the card)."""
        planes = rd.SORT_CHUNK // (data.shape[1] * data.shape[2])
        c0 = (data.shape[0] - planes) // 2
        sl = (slice(c0, c0 + planes),)
        cut, ok = data[sl], valid(sl)
        want = one_sort_mad_std(cut, ok)
        got = rd.masked_mad_std(cut, ok)
        keep = rd.SORT_CHUNK
        rd.SORT_CHUNK = cut.numel() // 5
        try:
            keyed = rd.masked_mad_std(cut, ok)
        finally:
            rd.SORT_CHUNK = keep
        hold(f"{tag} mad_std of channels {c0}-{c0 + planes - 1} the "
             "one-sort value, in one piece and in pieces",
             bits_equal(got.reshape(1), want.reshape(1))
             and bits_equal(keyed.reshape(1), want.reshape(1)),
             f"({float(want)!r})", f"{tag} mad_std cut-out")

    def hold_sharded_mad(tag, noise, data, **mask):
        cmesh = CubeMesh(devices=[dev] * 4, shape=MESH_GRID)
        got = staged(tag, "sharded mad_std", data.numel() * 4,
                     lambda: sharded_mad_std(data, cmesh, **mask))
        hold(f"{tag} mad_std bit for bit sharded_mad_std on a "
             f"{MESH_GRID[0]}x{MESH_GRID[1]} mesh of the card",
             bits_equal(got.reshape(1), torch.tensor(
                 [noise], dtype=torch.float32, device=dev)),
             f"({noise!r})", f"{tag} sharded mad_std")

    def hold_stats(tag, stats, want):
        bad = [k for k in ("sum", "mean", "sigma")
               if abs(float(stats[k].value) - want[k]) > 1e-6 * abs(want[k])]
        hold(f"{tag} statistics npts exact, sum/mean/sigma within 1e-6 of "
             "float64", stats["npts"] == want["npts"] and not bad,
             "(" + ", ".join(f"{k} {float(stats[k].value)!r} vs {want[k]!r}"
                             for k in ("sum", "mean", "sigma"))
             + f", npts {stats['npts']} vs {want['npts']})",
             f"{tag} statistics")

    def hold_tiles(tag, full, tile_moments, tiles):
        t = CARD_TILE
        for y0, x0 in tiles:
            got = tile_moments(y0, x0)
            same = all(np.ascontiguousarray(
                np.asarray(f)[y0:y0 + t, x0:x0 + t]).tobytes()
                == np.ascontiguousarray(np.asarray(g)).tobytes()
                for f, g in zip(full, got))
            hold(f"{tag} moment0/1 and linewidth on the tile at "
                 f"({y0}, {x0}) bit for bit the tile's", same, "",
                 f"{tag} tile ({y0}, {x0})")

    # P: run_pipeline on a cube read from FITS
    nchan, ny, nx = CARD_P
    t0 = time.perf_counter()
    data = card_cube(nchan, ny, nx, SEED, dev)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    nbytes = data.numel() * 4
    path = os.path.join(workdir, "card_p.fits")
    base = host_rss()
    with HostPeak() as write_peak:
        t0 = time.perf_counter()
        host = data.cpu().numpy()
        del data
        d2h = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_fits(path, [HDU(data=host, header=synth_header(nchan, ny,
                                                             nx))])
        wrote = time.perf_counter() - t0
        del host
    size = os.path.getsize(path)
    uploads = []
    as_tensor = tcube._as_tensor

    def timed_upload(arr, device):
        t = time.perf_counter()
        out = as_tensor(arr, device)
        torch.cuda.synchronize()
        uploads.append(time.perf_counter() - t)
        return out
    with HostPeak() as read_peak:
        t0 = time.perf_counter()
        tcube._as_tensor = timed_upload
        try:
            cube = T.SpectralCube.read(path, device=dev)
        finally:
            tcube._as_tensor = as_tensor
        torch.cuda.synchronize()
        read = time.perf_counter() - t0
    io_part = (f"made on the card {made:.2f} s, to the host {d2h:.2f} s, "
               f"written ({size / 2**30:.2f} GiB) {wrote:.2f} s; read "
               f"{read:.2f} s (upload {max(uploads):.2f} s); host resident "
               f"{host_gib(base)} before, peaks {write_peak} writing, "
               f"{read_peak} reading")
    log(f"  P {cube}: {io_part}")
    if cube.device != dev or cube.shape != CARD_P:
        raise AssertionError(f"P read: {cube.device}, {cube.shape}")

    _, target_beam = beams()
    target_header = shifted_header(cube.header, *SHIFT)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    with recorded_calls(CARD_KERNELS["P"], numel) as sizes:
        t0 = time.perf_counter()
        res = T.run_pipeline(cube, snr_threshold=SNR, target_beam=target_beam,
                             target_header=target_header)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
    p_launches = big_launches("P", sizes, PIPELINE_KERNELS)
    peak = torch.cuda.max_memory_allocated(dev)
    hold(f"P run_pipeline peak at most {CARD_PEAK_SHARE:.0%} of the card",
         peak <= CARD_PEAK_SHARE * card,
         f"({peak / 2**30:.2f} of {card / 2**30:.2f} GiB, "
         f"{peak / nbytes:.2f} cube bytes)", "P pipeline peak")
    parts.append(f"P {nchan}x{ny}x{nx} ({nchan * ny * nx} voxels, "
                 f"{nbytes / 2**30:.2f} GiB): {io_part}; run_pipeline "
                 f"{first:.1f} ms (first call), peak {peak / 2**30:.2f} GiB "
                 f"({peak / card:.1%} of the card, {peak / nbytes:.2f} cube "
                 f"bytes), launches {p_launches}")
    # the tiles at the extremes of the primary beam's footprint: the
    # corners lie outside it, all NaN
    p_tiles = card_tiles(ny, nx, rd.finite(cube._data[0]).cpu().numpy())

    conv = staged("P", "convolve_to", nbytes,
                  lambda: cube.convolve_to(target_beam))
    noise = staged("P", "mad_std", nbytes,
                   lambda: float(conv.mad_std().value))
    masked = conv.with_mask(conv > T.Quantity(SNR * noise, conv.unit))
    mom = staged("P", "moments", nbytes, masked._moments012)
    stats = staged("P", "statistics", nbytes, masked.statistics)
    rep = staged("P", "reproject", nbytes,
                 lambda: masked._reproject(target_header))
    hold("P mad_std peak above the resident data at most "
         f"{CARD_MAD_RATIO} cube bytes",
         stages["P mad_std"][2] <= CARD_MAD_RATIO,
         f"({stages['P mad_std'][2]:.3f})", "P mad_std peak")
    full = [np.asarray(m.value) for m in res["moments"]]
    with np.errstate(invalid="ignore"):
        staged_moments = [mom[0], mom[1], np.sqrt(mom[2])]
    hold("P stages bit for bit run_pipeline's (moments, linewidth, "
         "reprojected cube, statistics)",
         all(a.tobytes() == np.asarray(b, a.dtype).tobytes()
             for a, b in zip(full, staged_moments))
         and bits_equal(rep._data, res["cube"]._data)
         and all(float(stats[k].value) == float(res["statistics"][k].value)
                 for k in ("sum", "mean", "sigma", "min", "max"))
         and stats["npts"] == res["statistics"]["npts"], "",
         "P stages = run_pipeline")
    del res
    hold_mad_cutout("P", conv._data, conv._valid_view)
    hold_sharded_mad("P", noise, conv._data,
                     include=conv.mask.include(data=conv._data))
    hold_tiles("P", full, lambda y0, x0: [
        m.value for m in T.run_pipeline(
            conv[:, y0:y0 + CARD_TILE, x0:x0 + CARD_TILE],
            snr_threshold=SNR, noise_estimate=noise)["moments"]], p_tiles)
    for c0 in (0, (nchan - CARD_SLAB) // 2, nchan - CARD_SLAB):
        sl = slice(c0, c0 + CARD_SLAB)
        hold(f"P convolve_to of channels {c0}-{c0 + CARD_SLAB - 1} bit for "
             "bit the slab's", bits_equal(
                 cube[sl].convolve_to(target_beam)._data, conv._data[sl]),
             "", f"P convolve_to slab {c0}")
        slab = masked[sl]
        hold(f"P reproject of channels {c0}-{c0 + CARD_SLAB - 1} bit for "
             "bit the slab's", bits_equal(slab._reproject(shifted_header(
                 slab.header, *SHIFT))._data, rep._data[sl]), "",
             f"P reproject slab {c0}")
    del rep, slab
    include = masked.mask.include(data=masked._data)
    hold_stats("P", stats, stats_oracle(
        masked._data, lambda c0, x: include[c0:c0 + x.shape[0]]))
    del include, masked, conv
    torch.cuda.empty_cache()
    # a second call, its kernels' first calls kept and timed at P's shapes
    with recorded_calls(CARD_KERNELS["P"]) as calls:
        t0 = time.perf_counter()
        T.run_pipeline(cube, snr_threshold=SNR, target_beam=target_beam,
                       target_header=target_header)
        torch.cuda.synchronize()
        second = (time.perf_counter() - t0) * 1e3
    p_kernels = time_first_calls("P", calls, PIPELINE_KERNELS)
    parts.append(f"P run_pipeline again {second:.1f} ms; kernel wrapper "
                 "calls " + p_kernels)
    del calls
    torch.cuda.empty_cache()
    # MS's references: the unsharded stages' tiles and slabs on the host
    ms_ref = {}
    parts.append(card_spectral(cube, p_tiles, nbytes, card, sizes, staged,
                               hold, big_launches, time_first_calls, ms_ref))
    torch.cuda.empty_cache()
    parts.append(card_s_f64(cube, nbytes, card, sizes, stages, staged, hold,
                            big_launches, time_first_calls, ms_ref))
    torch.cuda.empty_cache()
    parts.append(card_r(cube, nbytes, card, sizes, stages, staged, hold,
                        big_launches, ms_ref))
    torch.cuda.empty_cache()
    parts.append(card_c(cube, nbytes, card, sizes, stages, staged, hold,
                        big_launches, time_first_calls))
    torch.cuda.empty_cache()
    # M and V: P's data as a varying-resolution cube, written as a 4-D
    # FITS file with a BEAMS table, which M reads onto the meshes (with
    # P's FITS file) and V then reads back with no device argument
    t0 = time.perf_counter()
    ref = card_m_reference(cube, p_tiles)
    ref["MS"] = ms_ref
    del ms_ref
    m_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = cube._data.cpu().numpy()
    d2h = time.perf_counter() - t0
    del cube
    torch.cuda.empty_cache()
    with HostPeak() as vr_peak:
        vr_path, wrote = card_vr_file(host, workdir)
        del host
    parts.append(f"M references on the unsharded P {m_ref:.1f} s; "
                 + card_m(dev, path, vr_path, ref, nbytes, card, stages,
                          staged, hold, big_launches, p_tiles))
    del ref
    os.remove(path)
    torch.cuda.empty_cache()
    with HostPeak() as vr_read_peak:
        vr, read = card_vr_read(vr_path)
    if not isinstance(vr, T.VaryingResolutionSpectralCube) \
            or vr.device.type != "cuda" or vr.shape != CARD_P:
        raise AssertionError(f"V read without a device gave {vr!r}")
    vr_io = (f"V: to the host {d2h:.2f} s, written with a BEAMS table "
             f"{wrote:.2f} s, read {read:.2f} s, host peaks {vr_peak} "
             f"writing, {vr_read_peak} reading, "
             f"{int((~vr.goodbeams_mask).sum())} flagged planes")
    log(f"  {vr_io}")
    parts.append(vr_io + "; " + card_vr(
        vr, p_tiles, nbytes, card, sizes, stages, staged, hold,
        big_launches, time_first_calls, hold_tiles))
    del vr
    torch.cuda.empty_cache()

    # H: moments, statistics() and mad_std() on bench config 8's cube
    nchan, ny, nx = CARD_H
    t0 = time.perf_counter()
    data = headline_cube(nchan, ny, nx, SEED, dev)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    nbytes = data.numel() * 4
    h = synth_header(nchan, ny, nx)
    cube = T.SpectralCube(data, WCS(header=h), header=h)
    masked = cube.with_mask(cube > T.Quantity(CARD_H_THRESHOLD, cube.unit))
    K.reset_launch_counts()
    with recorded_calls(CARD_KERNELS["H"], numel) as sizes:
        full = staged("H", "moments", nbytes, lambda: [
            np.asarray(m.value) for m in (
                masked.moment0(), masked.moment1(),
                masked.linewidth_sigma())])
        stats = staged("H", "statistics", nbytes, masked.statistics)
    h_launches = big_launches("H", sizes)
    with recorded_calls(CARD_KERNELS["H"]) as calls:
        # a new cube: the moments of ``masked`` are cached
        cube.with_mask(masked.mask)._moments012()
    h_launches += "; kernel wrapper calls " + time_first_calls("H", calls)
    del calls
    noise = staged("H", "mad_std", nbytes,
                   lambda: float(masked.mad_std().value))
    hold("H mad_std peak above the resident data at most "
         f"{CARD_MAD_RATIO} cube bytes",
         stages["H mad_std"][2] <= CARD_MAD_RATIO,
         f"({stages['H mad_std'][2]:.3f})", "H mad_std peak")
    parts.append(f"H {nchan}x{ny}x{nx} ({nchan * ny * nx} voxels, "
                 f"{nbytes / 2**30:.2f} GiB): made on the card {made:.2f} "
                 f"s, launches {h_launches}")
    hold_tiles("H", full, lambda y0, x0: [
        np.asarray(m.value) for m in (lambda c: (
            c.moment0(), c.moment1(), c.linewidth_sigma()))(
                masked[:, y0:y0 + CARD_TILE, x0:x0 + CARD_TILE])],
        card_tiles(ny, nx))
    hold_stats("H", stats, stats_oracle(
        data, lambda c0, x: x > CARD_H_THRESHOLD))
    hold_mad_cutout("H", data, masked._valid_view)
    del full
    parts.append(card_reductions(masked, nbytes, stages, staged, hold))
    mask = masked.mask
    del masked
    hold_sharded_mad("H", noise, data, mask_expr=mask)
    del cube, data, mask
    torch.cuda.empty_cache()

    parts.append("stages " + ", ".join(
        f"{k} {ms:.1f} ms / {p / 2**30:.2f} GiB / {r:.3f}"
        for k, (ms, p, r) in stages.items())
        + " (time, peak, rise over cube bytes)")
    parts.append(f"{len(checks)} checks passed: " + ", ".join(checks))
    return "summary: card scale: " + "; ".join(parts)


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


class LaunchTally:
    """A pytest plugin: adds up the port's kernel launches test by test
    and writes the sums to ``path`` when pytest finishes.  A test that
    resets the counters counts its launches after the reset."""

    def __init__(self, path):
        from spectral_cube_tpu_torch import kernels as K
        self.K, self.path = K, path
        self.total = dict.fromkeys(K.WRAPPERS, 0)

    def pytest_runtest_logstart(self, nodeid, location):
        self.K.reset_launch_counts()

    def pytest_runtest_logfinish(self, nodeid, location):
        for k, n in self.K.launch_counts().items():
            self.total[k] += n

    def pytest_sessionfinish(self, session, exitstatus):
        with open(self.path, "w") as f:
            json.dump(self.total, f)


def pytest_configure(config):
    """A pytest hook, active under ``-p chip_smoke``: registers a
    :class:`LaunchTally` writing to the file ``COUNTS_ENV`` names."""
    path = os.environ.get(COUNTS_ENV)
    if path:
        config.pluginmanager.register(LaunchTally(path), "launch_tally")


def run_card_tests(files, workdir, tag):
    """The ``cuda`` cases of ``files`` in a pytest process of their own,
    without the repository's conftest (the card's machine has no JAX).
    Returns the outcomes by file (from its junit report), the totals, the
    seconds and the kernel launches of the process."""
    import xml.etree.ElementTree as ET
    report = os.path.join(workdir, f"{tag}.xml")
    counts = os.path.join(workdir, f"{tag}.launches.json")
    cmd = [sys.executable, "-m", "pytest", "--noconftest",
           "-p", "no:cacheprovider", "-p", "chip_smoke",
           "-o", "filterwarnings=", "-m", "cuda", "-q", "-rfEs",
           f"--junitxml={report}", *files]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          env=dict(os.environ, **{COUNTS_ENV: counts}),
                          timeout=BATTERY_TIMEOUT)
    seconds = time.perf_counter() - t
    for line in proc.stdout.splitlines():
        if line.startswith(("FAILED", "ERROR", "SKIPPED")):
            log(f"  {tag}: {line}")
    log(f"  {tag}: {proc.stdout.strip().splitlines()[-1]}")
    if proc.returncode != 0:
        log(proc.stdout[-6000:])
        log(proc.stderr[-3000:])
        raise AssertionError(f"{tag}: pytest exited {proc.returncode}")
    by_file = {}
    for case in ET.parse(report).getroot().iter("testcase"):
        name = case.get("classname").split(".")[-1]
        tags = {child.tag for child in case}
        outcome = ("failed" if "failure" in tags else "errors"
                   if "error" in tags else "skipped" if "skipped" in tags
                   else "passed")
        by_file.setdefault(name, dict.fromkeys(
            ("passed", "failed", "errors", "skipped"), 0))[outcome] += 1
    totals = {k: sum(f[k] for f in by_file.values())
              for k in ("passed", "failed", "errors", "skipped")}
    with open(counts) as f:
        launches = json.load(f)
    return {"by_file": by_file, "totals": totals, "seconds": seconds,
            "launches": launches}


def phase_batteries():
    """The JAX package's user-facing test batteries run through the port
    (``BATTERY_FILES``), then the kernel tests, every ``cuda`` case on the
    card in a pytest process of its own, the kernels already built.  Fails
    unless each file ran cases and every case passed: no failure, error or
    skip.  Prints one "summary: batteries" line."""
    log("phase batteries (card)")
    runs = {}
    with tempfile.TemporaryDirectory() as workdir:
        for tag, files in (("batteries", BATTERY_FILES),
                           ("kernel tests", KERNEL_TEST_FILES)):
            run = runs[tag] = run_card_tests(files, workdir, tag)
            t = run["totals"]
            ran = {os.path.basename(f)[:-3] for f in files}
            if set(run["by_file"]) != ran or t["passed"] == 0 or \
                    t["failed"] or t["errors"] or t["skipped"]:
                raise AssertionError(f"{tag}: {run['by_file']}")

    def part(tag):
        run = runs[tag]
        return (f"{tag}: " + ", ".join(f"{v} {k}" for k, v in
                                       run["totals"].items())
                + f" in {run['seconds']:.1f} s ("
                + ", ".join(f"{f[len('test_torch_'):]} {c['passed']}"
                            for f, c in run["by_file"].items())
                + "), kernel launches " + ", ".join(
                    f"{k} {n}" for k, n in run["launches"].items()))

    log("summary: batteries (card, cuda cases; pytest --noconftest -m "
        "cuda): " + "; ".join(part(tag) for tag in runs))
    return runs


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
        phase("sharded", phase_sharded, dev, workdir)
        distinct = phase("distinct mesh", phase_distinct_mesh, dev, workdir)
        concurrent = phase("concurrent positions", phase_concurrent, dev,
                           workdir)
        card_scale = phase("card scale", phase_card_scale, dev, workdir)
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
    phase("batteries (card)", phase_batteries)
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
    log(distinct)
    log(concurrent)
    log(card_scale)
    for line in TRACE_LINES:
        log(line)
    if len(TRACE_LINES) != 4:
        raise AssertionError(f"{len(TRACE_LINES)} traced paths, not 4")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
