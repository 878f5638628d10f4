"""The plain reference of ``run_pipeline``'s chain and the comparison of
the program's products with it.

Chain (the spectral-cube reference's ``convolve_to``, ``mad_std``,
``with_mask(cube > k * sigma)``, ``moment0/1``, ``linewidth_sigma``,
``statistics`` and ``reproject``):

1. every plane convolved to the target beam (``conv.normalized_conv2d``
   with the kernel of ``beam``) and rescaled by the ratio of beam areas
   (Jy/beam);
2. sigma = 1.482602218505602 * median |x - median x| over the finite
   voxels (exact order statistics, ``select``), or the noise the step
   gives;
3. the mask: finite and above float32(snr * sigma);
4. moments along the spectral axis of the masked voxels, in float64:
   mom0 = dv sum w, mom1 = v0 + sum w c / sum w, linewidth =
   sqrt(sum w (c - mom1')^2 / sum w), NaN where no voxel is included;
5. statistics of the masked voxels (npts, sum, mean, sigma with ddof 1,
   rms, min, max), in float64;
6. the masked cube, NaN where excluded, resampled bilinearly onto the
   target grid, a translation by the cube's (dx, dy): output pixel (j, i)
   reads input (j - dy, i - dx); NaN outside the input (1e-3 pixel of
   slack) and wherever a NaN neighbour carries a weight above 1e-6.

Where float32 itself cannot decide a voxel, the comparison leaves it out
and counts it: a denominator between 1e-7 and 3e-3 (the value's float32
error grows as 1e-7 / den, and near 1e-6 its NaN state is rounding; at
3e-3 the error is a third of the threshold's band and a tenth of the
tightest limit), and a value within 1e-4 of the mask's threshold.  A spaxel holding such a voxel
is left out of the moment maps' comparison, and an output voxel whose
four sources hold one, out of the cube's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import beam as _beam
from . import conv as _conv
from . import select as _select
from .numerics import IEEE
from .stream import BLOCK_VOXELS, Stream

MAD_STD_FACTOR = 1.482602218505602
#: denominators strictly between these leave a voxel undecided
DEN_TRUST = (1e-7, 3e-3)
#: values within this share of the threshold leave a voxel undecided
THRESHOLD_BAND = 1e-4
#: slack of the reprojection's in-range test and its NaN weight floor
RANGE_SLACK = 1e-3
POISON = 1e-6


def _blocks(nchan, plane):
    step = max(1, BLOCK_VOXELS // plane)
    return [(c0, min(nchan, c0 + step)) for c0 in range(0, nchan, step)]


def _axis_taps(n_out, shift, n_in):
    """Bilinear taps of a translation by ``shift``: source index i0,
    weights (1 - w, w) in float32, and the in-range flags."""
    src = np.arange(n_out, dtype=np.float64) - shift
    ok = (src >= -RANGE_SLACK) & (src <= n_in - 1 + RANGE_SLACK)
    cl = np.clip(src, 0, n_in - 1)
    i0 = np.clip(np.floor(cl).astype(np.int64), 0, max(n_in - 2, 0))
    w = (cl - i0).astype(np.float32)
    return i0, np.float32(1.0) - w, w, ok


def _lerp2(a, ty, tx, arith):
    """y taps, then x taps, on (c, ny, nx) planes."""
    dev = a.device
    (y0, gy, fy, _), (x0, gx, fx, _) = ty, tx
    ny, nx = a.shape[1:]
    y0t = torch.as_tensor(y0, device=dev)
    y1t = torch.clamp(y0t + 1, max=ny - 1)
    x0t = torch.as_tensor(x0, device=dev)
    x1t = torch.clamp(x0t + 1, max=nx - 1)
    w = [arith(torch.as_tensor(v, device=dev)) for v in (gy, fy, gx, fx)]
    a = arith(a)
    t = arith(w[0][:, None] * a[:, y0t, :] + w[1][:, None] * a[:, y1t, :])
    return w[2] * t[:, :, x0t] + w[3] * t[:, :, x1t]


def _any2(a, ty, tx):
    """Whether any of the four sources of each output is set in (c, ny,
    nx) bool ``a``."""
    dev = a.device
    ny, nx = a.shape[1:]
    y0 = torch.as_tensor(ty[0], device=dev)
    x0 = torch.as_tensor(tx[0], device=dev)
    t = a[:, y0, :] | a[:, torch.clamp(y0 + 1, max=ny - 1), :]
    return t[:, :, x0] | t[:, :, torch.clamp(x0 + 1, max=nx - 1)]


def convolved(inp, config, arith=IEEE):
    """(the input convolved to the target beam and rescaled, the voxels
    whose denominator float32 cannot decide), a block of channels at a
    time."""
    nchan, ny, nx = inp.shape
    pairs = _conv.separable_pairs(_beam.convolution_kernel(config),
                                  _beam.separable)
    factor = float(np.float32(_beam.area_ratio(config["target_beam"],
                                               config["beam"])))
    conv = torch.empty_like(inp)
    undecided = torch.empty(inp.shape, dtype=torch.bool, device=inp.device)
    for c0, c1 in _blocks(nchan, ny * nx):
        val, den = _conv.normalized_conv2d(inp[c0:c1], pairs, arith)
        conv[c0:c1] = val.mul_(factor)
        undecided[c0:c1] = (den > DEN_TRUST[0]) & (den < DEN_TRUST[1])
        del val, den
    return conv, undecided


def mad_std(conv, blocks):
    """1.482602218505602 * median |x - median x| over the finite voxels,
    exact, as float32."""
    def finite_values():
        for c0, c1 in blocks:
            b = conv[c0:c1]
            yield b[torch.isfinite(b)]
    n = sum(int(torch.isfinite(conv[c0:c1]).sum()) for c0, c1 in blocks)
    med = _select.median(finite_values, n)

    def deviations():
        for v in finite_values():
            yield torch.abs(v - med)
    return float(np.float32(MAD_STD_FACTOR * _select.median(deviations, n)))


def _masks(x, undecided, thr):
    """(finite, included, undecided) of a block of the convolved cube."""
    fin = torch.isfinite(x)
    inc = fin & (x > thr)
    und = undecided | (fin & (torch.abs(x - thr) <= THRESHOLD_BAND * thr))
    return fin, inc, und


def apply(inp, config, op, draw, arith=IEEE):
    """The reference of one cube of the pipeline step ``op`` (its
    ``snr_threshold`` and ``noise``) on input ``inp`` (float32, on its
    device) under ``config`` and the cube's ``draw`` ({"dx", "dy"}):
    (products, the reprojected cube as a :class:`~.stream.Stream`).  The
    products are ``sigma`` (where the noise is ``mad_std``),
    ``threshold``, ``mom0``, ``mom1``, ``linewidth`` (float64 host maps),
    ``statistics`` and ``trust_spaxel`` (host bool, the decidable
    spaxels); the cube's blocks carry the decidable output voxels."""
    nchan, ny, nx = inp.shape
    dev = inp.device
    blocks = _blocks(nchan, ny * nx)
    conv, undecided = convolved(inp, config, arith)
    products = {}
    if op["noise"] == "mad_std":
        sigma = products["sigma"] = mad_std(conv, blocks)
    else:
        sigma = float(op["noise"])
    thr = float(np.float32(float(op["snr_threshold"]) * sigma))

    h = config["header"]
    cdelt = float(h["cdelt3_m_s"])
    v0 = float(h["crval3_m_s"])
    off = torch.arange(nchan, dtype=torch.float64, device=dev) * cdelt
    s0 = torch.zeros((ny, nx), dtype=torch.float64, device=dev)
    s1 = torch.zeros_like(s0)
    s2 = torch.zeros_like(s0)
    cnt = torch.zeros((ny, nx), dtype=torch.int64, device=dev)
    doubt = torch.zeros((ny, nx), dtype=torch.bool, device=dev)
    st = {"npts": 0, "sum": 0.0, "sumsq": 0.0, "min": math.inf,
          "max": -math.inf}
    for c0, c1 in blocks:
        x = conv[c0:c1]
        fin, inc, und = _masks(x, undecided[c0:c1], thr)
        doubt |= und.any(0)
        w = arith(torch.where(inc, x, 0.0)).double()
        c = arith(off[c0:c1].float()).double()[:, None, None]
        s0 += w.sum(0)
        s1 += (w * c).sum(0)
        s2 += (w * c * c).sum(0)
        cnt += inc.sum(0)
        vals = x[inc].double()
        if vals.numel():
            st["npts"] += int(vals.numel())
            st["sum"] += float(vals.sum())
            st["sumsq"] += float((vals * vals).sum())
            st["min"] = min(st["min"], float(vals.min()))
            st["max"] = max(st["max"], float(vals.max()))
        del x, fin, inc, und, w, vals
    some = cnt > 0
    safe = torch.where(some, s0, 1.0)
    m1 = s1 / safe
    mom2 = torch.clamp(s2 / safe - m1 * m1, min=0.0)
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=dev)
    npts = st["npts"]
    mean = st["sum"] / npts if npts else math.nan
    var = (st["sumsq"] - npts * mean * mean) / (npts - 1) if npts > 1 \
        else math.nan
    products.update(
        threshold=thr,
        mom0=torch.where(some, s0 * abs(cdelt), nan).cpu().numpy(),
        mom1=torch.where(some, m1 + v0, nan).cpu().numpy(),
        linewidth=torch.where(some, torch.sqrt(mom2), nan).cpu().numpy(),
        statistics={"npts": float(npts), "sum": st["sum"], "mean": mean,
                    "sigma": math.sqrt(max(var, 0.0)),
                    "rms": math.sqrt(st["sumsq"] / npts) if npts
                    else math.nan,
                    "min": st["min"], "max": st["max"]},
        trust_spaxel=(~doubt).cpu().numpy())

    ty = _axis_taps(ny, float(draw["dy"]), ny)
    tx = _axis_taps(nx, float(draw["dx"]), nx)
    in_range = torch.as_tensor(ty[3][:, None] & tx[3][None, :], device=dev)

    def cube_blocks():
        for c0, c1 in blocks:
            x = conv[c0:c1]
            _, inc, und = _masks(x, undecided[c0:c1], thr)
            filled = torch.where(inc, x, float("nan"))
            val = _lerp2(torch.nan_to_num(filled, nan=0.0), ty, tx, arith)
            wn = _lerp2(torch.isnan(filled).float(), ty, tx, IEEE)
            val = torch.where((wn > POISON) | ~in_range, float("nan"), val)
            yield (slice(c0, c1),), val, ~_any2(und, ty, tx)
    return products, Stream(inp.shape, dev, cube_blocks)


def _map_gap(got, want, trust):
    """The widest gap of a host map over the decidable spaxels, as a share
    of the reference's largest magnitude there; a NaN where the other
    holds a value counts 1."""
    got = np.asarray(got, np.float64)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    if np.any((nan_g != nan_w) & trust):
        return 1.0
    both = trust & ~nan_w
    if not both.any():
        return 0.0
    scale = float(np.max(np.abs(want[both])))
    return float(np.max(np.abs(got[both] - want[both]))) / max(scale, 1e-300)


STAT_KEYS = ("npts", "sum", "mean", "sigma", "rms", "min", "max")


def compare(got, want):
    """The numbers compared, from the program's products ``got`` (mom0,
    mom1, linewidth, statistics, and sigma where the noise came from
    ``mad_std``) and the reference's ``want`` (:func:`apply`), with what
    each left out.  The cube is compared by ``stream.compare``."""
    trust = want["trust_spaxel"]
    numbers = {}
    if "sigma" in want:
        numbers["sigma_rel"] = abs(got["sigma"] - want["sigma"]) \
            / want["sigma"]
    for name in ("mom0", "mom1", "linewidth"):
        numbers[f"{name}_gap"] = _map_gap(got[name], want[name], trust)
    numbers["stats_rel"] = max(
        abs(float(got["statistics"][k]) - want["statistics"][k])
        / max(abs(want["statistics"][k]), 1e-300) for k in STAT_KEYS)
    return numbers, {"undecided_spaxels": int((~trust).sum())}
