"""Spectral interpolation / regridding and axis downsampling.

Port of ``spectral_cube_tpu/ops/interpolate.py``.  The interpolation
weights come once from the shared spectral axis and apply as two gathers
and a lerp over the whole cube.  The fused spectral smooth + regrid
(:func:`smooth_interp_cube`) runs kernel 5 (``kernels/smooth_interp.py``,
its plain version on the CPU) with the host operators S (smoothing band),
I (2-tap interpolation) and M = I @ S.  ``downsample_axis`` reproduces the
block-estimator reduce of the reference (spectral_cube.py:3421-3557).
:func:`interp_spectrum` is the 1-D case of a spectrum held on the host.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from ..kernels.smooth_interp import band_rows, smooth_interp
from ..utils import SmoothingWarning, takes_numpy
from .smoothing import _banded_conv_matrix, spectral_smooth_cube

__all__ = ["interp_weights", "interp_cube_spectral", "smooth_interp_cube",
           "compose_interp_banded", "linear_spectral_wcs", "check_nyquist",
           "downsample_axis", "downsample_include", "_interp_matrix",
           "interp_spectrum"]


def interp_weights(inaxis, outaxis):
    """Indices and fractions for linear interpolation from ``inaxis`` onto
    ``outaxis`` with np.interp edge-clamping semantics.

    Both axes may be descending; the reference requires monotonicity and a
    *linear* output grid (checks at spectral_cube.py:3253-3285)."""
    inaxis = np.asarray(inaxis, dtype=np.float64)
    outaxis = np.asarray(outaxis, dtype=np.float64)
    if inaxis.size < 2:
        raise ValueError("spectral interpolation needs at least 2 input "
                         f"channels, got {inaxis.size}")
    flip_in = False
    if inaxis[1] < inaxis[0]:
        inaxis = inaxis[::-1]
        flip_in = True
    if np.any(np.diff(inaxis) <= 0):
        raise ValueError("input spectral axis must be strictly monotonic")
    idx = np.searchsorted(inaxis, outaxis, side="right") - 1
    idx = np.clip(idx, 0, inaxis.size - 2)
    x0 = inaxis[idx]
    x1 = inaxis[idx + 1]
    frac = (outaxis - x0) / (x1 - x0)
    frac = np.clip(frac, 0.0, 1.0)  # np.interp clamps outside the range
    if flip_in:
        idx = inaxis.size - 2 - idx
        frac = 1.0 - frac
    return idx.astype(np.int32), frac


def _interp_matrix(idx, frac, nin):
    """(nout, nin) 2-tap linear-interpolation matrix.  Zero-weight taps are
    simply absent, preserving np.interp's exact-hit semantics (a NaN
    zero-weight neighbor must not poison the result)."""
    nout = idx.shape[0]
    mat = np.zeros((nout, nin), dtype=np.float32)
    rows = np.arange(nout)
    np.add.at(mat, (rows, idx), (1.0 - frac).astype(np.float32))
    np.add.at(mat, (rows, idx + 1), frac.astype(np.float32))
    return mat


def compose_interp_banded(idx, frac, banded, dtype=np.float64):
    """``_interp_matrix(idx, frac, nin) @ banded`` without the dense
    product: each output row is a float64 weighted sum of two row windows
    of ``banded``, rounded once to ``dtype`` (interpolate.py:67-101)."""
    B = np.asarray(banded)
    nrow, nin = B.shape
    idx = np.asarray(idx)
    w1 = np.asarray(frac, dtype=np.float64)[:, None]
    nout = idx.shape[0]
    i1 = np.minimum(idx + 1, nrow - 1)
    nz_r, nz_c = np.nonzero(B)
    lo = np.full(nrow, nin, np.int64)
    hi = np.full(nrow, -1, np.int64)
    np.minimum.at(lo, nz_r, nz_c)
    np.maximum.at(hi, nz_r, nz_c)
    rlo = np.minimum(lo[idx], lo[i1])
    rhi = np.maximum(hi[idx], hi[i1])
    W = max(1, int((rhi - rlo + 1).max())) if nout else 1
    rlo = np.clip(rlo, 0, nin - W)
    cols = rlo[:, None] + np.arange(W)[None, :]
    band = (1.0 - w1) * B[idx[:, None], cols].astype(np.float64) \
        + w1 * B[i1[:, None], cols].astype(np.float64)
    out = np.zeros((nout, nin), dtype)
    np.put_along_axis(out, cols, band.astype(dtype), axis=1)
    return out


def _gather_lerp(x, idx_t, frac_t):
    """The 2-tap lerp along axis 0 with np.interp's exact hits: a sample
    on the grid returns that sample, so a NaN neighbour of weight 0 does
    not poison it."""
    lo = x.index_select(0, idx_t)
    hi = x.index_select(0, idx_t + 1)
    lerp = lo * (1 - frac_t) + hi * frac_t
    return torch.where(frac_t == 0, lo, torch.where(frac_t == 1, hi, lerp))


def _weights_on(device, idx, frac, ndim):
    tail = (1,) * (ndim - 1)
    return (torch.as_tensor(idx.astype(np.int64), device=device),
            torch.as_tensor(frac, dtype=torch.float32,
                            device=device).reshape((-1,) + tail))


def _interp_include(include, shape, idx_t, frac_t):
    """Include mask after the interpolation: included only where every
    neighbour of nonzero weight is included ("excluded mass == 0")."""
    inc = torch.as_tensor(include, device=idx_t.device)
    exc = 1.0 - inc.to(torch.float32).expand(tuple(shape))
    return _gather_lerp(exc, idx_t, frac_t) == 0


@takes_numpy
def interp_cube_spectral(data, inaxis, outaxis, include=None):
    """Interpolate a [spec, y, x] cube onto a new spectral grid.

    Returns (new_data, new_include_or_None).  The mask interpolates as a
    float and stays included only where every contributing neighbor is
    included: the reference interpolates the *filled* data, so one
    excluded neighbor NaN-poisons the output sample
    (spectral_cube.py:3267-3310).  A tensor gives tensors on its device,
    numpy data numpy results (:func:`~..utils.takes_numpy`)."""
    idx, frac = interp_weights(inaxis, outaxis)
    idx_t, frac_t = _weights_on(data.device, idx, frac, data.ndim)
    out = _gather_lerp(data, idx_t, frac_t).to(data.dtype)
    new_include = None
    if include is not None:
        new_include = _interp_include(include, data.shape, idx_t, frac_t)
    return out, new_include


_SI_OP_CACHE = {}
#: the positions of a mesh ask for the operators at once
_SI_OP_LOCK = threading.Lock()


def _nbytes(val):
    S, Imat, M_host, bands = val
    return sum(a.nbytes for a in (S, Imat, M_host)) + sum(
        start.nbytes + taps.nbytes for start, taps in bands)


def _si_operators(k, idx, frac, nin):
    """Host operators (S float32 band matrix, I float32 2-tap matrix,
    M = I @ S float32 composed, and kernel 5's band descriptors
    ``band_rows`` of (M, S, I)) for the fused smooth+interp, cached by
    value of the normalized kernel and the interp weights, and bounded by
    bytes (interpolate.py:299-330)."""
    key = (int(nin), k.tobytes(), idx.tobytes(), frac.tobytes())
    with _SI_OP_LOCK:
        hit = _SI_OP_CACHE.get(key)
    if hit is not None:
        return hit
    S = _banded_conv_matrix(nin, k)
    Imat = _interp_matrix(idx, frac, nin)
    M_host = compose_interp_banded(idx, frac, S, dtype=np.float32)
    val = (S, Imat, M_host, [band_rows(A) for A in (M_host, S, Imat)])
    nbytes = _nbytes(val)
    with _SI_OP_LOCK:
        total = sum(_nbytes(v) for v in _SI_OP_CACHE.values())
        if len(_SI_OP_CACHE) >= 8 or total + nbytes > 2 * 2 ** 30:
            _SI_OP_CACHE.clear()
        _SI_OP_CACHE[key] = val
    return val


def smooth_interp_cube(data, kernel, inaxis, outaxis, include=None):
    """Fused spectral smooth + regrid of a [spec, ...] cube, the workflow
    the reference documents as ``spectral_smooth`` then
    ``spectral_interpolate`` (docs/smoothing.rst).

    float32 data goes through kernel 5 (its plain version on the CPU): a
    spectrum with no NaN takes the composed operator M = I @ S, one with
    NaN the exact chain (normalized smooth, then the interp with NaN
    poisoning), decided per spectrum from its own finiteness.  Other
    dtypes run the chain.  The include mask transforms as in
    :func:`interp_cube_spectral` (the smooth leaves it unchanged).

    Returns (new_data, new_include_or_None)."""
    idx, frac = interp_weights(inaxis, outaxis)
    if data.dtype != torch.float32:
        sm = spectral_smooth_cube(data, kernel)
        return interp_cube_spectral(sm, inaxis, outaxis, include=include)
    k = np.asarray(kernel, dtype=np.float64)
    k = k / k.sum()
    nin, nout = data.shape[0], idx.shape[0]
    S, Imat, M_host, bands = _si_operators(k, idx, frac, nin)
    out = smooth_interp(data.contiguous(), M_host, S, Imat, bands)
    new_include = None
    if include is not None:
        new_include = _interp_include(
            include, data.shape, *_weights_on(data.device, idx, frac,
                                              data.ndim))
    return out.reshape((nout,) + tuple(data.shape[1:])), new_include


def check_nyquist(inaxis, outaxis):
    indiff = np.abs(np.diff(inaxis).mean())
    outdiff = np.abs(np.diff(outaxis).mean())
    if outdiff > 2 * indiff:
        warnings.warn("Input grid has too small a spacing. The data should "
                      "be smoothed prior to resampling.", SmoothingWarning)


def linear_spectral_wcs(wcs, outaxis, unit=None):
    """New WCS with a linear spectral axis matching ``outaxis`` (reference
    spectral_cube.py:3317-3324)."""
    outaxis = np.asarray(outaxis, dtype=np.float64)
    new = wcs.deepcopy()
    i = new.spec
    new.crpix[i] = 1.0
    new.crval[i] = float(outaxis[0])
    new.cdelt[i] = float(outaxis[1] - outaxis[0]) if outaxis.size > 1 \
        else new.cdelt[i]
    new.pc[i, :] = 0.0
    new.pc[:, i] = 0.0
    new.pc[i, i] = 1.0
    if unit is not None:
        new.cunit[i] = unit
    # the axis is now linearly sampled in its own variable
    ct = new.ctype[i]
    if len(ct) > 4:
        new.ctype[i] = ct[:4]
    return new


def interp_spectrum(value, inaxis, outaxis, wcs,
                    suppress_smooth_warning=False, fill_value=None,
                    include=None):
    """The 1-D case of ``OneDSpectrum.spectral_interpolate``
    (interpolate.py:455-486) on host arrays.  Returns ``(out, new_wcs,
    new_include_or_None)``: a sample stays included only where every
    neighbour it takes weight from is included, as the cube path poisons
    its include mask; an exact grid hit or an edge clamp returns the
    sample itself, so a zero-weight NaN neighbour never poisons it."""
    if not suppress_smooth_warning:
        check_nyquist(inaxis, outaxis)
    idx, frac = interp_weights(inaxis, outaxis)

    def lerp(v):
        mixed = v[idx] * (1 - frac) + v[idx + 1] * frac
        return np.where(frac == 0, v[idx],
                        np.where(frac == 1, v[idx + 1], mixed))

    out = lerp(value)
    if fill_value is not None:
        lo, hi = min(inaxis[0], inaxis[-1]), max(inaxis[0], inaxis[-1])
        out = np.where((outaxis < lo) | (outaxis > hi), fill_value, out)
    new_include = None
    if include is not None:
        new_include = lerp(1.0 - np.asarray(include, dtype=float)) == 0
    return out, linear_spectral_wcs(wcs, outaxis), new_include


def _nanmedian(x, dim):
    """jnp.nanmedian along ``dim``: the mean of the two middle non-NaN
    values for an even count (``torch.nanmedian`` takes the lower one),
    NaN where all are NaN."""
    s = torch.sort(x, dim=dim).values       # NaN sorts last
    n = (~torch.isnan(x)).sum(dim, keepdim=True)
    lo = torch.gather(s, dim, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(s, dim, torch.clamp(n // 2, min=0).clamp(
        max=x.shape[dim] - 1))
    med = ((lo + hi) * 0.5).squeeze(dim)
    return torch.where(n.squeeze(dim) > 0, med, float("nan"))


def _nanextreme(fn, fill):
    def est(x, dim):
        allnan = torch.isnan(x).all(dim)
        out = fn(torch.where(torch.isnan(x), fill, x), dim=dim)
        return torch.where(allnan, float("nan"), out)
    return est


ESTIMATORS = {
    "mean": lambda x, dim: torch.nanmean(x, dim=dim),
    "sum": lambda x, dim: torch.nansum(x, dim=dim),
    "median": _nanmedian,
    "max": _nanextreme(torch.amax, float("-inf")),
    "min": _nanextreme(torch.amin, float("inf")),
}


def downsample_axis(data, factor, axis, estimator="mean", truncate=False):
    """Block-downsample along ``axis`` with a NaN-aware estimator
    (reference spectral_cube.py:3421-3557).

    With ``truncate=False`` a ragged tail block is padded with NaN so the
    estimator sees only real samples.  ``estimator``: a name of
    :data:`ESTIMATORS` or a callable ``f(x, dim)``."""
    est = ESTIMATORS[estimator] if isinstance(estimator, str) else estimator
    n = data.shape[axis]
    factor = int(factor)
    if truncate:
        keep = (n // factor) * factor
        data = data.narrow(axis, 0, keep)
        n = keep
    pad = (-n) % factor
    if pad:
        shape = list(data.shape)
        shape[axis] = pad
        data = torch.cat([data, torch.full(shape, float("nan"),
                                           dtype=data.dtype,
                                           device=data.device)], dim=axis)
    shape = list(data.shape)
    shape[axis] = data.shape[axis] // factor
    shape.insert(axis + 1, factor)
    return est(data.reshape(shape), axis + 1)


def downsample_include(include, factor, axis, truncate=False):
    """Block-downsample a boolean include mask: a block is included if any
    of its members is (reference spectral_cube.py:3497-3503 ``np.any`` over
    each factor-block; the ragged tail pads with excluded)."""
    include = include.to(torch.bool)
    factor = int(factor)
    n = include.shape[axis]
    if truncate:
        keep = (n // factor) * factor
        include = include.narrow(axis, 0, keep)
        n = keep
    pad = (-n) % factor
    if pad:
        shape = list(include.shape)
        shape[axis] = pad
        include = torch.cat([include, torch.zeros(shape, dtype=torch.bool,
                                                  device=include.device)],
                            dim=axis)
    shape = list(include.shape)
    shape[axis] = include.shape[axis] // factor
    shape.insert(axis + 1, factor)
    return include.reshape(shape).any(axis + 1)
