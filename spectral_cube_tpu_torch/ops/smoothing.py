"""Spectral/spatial smoothing, filtering, and sigma clipping.

Port of ``spectral_cube_tpu/ops/smoothing.py``.  1-D spectral
convolutions are banded matrix products over all spaxels at once (library
matmuls in IEEE float32, as the JAX package leaves them to XLA at HIGHEST
precision); spatial smoothing runs the separable convolution kernel
(``ops/convolve.py``, kernel 2) or, for a full-rank kernel, one
``conv2d``; median filters are sliding-window stacks with numpy median
semantics; the sigma clip runs kernel 4 (``kernels/sigma_clip.py``) for a
float32 cube with stdfunc='std' and its sorted-band plain version
otherwise.  NaN handling matches astropy ``convolve``
(``nan_treatment='interpolate'``, ``boundary='fill'(0)``,
``normalize_kernel=True``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import sigma_clip as _clip
from ..kernels.conv_sep import DEN_EPS
from ..profiling import spanned
from ..utils import ieee_fp32, takes_numpy
from . import reductions as _red

__all__ = ["convolve1d_nan", "spectral_smooth_cube", "spatial_smooth_cube",
           "spectral_median_filter_cube", "spatial_median_filter_cube",
           "sigma_clip_spectrally", "gaussian_kernel1d",
           "_banded_conv_matrix", "banded_tap_offset"]

# the single dense banded product serves spectral axes up to this length;
# longer axes take the overlap-save chunked form (smoothing.py:40)
_DENSE_CONV_MAX_N = 512


def gaussian_kernel1d(stddev, size=None):
    """Host-side 1-D Gaussian kernel matching astropy Gaussian1DKernel:
    sampled at integer offsets, support 8*stddev (odd), normalized."""
    if size is None:
        size = int(8 * float(stddev) + 1) | 1
    x = np.arange(size, dtype=float) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / float(stddev)) ** 2)
    return k / k.sum()


def banded_tap_offset(n_taps):
    """Centre offset of a kernel of ``n_taps`` taps: flipped tap ``o``
    lands on input index ``i + o - banded_tap_offset(n_taps)``."""
    return n_taps - 1 - (n_taps - 1) // 2


def _round_up(x, m):
    return -(-x // m) * m


def _banded_conv_matrix(n, kernel):
    """(n, n) banded true-convolution matrix with zero-fill boundary.

    The kernel is flipped so asymmetric kernels match np.convolve
    'same' / astropy convolve semantics (convolution, not correlation)."""
    k = np.asarray(kernel, dtype=np.float32)[::-1]
    half = len(k) - 1 - (len(k) - 1) // 2
    mat = np.zeros((n, n), dtype=np.float32)
    for o, kv in enumerate(k):
        d = o - half
        idx = np.arange(max(0, -d), min(n, n - d))
        mat[idx, idx + d] = kv
    return mat


def _apply_rows(mat, x):
    """``mat`` (r, c) applied along axis 0 of ``x`` (c, ...)."""
    flat = x.reshape(x.shape[0], -1)
    with ieee_fp32():
        out = torch.matmul(mat, flat)
    return out.reshape((mat.shape[0],) + tuple(x.shape[1:]))


def _band_blocks(n, kernel, dtype, device):
    """The overlap-save blocks of a banded convolution along an axis of
    length ``n``: the axis splits into chunks of C; every chunk applies
    the same (C, C+2h) Toeplitz band matrix to its haloed window, so the
    cost is linear in n.  Edge blocks drop the out-of-range columns,
    which is exactly the zero-fill boundary (smoothing.py:63-113).
    Yields ``(r0, rows, cs, ce, W)``: output rows ``r0:r0 + rows`` are
    ``W @`` input rows ``cs:ce``."""
    kf = np.asarray(kernel, dtype=np.float32)[::-1]
    klen = len(kf)
    half_lo = klen - 1 - (klen - 1) // 2   # taps reaching backward
    half_hi = (klen - 1) // 2              # taps reaching forward
    h = max(half_lo, half_hi)
    chunk = min(max(64, _round_up(h + 1, 8) * 2), _round_up(n, 8))
    nb = -(-n // chunk)
    # W[r, c] over the haloed window: output row r reads window column
    # r + h + d for tap offset d in [-half_lo, half_hi]
    rr, cc = np.mgrid[0:chunk, 0:chunk + 2 * h]
    o = cc - rr - h + half_lo
    W = np.where((o >= 0) & (o < klen),
                 kf[np.clip(o, 0, klen - 1)], 0.0).astype(np.float32)
    Wt = torch.as_tensor(W, dtype=dtype, device=device)
    for i in range(nb):
        s, e = i * chunk - h, i * chunk + chunk + h
        cs, ce = max(s, 0), min(e, n)
        rows = min(chunk, n - i * chunk)
        yield i * chunk, rows, cs, ce, Wt[:rows, cs - s:W.shape[1] - (e - ce)]


def _block_banded_conv(data, kernel):
    """Overlap-save banded convolution along axis 0 (:func:`_band_blocks`)."""
    out = torch.empty_like(data)
    for r0, rows, cs, ce, Wi in _band_blocks(data.shape[0], kernel,
                                             data.dtype, data.device):
        out[r0:r0 + rows] = _apply_rows(Wi, data[cs:ce])
    return out


def _conv1d_along_axis0(data, kernel):
    """Convolve ``data`` (n, ...) with ``kernel`` (k,) along axis 0, zero
    padding, as a banded matrix product (smoothing.py:116-139)."""
    n = data.shape[0]
    if n > _DENSE_CONV_MAX_N:
        return _block_banded_conv(data, kernel)
    mat = torch.as_tensor(_banded_conv_matrix(n, kernel), dtype=data.dtype,
                          device=data.device)
    return _apply_rows(mat, data)


def _nan_rows(W, x, v, flags, out):
    """``W @`` the rows ``x`` (validity ``v``) under astropy's NaN rule,
    written into ``out``: the numerator ``W @ where(v, x, 0)`` over the
    denominator ``1 - W @ (1 - v)``, NaN where that is at most 1e-6.
    ``flags`` holds 0 and 1 in the output's dtype, the invalid rows'
    weights ``where(v, 0, 1)`` formed in one pass."""
    num = _apply_rows(W, torch.where(v, x, 0).to(out.dtype))
    den = _apply_rows(W, torch.where(v, flags[0], flags[1]))
    den.neg_().add_(1.0)
    torch.div(num, den, out=out)
    out.masked_fill_(den <= DEN_EPS, float("nan"))


@spanned("sct.smoothing.convolve1d_nan")
def convolve1d_nan(data, kernel, axis=0):
    """astropy-convolve semantics along ``axis``: NaNs are interpolated over
    (normalized convolution), zero-fill boundary, kernel normalized; a
    spectrum with no finite value stays NaN.  The validity is formed once
    (:func:`~.reductions.finite`, a bool array); the filled data, the
    numerator and the denominator a block of rows at a time (the banded
    blocks of a long axis, each block's window filled as it is read) or
    a tile of whole spectra at a time (the dense product of a short
    axis), each block's quotient divided straight into the output: no
    float temporary the size of the cube but the output."""
    kernel = np.asarray(kernel, dtype=float)
    kernel = kernel / kernel.sum()
    x = data.movedim(axis, 0) if axis != 0 else data
    comp = torch.float64 if data.dtype == torch.float64 else torch.float32
    v = _red.finite(x)
    n = x.shape[0]
    if bool(v.all()):
        out = _conv1d_along_axis0(x.to(comp).contiguous(), kernel)
    else:
        out = torch.empty(x.shape, dtype=comp, device=x.device)
        flags = torch.tensor([0.0, 1.0], dtype=comp, device=x.device)
        if n > _DENSE_CONV_MAX_N:
            for r0, rows, cs, ce, W in _band_blocks(n, kernel, comp,
                                                    x.device):
                _nan_rows(W, x[cs:ce], v[cs:ce], flags, out[r0:r0 + rows])
        else:
            mat = torch.as_tensor(_banded_conv_matrix(n, kernel),
                                  dtype=comp, device=x.device)
            flat, xf, vf = out.view(n, -1), x.reshape(n, -1), \
                v.reshape(n, -1)
            for idx in _red.lane_tiles(xf.shape, (0,)):
                _nan_rows(mat, xf[idx], vf[idx], flags, flat[idx])
        out.masked_fill_(v.any(0, keepdim=True).logical_not_(), float("nan"))
    if axis != 0:
        out = out.movedim(0, axis)
    return out.to(data.dtype)


def spectral_smooth_cube(data, kernel):
    """Convolve along the spectral axis (axis 0) of a [spec, y, x] cube."""
    return convolve1d_nan(data, kernel, axis=0)


def spatial_smooth_cube(data, kernel2d):
    """Convolve each channel map with a 2-D kernel (zero boundary,
    NaN-interpolating, normalized), batched over channels.  Low-rank
    kernels (every Gaussian) run the separable convolution kernel;
    full-rank kernels one ``conv2d`` in IEEE float32."""
    k = np.asarray(kernel2d, dtype=float)
    k = k / k.sum()
    if data.ndim == 3 and k.shape[0] <= 2 * data.shape[1] \
            and k.shape[1] <= 2 * data.shape[2]:
        from .convolve import convolve2d_separable
        out = convolve2d_separable(data, k)
        if out is not None:
            return out
    comp = torch.float64 if data.dtype == torch.float64 else torch.float32
    valid = torch.isfinite(data)
    filled = torch.where(valid, data, 0).to(comp)
    weight = torch.as_tensor(np.ascontiguousarray(k[::-1, ::-1]), dtype=comp,
                             device=data.device)[None, None]
    py, px = (k.shape[0] - 1) // 2, (k.shape[1] - 1) // 2
    pad = (k.shape[1] - 1 - px, px, k.shape[0] - 1 - py, py)

    def conv(x):
        with ieee_fp32():
            return F.conv2d(F.pad(x[:, None], pad), weight)[:, 0]

    out = conv(filled)
    if not bool(valid.all()):
        den = 1.0 - conv((~valid).to(comp))
        ok = den > DEN_EPS
        o = torch.where(ok, out / torch.where(ok, den, 1.0), float("nan"))
        out = torch.where(valid.any(dim=(1, 2), keepdim=True), o,
                          float("nan"))
    return out.to(data.dtype)


def _symmetric_index(n, before, after, device):
    """Indices of numpy's 'symmetric' pad (scipy.ndimage 'reflect': the
    edge sample repeats) of a length-``n`` axis, any pad width."""
    i = torch.arange(-before, n + after, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _sliding_stack(data, size, axis):
    """``size`` shifted copies of ``data`` along a new leading axis,
    reflect-padded along ``axis`` (scipy.ndimage's default boundary)."""
    half = size // 2
    n = data.shape[axis]
    idx = _symmetric_index(n, half, size - 1 - half, data.device)
    return torch.stack([data.index_select(axis, idx[o:o + n])
                        for o in range(size)])


def _median0(stack):
    """numpy/jnp median along axis 0: the mean of the two middle values
    for an even count, NaN where any value is NaN."""
    m = stack.shape[0]
    s = torch.sort(stack, dim=0).values
    med = (s[(m - 1) // 2] + s[m // 2]) * 0.5
    return torch.where(torch.isnan(stack).any(0), float("nan"), med)


def spectral_median_filter_cube(data, size):
    """scipy.ndimage.median_filter semantics along the spectral axis
    (NaNs propagate, reflect boundary), the reference's
    ``spectral_smooth_median`` (spectral_cube.py:3186).  The ``size``
    shifted copies are stacked and sorted a tile of whole spectra at a
    time (:func:`~.reductions.lane_tiles`, the stack's voxels counted),
    each spectrum's median the whole stack's bit for bit."""
    size = int(size)
    tiles = list(_red.lane_tiles(data.shape, (0,), weight=size))
    if len(tiles) == 1:
        return _median0(_sliding_stack(data, size, axis=0))
    out = None
    for idx in tiles:
        med = _median0(_sliding_stack(data[idx], size, axis=0))
        if out is None:
            out = torch.empty(data.shape, dtype=med.dtype, device=med.device)
        out[idx] = med
    return out


def spatial_median_filter_cube(data, size):
    """Per-channel 2-D median filter, ``size`` an int or (ky, kx)."""
    if np.isscalar(size):
        ky = kx = int(size)
    else:
        ky, kx = (int(s) for s in size)
    stack = _sliding_stack(data, ky, axis=1)
    stack = _sliding_stack(stack, kx, axis=3)
    return _median0(stack.reshape((ky * kx,) + tuple(data.shape)))


@takes_numpy
@spanned("sct.smoothing.sigma_clip")
def sigma_clip_spectrally(data, sigma=3.0, maxiters=5, cenfunc="median",
                          stdfunc="std"):
    """Iterative per-spaxel sigma clipping along the spectral axis,
    astropy.stats.sigma_clip semantics (cenfunc=median|mean,
    stdfunc=std|mad_std; clipped values -> NaN); the reference workload
    at docs/dask.rst:188-212 and spectral_cube.py:3161.

    float32 data with stdfunc='std' goes through kernel 4 (its plain
    version on the CPU); mad_std and float64 run the sorted-band plain
    version on every device, as in the JAX package.  A tensor gives a
    tensor on its device, numpy data a numpy result
    (:func:`~..utils.takes_numpy`)."""
    if cenfunc in ("median", np.median, np.nanmedian):
        use_mean_center = False
    elif cenfunc in ("mean", np.mean, np.nanmean):
        use_mean_center = True
    else:
        raise NotImplementedError(
            "the sorted-band sigma-clip implements cenfunc='median' and "
            f"'mean' only (got {cenfunc!r})")
    if stdfunc in ("std", np.std, np.nanstd):
        use_mad_std = False
    elif stdfunc == "mad_std":
        use_mad_std = True
    else:
        raise NotImplementedError(
            "the sorted-band sigma-clip implements stdfunc='std' and "
            f"'mad_std' only (got {stdfunc!r})")
    if data.dtype == torch.float32 and not use_mad_std:
        return _clip.sigma_clip(data.contiguous(), sigma, maxiters,
                                use_mean_center)
    return _clip.sigma_clip_plain(data, sigma, maxiters, use_mean_center,
                                  use_mad_std)
