"""Normalised convolution with astropy ``convolve``'s semantics: zero-fill
boundary, a unit-sum kernel, NaN interpolated over (the numerator
conv(where(finite, x, 0)) over the denominator 1 - conv(~finite), NaN where
that is at most :data:`DEN_FLOOR`), a plane or spectrum with no finite
value NaN.  Plain shifted-slice sums in float32, one tap at a time, with the
operands rounded as ``arith`` says."""

from __future__ import annotations

import numpy as np
import torch

from .numerics import IEEE

#: the denominator floor of the normalised convolution (astropy's and the
#: spectral-cube reference's ``nan_treatment='interpolate'`` threshold)
DEN_FLOOR = 1e-6


def _taps_1d(x, taps, dim, arith):
    """Correlation of ``x`` along ``dim`` with ``taps`` (float64 numpy,
    odd length) centred at (len - 1) // 2, zero outside."""
    n = x.shape[dim]
    length = len(taps)
    h = (length - 1) // 2
    pad = [0, 0] * (x.ndim - 1 - dim) + [h, length - 1 - h]
    xp = torch.nn.functional.pad(arith(x), pad)
    t = arith(torch.as_tensor(np.asarray(taps), dtype=torch.float32))
    acc = torch.zeros_like(x)
    for o in range(length):
        acc.add_(xp.narrow(dim, o, n), alpha=float(t[o]))
    return acc


def _flipped(kern):
    """A convolution is the correlation with the kernel flipped."""
    return np.ascontiguousarray(np.asarray(kern, np.float64)[::-1, ::-1])


def conv2d_planes(x, ytaps, xtaps, arith=IEEE):
    """sum_i of the y taps then the x taps of pair i over each plane of
    (c, ny, nx) ``x`` (correlation; see :func:`_flipped`)."""
    acc = None
    for yt, xt in zip(ytaps, xtaps):
        term = _taps_1d(_taps_1d(x, yt, 1, arith), xt, 2, arith)
        acc = term if acc is None else acc.add_(term)
    return acc


def normalized_conv2d(x, pairs, arith=IEEE):
    """(value, den) of the normalised convolution of (c, ny, nx) float32
    planes by the kernel whose flipped form is ``pairs`` = (ytaps,
    xtaps)."""
    valid = torch.isfinite(x)
    both = torch.cat([torch.where(valid, x, 0.0),
                      (~valid).to(torch.float32)])
    conv = conv2d_planes(both, *pairs, arith=arith)
    c = x.shape[0]
    num, den = conv[:c], conv[c:].neg_().add_(1.0)
    ok = den > DEN_FLOOR
    out = torch.where(ok, num / torch.where(ok, den, 1.0), float("nan"))
    out = torch.where(valid.flatten(1).any(1)[:, None, None], out,
                      float("nan"))
    return out, den


def separable_pairs(kern, separable):
    """The flipped kernel's tap pairs."""
    return separable(_flipped(kern))


def normalized_conv_axis0(x, taps, arith=IEEE):
    """The normalised convolution of (n, ...) float32 ``x`` along axis 0
    with 1-D ``taps`` (float64, odd length, unit sum)."""
    t = np.ascontiguousarray(np.asarray(taps, np.float64)[::-1])
    valid = torch.isfinite(x)
    num = _taps_1d(torch.where(valid, x, 0.0), t, 0, arith)
    den = _taps_1d((~valid).to(torch.float32), t, 0, arith).neg_().add_(1.0)
    ok = den > DEN_FLOOR
    out = torch.where(ok, num / torch.where(ok, den, 1.0), float("nan"))
    return torch.where(valid.any(0, keepdim=True), out, float("nan"))
