"""Masked moments 0/1/2 and one-pass global statistics.

Port of ``spectral_cube_tpu/ops/moments.py``.  Reference math:
``spectral_cube/_moments.py:170-193`` (cubewise) with ``allbadtonan`` NaN
semantics; the moment-1 world offset is added by the caller.  Two forms:

- :func:`moments_012`, the plain single-expression form (any dtype);
- :func:`moments_012_kernel`, the counterpart of the TPU's
  ``moments_012_pallas``: kernel 1 (``kernels/moments.py``) writes
  compensated-pair sufficient planes in one pass over the cube, with the
  mask predicate fused where it can be, and :func:`_finalize_pairs` /
  :func:`_recombine_statistics` finish at plane level.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..masks import fused_predicate
from ..kernels.moments import moments_planes
from .df32 import df_sub, df_mul, df_div, df_collapse

__all__ = ["moments_012", "moments_012_kernel", "statistics_kernel",
           "statistics_planes", "moment_generic", "SIGMA2FWHM"]

SIGMA2FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))
NAN = float("nan")


def _center(coords):
    coords = np.asarray(coords, dtype=np.float64)
    xbar = float(coords.mean()) if coords.size else 0.0
    return coords - xbar, xbar


def _moment_stats(w, valid, xc):
    """Sufficient statistics with two-pass numerics: the centroid estimate
    first, then the residual mean and the second moment about it."""
    s0 = w.sum(0)
    s1 = (w * xc).sum(0)
    cnt = valid.sum(0)
    safe_s0 = torch.where(s0 == 0, 1.0, s0)
    m1_est = s1 / safe_s0
    d = xc - m1_est[None]
    r1 = (w * d).sum(0) / safe_s0
    s2c = (w * (d * d)).sum(0)
    return s0, m1_est, r1, s2c, cnt


def _finalize(s0, m1_est, r1, s2c, cnt, xbar, dx):
    valid = cnt > 0
    mom0 = torch.where(valid, s0 * dx, NAN)
    mom1 = torch.where(valid, xbar + m1_est + r1, NAN)
    safe_s0 = torch.where(s0 == 0, 1.0, s0)
    mom2 = torch.where(valid, s2c / safe_s0 - r1 * r1, NAN)
    return mom0, mom1, mom2


def moments_012(data, coords, dx, include=None):
    """Masked moments 0/1/2 along axis 0 in one plain expression.

    ``coords``: (nchan,) spectral coordinate of each channel relative to
    channel 0; ``dx``: the channel width; ``include``: optional bool
    tensor broadcastable to ``data``.  Accumulates in float32."""
    f32 = torch.float32
    coords_c, xbar = _center(coords)
    xc = torch.as_tensor(coords_c, dtype=f32, device=data.device)[:, None,
                                                                   None]
    valid = torch.isfinite(data)
    if include is not None:
        valid = torch.logical_and(valid, include)
    w = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                             device=data.device)).to(f32)
    out_dtype = data.dtype if data.is_floating_point() else f32
    m0, m1, m2 = _finalize(*_moment_stats(w, valid, xc), xbar, dx)
    return m0.to(out_dtype), m1.to(out_dtype), m2.to(out_dtype)


def _kernel_inputs(data, mask_expr, include):
    """(cmp_op, threshold, include) for kernel 1: a fusable mask goes in as
    the op code; any other mask is evaluated and joins ``include``, which
    the kernel reads as a uint8 array (moments.py:196-198, 255-258)."""
    fused = fused_predicate(mask_expr)
    if fused is None:
        extra = mask_expr.include(data=data)
        include = extra if include is None \
            else torch.logical_and(include, extra)
        fused = (0, 0.0)
    if include is not None:
        include = include.to(data.device).expand(data.shape)
    return fused[0], fused[1], include


def moments_012_kernel(data, coords, dx, mask_expr=None, include=None,
                       with_stats=False):
    """Masked moments through kernel 1 (one pass over the cube).

    ``mask_expr``: a mask evaluated with the data (fused in the kernel
    when :func:`~..masks.fused_predicate` allows); ``include``: an
    explicit bool tensor.  ``with_stats=True`` also returns the global
    statistics dict of the included voxels, from the same pass."""
    coords_c, xbar = _center(coords)
    op, thr, inc = _kernel_inputs(data, mask_expr, include)
    planes, cnt = moments_planes(data, coords_c, op, thr, inc, with_stats)
    out = finalize_planes(planes, cnt, xbar, dx, with_stats)
    moms = tuple(m.to(data.dtype) for m in out[:3])
    return moms + tuple(out[3:])


def finalize_planes(planes, cnt, xbar, dx, with_stats):
    """:func:`_finalize_pairs` of kernel 1's output ``(planes, count)``."""
    pairs = tuple(planes[:6])
    if with_stats:
        pairs += (planes[6], planes[7], cnt.to(torch.float32), planes[8],
                  planes[9])
    else:
        pairs += (cnt.to(torch.float32),)
    return _finalize_pairs(pairs, xbar, dx, with_stats)


def _finalize_pairs(planes, xbar, dx, with_stats):
    """Moments (and statistics) from the compensated-pair planes
    ``(s0h, s0l, s1h, s1l, s2h, s2l[, qh, ql], cntf[, mn, mx])``: the
    cancelling forms mom2 = S2/S0 - (S1/S0)^2 and d2 = Q - S0^2/n are
    evaluated in pair space (ops/df32)."""
    if with_stats:
        s0h, s0l, s1h, s1l, s2h, s2l, qh, ql, cntf, mn, mx = planes
    else:
        s0h, s0l, s1h, s1l, s2h, s2l, cntf = planes
    s0c = s0h + s0l
    deg = s0c == 0
    S0 = (torch.where(deg, 1.0, s0h), torch.where(deg, 0.0, s0l))
    q1 = df_div((s1h, s1l), S0)
    some = cntf > 0
    # dx and xbar rounded to float32 first, as the JAX path has them
    dx32, xbar32 = (torch.tensor(v, dtype=torch.float32, device=s0h.device)
                    for v in (dx, xbar))
    mom0 = torch.where(some, s0c * dx32, NAN)
    mom1 = torch.where(some, xbar32 + df_collapse(q1), NAN)
    # one included channel: the second moment about its own centroid is 0,
    # as moments_012_pallas gives it; the pair form leaves ~1e-14 of
    # either sign there, whose square root would be NaN
    mom2 = torch.where(
        some, df_collapse(df_sub(df_div((s2h, s2l), S0), df_mul(q1, q1))),
        NAN)
    mom2 = torch.where(cntf == 1, 0.0, mom2)
    if not with_stats:
        return mom0, mom1, mom2
    stats = _recombine_statistics(s0c, cntf.to(torch.int32), mn, mx,
                                  _d2_plane(s0h, s0l, qh, ql, cntf))
    return mom0, mom1, mom2, stats


def _d2_plane(s0h, s0l, qh, ql, cntf):
    """Per-spaxel sum of squared deviations from the spaxel's mean,
    d2 = Q - S0^2/n in pair space, 0 where nothing is included."""
    ns = torch.clamp(cntf, min=1.0)
    d2 = df_collapse(df_sub((qh, ql), df_div(df_mul((s0h, s0l), (s0h, s0l)),
                                             (ns, torch.zeros_like(s0h)))))
    return torch.where(cntf > 0, torch.clamp(d2, min=0.0), 0.0)


def statistics_planes(planes, cnt):
    """``(s0, cnt, min, max, d2)``, the per-spaxel planes of kernel 1's
    ``with_stats`` output ``(planes, cnt)`` that :func:`_recombine_statistics`
    reduces: the included sum, count, extremes and squared deviations
    (the sharded statistics reduce them over a mesh)."""
    cntf = cnt.to(torch.float32)
    return (planes[0] + planes[1], cnt, planes[8], planes[9],
            _d2_plane(planes[0], planes[1], planes[6], planes[7], cntf))


def _recombine_statistics(s0, cnt, mn_p, mx_p, d2_p):
    """Global statistics from per-spaxel sufficient planes by the law of
    total variance, s2c = sum d2_i + sum n_i (m_i - M)^2, with a pilot
    mean so a DC offset does not corrupt the cross term; the
    sum-of-squares plane is d2_i + n_i m_i^2.  Keys and the npts in
    {0, 1} semantics of reductions.masked_statistics."""
    cntf = cnt.to(torch.float32)
    npts = cntf.sum()
    s = s0.sum()
    m_i = s0 / torch.clamp(cntf, min=1)
    ss_p = d2_p + cntf * (m_i * m_i)
    has = cnt > 0
    pilot = torch.where(has, m_i, 0.0).sum() \
        / torch.clamp(has.to(torch.float32).sum(), min=1)
    mean_acc = pilot + (cntf * (m_i - pilot)).sum() / torch.clamp(npts,
                                                                  min=1)
    mean = torch.where(npts > 0, mean_acc, NAN)
    s2c = d2_p.sum() \
        + (cntf * (m_i - torch.where(npts > 0, mean_acc, 0.0)) ** 2).sum()
    sigma = torch.where(npts > 1,
                        torch.sqrt(s2c / torch.clamp(npts - 1, min=1)), NAN)
    ss = ss_p.sum()
    rms = torch.where(npts > 0, torch.sqrt(ss / torch.clamp(npts, min=1)),
                      NAN)
    mn = torch.where(has, mn_p, math.inf).min()
    mx = torch.where(has, mx_p, -math.inf).max()
    some = npts > 0
    return {"npts": cnt.sum(),
            "min": torch.where(some, mn, NAN),
            "max": torch.where(some, mx, NAN),
            "sum": torch.where(some, s, NAN),
            "sumsq": torch.where(some, ss, NAN),
            "mean": mean, "sigma": sigma, "rms": rms}


def statistics_kernel(data, include=None, mask_expr=None):
    """Global statistics in one pass through kernel 1's ``with_stats``
    planes (all-zero coordinates; the moment planes are discarded)
    (reference semantics: CASA-style ``statistics()``,
    dask_spectral_cube.py:769-814)."""
    return moments_012_kernel(data, np.zeros(data.shape[0]), 1.0,
                              mask_expr=mask_expr, include=include,
                              with_stats=True)[3]


def moment_generic(data, coords, dx, order, axis=0, include=None):
    """General moment of any order along ``axis`` (reference
    ``_moments.py:170-193``): order 0 is the integral, order 1 the
    centroid, order N >= 2 the central moment about the centroid."""
    ftype = data.dtype if data.is_floating_point() else torch.float32
    coords = torch.as_tensor(np.asarray(coords), dtype=ftype,
                             device=data.device)
    if coords.ndim == 1:
        shape = [1] * data.ndim
        shape[axis] = -1
        x = coords.reshape(shape)
    else:
        x = coords if coords.ndim == data.ndim else coords[None]
    valid = torch.isfinite(data)
    if include is not None:
        valid = torch.logical_and(valid, include)
    w = torch.where(valid, data, 0.0) * dx
    cnt = valid.sum(axis)
    s0 = w.sum(axis)
    if order == 0:
        return torch.where(cnt > 0, s0, NAN)
    mom1 = (w * x).sum(axis) / s0
    if order == 1:
        return torch.where(cnt > 0, mom1, NAN)
    sN = (w * (x - mom1.unsqueeze(axis)) ** order).sum(axis)
    return torch.where(cnt > 0, sN / s0, NAN)
