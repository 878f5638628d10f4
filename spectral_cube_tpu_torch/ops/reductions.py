"""Masked reductions with the reference's NaN semantics, over torch tensors.

Port of ``spectral_cube_tpu/ops/reductions.py``.  Every function takes the
combined validity mask explicitly (``valid = include & isfinite(data)``).
The critical semantic is ``allbadtonan`` (reference ``np_compat.py:3-27``):
positions where no included finite value exists along the reduced axis
yield NaN.  ``axis=None`` reduces over the whole cube, and a tuple
``axis`` over those axes together (:func:`_merge_axes`).
"""

from __future__ import annotations

import math

import torch

__all__ = ["valid_mask", "masked_sum", "masked_mean", "masked_std",
           "masked_max", "masked_min", "masked_argmax", "masked_argmin",
           "masked_median", "masked_percentile",
           "masked_mad_std", "masked_statistics", "MAD_STD_FACTOR"]

NAN = float("nan")


def valid_mask(data, include=None):
    """Combined predicate: included and finite."""
    finite = torch.isfinite(data)
    if include is None:
        return finite
    return torch.logical_and(finite, include)


def _fill(data, valid, fill):
    return torch.where(valid, data, torch.as_tensor(fill, dtype=data.dtype,
                                                    device=data.device))


def _merge_axes(data, valid, axis):
    """``(data, valid, axis)`` with a tuple ``axis`` turned into one: the
    reduced axes moved last, in order, and flattened into axis -1 (the
    kept axes stay in order in front), as ``jnp`` reduces a tuple of axes
    in the JAX package.  Any other ``axis`` passes through."""
    if not isinstance(axis, (tuple, list)):
        return data, valid, axis
    axes = sorted(int(a) % data.ndim for a in axis)
    keep = [i for i in range(data.ndim) if i not in axes]
    shape = [data.shape[i] for i in keep] + [-1]

    def merge(x):
        return x.expand(data.shape).permute(keep + axes).reshape(shape)
    return merge(data), merge(valid), -1


def _sum(x, axis):
    return x.sum() if axis is None else x.sum(axis)


def _count(valid, axis):
    return valid.sum() if axis is None else valid.sum(axis)


def masked_sum(data, valid, axis=None):
    """nansum with allbadtonan: all-invalid positions -> NaN."""
    data, valid, axis = _merge_axes(data, valid, axis)
    s = _sum(_fill(data, valid, 0), axis)
    return torch.where(_count(valid, axis) > 0, s, NAN)


def masked_mean(data, valid, axis=None):
    data, valid, axis = _merge_axes(data, valid, axis)
    s = _sum(_fill(data, valid, 0), axis)
    cnt = _count(valid, axis).to(data.dtype)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), NAN)


def masked_std(data, valid, axis=None, ddof=0):
    """nanstd, two-pass form (numpy nanstd numerics)."""
    data, valid, axis = _merge_axes(data, valid, axis)
    cnt = _count(valid, axis).to(data.dtype)
    mean = _sum(_fill(data, valid, 0), axis) / torch.clamp(cnt, min=1)
    mean_b = mean if axis is None else mean.unsqueeze(axis)
    dev = _fill((data - mean_b) ** 2, valid, 0)
    var = _sum(dev, axis) / torch.clamp(cnt - ddof, min=1)
    return torch.where(cnt > ddof, torch.sqrt(var), NAN)


def masked_max(data, valid, axis=None):
    data, valid, axis = _merge_axes(data, valid, axis)
    filled = _fill(data, valid, -math.inf)
    m = filled.max() if axis is None else filled.amax(axis)
    return torch.where(_count(valid, axis) > 0, m, NAN)


def masked_min(data, valid, axis=None):
    data, valid, axis = _merge_axes(data, valid, axis)
    filled = _fill(data, valid, math.inf)
    m = filled.min() if axis is None else filled.amin(axis)
    return torch.where(_count(valid, axis) > 0, m, NAN)


def masked_argmax(data, valid, axis=0):
    """nanargmax with invalid values filled with -inf (reference
    spectral_cube.py:771-795): ties break to the first index, as
    ``torch.argmax`` documents on every device, and a position with no
    valid value along ``axis`` gives 0."""
    return torch.argmax(_fill(data, valid, -math.inf), dim=axis)


def masked_argmin(data, valid, axis=0):
    return torch.argmin(_fill(data, valid, math.inf), dim=axis)


def _lerp_sorted(lo_v, hi_v, frac):
    # jnp.nanpercentile's linear interpolation form
    return lo_v * (1.0 - frac) + hi_v * frac


def masked_percentile(data, valid, q, axis=None):
    """nanpercentile over the masked data (linear interpolation).

    ``torch.nanquantile`` refuses inputs above 2**24 elements, far below a
    real cube, so this sorts instead: the included finite values for
    ``axis=None``, else each lane with excluded values set to NaN (sorted
    last), and interpolates between the two bracketing order statistics
    at position ``q/100 * (n - 1)``, computed in float64."""
    data, valid, axis = _merge_axes(data, valid, axis)
    q = float(q)
    if axis is None:
        vals = data[valid]
        n = vals.numel()
        if n == 0:
            return torch.tensor(NAN, dtype=data.dtype, device=data.device)
        s = torch.sort(vals).values
        pos = q / 100.0 * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        return _lerp_sorted(s[lo], s[hi], pos - lo)
    s = torch.sort(_fill(data, valid, NAN), dim=axis).values
    n = _count(valid, axis).unsqueeze(axis)
    pos = q / 100.0 * (n - 1).to(torch.float64)
    lo = torch.clamp(torch.floor(pos), min=0)
    frac = (pos - lo).to(data.dtype)
    lo = lo.to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(n - 1, min=0))
    out = _lerp_sorted(torch.gather(s, axis, lo), torch.gather(s, axis, hi),
                       frac)
    return torch.where(n > 0, out, NAN).squeeze(axis)


def masked_median(data, valid, axis=None):
    return masked_percentile(data, valid, 50.0, axis=axis)


MAD_STD_FACTOR = 1.482602218505602  # 1/Phi^-1(3/4), astropy.stats.mad_std


def masked_mad_std(data, valid, axis=None):
    """Median-absolute-deviation std estimate (astropy mad_std semantics,
    used by reference spectral_cube.py:719-767)."""
    data, valid, axis = _merge_axes(data, valid, axis)
    med = masked_median(data, valid, axis=axis)
    med_b = med if axis is None else med.unsqueeze(axis)
    dev = torch.abs(data - med_b)
    return MAD_STD_FACTOR * masked_median(dev, valid, axis=axis)


def masked_statistics(data, valid):
    """Global statistics, CASA ia.statistics naming (reference
    ``dask_spectral_cube.py:769-814``), with sigma from a second,
    mean-centered pass (the one-pass form cancels in float32)."""
    cnt = valid.sum()
    s = _fill(data, valid, 0).sum()
    ss = _fill(data * data, valid, 0).sum()
    mn = _fill(data, valid, math.inf).min()
    mx = _fill(data, valid, -math.inf).max()
    npts = cnt.to(data.dtype)
    mean = torch.where(cnt > 0, s / torch.clamp(npts, min=1), NAN)
    mean_safe = torch.where(cnt > 0, mean, 0.0)
    dev = _fill(data - mean_safe, valid, 0)
    s2c = (dev * dev).sum()
    sigma = torch.where(cnt > 1, torch.sqrt(s2c / torch.clamp(npts - 1,
                                                               min=1)), NAN)
    rms = torch.where(cnt > 0, torch.sqrt(ss / torch.clamp(npts, min=1)), NAN)
    some = cnt > 0
    return {"npts": cnt, "min": torch.where(some, mn, NAN),
            "max": torch.where(some, mx, NAN),
            "sum": torch.where(some, s, NAN),
            "sumsq": torch.where(some, ss, NAN), "mean": mean,
            "sigma": sigma, "rms": rms}
