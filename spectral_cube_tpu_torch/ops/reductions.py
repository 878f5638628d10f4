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

__all__ = ["finite", "valid_mask", "masked_sum", "masked_mean", "masked_std",
           "masked_max", "masked_min", "masked_argmax", "masked_argmin",
           "masked_median", "masked_percentile",
           "masked_mad_std", "masked_statistics", "MAD_STD_FACTOR"]

NAN = float("nan")


def finite(x):
    """``torch.isfinite(x)`` without its whole-array float temporary
    (torch forms ``|x|`` to compare it with inf, a copy of the cube): for
    a float tensor the two comparisons ``-inf < x < inf``, which NaN
    fails, each a bool array."""
    if not x.dtype.is_floating_point:
        return torch.isfinite(x)
    return (x < math.inf).logical_and_(x > -math.inf)


def valid_mask(data, include=None):
    """Combined predicate: included and finite."""
    ok = finite(data)
    if include is None:
        return ok
    if include.shape == ok.shape:
        return ok.logical_and_(include)
    return torch.logical_and(ok, include)


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


#: elements of a whole-array float32 sum taken to float64 at once
SUM_CHUNK = 1 << 24


def _sum(x, axis):
    """The sum over ``axis``.  Over the whole array (``axis=None``) a
    float32 sum is accumulated in float64, ``SUM_CHUNK`` elements at a
    time, and rounded once: a device's tree of float32 partial sums can
    land an ulp off the rounded sum, which the JAX tests' tolerances
    (rel 1e-7 on a cube's sum) do not allow."""
    if axis is not None:
        return x.sum(axis)
    if x.dtype != torch.float32:
        return x.sum()
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for chunk in x.reshape(-1).split(SUM_CHUNK):
        total += chunk.double().sum()
    return total.to(x.dtype)


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
    ``axis=None`` (:func:`_whole_percentile`), else each lane with
    excluded values set to NaN (sorted last), and interpolates between the
    two bracketing order statistics at position ``q/100 * (n - 1)``,
    computed in float64."""
    data, valid, axis = _merge_axes(data, valid, axis)
    q = float(q)
    if axis is None:
        return _whole_percentile(data, valid, q)
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
    used by reference spectral_cube.py:719-767).  Over the whole array the
    deviations are formed from each piece's included values as the
    piece is sorted, never as a whole-array temporary."""
    data, valid, axis = _merge_axes(data, valid, axis)
    if axis is None:
        med = _whole_percentile(data, valid, 50.0)
        return MAD_STD_FACTOR * _whole_percentile(
            data, valid, 50.0, lambda v: torch.abs(v - med))
    med = masked_median(data, valid, axis=axis)
    dev = torch.abs(data - med.unsqueeze(axis))
    return MAD_STD_FACTOR * masked_median(dev, valid, axis=axis)


# ---------------------------------------------------------------------------
# whole-array order statistics: exact at any size
# ---------------------------------------------------------------------------
#: the most values a whole-array order statistic sorts, or picks by a
#: boolean index, at once: an array of up to this many voxels is sorted
#: whole.  A sort of n float32 values holds about 36 bytes a value at its
#: peak (the picked values, their copy, the sorted values, int64 indices
#: and the sort's own double buffers), so the one sort of 2**29 values
#: stays under 19 GiB, and a 1-D sort or boolean index far from the
#: 2**31 - 1 elements where device libraries count in 32 bits.
SORT_CHUNK = 1 << 29
#: the voxels a piece holds past :data:`SORT_CHUNK` (at most that many):
#: a piece's sort of 2**27 values, near 5 GiB, and the keys that outlive
#: it keep a cube's order statistic within two cube bytes of its data
SORT_PIECE = 1 << 27


def _pieces(x, size=None):
    """Views of ``x`` in order along its leading axes: ``x`` itself up to
    :data:`SORT_CHUNK` elements, else pieces of at most ``size``
    (:data:`SORT_PIECE`, or :data:`SORT_CHUNK` where that is smaller)
    elements: whole leading-axis slabs where one row fits, else each row
    cut the same way."""
    if size is None:
        if x.numel() <= SORT_CHUNK:
            yield x
            return
        size = min(SORT_PIECE, SORT_CHUNK)
    if x.numel() <= size or x.ndim == 0:
        yield x
    elif x.ndim == 1:
        yield from x.split(size)
    elif x[0].numel() <= size:
        yield from x.split(max(1, size // x[0].numel()))
    else:
        for row in x:
            yield from _pieces(row, size)


def _pick(data, valid, fn=None):
    """``data[valid]`` (``fn`` of it), read as flat views where both are
    contiguous: the boolean index then builds one int64 index a value,
    not one a dimension."""
    if data.is_contiguous() and valid.is_contiguous():
        vals = data.view(-1)[valid.view(-1)]
    else:
        vals = data[valid]
    return vals if fn is None else fn(vals)


def _whole_percentile(data, valid, q, fn=None):
    """The ``q``-th percentile of ``fn`` of the included finite values of
    ``data`` (``masked_percentile(axis=None)``).  Up to
    :data:`SORT_CHUNK` voxels, one sort of the values; past it, each
    piece of :func:`_pieces` is picked and sorted on its own, and each
    order statistic is found by bisecting the pieces' ordered bit
    patterns (:func:`_percentile_of`), which gives the one sort's value
    bit for bit.  ``valid`` broadcasts against ``data``."""
    valid = valid.expand_as(data)
    if data.numel() <= SORT_CHUNK:
        vals = _pick(data, valid, fn)
        n = vals.numel()
        if n == 0:
            return torch.tensor(NAN, dtype=vals.dtype, device=data.device)
        s = torch.sort(vals).values
        pos = q / 100.0 * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        return _lerp_sorted(s[lo], s[hi], pos - lo)
    keys, dtype = _piece_keys(data, valid, fn)
    n = sum(k.numel() for k in keys)
    if n == 0:
        return torch.tensor(NAN, dtype=dtype, device=data.device)
    return _percentile_of(keys, n, q, dtype)


def _piece_keys(data, valid, fn=None):
    """The sorted keys (:func:`_sorted_keys`) of ``fn`` of the included
    finite values of each piece of ``data`` (:func:`_pieces`), one tensor
    a piece, and the values' dtype: only the keys outlive a piece.
    ``valid`` broadcasts against ``data``."""
    keys, dtype = [], data.dtype
    valid = valid.expand_as(data)
    for d, v in zip(_pieces(data), _pieces(valid)):
        vals = _pick(d, v, fn)
        dtype = vals.dtype
        keys.append(_sorted_keys(vals))
        del vals
    return keys, dtype


#: the integer type whose bits a float of each width is read as
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _keys_of(s):
    """Integer keys of the values ``s`` that order as the values do: a
    float's bits (16-bit floats widened to int32, which every searchsorted
    takes), its negative half reversed (``i ^ max`` where ``i < 0``); an
    integer type's values as int64.  NaN, positive as the fills of this
    module make it, keys above every finite value."""
    if not s.dtype.is_floating_point:
        return s.to(torch.int64)
    bits = _BITS[s.element_size()]
    i = s.view(bits)
    i = torch.where(i < 0, i ^ torch.iinfo(bits).max, i)
    return i.to(torch.int32) if s.element_size() < 4 else i


def _values_of(k, dtype):
    """The values of ``dtype`` whose keys (:func:`_keys_of`) are the
    integer tensor ``k``."""
    if not dtype.is_floating_point:
        return k.to(dtype)
    bits = _BITS[torch.empty((), dtype=dtype).element_size()]
    i = k.to(bits)
    return torch.where(i < 0, i ^ torch.iinfo(bits).max, i).view(dtype)


def _sorted_keys(x):
    """The keys of the values ``x``, ascending: the values sorted (-0.0
    taken as +0.0, an equal value the keys must not split), then keyed."""
    return _keys_of(torch.sort(x + 0).values)


def _count_le(keys, k):
    """How many of the sorted ``keys`` (1-D tensors, each on its own
    device) are <= ``k`` (a 0-d int64 tensor): a search in each, summed
    on the first keys' device into a 0-d tensor, with no wait on a
    device."""
    dev = keys[0].device
    query = {}
    counts = []
    for kk in keys:
        if kk.device not in query:
            query[kk.device] = k.to(kk.device, kk.dtype).reshape(1)
        counts.append(torch.searchsorted(kk, query[kk.device],
                                         right=True)[0].to(dev))
    return torch.stack(counts).sum()


def _select(keys, k):
    """The ``k``-th smallest (0-based) of the sorted ``keys``, a 0-d int64
    tensor on the first keys' device: a bisection over the key range, as
    many steps as the range's width has bits, each a count of the keys
    <= the middle queued on the device (one wait, for the range)."""
    dev = keys[0].device
    ends = torch.stack([torch.stack([kk[0], kk[-1]]).to(dev, torch.int64)
                        for kk in keys if kk.numel()])
    lo, hi = ends[:, 0].min(), ends[:, 1].max()
    lo_h, hi_h = torch.stack([lo, hi]).tolist()
    for _ in range((hi_h - lo_h).bit_length()):
        # floor((lo + hi) / 2), with no overflow over the int64 keys
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        up = _count_le(keys, mid) >= k + 1
        hi = torch.where(up, mid, hi)
        lo = torch.where(up, lo, mid + 1)
    return lo


def _percentile_of(keys, n, q, dtype):
    """:func:`_whole_percentile`'s value (the two bracketing order
    statistics at q/100 * (n - 1), lerped as the one sort does) of the
    ``n`` sorted ``keys``, values of ``dtype``: a 0-d tensor on the first
    keys' device."""
    pos = q / 100.0 * (n - 1)
    lo_i = int(math.floor(pos))
    hi_i = min(lo_i + 1, n - 1)
    k_lo = k_hi = _select(keys, lo_i)
    if hi_i != lo_i:
        # where the lower key has no twin at hi_i, the next larger key in
        # any piece
        dev = keys[0].device
        nxt = []
        for kk in keys:
            if kk.numel():
                j = torch.searchsorted(kk, k_lo.to(kk.device, kk.dtype)
                                       .reshape(1), right=True)[0]
                nxt.append(torch.where(
                    j < kk.numel(), kk[j.clamp(max=kk.numel() - 1)].to(
                        torch.int64), torch.iinfo(torch.int64).max).to(dev))
        k_hi = torch.where(_count_le(keys, k_lo) >= hi_i + 1, k_lo,
                           torch.stack(nxt).min())
    lo_v, hi_v = _values_of(torch.stack([k_lo, k_hi]), dtype)
    return _lerp_sorted(lo_v, hi_v, pos - lo_i)


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
