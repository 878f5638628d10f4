"""Masked reductions with the reference's NaN semantics, over torch tensors.

Port of ``spectral_cube_tpu/ops/reductions.py``.  Every function takes the
combined validity mask explicitly (``valid = include & isfinite(data)``).
The critical semantic is ``allbadtonan`` (reference ``np_compat.py:3-27``):
positions where no included finite value exists along the reduced axis
yield NaN.  ``axis=None`` reduces over the whole cube, and a tuple
``axis`` over those axes together.  No reduction holds a cube-sized
temporary past :data:`SORT_CHUNK` voxels: every piece is a tile of
:func:`lane_tiles`, a whole-cube reduction's tiles of no reduced axis
(:func:`_pieces`; order statistics: sorted pieces whose keys are
bisected), one along an axis its tiles of whole lanes, each lane's result
the one call's bit for bit; a whole-cube sum fills and reduces flat
:data:`SUM_CHUNK` ranges, in the order of one sum.
"""

from __future__ import annotations

import math

import torch

from ..profiling import spanned

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


# ---------------------------------------------------------------------------
# the pieces a reduction runs on
# ---------------------------------------------------------------------------
#: elements of a whole-array sum filled and reduced at once (a float32
#: sum takes each to float64)
SUM_CHUNK = 1 << 24


def _flat_range(x, a, b):
    """Elements ``a:b`` of ``x`` in its logical (row-major) order: a view
    where ``x`` is contiguous, else a copy of those elements alone."""
    if x.is_contiguous():
        return x.view(-1)[a:b]
    if x.ndim <= 1:
        return x.reshape(-1)[a:b]
    row = x[0].numel()
    ra, rb = a // row, (b - 1) // row
    if ra == rb:
        return _flat_range(x[ra], a - ra * row, b - ra * row)
    parts = [_flat_range(x[ra], a - ra * row, row)]
    if rb > ra + 1:
        parts.append(x[ra + 1:rb].reshape(-1))
    parts.append(_flat_range(x[rb], 0, b - rb * row))
    return torch.cat(parts)


def _whole_pieces(data, valid):
    """``(offset, data piece, valid piece)`` of the flat ranges of
    :data:`SUM_CHUNK` elements of ``data`` in order, the ranges a
    whole-array sum accumulates; ``valid`` broadcasts against it."""
    valid = valid.expand(data.shape)
    n = data.numel()
    for a in range(0, n, SUM_CHUNK):
        b = min(a + SUM_CHUNK, n)
        yield a, _flat_range(data, a, b), _flat_range(valid, a, b)


def _whole_sum(data, valid, fn=None):
    """The sum of ``fn`` of the included values of ``data`` (0 elsewhere),
    filled and reduced a :data:`SUM_CHUNK` piece at a time, and the count
    of included values.  A floating sum is accumulated in float64 and
    rounded once to the data's type (a float32 piece taken whole to
    float64, the order the whole array's sum had, so that a device's tree
    of float32 partial sums cannot land an ulp off the rounded sum, which
    the JAX tests' tolerances, rel 1e-7 on a cube's sum, do not allow); a
    float64 sum is rounded once a piece, within 1e-15 relative of one
    call over the whole."""
    total, cnt = _whole_total(data, valid, fn)
    return total.to(data.dtype), cnt


def _whole_total(data, valid, fn=None):
    """:func:`_whole_sum` before its rounding: the float64 sum (int64 for
    an integer type) and the count, 0-d tensors on the data's device (the
    sharded whole-cube sums add each shard's before they round)."""
    floating = data.dtype.is_floating_point
    total = torch.zeros((), dtype=torch.float64 if floating else torch.int64,
                        device=data.device)
    cnt = torch.zeros((), dtype=torch.int64, device=data.device)
    for _, d, v in _whole_pieces(data, valid):
        x = _fill(d if fn is None else fn(d), v, 0)
        total += x.double().sum() if floating else x.sum()
        cnt += v.sum()
    return total, cnt


def _whole_extremum(data, valid, fill, pick):
    """``pick`` (``torch.max`` / ``torch.min``) of the included values,
    ``fill`` elsewhere, over each piece (:func:`_pieces`) and then over
    the pieces' extremes; and the count of included values."""
    ext = [torch.tensor(fill, dtype=data.dtype, device=data.device)]
    cnt = torch.zeros((), dtype=torch.int64, device=data.device)
    valid = valid.expand(data.shape)
    for idx in lane_tiles(data.shape, ()) if data.numel() else ():
        v = valid[idx]
        ext.append(pick(_fill(data[idx], v, fill)))
        cnt += v.sum()
    return pick(torch.stack(ext)), cnt


def _whole_arg(data, valid, fill, pick):
    """The first flat index (0-d int64) of ``pick``'s extremum (argmax /
    argmin) of the included values, ``fill`` elsewhere: each piece's
    (:func:`_pieces`, runs of the flat order) first extreme index and
    value, then the first piece that holds the extreme value (ties break
    to the first index, as ``torch.argmax`` documents)."""
    if not data.numel():
        return torch.zeros((), dtype=torch.int64, device=data.device)
    vals, idx = [], []
    valid = valid.expand(data.shape)
    a = 0
    for tile in lane_tiles(data.shape, ()):
        f = _fill(data[tile], valid[tile], fill)
        i = pick(f)
        # a copy of the value: indexing by a 0-d tensor would read the
        # index on the host and keep a view, and with it the piece, alive
        vals.append(f.take(i))
        idx.append(i + a)
        a += f.numel()
    return torch.stack(idx)[pick(torch.stack(vals))]


def lane_tiles(shape, axes, weight=1, size=None):
    """Index tuples (one slice an axis) that cut an array of ``shape``
    into tiles of whole lanes along ``axes``: the whole array while
    ``weight`` times its voxels are at most :data:`SORT_CHUNK`, else
    tiles of at most ``size`` (:data:`SORT_PIECE`, or :data:`SORT_CHUNK`
    where that is smaller) voxels times ``weight``, cut along the other
    axes in order: a run of indices of the first axis where one of its
    indices fits, else each index cut the same way along the next; a
    tile holds one lane at least.  ``size`` given: tiles of that size
    whatever the array's."""
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    axes = sorted({int(a) % nd for a in axes}) if nd else []
    idx = [slice(None)] * nd
    total = math.prod(shape) * weight
    if size is None:
        if total <= SORT_CHUNK:
            yield tuple(idx)
            return
        size = min(SORT_PIECE, SORT_CHUNK)
    if total <= size:
        yield tuple(idx)
        return
    keep = [i for i in range(nd) if i not in axes]
    lane = weight * math.prod(shape[a] for a in axes)

    def cut(j):
        if j == len(keep):
            yield tuple(idx)
            return
        a = keep[j]
        inner = lane * math.prod(shape[k] for k in keep[j + 1:])
        if inner * shape[a] <= size:
            yield tuple(idx)
        elif inner <= size or j == len(keep) - 1:
            step = max(1, size // inner)
            for s in range(0, shape[a], step):
                idx[a] = slice(s, min(s + step, shape[a]))
                yield tuple(idx)
            idx[a] = slice(None)
        else:
            for s in range(shape[a]):
                idx[a] = slice(s, s + 1)
                yield from cut(j + 1)
            idx[a] = slice(None)
    yield from cut(0)


def _merges_as_view(x, axes):
    """Whether the axes ``axes`` (ascending) of ``x`` merge into one as a
    view, once moved last."""
    dims = [a for a in axes if x.shape[a] != 1]
    return all(x.stride(a) == x.stride(b) * x.shape[b]
               for a, b in zip(dims, dims[1:]))


def _along(fn, data, valid, axis):
    """``fn(d, v, a)``, a reduction along the one axis ``a`` of its
    arguments, over ``axis`` (an int, or a tuple of axes reduced
    together: moved last, in order, and merged into axis -1, as ``jnp``
    reduces a tuple of axes in the JAX package).  Each lane is reduced on
    its own, so the array is cut into tiles of whole lanes
    (:func:`lane_tiles`) where one call would hold more than
    :data:`SORT_CHUNK` voxels, and a tuple whose merge is no view of the
    data is merged a tile of at most :data:`SORT_PIECE` voxels at a time,
    never as a copy of the cube.  ``valid`` broadcasts against ``data``."""
    valid = valid.expand(data.shape)
    if isinstance(axis, (tuple, list)):
        axes = sorted({int(a) % data.ndim for a in axis})
    else:
        axes = [int(axis) % data.ndim]
    keep = [i for i in range(data.ndim) if i not in axes]
    size = None
    if len(axes) > 1:
        if not (_merges_as_view(data, axes) and _merges_as_view(valid, axes)):
            size = min(SORT_PIECE, SORT_CHUNK)

        def merge(x):
            return x.permute(keep + axes).reshape(
                [x.shape[i] for i in keep] + [-1])
        ax = -1
    else:
        def merge(x):
            return x
        ax = axes[0]
    tiles = list(lane_tiles(data.shape, axes, size=size))
    if len(tiles) == 1:
        return fn(merge(data[tiles[0]]), merge(valid[tiles[0]]), ax)
    out = None
    for idx in tiles:
        r = fn(merge(data[idx]), merge(valid[idx]), ax)
        if out is None:
            out = torch.empty([data.shape[i] for i in keep], dtype=r.dtype,
                              device=r.device)
        out[tuple(idx[i] for i in keep)] = r
    return out


# ---------------------------------------------------------------------------
# the reductions
# ---------------------------------------------------------------------------
def _sum_axis(data, valid, axis):
    s = _fill(data, valid, 0).sum(axis)
    return torch.where(valid.sum(axis) > 0, s, NAN)


def _mean_axis(data, valid, axis):
    s = _fill(data, valid, 0).sum(axis)
    cnt = valid.sum(axis).to(data.dtype)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), NAN)


def _std_axis(data, valid, axis, ddof=0):
    cnt = valid.sum(axis).to(data.dtype)
    mean = _fill(data, valid, 0).sum(axis) / torch.clamp(cnt, min=1)
    # the squared deviations formed in one array (x * x is ``** 2``'s
    # value), zero where excluded
    dev = data - mean.unsqueeze(axis)
    dev.mul_(dev).masked_fill_(valid.logical_not(), 0)
    var = dev.sum(axis) / torch.clamp(cnt - ddof, min=1)
    return torch.where(cnt > ddof, torch.sqrt(var), NAN)


def _max_axis(data, valid, axis):
    m = _fill(data, valid, -math.inf).amax(axis)
    return torch.where(valid.sum(axis) > 0, m, NAN)


def _min_axis(data, valid, axis):
    m = _fill(data, valid, math.inf).amin(axis)
    return torch.where(valid.sum(axis) > 0, m, NAN)


def masked_sum(data, valid, axis=None):
    """nansum with allbadtonan: all-invalid positions -> NaN."""
    if axis is not None:
        return _along(_sum_axis, data, valid, axis)
    s, cnt = _whole_sum(data, valid)
    return torch.where(cnt > 0, s, NAN)


def masked_mean(data, valid, axis=None):
    if axis is not None:
        return _along(_mean_axis, data, valid, axis)
    s, cnt = _whole_sum(data, valid)
    cnt = cnt.to(data.dtype)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), NAN)


def masked_std(data, valid, axis=None, ddof=0):
    """nanstd, two-pass form (numpy nanstd numerics)."""
    if axis is not None:
        return _along(lambda d, v, a: _std_axis(d, v, a, ddof), data, valid,
                      axis)
    s, cnt = _whole_sum(data, valid)
    cnt = cnt.to(data.dtype)
    mean = s / torch.clamp(cnt, min=1)

    def square(d):
        dev = d - mean
        return dev.mul_(dev)
    var = _whole_sum(data, valid, square)[0] / torch.clamp(cnt - ddof,
                                                           min=1)
    return torch.where(cnt > ddof, torch.sqrt(var), NAN)


def masked_max(data, valid, axis=None):
    if axis is not None:
        return _along(_max_axis, data, valid, axis)
    m, cnt = _whole_extremum(data, valid, -math.inf, torch.max)
    return torch.where(cnt > 0, m, NAN)


def masked_min(data, valid, axis=None):
    if axis is not None:
        return _along(_min_axis, data, valid, axis)
    m, cnt = _whole_extremum(data, valid, math.inf, torch.min)
    return torch.where(cnt > 0, m, NAN)


def masked_argmax(data, valid, axis=0):
    """nanargmax with invalid values filled with -inf (reference
    spectral_cube.py:771-795): ties break to the first index, as
    ``torch.argmax`` documents on every device, and a position with no
    valid value along ``axis`` gives 0.  ``axis=None``: the first flat
    index of the maximum over the whole array, found in pieces."""
    if axis is None:
        return _whole_arg(data, valid, -math.inf, torch.argmax)
    return _along(lambda d, v, a: torch.argmax(_fill(d, v, -math.inf),
                                               dim=a), data, valid, axis)


def masked_argmin(data, valid, axis=0):
    if axis is None:
        return _whole_arg(data, valid, math.inf, torch.argmin)
    return _along(lambda d, v, a: torch.argmin(_fill(d, v, math.inf),
                                               dim=a), data, valid, axis)


def _lerp_sorted(lo_v, hi_v, frac):
    # jnp.nanpercentile's linear interpolation form
    return lo_v * (1.0 - frac) + hi_v * frac


def _percentile_axis(data, valid, q, axis):
    s = torch.sort(_fill(data, valid, NAN), dim=axis).values
    n = valid.sum(axis).unsqueeze(axis)
    pos = q / 100.0 * (n - 1).to(torch.float64)
    lo = torch.clamp(torch.floor(pos), min=0)
    frac = (pos - lo).to(data.dtype)
    lo = lo.to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(n - 1, min=0))
    out = _lerp_sorted(torch.gather(s, axis, lo), torch.gather(s, axis, hi),
                       frac)
    return torch.where(n > 0, out, NAN).squeeze(axis)


def masked_percentile(data, valid, q, axis=None):
    """nanpercentile over the masked data (linear interpolation).

    ``torch.nanquantile`` refuses inputs above 2**24 elements, far below a
    real cube, so this sorts instead: the included finite values for
    ``axis=None`` (:func:`_whole_percentile`), else each lane with
    excluded values set to NaN (sorted last), a tile of lanes at a time
    (:func:`_along`), and interpolates between the two bracketing order
    statistics at position ``q/100 * (n - 1)``, computed in float64."""
    q = float(q)
    if axis is None:
        return _whole_percentile(data, valid, q)
    return _along(lambda d, v, a: _percentile_axis(d, v, q, a), data, valid,
                  axis)


def masked_median(data, valid, axis=None):
    return masked_percentile(data, valid, 50.0, axis=axis)


MAD_STD_FACTOR = 1.482602218505602  # 1/Phi^-1(3/4), astropy.stats.mad_std


def _mad_std_axis(data, valid, axis):
    med = _percentile_axis(data, valid, 50.0, axis)
    dev = torch.abs(data - med.unsqueeze(axis))
    return MAD_STD_FACTOR * _percentile_axis(dev, valid, 50.0, axis)


@spanned("sct.reductions.mad_std")
def masked_mad_std(data, valid, axis=None):
    """Median-absolute-deviation std estimate (astropy mad_std semantics,
    used by reference spectral_cube.py:719-767).  The deviations are never
    a whole-array temporary: over the whole array they are formed from
    each piece's included values as the piece is sorted, along an axis a
    tile of lanes at a time."""
    if axis is None:
        med = _whole_percentile(data, valid, 50.0)
        return MAD_STD_FACTOR * _whole_percentile(
            data, valid, 50.0, lambda v: torch.abs(v - med))
    return _along(_mad_std_axis, data, valid, axis)


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


def _pieces(x):
    """Views of ``x`` in order along its leading axes, runs of its flat
    order: the tiles of :func:`lane_tiles` with no axis reduced, ``x``
    itself up to :data:`SORT_CHUNK` elements, else whole leading-axis
    slabs of at most :data:`SORT_PIECE` elements where one row fits,
    else each row cut the same way."""
    for idx in lane_tiles(x.shape, ()):
        yield x[idx]


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


@spanned("sct.reductions.select")
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
    ``dask_spectral_cube.py:769-814``; the JAX package's
    ``ops/reductions.py:119-151``), with sigma from a second,
    mean-centered pass (the one-pass form cancels in float32).  Every sum
    is :func:`_whole_sum`'s and every extremum :func:`_whole_extremum`'s,
    a piece at a time: no count, filled copy or square of the whole
    cube.  ``valid`` broadcasts against ``data``."""
    s, cnt = _whole_sum(data, valid)
    ss = _whole_sum(data, valid, lambda d: d * d)[0]
    mn = _whole_extremum(data, valid, math.inf, torch.min)[0]
    mx = _whole_extremum(data, valid, -math.inf, torch.max)[0]
    npts = cnt.to(data.dtype)
    mean = torch.where(cnt > 0, s / torch.clamp(npts, min=1), NAN)
    mean_safe = torch.where(cnt > 0, mean, 0.0)

    def square(d):
        dev = d - mean_safe
        return dev.mul_(dev)
    s2c = _whole_sum(data, valid, square)[0]
    sigma = torch.where(cnt > 1, torch.sqrt(s2c / torch.clamp(npts - 1,
                                                               min=1)), NAN)
    rms = torch.where(cnt > 0, torch.sqrt(ss / torch.clamp(npts, min=1)), NAN)
    some = cnt > 0
    return {"npts": cnt, "min": torch.where(some, mn, NAN),
            "max": torch.where(some, mx, NAN),
            "sum": torch.where(some, s, NAN),
            "sumsq": torch.where(some, ss, NAN), "mean": mean,
            "sigma": sigma, "rms": rms}
