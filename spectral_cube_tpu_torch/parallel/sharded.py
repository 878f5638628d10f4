"""Sharded cube execution over a CubeMesh: the port of
``spectral_cube_tpu/parallel/sharded.py``.

The JAX package runs each operation as a ``shard_map`` program: every
device works on its own shard with the single-device kernels, ``psum``
trees reduce, ``ppermute`` exchanges halos and ``all_to_all`` reshards.
Here every mesh position runs the port's own single-device function on
its shard -- on a CUDA shard that is the kernel (moments #1/#2,
conv_sep #3/#4, resample2 #5/#6, smooth_interp #11/#12, sigma_clip #13),
launched once per shard on the shard's device -- and the collectives are
the explicit copies of :mod:`.mesh` and :func:`halo_pad`.  Reductions over
the mesh move scalars or one value per channel, never a cube.

Per shard the functions compute what the unsharded port computes on the
whole cube: the halo convolutions run conv_sep (or, past rank 8, the
unsharded path's IEEE-float32 ``conv2d``) on the halo-padded block, and
the halo reprojection runs resample2 on it, with each tile's taps moved
into the block.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
import warnings
from collections import namedtuple

import numpy as np
import torch

from .mesh import CubeMesh, ShardedArray, default_mesh
from ..masks import (is_data_local, is_finiteness_mask, LazyMask,
                     LazyComparisonMask, CompositeMask, BooleanArrayMask,
                     bind_data, unbind_data, has_unbound_data)
from ..kernels.moments import moments_planes_plain
from ..utils import warn_slow
from ..ops import moments as _mom
from ..ops import reductions as _red

__all__ = ["sharded_moments", "sharded_statistics", "sharded_mad_std",
           "sharded_percentile",
           "halo_pad", "sharded_convolve_per_channel_separable",
           "sharded_spatial_convolve", "sharded_spectral_convolve_fft",
           "sharded_sigma_clip", "sharded_spectral_interpolate",
           "sharded_smooth_interpolate", "sharded_reproject",
           "sharded_spline_reproject", "ShardedCube"]

NAN = float("nan")


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------
def _sharded(data, cmesh):
    """``data`` as a ShardedArray of ``cmesh`` from which each position
    cuts its spatial tile: a ShardedArray in the spatial (or replicated)
    layout as it is, one in the spectral layout resharded, a ShardedArray
    of another mesh gathered and placed again, and a host or device array
    wrapped whole without a copy (each position cuts its tile from it)."""
    if isinstance(data, ShardedArray):
        if data.cmesh is not cmesh:
            data = cmesh.shard(data.gather(), "spatial")
        if data.layout == "spectral":
            data = cmesh.reshard(data, "spatial")
        return data
    if isinstance(data, torch.Tensor):
        t = data
    else:
        arr = np.asarray(data)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    full = tuple(slice(0, n) for n in t.shape)
    n = cmesh.n_devices
    return ShardedArray(cmesh, "replicated", t.shape, [t] * n, [full] * n)


def _shape_of(data):
    return tuple(int(n) for n in (data.shape if hasattr(data, "shape")
                                  else np.shape(data)))


def _pad_spatial(data, cmesh, pad_value, include=None, chan_multiple=1):
    """Each mesh position's aligned spatial tile (nchan, py, px) of
    ``data``, py = ceil(ny / my) and px = ceil(nx / mx), the part past the
    cube filled with ``pad_value``: NaN = invalid (reductions, clipping,
    interpolation: padded voxels never contribute), 0 = the
    ``boundary='fill'`` valid zero (convolution).  ``include`` is cut the
    same way, padded False.  The channel count pads to a multiple of
    ``chan_multiple`` (the spectral layout's).  Every tile is cut from the
    position's own shard.  Returns ``(tiles, include_tiles, shape)``,
    ``shape`` the cube's."""
    src = _sharded(data, cmesh)
    tiles = cmesh._tile(src, "spatial", pad_value, chan_multiple)
    inc = None if include is None else cmesh._tile(
        _sharded(include, cmesh), "spatial", False, chan_multiple)
    return tiles, inc, src.shape


def _pad_chan(tiles, cmesh, pad_value):
    """Pad the channels of each tile up to a multiple of the device count,
    so that the spectral layout divides.  Returns ``(tiles, nchan)``."""
    n = cmesh.n_devices
    nchan = tiles[0].shape[0]
    pc = (-nchan) % n
    if pc == 0:
        return tiles, nchan
    out = []
    for t in tiles:
        p = torch.full((nchan + pc,) + tuple(t.shape[1:]), pad_value,
                       dtype=t.dtype, device=t.device)
        p[:nchan].copy_(t)
        out.append(p)
    return out, nchan


def _tile_extent(cmesh, p, shape, tile):
    """(rows, cols) of position ``p``'s aligned tile inside a plane of
    ``shape`` (ny, nx)."""
    my, mx = cmesh.grid
    iy, ix = divmod(p, mx)
    return (max(0, min(tile[0], shape[0] - iy * tile[0])),
            max(0, min(tile[1], shape[1] - ix * tile[1])))


def _planes(cmesh, planes, shape):
    """A plane-layout ShardedArray of ``shape`` (ny, nx) from aligned
    per-position planes."""
    return ShardedArray(cmesh, "plane", shape, *cmesh._cut_tiles(planes,
                                                                 shape))


def _to_first(cmesh, parts):
    """Per-position tensors stacked on the mesh's first device (the
    reduction tree's one step: a value per shard, never a cube)."""
    dev = cmesh.devices[0]
    return torch.stack([t.to(dev) for t in parts])


def _match(arr, like):
    """``arr`` with the placement of ``like`` (same shape): each block cut
    from the position's own block, resharded first between the cube
    layouts."""
    if arr.index == like.index:
        return arr
    if arr.layout != like.layout and {arr.layout, like.layout} == {
            "spatial", "spectral"}:
        arr = arr.cmesh.reshard(arr, like.layout)
    blocks = []
    for p, (b, ix) in enumerate(zip(arr.blocks, arr.index)):
        want = like.index[p]
        if any(w.stop > w.start and (w.start < s.start or w.stop > s.stop)
               for w, s in zip(want, ix)):
            raise ValueError(f"shard {p} does not hold the part asked for")
        blocks.append(b[tuple(slice(w.start - s.start, w.stop - s.start)
                              if w.stop > w.start else slice(0, 0)
                              for w, s in zip(want, ix))])
    return ShardedArray(arr.cmesh, like.layout, like.shape, blocks,
                        like.index)


def _spectral_blocks(cmesh, data, pad_value):
    """Each position's aligned block (C_p/n, ny_p, nx_p) of ``data`` in
    the spectral layout, whole planes of a slab of channels, padded with
    ``pad_value``: two counted all-to-alls from the spatial layout, none
    from the spectral one."""
    if isinstance(data, ShardedArray) and data.cmesh is cmesh \
            and data.layout == "spectral":
        return cmesh._tile(data, "spectral", pad_value)
    return cmesh._spectral_tiles(cmesh._tile(
        _sharded(data, cmesh), "spatial", pad_value, cmesh.n_devices))


def _include_tile(inc, mask_expr, d):
    """The include of the tile ``d``: its stored part ``inc``, the
    data-local expression evaluated on ``d``, both, or None."""
    if mask_expr is not None:
        extra = mask_expr.include(data=d)
        inc = extra if inc is None else torch.logical_and(inc, extra)
    return inc


# ---------------------------------------------------------------------------
# moments: spatial layout, zero communication
# ---------------------------------------------------------------------------
def _local_moments(d, coords, dx, mask_expr, inc):
    if d.dtype == torch.float32:
        return _mom.moments_012_kernel(d, coords, dx, mask_expr=mask_expr,
                                       include=inc)
    return _mom.moments_012(d, coords, dx,
                            include=_include_tile(inc, mask_expr, d))


def sharded_moments(data, coords, dx, cmesh: CubeMesh, include=None,
                    mask_expr=None):
    """Masked moments 0/1/2 of a spatially sharded cube.

    Each position reduces its own (nchan, py, px) tile along the local
    spectral axis, with no communication: float32 tiles through the
    moments kernel (its plain version on the CPU) with ``mask_expr``
    fused where it can be and ``include`` as its bool mask, as the
    unsharded cube runs them.  Returns three plane-layout
    ShardedArrays."""
    tiles, inc, shape = _pad_spatial(data, cmesh, NAN, include)
    outs = [_local_moments(d, coords, dx, mask_expr,
                           None if inc is None else inc[p])
            for p, d in enumerate(tiles)]
    return tuple(_planes(cmesh, [o[i] for o in outs], shape[1:])
                 for i in range(3))


# ---------------------------------------------------------------------------
# global statistics and mad_std: reductions over the mesh
# ---------------------------------------------------------------------------
def _statistics_planes(d, inc, mask_expr):
    """Per-spaxel (s0, cnt, min, max, d2) of one tile, from the moments
    kernel's with_stats planes: the kernel for float32 (its plain version
    on the CPU); for another type its plain version, in float32 as the
    kernel computes, with the mask evaluated on the data in its own
    type."""
    xc = np.zeros(d.shape[0])
    if d.dtype == torch.float32:
        op, thr, inc = _mom._kernel_inputs(d, mask_expr, inc)
        planes, cnt = _mom.moments_planes(d, xc, op, thr, inc, True)
    else:
        inc = _include_tile(inc, mask_expr, d)
        if inc is not None:
            inc = inc.to(d.device).expand(d.shape)
        planes, cnt = moments_planes_plain(d, xc, include=inc,
                                           with_stats=True)
    return _mom.statistics_planes(planes, cnt)


#: one shard's per-spaxel statistics planes (float32; ``cnt`` int32, ``n``
#: its float32 copy, ``m`` the spaxel's mean)
_Planes = namedtuple("_Planes", "s0 cnt n m mn mx d2")


def sharded_statistics(data, cmesh: CubeMesh, include=None, mask_expr=None):
    """CASA-style global statistics of a spatially sharded cube: each
    position's per-spaxel sufficient planes (the moments kernel's
    with_stats form), then a tree over the mesh of the per-shard sums,
    counts and extremes, then the mean-centred second pass for sigma
    (``ops/moments._recombine_statistics`` over the mesh; the reference's
    per-chunk accumulation, dask_spectral_cube.py:769-814).  Returns a
    dict of Python numbers; a cube with nothing included gives npts 0 and
    NaN elsewhere."""
    tiles, inc, _ = _pad_spatial(data, cmesh, NAN, include)
    f32 = torch.float32
    parts = []
    for p, d in enumerate(tiles):
        s0, cnt, mn, mx, d2 = _statistics_planes(
            d, None if inc is None else inc[p], mask_expr)
        n = cnt.to(f32)
        parts.append(_Planes(s0.to(f32), cnt, n, s0.to(f32) / torch.clamp(
            n, min=1), mn.to(f32), mx.to(f32), d2.to(f32)))

    def tree(fn, reduce=torch.sum):
        """``fn`` of each shard's planes, reduced over the mesh."""
        return reduce(_to_first(cmesh, [fn(q) for q in parts]))

    npts_i = int(tree(lambda q: q.cnt.sum()))
    if npts_i == 0:
        return {"npts": 0, "min": NAN, "max": NAN, "sum": NAN,
                "sumsq": NAN, "mean": NAN, "sigma": NAN, "rms": NAN}
    npts = tree(lambda q: q.n.sum())
    s = tree(lambda q: q.s0.sum())
    pilot = tree(lambda q: torch.where(q.cnt > 0, q.m, 0.0).sum()) \
        / torch.clamp(tree(lambda q: (q.cnt > 0).to(f32).sum()), min=1)
    ss = tree(lambda q: (q.d2 + q.n * q.m ** 2).sum())
    mn = tree(lambda q: torch.where(q.cnt > 0, q.mn, math.inf).min(),
              torch.min)
    mx = tree(lambda q: torch.where(q.cnt > 0, q.mx, -math.inf).max(),
              torch.max)
    mean = pilot + tree(lambda q: (q.n * (q.m - pilot.to(q.m.device)))
                        .sum()) / npts
    s2c = tree(lambda q: q.d2.sum()) + tree(
        lambda q: (q.n * (q.m - mean.to(q.m.device)) ** 2).sum())
    sigma = torch.sqrt(s2c / torch.clamp(npts - 1, min=1)) \
        if npts_i > 1 else torch.tensor(NAN)
    rms = torch.sqrt(ss / npts)
    vals = [float(v) for v in (mn, mx, s, ss, mean, sigma, rms)]
    return {"npts": npts_i, "min": vals[0], "max": vals[1], "sum": vals[2],
            "sumsq": vals[3], "mean": vals[4], "sigma": vals[5],
            "rms": vals[6]}


def _check_orderable(dtype):
    """Refuse the types the unsharded ``reductions.masked_percentile``
    does not reduce either: complex (torch sorts no complex values) and
    bool (``masked_mad_std`` subtracts)."""
    if dtype.is_complex or dtype == torch.bool:
        raise NotImplementedError(f"order statistics of {dtype} cubes: "
                                  "the unsharded reductions refuse them too")


def _valid_tiles(data, cmesh, include, mask_expr):
    """Each shard's tile part inside the cube, with its include (or
    None)."""
    src = _sharded(data, cmesh)
    _check_orderable(src.dtype)
    tiles, inc, shape = _pad_spatial(
        src, cmesh, NAN if src.dtype.is_floating_point else 0, include)
    out = []
    for p, d in enumerate(tiles):
        h, w = _tile_extent(cmesh, p, shape[1:], d.shape[1:])
        d = d[:, :h, :w]
        out.append((d, _include_tile(
            None if inc is None else inc[p][:, :h, :w], mask_expr, d)))
    return out


def _tiles_percentile(cmesh, tiles, q, fn=None):
    """The ``q``-th percentile of ``fn`` of the shards' included finite
    values: each shard sorts its own values, whole up to
    ``reductions.SORT_CHUNK`` voxels and in pieces past it
    (``reductions._pieces``), and each order statistic
    is found by bisecting the values' ordered bit patterns, every step a
    count of each piece's sorted keys summed over the mesh
    (``reductions._percentile_of``), so no shard's data leaves its
    device.  A 0-d tensor on the mesh's first device."""
    keys = []
    for d, i in tiles:
        k, dtype = _red._piece_keys(d, _red.valid_mask(d, i), fn)
        keys += k
    n = sum(k.numel() for k in keys)
    if n == 0:
        return torch.tensor(NAN, dtype=dtype, device=cmesh.devices[0])
    return _red._percentile_of(keys, n, float(q), dtype).to(
        cmesh.devices[0])


def sharded_percentile(data, q, cmesh: CubeMesh, include=None,
                       mask_expr=None):
    """The ``q``-th percentile of the included finite voxels of a sharded
    cube (the unsharded ``reductions.masked_percentile(axis=None)``,
    exactly).  Returns a 0-d tensor on the mesh's first device."""
    return _tiles_percentile(cmesh, _valid_tiles(data, cmesh, include,
                                                 mask_expr), q)


def sharded_mad_std(data, cmesh: CubeMesh, include=None, mask_expr=None):
    """``mad_std`` of the included finite voxels of a sharded cube (the
    unsharded ``reductions.masked_mad_std``, exactly): the median of the
    values, then the median of their absolute deviations from it, each as
    :func:`sharded_percentile` finds it, the deviations formed piece by
    piece.  Float cubes of every width and integer cubes, as the
    unsharded reduction takes them.  Returns a 0-d tensor on the mesh's
    first device."""
    tiles = _valid_tiles(data, cmesh, include, mask_expr)
    med = _tiles_percentile(cmesh, tiles, 50.0)
    return _red.MAD_STD_FACTOR * _tiles_percentile(
        cmesh, tiles, 50.0, lambda v: torch.abs(v - med.to(v.device)))


# ---------------------------------------------------------------------------
# reductions along lanes: every part holds some values of every lane
# ---------------------------------------------------------------------------
def _lane_select(cmesh, keys, counts, k):
    """Per lane, the ``k``-th smallest (0-based; ``k`` a (L,) int64 tensor
    on the first device) of the parts' keys: ``keys[p]`` (L, m_p) sorted
    along each lane, its first ``counts[p]`` (L,) entries the lane's
    values.  A bisection of every lane at once over its key range, each
    step one batched count of each part summed over the mesh."""
    dev = cmesh.devices[0]
    big = torch.iinfo(torch.int64).max
    lo = torch.full_like(k, big)
    hi = torch.full_like(k, -big)
    for kk, c in zip(keys, counts):
        has = (c > 0).to(dev)
        first = kk[:, 0].to(dev, torch.int64)
        last = kk.gather(1, (c - 1).clamp(min=0)[:, None])[:, 0].to(
            dev, torch.int64)
        lo = torch.where(has, torch.minimum(lo, first), lo)
        hi = torch.where(has, torch.maximum(hi, last), hi)
    hi = torch.maximum(hi, lo)       # an empty lane: nothing to bisect
    while bool((lo < hi).any()):
        # floor((lo + hi) / 2), with no overflow over the int64 keys
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        n = sum(torch.searchsorted(
            kk, mid.to(kk.device, kk.dtype)[:, None], right=True)[:, 0]
            .to(dev) for kk in keys)
        up = n >= k + 1
        hi = torch.where(up, mid, hi)
        lo = torch.where(up, lo, mid + 1)
    return lo


def _lane_percentile(cmesh, parts, q):
    """``masked_percentile`` along lanes (bit for bit): ``parts[p]`` is a
    (L, m_p) tensor of the lanes' values on position p, NaN where a value
    is not valid.  The two bracketing order statistics of each lane at
    q/100 * (n - 1), its position, fraction and lerp computed as the
    unsharded reduction computes them.  Returns (L,) on the first
    device."""
    dev = cmesh.devices[0]
    dtype = parts[0].dtype
    lanes = parts[0].shape[0]
    parts = [x for x in parts if x.shape[1]]
    if not parts:
        return torch.full((lanes,), NAN, dtype=dtype, device=dev)
    keys = [_red._keys_of(torch.sort(x, dim=1).values) for x in parts]
    counts = [(~torch.isnan(x)).sum(1) for x in parts]
    n = sum(c.to(dev) for c in counts)
    pos = float(q) / 100.0 * (n - 1).to(torch.float64)
    lo = torch.clamp(torch.floor(pos), min=0)
    frac = (pos - lo).to(dtype)
    lo = lo.to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(n - 1, min=0))
    out = _red._lerp_sorted(
        _red._values_of(_lane_select(cmesh, keys, counts, lo), dtype),
        _red._values_of(_lane_select(cmesh, keys, counts, hi), dtype), frac)
    return torch.where(n > 0, out, NAN)


def _lane_order(cmesh, name, parts, q=None):
    """The order statistic ``name`` (median, percentile, mad_std) along
    lanes of the parts (:func:`_lane_percentile`)."""
    if name != "mad_std":
        return _lane_percentile(cmesh, parts, 50.0 if q is None else q)
    med = _lane_percentile(cmesh, parts, 50.0)
    dev = [torch.abs(x - med.to(x.device)[:, None]) for x in parts]
    return _red.MAD_STD_FACTOR * _lane_percentile(cmesh, dev, 50.0)


def _lane_moments(cmesh, name, parts, ddof=0):
    """sum, mean, std, max or min along lanes of the parts (``parts[p]``
    a pair (x, valid) of (L, m_p) tensors), every part's partial
    reduced over the mesh: sums, counts and centred squares in float64,
    extremes in the values' type; a lane with no valid value is NaN (and
    std's lane with no more than ``ddof``).  Returns (L,) on the first
    device in the type the unsharded reduction gives."""
    dtype = parts[0][0].dtype
    out_dtype = dtype if dtype.is_floating_point else torch.float32
    lanes = parts[0][0].shape[0]
    parts = [(x, v) for x, v in parts if x.shape[1]]
    if not parts:
        return torch.full((lanes,), NAN, dtype=out_dtype,
                          device=cmesh.devices[0])
    f64 = torch.float64
    cnt = _to_first(cmesh, [v.sum(1) for _, v in parts]).sum(0)
    if name in ("max", "min"):
        fill, red = (-math.inf, torch.amax) if name == "max" \
            else (math.inf, torch.amin)
        m = red(_to_first(cmesh, [red(torch.where(v, x, fill), 1)
                                  for x, v in parts]), 0)
        return torch.where(cnt > 0, m, NAN)
    s = _to_first(cmesh, [torch.where(v, x, 0).sum(1, dtype=f64)
                          for x, v in parts]).sum(0)
    return _from_sums(name, cnt, s, lambda mean: _to_first(cmesh, [
        torch.where(v, (x.to(f64) - mean.to(x.device)[:, None]) ** 2,
                    0).sum(1) for x, v in parts]).sum(0), ddof, out_dtype)


def _from_sums(name, cnt, s, centred, ddof, out_dtype):
    """sum, mean or std (over ``n - ddof``) from the count ``cnt`` and the
    float64 sum ``s`` of the values, and ``centred(mean)``, the float64 sum
    of their squared deviations from ``mean``; NaN where nothing (or, for
    std, no more than ``ddof``) is counted, in ``out_dtype``."""
    if name == "sum":
        return torch.where(cnt > 0, s, NAN).to(out_dtype)
    n = cnt.to(torch.float64)
    mean = s / torch.clamp(n, min=1)
    if name == "mean":
        return torch.where(cnt > 0, mean, NAN).to(out_dtype)
    var = centred(mean) / torch.clamp(n - ddof, min=1)
    return torch.where(n > ddof, torch.sqrt(var), NAN).to(out_dtype)


def _by_lane_tiles(reduce, lanes, parts):
    """``reduce`` of the lanes of the parts a tile of whole lanes at a
    time, never of every lane at once: ``parts[p]`` is (m_p, get), m_p
    the values a lane holds on position p and ``get(sl)`` that position's
    values of the lanes ``sl`` (what :func:`_lane_moments` or
    :func:`_lane_order` takes of a part).  The tiles are
    ``reductions.lane_tiles``' of a (lanes, the sum of the m_p) array:
    all the lanes up to ``reductions.SORT_CHUNK`` voxels, else runs of
    lanes whose parts on all positions hold at most
    ``reductions.SORT_PIECE`` values together.  Each lane's value is its
    own reduction's, so that the tiles give the values of one call (sums
    within float64 rounding).  Returns (lanes,) on the first device."""
    out = None
    width = sum(m for m, _ in parts)
    for idx in _red.lane_tiles((lanes, width), (1,)):
        sl = slice(*idx[0].indices(lanes))
        r = reduce([get(sl) for _, get in parts])
        if out is None:
            out = torch.empty((lanes,), dtype=r.dtype, device=r.device)
        out[sl] = r
    return out


def _tile_lanes(d, inc, sl):
    """Channels ``sl`` of a spatial tile ``d`` (its include ``inc`` or
    None) as lanes over its plane: the values and their validity, each
    (lanes, py * px)."""
    x = d[sl]
    v = _red.valid_mask(x, None if inc is None else inc.expand(d.shape)[sl])
    return x.reshape(x.shape[0], -1), v.reshape(x.shape[0], -1)


def _slab_lanes(d, inc, keep, order, sl):
    """The rows (``keep`` 1) or columns (2) ``sl`` of a slab ``d`` of
    whole planes (its include ``inc`` or None) as lanes over its channels
    and the other spatial axis: the values and their validity, each
    (lanes, channels * the other axis), or for an order statistic the
    values with the invalid ones NaN."""
    n = sl.stop - sl.start
    x = d.narrow(keep, sl.start, n)
    v = _red.valid_mask(x, None if inc is None else
                        inc.expand(d.shape).narrow(keep, sl.start, n))
    perm = (keep, 0, 3 - keep)
    if order:
        return torch.where(v, x, NAN).permute(*perm).reshape(n, -1)
    return x.permute(*perm).reshape(n, -1), v.permute(*perm).reshape(n, -1)


def _whole_moments(cmesh, name, parts, ddof=0):
    """sum, mean, std, max or min of the values of the parts
    (``parts[p]`` a pair (x, valid) of position p's block and its
    validity), as :func:`_lane_moments` gives them over one lane: each
    part's float64 sums, count and extremes in the unsharded whole-cube
    reductions' pieces (``reductions._whole_total``, ``_whole_extremum``;
    no cube-sized count, fill or square), reduced over the mesh and
    rounded once.  A 0-d tensor on the first device."""
    dtype = parts[0][0].dtype
    out_dtype = dtype if dtype.is_floating_point else torch.float32
    f64 = torch.float64
    if name in ("max", "min"):
        fill, pick = (-math.inf, torch.max) if name == "max" \
            else (math.inf, torch.min)
        ext = [_red._whole_extremum(x, v, fill, pick) for x, v in parts]
        m = pick(_to_first(cmesh, [e for e, _ in ext]))
        cnt = _to_first(cmesh, [c for _, c in ext]).sum()
        return torch.where(cnt > 0, m, NAN)
    tot = [_red._whole_total(x, v) for x, v in parts]
    s = _to_first(cmesh, [t.to(f64) for t, _ in tot]).sum()
    cnt = _to_first(cmesh, [c for _, c in tot]).sum()
    return _from_sums(name, cnt, s, lambda mean: _to_first(cmesh, [
        _red._whole_total(x, v, lambda d: (d.to(f64) - mean.to(d.device))
                          ** 2)[0] for x, v in parts]).sum(), ddof,
        out_dtype)


# ---------------------------------------------------------------------------
# halo exchange for spatial stencils (the ppermute analog of dask chunk
# overlap)
# ---------------------------------------------------------------------------
def halo_pad(tiles, cmesh: CubeMesh, halo_y, halo_x):
    """Each aligned (..., py, px) tile padded with ``halo_y`` rows and
    ``halo_x`` columns of its neighbours' data, by copies between the
    shards: the y exchange first, then the x exchange of the y-padded
    blocks, which fills the corners from the diagonal neighbours.  Edge
    tiles get zero halos (the zero-fill boundary of the normalized
    convolution).  A halo wider than a tile is refused: as ``ppermute``,
    the exchange reaches one neighbour only.  Each exchange adds one to
    the mesh's ``halo_exchanges`` counter."""
    my, mx = cmesh.grid
    py, px = tiles[0].shape[-2:]
    if halo_y > py or halo_x > px:
        raise ValueError(f"halo ({halo_y}, {halo_x}) is wider than a "
                         f"({py}, {px}) tile: it reaches past the "
                         "neighbouring shard")
    lead = tuple(tiles[0].shape[:-2])
    cols = slice(halo_x, halo_x + px)
    out = []
    for t in tiles:
        o = torch.empty(lead + (py + 2 * halo_y, px + 2 * halo_x),
                        dtype=t.dtype, device=t.device)
        o[..., halo_y:halo_y + py, cols].copy_(t)
        out.append(o)
    if halo_y:
        for p, o in enumerate(out):
            iy = p // mx
            top, bottom = o[..., :halo_y, cols], o[..., halo_y + py:, cols]
            if iy > 0:
                top.copy_(tiles[p - mx][..., py - halo_y:, :])
            else:
                top.zero_()
            if iy < my - 1:
                bottom.copy_(tiles[p + mx][..., :halo_y, :])
            else:
                bottom.zero_()
        cmesh.counters["halo_exchanges"] += 1
    if halo_x:
        for p, o in enumerate(out):
            ix = p % mx
            left, right = o[..., :, :halo_x], o[..., :, halo_x + px:]
            if ix > 0:
                left.copy_(out[p - 1][..., :, px:px + halo_x])
            else:
                left.zero_()
            if ix < mx - 1:
                right.copy_(out[p + 1][..., :, halo_x:2 * halo_x])
            else:
                right.zero_()
        cmesh.counters["halo_exchanges"] += 1
    return out


def _nan_empty_channels(cmesh, outs, tiles, shape):
    """NaN, in place, the channels of the outputs ``outs`` with no finite
    value anywhere in the cube (the JAX package's ``any_valid`` psum):
    each tile's flags from its part inside the cube, OR-ed over the
    mesh."""
    tile = tiles[0].shape[-2:]
    flags = []
    for p, t in enumerate(tiles):
        h, w = _tile_extent(cmesh, p, shape[1:], tile)
        flags.append(_red.finite(t[:, :h, :w]).flatten(1).any(1))
    any_valid = _to_first(cmesh, flags).any(0)
    if bool(any_valid.all()):
        return outs
    return [o.masked_fill_(~any_valid.to(o.device)[:, None, None], NAN)
            for o in outs]


def _crop_halo(blocks, hy, hx, tile):
    py, px = tile
    return [b[:, hy:hy + py, hx:hx + px].contiguous() for b in blocks]


def sharded_convolve_per_channel_separable(data, kernels, group_idx,
                                           cmesh: CubeMesh, max_rank=4):
    """Per-channel separable beam convolution in the spatial layout with
    a halo exchange: zero all-to-alls.

    Each position runs conv_sep (kernel #3/#4; its plain version on the
    CPU) on its halo-padded block with the taps the unsharded
    ``ops/convolve.convolve_per_channel_separable`` builds; edge tiles see
    zero halos, which is the zero-fill boundary, and channels with no
    finite value anywhere are NaN.  Returns None when a kernel's rank
    exceeds ``max_rank`` or its half-width exceeds a tile (the caller then
    takes the reshard + FFT route)."""
    from ..ops.convolve import separable_factors, _convolve_groups
    from ..ops.smoothing import banded_tap_offset
    my, mx = cmesh.grid
    _, ny, nx = _shape_of(data)
    py, px = -(-ny // my), -(-nx // mx)
    ytaps_g, xtaps_g = [], []
    hy = hx = 0
    for k in kernels:
        if k is None:
            ytaps_g.append(np.ones((1, 1)))
            xtaps_g.append(np.ones((1, 1)))
            continue
        fac = separable_factors(k, max_rank=max_rank)
        if fac is None:
            return None
        ytaps_g.append(fac[0])
        xtaps_g.append(fac[1])
        # the backward reach after the flip, ceil((klen - 1) / 2)
        hy = max(hy, banded_tap_offset(k.shape[0]))
        hx = max(hx, banded_tap_offset(k.shape[1]))
    if hy > py or hx > px:
        return None
    tiles, _, shape = _pad_spatial(data, cmesh, 0.0)
    gi = np.asarray(group_idx, dtype=np.int32)
    outs = [_convolve_groups(b, ytaps_g, xtaps_g, gi)
            for b in halo_pad(tiles, cmesh, hy, hx)]
    outs = _nan_empty_channels(cmesh, _crop_halo(outs, hy, hx, (py, px)),
                               tiles, shape)
    return cmesh._from_spatial(outs, shape)


def sharded_spatial_convolve(data, kernel, cmesh: CubeMesh):
    """NaN-interpolating spatial convolution of a spatially sharded cube
    with one 2-D kernel, through a halo exchange.

    A kernel of rank <= 4 takes :func:`sharded_convolve_per_channel_separable`
    with one group; another odd kernel that fits a tile runs, per
    halo-padded block, the unsharded ``ops/smoothing.spatial_smooth_cube``
    (conv_sep to rank 8, else one IEEE-float32 ``conv2d``); an even kernel
    or a halo wider than a tile takes the reshard + FFT route."""
    from ..ops.smoothing import spatial_smooth_cube
    karr = np.asarray(kernel, dtype=float)
    k = karr / karr.sum()
    nchan0, ny0, nx0 = _shape_of(data)
    sep = sharded_convolve_per_channel_separable(
        data, [k], np.zeros(nchan0, np.int32), cmesh)
    if sep is not None:
        return sep
    hy, hx = k.shape[0] // 2, k.shape[1] // 2
    my, mx = cmesh.grid
    py, px = -(-max(ny0, 1) // my), -(-max(nx0, 1) // mx)
    if hy > py or hx > px or k.shape[0] % 2 == 0 or k.shape[1] % 2 == 0:
        # even kernels would emit misaligned tiles; both cases take the
        # reshard + spectral-multiply route, its FFT planes sized from
        # the mesh-padded extent
        from ..ops.convolve import _padded_shape, _transfers
        fy, fx = _padded_shape((ny0 + (-ny0) % my, nx0 + (-nx0) % mx),
                               k.shape)
        return _fft_convolve(
            data, np.zeros(nchan0, np.int32), cmesh, fy, fx,
            lambda groups, dev, dt: _transfers([k], fy, fx, dev, dt))
    tiles, _, shape = _pad_spatial(data, cmesh, 0.0)
    outs = [spatial_smooth_cube(b, karr)
            for b in halo_pad(tiles, cmesh, hy, hx)]
    outs = _nan_empty_channels(cmesh, _crop_halo(outs, hy, hx, (py, px)),
                               tiles, shape)
    return cmesh._from_spatial(outs, shape)


# ---------------------------------------------------------------------------
# FFT beam convolution: reshard to the channel layout (the rechunk analog)
# ---------------------------------------------------------------------------
def _fft_convolve(data, group_idx, cmesh, fy, fx, transfers_for):
    """Per-channel FFT convolution over a mesh on (fy, fx) planes: the
    spatial tiles (zero-padded to aligned tiles and to a channel count the
    devices divide) reshard to the spectral layout by two all-to-alls,
    each position convolves its channel block's whole planes in the
    unsharded route's channel batches (``ops/convolve._convolve_batches``,
    cuFFT on the card), and the result reshards back.
    ``transfers_for(groups, device, dtype)`` gives the transfers of the
    beam groups ``groups``, each batch's own, so that a device holds only
    the transfers of the batch it convolves."""
    from ..ops.convolve import _convolve_batches, _complex_of
    n = cmesh.n_devices
    tiles, _, shape = _pad_spatial(data, cmesh, 0.0, chan_multiple=n)
    nchan, ny, nx = shape
    blocks = cmesh._spectral_tiles(tiles)
    del tiles
    cb = blocks[0].shape[0]
    gidx = np.zeros(cb * n, np.int64)
    gidx[:nchan] = np.asarray(group_idx)
    outs = []
    for p in range(n):
        # each block leaves the list once convolved
        b, blocks[p] = blocks[p], None
        o = _convolve_batches(
            b, gidx[p * cb:(p + 1) * cb], fy, fx,
            lambda used, b=b: transfers_for(used, b.device,
                                            _complex_of(b.dtype)))
        # the mesh padding holds valid zeros: a channel with no finite
        # value inside the cube is NaN, as the unsharded route gives it
        inside = _red.finite(b[:, :ny, :nx]).flatten(1).any(1)
        del b
        if not bool(inside.all()):
            o.masked_fill_(~inside[:, None, None], NAN)
        outs.append(o)
    return cmesh._from_spatial(cmesh._spatial_tiles(outs), shape)


def sharded_spectral_convolve_fft(data, transfers, group_idx,
                                  cmesh: CubeMesh):
    """Per-channel FFT convolution over a mesh with the transfers
    ``transfers`` (ngroup, fy, fx//2+1), complex (``ops/convolve._transfers``
    of the kernels), ``fy``/``fx`` at least the mesh-padded plane plus the
    kernel: reshard [spec, y, x] to the spectral layout, full-plane FFTs
    per channel, reshard back."""
    tr = transfers if isinstance(transfers, torch.Tensor) \
        else torch.as_tensor(np.asarray(transfers))

    def transfers_for(groups, device, dtype):
        return tr[torch.as_tensor(groups)].to(device=device, dtype=dtype)
    return _fft_convolve(data, group_idx, cmesh, tr.shape[1],
                         2 * (tr.shape[2] - 1), transfers_for)


# ---------------------------------------------------------------------------
# the spectral path: zero communication in the spatial layout
# ---------------------------------------------------------------------------
def sharded_sigma_clip(data, cmesh: CubeMesh, sigma=3.0, maxiters=5,
                       cenfunc="median", stdfunc="std"):
    """Per-spaxel sigma clip: each position clips its own tile (NaN
    padded) with the unsharded ``ops/smoothing.sigma_clip_spectrally``,
    the sigma_clip kernel (#13) for float32 with stdfunc='std'."""
    from ..ops.smoothing import sigma_clip_spectrally
    tiles, _, shape = _pad_spatial(data, cmesh, NAN)
    outs = [sigma_clip_spectrally(t, sigma=sigma, maxiters=maxiters,
                                  cenfunc=cenfunc, stdfunc=stdfunc)
            for t in tiles]
    return cmesh._from_spatial(outs, shape)


def sharded_spectral_interpolate(data, inaxis, outaxis, cmesh: CubeMesh,
                                 include=None):
    """Spectral regrid: the gather weights are shared, so each position
    regrids its own tile (NaN padded) with no communication.  The include
    mask, if given, interpolates alongside (reference
    spectral_cube.py:3298-3315).  Returns ``(out, new_include_or_None)``."""
    from ..ops.interpolate import interp_cube_spectral
    tiles, inc, shape = _pad_spatial(data, cmesh, NAN, include)
    res = [interp_cube_spectral(t, inaxis, outaxis,
                                include=None if inc is None else inc[p])
           for p, t in enumerate(tiles)]
    out_shape = (res[0][0].shape[0],) + tuple(shape[1:])
    out = cmesh._from_spatial([r[0] for r in res], out_shape)
    if include is None:
        return out, None
    return out, cmesh._from_spatial([r[1] for r in res], out_shape)


def sharded_smooth_interpolate(data, kernel, inaxis, outaxis,
                               cmesh: CubeMesh, include=None):
    """Fused spectral smooth + regrid per spatial tile, no communication:
    the unsharded ``ops/interpolate.smooth_interp_cube`` on each tile
    (smooth_interp, #11/#12, for float32).  The tiles pad with ZEROS, not
    NaN: both operators act along the spectral axis only, the padded
    columns are cut after, and a NaN pad would send every edge tile's
    padded spectra down the kernel's slower NaN branch."""
    from ..ops.interpolate import smooth_interp_cube
    kernel = np.asarray(kernel, dtype=float)
    tiles, inc, shape = _pad_spatial(data, cmesh, 0.0, include)
    res = [smooth_interp_cube(t, kernel, inaxis, outaxis,
                              include=None if inc is None else inc[p])
           for p, t in enumerate(tiles)]
    out_shape = (res[0][0].shape[0],) + tuple(shape[1:])
    out = cmesh._from_spatial([r[0] for r in res], out_shape)
    if include is None:
        return out, None
    return out, cmesh._from_spatial([r[1] for r in res], out_shape)


# ---------------------------------------------------------------------------
# reprojection
# ---------------------------------------------------------------------------
def _reproject_tile_blocks(i0, w, valid, m, n_out, n_in):
    """Cut one axis of an axis-aligned bilinear resample (taps ``i0``,
    weights ``1 - w`` at ``i0`` and ``w`` at ``i0 + 1``) into per-tile
    taps for an m-way mesh axis.

    Output tile t (rows [t*po, (t+1)*po)) reads only the input window
    [t*pi - h, (t+1)*pi + h) of its halo-padded block; ``h`` is the
    smallest halo that covers every tile's taps of nonzero weight at the
    outputs in ``valid`` (the others are NaN by the validity plane).
    Returns ``(tiles, h)``, ``tiles[t] = (r0, r1, local_i0, local_w)``,
    or None when a tile's taps reach beyond the nearest neighbour
    (h > pi: the exchange reaches one tile only)."""
    po, pi = -(-n_out // m), -(-n_in // m)
    i0 = np.asarray(i0, np.int64)
    w = np.asarray(w, np.float32)
    first = np.where(w < 1, i0, i0 + 1)
    last = np.where(w > 0, np.minimum(i0 + 1, n_in - 1), i0)
    h = 0
    for t in range(m):
        r0, r1 = t * po, min((t + 1) * po, n_out)
        ok = valid[r0:r1] if r0 < r1 else np.zeros(0, bool)
        if ok.any():
            h = max(h, t * pi - int(first[r0:r1][ok].min()),
                    int(last[r0:r1][ok].max()) + 1 - (t + 1) * pi)
    if h > pi:
        return None
    span = pi + 2 * h
    tiles = []
    for t in range(m):
        r0, r1 = min(t * po, n_out), min((t + 1) * po, n_out)
        li = i0[r0:r1] - (t * pi - h)
        lw = w[r0:r1].copy()
        # a zero-weight lower tap left of the block: step onto the next
        # sample, weight 1 there, the same sum; an output outside the
        # input is NaN whatever it reads
        step = li < 0
        lw[step & (lw == 1)] = 0
        li = np.clip(np.where(step, li + 1, li), 0, span - 1)
        tiles.append((r0, r1, li, lw))
    return tiles, h


def _reproject_halo(src, maps, taps, halo, cmesh, nz):
    """The halo strategy: resample2 (#5/#6) on each halo-padded block
    with the tile's own taps, the spectral lerp first where the spectral
    axis changes (``resample2_filled``), as the unsharded
    ``ops/regrid._bilinear_spatial_then_linear_z`` runs on the cube."""
    from ..kernels.resample2 import resample2, resample2_filled
    from ..ops.regrid import _zlerp_filled
    (zvalid, z0, zf, z_identity, yvalid, xvalid) = maps[:6]
    (ytiles, hy), (xtiles, hx) = halo
    vp = yvalid & xvalid
    my, mx = cmesh.grid
    tiles, _, _ = _pad_spatial(src, cmesh, 0.0)
    blocks, index = [], []
    for p, b in enumerate(halo_pad(tiles, cmesh, hy, hx)):
        iy, ix = divmod(p, mx)
        ry0, ry1, yi, yw = ytiles[iy]
        rx0, rx1, xi, xw = xtiles[ix]
        plane = vp[ry0:ry1, rx0:rx1]
        if plane.size == 0:
            out = torch.empty((nz, ry1 - ry0, rx1 - rx0), dtype=b.dtype,
                              device=b.device)
        elif z_identity:
            out = resample2(b, yi, yw, xi, xw, plane, zvalid)
        else:
            fz, wz, wz_any = _zlerp_filled(b, z0, zf)
            out = resample2_filled(fz, wz, wz_any, yi, yw, xi, xw, plane,
                                   zvalid)
        blocks.append(out)
        index.append((slice(0, nz), slice(ry0, ry1), slice(rx0, rx1)))
    return ShardedArray(cmesh, "spatial", (nz,) + vp.shape, blocks, index)


def _reproject_reshard(src, maps, order, cmesh, nz):
    """The reshard strategy: the spectral step in the spatial layout (z
    local; none on an untouched spectral axis, the nearest input channel
    for order 0, else ``ops/regrid._zlerp_filled``'s lerp of the
    NaN-filled data and of the NaN flags), two all-to-alls to the
    spectral layout (whole planes local), on each channel block the
    unsharded four-corner gather a slab of channels at a time
    (``ops/regrid._gather_slabs``, each slab's NaN weights gathered where
    its channels hold NaN), and two all-to-alls back."""
    from ..ops.regrid import (_corner_taps, _gather_slabs, _nan_channels,
                              _nan_weight, _zlerp_filled)
    (zvalid, z0, zf, z_identity, yvalid, xvalid) = maps[:6]
    nchan_in, ny_in, nx_in = src.shape
    ny_out, nx_out = yvalid.shape
    tiles, _, _ = _pad_spatial(src, cmesh, 0.0)
    lerped = not (z_identity or order == 0 or nchan_in == 1)

    def spectral(parts):
        parts, _ = _pad_chan(parts, cmesh, 0.0)
        return cmesh._spectral_tiles(parts)
    if lerped:
        lerps = [_zlerp_filled(t, z0, zf) for t in tiles]
        del tiles
        # the output channels whose NaN weight is not zero on some tile
        wz_any = np.logical_or.reduce([a.cpu().numpy()
                                       for _, _, a in lerps])
        fz = spectral([f for f, _, _ in lerps])
        wz = spectral([w for _, w, _ in lerps])
        del lerps
    else:
        if not z_identity:
            lo = np.asarray(z0, np.int64)
            tiles = [t.index_select(0, torch.as_tensor(lo, device=t.device))
                     for t in tiles]
        fz = spectral(tiles)
        wz = None
        del tiles
    valid = (yvalid & xvalid)[None]
    cb = fz[0].shape[0]
    taps = {}
    outs = []
    for p in range(len(fz)):
        # each block leaves the lists once gathered
        f, fz[p] = fz[p][:, :ny_in, :nx_in], None
        dev = f.device
        if str(dev) not in taps:
            taps[str(dev)] = _corner_taps(maps, order, nx_in, dev)
        if wz is None:
            nan_chan = _nan_channels(f)

            def fill(k0, k1, f=f):
                return torch.nan_to_num(f[k0:k1])

            def weight(k0, k1, f=f, nan_chan=nan_chan):
                return _nan_weight(f[k0:k1]) \
                    if bool(nan_chan[k0:k1].any()) else None
        else:
            w, wz[p] = wz[p][:, :ny_in, :nx_in], None
            flags = wz_any[p * cb:(p + 1) * cb]

            def fill(k0, k1, f=f):
                return f[k0:k1]

            def weight(k0, k1, w=w, flags=flags):
                return w[k0:k1] if flags[k0:k1].any() else None
        out = _gather_slabs(cb, taps[str(dev)], (ny_in, nx_in),
                            (ny_out, nx_out), fill, weight)
        del f, fill, weight
        zv = np.zeros(cb, bool)
        c0, c1 = min(p * cb, nz), min((p + 1) * cb, nz)
        zv[:c1 - c0] = np.asarray(zvalid)[c0:c1]
        ok = torch.as_tensor(valid, device=dev) \
            & torch.as_tensor(zv, device=dev)[:, None, None]
        outs.append(out.masked_fill_(~ok, NAN))
    del fz, wz
    out = cmesh._from_spectral(outs, (nz, ny_out, nx_out))
    del outs
    return cmesh.reshard(out, "spatial")


def sharded_reproject(data, zs, ys, xs, cmesh: CubeMesh, order=1):
    """Reproject a spatially sharded [spec, y, x] cube onto the host-side
    target->source mappings ``(zs, ys, xs)``: the sharded form of the
    unsharded ``ops/regrid._bilinear_spatial_then_linear_z`` (orders 0
    and 1), with its host maps (``ops/regrid.bilinear_host_maps``) and
    its results.

    - **halo**: a bilinear, axis-aligned mapping (``ops/regrid.
      _axis_aligned_taps``) whose every output tile reads within one
      neighbouring tile runs resample2 per halo-padded block: zero
      all-to-alls (the offset and low-shear mosaicking case).
    - **reshard**: rotations, order 0 and displacements beyond one tile
      reshard to the spectral layout, gather per channel block and
      reshard back: four all-to-alls, never a gather of the cube.

    Returns the (nz, ny_out, nx_out) result in the spatial layout."""
    from ..ops.regrid import bilinear_host_maps, _axis_aligned_taps
    order = int(order)
    if order not in (0, 1):
        raise ValueError("sharded_reproject supports orders 0/1 "
                         "(nearest/bilinear); spline orders take the "
                         "unsharded path")
    src = _sharded(data, cmesh)
    nchan_in, ny_in, nx_in = src.shape
    zs = np.asarray(zs, np.float64)
    ys = np.asarray(ys, np.float64)
    xs = np.asarray(xs, np.float64)
    nz = zs.shape[0]
    ny_out, nx_out = ys.shape
    maps = bilinear_host_maps(zs, ys, xs, nchan_in, ny_in, nx_in, order)
    my, mx = cmesh.grid
    if order == 1 and ny_in > 1 and nx_in > 1:
        taps = _axis_aligned_taps(ys, xs, ny_in, nx_in)
        if taps is not None:
            vp = maps[4] & maps[5]
            by = _reproject_tile_blocks(taps[0], taps[1], vp.any(1), my,
                                        ny_out, ny_in)
            bx = _reproject_tile_blocks(taps[2], taps[3], vp.any(0), mx,
                                        nx_out, nx_in)
            if by is not None and bx is not None:
                return _reproject_halo(src, maps, taps, (by, bx), cmesh, nz)
    return _reproject_reshard(src, maps, order, cmesh, nz)


def sharded_spline_reproject(data, zs, ys, xs, cmesh: CubeMesh, order=3):
    """Spline reprojection (order 2, biquadratic, or 3, bicubic) of a
    spatially sharded [spec, y, x] cube onto the host-side target->source
    mappings ``(zs, ys, xs)``: the sharded form of the unsharded
    ``ops/regrid._spline_spatial_then_z``, its two steps
    (``_spline_spectral``, ``_spline_spatial``) run on the mesh, with its
    host operators, its routes and its results.

    - **spectral**: on each tile's whole spectra (the spatial layout, no
      communication) the spline operator along z through
      ``ops/regrid._spectral_product`` (kernel #14 on the card), once for
      the NaN-filled tile and once, with the operator's absolute values,
      for its NaN mask, the two inputs written in turn into one buffer:
      two launches a tile.  The route follows the operator's bands, so
      every tile takes the unsharded call's.  Four all-to-alls take fz
      and wz to the spectral layout; on an untouched spectral axis two
      take the data itself.
    - **spatial**: on each block of whole planes the separable products or
      the prefilter and tap gathers (the route chosen once from the full
      maps by ``ops/regrid.spline_host_maps``, as the unsharded call
      chooses it; one tap plan a device), a slab of output channels at a
      time into the block's one output (each slab filling itself on an
      untouched axis), the NaN poisoning where the |T|-weighted NaN mass
      passes 1e-6; each block leaves the mesh's lists once resampled; two
      all-to-alls back.

    Returns the (nz, ny_out, nx_out) result in the spatial layout."""
    from ..ops import regrid as _rg
    order = int(order)
    if order not in (2, 3):
        raise ValueError("sharded_spline_reproject takes the spline orders "
                         "2/3 (biquadratic/bicubic); orders 0/1 take "
                         "sharded_reproject")
    src = _sharded(data, cmesh)
    nchan_in, ny_in, nx_in = src.shape
    m = _rg.spline_host_maps(zs, ys, xs, nchan_in, ny_in, nx_in)
    nz = m.zc.shape[0]
    ny, nx = m.ycl.shape
    tiles, _, _ = _pad_spatial(src, cmesh, 0.0)
    if m.z_identity:
        fz, wz = cmesh._spectral_tiles(_pad_chan(tiles, cmesh, 0.0)[0]), None
    else:
        fz, wz = [], []
        for p in range(len(tiles)):
            # a tile's products made, padded and its tile let go in turn
            f, w = _rg._spline_spectral(tiles[p], m, order)
            tiles[p] = None
            fz.append(_pad_chan([f], cmesh, 0.0)[0][0])
            wz.append(_pad_chan([w], cmesh, 0.0)[0][0])
            del f, w
        fz, wz = cmesh._spectral_tiles(fz), cmesh._spectral_tiles(wz)
    del tiles
    plans = {}
    cb = fz[0].shape[0]
    outs = []
    for p in range(len(fz)):
        c0, c1 = min(p * cb, nz), min((p + 1) * cb, nz)
        # each block leaves the lists once resampled
        f, fz[p] = fz[p][:c1 - c0, :ny_in, :nx_in], None
        w = None
        if wz is not None:
            w, wz[p] = wz[p][:c1 - c0, :ny_in, :nx_in], None
        dev = f.device
        if c1 == c0:
            outs.append(torch.empty((0, ny, nx), dtype=src.dtype,
                                    device=dev))
            continue
        if not m.separable and str(dev) not in plans:
            plans[str(dev)] = _rg.spline_taps(m.ycl, m.xcl, order, ny_in,
                                              nx_in, dev)
        out = _rg._spline_spatial(f, w, m, order, plans.get(str(dev)),
                                  m.zvalid[c0:c1])
        del f, w
        outs.append(out.to(src.dtype))
        del out
    del fz, wz
    return cmesh.reshard(cmesh._from_spectral(outs, (nz, ny, nx)), "spatial")


# ---------------------------------------------------------------------------
# ShardedCube: the cube facade bound to a mesh
# ---------------------------------------------------------------------------
#: the unsharded reductions a ShardedCube runs on its tiles and slabs
_REDUCERS = {"sum": _red.masked_sum, "mean": _red.masked_mean,
             "std": _red.masked_std, "max": _red.masked_max,
             "min": _red.masked_min, "median": _red.masked_median,
             "mad_std": _red.masked_mad_std,
             "percentile": lambda d, v, axis, q: _red.masked_percentile(
                 d, v, q, axis=axis)}

#: attributes a ShardedCube reads from its metadata cube (no data needed;
#: ``device`` is the mesh's first device, where the metadata cube lives)
_METADATA = frozenset({
    "unit", "wcs", "spectral_axis", "spectral_unit", "header", "meta",
    "beam", "beams", "unmasked_beams", "goodbeams_mask", "ndim", "size",
    "dtype", "device", "fill_value", "velocity_convention",
    "pixels_per_beam", "common_beam", "closest_spectral_channel",
    "identify_bad_beams", "jtok_factors", "check_jybeam_smoothing",
    "chunked", "find_lines", "read", "world_spines", "flattened_world",
    "_wcs", "_meta", "_unit", "_fill_value", "_beam", "_beams",
    "_goodbeams_mask", "_header", "_nowcs_header", "_spectral_offsets",
    "_spectral_pix_size", "_is_huge", "world", "world_extrema",
    "longitude_extrema", "latitude_extrema", "spectral_extrema",
    "spatial_coordinate_map"})

#: the cube's names whose call still gathers the cube on the mesh's first
#: device (one count on ``gathers``), with the reason: each produces a
#: whole host array or a whole-cube host computation, in the JAX package
#: too (``np.asarray`` of the sharded array)
GATHERED = {
    "write": "a file of the whole cube (a streamed sharded writer is out "
             "of scope)",
    "hdu": "an HDU holds the whole filled cube as a host array",
    "hdulist": "its HDU holds the whole filled cube as a host array",
    "to_yt": "yt takes the whole filled cube as a host array",
    "to_glue": "glue takes the whole filled cube as a host array",
    "to_ds9": "ds9 loads the whole cube from a FITS file",
    "to_pvextractor": "the viewer holds the whole cube",
    "plot_channel_maps": "the viewer holds the whole cube",
    "filled": "the whole filled cube as a host array",
    "get_mask_array": "the whole include as a host array",
    "apply_numpy_function": "a numpy function of the whole filled cube on "
                            "the host",
    "apply_function": "with axis=0, 1 or 2: the host loop over every ray "
                      "of the cube (axis=None runs on the shards)",
    "apply_function_parallel_spectral": "with accepts_chunks=True: the "
                                        "function receives the whole cube",
    "apply_function_parallel_spatial": "with accepts_chunks=True: the "
                                       "function receives the whole cube",
    "mask": "with a stored include (a sharded array that no mask object "
            "holds), a BooleanArrayMask of the whole include, and a data "
            "mask bound to no data (a streamed reader's, a comparison's) "
            "bound to the gathered data; otherwise the mask object as it "
            "is, nothing moved",
}

_MISSING = object()


def _tmp_dir_option(method):
    """The cube's ``save_to_tmp_dir=`` option of cube-returning methods:
    the resulting ShardedCube written to a temporary store and read back
    (:meth:`ShardedCube.checkpoint`, block by block)."""
    @functools.wraps(method)
    def wrapper(self, *args, save_to_tmp_dir=False, **kwargs):
        out = method(self, *args, **kwargs)
        return out.rechunk(save_to_tmp_dir=True) if save_to_tmp_dir else out
    return wrapper


def _placeholder(shape, dtype, device):
    """A tensor of ``shape`` that holds one value (a metadata cube's
    data)."""
    return torch.zeros((), dtype=dtype, device=device).expand(tuple(shape))


def _crop(arr, view):
    """The box ``view`` (unit-step slices) of the ShardedArray ``arr``, in
    the spatial layout of the box's own shape: each position's block
    assembled on its device from the parts of ``arr``'s blocks that
    overlap it, so that only the box's bytes move."""
    cmesh = arr.cmesh
    shape = tuple(v.stop - v.start for v in view)
    my, mx = cmesh.grid
    py, px = -(-shape[1] // my), -(-shape[2] // mx)
    sources = {}
    for b, ix in zip(arr.blocks, arr.index):
        sources.setdefault(tuple((s.start, s.stop) for s in ix), (b, ix))
    blocks, index = [], []
    for p, dev in enumerate(cmesh.devices):
        iy, ix = divmod(p, mx)
        want = (slice(0, shape[0]),
                slice(min(iy * py, shape[1]), min((iy + 1) * py, shape[1])),
                slice(min(ix * px, shape[2]), min((ix + 1) * px, shape[2])))
        out = torch.empty(tuple(w.stop - w.start for w in want),
                          dtype=arr.dtype, device=dev)
        for b, src in sources.values():
            # the overlap in the cube's coordinates
            lo = [max(v.start + w.start, s.start)
                  for v, w, s in zip(view, want, src)]
            hi = [min(v.start + w.stop, s.stop)
                  for v, w, s in zip(view, want, src)]
            if all(h > l_ for l_, h in zip(lo, hi)):
                out[tuple(slice(l_ - v.start - w.start, h - v.start - w.start)
                          for l_, h, v, w in zip(lo, hi, view, want))].copy_(
                    b[tuple(slice(l_ - s.start, h - s.start)
                            for l_, h, s in zip(lo, hi, src))])
        blocks.append(out)
        index.append(want)
    return ShardedArray(cmesh, "spatial", shape, blocks, index)


#: the voxels of one piece when a block's part is taken a few channels at a
#: time (:func:`_channel_chunks`): 4 Mi voxels, 16 MiB of float32
_CHUNK_VOXELS = 1 << 22


def _channel_chunks(local, glob, place):
    """A part (:meth:`ShardedCube._view_parts`) cut along its first axis
    into pieces of at most ``_CHUNK_VOXELS`` voxels, each as ``(local,
    glob, place)``: what is evaluated on a piece at a time (a mask's
    include, flat positions) stays bounded whatever the cube's size."""
    n = place[0].stop - place[0].start
    per = max(1, (place[1].stop - place[1].start)
              * (place[2].stop - place[2].start))
    step = max(1, _CHUNK_VOXELS // per)
    for a in range(0, n, step):
        b = min(n, a + step)
        cut = [(sl.start + a * sl.step, sl.start + (b - 1) * sl.step + 1,
                sl.step) for sl in (local[0], glob[0])]
        yield ((slice(*cut[0]),) + local[1:], (slice(*cut[1]),) + glob[1:],
               (slice(place[0].start + a, place[0].start + b),) + place[1:])


def _view_axes(view, shape):
    """The view ``view`` of an array of ``shape`` as numpy reads it
    (integers, slices of any step, ``None`` and one ``Ellipsis``, the
    views ``masks.index_view`` takes): per axis an integer (the axis is
    dropped) or ``(lo, count, step, flip)``, the indices ``lo + j * step``
    (j < count, ``step`` > 0) the view selects in ascending order,
    ``flip`` where it walks them backwards; and the positions in the
    result of the axes ``None`` adds."""
    from ..masks import _is_index
    view = view if isinstance(view, tuple) else (view,)
    ells = [i for i, v in enumerate(view) if v is Ellipsis]
    if len(ells) > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    used = sum(1 for v in view if v is not None and v is not Ellipsis)
    if used > len(shape):
        raise IndexError(f"too many indices for an array of {len(shape)} "
                         "dimensions")
    rest = (slice(None),) * (len(shape) - used)
    view = view[:ells[0]] + rest + view[ells[0] + 1:] if ells \
        else view + rest
    axes, new = [], []
    for v in view:
        if v is None:
            new.append(sum(not isinstance(a, int) for a in axes) + len(new))
            continue
        n = shape[len(axes)]
        if isinstance(v, slice):
            start, stop, step = v.indices(n)
            r = range(start, stop, step)
            axes.append((start, len(r), step, False) if step > 0 else
                        (r[-1] if len(r) else 0, len(r), -step, True))
        elif _is_index(v):
            if not -n <= int(v) < n:
                raise IndexError(f"index {int(v)} is out of bounds for "
                                 f"axis {len(axes)} with size {n}")
            axes.append(int(v) % n)
        else:
            raise TypeError("a ShardedCube's data indexers take integers, "
                            "slices, None and Ellipsis, not "
                            f"{type(v).__name__}")
    return axes, new


class ShardedCube:
    """A cube whose data is sharded over a CubeMesh, running its hot
    operations shard by shard: the analog of the reference's
    ``DaskSpectralCube``.  ``SpectralCube.read(..., use_dask=True)`` and
    ``cube.to_sharded(mesh)`` give one.

    It holds the data as a spatial-layout :class:`ShardedArray`; the mask
    as a mask object, evaluated on each shard as the cube's indexing cuts
    it (``mask[index].include(data=block)``), and/or a sharded include
    array that a sharded operation produced; and a metadata cube (WCS,
    unit, beams, meta; its data a one-value placeholder).

    Shard by shard, each result the unsharded method's: the moments and
    linewidths (the maps cached, the moments kernel once a shard), the
    reductions (``sum``, ``mean``, ``std``, ``max``, ``min``, ``median``,
    ``percentile``, ``mad_std``, ``argmax``, ``argmin``) along any axis,
    ``argmax_world`` / ``argmin_world``, ``statistics``, ``sigma_clip``,
    the spectral smoothing family, ``spatial_smooth`` and the spatial
    median and host filters, ``downsample_axis``,
    ``sigma_clip_spectrally``, ``spectral_interpolate``, ``reproject``
    (every order), ``convolve_to``, the cuts (``spectral_slab``,
    ``subcube``, ``minimal_subcube``, ``subcube_from_mask`` and the region
    cuts), the ``unmasked_data[...]`` / ``filled_data[...]`` indexers,
    ``flattened``, ``apply_everywhere`` and the parallel apply functions,
    the mask and beam edits (``with_mask``, ``mask_channels``,
    ``unmasked_copy``, ``with_beam``, ``with_beams``,
    ``mask_out_bad_beams``), ``to``, ``with_fill_value``,
    ``with_spectral_unit`` and the WCS attributes.  Along the spectral
    axis each tile's whole spectra; over the cube partials reduced over
    the mesh; along a spatial axis each slab of whole planes of the
    spectral layout (all-to-alls).  The calls of :data:`GATHERED` run on
    :attr:`cube`, the cube gathered on the mesh's first device (a counted
    gather; each makes a whole host array, in the JAX package too), and
    a cube they return is sharded again."""

    def __init__(self, cube, cmesh: CubeMesh | None = None):
        if cmesh is not None and not isinstance(cmesh, CubeMesh):
            raise TypeError(f"cmesh must be a CubeMesh, not "
                            f"{type(cmesh).__name__}")
        self.cmesh = cmesh if cmesh is not None else default_mesh()
        if isinstance(cube, ShardedCube):
            data, include = cube._data, cube._include
            if cube.cmesh is not self.cmesh:
                data = self.cmesh.shard(data.gather(), "spatial")
                include = None if include is None else self.cmesh.shard(
                    include.gather(), "spatial")
            self._set(data, cube._template, cube._mask, include)
            return
        template = cube._new_cube_with(
            data=_placeholder(cube.shape, cube._data.dtype,
                              self.cmesh.devices[0]),
            mask=None)
        # a mask bound to the cube's data is evaluated on each shard: the
        # binding would keep the unsharded data alive beside the shards
        self._set(self.cmesh.shard(cube._data, "spatial"), template,
                  unbind_data(cube._mask, cube._data), None)

    def _set(self, data, template, mask, include):
        self._data = data
        self._template = template
        self._mask = mask
        self._include = None if include is None else _match(include, data)
        self._gathered = None
        self._moments = None

    @classmethod
    def _from_parts(cls, cmesh, data, template, mask=None, include=None):
        """A ShardedCube over the ShardedArray ``data`` with the metadata
        cube ``template`` (a readers' and a store's constructor)."""
        out = object.__new__(cls)
        out.cmesh = cmesh
        out._set(data, template, mask, include)
        return out

    def _new(self, data, template=None, mask=None, include=None):
        return ShardedCube._from_parts(
            self.cmesh, data, self._template if template is None
            else template, mask, include)

    def _with_data(self, data):
        """The same mask and metadata over new data of the same shape."""
        return self._new(data, mask=self._mask, include=self._include)

    def _template_like(self, shape, **kwargs):
        t = self._template
        return t._new_cube_with(
            data=_placeholder(shape, t._data.dtype,
                              self.cmesh.devices[0]),
            mask=None, **kwargs)

    # -- the gathered cube and delegation ---------------------------------
    @property
    def cube(self):
        """The cube with its data (and a stored mask) gathered on the
        mesh's first device; each gather adds to the mesh's ``gathers``
        counter, once per ShardedCube."""
        if self._gathered is None:
            data = self._data.gather()
            mask = bind_data(self._mask, data)
            if self._include is not None:
                t = self._template
                stored = BooleanArrayMask(self._include.gather(),
                                          wcs=t._wcs, shape=self.shape)
                mask = stored if mask is None else CompositeMask(
                    stored, mask, "and")
            self._gathered = self._template._new_cube_with(data=data,
                                                           mask=mask)
        return self._gathered

    def __getattr__(self, name):
        """Metadata comes from the metadata cube.  Any other method of the
        cube class is looked up without moving data and runs on the
        gathered cube when called (the :data:`GATHERED` names), a cube it
        returns sharded again (the DaskSpectralCube mirroring of
        SpectralCube); any other property or attribute is read from the
        gathered cube."""
        if name.startswith("__") or name in ("cmesh", "_data", "_template",
                                             "_mask", "_include",
                                             "_gathered", "_moments"):
            raise AttributeError(name)
        if name in _METADATA:
            return getattr(self._template, name)
        static = inspect.getattr_static(self._template, name, _MISSING)
        if static is _MISSING:
            raise AttributeError(f"{type(self).__name__} has no attribute "
                                 f"{name!r}")
        if not inspect.isfunction(static):
            return getattr(self.cube, name)

        @functools.wraps(static)
        def gathered(*args, **kwargs):
            return self._call_gathered(name, *args, **kwargs)
        return gathered

    def _call_gathered(self, name, *args, **kwargs):
        """The cube's method ``name`` called on :attr:`cube` (one counted
        gather); a cube it returns is sharded again."""
        from ..cube import BaseSpectralCube
        out = getattr(self.cube, name)(*args, **kwargs)
        if isinstance(out, BaseSpectralCube):
            return ShardedCube(out, self.cmesh)
        return out

    def __repr__(self):
        return (f"ShardedCube(shape={self.shape}, layout="
                f"{self._data.layout!r}, mesh={self.cmesh.grid})")

    @property
    def shape(self):
        return self._data.shape

    @property
    def allow_huge_operations(self):
        return self._template.allow_huge_operations

    @allow_huge_operations.setter
    def allow_huge_operations(self, value):
        self._template = self._template._new_cube_with()
        self._template.allow_huge_operations = value

    @property
    def base(self):
        """The sharded data (the unsharded cube's ``base`` is its data
        tensor; in the JAX package the sharded array)."""
        return self._data

    @property
    def mask(self):
        """The mask object; with a stored include, a BooleanArrayMask of
        the whole include composed with it, and where it holds a data mask
        bound to no data, that mask bound to the gathered data (a counted
        gather: ``include()`` answers as the JAX package's mask over its
        sharded data does)."""
        if self._include is None and not has_unbound_data(self._mask):
            return self._mask
        return self.cube.mask

    @property
    def unitless(self):
        return self._edit(self._template.unitless)

    @property
    def velocity(self):
        from .. import units as u
        return self.with_spectral_unit(u.km_s, velocity_convention="radio")

    def to_sharded(self, cmesh=None):
        return ShardedCube(self, cmesh)

    def use_dask_scheduler(self, scheduler=None, num_workers=None):
        """API-compat shim for the reference's scheduler selection
        (dask_spectral_cube.py:278-312): the mesh owns the placement; pick
        devices with :func:`~.mesh.use_mesh`.  Returns a null context."""
        from ..utils import NotImplementedWarning
        warnings.warn("use_dask_scheduler has no effect: each shard runs "
                      "on its mesh device; pick a device set with "
                      "use_mesh()", NotImplementedWarning)
        return contextlib.nullcontext(self)

    def display_dask_array(self):
        """Print the layout of the sharded data (the analog of the
        reference's dask-graph display, dask_spectral_cube.py:341): the
        mesh, and each shard's device and index.  Returns the layout."""
        d = self._data
        print(f"shape={d.shape} dtype={d.dtype} mesh={self.cmesh.grid} "
              f"layout={d.layout}")
        for s in d.addressable_shards:
            print(f"  {s.position} {s.device}: "
                  + ", ".join(f"{i.start}:{i.stop}" for i in s.index))
        return d.layout

    display_sharding = display_dask_array

    def rechunk(self, layout="spatial", save_to_tmp_dir=False):
        """Move the data between the mesh layouts (the dask ``rechunk``
        analog, reference dask_spectral_cube.py:349-384).  With
        ``save_to_tmp_dir=True`` the current state is written to a
        temporary store and read back first (the zarr persistence
        analog, :meth:`checkpoint`)."""
        src = self.checkpoint() if save_to_tmp_dir else self
        data = self.cmesh.shard(src._data, layout)
        return src._new(data, mask=src._mask, include=src._include)

    def checkpoint(self, tmp_dir=None):
        """The current (masked) state written to a temporary store, one
        file per distinct block, and read back onto the mesh block by block
        (:func:`~..persistence.checkpoint_to_tmp_dir`): the whole cube
        never lands on the host."""
        from ..persistence import checkpoint_to_tmp_dir
        return checkpoint_to_tmp_dir(self, tmp_dir=tmp_dir)

    # -- masks -------------------------------------------------------------
    def _include_parts(self):
        """The bool include of each block (the stored part, and the mask
        cut to the block's index and evaluated on it), or None where
        nothing is masked."""
        if self._mask is None and self._include is None:
            return None
        blocks = [self._part_include(p, tuple(slice(0, s.stop - s.start)
                                              for s in ix), ix, d)
                  for p, (d, ix) in enumerate(zip(self._data.blocks,
                                                  self._data.index))]
        return ShardedArray(self.cmesh, self._data.layout, self.shape,
                            blocks, self._data.index)

    def _mask_args(self):
        """``(include, mask_expr)`` for the sharded functions: a data-local
        mask alone goes in as the expression each tile evaluates (fused in
        the moments kernel where it can be), anything else as the include
        of each block (the JAX package's split, sharded.py:876-886)."""
        if self._include is None and (self._mask is None
                                      or is_data_local(self._mask)):
            return None, self._mask
        return self._include_parts(), None

    def _filled(self, fill=NAN):
        """The data with excluded voxels set to ``fill``."""
        inc = self._include_parts()
        if inc is None:
            return self._data
        return self._data.map(
            lambda d, i: torch.where(i, d, torch.as_tensor(
                fill, dtype=d.dtype, device=d.device)), inc)

    def _comparison_mask(self, op, value):
        from ..units import Quantity
        if not isinstance(value, Quantity):
            if self.unit.dimensionless:
                value = Quantity(value, "")
            else:
                raise ValueError(
                    "Can only compare with Quantity values with units "
                    "matching the cube's")
        return LazyComparisonMask(op, value.to_value(self.unit),
                                  wcs=self._template._wcs, shape=self.shape)

    def __gt__(self, value):
        return self._comparison_mask(torch.gt, value)

    def __ge__(self, value):
        return self._comparison_mask(torch.ge, value)

    def __lt__(self, value):
        return self._comparison_mask(torch.lt, value)

    def __le__(self, value):
        return self._comparison_mask(torch.le, value)

    def with_mask(self, mask, inherit_mask=True, wcs_tolerance=None):
        """A new ShardedCube with ``mask`` (and the current mask, with
        ``inherit_mask``); a boolean array becomes a BooleanArrayMask.
        Each shard evaluates its cut of the mask on its own data."""
        if isinstance(mask, (np.ndarray, torch.Tensor)):
            mask = BooleanArrayMask(mask, wcs=self._template._wcs,
                                    shape=self.shape)
        self._template._validate_mask_wcs(mask, wcs_tolerance)
        old = self._mask if inherit_mask else None
        return self._new(self._data, include=self._include if inherit_mask
                         else None,
                         mask=mask if old is None else CompositeMask(
                             old, mask, "and"))

    # -- mask, beam and metadata edits: no data moves ------------------------
    def _edit(self, template):
        """The same data over ``template``, a metadata cube that one of the
        template's own methods returned: the mask that method added (a
        channel mask) composed with this cube's, as the unsharded method
        composes it; the stored include kept."""
        added, template._mask = template._mask, None
        mask = self._mask if added is None else added if self._mask is None \
            else CompositeMask(self._mask, added, "and")
        return self._new(self._data, template, mask=mask,
                         include=self._include)

    def mask_channels(self, goodchannels):
        """Mask out the channels where ``goodchannels`` is False (and, for
        a varying-resolution cube, exempt their beams from the checks)."""
        return self._edit(self._template.mask_channels(goodchannels))

    def unmasked_copy(self):
        """The same data with no mask and no stored include."""
        return self._new(self._data)

    def with_beam(self, beam, raise_error_jybm=True):
        return self._edit(self._template.with_beam(
            beam, raise_error_jybm=raise_error_jybm))

    def with_beams(self, beams, goodbeams_mask=None, raise_error_jybm=True):
        return self._edit(self._template.with_beams(
            beams, goodbeams_mask=goodbeams_mask,
            raise_error_jybm=raise_error_jybm))

    def mask_out_bad_beams(self, threshold, reference_beam=None,
                           criteria=("sr", "major", "minor")):
        return self._edit(self._template.mask_out_bad_beams(
            threshold, reference_beam=reference_beam, criteria=criteria))

    def average_beams(self, threshold=None, mask="compute", warn=False):
        """The average of the good beams of the channels that hold an
        included voxel (``mask='compute'``; each block's channel flags
        OR-ed on the host), as the unsharded ``average_beams``."""
        from ..utils import BeamAverageWarning
        t = self._template
        chans = self._channels_included() if mask == "compute" else None
        beam_mask = t._goodbeams_mask if chans is None \
            else chans & t._goodbeams_mask
        if threshold is not None:
            t._check_beam_areas(threshold, mask=beam_mask)
        if warn:
            warnings.warn("Arithmetic beam averaging is being performed.",
                          BeamAverageWarning)
        return t._beams.average_beam(include_mask=beam_mask)

    def sigma_clip(self, threshold):
        """Mask out |data - median| > threshold * mad_std, both tails: the
        sharded ``mad_std()`` and ``median()``, then a comparison mask each
        shard evaluates on its own data."""
        from ..units import Quantity
        s = float(self.mad_std().value)
        med = float(self.median().value)
        lo = Quantity(med - threshold * s, self.unit)
        hi = Quantity(med + threshold * s, self.unit)
        return self.with_mask((self > lo) & (self < hi))

    # -- the blocks the methods run on -----------------------------------
    def _tiles(self, filled=False):
        """Each position's aligned spatial tile (nchan, py, px), NaN past
        the cube, and the include of its values (the stored part and the
        mask evaluated on the tile; None where nothing is masked);
        ``filled`` sets the excluded values to NaN.  No communication."""
        include, expr = self._mask_args()
        tiles, inc, _ = _pad_spatial(self._data, self.cmesh, NAN, include)
        incs = [_include_tile(None if inc is None else inc[p], expr, d)
                for p, d in enumerate(tiles)]
        if filled:
            tiles = [d if i is None else torch.where(i, d, NAN)
                     for d, i in zip(tiles, incs)]
        return tiles, incs

    def _slabs(self, filled=False):
        """Each position's slab of whole planes, cut to the cube (the
        spectral layout: two counted all-to-alls, two more for a stored
        include or a mask that is not data-local), and its include, as
        :meth:`_tiles` gives them."""
        include, expr = self._mask_args()
        slabs = self._slab_parts(self._data, NAN)
        inc = None if include is None else self._slab_parts(include, False)
        incs = [_include_tile(None if inc is None else inc[p], expr, d)
                for p, d in enumerate(slabs)]
        if filled:
            slabs = [d if i is None else torch.where(i, d, NAN)
                     for d, i in zip(slabs, incs)]
        return slabs, incs

    def _slab_parts(self, arr, pad_value):
        """Each position's slab of whole planes of the ShardedArray
        ``arr``, cut to the cube (:func:`_spectral_blocks`)."""
        nchan, ny, nx = self.shape
        blocks = _spectral_blocks(self.cmesh, arr, pad_value)
        cb = blocks[0].shape[0]
        return [b[:max(0, min((p + 1) * cb, nchan) - p * cb), :ny, :nx]
                for p, b in enumerate(blocks)]

    def _from_slabs(self, outs, shape):
        """A spatial-layout ShardedArray of ``shape`` from each slab's
        result (its channels, whole planes): two counted all-to-alls."""
        return self.cmesh.reshard(self.cmesh._from_spectral(outs, shape),
                                  "spatial")

    def _planes_of(self, outs):
        """The (ny, nx) host map assembled from each tile's plane (a 2-D
        assembly, not a counted gather)."""
        return np.asarray(_planes(self.cmesh, outs, self.shape[1:]))

    def _concat(self, outs):
        """Each slab's result stacked along its channels, on the mesh's
        first device."""
        dev = self.cmesh.devices[0]
        return torch.cat([o.to(dev) for o in outs])

    def _channels_included(self):
        """Per channel, whether it holds an included voxel (host bool), or
        None where nothing is masked."""
        inc = self._include_parts()
        if inc is None:
            return None
        out = np.zeros(self.shape[0], bool)
        for b, ix in zip(inc.blocks, inc.index):
            if b.numel():
                out[ix[0]] |= b.flatten(1).any(1).cpu().numpy()
        return out

    def _result_beam(self):
        """The beam of a spectral reduction: the template's, and for a
        varying-resolution cube the average of the good beams of the
        channels that hold an included voxel, with the warning, as the
        unsharded ``average_beams(mask='compute')`` gives it."""
        from ..utils import BeamAverageWarning, NoBeamError
        t = self._template
        chans = self._channels_included() \
            if getattr(t, "_beams", None) is not None else None
        if chans is None:
            return t._result_beam()
        warnings.warn("Arithmetic beam averaging is being performed.",
                      BeamAverageWarning)
        try:
            return t._beams.average_beam(
                include_mask=chans & t._goodbeams_mask)
        except (ValueError, NoBeamError):
            return None

    def _wrap(self, out, axis, unit):
        """A reduction's result as the unsharded ``_reduce`` returns it:
        a Quantity, a Projection carrying :meth:`_result_beam` along the
        spectral axis, or the template's lower-dimensional object."""
        from ..units import Quantity
        from ..lower_dimensional_structures import Projection
        t = self._template
        if axis is None:
            return Quantity(out.item(), unit)
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
        if axis != 0:
            return t._wrap_projection(out, axis, unit)
        meta = {"collapse_axis": 0}
        meta.update(t._meta)
        beam = self._result_beam()
        if beam is not None:
            meta["beam"] = beam
        return Projection(out, unit=unit, wcs=t._wcs.dropaxis(2), meta=meta,
                          header=t._nowcs_header, beam=beam)

    # -- reductions --------------------------------------------------------
    def _reduce(self, name, axis=None, unit=None, **kwargs):
        """The unsharded ``_reduce`` of the reduction ``name`` (sum, mean,
        std, max, min, median, percentile, mad_std), shard by shard:

        - along the spectral axis each tile holds whole spectra: the
          unsharded reduction on each tile, the maps assembled;
        - over the cube (``axis=None``), sums, counts and extremes reduced
          over the mesh, order statistics by :func:`sharded_percentile`'s
          bisection;
        - over the planes (``axis=(1, 2)``), partial spectra of each tile
          reduced over the mesh; order statistics on the slabs below;
        - along a spatial axis each slab of the spectral layout holds
          whole planes: the unsharded reduction on each slab, the maps
          stacked; with the spectral axis too, every slab's partials (or
          its values' bisection, :func:`_lane_select`) over the mesh."""
        t = self._template
        if isinstance(axis, (tuple, list)):
            axis = tuple(sorted(int(a) % 3 for a in axis))
            if axis == (0, 1, 2):
                axis = None
        elif axis is not None:
            axis = int(axis) % 3
        axes = {0, 1, 2} if axis is None else set(np.atleast_1d(axis))
        if 0 in axes and hasattr(t, "_check_beam_areas"):
            t._check_beam_areas()
        unit = unit if unit is not None else t.unit
        q = kwargs.get("q")
        fn = _REDUCERS[name]
        order = name in ("median", "percentile", "mad_std")
        if order:
            _check_orderable(self._data.dtype)
        if axes == {0}:
            tiles, incs = self._tiles()
            out = self._planes_of([fn(d, _red.valid_mask(d, i), axis=axis,
                                      **kwargs)
                                   for d, i in zip(tiles, incs)])
        elif axis is None and order:
            include, expr = self._mask_args()
            if name == "mad_std":
                out = sharded_mad_std(self._data, self.cmesh, include, expr)
            else:
                out = sharded_percentile(self._data, 50.0 if q is None
                                         else q, self.cmesh, include, expr)
        elif axis is None:
            tiles, incs = self._tiles()
            out = _whole_moments(self.cmesh, name, [
                (d, _red.valid_mask(d, i)) for d, i in zip(tiles, incs)],
                **kwargs)
        elif axes == {1, 2} and not order:
            tiles, incs = self._tiles()
            out = _by_lane_tiles(
                lambda parts: _lane_moments(self.cmesh, name, parts,
                                            **kwargs), self.shape[0],
                [(d[0].numel(), functools.partial(_tile_lanes, d, i))
                 for d, i in zip(tiles, incs)])
        elif 0 not in axes:
            slabs, incs = self._slabs()
            out = self._concat([fn(d, _red.valid_mask(d, i), axis=axis,
                                   **kwargs) for d, i in zip(slabs, incs)
                                if d.shape[0]])
        else:
            # (0, 1) or (0, 2): the kept spatial axis is each slab's lanes
            keep = ({1, 2} - axes).pop()
            slabs, incs = self._slabs()
            parts = [(d.shape[0] * d.shape[3 - keep], functools.partial(
                _slab_lanes, d, i, keep, order)) for d, i in zip(slabs, incs)]
            if order:
                out = _by_lane_tiles(
                    lambda p: _lane_order(self.cmesh, name, p, q=q),
                    self.shape[keep], parts)
            else:
                out = _by_lane_tiles(
                    lambda p: _lane_moments(self.cmesh, name, p, **kwargs),
                    self.shape[keep], parts)
        return self._wrap(out, axis, unit)

    def sum(self, axis=None, how=None, **kwargs):
        return self._reduce("sum", axis=axis)

    def mean(self, axis=None, how=None, **kwargs):
        return self._reduce("mean", axis=axis)

    def std(self, axis=None, ddof=0, how=None, **kwargs):
        return self._reduce("std", axis=axis, ddof=ddof)

    def max(self, axis=None, how=None, **kwargs):
        return self._reduce("max", axis=axis)

    def min(self, axis=None, how=None, **kwargs):
        return self._reduce("min", axis=axis)

    def median(self, axis=None, how=None, **kwargs):
        return self._reduce("median", axis=axis)

    def percentile(self, q, axis=None, how=None, **kwargs):
        return self._reduce("percentile", axis=axis, q=q)

    def mad_std(self, axis=None, how=None, **kwargs):
        """mad_std; over the whole cube found over the mesh without moving
        the data (:func:`sharded_mad_std`)."""
        return self._reduce("mad_std", axis=axis)

    def _arg_extremum(self, name, axis):
        """argmax / argmin as the unsharded cube gives them: along an axis
        the unsharded reduction on each tile (spectral) or slab (spatial);
        over the cube each tile's first extremum and its flat index, the
        first in C order of the extremes winning, as ``masked_argmax``
        breaks ties."""
        fn = _red.masked_argmax if name == "argmax" else _red.masked_argmin
        if axis is not None:
            axis = int(axis) % 3
            if axis == 0:
                tiles, incs = self._tiles()
                return self._planes_of([fn(d, _red.valid_mask(d, i), axis=0)
                                        for d, i in zip(tiles, incs)])
            slabs, incs = self._slabs()
            return self._concat([fn(d, _red.valid_mask(d, i), axis=axis)
                                 for d, i in zip(slabs, incs)
                                 if d.shape[0]]).cpu().numpy()
        tiles, incs = self._tiles()
        fill = -math.inf if name == "argmax" else math.inf
        better = (lambda a, b: a > b) if name == "argmax" \
            else (lambda a, b: a < b)
        py, px = tiles[0].shape[1:]
        best = None
        for p, (d, i) in enumerate(zip(tiles, incs)):
            h, w = _tile_extent(self.cmesh, p, self.shape[1:], (py, px))
            if h == 0 or w == 0 or d.shape[0] == 0:
                continue
            vals = torch.where(_red.valid_mask(d, i)[:, :h, :w],
                               d[:, :h, :w], fill).reshape(-1)
            j = int(torch.argmax(vals) if name == "argmax"
                    else torch.argmin(vals))
            c, y, x = np.unravel_index(j, (d.shape[0], h, w))
            iy, ix = divmod(p, self.cmesh.grid[1])
            flat = int(np.ravel_multi_index((c, iy * py + y, ix * px + x),
                                            self.shape))
            v = float(vals[j])
            if best is None or better(v, best[0]) or (
                    v == best[0] and flat < best[1]):
                best = (v, flat)
        return np.unravel_index(best[1] if best else 0, self.shape)

    def argmax(self, axis=None, how=None, **kwargs):
        return self._arg_extremum("argmax", axis)

    def argmin(self, axis=None, how=None, **kwargs):
        return self._arg_extremum("argmin", axis)

    # -- moments -----------------------------------------------------------
    def _moments012(self):
        """(mom0, mom1, mom2) host maps along the spectral axis from one
        sharded pass (the moments kernel once a shard), kept for the
        ShardedCube's life as the unsharded ``_moments012`` is cached."""
        if self._moments is None:
            t = self._template
            include, expr = self._mask_args()
            maps = [np.asarray(m) for m in sharded_moments(
                self._data, t._spectral_offsets(), t._spectral_pix_size(),
                self.cmesh, include=include, mask_expr=expr)]
            maps[1] = maps[1] + float(np.asarray(t.spectral_axis.value)[0])
            self._moments = tuple(maps)
        return self._moments

    def moment_maps(self):
        """(mom0, mom1, mom2) Projections in one sharded pass (the moments
        kernel on each shard)."""
        return tuple(self._moment_projection(m, order, 0, "sharded")
                     for order, m in enumerate(self._moments012()))

    def _moment_projection(self, out, order, axis, how):
        from ..lower_dimensional_structures import Projection
        from ..units import Unit
        t = self._template
        axunit = t.spectral_unit if axis == 0 else Unit.parse("deg")
        unit = t.unit * axunit if order == 0 else axunit ** max(order, 1)
        meta = {"moment_order": order, "moment_axis": axis,
                "moment_method": how}
        meta.update(t._meta)
        beam = self._result_beam() if axis == 0 else None
        if beam is not None:
            meta["beam"] = beam
        return Projection(out, unit=unit, wcs=t._wcs.dropaxis(2 - axis),
                          meta=meta, header=t._nowcs_header, beam=beam)

    def moment(self, order=0, axis=0, how="auto", **kwargs):
        """The unsharded ``moment``: orders 0-2 along the spectral axis
        from the cached moments pass, other orders on each tile, and along
        a spatial axis on each slab of whole planes."""
        from ..utils import VarianceWarning
        t = self._template
        axis = int(axis) % 3
        if axis == 0 and hasattr(t, "_check_beam_areas"):
            t._check_beam_areas()
        if axis == 0 and order == 2:
            warnings.warn("Note that the second moment returned will be a "
                          "variance map. To get a linewidth map, use the "
                          "SpectralCube.linewidth_fwhm() or "
                          "SpectralCube.linewidth_sigma() methods instead.",
                          VarianceWarning)
        if axis == 0 and order in (0, 1, 2):
            out = self._moments012()[order]
        else:
            coords, dx = t._moment_coords(axis)
            parts, incs = self._tiles() if axis == 0 else self._slabs()
            outs = [_mom.moment_generic(d, coords, dx, order, axis=axis,
                                        include=i)
                    for d, i in zip(parts, incs) if axis == 0 or d.shape[0]]
            out = self._planes_of(outs) if axis == 0 \
                else self._concat(outs).cpu().numpy()
        return self._moment_projection(out, order, axis, how)

    def moment0(self, axis=0, how="auto", **kwargs):
        return self.moment(order=0, axis=axis, how=how, **kwargs)

    def moment1(self, axis=0, how="auto", **kwargs):
        return self.moment(order=1, axis=axis, how=how, **kwargs)

    def moment2(self, axis=0, how="auto", **kwargs):
        return self.moment(order=2, axis=axis, how=how, **kwargs)

    def linewidth_sigma(self, how="auto"):
        """sqrt(moment2) (reference spectral_cube.py:1746-1755)."""
        from ..lower_dimensional_structures import Projection
        from ..utils import VarianceWarning
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", VarianceWarning)
            mom2 = self.moment(order=2, axis=0, how=how)
        with np.errstate(invalid="ignore"):
            vals = np.sqrt(np.asarray(mom2.value))
        return Projection(vals, unit=self._template.spectral_unit,
                          wcs=mom2.wcs, meta=mom2.meta, header=mom2._header,
                          beam=mom2._beam)

    def linewidth_fwhm(self, how="auto"):
        from ..lower_dimensional_structures import Projection
        sig = self.linewidth_sigma(how=how)
        return Projection(np.asarray(sig.value) * _mom.SIGMA2FWHM, unit=sig.unit,
                          wcs=sig.wcs, meta=sig.meta, header=sig._header,
                          beam=sig._beam)

    def statistics(self):
        """Global statistics (CASA ``ia.statistics`` naming) reduced over
        the mesh."""
        from ..units import Quantity
        include, expr = self._mask_args()
        raw = sharded_statistics(self._data, self.cmesh, include=include,
                                 mask_expr=expr)
        unit = self._template.unit
        out = {"npts": raw["npts"]}
        for k in ("min", "max", "sum", "mean", "sigma", "rms"):
            out[k] = Quantity(raw[k], unit)
        out["sumsq"] = Quantity(raw["sumsq"], unit ** 2)
        return out

    def sigma_clip_spectrally(self, threshold, maxiters=5,
                              cenfunc="median", stdfunc="std"):
        out = sharded_sigma_clip(self._filled(), self.cmesh, sigma=threshold,
                                 maxiters=maxiters, cenfunc=cenfunc,
                                 stdfunc=stdfunc)
        return self._with_data(out)

    def spatial_smooth(self, kernel):
        karr = np.asarray(getattr(kernel, "array", kernel), dtype=float)
        return self._with_data(sharded_spatial_convolve(
            self._filled(), karr, self.cmesh))

    def spectral_interpolate(self, spectral_grid, smooth_kernel=None):
        """Regrid onto a new linear spectral grid shard by shard (the
        smooth_interp kernel with ``smooth_kernel``).  Under a data-local
        mask other than the finiteness one the smooth must re-evaluate the
        mask on the smoothed data, as the unsharded call does it: each
        tile smooths its whole spectra, evaluates the mask on them and
        interpolates the data and that include."""
        from ..units import Quantity
        from ..ops.interpolate import linear_spectral_wcs
        t = self._template
        grid = spectral_grid.to_value(t.spectral_unit) \
            if isinstance(spectral_grid, Quantity) \
            else np.asarray(spectral_grid)
        inax = np.asarray(t.spectral_axis.value, dtype=float)
        new_wcs = linear_spectral_wcs(t._wcs, grid)
        mask = self._mask
        template = self._template_like((len(grid),) + self.shape[1:],
                                       wcs=new_wcs)
        if smooth_kernel is not None:
            karr = np.asarray(getattr(smooth_kernel, "array",
                                      smooth_kernel), dtype=float)
            finiteness = self._include is None and (
                mask is None or is_finiteness_mask(mask))
            if not finiteness and self._include is None \
                    and is_data_local(mask):
                from ..ops.interpolate import interp_cube_spectral
                from ..ops.smoothing import spectral_smooth_cube
                tiles, _ = self._tiles(filled=True)
                res = []
                for d in tiles:
                    sm = spectral_smooth_cube(d, karr)
                    res.append(interp_cube_spectral(
                        sm, inax, grid, include=mask.include(data=sm,
                                                             wcs=t._wcs)))
                del tiles
                out, new_include = (self.cmesh._from_spatial(
                    [r[i] for r in res], template.shape) for i in (0, 1))
                return self._new(out, template, include=new_include)
            include = None if finiteness else self._include_parts()
            out, new_include = sharded_smooth_interpolate(
                self._filled(), karr, inax, grid, self.cmesh,
                include=include)
            if finiteness:
                # the re-bound finiteness mask tracks the fused result
                return self._new(out, template, mask=LazyMask(
                    torch.isfinite, wcs=new_wcs, shape=out.shape))
            return self._new(out, template, include=new_include)
        # RAW data, not filled: masked voxels must not poison neighbours;
        # the mask interpolates separately (the unsharded semantics)
        out, new_include = sharded_spectral_interpolate(
            self._data, inax, grid, self.cmesh,
            include=self._include_parts())
        return self._new(out, template, include=new_include)

    def reproject(self, header, order="bilinear", use_memmap=False,
                  filled=True, **kwargs):
        """Sharded reprojection onto a new spatial (and spectral) WCS:
        the mappings are the unsharded ``cube.reproject``'s, then
        :func:`sharded_reproject` resamples (the halo strategy for
        axis-aligned mappings within a tile's reach, the reshard
        otherwise); the spline orders (2/3) through
        :func:`sharded_spline_reproject`."""
        from ..ops.regrid import reproject_mappings, _order_int
        t = self._template
        order = _order_int(order)
        data = self._filled() if filled else self._data
        zs, ys, xs, wcs_out = reproject_mappings(
            t._wcs, header, self.shape[0],
            spectral_values_in=np.asarray(t.spectral_axis.value))
        resample = sharded_spline_reproject if order >= 2 \
            else sharded_reproject
        out = resample(data, zs, ys, xs, self.cmesh, order=order)
        template = t.__class__(
            data=_placeholder(out.shape, t._data.dtype,
                              self.cmesh.devices[0]),
            wcs=wcs_out, meta=dict(t._meta), unit=t._unit,
            fill_value=t._fill_value,
            allow_huge_operations=t.allow_huge_operations)
        return self._new(out, template, include=out.map(_red.finite))

    def convolve_to(self, beam, allow_smaller=False, **kwargs):
        """Common-beam convolution: the halo-exchange separable route
        (conv_sep per shard, no all-to-all) where every beam group's
        kernel separates (rank <= 8 for one group, <= 4 for several) and
        its half-width fits a tile, else the reshard + FFT route.  A
        varying-resolution cube's flagged channels are NaN and its beams
        checked as the unsharded ``convolve_to`` does; returns a
        single-beam cube."""
        from ..ops import convolve as _conv
        from ..beams import BeamError
        from ..utils import NoBeamError
        from ..cube import SpectralCube
        t = self._template
        nchan, ny, nx = self.shape
        beams = getattr(t, "_beams", None)
        good = None
        if beams is not None:
            good = np.asarray(t._goodbeams_mask, dtype=bool)
            beam_list = [b if g else beam for b, g in zip(beams, good)]

            def deconvolvable(b):
                try:
                    beam.deconvolve(b)
                    return True
                except BeamError:
                    if not allow_smaller:
                        raise
                    return False
            beam_list = [b if not g or deconvolvable(b) else beam
                         for b, g in zip(beam_list, good)]
        else:
            if getattr(t, "_beam", None) is None:
                raise NoBeamError("The cube has no beam; use with_beam "
                                  "first")
            beam_list = [t._beam] * nchan
        pixscale = float(np.mean(np.abs(
            t._wcs.celestial.proj_plane_pixel_scales()))) * np.pi / 180.0
        groups, group_idx = _conv.beam_groups(beam_list)
        kernels, max_k = [], (1, 1)
        for b in groups:
            cb = beam.deconvolve(b)
            if cb.major_rad <= 0:
                kernels.append(None)
                continue
            k = cb.as_kernel(pixscale)
            kernels.append(k)
            max_k = (max(max_k[0], k.shape[0]), max(max_k[1], k.shape[1]))
        filled = self._filled()
        # one beam group separates up to rank 8, several up to rank 4: the
        # unsharded route's rule (ops/convolve.convolve_cube_to_beam), so
        # that both run conv_sep on the same taps
        out = sharded_convolve_per_channel_separable(
            filled, kernels, group_idx, self.cmesh,
            max_rank=8 if len(groups) == 1 else 4)
        if out is None:
            my, mx = self.cmesh.grid
            fy, fx = _conv._padded_shape((ny + (-ny) % my, nx + (-nx) % mx),
                                         max_k)
            out = _fft_convolve(
                filled, group_idx, self.cmesh, fy, fx,
                lambda g, dev, dt: _conv._transfers(
                    [kernels[i] for i in g], fy, fx, dev, dt))
        del filled
        # the Jy/beam factors and the flagged planes written in place on
        # the convolution's own output blocks (the unsharded cube's)
        from ..cube import _rescaled
        factors = np.array([_conv.beam_unit_factor(t.unit, b, beam)
                            for b in beam_list])
        bad = None if good is None else np.flatnonzero(~good)
        for d in out.blocks:
            _rescaled(d, factors, None)
            if bad is not None and bad.size:
                d.index_fill_(0, torch.as_tensor(bad, device=d.device), NAN)
        meta = dict(t._meta)
        meta["beam"] = beam
        template = SpectralCube(
            data=_placeholder(self.shape, t._data.dtype,
                              self.cmesh.devices[0]),
            wcs=t._wcs, meta=meta, fill_value=t._fill_value, unit=t._unit,
            beam=beam, allow_huge_operations=t.allow_huge_operations)
        return self._new(out, template, mask=self._mask,
                         include=self._include)

    # -- metadata and element-wise steps: no exchange -----------------------
    def with_fill_value(self, fill_value):
        return self._new(self._data, self._template.with_fill_value(
            fill_value), mask=self._mask, include=self._include)

    def with_spectral_unit(self, unit, velocity_convention=None,
                           rest_value=None):
        """The spectral axis converted (the template's WCS); the data as it
        is."""
        return self._new(self._data, self._template.with_spectral_unit(
            unit, velocity_convention=velocity_convention,
            rest_value=rest_value), mask=self._mask, include=self._include)

    def to(self, unit, equivalencies=()):
        """Brightness-unit conversion: each block times the unsharded
        call's factor, per channel where the conversion needs it
        (``cube_utils.bunit_converters`` of the template).  No block
        leaves its device, so the unsharded call's guard on huge cubes
        does not apply."""
        from ..cube_utils import bunit_converters
        from ..units import Unit
        unit = Unit.parse(unit) if isinstance(unit, str) else unit
        factors = bunit_converters(self._template, unit,
                                   equivalencies=equivalencies)
        d = self._data
        if factors.size == 1:
            blocks = [b * float(factors[0]) for b in d.blocks]
        else:
            blocks = [b * torch.as_tensor(factors[ix[0]], dtype=b.dtype,
                                          device=b.device)[:, None, None]
                      for b, ix in zip(d.blocks, d.index)]
        return self._new(ShardedArray(self.cmesh, d.layout, d.shape, blocks,
                                      d.index),
                         self._template_like(self.shape, unit=unit),
                         mask=self._mask, include=self._include)

    def _template_view(self, view, raw_view):
        """The template cut by the slices ``view`` (canonical, step 1), as
        the unsharded ``__getitem__`` cuts a cube: the WCS, the beams of a
        varying-resolution cube, ``meta['slice']`` (of ``raw_view`` where
        the unsharded base class records the view as given)."""
        t = self._template
        shape = tuple(s.stop - s.start for s in view)
        kw = {}
        if getattr(t, "_beams", None) is not None:
            kw = {"beams": t._beams[view[0]],
                  "goodbeams_mask": t._goodbeams_mask[view[0]]}
            raw_view = view
        meta = dict(t._meta)
        meta["slice"] = [(v.start, v.stop, v.step) for v in raw_view]
        return t._new_cube_with(
            data=_placeholder(shape, t._data.dtype,
                              self.cmesh.devices[0]),
            wcs=t._wcs.slice(view, shape=self.shape), mask=None, meta=meta,
            **kw)

    def _cut(self, raw_view):
        """The cube cut by a view of unit-step slices, as ``cube[view]``:
        a channel range in the spatial layout, each block its own
        channels (no exchange); a spatial box by :func:`_crop`, each block
        of the box assembled from the parts of the blocks that overlap it
        (only the box's bytes move, no all-to-all)."""
        from ..cube_utils import canon_view
        view = canon_view(tuple(raw_view) + (slice(None),) * (
            3 - len(raw_view)), self.shape)
        if any(v.step != 1 for v in view):
            raise ValueError("a ShardedCube is cut by unit-step slices")
        (c0, c1), (y0, y1), (x0, x1) = [(v.start, max(v.start, v.stop))
                                        for v in view]
        view = tuple(slice(a, b, 1) for a, b in ((c0, c1), (y0, y1),
                                                  (x0, x1)))
        nchan, ny, nx = self.shape
        cmesh = self.cmesh

        def cut(arr, pad):
            if arr is None:
                return None
            if (y0, y1, x0, x1) != (0, ny, 0, nx):
                return _crop(arr, view)
            if (c0, c1) == (0, nchan):
                return arr
            tiles = cmesh._tile(arr, "spatial", pad)
            return cmesh._from_spatial([t[c0:c1] for t in tiles],
                                       (c1 - c0, ny, nx))
        return self._new(cut(self._data, 0.0),
                         self._template_view(view, raw_view),
                         mask=None if self._mask is None
                         else self._mask[view],
                         include=cut(self._include, False))

    def spectral_slab(self, lo, hi):
        """The channel range covering [lo, hi] (the unsharded
        ``spectral_slab``): each block keeps its own channels."""
        t = self._template
        ilo = t.closest_spectral_channel(lo)
        ihi = t.closest_spectral_channel(hi)
        if ilo > ihi:
            ilo, ihi = ihi, ilo
        return self._cut((slice(ilo, ihi + 1), slice(None), slice(None)))

    def minimal_subcube(self, spatial_only=False):
        """The bounding box of the included voxels (the unsharded
        ``minimal_subcube``): each block's any() profiles, combined on the
        host, then :meth:`_cut`."""
        if self._mask is None and self._include is None:
            return self._cut((slice(None),) * 3)
        return self._cut(self._bounding_slices(spatial_only))

    def subcube_slices_from_mask(self, region_mask, spatial_only=False):
        """The bounding-box slices of ``region_mask``'s included region,
        the mask evaluated on each block."""
        return self._new(self._data, mask=region_mask)._bounding_slices(
            spatial_only)

    def subcube_from_mask(self, region_mask):
        return self.with_mask(region_mask).minimal_subcube()

    def subcube(self, xlo="min", xhi="max", ylo="min", yhi="max", zlo="min",
                zhi="max", rest_value=None):
        """Cut by pixel or world bounds: the unsharded call's slices from
        the template's WCS, then :meth:`_cut`."""
        from ..cube import _subcube_view
        return self._cut(_subcube_view(self._template, xlo, xhi, ylo, yhi,
                                       zlo, zhi))

    def subcube_from_regions(self, region_list, allow_empty=False,
                             minimize=True):
        """Cut by :class:`~..region.Region` objects: ``region._extract`` on
        this cube (its ``spectral_slab``, ``with_mask`` and
        ``minimal_subcube``)."""
        from ..region import subcube_from_regions
        return subcube_from_regions(self, region_list,
                                    allow_empty=allow_empty,
                                    minimize=minimize)

    def subcube_from_ds9region(self, ds9_region, allow_empty=False):
        from ..region import subcube_from_ds9region
        return subcube_from_ds9region(self, ds9_region,
                                      allow_empty=allow_empty)

    def subcube_from_crtfregion(self, crtf_region, allow_empty=False):
        from ..region import subcube_from_crtfregion
        return subcube_from_crtfregion(self, crtf_region,
                                       allow_empty=allow_empty)

    def _bounding_slices(self, spatial_only):
        """The slices of the bounding box of the included voxels: each
        block's any() profiles along the three axes, its include
        evaluated a few channels at a time (:func:`_channel_chunks`), OR-ed
        on the host (an empty axis gives slice(0, 0))."""
        profiles = [np.zeros(n, bool) for n in self.shape]
        full = [(0, n, 1, False) for n in self.shape]
        for p, local, glob, place in self._view_parts(full):
            chans, plane = [], False
            for lc, gc, _ in _channel_chunks(local, glob, place):
                d = self._data.blocks[p][lc]
                b = self._part_include(p, lc, gc, d)
                chans.append(b.flatten(1).any(1))
                plane = b.any(0) | plane
            for ax, prof in enumerate((torch.cat(chans), plane.any(1),
                                       plane.any(0))):
                profiles[ax][glob[ax]] |= prof.cpu().numpy()
        slices = []
        for ax, prof in enumerate(profiles):
            w = np.flatnonzero(prof)
            if not w.size:
                slices.append(slice(0, 0))
            elif spatial_only and ax == 0:
                slices.append(slice(None))
            else:
                slices.append(slice(int(w[0]), int(w[-1]) + 1))
        return tuple(slices)

    # -- the data indexers and host results, from the shards a view meets --
    def _view_parts(self, axes):
        """Each block's part of the view ``axes`` (:func:`_view_axes`):
        ``(p, local, glob, place)``, the part's index into block ``p``, its
        index into the cube (unit or positive steps, every axis kept) and
        its place in the view's result taken in ascending order.  A block
        the view misses gives nothing; blocks that repeat an index (an
        axis the mesh does not divide is whole on each) give it once."""
        seen = set()
        for p, ix in enumerate(self._data.index):
            key = tuple((s.start, s.stop) for s in ix)
            if key in seen:
                continue
            seen.add(key)
            local, glob, place = [], [], []
            for a, s in zip(axes, ix):
                if isinstance(a, int):
                    lo, k, j0, j1 = a, 1, 0, int(s.start <= a < s.stop)
                else:
                    lo, cnt, k, _ = a
                    # the first and past-the-last j with lo + j*k in the block
                    j0 = max(0, -((lo - s.start) // k))
                    j1 = min(cnt, -((lo - s.stop) // k))
                if j1 <= j0:
                    break
                g0, g1 = lo + j0 * k, lo + (j1 - 1) * k + 1
                local.append(slice(g0 - s.start, g1 - s.start, k))
                glob.append(slice(g0, g1, k))
                place.append(slice(j0, j1))
            else:
                yield p, tuple(local), tuple(glob), tuple(place)

    def _part_include(self, p, local, glob, d):
        """The include of ``d``, block ``p``'s part ``local`` (the cube's
        ``glob``): the stored include cut so, and the mask cut to ``glob``
        and evaluated on ``d``; None where nothing is masked."""
        inc = None if self._include is None else \
            self._include.blocks[p][local]
        if self._mask is not None:
            m = self._mask[glob].include(data=d).to(d.device).expand(d.shape)
            inc = m if inc is None else torch.logical_and(inc, m)
        return inc

    def _view_data(self, view, filled):
        """``data[view]`` (``filled``: excluded voxels set to the fill
        value), a tensor on the mesh's first device assembled from the
        parts of the blocks the view meets; nothing else moves."""
        axes, new = _view_axes(view, self.shape)
        out = torch.empty([1 if isinstance(a, int) else a[1] for a in axes],
                          dtype=self._data.dtype, device=self.cmesh.devices[0])
        fill = self._template._fill_value
        for p, local, glob, place in self._view_parts(axes):
            d = self._data.blocks[p][local]
            inc = self._part_include(p, local, glob, d) if filled else None
            if inc is not None:
                d = torch.where(inc, d, torch.as_tensor(
                    fill, dtype=d.dtype, device=d.device))
            out[place].copy_(d)
        flips = [i for i, a in enumerate(axes)
                 if not isinstance(a, int) and a[3]]
        if flips:
            out = out.flip(flips)
        out = out[tuple(0 if isinstance(a, int) else slice(None)
                        for a in axes)]
        for pos in new:
            out = out.unsqueeze(pos)
        return out

    @property
    def filled_data(self):
        """``filled_data[view]``: a Quantity of the mask-filled data of the
        view, a host array as the unsharded cube's; only the blocks the
        view meets send their part, each with its include evaluated on
        it."""
        from ..cube import _SliceSyntax
        from ..units import Quantity
        return _SliceSyntax(lambda view: Quantity(
            self._view_data(view, True).cpu().numpy(), self.unit))

    @property
    def unmasked_data(self):
        """``unmasked_data[view]``, as :attr:`filled_data` without the
        mask."""
        from ..cube import _SliceSyntax
        from ..units import Quantity
        return _SliceSyntax(lambda view: Quantity(
            self._view_data(view, False).cpu().numpy(), self.unit))

    @property
    def unitless_filled_data(self):
        """``unitless_filled_data[view]``: :attr:`filled_data`'s values as a
        host array."""
        from ..cube import _SliceSyntax
        return _SliceSyntax(lambda view: self._view_data(view, True)
                            .cpu().numpy())

    @warn_slow
    def flattened(self, slice=(), weights=None):
        """1-D host Quantity of the included values of the view ``slice``
        in C order (times ``weights`` cut by the same view and mask): each
        block compacts its part's included values with their flat
        positions in the view, and the pieces merge in that order."""
        from ..units import Quantity
        axes, _ = _view_axes(slice, self.shape)
        kept = [i for i, a in enumerate(axes) if not isinstance(a, int)]
        strides = np.cumprod([1] + [axes[i][1] for i in kept[:0:-1]])[::-1]
        w = None if weights is None else np.broadcast_to(
            np.asarray(weights), self.shape)
        dev = self.cmesh.devices[0]
        vals, pos = [], []
        for p, *part in self._view_parts(axes):
            for local, glob, place in _channel_chunks(*part):
                d = self._data.blocks[p][local]
                inc = self._part_include(p, local, glob, d)
                if inc is None:
                    inc = torch.ones(d.shape, dtype=torch.bool,
                                     device=d.device)
                flat = torch.zeros((), dtype=torch.int64, device=d.device)
                for i, stride in zip(kept, strides):
                    _, cnt, _, flip = axes[i]
                    j = torch.arange(place[i].start, place[i].stop,
                                     device=d.device)
                    shape = [1, 1, 1]
                    shape[i] = -1
                    flat = flat + ((cnt - 1 - j) if flip else j).reshape(
                        shape) * int(stride)
                nz = torch.nonzero(inc, as_tuple=True)
                v = d[nz]
                if w is not None:
                    v = v * torch.as_tensor(np.ascontiguousarray(
                        w[glob])).to(d.device)[nz]
                vals.append(v.to(dev))
                pos.append(flat.expand(d.shape)[nz].to(dev))
        if not vals:
            # a view that selects nothing: the values' type, as unsharded
            out = self._data.blocks[0].reshape(-1)[:0].cpu().numpy()
            return Quantity(out if w is None else out * w.reshape(-1)[:0],
                            self.unit)
        out = torch.cat(vals)[torch.argsort(torch.cat(pos))]
        return Quantity(out.cpu().numpy(), self.unit)

    def apply_function(self, function, axis=None, weights=None, unit=None,
                       projection=False, progressbar=False,
                       update_function=None, keep_shape=False, **kwargs):
        """``axis=None``: ``function`` of :meth:`flattened` (``weights``
        ignored, as the unsharded call ignores them).  Along an axis the
        unsharded host loop over every ray, on the gathered cube."""
        from ..units import Quantity
        if axis is not None:
            return self._call_gathered(
                "apply_function", function, axis=axis, weights=weights,
                unit=unit, projection=projection, progressbar=progressbar,
                update_function=update_function, keep_shape=keep_shape,
                **kwargs)
        out = function(self.flattened(), **kwargs)
        return Quantity(out, unit) if unit is not None else out

    def _argmaxmin_world(self, axis, method):
        """World coordinate of the maximum or minimum along ``axis``: the
        sharded arg-extremum and any-valid plane (each tile's whole spectra
        along the spectral axis, each slab's whole planes along a spatial
        one), then the template's ``world_take_along_axis``."""
        from ..cube_utils import world_take_along_axis
        from ..lower_dimensional_structures import (Projection,
                                                    LowerDimensionalObject)
        from ..utils import WCSCelestialError
        t = self._template
        if t._wcs.is_pixel_axis_correlated(2 - axis):
            raise WCSCelestialError(
                f"{method}_world requires the celestial axes to be "
                "aligned along image axes.")
        idx = self._arg_extremum(method, axis)
        if axis == 0:
            tiles, incs = self._tiles()
            any_valid = self._planes_of([_red.valid_mask(d, i).any(0)
                                         for d, i in zip(tiles, incs)])
        else:
            slabs, incs = self._slabs()
            any_valid = self._concat([_red.valid_mask(d, i).any(axis)
                                      for d, i in zip(slabs, incs)
                                      if d.shape[0]]).cpu().numpy()
        out = world_take_along_axis(t, idx, axis)
        vals = np.asarray(out.value, dtype=float).copy()
        vals[~any_valid] = np.nan
        meta = {"collapse_axis": axis}
        meta.update(t._meta)
        new_wcs = t._wcs.dropaxis(2 - axis)
        cls = Projection if axis == 0 else LowerDimensionalObject
        return cls(vals, unit=out.unit, wcs=new_wcs, meta=meta,
                   header=t._nowcs_header)

    def argmax_world(self, axis=0, **kwargs):
        return self._argmaxmin_world(axis, "argmax")

    def argmin_world(self, axis=0, **kwargs):
        return self._argmaxmin_world(axis, "argmin")

    # -- element-wise and per-spectrum / per-plane functions ----------------
    def apply_everywhere(self, function, *args, check_units=True):
        """An element-wise ``function`` of the NaN-filled data, block by
        block (no block leaves its device, so the unsharded call's guard
        on huge cubes does not apply); the function gets a Quantity whose
        value is the block."""
        from ..units import Quantity, Unit
        filled = self._filled()
        if not check_units:
            outs = [function(d, *args) for d in filled.blocks]
            unit = self._template.unit
        else:
            try:
                test = function(Quantity(np.ones((1, 1, 1)), self.unit),
                                *args)
            except Exception as exc:
                raise ValueError(f"function {function} does not accept "
                                 f"Quantity input: {exc}")
            outs = [function(Quantity(d, self.unit), *args)
                    for d in filled.blocks]
            unit = outs[0].unit if isinstance(outs[0], Quantity) else (
                test.unit if isinstance(test, Quantity) else Unit.parse(""))
            outs = [getattr(o, "value", o) for o in outs]
        d = self._data
        return self._new(ShardedArray(self.cmesh, d.layout, d.shape, outs,
                                      d.index),
                         self._template_like(self.shape, unit=unit),
                         mask=self._mask, include=self._include)

    def _applied(self, out, return_new_cube):
        """The result of a parallel apply function: the ShardedArray, or a
        cube of it (the same mask; the stored include where the shape
        holds)."""
        if not return_new_cube:
            return out
        if out.shape == self.shape:
            return self._with_data(out)
        return self._new(out, self._template_like(out.shape), mask=self._mask)

    @_tmp_dir_option
    def apply_function_parallel_spectral(self, function, *args,
                                         accepts_chunks=False,
                                         return_new_cube=True,
                                         use_memmap=None, parallel=None,
                                         num_cores=None, verbose=0,
                                         progressbar=False,
                                         update_function=None, **kwargs):
        """``function`` of every spectrum of the NaN-filled data, tile by
        tile (each tile holds whole spectra): ``torch.func.vmap`` over the
        tile's spaxels, or, for a function that cannot be vmapped, per
        spectrum on the host; the output's channel count follows the
        function.  A function that takes ``block_info`` gets the whole
        cube's, as in the unsharded call.  ``accepts_chunks=True`` hands
        the function the whole cube (gathered).  ``return_new_cube=False``
        returns the output as a spatial-layout ShardedArray, where the
        unsharded call returns a tensor."""
        from ..cube import (_as_tensor, _check_parallel_options,
                            _engine_kwargs, _vmapped)
        if accepts_chunks:
            return self._call_gathered(
                "apply_function_parallel_spectral", function, *args,
                accepts_chunks=True, return_new_cube=return_new_cube,
                parallel=parallel, num_cores=num_cores, **kwargs)
        _check_parallel_options(parallel, num_cores)
        kwargs = _engine_kwargs(function, self.shape, kwargs)
        tiles, _ = self._tiles(filled=True)
        outs, extents = [], []
        for p, t in enumerate(tiles):
            h, w = _tile_extent(self.cmesh, p, self.shape[1:], t.shape[1:])
            extents.append((h, w))
            if h == 0 or w == 0:
                outs.append(None)
                continue
            d = t[:, :h, :w]
            nchan = d.shape[0]
            out = _vmapped(lambda spec: function(spec, *args, **kwargs),
                           d.reshape(nchan, h * w), 1, 1)
            if out is not None:
                out = out.reshape(out.shape[0], h, w)
            else:
                out = _as_tensor(np.apply_along_axis(
                    lambda spec: np.asarray(function(spec, *args, **kwargs)),
                    0, d.cpu().numpy()), d.device)
            outs.append(out)
        ref = next(o for o in outs if o is not None)
        outs = [o if o is not None else torch.empty(
            (ref.shape[0],) + e, dtype=ref.dtype, device=t.device)
            for o, e, t in zip(outs, extents, tiles)]
        return self._applied(self.cmesh._from_spatial(
            outs, (ref.shape[0],) + tuple(self.shape[1:])), return_new_cube)

    @_tmp_dir_option
    def apply_function_parallel_spatial(self, function, *args,
                                        accepts_chunks=False,
                                        return_new_cube=True,
                                        use_memmap=None, parallel=None,
                                        num_cores=None, verbose=0,
                                        progressbar=False,
                                        update_function=None, **kwargs):
        """``function`` of every channel map of the NaN-filled data, slab
        by slab of whole planes (the spectral layout: four all-to-alls),
        vmapped over each slab's channels (per plane on the host for a
        function that cannot be vmapped), with the options and the result
        types of :meth:`apply_function_parallel_spectral`."""
        from ..cube import (_as_tensor, _check_parallel_options,
                            _engine_kwargs, _vmapped)
        if accepts_chunks:
            return self._call_gathered(
                "apply_function_parallel_spatial", function, *args,
                accepts_chunks=True, return_new_cube=return_new_cube,
                parallel=parallel, num_cores=num_cores, **kwargs)
        _check_parallel_options(parallel, num_cores)
        kwargs = _engine_kwargs(function, self.shape, kwargs)
        slabs, _ = self._slabs(filled=True)
        outs = []
        for s in slabs:
            if not s.shape[0]:
                outs.append(None)
                continue
            out = _vmapped(lambda img: function(img, *args, **kwargs), s,
                           0, 0)
            if out is None:
                arr = s.cpu().numpy()
                out = _as_tensor(np.stack([
                    np.asarray(function(arr[i], *args, **kwargs))
                    for i in range(arr.shape[0])]), s.device)
            outs.append(out)
        ref = next(o for o in outs if o is not None)
        outs = [o if o is not None else torch.empty(
            (0,) + tuple(ref.shape[1:]), dtype=ref.dtype, device=s.device)
            for o, s in zip(outs, slabs)]
        return self._applied(self._from_slabs(
            outs, (self.shape[0],) + tuple(ref.shape[1:])), return_new_cube)

    # -- the spectral smoothing family: each tile's whole spectra ----------
    def _check_spectral_smoothing(self, method):
        """A varying-resolution cube refuses spectral smoothing: the
        template's method raises as the unsharded cube's does."""
        if getattr(self._template, "_beams", None) is not None:
            getattr(self._template, method)()

    def _per_tile(self, fn):
        """``fn`` of each NaN-filled tile, a cube of the same shape: the
        same mask and include over the new data."""
        tiles, _ = self._tiles(filled=True)
        return self._with_data(self.cmesh._from_spatial(
            [fn(t) for t in tiles], self.shape))

    @_tmp_dir_option
    def spectral_smooth(self, kernel, convolve=None, verbose=0,
                        parallel=None, num_cores=None, **kwargs):
        """Smooth along the spectral axis (the unsharded
        ``ops/smoothing.spectral_smooth_cube``) tile by tile."""
        from ..cube import _check_parallel_options, _kernel_array
        from ..ops.smoothing import spectral_smooth_cube
        self._check_spectral_smoothing("spectral_smooth")
        _check_parallel_options(parallel, num_cores)
        karr = _kernel_array(kernel)
        return self._per_tile(lambda t: spectral_smooth_cube(t, karr))

    @_tmp_dir_option
    def spectral_smooth_median(self, ksize, raise_error_jybm=True,
                               parallel=None, num_cores=None,
                               update_function=None, **kwargs):
        """Median filter along the spectral axis tile by tile; the
        progress hook once a spaxel of the cube."""
        from ..cube import _check_parallel_options
        from ..ops.smoothing import spectral_median_filter_cube
        t = self._template
        t._check_jybeam_smoothing(raise_error_jybm)
        _check_parallel_options(parallel, num_cores)
        out = self._per_tile(lambda d: spectral_median_filter_cube(d, ksize))
        t._call_per_spaxel(update_function)
        return out

    @_tmp_dir_option
    def spectral_filter(self, ksize, filter, parallel=None, num_cores=None,
                        use_memmap=None, update_function=None, **kwargs):
        """A scipy-style filter along the spectral axis on the host, one
        tile at a time; the progress hook once a spaxel of the cube."""
        from ..cube import _as_tensor, _check_parallel_options
        _check_parallel_options(parallel, num_cores)
        out = self._per_tile(lambda d: _as_tensor(filter(
            d.cpu().numpy(), size=(ksize, 1, 1), **kwargs), d.device))
        self._template._call_per_spaxel(update_function)
        return out

    # -- the spatial axes: each slab's whole planes -------------------------
    def _per_slab(self, fn):
        """``fn`` of each NaN-filled slab of whole planes, a cube of the
        same shape: the same mask and include over the new data (four
        counted all-to-alls)."""
        slabs, _ = self._slabs(filled=True)
        return self._with_data(self._from_slabs([fn(s) for s in slabs],
                                                self.shape))

    def spatial_smooth_median(self, ksize, raise_error_jybm=True, **kwargs):
        """Median filter of each channel map (reflected at the cube's
        border, as the unsharded call), slab by slab."""
        from ..ops.smoothing import spatial_median_filter_cube
        self._template._check_jybeam_smoothing(raise_error_jybm)
        return self._per_slab(lambda d: spatial_median_filter_cube(d, ksize))

    @_tmp_dir_option
    def spatial_filter(self, ksize, filter, raise_error_jybm=True,
                       parallel=None, num_cores=None, use_memmap=None,
                       update_function=None, **kwargs):
        """A scipy.ndimage filter over each spatial plane on the host, one
        slab at a time; the progress hook once a channel."""
        from ..cube import _as_tensor, _check_parallel_options
        self._template._check_jybeam_smoothing(raise_error_jybm)
        _check_parallel_options(parallel, num_cores)
        ky, kx = (ksize, ksize) if np.isscalar(ksize) else tuple(ksize)
        out = self._per_slab(lambda d: _as_tensor(filter(
            d.cpu().numpy(), size=(1, ky, kx), **kwargs), d.device))
        if update_function is not None:
            for _ in range(int(self.shape[0])):
                update_function()
        return out

    @_tmp_dir_option
    def downsample_axis(self, factor, axis, estimator="mean", truncate=False,
                        use_memmap=None, progressbar=None):
        """Block-downsample (the unsharded ``downsample_axis``): along the
        spectral axis tile by tile, along a spatial axis slab by slab; a
        mask becomes the block-any of its include, stored sharded."""
        from ..ops.interpolate import downsample_axis, downsample_include
        axis = int(axis) % 3
        parts, incs = self._tiles(filled=True) if axis == 0 \
            else self._slabs(filled=True)
        outs = [downsample_axis(d, factor, axis, estimator=estimator,
                                truncate=truncate) for d in parts]
        shape = list(self.shape)
        shape[axis] = outs[0].shape[axis]
        shape = tuple(shape)
        masked = self._mask is not None or self._include is not None
        if masked:
            raw = self._include_parts()
            inc = [downsample_include(i, factor, axis, truncate=truncate)
                   for i in (_pad_spatial(raw, self.cmesh, False)[0]
                             if axis == 0 else self._slab_parts(raw, False))]
        assemble = (lambda o: self.cmesh._from_spatial(o, shape)) \
            if axis == 0 else (lambda o: self._from_slabs(o, shape))
        view = [slice(None)] * 3
        view[axis] = slice(None, None, int(factor))
        t = self._template
        template = self._template_like(shape, wcs=t._wcs.slice(
            tuple(view), shape=self.shape))
        return self._new(assemble(outs), template,
                         include=assemble(inc) if masked else None)
