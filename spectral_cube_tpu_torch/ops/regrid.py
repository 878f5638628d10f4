"""Reprojection onto a new WCS, and the fused convolve + reproject.

Port of ``spectral_cube_tpu/ops/regrid.py``.  The
target-to-source pixel mapping is computed on the host in float64 through
the standalone WCS stack (shared with the JAX package's derivation,
:func:`bilinear_host_maps`).  A bilinear, axis-aligned target with an
untouched spectral axis resamples in kernel 3
(``kernels/resample2.py::resample2``) straight from the raw, NaN-carrying
data; a target whose spectral axis differs from the input's first lerps
the NaN-filled data and the NaN mask along the spectral axis (torch
gathers, as XLA does it in the JAX package) and then resamples both in
``resample2_filled``.  A rotated target, and nearest-neighbour resampling
(order 0), take the four-corner gather of the JAX package
(regrid.py:351-408), plain torch as there: outside any kernel.  NaN
poisoning follows nonzero-weight semantics, so a zero-weight NaN
neighbour never poisons an output.

:func:`convolve_reproject_separable` fuses the common-beam convolution
with the resample in kernel 6 (``kernels/conv_reproject.py``) on operators
composed on the host by :func:`_conv_reproject_operators`, or, where
kernel 6's plan does not fit, runs the two-stage chain.

The spline orders 2 and 3 (biquadratic, bicubic) take
:func:`_spline_spatial_then_z`: exact scipy operators built on the host in
float64, a new spectral axis applied by kernel 7
(``kernels/banded_matmul.py``), then the spatial step as IEEE float32
matrix products (an axis-aligned mapping) or as the prefilter and the
(order + 1)^2 tap gathers (any other mapping), as the JAX package computes
them outside any Pallas kernel.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import ieee_fp32
from ..wcs import WCS
from ..kernels import banded_matmul as _bm
from ..kernels.conv_reproject import (Bands, ConvTaps, Rows2, bands_of,
                                      conv_reproject, plan)
from ..kernels.resample2 import resample2, resample2_filled
from .convolve import (convolve2d_separable, separable_factors,
                       _conv_matrix_1d, _tap_stack)
from .interpolate import _interp_matrix, compose_interp_banded
from .reductions import finite

__all__ = ["spatial_pixel_mapping", "bilinear_host_maps",
           "reproject_mappings", "reproject_cube", "reproject_image",
           "mosaic_add", "convolve_reproject_separable", "fused_plan_fits"]

_ORDERS = {"nearest-neighbor": 0, "nearest": 0, "bilinear": 1,
           "biquadratic": 2, "bicubic": 3}


#: output voxels a slab of the staged spectral lerp, of the four-corner
#: gather and of the spline path's spatial step holds at once: each runs a
#: slab of output channels at a time into its one output, so that its
#: temporaries are a slab's, not a cube's
SLAB_VOXELS = 1 << 27


def _slabs(nz, plane):
    """``(k0, k1)`` of the slabs of ``nz`` output channels of ``plane``
    voxels each, :data:`SLAB_VOXELS` at most (one channel at least)."""
    step = max(1, SLAB_VOXELS // max(int(plane), 1))
    return [(k0, min(k0 + step, nz)) for k0 in range(0, nz, step)]


def _into(out, k0, k1, nz, val):
    """``val`` written as channels ``k0:k1`` of ``out``, the (nz, ...)
    output made at the first slab with ``val``'s type and device."""
    if out is None:
        out = torch.empty((nz,) + tuple(val.shape[1:]), dtype=val.dtype,
                          device=val.device)
    out[k0:k1] = val
    return out


def _nan_channels(data):
    """(nchan,) bool: the channels of ``data`` that hold a NaN, found a
    slab of channels at a time."""
    return torch.cat([torch.isnan(data[k0:k1]).flatten(1).any(1)
                      for k0, k1 in _slabs(data.shape[0],
                                           data[0].numel())])


def _order_int(order):
    """Accept the reference's order names (reproject_interp's documented
    'nearest-neighbor'|'bilinear'|'biquadratic'|'bicubic', reference
    spectral_cube.py:2671-2678) or a bare int 0-3."""
    if isinstance(order, (int, np.integer)):
        if order not in (0, 1, 2, 3):
            raise ValueError(f"order must be 0-3, got {order}")
        return int(order)
    try:
        return _ORDERS[order]
    except KeyError:
        raise ValueError(f"unknown interpolation order {order!r}; expected "
                         f"one of {sorted(_ORDERS)} or an int 0-3") from None


def spatial_pixel_mapping(wcs_in: WCS, wcs_out: WCS, shape_out):
    """(y_src, x_src) float64 arrays: for each output pixel, the fractional
    input pixel it samples."""
    ny, nx = shape_out
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    cel_out = wcs_out.celestial
    cel_in = wcs_in.celestial
    lon, lat = cel_out.pix2world(xx.ravel(), yy.ravel())
    xs, ys = cel_in.world2pix(np.asarray(lon), np.asarray(lat))
    return (np.asarray(ys).reshape(ny, nx),
            np.asarray(xs).reshape(ny, nx))


def bilinear_host_maps(zs, ys, xs, nchan_in, ny_in, nx_in, order):
    """Host-side index/weight/validity arrays for the separable
    trilinear resample — shared by :func:`_bilinear_spatial_then_linear_z`
    and ``parallel.sharded.sharded_reproject`` (whose contract is exact
    agreement with the unsharded path, so the derivations must not be
    able to diverge).  Returns
    ``(zvalid, z0, zf, z_identity, yvalid, xvalid, y0, y1, wy, x0, x1,
    wx)`` with ``zf``/``wy``/``wx`` float32 numpy arrays."""
    nz = zs.shape[0]
    zvalid = np.isfinite(zs) & (zs >= -1e-3) & (zs <= nchan_in - 1 + 1e-3)
    zc = np.clip(np.nan_to_num(zs), 0, nchan_in - 1)
    z0 = np.clip(zc.astype(np.int32), 0, nchan_in - 2) \
        if nchan_in > 1 else np.zeros(nz, np.int32)
    zf = (zc - z0).astype(np.float32)
    if order == 0:
        z0 = np.clip(np.round(zc).astype(np.int32), 0, nchan_in - 1)
        zf = np.zeros(nz, np.float32)
    z_identity = (nz == nchan_in and np.all(zc == np.arange(nchan_in))
                  and zvalid.all())

    yvalid = np.isfinite(ys) & (ys >= -1e-3) & (ys <= ny_in - 1 + 1e-3)
    xvalid = np.isfinite(xs) & (xs >= -1e-3) & (xs <= nx_in - 1 + 1e-3)
    ycl = np.clip(np.nan_to_num(ys), 0, ny_in - 1)
    xcl = np.clip(np.nan_to_num(xs), 0, nx_in - 1)
    if order == 0:
        y0 = np.clip(np.round(ycl).astype(np.int64), 0, ny_in - 1)
        x0 = np.clip(np.round(xcl).astype(np.int64), 0, nx_in - 1)
        wy = np.zeros_like(ycl, np.float32)
        wx = np.zeros_like(xcl, np.float32)
    else:
        y0 = np.clip(ycl.astype(np.int64), 0, max(ny_in - 2, 0))
        x0 = np.clip(xcl.astype(np.int64), 0, max(nx_in - 2, 0))
        wy = (ycl - y0).astype(np.float32)
        wx = (xcl - x0).astype(np.float32)
    y1 = np.minimum(y0 + 1, ny_in - 1)
    x1 = np.minimum(x0 + 1, nx_in - 1)
    return (zvalid, z0, zf, z_identity, yvalid, xvalid, y0, y1, wy,
            x0, x1, wx)


#: host operators of the spline path, by their arguments (bounded)
_SPLINE_OPS = OrderedDict()
_SPLINE_OPS_SIZE = 16


_SPLINE_OPS_LOCK = threading.Lock()


def _spline_cached(key, build):
    """``_SPLINE_OPS[key]``, built first where absent; under a lock, as
    the positions of a mesh ask at once."""
    with _SPLINE_OPS_LOCK:
        hit = _SPLINE_OPS.get(key)
        if hit is not None:
            _SPLINE_OPS.move_to_end(key)
            return hit
    hit = build()
    with _SPLINE_OPS_LOCK:
        _SPLINE_OPS[key] = hit
        while len(_SPLINE_OPS) > _SPLINE_OPS_SIZE:
            _SPLINE_OPS.popitem(last=False)
    return hit


def _spline_1d_matrix(n_in, coords, order):
    """Exact (n_out, n_in) float32 scipy spline-resample operator along one
    axis (regrid.py:42-62): ``scipy.ndimage.map_coordinates`` of an
    identity in float64, which composes the spline prefilter and the
    B-spline taps, boundaries included; entries below 1e-8 are dropped so
    that the operator is banded.  Out-of-range coordinates give all-zero
    rows, which the caller's validity mask NaNs.  Cached by its
    arguments."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)

    def build():
        from scipy.ndimage import map_coordinates
        n_out = coords.shape[0]
        cc = np.stack([np.repeat(coords, n_in),
                       np.tile(np.arange(n_in, dtype=np.float64), n_out)])
        T = map_coordinates(np.eye(n_in), cc, order=order, mode="constant",
                            cval=0.0).reshape(n_out, n_in)
        T[np.abs(T) < 1e-8] = 0.0
        return T.astype(np.float32)
    return _spline_cached(("matrix", int(n_in), int(order), coords.tobytes()),
                          build)


def _spline_prefilter_matrix(n, order):
    """(n, n) float32 mirror-mode spline prefilter (regrid.py:100-107):
    column j the filtered unit impulse at j, entries below 1e-8 dropped.
    Cached by its arguments."""
    def build():
        from scipy.ndimage import spline_filter1d
        P = spline_filter1d(np.eye(n), order=order, axis=0,
                            mode="mirror").astype(np.float32)
        P[np.abs(P) < 1e-8] = 0.0
        return P
    return _spline_cached(("prefilter", int(n), int(order)), build)


def _spectral_route(M):
    """``(bands, fits)``: kernel 7's row bands of the host operator ``M``
    and whether its plan takes them, cached by ``M``'s bytes."""
    def build():
        bands = _bm.row_bands(M)
        return bands, _bm.fits(bands)
    return _spline_cached(("bands", M.shape, M.tobytes()), build)


def _spectral_product(M, cube):
    """``M @ cube`` along axis 0 for the host operator ``M`` (nz, nchan)
    and a finite float32 (nchan, ny, nx) tensor: kernel 7
    (:func:`~..kernels.banded_matmul.banded_matmul`) on the contiguous
    (nchan, ny * nx) view where its plan fits the operator's bands,
    decided on the host before any launch; else ``torch.matmul`` in IEEE
    float32, counted in ``_spectral_product.declined``.  The route of the
    latest call is ``_spectral_product.last``."""
    nchan, ny, nx = cube.shape
    flat = cube.reshape(nchan, ny * nx).to(torch.float32).contiguous()
    bands, fits = _spectral_route(M)
    if fits:
        _spectral_product.last = "banded_matmul"
        out = _bm.banded_matmul(flat, bands)
    else:
        _spectral_product.last = "matmul"
        _spectral_product.declined += 1
        with ieee_fp32():
            out = torch.matmul(torch.as_tensor(M, device=cube.device), flat)
    return out.reshape(M.shape[0], ny, nx)


_spectral_product.last = None
_spectral_product.declined = 0


def _spline_separable_resample(fz, wz, ys, xs, order):
    """Order-2/3 spatial resample of an axis-aligned mapping
    (regrid.py:65-87): the exact scipy operators along y then x, as IEEE
    float32 matrix products, for the data and, with the operators'
    absolute values, the NaN weights.  Returns ``(out, wn)``."""
    nz, ny_in, nx_in = fz.shape
    dev = fz.device
    ty = _spline_1d_matrix(ny_in, ys[:, 0], order)
    tx = _spline_1d_matrix(nx_in, xs[0, :], order)

    def apply(arr, a, b):
        a = torch.as_tensor(a, device=dev)
        b = torch.as_tensor(b, device=dev)
        t = torch.matmul(a, arr.to(torch.float32))
        return torch.matmul(t, b.t())

    with ieee_fp32():
        out = apply(fz, ty, tx)
        wn = apply(wz, np.abs(ty), np.abs(tx))
    return out, wn


def _bspline(order, t):
    """B-spline basis value at distance ``t`` (regrid.py:133-141)."""
    at = np.abs(t)
    if order == 2:
        return np.where(at < 0.5, 0.75 - at ** 2,
                        np.where(at < 1.5, 0.5 * (at - 1.5) ** 2, 0.0))
    return np.where(at < 1.0, (4.0 - 6.0 * at ** 2 + 3.0 * at ** 3) / 6.0,
                    np.where(at < 2.0, (2.0 - at) ** 3 / 6.0, 0.0))


class SplineTaps(NamedTuple):
    """The nonseparable spline path's host plan on a device: the float32
    prefilters ``py`` (ny_in, ny_in) and ``px`` (nx_in, nx_in), the
    padding (``pad`` cells, torch ``pad_mode``) and per tap the (ny * nx,)
    flat indices into the padded plane and the float32 weights (numpy)."""
    py: torch.Tensor
    px: torch.Tensor
    pad: int
    pad_mode: str
    taps: list


def spline_taps(ys, xs, order, ny_in, nx_in, device):
    """:class:`SplineTaps` of the (order + 1)^2 B-spline taps at the maps
    ``ys``/``xs`` (regrid.py:100-141): mirror-mode prefilters, ``order``
    cells of padding (reflect, or edge where a plane is no larger than
    ``order``), the taps' base knots rounded (order 2) or floored (order
    3), weights in float64 cast to float32."""
    pad = order
    nxp = nx_in + 2 * pad
    ycl = np.nan_to_num(np.asarray(ys, dtype=np.float64))
    xcl = np.nan_to_num(np.asarray(xs, dtype=np.float64))
    if order == 2:
        yb, xb = np.round(ycl).astype(np.int64), np.round(xcl).astype(np.int64)
        offs = (-1, 0, 1)
    else:
        yb, xb = np.floor(ycl).astype(np.int64), np.floor(xcl).astype(np.int64)
        offs = (-1, 0, 1, 2)
    fy, fx = ycl - yb, xcl - xb
    taps = []
    for dy in offs:
        for dx in offs:
            w = (_bspline(order, fy - dy)
                 * _bspline(order, fx - dx)).astype(np.float32)
            iy = np.clip(yb + dy + pad, 0, ny_in + 2 * pad - 1)
            ix = np.clip(xb + dx + pad, 0, nxp - 1)
            taps.append((torch.as_tensor((iy * nxp + ix).ravel(),
                                         device=device),
                         np.ascontiguousarray(w.ravel())))
    return SplineTaps(
        torch.as_tensor(_spline_prefilter_matrix(ny_in, order),
                        device=device),
        torch.as_tensor(_spline_prefilter_matrix(nx_in, order),
                        device=device),
        pad, "reflect" if min(ny_in, nx_in) > order else "replicate", taps)


def spline_coefficients(arr, plan, absolute):
    """The padded spline coefficients of the (nz, ny_in, nx_in) ``arr``
    (their absolute values with ``absolute``) as the channels-minor
    (padded plane, nz) tensor the taps gather from."""
    with ieee_fp32():
        c = torch.matmul(torch.matmul(plan.py, arr.to(torch.float32)),
                         plan.px.t())
    if absolute:
        c = c.abs_()
    p = plan.pad
    c = F.pad(c[None], (p, p, p, p), mode=plan.pad_mode)[0]
    return c.reshape(c.shape[0], -1).t().contiguous()


def spline_gathers(flat, plan, absolute):
    """The weighted sum of the taps of :func:`spline_coefficients`'
    ``flat``: each tap gathered into one reused buffer and accumulated in
    place, with the weights' absolute values where ``absolute``.  Returns
    the (ny * nx, nz) sum."""
    n_out = plan.taps[0][0].shape[0]
    acc = torch.zeros((n_out, flat.shape[1]), dtype=flat.dtype,
                      device=flat.device)
    part = torch.empty_like(acc)
    for idx, w in plan.taps:
        w = np.abs(w) if absolute else w
        torch.index_select(flat, 0, idx, out=part)
        acc.addcmul_(part, torch.as_tensor(w, device=flat.device)[:, None])
    return acc


def _spline_nonseparable_resample(fz, wz, ys, xs, order, plan=None):
    """Order-2/3 resample of a rotated or general mapping
    (regrid.py:90-178): prefilter both spatial axes (IEEE float32 matrix
    products) and pad (:func:`spline_coefficients`), then sum the
    (order + 1)^2 B-spline taps gathered as rows of the (space, nz)
    channels-minor view (:func:`spline_gathers`).  The NaN-weight pass
    runs only where ``wz`` is not all zero (decided on the host); an
    output whose NaN weight is above 1e-6 is NaN.  ``plan``: the maps'
    :func:`spline_taps` on ``fz``'s device, when the caller built it
    already.  Returns ``(out, None)``."""
    nz, ny_in, nx_in = fz.shape
    ny, nx = ys.shape
    if plan is None:
        plan = spline_taps(ys, xs, order, ny_in, nx_in, fz.device)
    out = spline_gathers(spline_coefficients(fz, plan, False), plan, False)
    if bool(wz.ne(0).any()):
        wn = spline_gathers(spline_coefficients(wz, plan, True), plan, True)
        out.masked_fill_(wn > 1e-6, float("nan"))
        del wn
    return out.t().reshape(nz, ny, nx), None


class SplineMaps(NamedTuple):
    """The spline path's host decisions (regrid.py:194-244): the validity
    of each output channel, row and column, the finite source maps, whether
    the spectral axis is untouched and whether the spatial step is
    separable (axis-aligned to 1e-9 pixel, no grid above 4096)."""
    zvalid: np.ndarray
    yvalid: np.ndarray
    xvalid: np.ndarray
    zc: np.ndarray
    ycl: np.ndarray
    xcl: np.ndarray
    z_identity: bool
    separable: bool


def spline_host_maps(zs, ys, xs, nchan_in, ny_in, nx_in):
    """:class:`SplineMaps` of the target->source maps ``zs`` (nz,),
    ``ys``/``xs`` (ny, nx) onto an input of (nchan_in, ny_in, nx_in)."""
    zs, ys, xs = (np.asarray(a, dtype=np.float64) for a in (zs, ys, xs))
    zvalid = np.isfinite(zs) & (zs >= -1e-3) & (zs <= nchan_in - 1 + 1e-3)
    yvalid = np.isfinite(ys) & (ys >= -1e-3) & (ys <= ny_in - 1 + 1e-3)
    xvalid = np.isfinite(xs) & (xs >= -1e-3) & (xs <= nx_in - 1 + 1e-3)
    zc, ycl, xcl = (np.nan_to_num(a) for a in (zs, ys, xs))
    z_identity = bool(zs.shape[0] == nchan_in and zvalid.all()
                      and np.all(zc == np.arange(nchan_in)))
    separable = bool(np.ptp(ycl, axis=1).max() <= 1e-9
                     and np.ptp(xcl, axis=0).max() <= 1e-9
                     and max(*ys.shape, ny_in, nx_in)
                     <= _MATMUL_RESAMPLE_MAX_N)
    return SplineMaps(zvalid, yvalid, xvalid, zc, ycl, xcl, z_identity,
                      separable)


def _spline_spectral(data, m, order):
    """The spectral step of :func:`_spline_spatial_then_z` on ``data``
    (nchan, ny_in, nx_in) with its :class:`SplineMaps` ``m``: the spline
    operator along z (:func:`_spectral_product`, kernel 7) of the
    NaN-filled data and, with its absolute values, of the NaN mask, both
    written a slab at a time into one buffer, each product's input in
    turn.  Returns ``(fz, wz)``, or ``(None, None)`` on an untouched
    spectral axis (the spatial step then fills each slab itself)."""
    if m.z_identity:
        return None, None
    nchan, ny_in, nx_in = data.shape
    tz = _spline_1d_matrix(nchan, m.zc, order)
    buf = torch.empty(data.shape, dtype=torch.float32, device=data.device)
    slabs = _slabs(nchan, ny_in * nx_in)
    for k0, k1 in slabs:
        buf[k0:k1] = torch.nan_to_num(data[k0:k1])
    fz = _spectral_product(tz, buf)
    for k0, k1 in slabs:
        buf[k0:k1] = torch.isnan(data[k0:k1])
    wz = _spectral_product(np.abs(tz), buf)
    return fz, wz


def _spline_spatial(fz, wz, m, order, plan, zvalid):
    """The spatial step of :func:`_spline_spatial_then_z` on the output
    channels of :func:`_spline_spectral`'s ``fz`` and ``wz`` or, where
    ``wz`` is None (an untouched spectral axis), of the data ``fz``, each
    slab filling its own channels and forming their NaN mask: the
    separable products or (``plan``, the maps' :func:`spline_taps` on the
    device) the prefilter and tap gathers, a slab of output channels at a
    time (:data:`SLAB_VOXELS`) into the one output, NaN where the NaN
    weight passes 1e-6 and outside the input (``zvalid``: the channels'
    validity).  Returns the float32 output."""
    nz, ny_in, nx_in = fz.shape
    ny, nx = m.ycl.shape
    dev = fz.device
    plane = torch.as_tensor(m.yvalid & m.xvalid, device=dev)
    zv = torch.as_tensor(np.asarray(zvalid), device=dev)
    out = None
    for k0, k1 in _slabs(nz, max(ny * nx, ny_in * nx_in)):
        if wz is None:
            f = torch.nan_to_num(fz[k0:k1])
            w = torch.isnan(fz[k0:k1]).to(torch.float32)
        else:
            f, w = fz[k0:k1], wz[k0:k1]
        if m.separable:
            o, wn = _spline_separable_resample(f, w, m.ycl, m.xcl, order)
        else:
            o, wn = _spline_nonseparable_resample(f, w, m.ycl, m.xcl, order,
                                                  plan)
        del f, w
        if wn is not None:
            o.masked_fill_(wn > 1e-6, float("nan"))
        del wn
        o.masked_fill_(~(plane[None] & zv[k0:k1, None, None]),
                       float("nan"))
        out = _into(out, k0, k1, nz, o)
        del o
    return out


def _spline_spatial_then_z(data, zs, ys, xs, order):
    """Order-2/3 resample (regrid.py:194-244): the spectral operator of the
    exact scipy spline along z (:func:`_spline_spectral`, kernel 7), for
    the NaN-filled data and, with its absolute values, the NaN mask; then
    the spatial step (:func:`_spline_spatial`), separable where the
    mapping is axis-aligned to 1e-9 pixel and no grid exceeds 4096, else
    the prefilter and tap gathers.  NaN poisoning is the |T|-weighted NaN
    mass above 1e-6, local to the taps; outputs outside the input are
    NaN.  The filled data and then the NaN mask are written a slab at a
    time into one buffer, each product's input in turn, and the spatial
    step runs a slab of output channels at a time into the one output
    (:data:`SLAB_VOXELS`).  On an untouched spectral axis each slab fills
    its own channels and forms their NaN mask, so that the output is the
    only cube it makes.  ``parallel.sharded.sharded_spline_reproject``
    runs the same two steps on each tile and each channel block."""
    m = spline_host_maps(zs, ys, xs, *data.shape)
    fz, wz = _spline_spectral(data, m, order)
    plan = None if m.separable else spline_taps(m.ycl, m.xcl, order,
                                                *data.shape[1:], data.device)
    out = _spline_spatial(data if fz is None else fz, wz, m, order, plan,
                          m.zvalid)
    del fz, wz
    return out.to(data.dtype)


def _bilinear_spatial_then_linear_z(data, zs, ys, xs, order):
    """Separable resample of (nchan, ny_in, nx_in) ``data`` at spectral
    input coordinates ``zs`` and spatial maps ``ys``/``xs``
    (regrid.py:287-408).  Orders 2 and 3 take
    :func:`_spline_spatial_then_z`.  A bilinear,
    axis-aligned mapping runs kernel 3: on the raw data for an untouched
    spectral axis, else after the staged spectral lerp of the NaN-filled
    data and the NaN mask (``resample2_filled``).  A rotated mapping and
    order 0 take :func:`_gather_resample`."""
    if order >= 2:
        return _spline_spatial_then_z(data, np.asarray(zs), np.asarray(ys),
                                      np.asarray(xs), order)
    nchan_in, ny_in, nx_in = data.shape
    maps = bilinear_host_maps(zs, ys, xs, nchan_in, ny_in, nx_in, order)
    zvalid, z0, zf, z_identity, yvalid, xvalid = maps[:6]
    taps = _axis_aligned_taps(ys, xs, ny_in, nx_in) if order == 1 else None
    if taps is None:
        return _gather_resample(data, maps, order)
    if z_identity:
        return resample2(data, *taps, yvalid & xvalid, zvalid)
    fz, wz, wz_any = _zlerp_filled(data, z0, zf)
    return resample2_filled(fz, wz, wz_any, *taps, yvalid & xvalid, zvalid)


def _gather_resample(data, maps, order):
    """The JAX package's four-corner gather (regrid.py:351-408): the
    spectral lerp of the NaN-filled data (none on an untouched axis), then
    per output pixel the weighted sum of its 2 x 2 input corners (the
    nearest one for order 0), :func:`_gather_slabs`.  Only a slab whose
    input channels hold NaN gathers its NaN weights too, and an output
    whose NaN weight is above 1e-6 becomes NaN; outputs outside the
    input's footprint are NaN.  The output is the only cube it makes (the
    JAX package's whole-cube form held about four)."""
    (zvalid, z0, zf, z_identity, yvalid, xvalid) = maps[:6]
    nchan_in, ny_in, nx_in = data.shape
    nz = zf.shape[0]
    dev = data.device
    lo = torch.as_tensor(np.asarray(z0, np.int64), device=dev)
    hi = torch.as_tensor(np.minimum(np.asarray(z0, np.int64) + 1,
                                    nchan_in - 1), device=dev)
    f3 = torch.as_tensor(np.asarray(zf, np.float32), device=dev)[:, None,
                                                                 None]
    lerped = not (z_identity or order == 0 or nchan_in == 1)
    nan_chan = _nan_channels(data)

    def zlerp(prep, k0, k1):
        # output channels k0:k1 of the spectral lerp of ``prep`` of the
        # data, ``prep`` applied to the input channels they read
        if z_identity:
            return prep(data[k0:k1])
        a = prep(data.index_select(0, lo[k0:k1]))
        if not lerped:
            return a
        f = f3[k0:k1]
        return a * (1 - f) + prep(data.index_select(0, hi[k0:k1])) * f

    def weight(k0, k1):
        read = slice(k0, k1) if z_identity else torch.cat(
            [lo[k0:k1], hi[k0:k1]] if lerped else [lo[k0:k1]])
        if not bool(nan_chan[read].any()):
            return None
        return zlerp(_nan_weight, k0, k1)

    out = _gather_slabs(nz, _corner_taps(maps, order, nx_in, dev),
                       (ny_in, nx_in), yvalid.shape,
                       lambda k0, k1: zlerp(torch.nan_to_num, k0, k1),
                       weight)
    valid = torch.as_tensor((yvalid & xvalid)[None], device=dev) \
        & torch.as_tensor(np.asarray(zvalid), device=dev)[:, None, None]
    return out.masked_fill_(~valid, float("nan")).to(data.dtype)


def _nan_weight(a):
    return torch.isnan(a).to(torch.float32)


def _corner_taps(maps, order, nx_in, device):
    """The four-corner gather's taps of the host maps ``maps``
    (:func:`bilinear_host_maps`): per corner (one for order 0) the flat
    indices of its input pixel in a plane of ``nx_in`` columns and its
    (n, 1) weights, on ``device``."""
    y0, y1, wy, x0, x1, wx = maps[6:]
    corners = ((y0, x0, (1 - wy) * (1 - wx)), (y0, x1, (1 - wy) * wx),
               (y1, x0, wy * (1 - wx)), (y1, x1, wy * wx))
    if order == 0:
        corners = corners[:1]
    return [(torch.as_tensor((yy * nx_in + xx).ravel(), device=device),
             torch.as_tensor(np.ascontiguousarray(w.ravel()),
                             device=device)[:, None])
            for yy, xx, w in corners]


def _gather_slabs(nz, taps, plane_in, plane_out, fill, weight):
    """The four-corner gather of ``nz`` output channels onto the
    ``plane_out`` plane by the taps ``taps`` (:func:`_corner_taps`), a slab
    of output channels at a time (:data:`SLAB_VOXELS`) into the one output:
    ``fill(k0, k1)`` gives the slab's NaN-filled input planes (k1 - k0,
    *``plane_in``) and ``weight(k0, k1)`` their NaN weights, or None where
    they hold no NaN; an output whose gathered NaN weight passes 1e-6 is
    NaN.  The gathers read rows of the slab's (ny_in * nx_in, k1 - k0)
    channels-minor copy, whole spectra, and accumulate in place into one
    buffer."""
    ny_in, nx_in = plane_in
    ny, nx = plane_out

    def gathers(src):
        # the slab's channels-minor copy is the only one alive
        flat = src.reshape(src.shape[0], ny_in * nx_in).t().contiguous()
        del src
        acc = None
        for idx, w in taps:
            part = flat.index_select(0, idx)
            if acc is None:
                acc = part.mul_(w)
            else:
                acc.addcmul_(part, w)
            del part
        return acc

    out = None
    for k0, k1 in _slabs(nz, max(ny * nx, ny_in * nx_in)):
        acc = gathers(fill(k0, k1))
        w = [weight(k0, k1)]
        if w[0] is not None:
            # handed over, so that the gather frees it once copied
            acc.masked_fill_(gathers(w.pop()) > 1e-6, float("nan"))
        out = _into(out, k0, k1, nz, acc.t().reshape(k1 - k0, ny, nx))
        del acc
    return out


def _zlerp_filled(data, z0, zf):
    """The spectral lerp of the staged branch (regrid.py:351-366):
    ``fz = zlerp(nan_to_num(data))``, ``wz = zlerp(isnan(data))`` with
    ``zlerp(a) = a[z0] * (1 - zf) + a[z0 + 1] * zf``, and ``wz_any``, the
    (nz,) flags of the output channels whose ``wz`` is not all zero,
    derived from the input channels that hold a NaN (a weight of 0 carries
    no NaN).  It runs a slab of output channels at a time
    (:data:`SLAB_VOXELS`), filling and lerping the input channels that
    slab reads, into the one fz and the one wz."""
    nchan_in = data.shape[0]
    dev = data.device
    nz = len(z0)
    lo_i = torch.as_tensor(np.asarray(z0, np.int64), device=dev)
    chan_nan = _nan_channels(data)

    def nanmask(a):
        return torch.isnan(a).to(torch.float32)
    fz = wz = None
    if nchan_in == 1:
        for k0, k1 in _slabs(nz, data[0].numel()):
            a = data.index_select(0, lo_i[k0:k1])
            fz = _into(fz, k0, k1, nz, torch.nan_to_num(a))
            wz = _into(wz, k0, k1, nz, nanmask(a))
        return fz, wz, chan_nan[lo_i]
    hi_i = torch.as_tensor(np.minimum(np.asarray(z0, np.int64) + 1,
                                      nchan_in - 1), device=dev)
    f = torch.as_tensor(np.asarray(zf, np.float32), device=dev)
    g = 1 - f
    f3, g3 = f[:, None, None], g[:, None, None]
    for k0, k1 in _slabs(nz, data[0].numel()):
        a = data.index_select(0, lo_i[k0:k1])
        b = data.index_select(0, hi_i[k0:k1])
        gs, fs = g3[k0:k1], f3[k0:k1]
        fz = _into(fz, k0, k1, nz,
                   torch.nan_to_num(a) * gs + torch.nan_to_num(b) * fs)
        wz = _into(wz, k0, k1, nz, nanmask(a) * gs + nanmask(b) * fs)
        del a, b
    wz_any = (chan_nan[lo_i] & (g != 0)) | (chan_nan[hi_i] & (f != 0))
    return fz, wz, wz_any


#: how far (pixels) a map may stray from axis alignment; the tolerance of
#: _translation_params (regrid.py:420-437)
_ALIGN_TOL = 1e-9


def _axis_aligned_taps(ys, xs, ny_in, nx_in):
    """1-D bilinear taps ``(y0, wy, x0, wx)`` when the source row ``ys``
    depends on the output row only and ``xs`` on the column only, to
    :data:`_ALIGN_TOL` pixel; else None.

    A translated or rescaled target of the same projection is axis-aligned
    exactly, but the float64 WCS round trip adds ~1e-12 pixel of noise that
    an exact per-row comparison of the float32 weights can trip over (the
    JAX package then takes its gather path); this test reads the float64
    maps directly.  Each axis is clipped as ``bilinear_host_maps`` clips
    it; out-of-range outputs are masked by the caller's validity plane."""
    def centre(c, axis):
        # mean of the finite entries; a row or column entirely off the
        # input sky (all NaN) gets 0 and is masked by the validity plane
        fin = np.isfinite(c)
        return np.where(fin, c, 0.0).sum(axis) \
            / np.maximum(fin.sum(axis), 1)

    ys, xs = np.asarray(ys, np.float64), np.asarray(xs, np.float64)
    yrow, xcol = centre(ys, 1), centre(xs, 0)
    off_y = np.where(np.isfinite(ys), np.abs(ys - yrow[:, None]), 0.0)
    off_x = np.where(np.isfinite(xs), np.abs(xs - xcol[None, :]), 0.0)
    if off_y.max(initial=0.0) > _ALIGN_TOL \
            or off_x.max(initial=0.0) > _ALIGN_TOL:
        return None

    def axis(c, n_in):
        cl = np.clip(c, 0, n_in - 1)
        i0 = np.clip(cl.astype(np.int64), 0, max(n_in - 2, 0))
        return i0, (cl - i0).astype(np.float32)

    return axis(yrow, ny_in) + axis(xcol, nx_in)


def _translation_params(ys, xs, ny_in, nx_in):
    """(sy, wy, sx, wx) when the output grid is the input grid shifted by
    a constant — integer parts sy/sx, fractions in [0, 1) — else None.
    Tolerance 1e-9 pixel: (i + t) - i wobbles at the float64 ulp of the
    coordinate, ~7 decades below what an f32 lerp weight can resolve."""
    ny, nx = np.asarray(ys).shape
    if ny != ny_in or nx != nx_in:
        return None
    dy = np.asarray(ys) - np.arange(ny, dtype=np.float64)[:, None]
    dx = np.asarray(xs) - np.arange(nx, dtype=np.float64)[None, :]
    if not (np.isfinite(dy).all() and np.isfinite(dx).all()):
        return None
    if np.ptp(dy) > 1e-9 or np.ptp(dx) > 1e-9:
        return None
    ty, tx = float(dy.mean()), float(dx.mean())
    sy = int(np.floor(ty))
    sx = int(np.floor(tx))
    return sy, ty - sy, sx, tx - sx


# past this grid size the composed operators are not built (the JAX
# package's _MATMUL_RESAMPLE_MAX_N, regrid.py:412)
_MATMUL_RESAMPLE_MAX_N = 4096


class ConvReprojectOps(NamedTuple):
    """Host operators of the fused convolve + reproject: G = R @ M bands
    per axis (float32, composed in float64), the flipped convolution taps
    M, the 2-tap resample rows R, the in-range output plane and the
    rank."""
    gy: Bands
    gx: Bands
    my: ConvTaps
    mx: ConvTaps
    ry: Rows2
    rx: Rows2
    valid: np.ndarray
    rank: int


def _conv_reproject_operators(shape, kernel, ys, xs):
    """The operators of :func:`convolve_reproject_separable` and the
    whole-pipeline fusion (``ops/pipeline_fused``), as
    :class:`ConvReprojectOps`, or None where the JAX function
    (regrid.py:513-567) returns None: a kernel that does not SVD-separate,
    a mapping that is not exactly axis-aligned (``ptp == 0`` of the taps
    along the other axis), a grid above 4096, or a singleton spatial input
    axis.  The JAX function's TPU-backend gate is dropped: the kernel runs
    wherever the port does."""
    nchan, ny_in, nx_in = shape
    ys, xs = np.asarray(ys), np.asarray(xs)
    ny, nx = ys.shape
    if max(ny, nx, ny_in, nx_in) > _MATMUL_RESAMPLE_MAX_N:
        return None
    k64 = np.asarray(kernel, dtype=np.float64)
    factors = separable_factors(k64 / k64.sum())
    if factors is None:
        return None
    yvalid = np.isfinite(ys) & (ys >= -1e-3) & (ys <= ny_in - 1 + 1e-3)
    xvalid = np.isfinite(xs) & (xs >= -1e-3) & (xs <= nx_in - 1 + 1e-3)
    ycl = np.clip(np.nan_to_num(ys), 0, ny_in - 1)
    xcl = np.clip(np.nan_to_num(xs), 0, nx_in - 1)
    y0 = np.clip(ycl.astype(np.int64), 0, max(ny_in - 2, 0))
    x0 = np.clip(xcl.astype(np.int64), 0, max(nx_in - 2, 0))
    wy = ycl - y0
    wx = xcl - x0
    ysep = np.ptp(y0, axis=1).max() == 0 and np.ptp(wy, axis=1).max() == 0
    xsep = np.ptp(x0, axis=0).max() == 0 and np.ptp(wx, axis=0).max() == 0
    if not (ysep and xsep):
        return None
    if ny_in < 2 or nx_in < 2:
        return None
    ytaps, xtaps = factors
    r = ytaps.shape[1]

    def axis(i0, w, n_in, taps):
        G = np.stack([compose_interp_banded(i0, w, _conv_matrix_1d(
            n_in, taps[:, i])).astype(np.float32) for i in range(r)])
        R = _interp_matrix(i0, w, n_in)
        rows = np.arange(i0.size)
        flipped, half = _tap_stack([taps])
        return (bands_of(G[None]), ConvTaps(flipped[0], half),
                Rows2(i0, R[rows, i0], R[rows, i0 + 1]))

    gy, my, ry = axis(y0[:, 0], wy[:, 0], ny_in, ytaps)
    gx, mx, rx = axis(x0[0, :], wx[0, :], nx_in, xtaps)
    return ConvReprojectOps(gy, gx, my, mx, ry, rx, yvalid & xvalid, r)


def fused_plan_fits(shape, ops, mode=0):
    """Whether kernel 6 takes ``ops`` (:class:`ConvReprojectOps`) on a cube
    of ``shape`` in ``mode`` (0: conv + reproject, 2: with the moment
    planes): a tile whose input window fits one block's shared memory
    (``kernels/conv_reproject.plan``), as the TPU kernels' planners decline
    a window that does not fit VMEM.  A predicate on shapes, decided before
    any launch and the same on either device."""
    return plan(mode, shape, ops.gy, ops.gx,
                (ops.my, ops.mx, ops.ry, ops.rx)) is not None


def convolve_reproject_separable(data, kernel, ys, xs):
    """Fused common-beam convolve + axis-aligned reproject of a (nchan,
    ny_in, nx_in) cube through kernel 6 (``kernels/conv_reproject.py``):
    clean channels apply the host-composed G = R @ M per rank, channels
    holding NaN the exact normalized-convolution chain and the poisoned
    resample, all-NaN channels give NaN, and out-of-range outputs NaN.
    The JAX function tests ``~isfinite`` over the whole cube to pick the
    chain for every channel (regrid.py:632); the port follows the TPU
    kernel's per-channel ``isnan`` instead (banded_pallas.py:1159).

    Where kernel 6's plan does not fit (:func:`fused_plan_fits`: a wide
    kernel or a strong rescaling), the two-stage chain of the JAX
    function's fallback (regrid.py:619-626): ``convolve2d_separable`` with
    the normalized kernel (kernel 2), then the bilinear resample (kernel
    3), out-of-range outputs NaN.  ``convolve_reproject_separable.last``
    names the route of the latest call: 'fused', 'chain' or None.

    Returns None where the JAX function does with its TPU backend gate
    true (see :func:`_conv_reproject_operators`), so callers take the
    two-stage path."""
    ops = _conv_reproject_operators(data.shape, kernel, ys, xs)
    convolve_reproject_separable.last = {"route": None}
    if ops is None:
        return None
    if not fused_plan_fits(data.shape, ops):
        convolve_reproject_separable.last = {"route": "chain"}
        k64 = np.asarray(kernel, dtype=np.float64)
        conv = convolve2d_separable(data, k64 / k64.sum())
        zs = np.arange(data.shape[0], dtype=np.float64)
        return _bilinear_spatial_then_linear_z(conv, zs, np.asarray(ys),
                                               np.asarray(xs), 1)
    convolve_reproject_separable.last = {"route": "fused"}
    out = conv_reproject(data, ops.gy, ops.gx, ops.my, ops.mx, ops.ry,
                         ops.rx, ops.valid)
    return out.to(data.dtype)


convolve_reproject_separable.last = {}


def reproject_mappings(wcs_in: WCS, target_header, nchan_in,
                       spectral_values_in=None):
    """Host-side target->source pixel mappings for reprojection onto
    ``target_header``: returns ``(zs, ys, xs, wcs_out)`` with ``zs`` the
    (nz,) input-channel coordinate of each output channel and ``ys``/``xs``
    the (ny, nx) fractional input-pixel maps.  Shared by the unsharded
    :func:`reproject_cube` and ``parallel.sharded.sharded_reproject``."""
    wcs_out = WCS(header=target_header)
    nz = int(target_header.get("NAXIS3", nchan_in))
    ny = int(target_header["NAXIS2"])
    nx = int(target_header["NAXIS1"])
    ys, xs = spatial_pixel_mapping(wcs_in, wcs_out, (ny, nx))

    # spectral mapping: world value of each output channel -> input pixel
    sv_out = wcs_out.spectral_axis_values(nz)
    out_unit = wcs_out.spectral_unit
    in_unit = wcs_in.spectral_unit
    in_root = wcs_in.ctype[wcs_in.spec].strip().upper()[:4]
    out_root = wcs_out.ctype[wcs_out.spec].strip().upper()[:4]
    if in_root == out_root:
        sv_out_in_units = out_unit.to(in_unit, np.asarray(sv_out))
    else:
        # cross-type spectral axes (e.g. a FREQ cube onto a WAVE or
        # velocity template): route through the spectral conversion
        # engine in SI (reference handles this via astropy world
        # coordinates inside the reproject package)
        from ..wcs.spectral import spectral_value_transform, _rest_freq_si
        rest = _rest_freq_si(wcs_out) or _rest_freq_si(wcs_in)
        val, _ = spectral_value_transform(out_root, in_root, rest)
        si = np.asarray(sv_out, dtype=np.float64) * out_unit.scale
        sv_out_in_units = np.asarray(val(si)) / in_unit.scale
    if spectral_values_in is not None:
        # invert via the actual input axis (handles nonlinear sampling)
        inax = np.asarray(spectral_values_in, dtype=np.float64)
        order_in = np.argsort(inax)
        srt = inax[order_in]
        # snap float-epsilon overshoots onto the endpoint channels: a
        # unit/ctype conversion roundtrip perturbs the edge values by
        # ~1e-16 relative, which would otherwise NaN the edge channels
        sv = np.asarray(sv_out_in_units, dtype=np.float64)
        tol = min(1e-9 * max(abs(srt[0]), abs(srt[-1])),
                  1e-3 * np.min(np.diff(srt))) if len(srt) > 1 else 0.0
        sv = np.where((sv < srt[0]) & (sv > srt[0] - tol), srt[0], sv)
        sv = np.where((sv > srt[-1]) & (sv < srt[-1] + tol), srt[-1], sv)
        zs = np.interp(sv, srt,
                       np.arange(len(inax), dtype=np.float64)[order_in],
                       left=np.nan, right=np.nan)
    else:
        zs = np.asarray(wcs_in._spectral_world2inter(sv_out_in_units)
                        / wcs_in.cdelt[wcs_in.spec]
                        + wcs_in.crpix[wcs_in.spec] - 1.0)
    return np.asarray(zs), ys, xs, wcs_out


def reproject_cube(data, wcs_in: WCS, target_header, order="bilinear",
                   spectral_values_in=None):
    """Reproject a (spec, y, x) cube onto the WCS of ``target_header``.
    Returns ``(out, footprint, wcs_out)``, the footprint a bool tensor of
    the finite outputs."""
    zs, ys, xs, wcs_out = reproject_mappings(
        wcs_in, target_header, data.shape[0],
        spectral_values_in=spectral_values_in)
    out = _bilinear_spatial_then_linear_z(data, np.asarray(zs),
                                          np.asarray(ys), np.asarray(xs),
                                          _order_int(order))
    return out, finite(out), wcs_out


def _resample_planes(data, ys, xs, order):
    """Resample (nchan, ny_in, nx_in) or (ny_in, nx_in) planes at the
    fractional maps ``ys``/``xs``; NaN outside (regrid.py:638-648)."""
    single = data.ndim == 2
    if single:
        data = data[None]
    zs = np.arange(data.shape[0], dtype=np.float64)
    out = _bilinear_spatial_then_linear_z(data, zs, np.asarray(ys),
                                          np.asarray(xs), order)
    return out[0] if single else out


def reproject_image(data, wcs_in: WCS, target_header, order="bilinear",
                    device=None):
    """Reproject a 2-D image onto the celestial WCS of ``target_header``
    (regrid.py:651-659).  Returns ``(image, wcs)``, the image a tensor on
    ``device``: by default a tensor's own device, and the CUDA device for
    an array (raising where CUDA is absent), as the cube entry points
    place their data."""
    from ..cube import _as_tensor
    wcs_out = WCS(header=target_header)
    ny = int(target_header["NAXIS2"])
    nx = int(target_header["NAXIS1"])
    ys, xs = spatial_pixel_mapping(wcs_in, wcs_out, (ny, nx))
    data = _as_tensor(data, device).to(torch.float32)
    out = _resample_planes(data, ys, xs, _order_int(order))
    return out, wcs_out.celestial if wcs_out.naxis > 2 else wcs_out


def mosaic_add(accum, weights, cube_data, wcs_in, target_header,
               order="bilinear", spectral_values_in=None):
    """Add one reprojected cube into a mosaic accumulator (reference
    mosaic_cubes, cube_utils.py:791-856; regrid.py:739-750): accum +=
    data * w, weights += w, with w the reprojection footprint.  Returns
    the new ``(accum, weights)``."""
    out, foot, _ = reproject_cube(cube_data, wcs_in, target_header,
                                  order=order,
                                  spectral_values_in=spectral_values_in)
    w = foot.to(accum.dtype)
    return accum + torch.where(foot, out, 0.0), weights + w
