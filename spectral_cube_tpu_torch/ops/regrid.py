"""Reprojection onto a new spatial WCS, axis-aligned half.

Port of the axis-aligned part of ``spectral_cube_tpu/ops/regrid.py``.  The
target-to-source pixel mapping is computed on the host in float64 through
the standalone WCS stack (shared with the JAX package's derivation,
:func:`bilinear_host_maps`); the bilinear resample runs on the device in
kernel 3 (``kernels/resample2.py``) straight from the raw, NaN-carrying
data: NaN poisoning follows nonzero-weight semantics, so a zero-weight NaN
neighbour never poisons an output.

Not ported yet, and raising ``NotImplementedError``: targets whose spectral
axis differs from the input's (the staged ``_separable_resample`` path,
ROADMAP.md Queue 1 item 6), rotated targets (the gather path) and the
nearest/spline orders (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..wcs import WCS
from ..kernels.resample2 import resample2

__all__ = ["spatial_pixel_mapping", "bilinear_host_maps",
           "reproject_mappings", "reproject_cube"]

_ORDERS = {"nearest-neighbor": 0, "nearest": 0, "bilinear": 1,
           "biquadratic": 2, "bicubic": 3}


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


def _bilinear_spatial_then_linear_z(data, zs, ys, xs, order):
    """Separable resample of (nchan, ny_in, nx_in) ``data`` at spectral
    input coordinates ``zs`` and spatial maps ``ys``/``xs``; the torch
    port's counterpart of the JAX function for an untouched spectral axis
    and an axis-aligned bilinear mapping (regrid.py:312-349), where it
    runs kernel 3."""
    if order != 1:
        raise NotImplementedError(
            "nearest-neighbour and spline reprojection are not ported to "
            "torch yet (ROADMAP.md Queue 1 item 9)")
    nchan_in, ny_in, nx_in = data.shape
    (zvalid, z0, zf, z_identity, yvalid, xvalid, y0, y1, wy,
     x0, x1, wx) = bilinear_host_maps(zs, ys, xs, nchan_in, ny_in,
                                      nx_in, order)
    if not z_identity:
        raise NotImplementedError(
            "reprojection onto a different spectral axis is not ported to "
            "torch yet (ROADMAP.md Queue 1 item 6)")
    taps = _axis_aligned_taps(ys, xs, ny_in, nx_in)
    if taps is None:
        raise NotImplementedError(
            "rotated (non-axis-aligned) reprojection is not ported to "
            "torch yet (ROADMAP.md Queue 1 item 9)")
    return resample2(data, *taps, yvalid & xvalid, zvalid)


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
    return out, torch.isfinite(out), wcs_out
