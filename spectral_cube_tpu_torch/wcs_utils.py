"""Module-level WCS utility functions matching the reference library's
``spectral_cube.wcs_utils`` surface (reference wcs_utils.py:28-555).

Port of ``spectral_cube_tpu/wcs_utils.py``: the functionality lives on
the port's :class:`~.wcs.WCS` as methods (host float64); this module
gives the reference's free-function spellings, so code written against
the reference (``from spectral_cube.wcs_utils import slice_wcs``) ports
by changing only the package name.
"""
from __future__ import annotations

import numpy as np

from .wcs import WCS

__all__ = ["drop_axis", "add_stokes_axis_to_wcs", "wcs_swapaxes",
           "reindex_wcs", "axis_names", "slice_wcs", "check_equality",
           "strip_wcs_from_header", "diagonal_wcs_to_cdelt",
           "is_pixel_axis_to_wcs_correlated", "find_spatial_pixel_index"]


def drop_axis(wcs: WCS, dropax: int) -> WCS:
    """Drop one WCS axis (FITS order index; reference wcs_utils.py:28-45)."""
    return wcs.dropaxis(dropax)


def add_stokes_axis_to_wcs(wcs: WCS, add_before_ind: int) -> WCS:
    """Insert a STOKES axis before FITS-order index ``add_before_ind``
    (reference wcs_utils.py:48-92)."""
    return wcs.add_stokes_axis(add_before_ind)


def wcs_swapaxes(wcs: WCS, ax0: int, ax1: int) -> WCS:
    """Swap two WCS axes (FITS order; reference wcs_utils.py:95-112)."""
    return wcs.swapaxes(ax0, ax1)


def reindex_wcs(wcs: WCS, inds) -> WCS:
    """Re-order WCS axes by FITS-order indices (reference
    wcs_utils.py:115-187)."""
    return wcs.reindex(list(inds))


def axis_names(wcs: WCS):
    """Long names of each FITS axis: the CTYPE root with any projection
    suffix stripped, e.g. ['RA', 'DEC', 'VOPT'] (reference
    wcs_utils.py:190-209)."""
    names = []
    for ct in wcs.ctype:
        names.append(str(ct).split("-")[0].strip())
    return names


def slice_wcs(mywcs: WCS, view, shape=None, numpy_order=True,
              drop_degenerate=False) -> WCS:
    """Slice a WCS with a numpy-style view (reference
    wcs_utils.py:212-338).  ``numpy_order=False`` takes the view in FITS
    axis order instead."""
    return mywcs.slice(view, shape=shape, numpy_order=numpy_order)


def check_equality(wcs1: WCS, wcs2: WCS, warn_missing=False,
                   ignore_keywords=("MJD-OBS", "VELOSYS"),
                   wcs_tolerance=0.0) -> bool:
    """Compare two WCSes (reference wcs_utils.py:341-440)."""
    return wcs1.check_equality(wcs2, wcs_tolerance=wcs_tolerance)


def strip_wcs_from_header(header):
    """Return a copy of ``header`` with every WCS keyword removed
    (reference wcs_utils.py:443-477)."""
    new = header.copy()
    try:
        wcs_keys = set(WCS(header=header).to_header())
    except Exception:
        wcs_keys = set()
    extra = set()
    for kw in ("CRPIX", "CRVAL", "CDELT", "CUNIT", "CTYPE", "CROTA",
               "NAXIS"):
        for ii in range(5):
            extra.add(f"{kw}{ii}")
    for ii in range(5):
        for jj in range(5):
            extra.update({f"PC{ii}_{jj}", f"CD{ii}_{jj}", f"PV{ii}_{jj}",
                          f"PC{ii:03d}{jj:03d}"})
    extra.update({"WCSAXES", "RESTFRQ", "RESTWAV", "SPECSYS", "RADESYS",
                  "EQUINOX", "LONPOLE", "LATPOLE", "NAXIS"})
    for k in list(new.keys()):
        if not k or k in wcs_keys or k in extra:
            try:
                del new[k]
            except KeyError:
                pass
    return new


def diagonal_wcs_to_cdelt(mywcs: WCS) -> WCS:
    """If the pixel-scale matrix is diagonal, fold it into CDELT and reset
    PC to identity (reference wcs_utils.py:478-490)."""
    psm = mywcs.pixel_scale_matrix
    offdiag = ~np.eye(psm.shape[0], dtype=bool)
    if not np.any(psm[offdiag]):
        out = mywcs.deepcopy()
        out.cdelt = list(np.asarray(psm.diagonal(), dtype=float))
        out.pc = np.eye(out.naxis)
        return out
    return mywcs


def is_pixel_axis_to_wcs_correlated(mywcs: WCS, axis: int) -> bool:
    """True if the numpy ``axis`` is correlated to more than one WCS axis
    (reference wcs_utils.py:493-514)."""
    return mywcs.is_pixel_axis_correlated(mywcs.naxis - 1 - axis)


def find_spatial_pixel_index(cube, xlo, xhi, ylo, yhi):
    """Pixel bounds of a rectangular spatial region given pixel or world
    quantities (reference wcs_utils.py:517-555).  Returns
    (xlo, xhi, ylo, yhi) as ints."""
    from .cube import _world_to_pixel_range
    nz_ny_nx = cube.shape
    ny, nx = nz_ny_nx[-2], nz_ny_nx[-1]
    xlo, xhi = _world_to_pixel_range(cube.wcs, 0, xlo, xhi, nx, n_other=ny)
    ylo, yhi = _world_to_pixel_range(cube.wcs, 1, ylo, yhi, ny, n_other=nx)
    return int(xlo), int(xhi), int(ylo), int(yhi)
