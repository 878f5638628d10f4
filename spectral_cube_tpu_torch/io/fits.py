"""FITS cube reader and writer.

Port of ``spectral_cube_tpu/io/fits.py``: a 3-D image HDU loads as a
:class:`~..cube.SpectralCube` on the requested device, with a finiteness
mask (reference io/fits.py:214); a ``BEAMS`` table makes it a
:class:`~..cube.VaryingResolutionSpectralCube` (reference io/fits.py:96-131);
a 4-D file splits per Stokes component (reference io/fits.py:229-253) and
one component returns that cube.  Several components would make a
``StokesSpectralCube``, which is not ported yet (ROADMAP.md Queue 1 item
10): :func:`cube_from_hdus` raises there unless asked for the I component,
as ``SpectralCube.read`` asks.  Writing stamps a history card (reference
io/fits.py:263-282) and appends a varying-resolution cube's BEAMS table.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .fits_low import read_fits, write_fits, is_fits, BinTableHDU
from ..wcs import WCS
from ..masks import LazyMask
from ..utils import FITSReadError, StokesWarning
from ..cube_utils import orient, split_stokes

__all__ = ["load_fits_cube", "cube_from_hdus", "write_fits_cube", "is_fits"]


def _find_image_hdu(hdus, hdu_index=0):
    if hdu_index != 0:
        return hdus[hdu_index]
    for h in hdus:
        if getattr(h, "is_image", False) and \
                (h._lazy is not None or h._data is not None):
            if int(h.header.get("NAXIS", 0)) >= 3:
                return h
    for h in hdus:
        if getattr(h, "is_image", False) and \
                (h._lazy is not None or h._data is not None):
            return h
    raise FITSReadError("No image HDU found")


def _find_beam_table(hdus):
    for h in hdus:
        if isinstance(h, BinTableHDU) and h.name.strip().upper() == "BEAMS":
            return h
    return None


def load_fits_cube(filename, hdu=0, meta=None, device=None, **kwargs):
    """Read a FITS cube onto ``device`` (reference io/fits.py:171-260)."""
    return cube_from_hdus(read_fits(filename), hdu=hdu, meta=meta,
                          device=device, **kwargs)


def _component_cube(arr, wcs, meta, header, beams, device):
    """One oriented (spec, lat, lon) component on ``device`` with a
    finiteness mask: a SpectralCube, or a VaryingResolutionSpectralCube
    when ``beams`` is given."""
    from ..cube import (SpectralCube, VaryingResolutionSpectralCube,
                        _as_tensor)
    arr, wcs3 = orient(arr, wcs)
    data = _as_tensor(np.ascontiguousarray(arr), device)
    mask = LazyMask(torch.isfinite, data=data, wcs=wcs3)
    if beams is not None:
        return VaryingResolutionSpectralCube(data, wcs3, mask=mask,
                                             meta=dict(meta), header=header,
                                             beams=beams)
    return SpectralCube(data, wcs3, mask=mask, meta=dict(meta),
                        header=header)


def cube_from_hdus(hdus, hdu=0, meta=None, device=None, stokes_to_i=False,
                   **kwargs):
    """Build a cube from parsed HDU objects.

    A 4-D file with several Stokes components raises
    ``NotImplementedError`` (a ``StokesSpectralCube``, ROADMAP.md Queue 1
    item 10) unless ``stokes_to_i``: then the I component is returned with
    a :class:`StokesWarning`, and a file without one raises ``ValueError``
    (reference io/core.py:175-192, the JAX package's cube.py:485-512)."""
    from ..cube import _beams_from_bintable, _beams_from_columns

    ihdu = _find_image_hdu(hdus, hdu)
    header = ihdu.header
    beam_table = _find_beam_table(hdus)
    meta = dict(meta) if meta else {}
    if "BUNIT" in header:
        meta["BUNIT"] = str(header["BUNIT"]).strip()
    data = ihdu.data
    wcs = WCS(header=header)

    if data.ndim == 3:
        beams = _beams_from_bintable(beam_table) \
            if beam_table is not None else None
        return _component_cube(data, wcs, meta, header, beams, device)
    if data.ndim != 4:
        raise FITSReadError(
            f"Data should be 3- or 4-dimensional, got {data.ndim}")

    if beam_table is not None:
        arrays, wcs3, tables = split_stokes(data, wcs, beam_table=beam_table)
    else:
        (arrays, wcs3), tables = split_stokes(data, wcs), None
    names = list(arrays)
    if len(names) > 1:
        if not stokes_to_i:
            raise NotImplementedError(
                f"a 4-D file with Stokes components {names} makes a "
                "StokesSpectralCube, which is not ported to torch yet "
                "(ROADMAP.md Queue 1 item 10); SpectralCube.read returns "
                "its I component")
        if "I" not in names:
            raise ValueError("Spectral cube is a Stokes cube that does not "
                             "have an I component")
        warnings.warn("Cube is a Stokes cube, returning spectral cube for I "
                      "component", StokesWarning)
        names = ["I"]
    name = names[0]
    beams = _beams_from_columns(tables[name], beam_table.units) \
        if tables is not None else None
    return _component_cube(arrays[name], wcs3, meta, header, beams, device)


def write_fits_cube(cube, filename, overwrite=False,
                    include_origin_notes=True):
    """Write a cube, and its BEAMS table if it has one, to FITS (reference
    io/fits.py:263-282)."""
    if os.path.exists(filename) and not overwrite:
        raise OSError(f"{filename} exists; use overwrite=True")
    hdus = cube.hdulist
    if include_origin_notes:
        hdus[0].header.add_history("Written by spectral_cube_tpu_torch")
    write_fits(filename, hdus)
