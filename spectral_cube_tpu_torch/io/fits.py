"""FITS cube reader and writer.

Port of ``spectral_cube_tpu/io/fits.py``: a 3-D image HDU loads as a
:class:`~..cube.SpectralCube` on the requested device, with a finiteness
mask (reference io/fits.py:214); a ``BEAMS`` table makes it a
:class:`~..cube.VaryingResolutionSpectralCube` (reference io/fits.py:96-131);
a 4-D file splits per Stokes component (reference io/fits.py:229-253):
one component returns that cube, several a
:class:`~..stokes.StokesSpectralCube` (or its I component, when
``SpectralCube.read`` asks).  Writing stamps a history card (reference
io/fits.py:263-282) and appends a varying-resolution cube's BEAMS table;
a StokesSpectralCube writes as one 4-D file.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .fits_low import read_fits, write_fits, is_fits, BinTableHDU, HDU
from ..wcs import WCS
from ..masks import LazyMask
from ..utils import FITSReadError, StokesWarning
from ..cube_utils import orient, split_stokes

__all__ = ["load_fits_cube", "cube_from_hdus", "write_fits_cube",
           "write_fits_stokes", "is_fits"]


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


def stokes_components(names, stokes_to_i):
    """The Stokes components to build: all of ``names``, or with
    ``stokes_to_i`` and several of them only I, with a
    :class:`StokesWarning`; a file without I then raises ``ValueError``
    (reference io/core.py:175-192, the JAX package's cube.py:485-512)."""
    if len(names) <= 1 or not stokes_to_i:
        return names
    if "I" not in names:
        raise ValueError("Spectral cube is a Stokes cube that does not "
                         "have an I component")
    warnings.warn("Cube is a Stokes cube, returning spectral cube for I "
                  "component", StokesWarning)
    return ["I"]


def cube_from_hdus(hdus, hdu=0, meta=None, device=None, stokes_to_i=False,
                   **kwargs):
    """Build a cube from parsed HDU objects.

    A 4-D file with several Stokes components gives a
    :class:`~..stokes.StokesSpectralCube`, or with ``stokes_to_i`` its I
    component and a :class:`StokesWarning`; a file without one then
    raises ``ValueError`` (reference io/core.py:175-192, the JAX package's
    cube.py:485-512)."""
    from ..cube import _beams_from_bintable, _beams_from_columns
    from ..stokes import StokesSpectralCube

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
    names = stokes_components(list(arrays), stokes_to_i)
    cubes = {name: _component_cube(
        arrays[name], wcs3, meta, header,
        _beams_from_columns(tables[name], beam_table.units)
        if tables is not None else None, device) for name in names}
    if len(cubes) == 1:
        return next(iter(cubes.values()))
    return StokesSpectralCube(cubes, meta=meta)


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


def write_fits_stokes(stokes_cube, filename, overwrite=False):
    """Write a StokesSpectralCube as a 4-D FITS file."""
    if os.path.exists(filename) and not overwrite:
        raise OSError(f"{filename} exists; use overwrite=True")
    comps = stokes_cube.components
    ref = stokes_cube[comps[0]]
    data4 = np.stack([stokes_cube[c]._get_filled_data().cpu().numpy()
                      for c in comps], axis=0)
    h = ref.header
    h["NAXIS"] = 4
    h["WCSAXES"] = 4
    h["NAXIS4"] = len(comps)
    h["CTYPE4"] = "STOKES"
    from ..stokes import STOKES_SYMBOLS
    sym_by_name = {v: k for k, v in STOKES_SYMBOLS.items()}
    codes = [float(sym_by_name.get(c, 1)) for c in comps]
    # a FITS STOKES axis is linear (code = CRVAL4 + CDELT4*(i+1-CRPIX4));
    # non-arithmetic component sets (e.g. {I, V}) cannot be labeled on one
    # axis — refuse rather than silently relabel them on read-back
    steps = np.diff(codes)
    if len(codes) > 1 and not np.all(steps == steps[0]):
        raise ValueError(
            f"Stokes components {comps} have codes {codes} that do not "
            "form an arithmetic sequence and cannot share a linear FITS "
            "STOKES axis; write the components separately")
    h["CRVAL4"] = codes[0]
    h["CDELT4"] = float(steps[0]) if len(codes) > 1 else 1.0
    h["CRPIX4"] = 1.0
    h["CUNIT4"] = ""
    write_fits(filename, [HDU(data=data4, header=h)])
