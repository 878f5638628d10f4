"""FITS cube reader and writer, 3-D single-beam cubes.

Port of ``spectral_cube_tpu/io/fits.py`` for the analysis path: a 3-D
image HDU loads as a :class:`~..cube.SpectralCube` on the requested
device, with a finiteness mask (reference io/fits.py:214); writing stamps a
history card (reference io/fits.py:263-282).  4-D (Stokes) files and
BEAMS tables (varying-resolution cubes) follow in ROADMAP.md Queue 1
items 10 and 5.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .fits_low import read_fits, write_fits, is_fits, BinTableHDU
from ..wcs import WCS
from ..masks import LazyMask
from ..utils import FITSReadError
from ..cube_utils import orient

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


def load_fits_cube(filename, hdu=0, meta=None, device=None, **kwargs):
    """Read a 3-D FITS cube onto ``device`` (reference
    io/fits.py:171-260)."""
    return cube_from_hdus(read_fits(filename), hdu=hdu, meta=meta,
                          device=device, **kwargs)


def cube_from_hdus(hdus, hdu=0, meta=None, device=None, **kwargs):
    """Build a cube from parsed HDU objects."""
    from ..cube import SpectralCube

    ihdu = _find_image_hdu(hdus, hdu)
    header = ihdu.header
    if any(isinstance(h, BinTableHDU) and h.name.strip().upper() == "BEAMS"
           for h in hdus):
        raise NotImplementedError(
            "varying-resolution cubes (a BEAMS table) are not ported to "
            "torch yet (ROADMAP.md Queue 1 item 5)")
    meta = dict(meta) if meta else {}
    if "BUNIT" in header:
        meta["BUNIT"] = str(header["BUNIT"]).strip()
    data = ihdu.data
    if data.ndim != 3:
        raise NotImplementedError(
            f"only 3-D cubes are ported to torch so far, got {data.ndim}-D "
            "(ROADMAP.md Queue 1 item 10)")
    data, wcs3 = orient(data, WCS(header=header))
    cube = SpectralCube(np.ascontiguousarray(data), wcs3, meta=meta,
                        header=header, device=device)
    cube._mask = LazyMask(torch.isfinite, data=cube._data, wcs=wcs3)
    return cube


def write_fits_cube(cube, filename, overwrite=False,
                    include_origin_notes=True):
    """Write a cube to FITS (reference io/fits.py:263-282)."""
    if os.path.exists(filename) and not overwrite:
        raise OSError(f"{filename} exists; use overwrite=True")
    hdus = cube.hdulist
    if include_origin_notes:
        hdus[0].header.add_history("Written by spectral_cube_tpu_torch")
    write_fits(filename, hdus)
