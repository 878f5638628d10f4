"""Cube I/O: FITS files (other formats follow in ROADMAP.md Queue 1
item 11)."""

from __future__ import annotations

import os

from .fits_low import is_fits, Header, HDU, BinTableHDU, read_fits, write_fits
from .fits import (load_fits_cube, cube_from_hdus, write_fits_cube,
                   write_fits_stokes)

__all__ = ["read_cube", "write_cube", "read_stokes_cube",
           "write_stokes_cube", "Header", "HDU", "BinTableHDU"]


def read_cube(filename, format=None, hdu=0, device=None, **kwargs):
    """A cube from a FITS file or parsed HDUs (``io/fits.cube_from_hdus``):
    a multi-Stokes file gives a StokesSpectralCube, or its I component
    with ``stokes_to_i=True``."""
    if isinstance(filename, (HDU, list)):
        hdus = filename if isinstance(filename, list) else [filename]
        return cube_from_hdus(hdus, hdu=hdu, device=device, **kwargs)
    name = str(filename)
    if format is None and (is_fits(name)
                           or name.lower().endswith((".fits", ".fit"))):
        format = "fits"
    if format != "fits":
        raise NotImplementedError(
            f"format {format!r} of {filename!r}: only FITS is ported to "
            "torch so far (ROADMAP.md Queue 1 item 11)")
    return load_fits_cube(name, hdu=hdu, device=device, **kwargs)


def write_cube(cube, filename, overwrite=False, format=None):
    if format not in (None, "fits"):
        raise NotImplementedError(
            f"format {format!r}: only FITS is ported to torch so far "
            "(ROADMAP.md Queue 1 item 11)")
    write_fits_cube(cube, filename, overwrite=overwrite)


def read_stokes_cube(filename, format=None, hdu=0, device=None, **kwargs):
    """A :class:`~..stokes.StokesSpectralCube`; a file of one component
    gives one holding it as I."""
    out = read_cube(filename, format=format, hdu=hdu, device=device,
                    **kwargs)
    from ..stokes import StokesSpectralCube
    if isinstance(out, StokesSpectralCube):
        return out
    return StokesSpectralCube({"I": out})


def write_stokes_cube(stokes_cube, filename, overwrite=False, format=None):
    if format not in (None, "fits"):
        raise NotImplementedError(
            f"format {format!r}: only FITS is ported to torch so far "
            "(ROADMAP.md Queue 1 item 11)")
    write_fits_stokes(stokes_cube, filename, overwrite=overwrite)
