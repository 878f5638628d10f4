"""Cube I/O registry: FITS files, CASA images and GILDAS CLASS .lmv cubes.

Port of ``spectral_cube_tpu/io/__init__.py``: a small registry keyed by
format name, with the format detected from the path when none is given
(a directory holding ``table.dat`` is a CASA image, a ``.lmv`` suffix a
CLASS cube, a FITS signature or suffix a FITS file).  Every loader puts
the cube on ``device``: the CUDA device unless the caller asks for
another.
"""

from __future__ import annotations

import os

import numpy as np

from .fits_low import is_fits, Header, HDU, BinTableHDU, read_fits, write_fits
from .fits import (load_fits_cube, cube_from_hdus, write_fits_cube,
                   write_fits_stokes)

__all__ = ["read_cube", "write_cube", "read_stokes_cube",
           "write_stokes_cube", "Header", "HDU", "BinTableHDU"]


def _detect_format(filename):
    name = str(filename)
    if os.path.isdir(name) and os.path.exists(os.path.join(name,
                                                           "table.dat")):
        return "casa_image"
    if name.lower().endswith(".lmv"):
        return "class_lmv"
    if is_fits(name):
        return "fits"
    if name.lower().endswith((".fits", ".fit")):
        return "fits"
    raise ValueError(f"Cannot determine format of {filename!r}; "
                     "pass format= explicitly")


def _as_native_hdu(obj):
    """Coerce a foreign HDU-like (anything with .header/.data, e.g. an
    astropy PrimaryHDU) into a native HDU without serializing it."""
    if isinstance(obj, (HDU, BinTableHDU)):
        return obj
    header = obj.header
    if not isinstance(header, Header):
        native = Header()
        for key, value in header.items():
            if key in ("COMMENT", "HISTORY", ""):
                continue
            native[str(key)] = value
        header = native
    return HDU(data=np.asarray(obj.data), header=header,
               name=getattr(obj, "name", None))


def read_cube(filename, format=None, hdu=0, device=None, stokes_to_i=False,
              **kwargs):
    """A cube from a file or from HDU objects, on ``device``.

    ``filename`` may be a path, a native HDU, a list of HDUs, or any
    object with ``.header`` and ``.data`` (an astropy HDU, say), which is
    used as it is, without a temporary file.  A multi-Stokes file gives a
    StokesSpectralCube, or its I component with ``stokes_to_i=True``."""
    if isinstance(filename, (HDU, list)) or (
            not isinstance(filename, (str, os.PathLike))
            and hasattr(filename, "header") and hasattr(filename, "data")):
        hdus = filename if isinstance(filename, list) else [filename]
        return cube_from_hdus([_as_native_hdu(h) for h in hdus], hdu=hdu,
                              device=device, stokes_to_i=stokes_to_i,
                              **kwargs)
    format = format or _detect_format(filename)
    if format == "fits":
        return load_fits_cube(filename, hdu=hdu, device=device,
                              stokes_to_i=stokes_to_i, **kwargs)
    if format in ("casa_image", "casa"):  # both names, like the
        # reference registry (io/casa_image.py:230-231)
        from .casa_image import load_casa_image
        return load_casa_image(filename, device=device,
                               stokes_to_i=stokes_to_i, **kwargs)
    if format in ("class_lmv", "lmv"):
        from .class_lmv import load_lmv_cube
        return load_lmv_cube(filename, device=device,
                             stokes_to_i=stokes_to_i, **kwargs)
    raise ValueError(f"Unknown format {format!r}")


def write_cube(cube, filename, overwrite=False, format=None):
    name = str(filename).lower()
    if format is None:
        format = "casa_image" if name.endswith((".image", ".im")) else "fits"
    if format == "fits":
        write_fits_cube(cube, filename, overwrite=overwrite)
    elif format in ("casa_image", "casa"):
        from .casa_writer import write_casa_image
        write_casa_image(cube, filename, overwrite=overwrite)
    else:
        raise ValueError(f"Unknown format {format!r}")


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
    """Write a Stokes cube as one 4-D FITS file.  ``format`` is accepted
    and not read, as in the JAX package (its io/__init__.py:98-99): a
    ``.image`` name still gets FITS bytes."""
    write_fits_stokes(stokes_cube, filename, overwrite=overwrite)
