"""CASA image reading onto a torch device.

Port of ``spectral_cube_tpu/io/casa_image.py``.  The table system is
parsed on the host (:mod:`.casa_low`): pixel data and the boolean
validity mask from their tiled storage managers, the coordinate system
from the ``coords`` record, single or per-plane beams from ``imageinfo``,
and the brightness unit from ``units``.  The data then moves to the
requested device (the CUDA device unless the caller asks for another),
float64 images as float32 as the JAX package stores them; the stored
validity mask goes there once, beside it, and is ``and``-ed with the
finiteness of the data.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .casa_low import read_casa_image_parts
from .fits import stokes_components
from ..cube_utils import orient, split_stokes
from ..masks import BooleanArrayMask, LazyMask, CompositeMask
from ..utils import FITSReadError

__all__ = ["load_casa_image", "is_casa_image"]


def is_casa_image(path) -> bool:
    name = str(path)
    return os.path.isdir(name) and os.path.exists(
        os.path.join(name, "table.dat"))


def load_casa_image(filename, skipdata=False, skipvalid=False, skipcs=False,
                    device=None, stokes_to_i=False, **kwargs):
    """Load a CASA .image directory onto ``device`` (default: the CUDA
    device; raises where CUDA is absent unless ``device='cpu'``).  A 3-D
    image gives a cube, a 4-D image one cube per Stokes component (a
    :class:`~..stokes.StokesSpectralCube` when there are several, or with
    ``stokes_to_i`` the I component alone, the others never leaving the
    host), a 2-D image a host
    :class:`~..lower_dimensional_structures.Projection`."""
    from ..cube import (SpectralCube, VaryingResolutionSpectralCube,
                        _as_tensor, default_device)
    from ..stokes import StokesSpectralCube
    from ..beams import Beam, Beams

    if not is_casa_image(filename):
        raise FITSReadError(f"{filename!r} is not a CASA image directory")
    device = torch.device(device) if device is not None else default_device()

    data, valid, wcs, unit, beams, misc = read_casa_image_parts(
        str(filename))
    meta = {"filename": str(filename)}
    meta.update(misc)
    if unit:
        meta["BUNIT"] = unit

    def build_cube(arr3, valid3, wcs3, cube_beams):
        arr3, wcs_o = orient(arr3, wcs3)
        tdata = _as_tensor(np.ascontiguousarray(arr3), device)
        mask = LazyMask(torch.isfinite, data=tdata, wcs=wcs_o)
        if valid3 is not None:
            v3, _ = orient(valid3, wcs3)
            stored = torch.as_tensor(np.ascontiguousarray(v3, dtype=bool),
                                     device=device)
            mask = CompositeMask(
                mask, BooleanArrayMask(stored, wcs=wcs_o,
                                       shape=tuple(arr3.shape)), "and")
        if isinstance(cube_beams, Beams):
            return VaryingResolutionSpectralCube(
                tdata, wcs_o, mask=mask, meta=dict(meta), beams=cube_beams)
        return SpectralCube(tdata, wcs_o, mask=mask, meta=dict(meta),
                            beam=cube_beams)

    if data.ndim == 3:
        if isinstance(beams, list):
            beams = beams[0]
        return build_cube(data, valid, wcs, beams)
    if data.ndim == 4:
        arrays, wcs3 = split_stokes(data, wcs)
        valid_arrays = {}
        if valid is not None:
            valid_arrays, _ = split_stokes(valid, wcs)

        # per-plane beams are per-Stokes (stokes-major keys); a single
        # Beams applies to every component
        def _beams_for(i):
            if isinstance(beams, list):
                return beams[i] if i < len(beams) else None
            return beams
        order = list(arrays)
        cubes = {name: build_cube(arrays[name], valid_arrays.get(name), wcs3,
                                  _beams_for(order.index(name)))
                 for name in stokes_components(order, stokes_to_i)}
        if len(cubes) == 1:
            return next(iter(cubes.values()))
        return StokesSpectralCube(cubes, meta=meta)
    if data.ndim == 2:
        from ..lower_dimensional_structures import Projection
        from ..units import parse_bunit
        return Projection(data, unit=parse_bunit(unit) if unit else None,
                          wcs=wcs, meta=meta,
                          beam=beams if isinstance(beams, Beam) else None)
    raise FITSReadError(f"unsupported CASA image dimensionality "
                        f"{data.ndim}")
