"""Build the port's cube from the host state of a JAX-package cube.

The two packages share no objects: a JAX cube's state crosses as numpy
arrays and FITS cards, so the same analysis can run in both and be
compared::

    cube_from_arrays(np.asarray(jcube._data), jcube.header,
                     mask=np.asarray(jcube.get_mask_array()),
                     beam=jcube.beam, device="cuda")

A varying-resolution cube crosses with its per-channel beams::

    cube_from_arrays(np.asarray(jvr._data), jvr.header,
                     beams=jvr.unmasked_beams,
                     goodbeams_mask=jvr.goodbeams_mask, device="cuda")

A StokesSpectralCube crosses as a mapping of its components (each
component's mask holds the common mask)::

    cube_from_arrays({k: np.asarray(js.stokes_data[k]._data)
                      for k in js.components},
                     js[js.components[0]].header,
                     mask={k: js[k].get_mask_array() for k in js.components},
                     device="cuda")
"""

from __future__ import annotations

import numpy as np
import torch

from .beams import Beam, Beams
from .io.fits_low import Header
from .masks import BooleanArrayMask, LazyMask
from .wcs import WCS
from .cube import SpectralCube, VaryingResolutionSpectralCube, _as_tensor

__all__ = ["cube_from_arrays"]


def _header(cards):
    if isinstance(cards, (list, tuple)):
        return Header(list(cards))
    return Header([(k, cards[k]) for k in cards])


def _beam(b):
    return Beam(float(b.major_rad), float(b.minor_rad), float(b.pa_rad))


def cube_from_arrays(data, header_cards, mask=None, beam=None, beams=None,
                     goodbeams_mask=None, device=None):
    """A :class:`SpectralCube` on ``device`` from oriented (spec, lat, lon)
    ``data``, the FITS cards of its header (a mapping or (key, value)
    pairs, WCS axes in [lon, lat, spec] order), an optional include
    ``mask`` broadcastable to the data, and an optional beam (any object
    with ``major_rad``/``minor_rad``/``pa_rad``; default: the header's
    BMAJ/BMIN/BPA).  Without a mask, non-finite voxels are excluded, as a
    cube read from FITS has it.

    ``beams`` (a sequence of such objects, one per channel) makes a
    :class:`VaryingResolutionSpectralCube` instead, with the optional
    ``goodbeams_mask`` of its channels.

    ``data`` as a mapping of Stokes component names to arrays (and
    ``mask``, if given, a mapping of the same names) makes a
    :class:`~.stokes.StokesSpectralCube` of such cubes, sharing the
    header."""
    if isinstance(data, dict):
        from .stokes import StokesSpectralCube
        return StokesSpectralCube({
            name: cube_from_arrays(
                arr, header_cards, mask=None if mask is None else mask[name],
                beam=beam, beams=beams, goodbeams_mask=goodbeams_mask,
                device=device)
            for name, arr in data.items()})
    header = _header(header_cards)
    wcs = WCS(header=header)
    meta = {"BUNIT": str(header["BUNIT"]).strip()} if "BUNIT" in header \
        else {}
    tensor = _as_tensor(np.asarray(data), device)
    cube_mask = BooleanArrayMask(np.asarray(mask, dtype=bool), wcs=wcs,
                                 shape=tuple(tensor.shape)) \
        if mask is not None else LazyMask(torch.isfinite, data=tensor,
                                          wcs=wcs)
    if beams is not None:
        return VaryingResolutionSpectralCube(
            tensor, wcs, mask=cube_mask, meta=meta, header=header,
            beams=Beams(beams=[_beam(b) for b in beams]),
            goodbeams_mask=goodbeams_mask)
    return SpectralCube(tensor, wcs, mask=cube_mask, meta=meta,
                        header=header,
                        beam=_beam(beam) if beam is not None else None)
