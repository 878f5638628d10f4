"""Build the port's cube from the host state of a JAX-package cube.

The two packages share no objects: a JAX cube's state crosses as numpy
arrays and FITS cards, so the same analysis can run in both and be
compared::

    cube_from_arrays(np.asarray(jcube._data), jcube.header,
                     mask=np.asarray(jcube.get_mask_array()),
                     beam=jcube.beam, device="cuda")
"""

from __future__ import annotations

import numpy as np
import torch

from .beams import Beam
from .io.fits_low import Header
from .masks import BooleanArrayMask, LazyMask
from .wcs import WCS
from .cube import SpectralCube

__all__ = ["cube_from_arrays"]


def _header(cards):
    if isinstance(cards, (list, tuple)):
        return Header(list(cards))
    return Header([(k, cards[k]) for k in cards])


def cube_from_arrays(data, header_cards, mask=None, beam=None, device=None):
    """A :class:`SpectralCube` on ``device`` from oriented (spec, lat, lon)
    ``data``, the FITS cards of its header (a mapping or (key, value)
    pairs, WCS axes in [lon, lat, spec] order), an optional include
    ``mask`` broadcastable to the data, and an optional beam (any object
    with ``major_rad``/``minor_rad``/``pa_rad``; default: the header's
    BMAJ/BMIN/BPA).  Without a mask, non-finite voxels are excluded, as a
    cube read from FITS has it."""
    header = _header(header_cards)
    wcs = WCS(header=header)
    if beam is not None:
        beam = Beam(float(beam.major_rad), float(beam.minor_rad),
                    float(beam.pa_rad))
    meta = {"BUNIT": str(header["BUNIT"]).strip()} if "BUNIT" in header \
        else {}
    cube = SpectralCube(np.asarray(data), wcs, meta=meta, header=header,
                        beam=beam, device=device)
    cube._mask = BooleanArrayMask(np.asarray(mask, dtype=bool), wcs=wcs,
                                  shape=cube.shape) if mask is not None \
        else LazyMask(torch.isfinite, data=cube._data, wcs=wcs)
    return cube
