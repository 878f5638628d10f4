"""Cube helpers: axis orientation, Stokes splitting and the huge-operation
policy.

Port of the parts of ``spectral_cube_tpu/cube_utils.py`` the FITS reader
and the cube need; the rest follows in ROADMAP.md Queue 1 item 10.
"""

from __future__ import annotations

import numpy as np

from .utils import MEMORY_THRESHOLD
from .wcs import WCS

__all__ = ["orient", "split_stokes", "canon_view", "is_huge",
           "STOKES_SYMBOLS"]

# FITS/CASA Stokes axis symbols (the JAX package's stokes.py:19-30,
# reference stokes_spectral_cube.py:21-42)
STOKES_SYMBOLS = {
    1: "I", 2: "Q", 3: "U", 4: "V",
    -1: "RR", -2: "LL", -3: "RL", -4: "LR",
    -5: "XX", -6: "YY", -7: "XY", -8: "YX",
    # CASA extensions (-9..-28): RX..Pangle
    -9: "RX", -10: "RY", -11: "LX", -12: "LY",
    -13: "XR", -14: "XL", -15: "YR", -16: "YL",
    -17: "PP", -18: "PQ", -19: "QP", -20: "QQ",
    -21: "RCircular", -22: "LCircular", -23: "Linear",
    -24: "Ptotal", -25: "Plinear", -26: "PFtotal", -27: "PFlinear",
    -28: "Pangle",
}


def orient(array, wcs: WCS):
    """Transpose a 3-D array + WCS so the numpy axes are [spec, lat, lon]
    (WCS axes [lon, lat, spec]).  Reference semantics: cube_utils._orient.
    """
    if array.ndim != 3:
        raise ValueError("Input array must be 3-dimensional")
    if wcs.naxis != 3:
        raise ValueError("Input WCS must be 3-dimensional")
    kinds = wcs.axis_kinds
    if kinds.count("lon") != 1 or kinds.count("lat") != 1:
        raise ValueError("WCS should contain 2 celestial dimensions")
    if kinds.count("spectral") != 1:
        raise ValueError("WCS should contain one spectral dimension")
    # numpy axis i corresponds to wcs axis (naxis-1-i)
    np_kinds = kinds[::-1]
    t = [np_kinds.index("spectral"), np_kinds.index("lat"),
         np_kinds.index("lon")]
    if t != [0, 1, 2]:
        array = array.transpose(t)
    out_wcs = wcs.reindex([kinds.index("lon"), kinds.index("lat"),
                           kinds.index("spectral")])
    return array, out_wcs


def split_stokes(array, wcs: WCS, beam_table=None):
    """Split a 4-D (stokes) array into per-component 3-D arrays + 3-D WCS
    (reference cube_utils.py:49-138).

    Returns (dict name->array, wcs3d[, dict name->beam_table_rows]).
    """
    if array.ndim not in (3, 4):
        raise ValueError("Input array must be 3- or 4-dimensional for a "
                         "STOKES cube")
    if wcs.naxis != 4:
        raise ValueError("Input WCS must be 4-dimensional for a STOKES cube")
    kinds = wcs.axis_kinds
    if "stokes" in kinds:
        stokes_wcs_ax = kinds.index("stokes")
    else:
        # assume the non-celestial, non-spectral axis is stokes
        cands = [i for i, k in enumerate(kinds)
                 if k not in ("lon", "lat", "spectral")]
        if not cands:
            raise IOError("There are 4 axes in the data cube but no STOKES "
                          "axis could be identified")
        stokes_wcs_ax = cands[0]
    stokes_np_ax = wcs.naxis - 1 - stokes_wcs_ax

    crval = int(round(wcs.crval[stokes_wcs_ax]))
    cdelt = int(round(wcs.cdelt[stokes_wcs_ax])) or 1
    crpix = wcs.crpix[stokes_wcs_ax]

    wcs3 = wcs.dropaxis(stokes_wcs_ax)
    arrays = {}
    tables = {}
    if array.ndim == 4:
        n = array.shape[stokes_np_ax]
        for i in range(n):
            sym = crval + cdelt * int(i + 1 - crpix)
            name = STOKES_SYMBOLS.get(sym, f"S{sym}")
            sl = [slice(None)] * 4
            sl[stokes_np_ax] = i
            arrays[name] = array[tuple(sl)]
            if beam_table is not None:
                if "POL" in beam_table.columns:
                    rows = np.asarray(beam_table["POL"]) == i
                    if not rows.any():
                        # one shared per-channel table (NPOL=1) serving
                        # every stokes plane: reuse all rows
                        rows = slice(None)
                else:
                    rows = slice(None)
                tables[name] = {k: np.asarray(v)[rows]
                                for k, v in beam_table.columns.items()}
    else:
        arrays["I"] = array
        if beam_table is not None:
            tables["I"] = {k: np.asarray(v)
                           for k, v in beam_table.columns.items()}
    if beam_table is not None:
        return arrays, wcs3, tables
    return arrays, wcs3


def _has_beams(obj):
    """reference cube_utils.py:565-569."""
    return getattr(obj, "_beams", None) is not None


def canon_view(view, shape):
    """Canonicalize negative/None slice bounds against ``shape``.

    ``WCS.slice`` treats ``start`` as a raw pixel offset, so ``arr[-4:]``
    would shift crpix the wrong way by ~n pixels without this.
    ``indices()`` returns stop=-1 for a full negative-step slice, which
    would re-read as empty — map it back to None."""
    def _canon(v, n):
        start, stop, step = v.indices(n)
        if step < 0 and stop < 0:
            stop = None
        return slice(start, stop, step)
    return tuple(_canon(v, n) if isinstance(v, slice) else v
                 for v, n in zip(view, shape))


def is_huge(cube) -> bool:
    """True if the cube is large enough that whole-cube host
    materialization should be guarded (reference cube_utils.py:270-275)."""
    return cube.size >= MEMORY_THRESHOLD
