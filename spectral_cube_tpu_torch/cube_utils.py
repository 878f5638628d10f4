"""Cube helpers: axis orientation and the huge-operation policy.

Port of the parts of ``spectral_cube_tpu/cube_utils.py`` the FITS reader
and the cube need; the rest follows in ROADMAP.md Queue 1 item 10.
"""

from __future__ import annotations

from .utils import MEMORY_THRESHOLD
from .wcs import WCS

__all__ = ["orient", "canon_view", "is_huge"]


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
