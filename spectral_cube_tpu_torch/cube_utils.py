"""Cube helpers: axis orientation, Stokes splitting, brightness-unit
conversion factors, world coordinates of per-axis indices and the
huge-operation policy.

Port of the parts of ``spectral_cube_tpu/cube_utils.py`` the FITS reader,
the cube and its lower-dimensional results need; ``mosaic_cubes``,
``combine_headers`` and the beam-table helpers follow in ROADMAP.md
Queue 1 item 10c.
"""

from __future__ import annotations

import numpy as np

from . import units as u
from .units import Quantity, Unit
from .utils import MEMORY_THRESHOLD
from .wcs import WCS

__all__ = ["orient", "split_stokes", "canon_view", "is_huge",
           "bunit_converters", "world_take_along_axis", "convert_bunit",
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


def _has_beam(obj):
    """reference cube_utils.py:558-562."""
    return getattr(obj, "_beam", None) is not None


def _has_beams(obj):
    """reference cube_utils.py:565-569."""
    return getattr(obj, "_beams", None) is not None


def bunit_converters(obj, unit, equivalencies=(), freq=None):
    """Conversion factor(s) from ``obj.unit`` to ``unit`` for brightness
    units (K, Jy/beam, Jy/sr, Jy/pix), handling per-channel factors when the
    conversion is frequency-dependent or beams vary per channel.

    Returns a 1-element array (constant factor) or an (nchan,) array.
    """
    unit = Unit.parse(unit) if isinstance(unit, str) else unit
    cur = obj.unit

    if cur.is_equivalent(unit, equivalencies):
        return np.array([cur.to(unit, 1.0, equivalencies)])

    K = u.K
    jybm = u.Jy / u.beam
    jysr = u.Jy / u.sr
    jypix = u.Jy / u.pix

    has_btemp = cur.is_equivalent(K) or unit.is_equivalent(K)
    has_perbeam = cur.is_equivalent(jybm) or unit.is_equivalent(jybm)
    has_perangarea = cur.is_equivalent(jysr) or unit.is_equivalent(jysr)
    has_perpix = cur.is_equivalent(jypix) or unit.is_equivalent(jypix)

    def _safe(name):
        # Projection.beam / OneDSpectrum.beam raise ValueError, and a
        # cube's beam NoBeamError, when unset: getattr's default misses both
        from .beams import NoBeamError
        try:
            return getattr(obj, name, None)
        except (ValueError, NoBeamError):
            return None
    beams = _safe("unmasked_beams")
    beam = _safe("beam")
    has_beams = beams is not None
    has_beam = beam is not None or has_beams

    # frequency axis (Hz) for brightness-temperature factors
    if has_btemp or has_perbeam or has_perangarea:
        if freq is None:
            if not hasattr(obj, "with_spectral_unit"):
                if has_btemp:
                    raise TypeError(
                        "`freq` must be provided for unit conversion "
                        "involving brightness temperature on an object "
                        "without a spectral axis")
                # beam/solid-angle-only conversions (Jy/pix <-> Jy/sr,
                # Jy/beam <-> Jy/sr) never evaluate the frequency
                freqs = np.array([np.nan])
            else:
                # convert via the WCS (handles velocity axes using
                # RESTFRQ, like the reference obj.with_spectral_unit(Hz))
                freqs = np.atleast_1d(np.asarray(
                    obj.with_spectral_unit(u.Hz).spectral_axis.value,
                    dtype=float))
        else:
            if isinstance(freq, Quantity):
                freqs = np.atleast_1d(freq.to_value(
                    "Hz", equivalencies=u.spectral()))
            else:
                freqs = np.atleast_1d(np.asarray(freq, dtype=float))
    else:
        freqs = np.array([np.nan])

    pix_area = None
    if has_perpix or has_perangarea:
        pix_area = obj.wcs.proj_plane_pixel_area() * (np.pi / 180.0) ** 2

    if has_beams:
        beam_list = list(beams)
        if len(freqs) == 1:
            freqs = np.repeat(freqs, len(beam_list))
    else:
        beam_list = [beam]

    def one_factor(bm, f):
        eqv = list(equivalencies) + list(u.spectral())
        if bm is not None and (has_perbeam or has_btemp or has_perangarea):
            eqv += u.brightness_temperature(bm.sr, Quantity(f, "Hz"))
            eqv += u.beam_solid_angle(bm.sr)
        elif has_perangarea and has_btemp:
            # Jy/sr <-> K without a beam: solid angle of 1 sr
            eqv += u.brightness_temperature(Quantity(1.0, "sr"),
                                            Quantity(f, "Hz"))
        if pix_area is not None:
            eqv += u.pixel_scale(Quantity(pix_area, "sr"))
            if bm is not None:
                ratio = float(bm.sr.value) / pix_area
                eqv += [
                    (u._dims(kg=1, s=-2, pix=-1), u._dims(kg=1, s=-2,
                                                          beam=-1),
                     lambda x, r=ratio: x * r, lambda x, r=ratio: x / r),
                ]
        return cur.to(unit, 1.0, eqv)

    if has_beams or (len(freqs) > 1 and (has_btemp or has_perbeam
                                         or has_perangarea)):
        if has_beams:
            return np.array([one_factor(b, f)
                             for b, f in zip(beam_list, freqs)])
        return np.array([one_factor(beam, f) for f in freqs])
    return np.array([one_factor(beam, freqs[0])])


def world_take_along_axis(cube, position_plane, axis):
    """Convert a plane of pixel indices along ``axis`` into world coords
    (reference cube_utils.py:510-555): used by argmax_world/argmin_world.

    Requires the pixel axis to map to exactly one world axis (the
    axis-correlation gate, reference wcs_utils.py:493); raises
    WCSCelestialError otherwise — on a celestial projection the spatial
    pixel axes always couple through lon/lat, so like the reference this
    works spatially only for separable WCS."""
    from .utils import WCSCelestialError
    if cube.wcs.is_pixel_axis_correlated(2 - axis):
        raise WCSCelestialError(
            "world_take_along_axis requires the celestial axes to be "
            "aligned along image axes.")
    pos = np.asarray(position_plane)
    if axis == 0:
        sv = cube.spectral_axis.value
        out = np.asarray(sv)[pos]
        return Quantity(out, cube.spectral_axis.unit)
    # spatial axes: 1-D world spine along the axis (separability holds by
    # the gate above), indexed by the position plane
    world_slice = [0, 0]
    world_slice.insert(axis, slice(None))
    coords = cube.world[tuple(world_slice)][axis]
    spine = np.asarray(coords.value)
    out = np.take_along_axis(
        spine[tuple(np.newaxis if i != axis else slice(None)
                    for i in range(3))],
        pos[tuple(slice(None) if i != axis else np.newaxis
                  for i in range(3))], axis=axis).squeeze(axis)
    return Quantity(out, coords.unit)


def convert_bunit(bunit):
    """Forgiving BUNIT parse: a Unit, or None with a warning
    (reference cube_utils.py:478-508)."""
    return u.parse_bunit(bunit)


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
