"""Cube helpers: axis orientation, Stokes splitting, brightness-unit
conversion factors, world coordinates of per-axis indices, the
huge-operation policy, mosaics and the beam-table helpers.

Port of ``spectral_cube_tpu/cube_utils.py``.  :func:`mosaic_cubes`
reprojects each cube through ``ops/regrid.mosaic_add`` into accumulators
on the first cube's device.
"""

from __future__ import annotations

import numpy as np

from . import units as u
from .units import Quantity, Unit
from .utils import MEMORY_THRESHOLD
from .wcs import WCS

__all__ = ["orient", "split_stokes", "canon_view", "is_huge",
           "bunit_converters", "world_take_along_axis", "convert_bunit",
           "STOKES_SYMBOLS", "mosaic_cubes", "combine_headers",
           "largest_beam", "smallest_beam", "iterator_strategy",
           "try_load_beam", "try_load_beams", "beams_to_bintable",
           "beam_props"]

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


def iterator_strategy(cube, axis=None) -> str:
    """The reference's ``how=`` recommendation (cube_utils.py:277-301),
    kept for API compatibility: every reduction here is one pass over the
    device tensor, whatever the answer."""
    if cube.size < MEMORY_THRESHOLD:
        return "cube"
    return "slice"


def mosaic_cubes(cubes, target_header=None, order="bilinear",
                 combine="mean"):
    """Mosaic cubes onto a common celestial grid (the JAX package's
    cube_utils.py:270-305; reference cube_utils.py:791-856): each cube is
    reprojected onto ``target_header`` (by default the
    :func:`combine_headers` of all of them) and added with its footprint
    as weight into float32 accumulators on the first cube's device; the
    result is their ratio where any weight is positive, NaN elsewhere."""
    import torch
    from .ops.regrid import mosaic_add
    from .masks import BooleanArrayMask
    from .cube import SpectralCube

    if len(cubes) < 1:
        raise ValueError("need at least one cube")
    if target_header is None:
        target_header = cubes[0].header
        for c in cubes[1:]:
            target_header = combine_headers(target_header, c.header)
    nz = int(target_header.get("NAXIS3", cubes[0].shape[0]))
    ny = int(target_header["NAXIS2"])
    nx = int(target_header["NAXIS1"])
    dev = cubes[0].device
    accum = torch.zeros((nz, ny, nx), dtype=torch.float32, device=dev)
    weights = torch.zeros_like(accum)
    for c in cubes:
        accum, weights = mosaic_add(
            accum, weights, c._get_filled_data(fill=np.nan).to(dev), c.wcs,
            target_header, order=order,
            spectral_values_in=np.asarray(c.spectral_axis.value))
    covered = weights > 0
    out = torch.where(covered, accum / torch.where(covered, weights, 1.0),
                      float("nan"))
    del accum, weights
    out_wcs = WCS(header=target_header)
    return SpectralCube(out, out_wcs,
                        mask=BooleanArrayMask(covered, wcs=out_wcs,
                                              shape=tuple(out.shape)),
                        meta=dict(cubes[0].meta), unit=cubes[0].unit,
                        beam=getattr(cubes[0], "_beam", None))


def combine_headers(header1, header2):
    """The celestial header covering both inputs' footprints (the JAX
    package's cube_utils.py:308-373, a simplified analog of the
    reference's ``reproject.find_optimal_celestial_wcs``): the pixel-edge
    corners of both, in a candidate projection centred on their extent, at
    the finer pixel size; the spectral cards come from ``header1``."""
    from .io.fits_low import Header
    w1, w2 = WCS(header=header1), WCS(header=header2)
    lons, lats = [], []
    for w, h in ((w1, header1), (w2, header2)):
        nx = int(h["NAXIS1"])
        ny = int(h["NAXIS2"])
        xs = np.array([-0.5, nx - 0.5, -0.5, nx - 0.5])
        ys = np.array([-0.5, -0.5, ny - 0.5, ny - 0.5])
        lon, lat = w.celestial.pix2world(xs, ys)
        lons.append(np.asarray(lon))
        lats.append(np.asarray(lat))
    lon_all = np.concatenate(lons)
    lat_all = np.concatenate(lats)
    # unwrap longitudes about the first cube's centre
    lon0 = lons[0].mean()
    lon_all = (lon_all - lon0 + 180.0) % 360.0 - 180.0 + lon0
    cd = min(abs(w1.cdelt[0]), abs(w2.cdelt[0]))
    cd_lat = min(abs(w1.cdelt[1]), abs(w2.cdelt[1]))
    tmp = WCS(naxis=2)
    tmp.ctype = [w1.ctype[0], w1.ctype[1]]
    tmp.crval = np.array([(lon_all.min() + lon_all.max()) / 2,
                          (lat_all.min() + lat_all.max()) / 2])
    tmp.cdelt = np.array([-cd, cd_lat])
    tmp.crpix = np.array([1.0, 1.0])
    tmp.cunit = [Unit.parse("deg"), Unit.parse("deg")]
    px, py = (np.asarray(a) for a in tmp.world2pix(lon_all, lat_all))
    # milli-pixel slack: inputs that tile a grid reproduce its size
    nx = max(1, int(np.ceil(px.max() - px.min() - 1e-3)))
    ny = max(1, int(np.ceil(py.max() - py.min() - 1e-3)))
    out = Header()
    for key in ("NAXIS3", "CTYPE3", "CRVAL3", "CDELT3", "CRPIX3", "CUNIT3",
                "RESTFRQ", "SPECSYS", "BUNIT"):
        if key in header1:
            out[key] = header1[key]
    out["NAXIS"] = 3
    out["NAXIS1"] = nx
    out["NAXIS2"] = ny
    out["CTYPE1"] = w1.ctype[0]
    out["CTYPE2"] = w1.ctype[1]
    out["CUNIT1"] = "deg"
    out["CUNIT2"] = "deg"
    out["CRVAL1"] = float(tmp.crval[0])
    out["CRVAL2"] = float(tmp.crval[1])
    out["CDELT1"] = -cd
    out["CDELT2"] = cd_lat
    # the first output pixel centre sits half a pixel inside the corner
    out["CRPIX1"] = 1.0 - (float(px.min()) + 0.5)
    out["CRPIX2"] = 1.0 - (float(py.min()) + 0.5)
    return out


def _as_beams(beams):
    from .beams import Beams
    return beams if isinstance(beams, Beams) else Beams(beams=list(beams))


def largest_beam(beams, include_mask=None):
    """Largest beam by area (reference cube_utils.largest_beam)."""
    return _as_beams(beams).largest_beam(include_mask)


def smallest_beam(beams, include_mask=None):
    """Smallest beam by area (reference cube_utils.smallest_beam)."""
    return _as_beams(beams).smallest_beam(include_mask)


def try_load_beam(header):
    """A single beam from a FITS header, or None where it holds none or
    a malformed one (reference cube_utils.py:304-325)."""
    from .beams import Beam
    try:
        return Beam.from_header(header)
    except (KeyError, ValueError, TypeError):
        return None


def try_load_beams(data):
    """A beam or the beams of a BEAMS table from a header, an HDU or a list
    of HDUs (reference cube_utils.py:327-378): a BEAMS table wins (BMAJ and
    BMIN in arcsec, BPA in degrees), else the first header's beam.  The
    table's columns are read from its ``data`` where it has one (an
    astropy HDU, as the JAX package reads them) and else from the table
    itself (this package's ``BinTableHDU``, which the JAX function cannot
    read)."""
    from .beams import Beams
    if hasattr(data, "header") and not hasattr(data, "__iter__"):
        data = [data]
    if hasattr(data, "keys") or not hasattr(data, "__iter__"):
        return try_load_beam(data)
    beams = None
    for hdu in data:
        hdr = getattr(hdu, "header", None)
        if hdr is None:
            continue
        if str(hdr.get("EXTNAME", "")).strip() == "BEAMS":
            t = getattr(hdu, "data", hdu)
            return Beams(
                major=Quantity(np.asarray(t["BMAJ"], dtype=float), "arcsec"),
                minor=Quantity(np.asarray(t["BMIN"], dtype=float), "arcsec"),
                pa=Quantity(np.asarray(t["BPA"], dtype=float), "deg"))
        if beams is None and "BMAJ" in hdr:
            beams = try_load_beam(hdr)
    return beams


def beams_to_bintable(beams, pols=None):
    """Beams as a FITS BEAMS table HDU (reference cube_utils.py:380-398)."""
    from . import beams as _beams_mod
    return _beams_mod.beams_to_bintable(beams, pols=pols)


def beam_props(beams, includemask=None):
    """(major, minor, pa) Quantity arrays in degrees of the beams that
    ``includemask`` keeps (reference cube_utils.py:401-417)."""
    if includemask is None:
        includemask = [True] * len(beams)
    kept = [b for b, m in zip(beams, includemask) if m]
    return tuple(Quantity(np.array([getattr(b, k).to_value("deg")
                                    for b in kept]), "deg")
                 for k in ("major", "minor", "pa"))
