"""Reader for the CASA table system (images), on the host.

Port of ``spectral_cube_tpu/io/casa_low.py``, copied whole: the port
keeps its own copy and imports nothing of the JAX package.  The
reference library delegates CASA image reading to the external
``casa_formats_io`` package (``spectral_cube/io/casa_image.py:37-227``);
this module implements the pieces an image needs:

- the AipsIO serialization (big-endian, length-delimited ``putstart``
  objects: Table / TableDesc / TableRecord / RecordDesc / Array<T> /
  IPosition),
- the TiledStMan/TiledCellStMan storage manager (tiled, Fortran-ordered
  payloads in the table's byte order; booleans bit-packed), assembled by
  ``io/native.assemble_casa_tiles`` where the C++ helper builds, else by
  a numpy loop,
- the CASA ``coords`` record -> WCS conversion (direction/spectral/stokes/
  linear coordinates, worldmap/pixelmap orderings),
- ``imageinfo`` -> beam(s), incl. per-plane beams.

Everything here is numpy: ``io/casa_image.py`` moves the result to the
device.
"""

from __future__ import annotations

import os
import struct
import warnings

import numpy as np

__all__ = ["read_table_keywords", "read_tiled_data", "read_casa_image_parts",
           "casa_image_info", "casa_coords_to_wcs"]

TP_BOOL, TP_INT, TP_UINT, TP_FLOAT, TP_DOUBLE, TP_STRING, TP_TABLE = \
    0, 5, 6, 7, 8, 11, 12
TP_RECORD = 25

_ARRAY_DTYPES = {
    "Bool": None,  # bit-handled separately in tiles; byte-per-bool in AipsIO
    "Char": ">i1", "uChar": ">u1", "Short": ">i2", "uShort": ">u2",
    "Int": ">i4", "uInt": ">u4", "Int64": ">i8",
    "Float": ">f4", "Double": ">f8", "double": ">f8",
    "Complex": ">c8", "DComplex": ">c16",
}


class AipsIO:
    """Cursor over an AipsIO byte stream."""

    def __init__(self, data: bytes):
        self.b = data
        self.p = 0

    def u8(self):
        v = self.b[self.p]
        self.p += 1
        return v

    def u32(self):
        v = struct.unpack_from(">I", self.b, self.p)[0]
        self.p += 4
        return v

    def i32(self):
        v = struct.unpack_from(">i", self.b, self.p)[0]
        self.p += 4
        return v

    def f32(self):
        v = struct.unpack_from(">f", self.b, self.p)[0]
        self.p += 4
        return v

    def f64(self):
        v = struct.unpack_from(">d", self.b, self.p)[0]
        self.p += 8
        return v

    def string(self):
        n = self.u32()
        v = self.b[self.p:self.p + n].decode("latin1")
        self.p += n
        return v

    def start(self):
        """Read a putstart header: (length incl. itself, type, version,
        start position of the length field)."""
        p0 = self.p
        ln = self.u32()
        t = self.string()
        v = self.u32()
        return ln, t, v, p0

    def expect(self, typename):
        ln, t, v, p0 = self.start()
        if t != typename:
            raise ValueError(f"expected {typename!r}, found {t!r} at {p0}")
        return ln, v, p0

    def iposition(self):
        ln, v, p0 = self.expect("IPosition")
        nd = self.u32()
        vals = [self.u32() for _ in range(nd)]
        if self.p != p0 + ln:
            raise ValueError("IPosition length mismatch")
        return vals


def read_recorddesc(a: AipsIO):
    ln, v, p0 = a.expect("RecordDesc")
    n = a.u32()
    fields = []
    for _ in range(n):
        name = a.string()
        tp = a.i32()
        sub = None
        if tp == TP_RECORD:
            sub = read_recorddesc(a)
        elif tp == TP_TABLE:
            a.string()  # table description name
        elif 13 <= tp <= 24:
            # fixed-shape marker: an IPosition (often [-1] = variable)
            a.iposition()
        a.string()  # comment
        fields.append((name, tp, sub))
    if a.p != p0 + ln:
        raise ValueError("RecordDesc length mismatch")
    return fields


def read_aips_array(a: AipsIO):
    ln, t, ver, p0 = a.start()
    if not (t.startswith("Array<") and t.endswith(">")):
        raise ValueError(f"expected Array<...>, found {t!r}")
    if ver != 3:
        raise ValueError(f"unsupported Array version {ver}")
    ndim = a.u32()
    dims = [a.u32() for _ in range(ndim)]
    nel = a.u32()
    kind = t[6:-1]
    if kind == "String":
        vals = np.array([a.string() for _ in range(nel)], dtype=object)
    elif kind == "Bool":
        nbytes_left = (p0 + ln) - a.p
        if nbytes_left == nel:
            vals = np.frombuffer(a.b, "u1", nel, a.p).astype(bool)
            a.p += nel
        else:
            # bit-packed Bool stream (8 per byte): some casacore AipsIO
            # writers pack Bool arrays; accept either layout
            nb = (nel + 7) // 8
            if nbytes_left != nb:
                raise ValueError("Array<Bool> length mismatch")
            bits = np.unpackbits(np.frombuffer(a.b, "u1", nb, a.p),
                                 bitorder="little")[:nel]
            vals = bits.astype(bool)
            a.p += nb
    else:
        dt = _ARRAY_DTYPES[kind]
        vals = np.frombuffer(a.b, dt, nel, a.p).copy()
        vals = vals.astype(vals.dtype.newbyteorder("="))
        a.p += nel * np.dtype(dt).itemsize
    if a.p != p0 + ln:
        raise ValueError(f"Array<{kind}> length mismatch")
    if kind != "String" and ndim > 1:
        # casacore Array streams are Fortran-ordered with dims as
        # written: a C-order reshape of reversed dims would TRANSPOSE
        # 2-D records (the pc matrix — a rotation read as its inverse)
        vals = vals.reshape(dims, order="F")
    return vals


def read_tablerecord(a: AipsIO):
    ln, ver, p0 = a.expect("TableRecord")
    fields = read_recorddesc(a)
    a.u32()  # record type (fixed/variable)
    out = {}
    for name, tp, _sub in fields:
        if tp == TP_TABLE:
            out[name] = ("Table", a.string())
        elif tp == TP_RECORD:
            out[name] = read_tablerecord(a)
        elif tp == TP_STRING:
            out[name] = a.string()
        elif tp == TP_INT:
            out[name] = a.i32()
        elif tp == TP_UINT:
            out[name] = a.u32()
        elif tp == TP_FLOAT:
            out[name] = a.f32()
        elif tp == TP_DOUBLE:
            out[name] = a.f64()
        elif tp == TP_BOOL:
            out[name] = bool(a.u8())
        elif 13 <= tp <= 24:
            out[name] = read_aips_array(a)
        else:
            raise ValueError(f"unsupported field type {tp} for {name!r}")
    if a.p != p0 + ln:
        raise ValueError("TableRecord length mismatch")
    return out


def read_table_keywords(table_dat_path, return_endian=False):
    """Parse table.dat and return the table's keyword record (for images:
    coords / units / miscinfo / imageinfo).

    The table's *data payloads* follow the ``fmt`` flag (0 = big endian,
    1 = little endian); the AipsIO header structures themselves are always
    big-endian."""
    with open(table_dat_path, "rb") as f:
        b = f.read()
    a = AipsIO(b)
    if a.u32() != 0xBEBEBEBE:
        raise ValueError(f"{table_dat_path} is not an AipsIO table file")
    a.expect("Table")
    a.u32()  # number of rows
    fmt = a.u32()  # endian format flag: 0 big, 1 little
    a.string()  # table type (PlainTable)
    a.expect("TableDesc")
    a.string()  # table description name
    a.string()  # version string
    a.string()  # comment
    rec = read_tablerecord(a)
    if return_endian:
        return rec, ("<" if fmt == 1 else ">")
    return rec


def read_tiled_stman(table_f0_path):
    """Parse a TiledCellStMan header file: returns (dtype_code, cube_shape,
    tile_shape) in CASA (Fortran) axis order."""
    with open(table_f0_path, "rb") as f:
        b = f.read()
    a = AipsIO(b)
    if a.u32() != 0xBEBEBEBE:
        raise ValueError("not an AipsIO file")
    ln, t, ver, _ = a.start()
    if t not in ("TiledCellStMan", "TiledShapeStMan", "TiledColumnStMan"):
        raise ValueError(f"unsupported storage manager {t!r}")
    a.iposition()  # default tile shape
    a.expect("TiledStMan")
    a.u32()
    a.u32()
    a.u8()          # big-endian flag
    a.u32()         # sequence number
    dtype_code = a.u32()
    a.string()      # hypercolumn/column name
    a.u32()
    a.u32()         # ndim
    a.u32()         # number of tile sections?
    a.u8()
    a.u32()
    a.u32()
    a.u32()         # total data bytes
    a.u32()         # number of hypercubes
    a.u32()
    read_tablerecord_like_record(a)
    # a few writer-version-dependent scalar fields precede the hypercube
    # shapes; locate the IPosition object markers directly (the marker
    # byte sequence cannot occur inside the intervening scalars)
    marker = b"\x00\x00\x00\x09IPosition"
    pos = a.b.find(marker, a.p)
    if pos < 4:
        raise ValueError("hypercube shape not found in TSM header")
    a.p = pos - 4
    cube_shape = a.iposition()
    pos = a.b.find(marker, a.p)
    if pos < 4:
        raise ValueError("tile shape not found in TSM header")
    a.p = pos - 4
    tile_shape = a.iposition()
    return dtype_code, cube_shape, tile_shape


def read_tablerecord_like_record(a: AipsIO):
    """The TSM header embeds a plain 'Record' (not 'TableRecord')."""
    ln, t, ver, p0 = a.start()
    if t not in ("Record", "TableRecord"):
        raise ValueError(f"expected Record, found {t!r}")
    a.p = p0 + ln  # image TSM records are empty; skip by length
    return {}


def read_tiled_data(image_dir, f_index=0, dtype_code=None):
    """Read the tiled payload of table.f<i> into a numpy array with shape
    reversed to numpy (C) order."""
    f0 = os.path.join(image_dir, f"table.f{f_index}")
    tsm = os.path.join(image_dir, f"table.f{f_index}_TSM0")
    dt_code, cube_shape, tile_shape = read_tiled_stman(f0)
    if dtype_code is not None:
        dt_code = dtype_code
    # payload byte order follows the table's format flag
    _, endian = read_table_keywords(os.path.join(image_dir, "table.dat"),
                                    return_endian=True)
    casa_shape = list(cube_shape)           # Fortran order
    tshape = list(tile_shape)
    ntiles = [-(-c // t) for c, t in zip(casa_shape, tshape)]
    tile_elems = int(np.prod(tshape))

    if dt_code == TP_FLOAT:
        dt = np.dtype(endian + "f4")
    elif dt_code == TP_DOUBLE:
        dt = np.dtype(endian + "f8")
    elif dt_code == TP_INT:
        dt = np.dtype(endian + "i4")
    elif dt_code == TP_BOOL:
        dt = None
    else:
        raise ValueError(f"unsupported tile dtype code {dt_code}")

    with open(tsm, "rb") as f:
        raw = f.read()

    total_tiles = int(np.prod(ntiles))
    # native multithreaded tile scatter (native/casa_tiles.cpp): fuses the
    # byteswap and the per-tile slice assignment the Python loop below
    # does one tile at a time — the difference between seconds and minutes
    # on ~10^5-tile TB-scale images
    from .native import assemble_casa_tiles
    native_dtype = {TP_FLOAT: "f4", TP_DOUBLE: "f8",
                    TP_INT: "i4"}.get(dt_code)
    if dt_code == TP_BOOL or native_dtype is not None:
        out_native = assemble_casa_tiles(
            raw, casa_shape, tshape,
            None if dt_code == TP_BOOL else native_dtype,
            big_endian=(endian == ">"))
        if out_native is not None:
            np_cube_shape = casa_shape[::-1]
            return out_native[tuple(slice(0, s) for s in np_cube_shape)]
    if dt is None:
        # booleans are bit-packed per tile, LSB-first within each byte
        tile_bytes = -(-tile_elems // 8)
        bits = np.unpackbits(
            np.frombuffer(raw, "u1",
                          total_tiles * tile_bytes).reshape(
                              total_tiles, tile_bytes),
            axis=1, bitorder="little")[:, :tile_elems].astype(bool)
        tiles = bits
        out_dtype = np.bool_
    else:
        tiles = np.frombuffer(
            raw, dt, total_tiles * tile_elems).reshape(total_tiles,
                                                       tile_elems)
        tiles = tiles.astype(dt.newbyteorder("="))
        out_dtype = tiles.dtype

    # assemble: tiles traverse the tile grid in Fortran order; each tile is
    # Fortran-ordered.  Work in numpy (reversed) order.
    np_cube_shape = casa_shape[::-1]
    np_tile_shape = tshape[::-1]
    np_ntiles = ntiles[::-1]
    padded_shape = [nt * ts for nt, ts in zip(np_ntiles, np_tile_shape)]
    out = np.empty(padded_shape, dtype=out_dtype)
    for flat in range(total_tiles):
        # decompose in Fortran order over the casa tile grid
        rem = flat
        casa_idx = []
        for n in ntiles:
            casa_idx.append(rem % n)
            rem //= n
        np_idx = casa_idx[::-1]
        tile = tiles[flat].reshape(np_tile_shape)
        sl = tuple(slice(i * t, (i + 1) * t)
                   for i, t in zip(np_idx, np_tile_shape))
        out[sl] = tile
    return out[tuple(slice(0, s) for s in np_cube_shape)]


# ---------------------------------------------------------------------------
# coordinate system -> WCS
# ---------------------------------------------------------------------------
_DIR_SYSTEMS = {
    "J2000": ("RA--", "DEC-", "FK5", 2000.0),
    "B1950": ("RA--", "DEC-", "FK4", 1950.0),
    "ICRS": ("RA--", "DEC-", "ICRS", None),
    "GALACTIC": ("GLON", "GLAT", None, None),
    "SUPERGAL": ("SLON", "SLAT", None, None),
    "ECLIPTIC": ("ELON", "ELAT", None, None),
}

# casacore MFrequency::Types enum -> FITS SPECSYS names
# (REST=0, LSRD=1, LSRK=2, BARY=3, GEO=4, TOPO=5, GALACTO=6, LGROUP=7,
# CMB=8)
_SPECTRAL_SYSTEMS = {0: "SOURCE", 1: "LSRD", 2: "LSRK", 3: "BARYCENT",
                     4: "GEOCENTR", 5: "TOPOCENT", 6: "GALACTOC",
                     7: "LOCALGRP", 8: "CMBDIPOL"}

R2D = 180.0 / np.pi


def casa_coords_to_wcs(coords, naxis):
    """Convert a CASA 'coords' record into this framework's WCS (reference
    behavior: casa_formats_io.coordsys_to_astropy_wcs)."""
    from ..wcs import WCS

    w = WCS(naxis=naxis)
    i = 0
    while True:
        found = False
        for kind in ("direction", "stokes", "spectral", "linear", "tabular"):
            key = f"{kind}{i}"
            if key in coords:
                rec = coords[key]
                pixmap = np.atleast_1d(np.asarray(
                    coords.get(f"pixelmap{i}", [i])))
                _apply_coord(w, kind, rec, pixmap)
                found = True
        if not found:
            break
        i += 1
    if "obsdate" in coords:
        mjd = coords["obsdate"].get("m0", {}).get("value")
        if mjd:
            w.mjdobs = float(mjd)
    return w


def _apply_coord(w, kind, rec, pixmap):
    from ..units import Unit
    if kind == "direction":
        lon_ax, lat_ax = int(pixmap[0]), int(pixmap[1])
        system = str(rec.get("system", "J2000")).upper()
        lon_pfx, lat_pfx, radesys, equinox = _DIR_SYSTEMS.get(
            system, ("RA--", "DEC-", None, None))
        proj = str(rec.get("projection", "SIN")).upper()
        w.ctype[lon_ax] = f"{lon_pfx}{'-' * (4 - len(lon_pfx))}-{proj}"
        w.ctype[lat_ax] = f"{lat_pfx}{'-' * (4 - len(lat_pfx))}-{proj}"
        crval = np.asarray(rec["crval"], dtype=float) * R2D
        cdelt = np.asarray(rec["cdelt"], dtype=float) * R2D
        crpix = np.asarray(rec["crpix"], dtype=float)
        for k, ax in ((0, lon_ax), (1, lat_ax)):
            w.crval[ax] = crval[k]
            w.cdelt[ax] = cdelt[k]
            w.crpix[ax] = crpix[k] + 1.0  # CASA crpix is 0-based
            w.cunit[ax] = Unit.parse("deg")
        pc = np.asarray(rec.get("pc", np.eye(2)), dtype=float)
        w.pc[lon_ax, lon_ax] = pc[0, 0]
        w.pc[lon_ax, lat_ax] = pc[0, 1]
        w.pc[lat_ax, lon_ax] = pc[1, 0]
        w.pc[lat_ax, lat_ax] = pc[1, 1]
        if radesys:
            w.radesys = radesys
        if equinox:
            w.equinox = equinox
        if "longpole" in rec:
            w.lonpole = float(rec["longpole"])
        if "latpole" in rec:
            w.latpole = float(rec["latpole"])
    elif kind == "stokes":
        ax = int(pixmap[0])
        w.ctype[ax] = "STOKES"
        from ..stokes import STOKES_SYMBOLS
        names = list(rec.get("stokes", ["I"]))
        sym_by_name = {v: k for k, v in STOKES_SYMBOLS.items()}
        codes = [sym_by_name.get(str(n), 1) for n in names]
        w.crval[ax] = float(codes[0])
        w.cdelt[ax] = float(codes[1] - codes[0]) if len(codes) > 1 else 1.0
        w.crpix[ax] = 1.0
    elif kind in ("spectral",):
        ax = int(pixmap[0])
        tab = rec.get("tabular", rec)
        w.ctype[ax] = "FREQ"
        w.crval[ax] = float(np.atleast_1d(tab["crval"])[0])
        w.cdelt[ax] = float(np.atleast_1d(tab["cdelt"])[0])
        w.crpix[ax] = float(np.atleast_1d(tab["crpix"])[0]) + 1.0
        from ..units import Unit
        unit = str(np.atleast_1d(tab.get("units", ["Hz"]))[0])
        w.cunit[ax] = Unit.parse(unit)
        if rec.get("restfreq"):
            w.restfrq = float(rec["restfreq"])
        w.specsys = _SPECTRAL_SYSTEMS.get(int(rec.get("system", 5))
                                          if not isinstance(
                                              rec.get("system"), str)
                                          else -1,
                                          str(rec.get("system", "")))
        if isinstance(rec.get("system"), str):
            w.specsys = {"BARY": "BARYCENT", "LSRK": "LSRK",
                         "TOPO": "TOPOCENT", "LSRD": "LSRD",
                         "GEO": "GEOCENTR", "GALACTO": "GALACTOC",
                         "LGROUP": "LOCALGRP", "CMB": "CMBDIPOL",
                         "REST": "SOURCE"}.get(
                             rec["system"], rec["system"])
    elif kind in ("linear", "tabular"):
        for k, ax in enumerate(int(p) for p in pixmap):
            w.ctype[ax] = str(np.atleast_1d(rec.get("axes", [""]))[k])
            w.crval[ax] = float(np.atleast_1d(rec["crval"])[k])
            w.cdelt[ax] = float(np.atleast_1d(rec["cdelt"])[k])
            w.crpix[ax] = float(np.atleast_1d(rec["crpix"])[k]) + 1.0


def _beam_from_record(rec):
    from ..beams import Beam
    from ..units import Quantity

    def q(sub):
        return Quantity(float(sub["value"]), str(sub["unit"]))

    return Beam.make(q(rec["major"]), q(rec["minor"]),
                     q(rec["positionangle"]))


def read_casa_image_parts(image_dir):
    """Read a CASA image directory -> (data, valid_mask_or_None, wcs,
    unit_string, beam_or_beams, misc_header_dict)."""
    data = read_tiled_data(image_dir, 0)
    wcs, maskname, unit, beams, misc = casa_image_info(image_dir, data.ndim)
    valid = None
    if maskname:
        try:
            valid = read_tiled_data(os.path.join(image_dir, maskname), 0)
        except Exception as exc:  # mask is optional; data stands alone
            warnings.warn(f"could not read CASA mask {maskname}: {exc}")
    return data, valid, wcs, unit, beams, misc


def casa_image_info(image_dir, ndim):
    """Everything of a CASA image directory but its pixels: ``(wcs,
    mask_name_or_None, unit_string, beam_or_beams, misc_header_dict)``,
    ``ndim`` the image's dimensionality."""
    kw = read_table_keywords(os.path.join(image_dir, "table.dat"))
    wcs = casa_coords_to_wcs(kw["coords"], ndim)

    maskname = None
    # the default mask is recorded in Image_defaultmask or as mask0; any
    # appended mask directory (make_casa_mask append_to_image) also counts
    def _is_paged_bool(entry):
        info_path = os.path.join(image_dir, entry, "table.info")
        if not os.path.exists(info_path):
            return False
        with open(info_path) as fh:
            return "Paged Array" in fh.read()

    dm = kw.get("Image_defaultmask")
    if isinstance(dm, str) and os.path.isdir(os.path.join(image_dir, dm)):
        maskname = dm
    elif os.path.isdir(os.path.join(image_dir, "mask0")):
        maskname = "mask0"
    else:
        # any appended lattice-mask subtable (make_casa_mask append path)
        for entry in sorted(os.listdir(image_dir)):
            if os.path.isdir(os.path.join(image_dir, entry)) and \
                    _is_paged_bool(entry):
                maskname = entry
                break

    unit = kw.get("units", "")
    info = kw.get("imageinfo", {})
    beams = None
    if "perplanebeams" in info:
        from ..beams import Beams
        pp = info["perplanebeams"]
        nchan = int(pp.get("nChannels", 0))
        nstokes = max(int(pp.get("nStokes", 1) or 1), 1)
        # keys are STOKES-MAJOR: *{istokes*nchan + chan} (reference
        # casa_image.py:116-127); reading only *0..*(nchan-1) would hand
        # every Stokes component the Stokes-I beams
        per_stokes = []
        for s in range(nstokes):
            beam_list = [
                _beam_from_record(pp[f"*{s * nchan + c}"])
                for c in range(nchan) if f"*{s * nchan + c}" in pp]
            per_stokes.append(Beams(beams=beam_list) if beam_list
                              else None)
        beams = per_stokes[0] if nstokes == 1 else per_stokes
    elif "restoringbeam" in info and "major" in info["restoringbeam"]:
        beams = _beam_from_record(info["restoringbeam"])

    misc = {}
    mi = kw.get("miscinfo", {})
    for k, v in mi.items():
        if isinstance(v, (str, int, float, bool)):
            misc[k.upper()[:8]] = v
    if "objectname" in info:
        misc["OBJECT"] = info["objectname"]
    return wcs, maskname, unit, beams, misc
