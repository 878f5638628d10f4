"""GILDAS CLASS .lmv (GDF image) reader.

Port of ``spectral_cube_tpu/io/class_lmv.py``: the same host parser,
copied whole.  The format follows the GILDAS GDF specification
(image_def.f90 / to_imfits.f90 semantics; the reference library's reader
is ``spectral_cube/io/class_lmv.py:42-672``).  It supports the classic
type-1 layout and the version-20 type-2 layout, in either byte order;
the parsed header is converted to FITS keywords and fed through the
port's FITS cube path onto the requested device.
"""

from __future__ import annotations

import warnings

import numpy as np

from .fits_low import Header, HDU
from ..utils import FITSReadError

__all__ = ["load_lmv_cube", "is_lmv", "read_lmv"]

R2DEG = 180.0 / np.pi

# GILDAS axis codes -> FITS CTYPE roots / units
CTYPE_MAP = {"LII": "GLON", "BII": "GLAT", "VELOCITY": "VELO", "RA": "RA",
             "DEC": "DEC", "FREQUENCY": "FREQ", "L": "GLON", "B": "GLAT",
             "LON": "GLON", "LAT": "GLAT", "GLON": "GLON", "GLAT": "GLAT"}
CUNIT_MAP = {"LII": "deg", "BII": "deg", "VELOCITY": "km s-1", "RA": "deg",
             "DEC": "deg", "FREQUENCY": "MHz", "GLON": "deg", "GLAT": "deg"}
CEL_CODES = ("RA", "DEC", "GLON", "GLAT")
# GILDAS projection codes (0 = unprojected defaults to ARC per CLASS export)
PROJ_CODES = {0: "ARC", 1: "TAN", 2: "SIN", 3: "AZP", 4: "STG", 5: "ZEA",
              6: "AIT", 7: "GLS", 8: "SFL"}
BUNIT_FIXES = {"k (tmb)": "K"}

ANGULAR_CODES = ("RA", "DEC", "LII", "BII", "GLON", "GLAT", "L", "B",
                 "LON", "LAT")


class _Buf:
    """Little cursor over the file bytes with typed reads.

    ``endian`` is '<' (little, the GILDAS IEEE code) or '>' (big, the
    EEEI code used by HPUX/SPARC-era files)."""

    def __init__(self, data: bytes, endian: str = "<"):
        self.data = data
        self.pos = 0
        self.endian = endian

    def seek(self, pos):
        self.pos = pos

    def tell(self):
        return self.pos

    def _take(self, n):
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise FITSReadError("truncated LMV file")
        self.pos += n
        return out

    def i32(self, count=1):
        out = np.frombuffer(self._take(4 * count), dtype=self.endian + "i4")
        return int(out[0]) if count == 1 else out

    def i64(self, count=1):
        out = np.frombuffer(self._take(8 * count), dtype=self.endian + "i8")
        return int(out[0]) if count == 1 else out

    def f32(self, count=1):
        out = np.frombuffer(self._take(4 * count), dtype=self.endian + "f4")
        return float(out[0]) if count == 1 else out

    def f64(self, count=1):
        out = np.frombuffer(self._take(8 * count), dtype=self.endian + "f8")
        return float(out[0]) if count == 1 else out

    def string(self, nbytes):
        return self._take(nbytes).decode("ascii", errors="replace").strip()


def is_lmv(filepath) -> bool:
    name = str(filepath)
    if not name.lower().endswith(".lmv"):
        try:
            with open(name, "rb") as f:
                return f.read(6) == b"GILDAS"
        except OSError:
            return False
    return True


def _apply_projection(header, ptyp):
    for kw in list(header.keys()):
        if kw.startswith("CTYPE"):
            root = str(header[kw]).strip()
            mapped = CTYPE_MAP.get(root, root)
            if mapped in CEL_CODES:
                header[kw] = mapped + "-" * (5 - len(mapped)) + \
                    PROJ_CODES.get(ptyp, "ARC")
            elif root == "VELOCITY":
                header[kw] = "VELO"
            elif root == "FREQUENCY":
                header[kw] = "FREQ"


def _read_type1(buf: _Buf):
    header = {}
    buf.i32()            # data format code
    buf.i32()            # number of data blocks
    buf.i32()            # gdf type
    buf.i32(4)           # reserved
    buf.i32()            # general section length
    naxes = buf.i32(5)
    header["NAXIS"] = int(naxes[0])
    for i in range(4):
        header[f"NAXIS{i + 1}"] = int(naxes[i + 1])
    for ax in range(1, 5):
        crpix = buf.f64()
        crval = buf.f64()
        cdelt = buf.f64()
        header[f"CRPIX{ax}"] = crpix
        header[f"CRVAL{ax}"] = crval
        header[f"CDELT{ax}"] = cdelt
    # axes 1/2 are stored in radians
    for ax in (1, 2):
        header[f"CDELT{ax}"] *= R2DEG
    if buf.i32() != 8:
        warnings.warn("Invalid blanking-section length in LMV header")
    bval = buf.f32()
    buf.i32()            # blanking tolerance
    if buf.i32() != 40:
        warnings.warn("Invalid extrema-section length in LMV header")
    buf.f32(2)           # vmin, vmax
    buf.i32(6)           # extrema locations
    buf.i32(2)           # wmin, wmax
    if buf.i32() != 72:
        warnings.warn("Invalid description-section length in LMV header")
    header["BUNIT"] = buf.string(12)
    for ax in range(1, 5):
        header[f"CTYPE{ax}"] = buf.string(12)
    for ax in range(1, 4):
        code = str(header[f"CTYPE{ax}"]).strip()
        if code in CUNIT_MAP:
            header[f"CUNIT{ax}"] = CUNIT_MAP[code]
    header["COOSYS"] = buf.string(12)
    if buf.i32() != 48:
        warnings.warn("Invalid position-section length in LMV header")
    header["OBJECT"] = buf.string(12)
    ra = buf.f64() * R2DEG
    dec = buf.f64() * R2DEG
    buf.f64(2)           # galactic lon/lat
    header["EQUINOX"] = buf.f32()
    buf.string(4)        # projection word
    ptyp = buf.i32()
    buf.f64()            # a0
    buf.f64()            # d0
    buf.f64()            # projection angle
    buf.f32(2)           # xaxi/yaxi
    if buf.i32() != 48:
        warnings.warn("Invalid spectroscopy-section length in LMV header")
    header["LINE"] = buf.string(12)
    header["FRES"] = buf.f64()
    buf.f64()            # image frequency
    header["RESTFREQ"] = buf.f64() * 1e6  # MHz -> Hz
    header["VRES"] = buf.f32()
    header["VELO-LSR"] = buf.f32()
    buf.i32()            # frequency axis id
    if buf.i32() != 12:
        warnings.warn("Invalid resolution-section length in LMV header")
    header["BMAJ"] = buf.f32() * R2DEG
    header["BMIN"] = buf.f32() * R2DEG
    header["BPA"] = buf.f32() * R2DEG
    buf.i32()
    buf.f32(2)           # noise, rms
    buf.i32()
    buf.f32(3)           # proper motions, parallax
    buf.f32(7)           # trailing words

    # CLASS headers may leave the reference value blank for RA axes
    if str(header.get("CTYPE1", "")).strip() == "RA" \
            and header["CRVAL1"] == 0 and ra != 0:
        header["CRVAL1"] = ra
        header["CRVAL2"] = dec
    _apply_projection(header, ptyp)

    # data starts on the next 512-byte GDF block boundary (header = 1 block)
    buf.seek(512)
    n1, n2, n3 = (header[f"NAXIS{i}"] for i in (1, 2, 3))
    n4 = max(header.get("NAXIS4", 1), 1)
    count = n1 * n2 * n3 * n4
    data = np.frombuffer(buf._take(4 * count), dtype=buf.endian + "f4").copy()
    data[data == bval] = np.nan
    return data.reshape([n4, n3, n2, n1]), header


def _read_type2(buf: _Buf):
    header = {}
    maxdims = 7
    buf.seek(12)
    buf.i32()            # data format code
    buf.i64()            # number of data blocks
    buf.i32()            # header blocks
    buf.i32()            # trailing blocks
    version = buf.i32()
    if version != 20:
        raise FITSReadError(f"GDF type-2 version {version} != 20")
    buf.i32()            # gdf type
    buf.i32()            # dim section start
    buf.i32()            # trailing padding

    buf.seek(16 * 4)
    buf.i32()            # dim section word count
    buf.i32()            # blanking section start
    buf.i32()            # mdim
    ndim = buf.i32()
    dims = buf.i64(maxdims)
    header["NAXIS"] = int(ndim)
    valid = []
    for i, d in enumerate(dims):
        if d != 0:
            header[f"NAXIS{i + 1}"] = int(d)
            valid.append(i)

    buf.i32()            # blanking words
    buf.i32()            # extrema section start
    bval = buf.f32()
    buf.f32()            # blanking tolerance
    buf.i32()            # extrema words
    buf.i32()            # coordinate section start
    buf.f32(2)           # min/max
    buf.i64(2)           # min/max locations
    buf.i32()            # coordinate words
    buf.i32()            # description section start
    convert = buf.f64(3 * maxdims).reshape(maxdims, 3)
    buf.i32()            # description words
    buf.i32()            # null section start
    bunit = buf.string(12)
    codes = [buf.string(12) for _ in range(maxdims)]
    header["BUNIT"] = BUNIT_FIXES.get(bunit.lower(), bunit)
    for i in valid:
        header[f"CTYPE{i + 1}"] = codes[i]
        code = codes[i].strip()
        if code in CUNIT_MAP:
            header[f"CUNIT{i + 1}"] = CUNIT_MAP[code]

    buf.seek(512)
    buf.i32()            # position words
    proj_start = buf.i32()
    header["OBJECT"] = buf.string(12)
    buf.string(12)       # coordinate system name
    buf.f64(2)           # ra, dec
    buf.f64(2)           # lii, bii
    header["EQUINOX"] = buf.f32()
    proj_words = buf.i32()
    buf.i32()            # spectroscopy section start
    ptyp = 0
    a0 = d0 = pang = 0.0
    xaxi = yaxi = 0
    if proj_words == 9:
        a0 = buf.f64()
        d0 = buf.f64()
        pang = buf.f64()
        ptyp = buf.i32()
        xaxi = buf.i32()
        yaxi = buf.i32()
    elif proj_words != 0:
        raise FITSReadError("Invalid LMV projection-section length")

    # axis conversion words -> CRPIX/CRVAL/CDELT (to_imfits semantics)
    for i in valid:
        ref, val, inc = convert[i]
        code = codes[i].strip()
        if ptyp != 0 and (i + 1) in (xaxi, yaxi):
            ref = ref - val / inc
            val = (a0 if (i + 1) == xaxi else d0) * R2DEG
            inc = inc * R2DEG
        elif code in ANGULAR_CODES:
            val = val * R2DEG
            inc = inc * R2DEG
        header[f"CRPIX{i + 1}"] = float(ref)
        header[f"CRVAL{i + 1}"] = float(val)
        header[f"CDELT{i + 1}"] = float(inc)
    _apply_projection(header, ptyp)

    # spectroscopy + resolution sections
    # type-2 sections are read sequentially; the section table's
    # projection offset is informational here (matches the reference
    # reader's sequential layout, class_lmv.py:241-672)
    spec_words = buf.i32()
    buf.i32()            # next section start
    if spec_words == 14:
        # field order from GILDAS image_def.f90 (quoted in reference
        # class_lmv.py:526-539): fres, fima, freq, vres, voff, dopp,
        # faxi, ijlin(3 words of line name), vtyp — 14 words total.
        # (A previous revision read the line name FIRST and skipped
        # dopp, garbling every field and the following section offsets.)
        header["FRES"] = buf.f64()
        buf.f64()        # image frequency (MHz)
        header["RESTFREQ"] = buf.f64() * 1e6   # MHz -> Hz
        header["VRES"] = buf.f32()
        header["VELO-LSR"] = buf.f32()         # velocity offset
        buf.f32()        # doppler factor
        buf.i32()        # frequency axis
        header["LINE"] = buf.string(12)
        buf.i32()        # velocity type
    elif spec_words != 0:
        raise FITSReadError("Invalid LMV spectroscopy-section length")
    reso_words = buf.i32()
    buf.i32()
    if reso_words in (3, 4):
        header["BMAJ"] = buf.f32() * R2DEG
        header["BMIN"] = buf.f32() * R2DEG
        header["BPA"] = buf.f32() * R2DEG
        if reso_words == 4:
            buf.f32()
    elif reso_words != 0:
        raise FITSReadError("Invalid LMV resolution-section length")

    # data starts on the next 512-byte block boundary after the header blocks
    nhb_offset = 2 * 512  # two header blocks in the common layout
    shape = [header.get(f"NAXIS{i + 1}", 1) for i in range(max(valid) + 1)]
    count = int(np.prod(shape))
    buf.seek(nhb_offset)
    data = np.frombuffer(buf._take(4 * count), dtype=buf.endian + "f4").copy()
    data[data == bval] = np.nan
    return data.reshape(shape[::-1]), header


def read_lmv(path):
    """Read an LMV file -> (data, header-dict)."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = _Buf(raw)
    magic = buf.string(12)
    if not magic.startswith("GILDAS"):
        raise FITSReadError("File is not a GILDAS image")
    imcode = magic[6] if len(magic) > 6 else "-"
    if imcode in ("<", ">"):
        if imcode == ">":
            # EEEI (big-endian) file: decode every numeric field
            # big-endian (the reference only warns and mis-reads,
            # class_lmv.py:73-77)
            buf.endian = ">"
        return _read_type2(buf)
    return _read_type1(buf)


def load_lmv_cube(path, device=None, **kwargs):
    """Read an LMV cube onto ``device`` through the FITS cube builder, in
    memory (reference load_lmv_cube, io/class_lmv.py:259): the default is
    the CUDA device,
    and the call raises where CUDA is absent unless ``device='cpu'``."""
    data, hdr = read_lmv(path)
    data = np.squeeze(data)
    h = Header()
    for k, v in hdr.items():
        if k.endswith("4") and k[:5] in ("NAXIS", "CRVAL", "CRPIX",
                                         "CDELT", "CTYPE", "CUNIT"):
            continue
        if isinstance(v, tuple):
            h[k] = v[0]
        else:
            h[k] = v
    h["NAXIS"] = 3
    for i, n in enumerate(data.shape[::-1]):
        h[f"NAXIS{i + 1}"] = int(n)

    # the header as the JAX package's temporary FITS file gives it back
    # (its cards through FITS text, BITPIX from the float32 data); the
    # data stays in memory
    from .fits_low import format_header, parse_header
    from .fits import cube_from_hdus
    data = data.astype("f4")
    h["SIMPLE"] = True
    h["BITPIX"] = -32
    for k in ("BSCALE", "BZERO", "BLANK"):
        if k in h:
            del h[k]
    return cube_from_hdus([HDU(data=data, header=parse_header(
        format_header(h)))], meta={"filename": str(path)}, device=device,
        **kwargs)
