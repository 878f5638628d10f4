"""FITS Tiled Image Compression convention (ZIMAGE=T): RICE_1 / GZIP_1 /
GZIP_2 codecs, quantized-float support (including subtractive dithering),
reader and writer.

Real ALMA archive products are frequently tile-compressed.  The reference
reads them for free through astropy (its ``fits.open`` handles
``CompImageHDU`` transparently — reference spectral_cube/io/fits.py:76-81);
this framework's native FITS stack implements the convention directly:
the compressed HDU is a BINTABLE whose ``COMPRESSED_DATA`` column holds
one heap block per tile, with the image geometry in ``ZNAXISn``/``ZTILEn``
and the codec in ``ZCMPTYPE``.

RICE_1 is the Rice/FS code as specified by the convention (and by
CFITSIO's fits_rcomp/fits_rdecomp, whose bitstream it must match —
verified byte-identical against the system libcfitsio in
tests/test_tile_compress.py): successive pixel differences are
zigzag-mapped to non-negative ints; each block of ``BLOCKSIZE`` (default
32) pixels picks a split position ``fs`` and stores each value as
``value >> fs`` in unary (that many 0-bits then a 1) followed by the
``fs`` low bits; two escape selectors mark all-zero-difference blocks and
uncompressed (bit-for-bit) blocks.  Hot decode/encode runs through the
multithreaded batch codec in native/fits_decode.cpp; the pure-Python
bit-loop here is the compiler-free fallback and the readable spec.

Floating-point images are stored *quantized*: the float pixels become
``round((v - ZZERO)/ZSCALE)`` int32 values (per-tile scale/zero in the
ZSCALE/ZZERO table columns), optionally with subtractive dithering
(``ZQUANTIZ = 'SUBTRACTIVE_DITHER_1'|'SUBTRACTIVE_DITHER_2'``): a
reproducible pseudo-random offset, seeded by ``ZDITHER0`` and the tile
number, is added before rounding and subtracted on read.  The random
sequence is the convention's Park–Miller generator (10000 float32 values
from ``seed -> 16807*seed mod (2^31-1)``), so files written by
fpack/CFITSIO/astropy reconstruct exactly.  NaNs are stored as the
reserved ``ZBLANK`` integer; ``SUBTRACTIVE_DITHER_2`` additionally stores
exact zeros as -2147483646 so they survive unquantization exactly.

Tiles that do not compress under the primary codec may instead appear in
a ``GZIP_COMPRESSED_DATA`` column holding the gzip of the *original*
(unquantized) pixels; those rows bypass the scale/dither path.

Unsupported codecs raise :class:`~..utils.FITSReadError` naming the
compression rather than silently skipping the HDU.
"""

from __future__ import annotations

import re as _re
import zlib
from collections import OrderedDict

import numpy as np

from ..utils import FITSReadError

__all__ = ["is_compressed_image", "decompress_image_hdu",
           "compressed_image_blocks", "rice_encode", "rice_decode"]

_FSBITS = {1: 3, 2: 4, 4: 5}
_FSMAX = {1: 6, 2: 14, 4: 25}

_N_RANDOM = 10000
# CFITSIO's reserved int32 sentinels for quantized tiles
_NULL_VALUE = -2147483647       # quantized NaN (when ZBLANK is absent)
_UNQUANT_CHUNK_PX = 1 << 24     # unquantize chunk: ~128 MB f64 temporaries
_ZERO_VALUE = -2147483646       # exact 0.0 under SUBTRACTIVE_DITHER_2


def is_compressed_image(header) -> bool:
    val = header.get("ZIMAGE", False)
    return val is True or str(val).strip().upper() in ("T", "TRUE", "1")


# ---------------------------------------------------------------- dither

_DITHER_TABLE = None


def _dither_table():
    """The convention's 10000-value Park–Miller random table (float32),
    identical to CFITSIO's ``fits_init_randoms``."""
    global _DITHER_TABLE
    if _DITHER_TABLE is None:
        m = 2147483647
        seed = 1
        vals = np.empty(_N_RANDOM, dtype=np.float32)
        for i in range(_N_RANDOM):
            seed = (16807 * seed) % m
            vals[i] = np.float32(seed / m)
        if seed != 1043618065:
            raise RuntimeError("dither random generator self-check failed")
        _DITHER_TABLE = vals
    return _DITHER_TABLE


def _dither_values(row1, zdither0, npix):
    """Per-pixel dither offsets (float32) for 1-based tile number ``row1``
    under seed ``zdither0`` — CFITSIO's index walk: start at
    ``int(rand[(row1 + seed - 2) % 10000] * 500)`` and advance one per
    pixel, re-seeding from the next table slot on wraparound."""
    rand = _dither_table()
    iseed = (row1 + zdither0 - 2) % _N_RANDOM
    nextrand = int(rand[iseed] * 500.0)
    idx = np.empty(npix, dtype=np.int64)
    pos = 0
    while pos < npix:
        take = min(npix - pos, _N_RANDOM - nextrand)
        idx[pos:pos + take] = np.arange(nextrand, nextrand + take)
        pos += take
        nextrand += take
        if nextrand == _N_RANDOM:
            iseed = (iseed + 1) % _N_RANDOM
            nextrand = int(rand[iseed] * 500.0)
    return rand[idx]


def _dither_values_batch(rows1, zdither0, npix_arr):
    """Concatenated per-pixel dither offsets (float32) for many tiles at
    once — same walk as :func:`_dither_values`, vectorized with
    ``np.repeat`` over the ragged tile sizes.  Tiles longer than one
    wraparound window fall back to the per-tile walk."""
    rows1 = np.asarray(rows1, dtype=np.int64)
    npix_arr = np.asarray(npix_arr, dtype=np.int64)
    rand = _dither_table()
    iseed = (rows1 + zdither0 - 2) % _N_RANDOM
    starts = (rand[iseed] * np.float64(500.0)).astype(np.int64)
    # a tile can wrap the 10000-slot table at most once iff
    # start + npix <= 2 * N_RANDOM and the restart index stays in [0,500)
    if int(npix_arr.max(initial=0)) > _N_RANDOM - 500:
        return np.concatenate([
            _dither_values(int(r), zdither0, int(n))
            for r, n in zip(rows1, npix_arr)]) if len(rows1) else \
            np.empty(0, dtype=np.float32)
    total = int(npix_arr.sum())
    out_off = np.zeros(len(rows1), dtype=np.int64)
    np.cumsum(npix_arr[:-1], out=out_off[1:])
    intra = np.arange(total, dtype=np.int64) - np.repeat(out_off, npix_arr)
    idx = np.repeat(starts, npix_arr) + intra
    wrapped = idx >= _N_RANDOM
    if wrapped.any():
        restart = (rand[(iseed + 1) % _N_RANDOM]
                   * np.float64(500.0)).astype(np.int64)
        idx = np.where(wrapped,
                       np.repeat(restart, npix_arr) + (idx - _N_RANDOM),
                       idx)
    return rand[idx]


# ------------------------------------------------------------------ RICE


def rice_decode(buf, npix, blocksize=32, bytepix=4):
    """Decode one RICE_1 tile into int values (int64 work array).

    ``buf``: the tile's compressed bytes; ``npix``: pixel count.
    Pure-Python reference implementation (the batch hot path uses
    native/fits_decode.cpp's ``rice_decode_tiles``)."""
    fsbits = _FSBITS[bytepix]
    fsmax = _FSMAX[bytepix]
    bbits = 8 * bytepix
    mask = (1 << bbits) - 1
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8))
    nbits = bits.shape[0]
    # pack back to python ints lazily via positions
    out = np.empty(npix, dtype=np.int64)
    lastpix = 0
    for b in buf[:bytepix]:
        lastpix = (lastpix << 8) | b
    pos = bbits

    def read(n, pos):
        v = 0
        for bit in bits[pos:pos + n]:
            v = (v << 1) | int(bit)
        return v, pos + n

    i = 0
    while i < npix:
        thisblock = min(blocksize, npix - i)
        if pos + fsbits > nbits:
            raise FITSReadError("RICE_1 tile bitstream truncated")
        fs, pos = read(fsbits, pos)
        fs -= 1
        if fs < 0:
            out[i:i + thisblock] = lastpix
            i += thisblock
        elif fs == fsmax:
            for j in range(thisblock):
                diff, pos = read(bbits, pos)
                if diff & 1:
                    diff = ~(diff >> 1)
                else:
                    diff >>= 1
                lastpix = (lastpix + diff) & mask
                out[i + j] = lastpix
            i += thisblock
        else:
            for j in range(thisblock):
                # unary: count 0-bits to the terminating 1
                nz = int(np.argmax(bits[pos:]))
                if not bits[pos + nz]:
                    raise FITSReadError("RICE_1 tile bitstream truncated")
                pos += nz + 1
                low, pos = read(fs, pos)
                diff = (nz << fs) | low
                if diff & 1:
                    diff = ~(diff >> 1)
                else:
                    diff >>= 1
                lastpix = (lastpix + diff) & mask
                out[i + j] = lastpix
            i += thisblock
    # reinterpret as signed bytepix-width ints (bytepix 1 stays unsigned)
    half = 1 << (bbits - 1)
    if bytepix > 1:
        out = np.where(out >= half, out - (1 << bbits), out)
    return out


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nacc = 0

    def write(self, value, nbits):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nacc += nbits
        while self.nacc >= 8:
            self.nacc -= 8
            self.bytes.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def done(self):
        if self.nacc:
            self.bytes.append((self.acc << (8 - self.nacc)) & 0xFF)
            self.acc = self.nacc = 0
        return bytes(self.bytes)


def rice_encode(values, blocksize=32, bytepix=4):
    """Encode one tile of integer pixel values as a RICE_1 bitstream.

    Pure-Python reference implementation (the batch hot path uses
    native/fits_decode.cpp's ``rice_encode_tiles``)."""
    fsbits = _FSBITS[bytepix]
    fsmax = _FSMAX[bytepix]
    bbits = 8 * bytepix
    mask = (1 << bbits) - 1
    vals = np.asarray(values).astype(np.int64) & mask
    npix = vals.shape[0]
    w = _BitWriter()
    first = int(vals[0])
    w.write(first, bbits)
    lastpix = first
    # zigzag-mapped successive differences (wraparound arithmetic)
    diffs = np.empty(npix, dtype=object)
    for idx in range(npix):
        d = (int(vals[idx]) - lastpix) & mask
        if d >= (1 << (bbits - 1)):
            d -= 1 << bbits     # shortest signed representative
        diffs[idx] = (~(d << 1)) if d < 0 else (d << 1)
        lastpix = int(vals[idx])
    i = 0
    while i < npix:
        thisblock = min(blocksize, npix - i)
        block = [int(diffs[i + j]) for j in range(thisblock)]
        pixelsum = float(sum(block))
        if pixelsum == 0.0:
            w.write(0, fsbits)          # selector 0 -> fs = -1: all zero
            i += thisblock
            continue
        dpsum = (pixelsum - thisblock / 2.0 - 1.0) / thisblock
        if dpsum < 0:
            dpsum = 0.0
        psum = int(dpsum) >> 1
        fs = 0
        while psum > 0:
            psum >>= 1
            fs += 1
        if fs >= fsmax:
            w.write(fsmax + 1, fsbits)  # escape: raw bbits copies
            for v in block:
                w.write(v, bbits)
        else:
            w.write(fs + 1, fsbits)
            for v in block:
                top = v >> fs
                w.write(1, top + 1)     # `top` zeros then a 1
                if fs:
                    w.write(v, fs)
        i += thisblock
    return w.done()


# -------------------------------------------------------------- GZIP 1/2


def _gzip_decompress(buf):
    # CFITSIO/fpack/astropy write tiles in gzip container format (1f 8b);
    # wbits=47 auto-detects gzip or zlib headers so both interoperate
    return zlib.decompress(bytes(buf), 47)


def _gzip_compress(raw):
    # emit the gzip container CFITSIO expects (mtime=0: deterministic)
    co = zlib.compressobj(9, zlib.DEFLATED, 16 + 15)
    return co.compress(raw) + co.flush()


def _gzip1_decode(buf, npix, dtype):
    raw = _gzip_decompress(buf)
    return np.frombuffer(raw, dtype=dtype, count=npix).astype(
        dtype.newbyteorder("="))


def _gzip2_decode(buf, npix, dtype):
    raw = _gzip_decompress(buf)
    itemsize = dtype.itemsize
    shuf = np.frombuffer(raw, dtype=np.uint8, count=npix * itemsize)
    unshuf = shuf.reshape(itemsize, npix).T.copy()
    return unshuf.view(dtype)[:, 0].astype(dtype.newbyteorder("="))


# ------------------------------------------------------------- the HDU


def _tile_grid(znaxis, ztile):
    """Tile spans in numpy (reversed-FITS) axis order; iteration is FITS
    order (axis 1 fastest)."""
    counts = [-(-n // t) for n, t in zip(znaxis, ztile)]
    return counts


def _header_get_int(header, key, default=None):
    v = header.get(key, default)
    if v is None:
        raise FITSReadError(f"compressed HDU missing {key}")
    return int(v)


def _parse_bintable_columns(header, table_buf):
    """Parse the fixed table: P descriptors -> (len, offset) int32 pairs,
    Q descriptors -> int64 pairs; scalar numeric columns (ZSCALE/ZZERO/
    ZBLANK)."""
    nrows = _header_get_int(header, "NAXIS2")
    rowlen = _header_get_int(header, "NAXIS1")
    tfields = _header_get_int(header, "TFIELDS")
    names, formats, offsets = [], [], []
    off = 0
    for i in range(1, tfields + 1):
        name = str(header.get(f"TTYPE{i}", f"COL{i}")).strip()
        tform = str(header[f"TFORM{i}"]).strip()
        m = _re.fullmatch(r"(\d*)([PQ])([A-Z])\(?\d*\)?", tform)
        if m:
            kind = ">i4" if m.group(2) == "P" else ">i8"
            names.append(name)
            formats.append((kind, (2,)))
            offsets.append(off)
            off += np.dtype(kind).itemsize * 2
            continue
        m = _re.fullmatch(r"(\d*)([LBIJKED])", tform)
        if not m:
            raise FITSReadError(f"unsupported TFORM {tform!r} in "
                                "compressed HDU")
        rep = int(m.group(1) or 1)
        base = {"L": ">u1", "B": ">u1", "I": ">i2", "J": ">i4",
                "K": ">i8", "E": ">f4", "D": ">f8"}[m.group(2)]
        names.append(name)
        formats.append(base if rep == 1 else (base, (rep,)))
        offsets.append(off)
        off += np.dtype(base).itemsize * rep
    dtype = np.dtype({"names": names, "formats": formats,
                      "offsets": offsets, "itemsize": rowlen})
    return np.frombuffer(table_buf[:nrows * rowlen], dtype=dtype), names


def _tile_slices_for_row(row, counts, tile, dims):
    """numpy slices of tile number ``row`` (0-based, FITS iteration
    order: axis 1 fastest)."""
    rem = row
    idx_fits = []
    for c in counts[::-1]:             # FITS axis 1 first
        idx_fits.append(rem % c)
        rem //= c
    return tuple(slice(idx * t, min(idx * t + t, n))
                 for idx, t, n in zip(idx_fits[::-1], tile, dims))


def decompress_image_hdu(header, table_buf, heap_buf):
    """Reconstruct (image_header_dict, data ndarray) from a tile-compressed
    BINTABLE's fixed table bytes + heap bytes.

    Handles lossless integer tiles, lossless float tiles (GZIP), and
    quantized float tiles (ZSCALE/ZZERO columns or keywords, optional
    ZQUANTIZ subtractive dithering, ZBLANK nulls), plus the
    GZIP_COMPRESSED_DATA fallback column of raw original pixels."""
    cmptype = str(header.get("ZCMPTYPE", "")).strip().upper()
    if cmptype not in ("RICE_1", "RICE_ONE", "GZIP_1", "GZIP_2"):
        raise FITSReadError(
            f"unsupported tile compression {cmptype or '?'!r} "
            "(supported: RICE_1, GZIP_1, GZIP_2)")
    zbitpix = _header_get_int(header, "ZBITPIX")
    znaxis_n = _header_get_int(header, "ZNAXIS")
    dims_fits = [_header_get_int(header, f"ZNAXIS{i}")
                 for i in range(1, znaxis_n + 1)]
    tile_fits = [int(header.get(f"ZTILE{i}", dims_fits[0] if i == 1 else 1))
                 for i in range(1, znaxis_n + 1)]
    # RICE parameters
    blocksize, bytepix = 32, abs(zbitpix) // 8 if zbitpix > 0 else 4
    for i in (1, 2):
        name = str(header.get(f"ZNAME{i}", "")).strip().upper()
        if name == "BLOCKSIZE":
            blocksize = _header_get_int(header, f"ZVAL{i}")
        elif name == "BYTEPIX":
            bytepix = _header_get_int(header, f"ZVAL{i}")
    if bytepix not in _FSBITS and cmptype.startswith("RICE"):
        raise FITSReadError(f"RICE_1 BYTEPIX {bytepix} unsupported")

    rec, names = _parse_bintable_columns(header, table_buf)
    nrows = len(rec)

    col = rec["COMPRESSED_DATA"] if "COMPRESSED_DATA" in names else None
    gzip_col = rec["GZIP_COMPRESSED_DATA"] \
        if "GZIP_COMPRESSED_DATA" in names else None
    if col is None and gzip_col is None:
        raise FITSReadError("compressed HDU lacks COMPRESSED_DATA")

    # per-tile quantization scale/zero: table columns, else constant
    # header keywords (the convention allows either)
    zscale = zzero = None
    if "ZSCALE" in names:
        zscale = rec["ZSCALE"].astype("f8")
    elif "ZSCALE" in header:
        zscale = np.full(nrows, float(header["ZSCALE"]))
    if "ZZERO" in names:
        zzero = rec["ZZERO"].astype("f8")
    elif "ZZERO" in header:
        zzero = np.full(nrows, float(header["ZZERO"]))
    if "ZBLANK" in names:
        zblank = rec["ZBLANK"].astype("i8")
    elif header.get("ZBLANK", None) is not None:
        zblank = np.full(nrows, int(header["ZBLANK"]))
    else:
        zblank = None

    zquantiz = str(header.get("ZQUANTIZ", "")).strip().upper()
    if zquantiz in ("SUBTRACTIVE_DITHER_1", "SUBTRACTIVE_DITHER_2"):
        dither_method = 1 if zquantiz.endswith("_1") else 2
        zdither0 = int(header.get("ZDITHER0", 0))
        if "ZDITHER0" not in header:
            raise FITSReadError(
                f"{zquantiz} compressed HDU is missing ZDITHER0 (the "
                "dither seed) — cannot reverse the dithering")
    elif zquantiz in ("", "NONE", "NO_DITHER"):
        dither_method = 0
        zdither0 = 0
    else:
        raise FITSReadError(f"unsupported ZQUANTIZ {zquantiz!r} "
                            "(supported: NO_DITHER, SUBTRACTIVE_DITHER_1, "
                            "SUBTRACTIVE_DITHER_2)")

    # Quantized float data is signalled by the scale/zero columns (or a
    # dithering ZQUANTIZ), NOT by the sign of ZBITPIX: real fpack/astropy
    # products have ZBITPIX = -32 *and* ZSCALE/ZZERO columns, storing
    # int32 tile payloads.
    quantized = (zscale is not None or zzero is not None
                 or dither_method > 0)

    # numpy (reversed) geometry
    dims = dims_fits[::-1]
    tile = tile_fits[::-1]
    counts = _tile_grid(dims, tile)
    ntiles = int(np.prod(counts))
    if nrows != ntiles:
        raise FITSReadError(f"compressed HDU has {nrows} rows for "
                            f"{ntiles} tiles")

    if zbitpix < 0:
        out_dtype = np.float32 if zbitpix == -32 else np.float64
        orig_dtype = np.dtype(">f4" if zbitpix == -32 else ">f8")
    else:
        float_out = quantized or (zblank is not None)
        out_dtype = np.float64 if float_out else {
            8: np.uint8, 16: np.int16, 32: np.int32, 64: np.int64}[zbitpix]
        orig_dtype = np.dtype({8: ">u1", 16: ">i2", 32: ">i4",
                               64: ">i8"}[zbitpix])
    if quantized:
        # quantized payloads are stored integers of BYTEPIX width (RICE)
        # or int32 (GZIP of the quantized array)
        comp_dtype = np.dtype({1: ">u1", 2: ">i2", 4: ">i4"}[
            bytepix if cmptype.startswith("RICE") else 4])
    else:
        comp_dtype = orig_dtype

    data = np.empty(dims, dtype=out_dtype)

    # ---- gather per-tile payload descriptors (vectorized over rows)
    if col is not None:
        lens = col[:, 0].astype(np.int64)
        offs = col[:, 1].astype(np.int64)
    else:
        lens = np.zeros(ntiles, dtype=np.int64)
        offs = np.zeros(ntiles, dtype=np.int64)
    if gzip_col is not None:
        is_fallback = lens == 0
        lens = np.where(is_fallback, gzip_col[:, 0].astype(np.int64), lens)
        offs = np.where(is_fallback, gzip_col[:, 1].astype(np.int64), offs)
    else:
        is_fallback = np.zeros(ntiles, dtype=bool)

    # per-tile pixel counts: outer product of per-axis tile extents
    # (edge tiles shrink); C-order ravel of the numpy-ordered grid walks
    # tiles with FITS axis 1 fastest — exactly the table row order
    ax_sizes = [np.minimum(t, n - np.arange(c) * t)
                for n, t, c in zip(dims, tile, counts)]
    npix_grid = ax_sizes[0]
    for s in ax_sizes[1:]:
        npix_grid = np.multiply.outer(npix_grid, s)
    npix_arr = npix_grid.reshape(-1).astype(np.int64)
    # each tile is a contiguous C-order span (and table row order equals
    # flat order) iff, with k the last numpy axis the tiling splits, all
    # slower axes have tile extent 1: then every tile is (slow indices
    # fixed) x (one span of axis k) x (full faster axes)
    partial = [i for i in range(len(dims)) if tile[i] < dims[i]]
    if partial:
        k = partial[-1]
        contiguous = all(tile[i] == 1 or dims[i] == 1 for i in range(k))
    else:
        contiguous = True
    img_off = np.zeros(ntiles + 1, dtype=np.int64)
    np.cumsum(npix_arr, out=img_off[1:])

    # ---- decode all tiles into one flat array (image iteration order)
    total = int(img_off[-1])
    prim_idx = np.nonzero(~is_fallback)[0]
    fb_idx = np.nonzero(is_fallback)[0]
    if quantized:
        flat = np.empty(total, dtype=np.float64)
    else:
        flat = np.empty(total, dtype=comp_dtype.newbyteorder("="))

    def _store(row, vals):
        flat[img_off[row]:img_off[row + 1]] = vals

    if cmptype.startswith("RICE") and len(prim_idx) and quantized:
        # fused native path: decode + unquantize (scale/zero, dither,
        # ZBLANK) straight into the output buffer, multithreaded
        fused = None
        try:
            from .native import rice_decode_unquantize_native
            fdtype = out_dtype if out_dtype in (np.float32, np.float64) \
                else np.float64
            fused = rice_decode_unquantize_native(
                heap_buf, offs[prim_idx], lens[prim_idx],
                npix_arr[prim_idx], img_off[prim_idx], prim_idx + 1,
                blocksize, bytepix,
                zscale[prim_idx] if zscale is not None else None,
                zzero[prim_idx] if zzero is not None else None,
                dither_method, zdither0,
                zblank[prim_idx] if zblank is not None else None,
                total, fdtype)
        except ValueError as exc:
            raise FITSReadError(str(exc))
        except Exception:
            fused = None
        if fused is not None:
            flat = fused
            for row in fb_idx:
                flat[img_off[row]:img_off[row + 1]] = _gzip1_decode(
                    heap_buf[offs[row]:offs[row] + lens[row]],
                    int(npix_arr[row]), orig_dtype)
            if contiguous:
                data.reshape(-1)[:] = flat.astype(out_dtype, copy=False)
            else:
                for row in range(ntiles):
                    s = _tile_slices_for_row(row, counts, tile, dims)
                    data[s] = flat[img_off[row]:img_off[row + 1]] \
                        .reshape([sl.stop - sl.start for sl in s]) \
                        .astype(out_dtype, copy=False)
            return _rebuild_image_header(header, zbitpix, znaxis_n,
                                         dims_fits, data), data

    if cmptype.startswith("RICE") and len(prim_idx):
        decoded = None
        try:
            from .native import rice_decode_tiles_native
            out_off = np.zeros(len(prim_idx), dtype=np.int64)
            np.cumsum(npix_arr[prim_idx][:-1], out=out_off[1:])
            ptotal = int(npix_arr[prim_idx].sum())
            decoded = rice_decode_tiles_native(
                heap_buf, offs[prim_idx], lens[prim_idx],
                npix_arr[prim_idx], out_off, blocksize, bytepix, ptotal)
        except ValueError as exc:
            raise FITSReadError(str(exc))
        except Exception:
            decoded = None
        if decoded is None:
            decoded = np.empty(int(npix_arr[prim_idx].sum()),
                               dtype=np.int64)
            out_off = np.zeros(len(prim_idx), dtype=np.int64)
            np.cumsum(npix_arr[prim_idx][:-1], out=out_off[1:])
            for k, row in enumerate(prim_idx):
                decoded[out_off[k]:out_off[k] + npix_arr[row]] = \
                    rice_decode(heap_buf[offs[row]:offs[row] + lens[row]],
                                int(npix_arr[row]), blocksize=blocksize,
                                bytepix=bytepix)
        ivals_prim = decoded
    else:
        decode1 = _gzip1_decode if cmptype == "GZIP_1" else _gzip2_decode
        if quantized:
            out_off = np.zeros(len(prim_idx), dtype=np.int64)
            np.cumsum(npix_arr[prim_idx][:-1], out=out_off[1:])
            ivals_prim = np.empty(int(npix_arr[prim_idx].sum()),
                                  dtype=np.int64)
            for k, row in enumerate(prim_idx):
                ivals_prim[out_off[k]:out_off[k] + npix_arr[row]] = \
                    decode1(heap_buf[offs[row]:offs[row] + lens[row]],
                            int(npix_arr[row]), comp_dtype)
        else:
            ivals_prim = None
            for row in prim_idx:
                _store(row, decode1(
                    heap_buf[offs[row]:offs[row] + lens[row]],
                    int(npix_arr[row]), comp_dtype))

    if quantized and len(prim_idx):
        # vectorized unquantize over the primary tiles: per-pixel scale /
        # zero / dither / null via np.repeat of the per-tile columns,
        # CHUNKED over tile groups so the repeat/dither temporaries stay
        # O(chunk) instead of ~6x the image size in host RAM
        npx = npix_arr[prim_idx]
        tile_off = np.zeros(len(prim_idx), dtype=np.int64)
        np.cumsum(npx[:-1], out=tile_off[1:])
        fv = ivals_prim.astype(np.float64)
        chunk_px = _UNQUANT_CHUNK_PX
        lo = 0
        while lo < len(prim_idx):
            hi = lo + 1
            while hi < len(prim_idx) and \
                    int(tile_off[hi] + npx[hi] - tile_off[lo]) <= chunk_px:
                hi += 1
            a = int(tile_off[lo])
            b = int(tile_off[hi - 1] + npx[hi - 1])
            iv = ivals_prim[a:b]
            seg = fv[a:b]
            sc_px = np.repeat(zscale[prim_idx[lo:hi]]
                              if zscale is not None
                              else np.ones(hi - lo), npx[lo:hi])
            zr_px = np.repeat(zzero[prim_idx[lo:hi]]
                              if zzero is not None
                              else np.zeros(hi - lo), npx[lo:hi])
            if dither_method:
                dith = _dither_values_batch(prim_idx[lo:hi] + 1,
                                            zdither0, npx[lo:hi])
                seg[:] = (seg - dith + 0.5) * sc_px + zr_px
            else:
                seg *= sc_px
                seg += zr_px
            if dither_method == 2:
                seg[iv == _ZERO_VALUE] = 0.0
            if zblank is not None:
                null_px = np.repeat(zblank[prim_idx[lo:hi]], npx[lo:hi])
                seg[iv == null_px] = np.nan
            else:
                seg[iv == _NULL_VALUE] = np.nan
            lo = hi
        # scatter into flat (primary tiles may interleave with fallback)
        if len(fb_idx) == 0:
            flat = fv
        else:
            for k, row in enumerate(prim_idx):
                flat[img_off[row]:img_off[row + 1]] = \
                    fv[out_off[k]:out_off[k] + npix_arr[row]]
    elif not quantized and ivals_prim is not None:
        if len(fb_idx) == 0:
            flat = ivals_prim
        else:
            for k, row in enumerate(prim_idx):
                flat[img_off[row]:img_off[row + 1]] = \
                    ivals_prim[out_off[k]:out_off[k] + npix_arr[row]]

    # fallback rows hold the gzip of the ORIGINAL pixels (float for
    # quantized images): decode with the image dtype, no scaling
    for row in fb_idx:
        _store(row, _gzip1_decode(
            heap_buf[offs[row]:offs[row] + lens[row]],
            int(npix_arr[row]), orig_dtype))

    # integer images with ZBLANK promote blanks to NaN
    if not quantized and zbitpix > 0 and zblank is not None:
        null_px = np.repeat(zblank, npix_arr)
        flat = np.where(flat == null_px, np.nan, flat.astype(np.float64))

    # ---- scatter into the image
    if contiguous:
        data.reshape(-1)[:] = flat.astype(out_dtype, copy=False)
    else:
        for row in range(ntiles):
            s = _tile_slices_for_row(row, counts, tile, dims)
            data[s] = flat[img_off[row]:img_off[row + 1]] \
                .reshape([sl.stop - sl.start for sl in s]) \
                .astype(out_dtype, copy=False)

    return _rebuild_image_header(header, zbitpix, znaxis_n, dims_fits,
                                 data), data


def _rebuild_image_header(header, zbitpix, znaxis_n, dims_fits, data):
    """Reconstructed image header: Z-keywords restored, table scaffolding
    dropped (mirrors astropy CompImageHDU.header)."""
    img = OrderedDict()
    img["BITPIX"] = zbitpix if zbitpix < 0 else (
        -64 if data.dtype.kind == "f" else zbitpix)
    img["NAXIS"] = znaxis_n
    for i in range(1, znaxis_n + 1):
        img[f"NAXIS{i}"] = dims_fits[i - 1]
    drop_prefixes = ("Z", "TTYPE", "TFORM", "TUNIT", "TDIM")
    drop = {"XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT",
            "GCOUNT", "TFIELDS", "THEAP", "EXTNAME"}
    for key in header.keys():
        ku = str(key).upper()
        if ku in drop or any(ku.startswith(p) and ku != "ZODIAC"
                             for p in drop_prefixes):
            continue
        img[key] = header[key]
    return img


# --------------------------------------------------------------- writer


def _estimate_noise(tile_vals):
    """Robust per-tile background-noise sigma from median absolute
    third-order differences (the estimator the convention recommends for
    choosing ZSCALE; CFITSIO's FnNoise3 uses the same statistic)."""
    v = tile_vals[np.isfinite(tile_vals)]
    if v.size < 4:
        return 0.0
    d = np.abs(2.0 * v[1:-1] - v[:-2] - v[2:])
    med = float(np.median(d))
    # E|2x1 - x0 - x2| for N(0, sigma) differences = sigma*sqrt(6)*
    # sqrt(2/pi); invert via the normal-consistency constant 1.482602
    return 1.482602 / np.sqrt(6.0) * med


def _quantize_tile(tile_vals, row1, qlevel, dither_method, zdither0):
    """Quantize one float tile to int32.  Returns (ints, zscale, zzero)
    or None when the tile cannot be quantized (dynamic range too wide for
    int32, or no finite pixels to set a scale from)."""
    finite = np.isfinite(tile_vals)
    if not finite.any():
        return (np.full(tile_vals.size, _NULL_VALUE, dtype=np.int32),
                1.0, 0.0)
    fv = tile_vals[finite]
    if qlevel < 0:
        delta = -float(qlevel)
    else:
        noise = _estimate_noise(tile_vals)
        if noise == 0.0:
            # flat/noiseless tile: pick a delta that preserves the full
            # float precision of the span (lossless for constants)
            span = float(fv.max() - fv.min())
            delta = span / 2.0 ** 24 if span > 0 else 1.0
        else:
            delta = float(noise) / float(qlevel)
    zzero = float(fv.min())
    span = (float(fv.max()) - zzero) / delta
    if not np.isfinite(span) or span > 2 ** 31 - 16:
        return None                 # range too wide: store lossless
    ints = np.empty(tile_vals.size, dtype=np.int32)
    scaled = (tile_vals.astype(np.float64) - zzero) / delta
    if dither_method:
        dither = _dither_values(row1, zdither0, tile_vals.size) \
            .astype(np.float64)
        q = scaled + dither - 0.5
    else:
        q = scaled
    # NINT: round half away from zero, like CFITSIO
    qr = np.where(q >= 0, np.floor(q + 0.5), np.ceil(q - 0.5))
    ints[:] = np.where(finite, qr, _NULL_VALUE).astype(np.int32)
    if dither_method == 2:
        ints[:] = np.where(finite & (tile_vals == 0.0), _ZERO_VALUE, ints)
    return ints, delta, zzero


def _quantize_rows(rows2d, qlevel, dither_method, zdither0,
                   chunk_rows=65536):
    """Vectorized :func:`_quantize_tile` over uniform tiles laid out as
    the rows of ``rows2d`` (tile t == table row t+1).  Returns
    ``(ints2d, zscales, zzeros, bad)`` where ``bad`` marks tiles whose
    dynamic range cannot quantize (stored losslessly by the caller).

    The relative-qlevel noise estimate takes the median of absolute
    third-order differences over raw positions (NaN-adjacent differences
    excluded via nanmedian) — same statistic as the per-tile path up to
    NaN-compaction, and the chosen per-tile ZSCALE is recorded in the
    table either way."""
    ntiles, npx = rows2d.shape
    ints2d = np.empty((ntiles, npx), dtype=np.int32)
    zscales = np.ones(ntiles, dtype=np.float64)
    zzeros = np.zeros(ntiles, dtype=np.float64)
    bad = np.zeros(ntiles, dtype=bool)
    for lo in range(0, ntiles, chunk_rows):
        hi = min(ntiles, lo + chunk_rows)
        v = rows2d[lo:hi].astype(np.float64, copy=False)
        finite = np.isfinite(v)
        nfin = finite.sum(axis=1)
        with np.errstate(all="ignore"):
            vmin = np.nanmin(np.where(finite, v, np.nan), axis=1)
            vmax = np.nanmax(np.where(finite, v, np.nan), axis=1)
            if qlevel < 0:
                delta = np.full(hi - lo, -float(qlevel))
            else:
                if npx >= 4:
                    d3 = np.abs(2.0 * v[:, 1:-1] - v[:, :-2] - v[:, 2:])
                    med = np.nanmedian(d3, axis=1)
                else:
                    med = np.zeros(hi - lo)
                med = np.where(np.isfinite(med), med, 0.0)
                noise = 1.482602 / np.sqrt(6.0) * med
                span = vmax - vmin
                flat_delta = np.where(span > 0, span / 2.0 ** 24, 1.0)
                delta = np.where(noise > 0, noise / qlevel, flat_delta)
        empty = nfin == 0
        zz = np.where(empty, 0.0, np.where(np.isnan(vmin), 0.0, vmin))
        with np.errstate(all="ignore"):
            span_steps = (vmax - zz) / delta
            cbad = ~empty & (~np.isfinite(span_steps)
                             | (span_steps > 2 ** 31 - 16))
            scaled = (v - zz[:, None]) / delta[:, None]
            if dither_method:
                rows1 = np.arange(lo + 1, hi + 1, dtype=np.int64)
                dith = _dither_values_batch(
                    rows1, zdither0,
                    np.full(hi - lo, npx, dtype=np.int64)) \
                    .astype(np.float64).reshape(hi - lo, npx)
                q = scaled + dith - 0.5
            else:
                q = scaled
            qr = np.where(q >= 0, np.floor(q + 0.5), np.ceil(q - 0.5))
            qr = np.where(finite, qr, _NULL_VALUE)
            qr = np.where(np.isfinite(qr), qr, _NULL_VALUE)
            # cbad rows can hold values beyond int32: clip before the
            # cast (their ints are discarded — the raw tile is stored
            # losslessly) so no RuntimeWarning escapes under -W error
            qr = np.clip(qr, np.iinfo(np.int32).min,
                         np.iinfo(np.int32).max)
            ichunk = qr.astype(np.int32)
        if dither_method == 2:
            ichunk[finite & (v == 0.0)] = _ZERO_VALUE
        ichunk[empty] = _NULL_VALUE
        ints2d[lo:hi] = ichunk
        zscales[lo:hi] = delta
        zzeros[lo:hi] = zz
        bad[lo:hi] = cbad
    return ints2d, zscales, zzeros, bad


def compressed_image_blocks(data, header=None, cmptype="RICE_1",
                            tile=None, blocksize=32, quantize_level=None,
                            dither="SUBTRACTIVE_DITHER_1", dither_seed=1):
    """Build the BINTABLE header dict + table/heap payload bytes for one
    tile-compressed image HDU.

    Integer data is lossless (RICE_1 for <=32-bit; 64-bit integers fall
    back to GZIP_1 of the raw pixels — RICE is a 32-bit code and CFITSIO
    likewise refuses it, so values are never truncated).  Float data is
    stored losslessly via GZIP of the raw bytes by default; pass
    ``quantize_level`` to enable convention-standard lossy quantization
    (CFITSIO semantics: > 0 means ZSCALE = tile-noise/level, < 0 means
    ZSCALE = -level exactly), with subtractive dithering per ``dither``
    ('SUBTRACTIVE_DITHER_1' (default), 'SUBTRACTIVE_DITHER_2',
    'NO_DITHER') and seed ``dither_seed`` (1..10000, the ZDITHER0 card).
    Tiles whose dynamic range cannot quantize into int32 are stored
    losslessly in a GZIP_COMPRESSED_DATA fallback column, as the
    convention specifies.

    Returns (table_header_dict, payload_bytes) where payload is the
    fixed table followed by the heap, unpadded."""
    data = np.asarray(data)
    cmptype = cmptype.upper()
    if cmptype not in ("RICE_1", "GZIP_1", "GZIP_2"):
        raise ValueError(f"unsupported compression {cmptype!r}")
    quantizing = False
    if data.dtype.kind == "f":
        bitpix = -32 if data.dtype.itemsize == 4 else -64
        comp_dtype = np.dtype(">f4" if bitpix == -32 else ">f8")
        if quantize_level is not None:
            if not np.isfinite(quantize_level) or \
                    float(quantize_level) == 0.0:
                # level 0 would divide the noise estimate by zero and
                # write ZSCALE=inf files that read back all-NaN
                raise ValueError(
                    "quantize_level must be a nonzero finite number "
                    f"(got {quantize_level!r})")
            quantizing = True
            comp_dtype = np.dtype(">i4")
        elif cmptype.startswith("RICE"):
            # lossless float RICE needs quantization; store via GZIP_1
            cmptype = "GZIP_1"
    else:
        if data.dtype.kind == "u":
            # FITS integer BITPIX is signed (except 8): promote unsigned
            # types so values are never wrapped
            promote = {1: np.uint8, 2: np.int32, 4: np.int64}
            if data.dtype.itemsize == 8:
                raise ValueError("uint64 image data cannot be stored "
                                 "losslessly in a compressed FITS HDU")
            data = data.astype(promote[data.dtype.itemsize])
        bitpix = {1: 8, 2: 16, 4: 32, 8: 64}[data.dtype.itemsize]
        comp_dtype = np.dtype({8: ">u1", 16: ">i2", 32: ">i4",
                               64: ">i8"}[bitpix])
        if bitpix == 64 and cmptype.startswith("RICE"):
            # RICE_1 is a 32-bit code: int64 pixels outside int32 range
            # would silently corrupt (CFITSIO refuses 64-bit RICE too)
            cmptype = "GZIP_1"
    dither_method = 0
    if quantizing:
        dmap = {"NO_DITHER": 0, "SUBTRACTIVE_DITHER_1": 1,
                "SUBTRACTIVE_DITHER_2": 2, None: 0}
        key = dither if dither is None else str(dither).upper()
        if key not in dmap:
            raise ValueError(f"unknown dither method {dither!r}")
        dither_method = dmap[key]
        if not (1 <= int(dither_seed) <= _N_RANDOM):
            raise ValueError("dither_seed must be in 1..10000")
    dims = list(data.shape)           # numpy order
    dims_fits = dims[::-1]
    n = len(dims)
    if tile is None:
        tile_fits = [dims_fits[0]] + [1] * (n - 1)
    else:
        tile_fits = list(tile)
    tile_np = tile_fits[::-1]
    counts = _tile_grid(dims, tile_np)
    ntiles = int(np.prod(counts))
    bytepix = min(comp_dtype.itemsize, 4) if comp_dtype.kind != "f" else 4

    # the default row tiling gives uniform contiguous tiles: quantize the
    # whole image in one vectorized pass instead of 10^5+ per-tile calls
    partial = [i for i in range(n) if tile_np[i] < dims[i]]
    uniform_contig = (not partial or (
        all(tile_np[i] == 1 or dims[i] == 1 for i in range(partial[-1]))
        and dims[partial[-1]] % tile_np[partial[-1]] == 0))

    # gather tiles (and quantize float tiles when requested)
    tiles_ints = [None] * ntiles     # int arrays headed for the codec
    tiles_raw = [None] * ntiles      # raw original pixels (fallback rows)
    pre_encoded = [None] * ntiles    # bitstreams from the fused native path
    zscales = np.ones(ntiles, dtype=np.float64)
    zzeros = np.zeros(ntiles, dtype=np.float64)
    any_null = False
    if quantizing and uniform_contig and ntiles > 1:
        rows2d = np.ascontiguousarray(data).reshape(ntiles, -1)
        fused = None
        if cmptype == "RICE_1" and rows2d.dtype == np.float32:
            # fused native path: quantize + encode per tile in C++
            try:
                from .native import rice_quantize_encode_native
                npx_row = rows2d.shape[1]
                npx = np.full(ntiles, npx_row, dtype=np.int64)
                ioff = np.arange(ntiles, dtype=np.int64) * npx_row
                fused = rice_quantize_encode_native(
                    rows2d.reshape(-1), npx, ioff, blocksize,
                    float(quantize_level), dither_method,
                    int(dither_seed))
            except Exception:
                fused = None
        if fused is not None:
            enc_list, zscales, zzeros, any_null = fused
            zscales = zscales.copy()
            zzeros = zzeros.copy()
            for row, e in enumerate(enc_list):
                if e == -2:             # range too wide: store lossless
                    tiles_raw[row] = rows2d[row]
                elif e == -1:           # capacity miss: Python re-encode
                    q = _quantize_tile(rows2d[row], row + 1,
                                       float(quantize_level),
                                       dither_method, int(dither_seed))
                    if q is None:
                        tiles_raw[row] = rows2d[row]
                    else:
                        ints, zscales[row], zzeros[row] = q
                        pre_encoded[row] = rice_encode(
                            ints.astype(np.int64), blocksize=blocksize,
                            bytepix=4)
                else:
                    pre_encoded[row] = e
        else:
            ints2d, zscales, zzeros, bad = _quantize_rows(
                rows2d, float(quantize_level), dither_method,
                int(dither_seed))
            # infs quantize to the null sentinel too: ZBLANK must cover
            # every non-finite pixel or external readers unscale garbage
            any_null = not bool(np.isfinite(rows2d).all())
            for row in range(ntiles):
                if bad[row]:
                    tiles_raw[row] = rows2d[row]
                else:
                    tiles_ints[row] = ints2d[row]
    else:
        for row in range(ntiles):
            s = _tile_slices_for_row(row, counts, tile_np, dims)
            tvals = np.ascontiguousarray(data[s]).ravel()
            if quantizing:
                q = _quantize_tile(tvals, row + 1, float(quantize_level),
                                   dither_method, int(dither_seed))
                if q is None:
                    tiles_raw[row] = tvals
                else:
                    tiles_ints[row], zscales[row], zzeros[row] = q
                    if not np.isfinite(tvals).all():
                        any_null = True
            elif comp_dtype.kind == "f":
                tiles_raw[row] = tvals    # lossless float: always gzip
            else:
                tiles_ints[row] = tvals
    use_fallback_col = any(t is not None for t in tiles_raw) and (
        quantizing or cmptype.startswith("RICE"))

    # encode (tiles the fused native path already encoded pass through)
    encoded = list(pre_encoded)      # primary-column bytes
    fallback = [None] * ntiles       # GZIP_COMPRESSED_DATA bytes
    if cmptype == "RICE_1":
        int_rows = [r for r in range(ntiles) if tiles_ints[r] is not None]
        if int_rows:
            flat = np.concatenate([
                np.asarray(tiles_ints[r], dtype=np.int64) for r in int_rows])
            # native batch encode wants int32-representable values
            native_ok = bool(np.all(flat >= np.iinfo(np.int32).min)
                             and np.all(flat <= np.iinfo(np.int32).max))
            enc_list = None
            if native_ok:
                try:
                    from .native import rice_encode_tiles_native
                    npx = np.asarray([tiles_ints[r].size for r in int_rows],
                                     dtype=np.int64)
                    ioff = np.zeros(len(int_rows), dtype=np.int64)
                    np.cumsum(npx[:-1], out=ioff[1:])
                    enc_list = rice_encode_tiles_native(
                        flat.astype(np.int32), npx, ioff, blocksize,
                        bytepix)
                except Exception:
                    enc_list = None
            for k, r in enumerate(int_rows):
                enc = enc_list[k] if enc_list is not None else None
                if enc is None:
                    enc = rice_encode(
                        np.asarray(tiles_ints[r]).astype(np.int64),
                        blocksize=blocksize, bytepix=bytepix)
                encoded[r] = enc
    elif cmptype == "GZIP_1":
        for r in range(ntiles):
            if tiles_ints[r] is not None:
                encoded[r] = _gzip_compress(
                    np.asarray(tiles_ints[r]).astype(comp_dtype).tobytes())
            elif not use_fallback_col:
                encoded[r] = _gzip_compress(
                    np.asarray(tiles_raw[r]).astype(comp_dtype).tobytes())
    else:  # GZIP_2: byte-shuffled gzip
        for r in range(ntiles):
            vals = tiles_ints[r] if tiles_ints[r] is not None else (
                None if use_fallback_col else tiles_raw[r])
            if vals is None:
                continue
            be = np.asarray(vals).astype(comp_dtype).view(np.uint8) \
                .reshape(-1, comp_dtype.itemsize).T
            encoded[r] = _gzip_compress(np.ascontiguousarray(be).tobytes())
    if use_fallback_col:
        if data.dtype.kind == "f":
            orig_be = np.dtype(">f4" if bitpix == -32 else ">f8")
        else:
            orig_be = comp_dtype
        for r in range(ntiles):
            if tiles_raw[r] is not None:
                fallback[r] = _gzip_compress(
                    np.asarray(tiles_raw[r]).astype(orig_be).tobytes())

    heap = bytearray()
    descrs = []
    fdescrs = []
    for r in range(ntiles):
        if encoded[r] is not None:
            descrs.append((len(encoded[r]), len(heap)))
            heap.extend(encoded[r])
        else:
            descrs.append((0, 0))
        if fallback[r] is not None:
            fdescrs.append((len(fallback[r]), len(heap)))
            heap.extend(fallback[r])
        else:
            fdescrs.append((0, 0))

    cols = [("COMPRESSED_DATA", ("d", ">i4", (2,)))]
    if use_fallback_col:
        cols.append(("GZIP_COMPRESSED_DATA", ("g", ">i4", (2,))))
    if quantizing:
        cols.append(("ZSCALE", ("s", ">f8")))
        cols.append(("ZZERO", ("z", ">f8")))
    table = np.zeros((ntiles,), dtype=np.dtype([c[1] for c in cols]))
    table["d"] = descrs
    if use_fallback_col:
        table["g"] = fdescrs
    if quantizing:
        table["s"] = zscales
        table["z"] = zzeros
    maxlen = max((d[0] for d in descrs), default=0)
    maxflen = max((d[0] for d in fdescrs), default=0)

    hdr = OrderedDict()
    hdr["XTENSION"] = "BINTABLE"
    hdr["BITPIX"] = 8
    hdr["NAXIS"] = 2
    hdr["NAXIS1"] = table.dtype.itemsize
    hdr["NAXIS2"] = ntiles
    hdr["PCOUNT"] = len(heap)
    hdr["GCOUNT"] = 1
    hdr["TFIELDS"] = len(cols)
    tnum = 1
    hdr["TTYPE1"] = "COMPRESSED_DATA"
    hdr["TFORM1"] = f"1PB({maxlen})"
    tnum = 2
    if use_fallback_col:
        hdr[f"TTYPE{tnum}"] = "GZIP_COMPRESSED_DATA"
        hdr[f"TFORM{tnum}"] = f"1PB({maxflen})"
        tnum += 1
    if quantizing:
        hdr[f"TTYPE{tnum}"] = "ZSCALE"
        hdr[f"TFORM{tnum}"] = "1D"
        hdr[f"TTYPE{tnum + 1}"] = "ZZERO"
        hdr[f"TFORM{tnum + 1}"] = "1D"
        tnum += 2
    hdr["ZIMAGE"] = True
    hdr["ZCMPTYPE"] = cmptype
    hdr["ZBITPIX"] = bitpix
    hdr["ZNAXIS"] = n
    for i in range(1, n + 1):
        hdr[f"ZNAXIS{i}"] = dims_fits[i - 1]
        hdr[f"ZTILE{i}"] = tile_fits[i - 1]
    if cmptype == "RICE_1":
        hdr["ZNAME1"] = "BLOCKSIZE"
        hdr["ZVAL1"] = blocksize
        hdr["ZNAME2"] = "BYTEPIX"
        hdr["ZVAL2"] = bytepix
    if quantizing:
        hdr["ZQUANTIZ"] = {0: "NO_DITHER", 1: "SUBTRACTIVE_DITHER_1",
                           2: "SUBTRACTIVE_DITHER_2"}[dither_method]
        if dither_method:
            hdr["ZDITHER0"] = int(dither_seed)
        if any_null:
            hdr["ZBLANK"] = _NULL_VALUE
    if header is not None:
        skip = set(hdr) | {"SIMPLE", "BITPIX", "NAXIS", "EXTEND"} | {
            f"NAXIS{i}" for i in range(1, 8)}
        for key in header.keys():
            if str(key).upper() not in skip:
                hdr[key] = header[key]
    payload = table.tobytes() + bytes(heap)
    return hdr, payload
