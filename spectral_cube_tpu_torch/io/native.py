"""ctypes bindings for the native FITS payload decoder.

Builds ``native/fits_decode.cpp`` on first use (cached as a .so next to the
source) and exposes :func:`decode_payload` — a fused mmap + byteswap +
scale decode parallelized over host cores.  Falls back to numpy when no
compiler is available, so the pure-Python path always works.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["decode_payload", "native_available", "native_stats_f32",
           "assemble_casa_tiles", "rice_decode_tiles_native",
           "rice_encode_tiles_native"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "fits_decode.cpp")
_SO = os.path.join(os.path.dirname(_SRC), "_fits_decode.so")


def _build():
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", _SO, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            if not os.path.exists(_SO) or (
                    os.path.exists(_SRC)
                    and os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
            lib.fits_decode_payload.restype = ctypes.c_int
            lib.fits_decode_payload.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.fits_stats_f32.restype = None
            lib.fits_stats_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_int]
            P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.rice_decode_tiles.restype = I
            lib.rice_decode_tiles.argtypes = [P, I64, P, P, P, P, I64,
                                              I, I, P, I]
            lib.rice_encode_tiles.restype = I
            lib.rice_encode_tiles.argtypes = [P, P, P, I64, I, I, P, P,
                                              P, I]
            lib.rice_decode_unquantize_tiles.restype = I
            lib.rice_decode_unquantize_tiles.argtypes = [
                P, I64, P, P, P, P, P, I64, I, I, P, P, I, I, P, I, P,
                I, I]
            lib.rice_quantize_encode_tiles.restype = I
            lib.rice_quantize_encode_tiles.argtypes = [
                P, P, P, I64, I, ctypes.c_double, I, I, P, P, P, P, P,
                P, I]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def native_available() -> bool:
    return _load() is not None


# below this, thread spin-up costs more than it saves
_MIN_NATIVE_ELEMENTS = 1 << 20


def decode_payload(path, offset, count, bitpix, bscale=1.0, bzero=0.0,
                   out_dtype=None, nthreads=0):
    """Decode ``count`` elements of a FITS data payload starting at byte
    ``offset`` into a native-endian float array."""
    if out_dtype is None:
        out_dtype = np.float64 if bitpix == -64 else np.float32
    out_dtype = np.dtype(out_dtype)
    if out_dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        # the C++ writer emits exactly count*4 or count*8 bytes; any
        # other out_dtype would overflow or underfill the numpy buffer
        raise ValueError(
            f"decode_payload writes float32/float64, got {out_dtype}")
    lib = _load() if count >= _MIN_NATIVE_ELEMENTS else None
    if lib is not None:
        out = np.empty(count, dtype=out_dtype)
        rc = lib.fits_decode_payload(
            str(path).encode(), int(offset), int(count), int(bitpix),
            float(bscale), float(bzero),
            out.ctypes.data_as(ctypes.c_void_p),
            1 if out_dtype == np.float64 else 0, int(nthreads))
        if rc == 0:
            return out
    # numpy fallback (also the small-array fast path)
    be = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8",
          -32: ">f4", -64: ">f8"}[bitpix]
    raw = np.fromfile(str(path), dtype=be, count=count,
                      offset=int(offset))
    arr = raw.astype(out_dtype)
    if bscale != 1.0 or bzero != 0.0:
        arr = arr * bscale + bzero
    return arr


_TILES_LOCK = threading.Lock()
_TILES_LIB = None
_TILES_TRIED = False
_TILES_SRC = os.path.join(os.path.dirname(_SRC), "casa_tiles.cpp")
_TILES_SO = os.path.join(os.path.dirname(_SRC), "_casa_tiles.so")


def _load_tiles():
    global _TILES_LIB, _TILES_TRIED
    with _TILES_LOCK:
        if _TILES_LIB is not None or _TILES_TRIED:
            return _TILES_LIB
        _TILES_TRIED = True
        try:
            if not os.path.exists(_TILES_SO) or (
                    os.path.exists(_TILES_SRC)
                    and os.path.getmtime(_TILES_SO)
                    < os.path.getmtime(_TILES_SRC)):
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-pthread", "-o", _TILES_SO, _TILES_SRC],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(_TILES_SO)
            lib.casa_assemble_tiles.restype = ctypes.c_int
            lib.casa_assemble_tiles.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            _TILES_LIB = lib
        except Exception:
            _TILES_LIB = None
        return _TILES_LIB


def assemble_casa_tiles(payload, casa_shape, tile_shape, dtype,
                        big_endian, nthreads=0):
    """Scatter a CASA tiled payload into a C-ordered padded numpy array
    (numpy dims = reversed(ntiles*tile)); returns None when the native
    library is unavailable.  ``dtype`` None means bit-packed Bool."""
    lib = _load_tiles()
    if lib is None:
        return None
    ndim = len(casa_shape)
    np_padded = [(-(-c // t)) * t
                 for c, t in zip(casa_shape, tile_shape)][::-1]
    if dtype is None:
        out = np.empty(np_padded, dtype=np.uint8)
        code = 1
    else:
        dt = np.dtype(dtype)
        if dt.itemsize not in (4, 8):
            return None
        out = np.empty(np_padded, dtype=dt.newbyteorder("="))
        code = dt.itemsize
    cshape = (ctypes.c_long * ndim)(*[int(v) for v in casa_shape])
    tshape = (ctypes.c_long * ndim)(*[int(v) for v in tile_shape])
    rc = lib.casa_assemble_tiles(
        payload, len(payload), ndim, cshape, tshape, code,
        1 if big_endian else 0, out.ctypes.data_as(ctypes.c_void_p),
        int(nthreads))
    if rc != 0:
        return None
    return out.astype(bool) if dtype is None else out


# tile decode is bit-serial per tile; oversubscribing threads beyond the
# visible core count measured faster on the cgroup-limited CI hosts
_RICE_THREADS = max(8, os.cpu_count() or 1)


def rice_decode_tiles_native(heap, offsets, lengths, npix, out_offsets,
                             blocksize, bytepix, total, nthreads=0):
    """Batch-decode RICE_1 tiles via the native codec into one flat int32
    array (tile t's values land at ``out_offsets[t]``), or None when the
    native library is unavailable.  Raises on a corrupt bitstream."""
    lib = _load()
    if lib is None or bytepix not in (1, 2, 4):
        return None
    heap = bytes(heap)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    npx = np.ascontiguousarray(npix, dtype=np.int64)
    ooff = np.ascontiguousarray(out_offsets, dtype=np.int64)
    out = np.empty(int(total), dtype=np.int32)
    rc = lib.rice_decode_tiles(
        heap, len(heap), offs.ctypes.data, lens.ctypes.data,
        npx.ctypes.data, ooff.ctypes.data, len(offs), int(blocksize),
        int(bytepix), out.ctypes.data,
        int(nthreads) or _RICE_THREADS)
    if rc != 0:
        raise ValueError(f"RICE_1 tile {rc - 1} bitstream corrupt or "
                         "truncated")
    return out


def rice_encode_tiles_native(vals, npix, in_offsets, blocksize, bytepix,
                             nthreads=0):
    """Batch-encode int32 tiles via the native codec.  Returns a list of
    per-tile ``bytes`` (entries are None for tiles that exceeded the
    worst-case capacity — callers re-encode those via the Python path),
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None or bytepix not in (1, 2, 4):
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    npx = np.ascontiguousarray(npix, dtype=np.int64)
    ioff = np.ascontiguousarray(in_offsets, dtype=np.int64)
    ntiles = len(npx)
    caps = np.zeros(ntiles + 1, dtype=np.int64)
    np.cumsum(npx * (bytepix + 2) + 16, out=caps[1:])
    outbuf = np.empty(int(caps[-1]), dtype=np.uint8)
    outlens = np.empty(ntiles, dtype=np.int64)
    lib.rice_encode_tiles(
        vals.ctypes.data, npx.ctypes.data, ioff.ctypes.data, ntiles,
        int(blocksize), int(bytepix), outbuf.ctypes.data,
        caps.ctypes.data, outlens.ctypes.data,
        int(nthreads) or _RICE_THREADS)
    return [outbuf[caps[t]:caps[t] + outlens[t]].tobytes()
            if outlens[t] >= 0 else None for t in range(ntiles)]


def rice_decode_unquantize_native(heap, offsets, lengths, npix,
                                  out_offsets, rows1, blocksize, bytepix,
                                  zscale, zzero, dither_method, zdither0,
                                  zblank, total, out_dtype, nthreads=0):
    """Fused batch RICE decode + unquantize (scale/zero, dither reversal,
    ZBLANK -> NaN) into one flat float array, or None when the native
    library is unavailable.  Raises ValueError on a corrupt tile."""
    lib = _load()
    if lib is None or bytepix not in (1, 2, 4):
        return None
    heap = bytes(heap)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    npx = np.ascontiguousarray(npix, dtype=np.int64)
    ooff = np.ascontiguousarray(out_offsets, dtype=np.int64)
    out_dtype = np.dtype(out_dtype)
    out = np.empty(int(total), dtype=out_dtype)
    sc = (np.ascontiguousarray(zscale, dtype=np.float64)
          if zscale is not None else None)
    zr = (np.ascontiguousarray(zzero, dtype=np.float64)
          if zzero is not None else None)
    zb = (np.ascontiguousarray(zblank, dtype=np.int64)
          if zblank is not None else None)
    r1 = np.ascontiguousarray(rows1, dtype=np.int64)
    rc = lib.rice_decode_unquantize_tiles(
        heap, len(heap), offs.ctypes.data, lens.ctypes.data,
        npx.ctypes.data, ooff.ctypes.data, r1.ctypes.data, len(offs),
        int(blocksize), int(bytepix),
        sc.ctypes.data if sc is not None else None,
        zr.ctypes.data if zr is not None else None,
        int(dither_method), int(zdither0),
        zb.ctypes.data if zb is not None else None,
        1 if zb is not None else 0,
        out.ctypes.data, 1 if out_dtype == np.float64 else 0,
        int(nthreads) or _RICE_THREADS)
    if rc != 0:
        raise ValueError(f"RICE_1 tile {rc - 1} bitstream corrupt or "
                         "truncated")
    return out


def rice_quantize_encode_native(data_flat_f32, npix, in_offsets,
                                blocksize, qlevel, dither_method,
                                zdither0, nthreads=0):
    """Fused batch quantize + RICE encode of float32 tiles.  Returns
    (enc_list, zscale, zzero, any_null) where enc_list entries are bytes,
    -1 (capacity miss: re-encode via the Python path) or -2 (range too
    wide to quantize: store losslessly); or None when the native library
    is unavailable."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(data_flat_f32, dtype=np.float32)
    npx = np.ascontiguousarray(npix, dtype=np.int64)
    ioff = np.ascontiguousarray(in_offsets, dtype=np.int64)
    ntiles = len(npx)
    caps = np.zeros(ntiles + 1, dtype=np.int64)
    np.cumsum(npx * 6 + 16, out=caps[1:])
    outbuf = np.empty(int(caps[-1]), dtype=np.uint8)
    outlens = np.empty(ntiles, dtype=np.int64)
    zscale = np.empty(ntiles, dtype=np.float64)
    zzero = np.empty(ntiles, dtype=np.float64)
    any_null = ctypes.c_int(0)
    lib.rice_quantize_encode_tiles(
        vals.ctypes.data, npx.ctypes.data, ioff.ctypes.data, ntiles,
        int(blocksize), float(qlevel), int(dither_method), int(zdither0),
        outbuf.ctypes.data, caps.ctypes.data, outlens.ctypes.data,
        zscale.ctypes.data, zzero.ctypes.data, ctypes.byref(any_null),
        int(nthreads) or _RICE_THREADS)
    enc = [outbuf[caps[t]:caps[t] + outlens[t]].tobytes()
           if outlens[t] >= 0 else int(outlens[t]) for t in range(ntiles)]
    return enc, zscale, zzero, bool(any_null.value)


def native_stats_f32(arr: np.ndarray, nthreads=0):
    """One-pass {npts, min, max, sum, sumsq} over a float32 array, or None
    if the native library is unavailable."""
    lib = _load()
    if lib is None or arr.dtype != np.float32 or not arr.flags.c_contiguous:
        return None
    out = np.empty(5, dtype=np.float64)
    lib.fits_stats_f32(arr.ctypes.data_as(ctypes.c_void_p), arr.size,
                       out.ctypes.data_as(ctypes.c_void_p), int(nthreads))
    if out[0] == 0:
        # no finite values: NaN extrema, not the +-1e300 fold sentinels
        return {"npts": 0, "min": np.nan, "max": np.nan,
                "sum": 0.0, "sumsq": 0.0}
    return {"npts": int(out[0]), "min": out[1], "max": out[2],
            "sum": out[3], "sumsq": out[4]}
