"""Torch port, the public surface of ``io/`` against the JAX package: the
format registry, FITS (high and low level, tile compression), CASA images
(the AipsIO streams, the tiled storage, masks), CLASS ``.lmv`` files, the
native codecs and the streaming readers.

Files come from ``tests/torch_public.py``'s inputs, each written by the
package under test (a CASA image by its ``write_casa_image``, an ``.lmv``
by ``chip_smoke.write_lmv``) and read back; byte streams are written by
each package's ``AipsIOWriter``.  Each call is held on the CPU against the
JAX package and on the card outside any guard.
"""

import os
from collections import OrderedDict

import numpy as np

import torch_public as tp
from torch_public import C

MODULES = ("io/__init__.py", "io/casa_image.py", "io/casa_low.py",
           "io/casa_masks.py", "io/casa_writer.py", "io/class_lmv.py",
           "io/fits.py", "io/fits_low.py", "io/native.py", "io/streaming.py",
           "io/tile_compress.py")

RECORD = OrderedDict(a=np.int32(3), b=2.5, c="text",
                     arr=np.arange(6.0).reshape(2, 3))


def _io(k, name=""):
    return k.m("io" + ("." + name if name else ""))


def _cached(k, name, make):
    key = ("io", name)
    if key not in k._inputs:
        k._inputs[key] = make()
    return k._inputs[key]


def _casa(k):
    """A CASA image of the masked cube, written by the package's own
    writer; its directory."""
    def make():
        d = k.out("cube.image")
        _io(k, "casa_writer").write_casa_image(k.inp("cube"), d,
                                               overwrite=True)
        return d
    return _cached(k, "casa", make)


def _lmv(k):
    def make():
        import chip_smoke
        path = k.out("cube.lmv")
        data = np.asarray(k.inp("plain").unmasked_data[:].value, np.float32)
        chip_smoke.write_lmv(path, data, ref_deg=(23.1837, 30.5765),
                             pix_arcsec=2.0, velocity=(-321.2, 1.28))
        return path
    return _cached(k, "lmv", make)


def _stream(k):
    """An AipsIO stream with each scalar kind, a block, an IPosition, an
    array and a table record, written by the package's writer."""
    w = _io(k, "casa_writer").AipsIOWriter()
    w.u8(7)
    w.u32(9)
    w.i32(-3)
    w.f32(1.5)
    w.f64(2.25)
    w.string("abc")
    with w.block("IPosition", 1):
        w.u32(2)
        w.u32(4)
        w.u32(5)
    _io(k, "casa_writer").write_aips_array(w, np.arange(6.0).reshape(2, 3),
                                           21)
    _io(k, "casa_writer").write_recorddesc(w, RECORD)
    _io(k, "casa_writer").write_tablerecord(w, RECORD)
    return w.getvalue()


def _reader(k):
    return _io(k, "casa_low").AipsIO(_stream(k))


def _read_scalars(k):
    a = _reader(k)
    return (a.u8(), a.u32(), a.i32(), a.f32(), a.f64(), a.string(),
            a.iposition())


def _after_scalars(k):
    a = _reader(k)
    for name in ("u8", "u32", "i32", "f32", "f64", "string", "iposition"):
        getattr(a, name)()
    return a


def _read_array(k):
    a = _after_scalars(k)
    return _io(k, "casa_low").read_aips_array(a)


def _read_records(k):
    a = _after_scalars(k)
    low = _io(k, "casa_low")
    low.read_aips_array(a)
    return low.read_recorddesc(a), low.read_tablerecord(a)


def _writer(k, name):
    w = _io(k, "casa_writer").AipsIOWriter()
    return w, getattr(w, name)


def _wrote(k, name, value):
    w, fn = _writer(k, name)
    fn(value)
    return w.getvalue()


def _header(k):
    return k.inp("plain").header


def _compressed(k):
    """The cube as a RICE_1 tile-compressed HDU (quantized, NaNs kept): its
    header, table bytes and heap bytes."""
    tc = _io(k, "tile_compress")
    data = np.asarray(k.inp("plain").unmasked_data[:].value, np.float32)
    chdr, payload = tc.compressed_image_blocks(
        data, cmptype="RICE_1", quantize_level=-0.001, dither_seed=100)
    tbl = int(chdr["NAXIS1"]) * int(chdr["NAXIS2"])
    return _io(k, "fits_low").Header(chdr), payload[:tbl], payload[tbl:]


def _tiles(k, n=(40, 56)):
    vals = (np.arange(sum(n)) * 37 % 1001 - 500).astype(np.int32)
    npix = np.array(n, np.int64)
    offs = np.array([0, n[0]], np.int64)
    return vals, npix, offs


def _encoded(k):
    vals, npix, offs = _tiles(k)
    enc = _io(k, "native").rice_encode_tiles_native(vals, npix, offs, 32, 4)
    return enc, npix


def _decoded(k):
    enc, npix = _encoded(k)
    if enc is None:
        return None
    lens = np.array([len(e) for e in enc], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.concatenate([[0], np.cumsum(npix)[:-1]]).astype(np.int64)
    return _io(k, "native").rice_decode_tiles_native(
        b"".join(enc), offs, lens, npix, out, 32, 4, int(npix.sum()))


def _quantized(k):
    rng = np.random.RandomState(3)
    vals = rng.randn(96).astype(np.float32)
    npix = np.array([40, 56], np.int64)
    offs = np.array([0, 40], np.int64)
    return _io(k, "native").rice_quantize_encode_native(
        vals, npix, offs, 32, 16.0, 1, 1)


def _unquantized(k):
    q = _quantized(k)
    if q is None:
        return None
    enc, zscale, zzero, _ = q
    npix = np.array([40, 56], np.int64)
    lens = np.array([len(e) for e in enc], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.array([0, 40], np.int64)
    return _io(k, "native").rice_decode_unquantize_native(
        b"".join(enc), offs, lens, npix, out, np.array([1, 2]), 32, 4,
        zscale, zzero, 1, 1, None, 96, np.float32)


def _payload(k):
    data = np.asarray(k.inp("plain").unmasked_data[:].value, np.float32)
    path = k.out("payload.bin")
    with open(path, "wb") as f:
        f.write(data.astype(">f4").tobytes())
    return _io(k, "native").decode_payload(path, 0, data.size, -32)


def _casa_tiles(k):
    low = _io(k, "casa_low")
    d = _casa(k)
    stman = low.read_tiled_stman(os.path.join(d, "table.f0"))
    return stman


def _written_fits(k, name, write, *args):
    path = k.out(name)
    write(*args, path, overwrite=True)
    return _io(k, "fits_low").read_fits(path)


CALLS = {
    # -- io/__init__.py ----------------------------------------------------
    ("io/__init__.py", "annotations"): C(
        None, lambda _, k: str(_io(k).annotations.compiler_flag)),
    ("io/__init__.py", "BinTableHDU"): C(
        "beams", lambda b, k: _io(k).BinTableHDU(
            columns=OrderedDict(BMAJ=np.asarray(b.major.value)),
            name="BEAMS").nrows),
    ("io/__init__.py", "HDU"): C(
        None, lambda _, k: _io(k).HDU(data=np.ones((2, 3)),
                                      header=_header(k)).shape),
    ("io/__init__.py", "Header"): C(
        None, lambda _, k: _io(k).Header()),
    ("io/__init__.py", "cube_from_hdus"): C(
        None, lambda _, k: _io(k).cube_from_hdus(
            _io(k).read_fits(k.path("cube")), **k.devkw)),
    ("io/__init__.py", "is_fits"): C(
        None, lambda _, k: (_io(k).is_fits(k.path("cube")),
                            _io(k).is_fits(_casa(k)))),
    ("io/__init__.py", "load_fits_cube"): C(
        None, lambda _, k: _io(k).load_fits_cube(k.path("vrsc"),
                                                 **k.devkw)),
    ("io/__init__.py", "read_cube"): C(
        None, lambda _, k: (_io(k).read_cube(k.path("cube"), **k.devkw),
                            _io(k).read_cube(_casa(k), **k.devkw))),
    ("io/__init__.py", "read_fits"): C(
        None, lambda _, k: [h.header for h in
                            _io(k).read_fits(k.path("vrsc"))]),
    ("io/__init__.py", "read_stokes_cube"): C(
        None, lambda _, k: _io(k).read_stokes_cube(k.path("stokes"),
                                                   **k.devkw)),
    ("io/__init__.py", "write_cube"): C(
        "cube", lambda c, k: _written_fits(k, "wc.fits", _io(k).write_cube,
                                           c)[0].data),
    ("io/__init__.py", "write_fits"): C(
        None, lambda _, k: _written_hdus(k)),
    ("io/__init__.py", "write_fits_cube"): C(
        "vrsc", lambda c, k: [h.header for h in _written_fits(
            k, "wfc.fits", _io(k).write_fits_cube, c)]),
    ("io/__init__.py", "write_fits_stokes"): C(
        "stokes", lambda s, k: _written_fits(
            k, "wfs.fits", _io(k).write_fits_stokes, s)[0].data),
    ("io/__init__.py", "write_stokes_cube"): C(
        "stokes", lambda s, k: _written_fits(
            k, "wsc.fits", _io(k).write_stokes_cube, s)[0].data),
    # -- io/casa_image.py ----------------------------------------------------
    ("io/casa_image.py", "is_casa_image"): C(
        None, lambda _, k: (_io(k, "casa_image").is_casa_image(_casa(k)),
                            _io(k, "casa_image").is_casa_image(
                                k.path("cube")))),
    ("io/casa_image.py", "load_casa_image"): C(
        None, lambda _, k: _io(k, "casa_image").load_casa_image(
            _casa(k), **k.devkw)),
    # -- io/casa_low.py ------------------------------------------------------
    ("io/casa_low.py", "R2D"): C(None, lambda _, k: _io(k, "casa_low").R2D),
    ("io/casa_low.py", "TP_RECORD"): C(
        None, lambda _, k: _io(k, "casa_low").TP_RECORD),
    ("io/casa_low.py", "AipsIO"): C(
        None, lambda _, k: type(_reader(k)).__name__),
    ("io/casa_low.py", "AipsIO.u8"): C(None, lambda _, k: _reader(k).u8()),
    ("io/casa_low.py", "AipsIO.u32"): C(
        None, lambda _, k: _read_scalars(k)[1]),
    ("io/casa_low.py", "AipsIO.i32"): C(
        None, lambda _, k: _read_scalars(k)[2]),
    ("io/casa_low.py", "AipsIO.f32"): C(
        None, lambda _, k: _read_scalars(k)[3]),
    ("io/casa_low.py", "AipsIO.f64"): C(
        None, lambda _, k: _read_scalars(k)[4]),
    ("io/casa_low.py", "AipsIO.string"): C(
        None, lambda _, k: _read_scalars(k)[5]),
    ("io/casa_low.py", "AipsIO.iposition"): C(
        None, lambda _, k: _read_scalars(k)[6]),
    ("io/casa_low.py", "AipsIO.start"): C(
        None, lambda _, k: _after_scalars(k).start()),
    ("io/casa_low.py", "AipsIO.expect"): C(
        None, lambda _, k: _after_scalars(k).expect("Array<double>")),
    ("io/casa_low.py", "read_aips_array"): C(
        None, lambda _, k: _read_array(k)),
    ("io/casa_low.py", "read_recorddesc"): C(
        None, lambda _, k: _read_records(k)[0]),
    ("io/casa_low.py", "read_tablerecord"): C(
        None, lambda _, k: _read_records(k)[1]),
    ("io/casa_low.py", "read_tablerecord_like_record"): C(
        None, lambda _, k: _io(k, "casa_low").read_tablerecord_like_record(
            _tablerecord_reader(k))),
    ("io/casa_low.py", "read_table_keywords"): C(
        None, lambda _, k: sorted(_io(k, "casa_low").read_table_keywords(
            os.path.join(_casa(k), "table.dat")))),
    ("io/casa_low.py", "read_tiled_stman"): C(
        None, lambda _, k: _casa_tiles(k)),
    ("io/casa_low.py", "read_tiled_data"): C(
        None, lambda _, k: _io(k, "casa_low").read_tiled_data(_casa(k))),
    ("io/casa_low.py", "casa_coords_to_wcs"): C(
        None, lambda _, k: _io(k, "casa_low").casa_coords_to_wcs(
            _io(k, "casa_low").read_table_keywords(
                os.path.join(_casa(k), "table.dat"))["coords"], 4)),
    ("io/casa_low.py", "read_casa_image_parts"): C(
        None, lambda _, k: _io(k, "casa_low").read_casa_image_parts(
            _casa(k))[0]),
    # -- io/casa_masks.py ----------------------------------------------------
    ("io/casa_masks.py", "make_casa_mask"): C(
        "cube", lambda c, k: _casa_mask(c, k)),
    # -- io/casa_writer.py ---------------------------------------------------
    ("io/casa_writer.py", "AipsIOWriter"): C(None, lambda _, k: _stream(k)),
    ("io/casa_writer.py", "AipsIOWriter.raw"): C(
        None, lambda _, k: _wrote(k, "raw", b"\x01\x02")),
    ("io/casa_writer.py", "AipsIOWriter.u8"): C(
        None, lambda _, k: _wrote(k, "u8", 200)),
    ("io/casa_writer.py", "AipsIOWriter.u32"): C(
        None, lambda _, k: _wrote(k, "u32", 70000)),
    ("io/casa_writer.py", "AipsIOWriter.i32"): C(
        None, lambda _, k: _wrote(k, "i32", -70000)),
    ("io/casa_writer.py", "AipsIOWriter.f32"): C(
        None, lambda _, k: _wrote(k, "f32", 1.25)),
    ("io/casa_writer.py", "AipsIOWriter.f64"): C(
        None, lambda _, k: _wrote(k, "f64", -2.5e300)),
    ("io/casa_writer.py", "AipsIOWriter.string"): C(
        None, lambda _, k: _wrote(k, "string", "casa")),
    ("io/casa_writer.py", "AipsIOWriter.block"): C(
        None, lambda _, k: _block(k)),
    ("io/casa_writer.py", "AipsIOWriter.getvalue"): C(
        None, lambda _, k: _io(k, "casa_writer").AipsIOWriter().getvalue()),
    ("io/casa_writer.py", "write_aips_array"): C(
        None, lambda _, k: _read_array(k)),
    ("io/casa_writer.py", "write_recorddesc"): C(
        None, lambda _, k: _read_records(k)[0]),
    ("io/casa_writer.py", "write_tablerecord"): C(
        None, lambda _, k: _read_records(k)[1]),
    ("io/casa_writer.py", "write_casa_image"): C(
        None, lambda _, k: _io(k, "casa_image").load_casa_image(
            _casa(k), **k.devkw).unmasked_data[:]),
    # -- io/class_lmv.py -----------------------------------------------------
    ("io/class_lmv.py", "ANGULAR_CODES"): C(
        None, lambda _, k: _io(k, "class_lmv").ANGULAR_CODES),
    ("io/class_lmv.py", "BUNIT_FIXES"): C(
        None, lambda _, k: _io(k, "class_lmv").BUNIT_FIXES),
    ("io/class_lmv.py", "CEL_CODES"): C(
        None, lambda _, k: _io(k, "class_lmv").CEL_CODES),
    ("io/class_lmv.py", "CTYPE_MAP"): C(
        None, lambda _, k: _io(k, "class_lmv").CTYPE_MAP),
    ("io/class_lmv.py", "CUNIT_MAP"): C(
        None, lambda _, k: _io(k, "class_lmv").CUNIT_MAP),
    ("io/class_lmv.py", "PROJ_CODES"): C(
        None, lambda _, k: _io(k, "class_lmv").PROJ_CODES),
    ("io/class_lmv.py", "R2DEG"): C(
        None, lambda _, k: _io(k, "class_lmv").R2DEG),
    ("io/class_lmv.py", "is_lmv"): C(
        None, lambda _, k: (_io(k, "class_lmv").is_lmv(_lmv(k)),
                            _io(k, "class_lmv").is_lmv(k.path("cube")))),
    ("io/class_lmv.py", "read_lmv"): C(
        None, lambda _, k: _io(k, "class_lmv").read_lmv(_lmv(k))[0]),
    ("io/class_lmv.py", "load_lmv_cube"): C(
        None, lambda _, k: _io(k, "class_lmv").load_lmv_cube(
            _lmv(k), **k.devkw)),
    # -- io/fits.py ----------------------------------------------------------
    ("io/fits.py", "cube_from_hdus"): C(
        None, lambda _, k: _io(k, "fits").cube_from_hdus(
            _io(k).read_fits(k.path("vrsc")), **k.devkw)),
    ("io/fits.py", "load_fits_cube"): C(
        None, lambda _, k: _io(k, "fits").load_fits_cube(k.path("cube"),
                                                         **k.devkw)),
    ("io/fits.py", "write_fits_cube"): C(
        "cube", lambda c, k: _written_fits(
            k, "f.fits", _io(k, "fits").write_fits_cube, c)[0].data),
    ("io/fits.py", "write_fits_stokes"): C(
        "stokes", lambda s, k: _written_fits(
            k, "fs.fits", _io(k, "fits").write_fits_stokes, s)[0].header),
    # -- io/fits_low.py ------------------------------------------------------
    ("io/fits_low.py", "BLOCK"): C(
        None, lambda _, k: _io(k, "fits_low").BLOCK),
    ("io/fits_low.py", "CARD"): C(None, lambda _, k: _io(k, "fits_low").CARD),
    ("io/fits_low.py", "BinTableHDU"): C(
        "beams", lambda b, k: _io(k, "fits_low").BinTableHDU(
            columns=OrderedDict(BMAJ=np.asarray(b.major.value)))["BMAJ"]),
    ("io/fits_low.py", "HDU"): C(
        None, lambda _, k: _io(k, "fits_low").HDU(
            data=np.arange(6.0).reshape(2, 3))),
    ("io/fits_low.py", "Header"): C(
        None, lambda _, k: _io(k, "fits_low").Header()),
    ("io/fits_low.py", "fold_meta_into_header"): C(
        None, lambda _, k: _fold(k)),
    ("io/fits_low.py", "parse_header"): C(
        None, lambda _, k: _io(k, "fits_low").parse_header(
            _io(k, "fits_low").format_header(_header(k)))),
    ("io/fits_low.py", "format_header"): C(
        None, lambda _, k: _cards(_io(k, "fits_low").format_header(
            _header(k)))),
    ("io/fits_low.py", "is_fits"): C(
        None, lambda _, k: _io(k, "fits_low").is_fits(k.path("stokes"))),
    ("io/fits_low.py", "read_fits"): C(
        None, lambda _, k: _io(k, "fits_low").read_fits(
            k.path("cube"), memmap=False)[0]),
    ("io/fits_low.py", "write_fits"): C(
        None, lambda _, k: _written_hdus(k, compress="RICE_1")),
    ("io/fits_low.py", "Header.get"): C(
        "header", lambda h, k: (h.get("CTYPE3"), h.get("NOPE", 5))),
    ("io/fits_low.py", "Header.pop"): C(
        "header", lambda h, k: (h.copy().pop("BUNIT"),
                                h.copy().pop("NOPE", None))),
    ("io/fits_low.py", "Header.keys"): C(
        "header", lambda h, k: list(h.keys())),
    ("io/fits_low.py", "Header.items"): C(
        "header", lambda h, k: [list(i) for i in h.items()]),
    ("io/fits_low.py", "Header.update"): C(
        "header", lambda h, k: _updated(h)),
    ("io/fits_low.py", "Header.copy"): C("header", lambda h, k: h.copy()),
    ("io/fits_low.py", "Header.add_history"): C(
        "header", lambda h, k: _noted(h, "add_history")),
    ("io/fits_low.py", "Header.add_comment"): C(
        "header", lambda h, k: _noted(h, "add_comment")),
    ("io/fits_low.py", "Header.comment"): C(
        "header", lambda h, k: h.comment("CTYPE1")),
    ("io/fits_low.py", "HDU.shape"): C(
        None, lambda _, k: _io(k).read_fits(k.path("cube"))[0].shape),
    ("io/fits_low.py", "HDU.data"): C(
        None, lambda _, k: _io(k).read_fits(k.path("cube"))[0].data),
    ("io/fits_low.py", "HDU.memmap_data"): C(
        None, lambda _, k: np.array(_io(k).read_fits(
            k.path("cube"))[0].memmap_data())),
    ("io/fits_low.py", "HDU.is_image"): C(
        None, lambda _, k: [h.is_image for h in
                            _io(k).read_fits(k.path("vrsc"))]),
    ("io/fits_low.py", "BinTableHDU.is_image"): C(
        None, lambda _, k: _io(k).read_fits(k.path("vrsc"))[1].is_image),
    ("io/fits_low.py", "BinTableHDU.nrows"): C(
        None, lambda _, k: _io(k).read_fits(k.path("vrsc"))[1].nrows),
    # -- io/native.py --------------------------------------------------------
    ("io/native.py", "native_available"): C(
        None, lambda _, k: _io(k, "native").native_available()),
    ("io/native.py", "decode_payload"): C(None, lambda _, k: _payload(k)),
    ("io/native.py", "native_stats_f32"): C(
        None, lambda _, k: _io(k, "native").native_stats_f32(
            np.asarray(k.inp("plain").unmasked_data[:].value,
                       np.float32).ravel())),
    ("io/native.py", "assemble_casa_tiles"): C(
        None, lambda _, k: _assembled(k)),
    ("io/native.py", "rice_encode_tiles_native"): C(
        None, lambda _, k: _encoded(k)[0]),
    ("io/native.py", "rice_decode_tiles_native"): C(
        None, lambda _, k: _decoded(k)),
    ("io/native.py", "rice_quantize_encode_native"): C(
        None, lambda _, k: _quantized(k)),
    ("io/native.py", "rice_decode_unquantize_native"): C(
        None, lambda _, k: _unquantized(k)),
    # -- io/streaming.py -----------------------------------------------------
    ("io/streaming.py", "read_sharded_cube"): C(
        None, lambda _, k: _io(k, "streaming").read_sharded_cube(
            k.path("cube"), k.mesh()).moment0()),
    ("io/streaming.py", "read_sharded_casa"): C(
        None, lambda _, k: _io(k, "streaming").read_sharded_casa(
            _casa(k), k.mesh()).filled_data[:]),
    # -- io/tile_compress.py -------------------------------------------------
    ("io/tile_compress.py", "is_compressed_image"): C(
        None, lambda _, k: (
            _io(k, "tile_compress").is_compressed_image(_compressed(k)[0]),
            _io(k, "tile_compress").is_compressed_image(_header(k)))),
    ("io/tile_compress.py", "compressed_image_blocks"): C(
        None, lambda _, k: _compressed(k)),
    ("io/tile_compress.py", "decompress_image_hdu"): C(
        None, lambda _, k: _io(k, "tile_compress").decompress_image_hdu(
            *_compressed(k))),
    ("io/tile_compress.py", "rice_encode"): C(
        None, lambda _, k: _io(k, "tile_compress").rice_encode(
            _tiles(k)[0])),
    ("io/tile_compress.py", "rice_decode"): C(
        None, lambda _, k: _io(k, "tile_compress").rice_decode(
            _io(k, "tile_compress").rice_encode(_tiles(k)[0]),
            len(_tiles(k)[0]))),
}


def _tablerecord_reader(k):
    w = _io(k, "casa_writer").AipsIOWriter()
    _io(k, "casa_writer").write_tablerecord(w, RECORD)
    return _io(k, "casa_low").AipsIO(w.getvalue())


def _block(k):
    w = _io(k, "casa_writer").AipsIOWriter()
    with w.block("Thing", 3):
        w.u32(11)
    return w.getvalue()


def _casa_mask(c, k):
    d = k.out("masked.image")
    _io(k, "casa_writer").write_casa_image(c, d, overwrite=True)
    _io(k, "casa_masks").make_casa_mask(c, k.out("snr"), img=d,
                                        append_to_image=True)
    return _io(k, "casa_image").load_casa_image(d, **k.devkw).mask.include()


def _written_hdus(k, compress=None):
    fl = _io(k, "fits_low")
    path = k.out(f"w_{compress}.fits")
    data = np.asarray(k.inp("plain").unmasked_data[:].value, np.float32)
    fl.write_fits(path, [fl.HDU(data=data, header=_header(k))],
                  compress=compress)
    return fl.read_fits(path)[0].data


def _cards(block):
    """A header block's cards but the HISTORY card that names the package
    that wrote it."""
    return [block[i:i + 80] for i in range(0, len(block), 80)
            if not block[i:i + 80].startswith(b"HISTORY Written by")]


def _fold(k):
    h = _io(k, "fits_low").Header()
    _io(k, "fits_low").fold_meta_into_header(
        h, {"OBJECT": "N1", "a_long_key": 3, "BUNIT": "K"})
    return h


def _updated(h):
    h = h.copy()
    h.update({"OBJECT": "N2", "CRVAL3": 1.0})
    return h


def _noted(h, name):
    h = h.copy()
    getattr(h, name)("a note")
    return [list(i) for i in h.items()]


def _assembled(k):
    """Two 4 x 4 x 3 tiles of a little-endian float32 array, scattered."""
    tile = (3, 4, 4)
    payload = np.arange(96, dtype="<f4").tobytes()
    return _io(k, "native").assemble_casa_tiles(
        payload, (8, 4, 3), tile, "f4", big_endian=False)


NOT_CALLED = {}

DEVICE_RESULTS = {}

#: members that answer by design where the JAX package raises, with the
#: reason
PORT_ANSWERS = {}

tp.define_tests(globals())
