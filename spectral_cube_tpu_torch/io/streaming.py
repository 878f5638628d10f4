"""Streaming sharded readers: a FITS file or a CASA image straight onto a
device mesh, the whole cube never assembled on the host.

Port of ``spectral_cube_tpu/io/streaming.py`` (the reference's lazy chunk
adapters, dask_spectral_cube.py:205-254): each mesh position decodes only
its own block of the file and uploads it to its device.  Blocks follow
``CubeMesh.compatible_sharding``: an axis that the mesh does not divide is
whole on every position (replicated), and the sharded operations pad to
aligned tiles themselves.

Each block goes to its device as soon as it is decoded, so the host holds
one block's buffers at a time.  ``HOST_BUFFERS`` records the most host
bytes a reader held at once (the block's read and decode buffers), so
that a caller can check the bound.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from .fits_low import read_fits
from .fits import _find_image_hdu, _find_beam_table
from ..cube_utils import orient
from ..wcs import WCS

__all__ = ["read_sharded_cube", "read_sharded_casa", "HOST_BUFFERS"]

#: ``{"held_bytes": the most host bytes the last read held at once (its
#: read and decode buffers; a memmap view of the file counts as a read
#: buffer), "block_bytes": the largest block of that read in the cube's
#: type}``
HOST_BUFFERS = {"held_bytes": 0, "block_bytes": 0}

_BITPIX = {("u", 1): 8, ("i", 2): 16, ("i", 4): 32, ("i", 8): 64,
           ("f", 4): -32, ("f", 8): -64}


def _held(*arrays):
    """Record the host buffers ``arrays`` as held at once."""
    HOST_BUFFERS["held_bytes"] = max(HOST_BUFFERS["held_bytes"],
                                     sum(int(a.nbytes) for a in arrays))


def _start(shape, index, dtype):
    HOST_BUFFERS["held_bytes"] = 0
    HOST_BUFFERS["block_bytes"] = max(
        int(np.prod([s.stop - s.start for s in ix])) for ix in index) \
        * np.dtype(dtype).itemsize


def _upload(tile, dev):
    """One decoded host block onto its device."""
    return torch.from_numpy(tile).to(dev)


def _sharded(cmesh, shards, shape, layout, index):
    from ..parallel.mesh import ShardedArray
    return ShardedArray(cmesh, layout, shape, shards, index)


def _sharded_cube(cmesh, data, template_cls, wcs, include=None, **kwargs):
    """A ShardedCube over ``data`` with a finiteness mask (and the stored
    ``include``), its metadata cube of ``template_cls``."""
    from ..parallel.sharded import ShardedCube, _placeholder
    from ..masks import LazyMask
    template = template_cls(_placeholder(data.shape, data.dtype,
                                         cmesh.devices[0]), wcs, **kwargs)
    return ShardedCube._from_parts(
        cmesh, data, template,
        LazyMask(torch.isfinite, wcs=wcs, shape=data.shape), include)


def read_sharded_cube(path, cmesh, hdu=0, layout="spatial", dtype=None):
    """Read a 3-D FITS cube onto ``cmesh`` shard by shard; returns a
    :class:`~..parallel.sharded.ShardedCube` (a varying-resolution one's
    metadata with its BEAMS table).

    Each position's block is cut from the file's memmap in the file's
    axis order (only those pages are read), converted to native byte
    order and scaled block by block, and uploaded to its device.  A block
    of whole planes in the file's own order decodes in one call of the
    native decoder.  The data is float32 (as ``SpectralCube.read`` stores
    a float64 file) unless ``dtype`` is given."""
    from ..cube import SpectralCube, VaryingResolutionSpectralCube
    from ..cube import _beams_from_bintable

    hdus = read_fits(path)
    ihdu = _find_image_hdu(hdus, hdu)
    header = ihdu.header
    if int(header.get("NAXIS", 0)) != 3:
        raise ValueError("read_sharded_cube supports 3-D cubes")
    wcs = WCS(header=header)
    raw = ihdu.memmap_data()          # big-endian, file axis order
    # orientation without copying: the memmap view transposed
    view, out_wcs = orient(raw, wcs)
    path0, offset, fdtype, fshape, bscale, bzero = ihdu._lazy
    dtype = np.dtype(np.float32 if dtype is None else dtype)
    shape = tuple(view.shape)
    index = cmesh.compatible_sharding(layout, shape).indices(shape)
    _start(shape, index, dtype)
    bitpix = _BITPIX.get((fdtype.kind, fdtype.itemsize))
    shards = []
    for ix, dev in zip(index, cmesh.devices):
        (z0, z1), rest = (ix[0].start, ix[0].stop), ix[1:]
        whole = all(s.start == 0 and s.stop == n
                    for s, n in zip(rest, shape[1:]))
        if view is raw and whole and bitpix is not None \
                and dtype in (np.float32, np.float64):
            # whole planes in file order: one fused read + byteswap +
            # scale in the native decoder
            from .native import decode_payload
            plane = shape[1] * shape[2]
            tile = decode_payload(
                path0, offset + z0 * plane * fdtype.itemsize,
                (z1 - z0) * plane, bitpix, bscale, bzero,
                out_dtype=dtype).reshape(z1 - z0, shape[1], shape[2])
            _held(tile)
        elif bscale == 1.0 and bzero == 0.0:
            part = view[ix]                  # reads only this block
            # byte order and type in one pass into the block
            tile = np.empty(part.shape, dtype)
            tile[...] = part
            _held(part, tile)
            del part
        else:
            part = view[ix]
            native = part.astype(part.dtype.newbyteorder("="))
            _held(part, native)
            del part
            scaled = native * bscale
            _held(native, scaled)
            del native
            scaled += bzero
            tile = np.ascontiguousarray(scaled, dtype=dtype)
            _held(scaled, tile)
            del scaled
        shards.append(_upload(tile, dev))
        del tile
    data = _sharded(cmesh, shards, shape, layout, index)
    meta = {}
    if "BUNIT" in header:
        meta["BUNIT"] = str(header["BUNIT"]).strip()
    beam_table = _find_beam_table(hdus)
    if beam_table is not None:
        return _sharded_cube(cmesh, data, VaryingResolutionSpectralCube,
                             out_wcs, meta=meta, header=header,
                             beams=_beams_from_bintable(beam_table))
    return _sharded_cube(cmesh, data, SpectralCube, out_wcs, meta=meta,
                         header=header)


def _unflatten(flat, ntiles):
    """Fortran-order tile-grid index from the flat tile number."""
    idx = []
    for n in ntiles:
        idx.append(flat % n)
        flat //= n
    return idx


def _tile_indices(spans, ntiles):
    """Flat (Fortran-order) tile numbers covering the per-dimension
    [lo, hi) tile ranges."""
    strides = []
    acc = 1
    for n in ntiles:
        strides.append(acc)
        acc *= n
    ranges = [range(lo, hi) for lo, hi in spans]
    for combo in itertools.product(*reversed(ranges)):
        yield sum(c * s for c, s in zip(combo[::-1], strides))


def read_sharded_casa(image_dir, cmesh, layout="spatial", dtype=None):
    """Read a CASA ``.image`` directory onto ``cmesh`` shard by shard;
    returns a :class:`~..parallel.sharded.ShardedCube`.  Each position
    reads only the storage-manager tiles that meet its block (CASA images
    are tiled on disk), and its bit-packed mask the same way.  3-D and
    single-Stokes 4-D images with the axes (lon, lat[, stokes], spec);
    the metadata (WCS, unit, beam, the mask's name) is
    ``SpectralCube.read``'s."""
    from ..cube import SpectralCube, VaryingResolutionSpectralCube
    from ..beams import Beams
    from .casa_low import (read_table_keywords, read_tiled_stman,
                           casa_image_info, TP_FLOAT, TP_DOUBLE, TP_INT,
                           TP_BOOL)

    _, endian = read_table_keywords(os.path.join(image_dir, "table.dat"),
                                    return_endian=True)
    dt_code, casa_shape, tile_shape = read_tiled_stman(
        os.path.join(image_dir, "table.f0"))
    casa_shape, tile_shape = list(casa_shape), list(tile_shape)
    if len(casa_shape) == 4 and casa_shape[2] != 1:
        raise ValueError("read_sharded_casa supports single-Stokes images")
    if len(casa_shape) not in (3, 4):
        raise ValueError("read_sharded_casa supports 3-D and 4-D images")
    wcs, maskname, unit, beams, misc = casa_image_info(image_dir,
                                                       len(casa_shape))
    kinds = list(wcs.axis_kinds)
    if kinds != ["lon", "lat", "spectral"][:2] + (
            ["stokes"] if len(casa_shape) == 4 else []) + ["spectral"]:
        raise ValueError("read_sharded_casa reads images with the axes "
                         "(lon, lat[, stokes], spec)")
    zi = len(casa_shape) - 1
    shape = (casa_shape[zi], casa_shape[1], casa_shape[0])
    # the WCS as SpectralCube.read makes it (split_stokes, then orient)
    _, wcs3 = orient(np.broadcast_to(np.float32(0), shape),
                     wcs.dropaxis(2) if zi == 3 else wcs)
    if dtype is None:
        dtype = np.float64 if dt_code == TP_DOUBLE else np.float32
    index = cmesh.compatible_sharding(layout, shape).indices(shape)
    _start(shape, index, dtype)
    np_tile = tile_shape[::-1]
    tz, ty, tx = np_tile[0], np_tile[-2], np_tile[-1]
    ntiles = [-(-c // t) for c, t in zip(casa_shape, tile_shape)]
    tile_elems = int(np.prod(tile_shape))

    def stream(path, code, out_dt):
        elem = {TP_FLOAT: 4, TP_DOUBLE: 8, TP_INT: 4}.get(code)
        if elem is None and code != TP_BOOL:
            raise ValueError(
                f"unsupported CASA tile dtype code {code} for sharded "
                "reading (float/double/int/bool images are supported)")
        tile_bytes = (tile_elems + 7) // 8 if code == TP_BOOL \
            else tile_elems * elem
        shards = []
        with open(path, "rb") as f:
            for ix, dev in zip(index, cmesh.devices):
                (z0, z1), (y0, y1), (x0, x1) = ((s.start, s.stop)
                                                for s in ix)
                local = np.empty((z1 - z0, y1 - y0, x1 - x0), dtype=out_dt)
                # cube axis -> casa axis: x -> 0, y -> 1, spec -> last
                spans = [(0, n) for n in ntiles]
                spans[0] = (x0 // tile_shape[0], -(-x1 // tile_shape[0]))
                spans[1] = (y0 // tile_shape[1], -(-y1 // tile_shape[1]))
                spans[zi] = (z0 // tile_shape[zi], -(-z1 // tile_shape[zi]))
                for flat in _tile_indices(spans, ntiles):
                    f.seek(flat * tile_bytes)
                    raw = f.read(tile_bytes)
                    if code == TP_BOOL:
                        bits = np.frombuffer(raw, "u1")
                        tile = np.unpackbits(bits,
                                             bitorder="little")[:tile_elems]
                        _held(local, bits, tile)
                    else:
                        dt = np.dtype(endian + {TP_FLOAT: "f4",
                                                TP_DOUBLE: "f8",
                                                TP_INT: "i4"}[code])
                        tile = np.frombuffer(raw, dt)
                        _held(local, tile)
                    t3 = tile.reshape(tz, ty, tx)
                    cidx = _unflatten(flat, ntiles)
                    oz = cidx[zi] * tile_shape[zi]
                    oy = cidx[1] * tile_shape[1]
                    ox = cidx[0] * tile_shape[0]
                    sz = slice(max(z0, oz), min(z1, oz + tz))
                    sy = slice(max(y0, oy), min(y1, oy + ty))
                    sx = slice(max(x0, ox), min(x1, ox + tx))
                    if sz.start >= sz.stop or sy.start >= sy.stop \
                            or sx.start >= sx.stop:
                        continue
                    local[sz.start - z0:sz.stop - z0,
                          sy.start - y0:sy.stop - y0,
                          sx.start - x0:sx.stop - x0] = \
                        t3[sz.start - oz:sz.stop - oz,
                           sy.start - oy:sy.stop - oy,
                           sx.start - ox:sx.stop - ox]
                shards.append(_upload(local, dev))
                del local
        return _sharded(cmesh, shards, shape, layout, index)

    data = stream(os.path.join(image_dir, "table.f0_TSM0"), dt_code, dtype)
    include = None
    if maskname:
        mdir = os.path.join(image_dir, maskname)
        _, mshape, mtile = read_tiled_stman(os.path.join(mdir, "table.f0"))
        if list(mshape) != casa_shape or list(mtile) != tile_shape:
            raise ValueError(f"the mask {maskname} is tiled unlike the "
                             "image")
        include = stream(os.path.join(mdir, "table.f0_TSM0"), TP_BOOL,
                         bool)
    meta = {"filename": str(image_dir)}
    meta.update(misc)
    if unit:
        meta["BUNIT"] = unit
    if isinstance(beams, list):
        beams = beams[0]
    if isinstance(beams, Beams):
        return _sharded_cube(cmesh, data, VaryingResolutionSpectralCube,
                             wcs3, include=include, meta=meta, beams=beams)
    return _sharded_cube(cmesh, data, SpectralCube, wcs3, include=include,
                         meta=meta, beam=beams)
