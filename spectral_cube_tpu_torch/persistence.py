"""Cube stores: a cube saved to a directory and loaded back, and the
``save_to_tmp_dir`` checkpoint.

Port of ``spectral_cube_tpu/persistence.py`` (the reference materializes
dask graphs into temporary zarr stores, dask_spectral_cube.py:85-116).  The
on-disk format is the JAX package's: ``meta.json`` (shape, dtype, unit,
fill value, WCS cards, class, beam or per-channel beams) beside the data,
either one ``data.npy`` or, for a store written from a sharded JAX cube,
one ``shard_<n>.npy`` per distinct shard with its index in ``meta.json``.
A store written by either package loads in the other, which is how a
cube's state crosses between them on disk.  The port writes ``data.npy``
for a cube, and for a :class:`~.parallel.ShardedCube` the JAX package's
sharded store, each block copied to the host alone; a sharded store loads
into one tensor on the requested device (assembled on the host), or with
``cmesh`` shard by shard onto the mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import weakref

import numpy as np
import torch

__all__ = ["save_cube", "load_cube", "checkpoint_to_tmp_dir"]

_FORMAT_VERSION = 1


def _meta_for(cube):
    """The ``meta.json`` of a cube (persistence.py:28-52)."""
    fill = cube._fill_value
    meta = {
        "version": _FORMAT_VERSION,
        "shape": list(cube.shape),
        "dtype": str(np.dtype(cube.dtype)),
        "unit": cube.unit.to_string(),
        "fill_value": None if fill is None or
        (isinstance(fill, float) and np.isnan(fill)) else float(fill),
        "wcs": {k: v for k, v in cube._wcs.to_header().items()},
        "class": type(cube).__name__,
    }
    beams = getattr(cube, "_beams", None)
    if beams is not None:
        meta["beams"] = {
            "major_deg": [b.major.to_value("deg") for b in beams],
            "minor_deg": [b.minor.to_value("deg") for b in beams],
            "pa_deg": [b.pa.to_value("deg") for b in beams],
        }
        meta["goodbeams"] = [bool(g) for g in cube.goodbeams_mask]
    else:
        beam = getattr(cube, "_beam", None)
        if beam is not None:
            meta["beam"] = beam.to_header_keywords()
    return meta


def save_cube(cube, store_dir, include_mask=True):
    """Write a cube's data and metadata to ``store_dir``.  With
    ``include_mask`` the data is written mask-filled with NaN, so the
    loaded cube's ``LazyMask(isfinite)`` gives the same mask; without it
    the raw data.  A :class:`~.parallel.ShardedCube` writes one
    ``shard_<n>.npy`` per distinct block of its data (``n`` the block's
    mesh position; a replicated layout's copies once), each block masked
    on its device and copied to the host alone, with its index in
    ``meta.json`` and no ``data.npy`` (persistence.py:57-95 of the JAX
    package).  Returns ``store_dir``."""
    from .parallel.sharded import ShardedCube
    os.makedirs(store_dir, exist_ok=True)
    if isinstance(cube, ShardedCube):
        meta = _meta_for(cube._template)
        meta["sharded"] = True
        meta["shards"] = []
        data = cube._filled(np.nan) if include_mask else cube._data
        seen = set()
        for i, (block, ix) in enumerate(zip(data.blocks, data.index)):
            key = tuple((s.start, s.stop, 1) for s in ix)
            if key in seen:
                continue
            seen.add(key)
            name = f"shard_{i}.npy"
            np.save(os.path.join(store_dir, name), block.cpu().numpy())
            meta["shards"].append({"index": [list(k) for k in key],
                                   "file": name})
    else:
        data = cube._get_filled_data(fill=np.nan) if include_mask \
            else cube._data
        meta = _meta_for(cube)
        meta["sharded"] = False
        np.save(os.path.join(store_dir, "data.npy"), data.cpu().numpy())
    with open(os.path.join(store_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return store_dir


def _assemble_shards(store_dir, meta):
    """The whole array of a sharded store, on the host: its ``data.npy``
    where one exists, else each shard file written into its index."""
    full = os.path.join(store_dir, "data.npy")
    if os.path.exists(full):
        return np.load(full)
    out = np.empty(tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]))
    for i, entry in enumerate(meta["shards"]):
        index = tuple(slice(*(int(v) for v in sl)) for sl in entry["index"])
        out[index] = np.load(os.path.join(
            store_dir, entry.get("file", f"shard_{i}.npy")))
    return out


def _load_shards(store_dir, meta, cmesh):
    """A sharded store's data on ``cmesh``: where the mesh's spatial,
    spectral or replicated placement matches the saved shards, each
    position loads its own shard file onto its device (no host-global
    array, persistence.py:99-134 of the JAX package); else the array is
    assembled on the host and sharded."""
    from .parallel.mesh import ShardedArray
    shape = tuple(meta["shape"])
    saved = {}
    for i, entry in enumerate(meta["shards"]):
        key = tuple(tuple(int(v) for v in sl)[:2] for sl in entry["index"])
        saved[key] = os.path.join(store_dir,
                                  entry.get("file", f"shard_{i}.npy"))
    sizes = dict(zip(cmesh.axis_names, cmesh.grid))
    for layout in ("spatial", "spectral", "replicated"):
        sharding = cmesh.sharding(layout)
        if any(n % np.prod([sizes[a] for a in np.atleast_1d(e)])
               for n, e in zip(shape, sharding.spec) if e is not None):
            continue
        index = sharding.indices(shape)
        keys = [tuple((s.start, s.stop) for s in ix) for ix in index]
        if all(k in saved for k in keys):
            blocks = [torch.from_numpy(_native(np.load(saved[k]))).to(dev)
                      for k, dev in zip(keys, cmesh.devices)]
            return ShardedArray(cmesh, layout, shape, blocks, index)
    return cmesh.shard(_native(_assemble_shards(store_dir, meta)), "spatial")


def _native(arr):
    """A loaded array as the cube entry points store it (float64 becomes
    float32)."""
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def load_cube(store_dir, device=None, cmesh=None):
    """The cube of a store written by :func:`save_cube` (of either
    package), on ``device``: the CUDA device unless the caller asks for
    another.  With ``cmesh`` the cube is a
    :class:`~.parallel.ShardedCube` on that mesh, a sharded store's shards
    each loaded onto its own device where the placements match."""
    from .wcs import WCS
    from .cube import (SpectralCube, VaryingResolutionSpectralCube,
                       _as_tensor)
    from .beams import Beam, Beams
    from .units import Quantity, Unit
    from .masks import LazyMask

    with open(os.path.join(store_dir, "meta.json")) as f:
        meta = json.load(f)
    wcs = WCS(header=meta["wcs"])
    unit = Unit.parse(meta["unit"])
    fill_value = meta.get("fill_value")
    fill_value = np.nan if fill_value is None else float(fill_value)
    sharded = None
    if cmesh is not None:
        from .parallel.sharded import _placeholder
        sharded = _load_shards(store_dir, meta, cmesh) \
            if meta.get("sharded") else cmesh.shard(_native(np.load(
                os.path.join(store_dir, "data.npy"))), "spatial")
        data = _placeholder(sharded.shape, sharded.dtype, cmesh.devices[0])
    elif meta.get("sharded"):
        data = _as_tensor(_assemble_shards(store_dir, meta), device)
    else:
        data = _as_tensor(np.load(os.path.join(store_dir, "data.npy")),
                          device)
    mask = LazyMask(torch.isfinite, data=data, wcs=wcs)
    if "beams" in meta:
        beams = Beams(major=Quantity(np.array(meta["beams"]["major_deg"]),
                                     "deg"),
                      minor=Quantity(np.array(meta["beams"]["minor_deg"]),
                                     "deg"),
                      pa=Quantity(np.array(meta["beams"]["pa_deg"]), "deg"))
        cube = VaryingResolutionSpectralCube(
            data, wcs, mask=mask, unit=unit, beams=beams,
            fill_value=fill_value,
            goodbeams_mask=np.array(meta.get("goodbeams"), dtype=bool))
    else:
        beam = Beam.from_header(meta["beam"]) if "beam" in meta else None
        cube = SpectralCube(data, wcs, mask=mask, unit=unit, beam=beam,
                            fill_value=fill_value)
    if sharded is None:
        return cube
    from .parallel.sharded import ShardedCube
    return ShardedCube._from_parts(cmesh, sharded, cube, LazyMask(
        torch.isfinite, wcs=wcs, shape=sharded.shape))


def checkpoint_to_tmp_dir(cube, tmp_dir=None):
    """Write the cube's current (masked) state to a temporary store and
    load it back on the cube's device (a ShardedCube: block by block onto
    its mesh); the store lives as long as the returned cube (the
    reference's ``save_to_tmp_dir=True``, dask_spectral_cube.py:85-116)."""
    from .parallel.sharded import ShardedCube
    store = tempfile.mkdtemp(suffix=".cube_store", dir=tmp_dir)
    save_cube(cube, store)
    if isinstance(cube, ShardedCube):
        new = load_cube(store, cmesh=cube.cmesh)
    else:
        new = load_cube(store, device=cube.device)
    weakref.finalize(new, shutil.rmtree, store, True)
    return new
