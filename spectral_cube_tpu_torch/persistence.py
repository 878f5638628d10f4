"""Cube stores: a cube saved to a directory and loaded back, and the
``save_to_tmp_dir`` checkpoint.

Port of ``spectral_cube_tpu/persistence.py`` (the reference materializes
dask graphs into temporary zarr stores, dask_spectral_cube.py:85-116).  The
on-disk format is the JAX package's: ``meta.json`` (shape, dtype, unit,
fill value, WCS cards, class, beam or per-channel beams) beside the data,
either one ``data.npy`` or, for a store written from a sharded JAX cube,
one ``shard_<n>.npy`` per distinct shard with its index in ``meta.json``.
A store written by either package loads in the other, which is how a
cube's state crosses between them on disk.  The port writes ``data.npy``;
a sharded store is assembled on the host into one tensor on the requested
device.
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


def _numpy_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _meta_for(cube):
    """The ``meta.json`` of a cube (persistence.py:28-52)."""
    fill = cube._fill_value
    meta = {
        "version": _FORMAT_VERSION,
        "shape": list(cube.shape),
        "dtype": str(_numpy_dtype(cube.dtype)),
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
    the raw data.  Returns ``store_dir``."""
    os.makedirs(store_dir, exist_ok=True)
    data = cube._get_filled_data(fill=np.nan) if include_mask else cube._data
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


def load_cube(store_dir, device=None, cmesh=None):
    """The cube of a store written by :func:`save_cube` (of either
    package), on ``device``: the CUDA device unless the caller asks for
    another.  ``cmesh`` (a device mesh to restore shards onto) belongs to
    the port's sharded cubes, which are not ported."""
    if cmesh is not None:
        raise NotImplementedError(
            "restoring a store onto a device mesh needs the sharded cube, "
            "which is not ported to torch yet (ROADMAP.md Queue 1 item 12)")
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
    if meta.get("sharded"):
        arr = _assemble_shards(store_dir, meta)
    else:
        arr = np.load(os.path.join(store_dir, "data.npy"))
    data = _as_tensor(arr, device)
    mask = LazyMask(torch.isfinite, data=data, wcs=wcs)
    if "beams" in meta:
        beams = Beams(major=Quantity(np.array(meta["beams"]["major_deg"]),
                                     "deg"),
                      minor=Quantity(np.array(meta["beams"]["minor_deg"]),
                                     "deg"),
                      pa=Quantity(np.array(meta["beams"]["pa_deg"]), "deg"))
        return VaryingResolutionSpectralCube(
            data, wcs, mask=mask, unit=unit, beams=beams,
            fill_value=fill_value,
            goodbeams_mask=np.array(meta.get("goodbeams"), dtype=bool))
    beam = Beam.from_header(meta["beam"]) if "beam" in meta else None
    return SpectralCube(data, wcs, mask=mask, unit=unit, beam=beam,
                        fill_value=fill_value)


def checkpoint_to_tmp_dir(cube, tmp_dir=None):
    """Write the cube's current (masked) state to a temporary store and
    load it back on the cube's device; the store lives as long as the
    returned cube (the reference's ``save_to_tmp_dir=True``,
    dask_spectral_cube.py:85-116)."""
    store = tempfile.mkdtemp(suffix=".cube_store", dir=tmp_dir)
    save_cube(cube, store)
    new = load_cube(store, device=cube.device)
    weakref.finalize(new, shutil.rmtree, store, True)
    return new
