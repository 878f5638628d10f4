"""A sharded cube's store and a streamed cube's mask: faults F14 and F15
and their repairs.

- F14: ``persistence.save_cube`` of a ``ShardedCube`` gathered the whole
  cube to the host and wrote one ``data.npy``; the JAX package writes one
  ``shard_<n>.npy`` per distinct shard with its index in ``meta.json``
  and no ``data.npy``, so the whole cube never lands on the host
  (``tests/test_aux.py``'s ``test_sharded_checkpoint_restore`` and
  ``test_replicated_layout_saves_each_shard_once``).  ``checkpoint`` and
  ``save_to_tmp_dir=True`` go through it.
- F15: a cube of ``io.streaming.read_sharded_casa`` (and of
  ``read_sharded_cube``) answered ``mask.include()`` with "LazyMask has no
  bound data"; the JAX streamed cube answers with its mask over the
  streamed data (``tests/test_casa.py``'s ``test_streaming_casa_loader``).

Each case runs on the CPU and, marked ``cuda``, on the card, on the default
``CubeMesh()`` of 8 positions of the case's device (``use_mesh``), under
``numpy_guard``; the tests named ``*_matches_jax`` hold the same calls
against the JAX package's 8-device CPU mesh.
"""

import json
import os

import numpy as np
import pytest
import torch

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import persistence as tper
from spectral_cube_tpu_torch.io import streaming as tstream
from spectral_cube_tpu_torch.io.casa_writer import write_casa_image
from spectral_cube_tpu_torch.parallel import CubeMesh, ShardedCube

from test_torch_fixtures_ref import (DEVICES, make_cube_file, numpy_guard,
                                     use_device, use_mesh)

pytestmark = pytest.mark.filterwarnings("ignore::Warning")


@pytest.fixture(scope="module", autouse=True)
def _port_converts_explicitly():
    with numpy_guard():
        yield


@pytest.fixture(params=DEVICES)
def device(request, monkeypatch):
    dev = use_device(request.param, monkeypatch)
    use_mesh(dev, monkeypatch)
    return dev


def _jax_mesh():
    jax = pytest.importorskip("jax")
    if len(jax.devices()) != 8:
        pytest.skip("needs the JAX package's 8-device virtual CPU mesh")
    from spectral_cube_tpu.parallel import CubeMesh as JMesh
    return JMesh()


def _host(x):
    if isinstance(x, T.Quantity):
        x = x.value
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _store(store):
    """A store's files and its ``meta.json``."""
    with open(os.path.join(store, "meta.json")) as f:
        return sorted(os.listdir(store)), json.load(f)


def _blocks_by_index(store, meta):
    """index (start, stop, step triples) -> the shard file's array."""
    return {tuple(map(tuple, e["index"])): np.load(os.path.join(
        store, e["file"])) for e in meta["shards"]}


def _record_saves(monkeypatch):
    """The shapes of the arrays ``persistence`` hands ``np.save``."""
    shapes = []
    save = np.save

    def recording(path, arr, *args, **kwargs):
        shapes.append(tuple(np.shape(arr)))
        return save(path, arr, *args, **kwargs)

    monkeypatch.setattr(tper.np, "save", recording)
    return shapes


def _masked_sharded(tmp_path, shape=(8, 16, 16)):
    """A sharded cube of a FITS file under a comparison mask, and the file's
    data."""
    path, data = make_cube_file(tmp_path, shape=shape)
    cube = T.SpectralCube.read(path)
    sc = ShardedCube(cube.with_mask(cube > T.Quantity(0.5, cube.unit)))
    return sc, data.astype(np.float32)


def test_f14_sharded_save_writes_each_block(tmp_path, device, monkeypatch):
    sc, data = _masked_sharded(tmp_path)
    cmesh = sc.cmesh
    assert cmesh.grid == (2, 4)
    cmesh.reset_counters()
    shapes = _record_saves(monkeypatch)
    store = tper.save_cube(sc, str(tmp_path / "store"))
    files, meta = _store(store)
    assert "data.npy" not in files
    assert files == sorted([f"shard_{i}.npy" for i in range(8)]
                           + ["meta.json"])
    assert meta["sharded"] and meta["shape"] == [8, 16, 16]
    # each block reached the host alone, and nothing gathered the cube
    assert shapes == [(8, 8, 4)] * 8
    assert cmesh.counters["gathers"] == 0
    want = np.where(np.isfinite(data) & (data > 0.5), data, np.nan)
    for index, block in _blocks_by_index(store, meta).items():
        np.testing.assert_array_equal(
            block, want[tuple(slice(*k) for k in index)])
    # restored block by block, bit for bit, each on its position
    back = tper.load_cube(store, cmesh=cmesh)
    assert isinstance(back, ShardedCube) and back._data.layout == "spatial"
    assert cmesh.counters["gathers"] == 0
    filled = sc._filled()
    for got, orig in zip(back._data.addressable_shards,
                         filled.addressable_shards):
        assert got.index == orig.index and got.position == orig.position
        assert got.data.device.type == device.type
        assert torch.equal(got.data.isnan(), orig.data.isnan())
        assert torch.equal(got.data.nan_to_num(), orig.data.nan_to_num())
    np.testing.assert_array_equal(back.cube.get_mask_array(),
                                  np.isfinite(want))
    # without the mask, the raw data
    raw = tper.save_cube(sc, str(tmp_path / "raw"), include_mask=False)
    back = tper.load_cube(raw, cmesh=cmesh)
    np.testing.assert_array_equal(_host(back.cube.unmasked_data[:]), data)


def test_f14_replicated_layout_saves_each_block_once(tmp_path, device):
    path, data = make_cube_file(tmp_path, shape=(4, 8, 8), with_nan=False)
    cube = T.SpectralCube.read(path)
    rep = ShardedCube(cube).rechunk("replicated")
    cmesh = rep.cmesh
    assert len({tuple((s.start, s.stop) for s in ix)
                for ix in rep._data.index}) == 1
    store = tper.save_cube(rep, str(tmp_path / "rep"))
    files, meta = _store(store)
    assert [f for f in files if f.startswith("shard_")] == ["shard_0.npy"]
    assert meta["shards"] == [{"index": [[0, 4, 1], [0, 8, 1], [0, 8, 1]],
                               "file": "shard_0.npy"}]
    back = tper.load_cube(store, cmesh=cmesh)
    np.testing.assert_array_equal(_host(back.cube.unmasked_data[:]),
                                  data.astype(np.float32))


def test_f14_checkpoint_and_save_to_tmp_dir_gather_nothing(tmp_path,
                                                           device):
    sc, data = _masked_sharded(tmp_path, shape=(6, 10, 12))
    cmesh = sc.cmesh
    want = np.where(np.isfinite(data) & (data > 0.5), data, np.nan)
    kern = np.array([0.25, 0.5, 0.25])
    cmesh.reset_counters()
    results = {"checkpoint": sc.checkpoint(),
               "rechunk": sc.rechunk("spectral", save_to_tmp_dir=True),
               "spectral_smooth": sc.spectral_smooth(kern,
                                                     save_to_tmp_dir=True)}
    assert cmesh.counters["gathers"] == 0
    assert results["rechunk"]._data.layout == "spectral"
    smoothed = np.asarray(sc.spectral_smooth(kern)._filled())
    for name, out in results.items():
        assert isinstance(out, ShardedCube), name
        np.testing.assert_array_equal(
            np.asarray(out._filled()),
            smoothed if name == "spectral_smooth" else want, err_msg=name)


def test_f14_matches_jax(tmp_path, monkeypatch):
    jmesh = _jax_mesh()
    from spectral_cube_tpu import persistence as jper
    from spectral_cube_tpu.io import streaming as jstream
    use_device("cpu", monkeypatch)
    use_mesh(torch.device("cpu"), monkeypatch)
    path, data = make_cube_file(tmp_path, shape=(8, 16, 16))
    sc = tstream.read_sharded_cube(path, CubeMesh())
    jc = jstream.read_sharded_cube(path, jmesh)
    mine = tper.save_cube(sc, str(tmp_path / "port"))
    theirs = jper.save_cube(jc, str(tmp_path / "jax"))
    (files, meta), (jfiles, jmeta) = _store(mine), _store(theirs)
    assert files == jfiles and "data.npy" not in files
    assert {k: v for k, v in meta.items() if k != "shards"} == \
        {k: v for k, v in jmeta.items() if k != "shards"}
    got, want = _blocks_by_index(mine, meta), _blocks_by_index(theirs, jmeta)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # each package restores the other's store shard by shard
    cross = tper.load_cube(theirs, cmesh=CubeMesh())
    np.testing.assert_array_equal(_host(cross.cube.unmasked_data[:]),
                                  np.asarray(jc.unmasked_data[:].value))
    jback = jper.load_cube(mine, cmesh=jmesh)
    assert len(jback._data.sharding.device_set) == jmesh.n_devices
    np.testing.assert_array_equal(np.asarray(jback.unmasked_data[:].value),
                                  np.asarray(jc.unmasked_data[:].value))


def _casa_image(tmp_path):
    """``tests/test_casa.py``'s streamed image: the (8, 16, 16) cube with
    one NaN, written as CASA in (8, 4, 1, 4) tiles with its mask."""
    path, data = make_cube_file(tmp_path, shape=(8, 16, 16))
    cube = T.SpectralCube.read(path)
    out = str(tmp_path / "stream.image")
    write_casa_image(cube, out, tile_shape=(8, 4, 1, 4))
    return out, path, data


def test_f15_streamed_cubes_answer_include(tmp_path, device):
    image, path, data = _casa_image(tmp_path)
    cmesh = CubeMesh()
    eager = T.SpectralCube.read(image)
    for streamed in (tstream.read_sharded_casa(image, cmesh),
                     tstream.read_sharded_cube(path, cmesh)):
        inc = streamed.mask.include()
        assert isinstance(inc, torch.Tensor)
        # a public include() of no tensor data is a host tensor (F34)
        assert inc.device.type == "cpu"
        np.testing.assert_array_equal(_host(inc),
                                      _host(eager.mask.include()))
        np.testing.assert_array_equal(_host(inc), np.isfinite(data))
        np.testing.assert_array_equal(
            _host(streamed.mask.exclude(view=(slice(1, 3), 1))),
            ~np.isfinite(data[1:3, 1]))
        # a comparison's mask on the streamed cube, and the cube's calls
        # that evaluate its mask on the gathered cube
        cmp = streamed.with_mask(streamed > T.Quantity(0.5, streamed.unit))
        np.testing.assert_array_equal(
            _host(cmp.mask.include()), np.isfinite(data) & (data > 0.5))
        np.testing.assert_array_equal(
            cmp.get_mask_array(), np.isfinite(data) & (data > 0.5))


def test_f15_matches_jax(tmp_path, monkeypatch):
    jmesh = _jax_mesh()
    from spectral_cube_tpu.io import streaming as jstream
    use_device("cpu", monkeypatch)
    use_mesh(torch.device("cpu"), monkeypatch)
    image, path, _ = _casa_image(tmp_path)
    for reader in ("read_sharded_casa", "read_sharded_cube"):
        src = image if reader == "read_sharded_casa" else path
        mine = getattr(tstream, reader)(src, CubeMesh())
        theirs = getattr(jstream, reader)(src, jmesh)
        np.testing.assert_array_equal(_host(mine.mask.include()),
                                      np.asarray(theirs.mask.include()),
                                      err_msg=reader)
