"""Torch port, the streaming sharded readers and the sharded pipeline
against the JAX package.

``io.streaming.read_sharded_cube`` (FITS) and ``read_sharded_casa`` on the
port's mesh of eight CPU positions and the JAX package's 8-device CPU mesh:
values read exactly (bit for bit against ``SpectralCube.read``, mask and
metadata included), each position holding its own block, and no host read
or decode buffer larger than one block (the reader's byte record, in place
of a host-memory trace).  ``run_pipeline(cmesh=...)`` on a streamed cube
against the unsharded chain and the JAX sharded pipeline at the JAX test's
tolerances (tests/test_parallel.py:770-785), its mesh counters for each
route; and ``persistence.load_cube(cmesh=...)`` restoring a store shard
by shard.
"""

import os
import shutil

import numpy as np
import jax
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu import parallel as jpar
from spectral_cube_tpu import persistence as jper
from spectral_cube_tpu.io import streaming as jstream
from spectral_cube_tpu.pipeline import run_pipeline as j_run_pipeline

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch import persistence as tper
from spectral_cube_tpu_torch.io import streaming as tstream

from conftest import (HDU, base_header, make_cube_file,
                      make_vr_cube_file, write_fits)

pytestmark = pytest.mark.filterwarnings("ignore::Warning")


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) != 8:
        pytest.skip("multi-device tests need the 8-device virtual mesh")
    return jpar.CubeMesh()


@pytest.fixture
def tmesh():
    return tpar.CubeMesh(devices=["cpu"] * 8)


def _np(x):
    if isinstance(x, (T.Quantity, J.Quantity)):
        x = x.value
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _bits_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _assert_block_bound(sc, read_bytes=None):
    """The read held at most one block at once: the float32 block plus
    its read buffer, ``read_bytes`` (default: the block in the float64
    these tests' FITS files hold), and less than the whole cube where a
    block is less than the cube."""
    biggest = max(int(np.prod(s.data.shape))
                  for s in sc._data.addressable_shards)
    read_bytes = biggest * 8 if read_bytes is None else read_bytes
    assert tstream.HOST_BUFFERS["block_bytes"] == biggest * 4
    assert tstream.HOST_BUFFERS["held_bytes"] <= biggest * 4 + read_bytes
    if biggest < int(np.prod(sc.shape)):
        assert tstream.HOST_BUFFERS["held_bytes"] \
            < int(np.prod(sc.shape)) * 4


def test_streaming_loaders_mesh_unaligned(tmp_path, tmesh, jmesh):
    """The streaming FITS/CASA readers replicate the axes the mesh does
    not divide (the placement ``shard`` gives) and read values exactly."""
    p, _ = make_cube_file(tmp_path, name="odd.fits", shape=(5, 9, 11),
                          seed=3)
    cube = T.SpectralCube.read(p, device="cpu")
    out = tstream.read_sharded_cube(p, tmesh)
    _assert_block_bound(out)
    idx = tmesh.compatible_sharding("spatial", (5, 9, 11)).indices(
        (5, 9, 11))
    assert out._data.index == idx
    _bits_equal(out.cube.unmasked_data[:], cube.unmasked_data[:])
    jout = jstream.read_sharded_cube(p, jmesh)
    np.testing.assert_array_equal(_np(out.cube.unmasked_data[:]),
                                  np.asarray(jout.unmasked_data[:]))
    cube.write(str(tmp_path / "odd.image"), format="casa")
    out2 = tstream.read_sharded_casa(str(tmp_path / "odd.image"), tmesh)
    back = T.SpectralCube.read(str(tmp_path / "odd.image"), device="cpu")
    _bits_equal(out2.cube.unmasked_data[:], back.unmasked_data[:])
    np.testing.assert_allclose(_np(out2.cube.unmasked_data[:]),
                               _np(cube.unmasked_data[:]), rtol=1e-6)
    jout2 = jstream.read_sharded_casa(str(tmp_path / "odd.image"), jmesh)
    np.testing.assert_array_equal(_np(out2.cube.unmasked_data[:]),
                                  np.asarray(jout2.unmasked_data[:]))


def test_streaming_reader_keeps_each_block_on_its_position(tmp_path,
                                                           tmesh, jmesh):
    """On an aligned cube each position holds exactly its (y, x) tile,
    the JAX array's shard at the same mesh position, and no host buffer
    was larger than that tile."""
    shape = (12, 16, 24)
    p, _ = make_cube_file(tmp_path, name="al.fits", shape=shape, seed=2)
    out = tstream.read_sharded_cube(p, tmesh)
    _assert_block_bound(out)
    jout = jstream.read_sharded_cube(p, jmesh, dtype=np.float32)
    my, mx = tmesh.grid
    jblocks = {}
    for sh in jout._data.addressable_shards:
        pos = np.argwhere(jmesh.mesh.devices.ravel() == sh.device)[0, 0]
        jblocks[divmod(int(pos), mx)] = np.asarray(sh.data)
    for sh in out._data.addressable_shards:
        assert sh.data.shape == (12, 8, 6)
        np.testing.assert_array_equal(sh.data.numpy(),
                                      jblocks[tuple(sh.position)])
    spec = tstream.read_sharded_cube(p, tmesh, layout="spectral")
    assert spec._data.layout == "spectral"
    assert [tuple(s.data.shape) for s in spec._data.addressable_shards] \
        == [(12, 16, 24)] * 8    # 12 channels do not divide 8: replicated
    _bits_equal(spec.cube.unmasked_data[:], out.cube.unmasked_data[:])


def test_streaming_casa_mask_and_metadata_bit_for_bit(tmp_path, tmesh):
    """A tiled CASA image with an appended mask and a beam: data, mask,
    beam, unit and WCS as ``SpectralCube.read`` gives them; the mask is
    read block by block like the data."""
    from spectral_cube_tpu_torch.io.casa_masks import make_casa_mask
    p, data = make_cube_file(tmp_path, name="m.fits", shape=(6, 10, 14),
                             seed=4)
    cube = T.SpectralCube.read(p, device="cpu")
    img = str(tmp_path / "m.image")
    cube.write(img, format="casa")
    shutil.rmtree(os.path.join(img, "mask0"))
    masked = cube.with_mask(cube > T.Quantity(0.5, cube.unit))
    make_casa_mask(masked, str(tmp_path / "m_mask" / "newmask"),
                   append_to_image=True, img=img)
    want = T.SpectralCube.read(img, device="cpu")
    got = tstream.read_sharded_casa(img, tmesh)
    assert got._include is not None
    _bits_equal(got.cube.unmasked_data[:], want.unmasked_data[:])
    np.testing.assert_array_equal(got.cube.get_mask_array(),
                                  want.get_mask_array())
    np.testing.assert_array_equal(got.cube.get_mask_array(),
                                  np.isfinite(data) & (data > 0.5))
    assert got.beam == want.beam and str(got.unit) == str(want.unit)
    assert got.wcs.check_equality(want.wcs, wcs_tolerance=0.0)
    assert got.meta == want.meta
    np.testing.assert_allclose(got.moment_maps()[0].value,
                               want.moment0().value, rtol=1e-6)
    # a multi-tile layout reads each block from its own tiles
    tiled = str(tmp_path / "t.image")
    cube.write(tiled, format="casa")
    T.io.casa_writer.write_casa_image(cube, tiled, overwrite=True,
                                      tile_shape=(5, 4, 1, 4))
    got = tstream.read_sharded_casa(tiled, tmesh)
    _assert_block_bound(got, read_bytes=5 * 4 * 4 * 4)
    _bits_equal(got.cube.unmasked_data[:],
                T.SpectralCube.read(tiled, device="cpu").unmasked_data[:])


def test_streaming_scaled_integer_file(tmp_path, tmesh, jmesh):
    """An int16 file with BSCALE/BZERO: each block scaled in float64 on
    the host, bit for bit the JAX sharded reader (whose plain read, like
    the port's, scales in float32: the two reads agree to float32
    rounding), and the host held at most a block in float64 and its
    float32 copy at once."""
    rng = np.random.RandomState(7)
    data = rng.randint(-3000, 3000, size=(6, 8, 12)).astype(np.int16)
    h = base_header(nx=12, ny=8, nchan=6)
    h["BSCALE"], h["BZERO"] = 0.37, 11.0
    p = str(tmp_path / "i16.fits")
    write_fits(p, [HDU(data=data, header=h)])
    got = tstream.read_sharded_cube(p, tmesh)
    _assert_block_bound(got, read_bytes=max(
        int(np.prod(s.data.shape)) for s in got._data.addressable_shards)
        * 8)
    jgot = jstream.read_sharded_cube(p, jmesh, dtype=np.float32)
    _bits_equal(got.cube.unmasked_data[:], np.asarray(jgot._data))
    _bits_equal(got.cube.unmasked_data[:],
                (data * 0.37 + 11.0).astype(np.float32))
    np.testing.assert_allclose(
        _np(got.cube.unmasked_data[:]),
        _np(T.SpectralCube.read(p, device="cpu").unmasked_data[:]),
        rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("fmt", ["fits", "casa"])
def test_streaming_readers_upload_each_block_before_the_next(
        tmp_path, tmesh, monkeypatch, fmt):
    """Each block goes to its device before the next is read: the host
    never holds two decoded blocks (JAX ``device_put`` in the loop,
    spectral_cube_tpu/io/streaming.py:135, :245)."""
    p, _ = make_cube_file(tmp_path, name="e.fits", shape=(4, 16, 24),
                          seed=6)
    if fmt == "casa":
        from spectral_cube_tpu_torch.io.casa_writer import write_casa_image
        img = str(tmp_path / "e.image")
        write_casa_image(T.SpectralCube.read(p, device="cpu"), img,
                         tile_shape=(8, 8, 1, 2))
        p = img
    events = []
    held, upload = tstream._held, tstream._upload
    monkeypatch.setattr(tstream, "_held", lambda *a: (
        events.append("read"), held(*a))[1])
    monkeypatch.setattr(tstream, "_upload", lambda *a: (
        events.append("upload"), upload(*a))[1])
    read = tstream.read_sharded_cube if fmt == "fits" \
        else tstream.read_sharded_casa
    out = read(p, tmesh)
    # a CASA image streams its mask after its data
    streams = 2 if fmt == "casa" and out._include is not None else 1
    assert events.count("upload") == streams * tmesh.n_devices
    # between two uploads the reads of one block only: never two uploads
    # owed at once
    runs = "".join("u" if e == "upload" else "r" for e in events)
    assert runs.startswith("r") and runs.endswith("u")
    assert "uu" not in runs and all(run for run in runs.split("u")[:-1])
    assert len(out._data.addressable_shards) == tmesh.n_devices


def test_streaming_vrsc_keeps_its_beams(tmp_path, tmesh):
    p, _ = make_vr_cube_file(tmp_path, shape=(6, 8, 8))
    got = tstream.read_sharded_cube(p, tmesh)
    want = T.SpectralCube.read(p, device="cpu")
    assert type(got.cube).__name__ == "VaryingResolutionSpectralCube"
    assert got.common_beam() == want.common_beam()
    assert len(got.beams) == 6
    _bits_equal(got.cube.unmasked_data[:], want.unmasked_data[:])


def test_streaming_pipeline_tb_scale_analog(tmp_path, tmesh, jmesh):
    """The TB-scale story at a reduced scale (reference analog:
    tests/test_performance.py:128-241): a FITS cube streamed shard by
    shard into the sharded pipeline on the 8-position mesh, held against
    the single-device chain and the JAX sharded pipeline; each position
    holds exactly its (y, x) tile, and the read held no more than one
    tile's read and decode buffers at once.  A 40" beam on 2" pixels has a 34-pixel halo, wider than the
    24-pixel x tiles: the convolution takes the reshard + FFT route."""
    shape = (48, 80, 96)
    p, _ = make_cube_file(tmp_path, name="tb.fits", shape=shape, seed=5)
    sharded = tstream.read_sharded_cube(p, tmesh, dtype=np.float32)
    _assert_block_bound(sharded)
    # an eighth of the float64 file and of the float32 cube
    assert tstream.HOST_BUFFERS["held_bytes"] \
        <= int(np.prod(shape)) * (8 + 4) // 8
    shards = sharded._data.addressable_shards
    assert len(shards) == 8
    assert all(tuple(s.data.shape) == (48, 40, 24) for s in shards)
    assert len({(s.index[1].start, s.index[2].start) for s in shards}) == 8

    beam = T.Beam(T.Quantity(40.0, "arcsec"), T.Quantity(40.0, "arcsec"),
                  0.0)
    noise = T.Quantity(0.28, sharded.unit)
    tmesh.reset_counters()
    res = T.run_pipeline(sharded, tmesh, snr_threshold=1.0,
                         target_beam=beam, noise_estimate=noise)
    assert tmesh.counters["all_to_alls"] == 4
    assert tmesh.counters["gathers"] == 0

    cube = T.SpectralCube.read(p, device="cpu").with_fill_value(np.nan)
    conv = cube.convolve_to(beam)
    masked = conv.with_mask(conv > T.Quantity(float(noise.value),
                                              conv.unit))
    m0 = masked.moment0().value
    m1 = masked.moment1().value
    lw = masked.linewidth_sigma().value
    st = masked.statistics()

    jsh = jstream.read_sharded_cube(p, jmesh, dtype=np.float32)
    jbeam = J.Beam(J.Quantity(40.0, "arcsec"), J.Quantity(40.0, "arcsec"),
                   0.0)
    jres = j_run_pipeline(jsh, jmesh, snr_threshold=1.0, target_beam=jbeam,
                          noise_estimate=J.Quantity(0.28, jsh.unit))

    for want in ((m0, m1, lw, st),
                 tuple(_np(x.value) for x in jres["moments"])
                 + (jres["statistics"],)):
        m0s, m1s, lws = (_np(x.value) for x in res["moments"])
        np.testing.assert_allclose(m0s, _np(want[0]), rtol=3e-5, atol=1e-6)
        fin = np.isfinite(_np(want[1]))
        assert np.array_equal(np.isfinite(m1s), fin)
        np.testing.assert_allclose(m1s[fin], _np(want[1])[fin], rtol=3e-5,
                                   atol=1e-4)
        finw = np.isfinite(_np(want[2]))
        assert np.array_equal(np.isfinite(lws), finw)
        np.testing.assert_allclose(lws[finw], _np(want[2])[finw],
                                   rtol=1e-4, atol=1e-4)
        sts = res["statistics"]
        for key in ("npts", "mean", "sigma", "sum", "max", "min"):
            np.testing.assert_allclose(float(sts[key]), float(want[3][key]),
                                       rtol=2e-5, atol=1e-7)


def _shift(header, dx=0.37, dy=-0.61):
    h = header.copy() if hasattr(header, "copy") else header
    h["CRPIX1"] = float(h["CRPIX1"]) + dx
    h["CRPIX2"] = float(h["CRPIX2"]) + dy
    return h


def _rotate(header, deg=3.0):
    h = header
    t = np.deg2rad(deg)
    h["PC1_1"], h["PC1_2"] = np.cos(t), -np.sin(t)
    h["PC2_1"], h["PC2_2"] = np.sin(t), np.cos(t)
    return h


@pytest.mark.parametrize("route", ["halo", "reshard"])
def test_run_pipeline_cmesh_matches_unsharded(tmp_path, tmesh, jmesh,
                                              route):
    """``run_pipeline(cmesh=)`` on a streamed cube (the card's phase
    sharded at a small size): an elliptical beam of rank 5 convolves with
    halo exchanges (one beam group separates to rank 8, the unsharded
    route's rule) and a CRPIX-shifted target reprojects with halos, with
    no all-to-all and no gather; a beam to a grid rotated by 3 degrees
    reshards in the reprojection.  Moments, linewidth, statistics (the
    noise from the sharded mad_std) and the reprojected cube agree with
    the unsharded run and the JAX sharded pipeline, NaN patterns equal."""
    rng = np.random.RandomState(7)
    shape = (20, 32, 40)
    data = rng.randn(*shape) * 0.1 + 1.5 * np.exp(-0.5 * ((np.arange(
        shape[0]) - 10) / 2.0) ** 2)[:, None, None]
    data[:, :2, :] = np.nan
    from spectral_cube_tpu.io.fits_low import HDU, write_fits
    from conftest import base_header
    h = base_header(nx=shape[2], ny=shape[1], nchan=shape[0])
    h["BMAJ"], h["BMIN"], h["BPA"] = 6.0 / 3600, 4.5 / 3600, 30.0
    h["CDELT1"], h["CDELT2"] = -2.0 / 3600, 2.0 / 3600
    p = str(tmp_path / "pipe.fits")
    write_fits(p, [HDU(data=data, header=h)])
    cube = T.SpectralCube.read(p, device="cpu")
    target = _shift(cube.header) if route == "halo" \
        else _rotate(cube.header)
    beam = T.Beam(T.Quantity(12.0, "arcsec"), T.Quantity(12.0, "arcsec"),
                  0.0)
    sharded = tstream.read_sharded_cube(p, tmesh)
    tmesh.reset_counters()
    res = T.run_pipeline(sharded, tmesh, snr_threshold=3.0,
                         target_beam=beam, target_header=target)
    if route == "halo":
        assert tmesh.counters["halo_exchanges"] > 0
        assert tmesh.counters["all_to_alls"] == 0
    else:
        assert tmesh.counters["all_to_alls"] > 0
    assert tmesh.counters["gathers"] == 0
    ref = T.run_pipeline(cube, snr_threshold=3.0, target_beam=beam,
                         target_header=target)
    jcube = jstream.read_sharded_cube(p, jmesh, dtype=np.float32)
    jtarget = _shift(jcube.header) if route == "halo" \
        else _rotate(jcube.header)
    jres = j_run_pipeline(jcube, jmesh, snr_threshold=3.0,
                          target_beam=J.Beam(J.Quantity(12.0, "arcsec"),
                                             J.Quantity(12.0, "arcsec"),
                                             0.0),
                          target_header=jtarget)
    for want in (ref, jres):
        for i, (a, b) in enumerate(zip(res["moments"], want["moments"])):
            a, b = _np(a.value), _np(b.value)
            fin = np.isfinite(b)
            assert np.array_equal(np.isfinite(a), fin)
            tol = [(3e-5, 1e-6), (3e-5, 1e-4), (1e-4, 1e-4)][i]
            np.testing.assert_allclose(a[fin], b[fin], rtol=tol[0],
                                       atol=tol[1])
        for key in ("npts", "mean", "sigma", "sum", "max", "min"):
            np.testing.assert_allclose(float(res["statistics"][key].value
                                             if key != "npts" else
                                             res["statistics"][key]),
                                       float(want["statistics"][key].value
                                             if key != "npts" else
                                             want["statistics"][key]),
                                       rtol=2e-5, atol=1e-7)
        got = _np(res["cube"].cube.unmasked_data[:])
        exp = _np(want["cube"].unmasked_data[:])
        assert np.array_equal(np.isnan(got), np.isnan(exp))
        fin = np.isfinite(exp)
        np.testing.assert_allclose(got[fin], exp[fin], rtol=1e-5, atol=1e-6)


def test_load_cube_onto_a_mesh(tmp_path, tmesh, jmesh):
    """``load_cube(cmesh=)``: a JAX store sharded over the 2 x 4 mesh
    restores shard by shard (each position loads its own file); a store
    of one array is sharded after loading; both equal the data."""
    path, data = make_cube_file(tmp_path, shape=(8, 16, 16))
    jcube = jstream.read_sharded_cube(path, jmesh)
    store = str(tmp_path / "sharded")
    jper.save_cube(jcube, store)
    got = tper.load_cube(store, cmesh=tmesh)
    assert isinstance(got, tpar.ShardedCube)
    assert got._data.layout == "spatial"
    assert [tuple(s.data.shape) for s in got._data.addressable_shards] \
        == [(8, 8, 4)] * 8
    assert tmesh.counters["gathers"] == 0
    np.testing.assert_array_equal(_np(got.cube.unmasked_data[:]),
                                  np.asarray(jcube.unmasked_data[:]))
    np.testing.assert_array_equal(got.cube.get_mask_array(),
                                  np.isfinite(data))
    plain = str(tmp_path / "plain")
    tper.save_cube(T.SpectralCube.read(path, device="cpu"), plain)
    got = tper.load_cube(plain, cmesh=tmesh)
    np.testing.assert_array_equal(_np(got.cube.unmasked_data[:]),
                                  data.astype(np.float32))
    assert got.beam == T.SpectralCube.read(path, device="cpu").beam
