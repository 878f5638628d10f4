"""Torch port, the cube helpers and the cube store against the JAX
package: ``mosaic_cubes`` (the two offset cubes of test_regrid.py:205-233
and the split cube of :607-636), ``combine_headers``, the beam helpers
(``largest_beam``, ``smallest_beam``, ``try_load_beam(s)`` on headers and
a BEAMS HDU list, ``beams_to_bintable``, ``beam_props``),
``iterator_strategy``, and ``persistence``: a store written by either
package loads in the other bitwise (data, mask, WCS cards, beams), and a
sharded JAX store is assembled into one tensor on one device.

Tolerances: headers, beams, stores and masks equal; mosaics within the
JAX mosaic test's own 1e-3 of the input and atol 5e-6 of the JAX mosaic
after equal NaN patterns.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu import cube_utils as jcu
from spectral_cube_tpu import persistence as jper
from spectral_cube_tpu.io.fits_low import HDU, write_fits, read_fits

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import cube_utils as tcu
from spectral_cube_tpu_torch import persistence as tper
from spectral_cube_tpu_torch.io.fits_low import read_fits as t_read_fits

from conftest import base_header, make_cube_file, make_vr_cube_file
from test_torch_slicing import read_both, write_cube, assert_cube_equal


def _read(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (T.SpectralCube.read(path, device="cpu"),
                J.SpectralCube.read(path))


def _assert_mosaic_equal(t, j):
    assert type(t).__name__ == type(j).__name__ == "SpectralCube"
    assert t.shape == j.shape
    a, b = t.unitless_filled_data[:], np.asarray(j.filled_data[:].value)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(b)
    np.testing.assert_allclose(a[fin], b[fin], atol=5e-6)
    np.testing.assert_array_equal(t.get_mask_array(),
                                  np.asarray(j.get_mask_array()))
    assert t.wcs.to_header() == j.wcs.to_header()
    assert t.unit.to_string() == j.unit.to_string()


def _offset_pair(tmp_path):
    """test_regrid.py:205-233's two cubes, the second 8 pixels east."""
    p1, _ = make_cube_file(tmp_path, "m1.fits", shape=(2, 12, 12),
                           with_nan=False)
    h2 = base_header(nx=12, ny=12, nchan=2)
    t1, j1 = _read(p1)
    h2["CRVAL1"] = j1.header["CRVAL1"] + 8 * abs(j1.header["CDELT1"])
    p2 = str(tmp_path / "m2.fits")
    write_fits(p2, [HDU(data=np.random.RandomState(1).rand(2, 12, 12),
                        header=h2)])
    t2, j2 = _read(p2)
    return (t1, t2), (j1, j2)


@pytest.mark.parametrize("order", ["bilinear", "nearest-neighbor",
                                   "bicubic"])
def test_mosaic_of_two_offset_cubes_matches_jax(tmp_path, order):
    (t1, t2), (j1, j2) = _offset_pair(tmp_path)
    th = tcu.combine_headers(t1.header, t2.header)
    jh = jcu.combine_headers(j1.header, j2.header)
    assert dict(th.items()) == dict(jh.items())
    t = tcu.mosaic_cubes([t1, t2], order=order)
    j = jcu.mosaic_cubes([j1, j2], order=order)
    assert t.device == t1.device
    _assert_mosaic_equal(t, j)
    assert np.isfinite(t.unitless_filled_data[:]).sum() > 2 * 12 * 12


def test_mosaic_reassembles_a_split_cube(tmp_path):
    """test_regrid.py:607-636: two overlapping parts give the original
    grid and values; disjoint parts leave a NaN row."""
    path, data = make_cube_file(tmp_path, shape=(2, 5, 5), with_nan=False)
    tc, jc = _read(path)
    hdr = tcu.combine_headers(tc[:, :4, :].header, tc[:, 2:, :].header)
    assert (hdr["NAXIS1"], hdr["NAXIS2"]) == (5, 5)
    for order in ("nearest-neighbor", "bilinear"):
        t = tcu.mosaic_cubes([tc[:, :4, :], tc[:, 2:, :]], order=order)
        j = jcu.mosaic_cubes([jc[:, :4, :], jc[:, 2:, :]], order=order)
        _assert_mosaic_equal(t, j)
        assert t.shape == tc.shape
        np.testing.assert_almost_equal(t.unitless_filled_data[:],
                                       tc.unitless_filled_data[:], decimal=3)
    t = tcu.mosaic_cubes([tc[:, :2, :], tc[:, 3:, :]],
                         order="nearest-neighbor")
    j = jcu.mosaic_cubes([jc[:, :2, :], jc[:, 3:, :]],
                         order="nearest-neighbor")
    _assert_mosaic_equal(t, j)
    v = t.unitless_filled_data[:]
    np.testing.assert_almost_equal(v[:, :2, :], data[:, :2, :], decimal=3)
    assert np.isnan(v[:, 2, :]).all()


def test_mosaic_onto_a_given_header(tmp_path):
    (t1, t2), (j1, j2) = _offset_pair(tmp_path)
    target = t1.header
    _assert_mosaic_equal(tcu.mosaic_cubes([t1, t2], target_header=target),
                         jcu.mosaic_cubes([j1, j2], target_header=j1.header))
    with pytest.raises(ValueError):
        tcu.mosaic_cubes([])


def test_combine_headers_of_shifted_and_finer_grids():
    h1 = base_header(nx=20, ny=16, nchan=3)
    h2 = base_header(nx=10, ny=30, nchan=3)
    h2["CRVAL2"] = h1["CRVAL2"] - 12 * h1["CDELT2"]
    h2["CDELT1"] = h1["CDELT1"] / 2
    th = tcu.combine_headers(h1, h2)
    jh = jcu.combine_headers(h1, h2)
    assert dict(th.items()) == dict(jh.items())


def test_beam_helpers_match_jax(tmp_path):
    path, _ = make_vr_cube_file(tmp_path, shape=(5, 3, 2),
                                major_arcsec=[1.0, 2.0, 1.5, 0.5, 3.0])
    tc, jc = _read(path)
    tb, jb = tc.unmasked_beams, jc.unmasked_beams
    for name in ("largest_beam", "smallest_beam"):
        t = getattr(tcu, name)(tb)
        j = getattr(jcu, name)(jb)
        assert (t.major_rad, t.minor_rad) == (j.major_rad, j.minor_rad)
        mask = np.array([True, True, True, False, False])
        t = getattr(tcu, name)(list(tb), mask)
        j = getattr(jcu, name)(list(jb), mask)
        assert (t.major_rad, t.minor_rad) == (j.major_rad, j.minor_rad)
    for t, j in zip(tcu.beam_props(tb, [True, False, True, True, False]),
                    jcu.beam_props(jb, [True, False, True, True, False])):
        np.testing.assert_array_equal(t.value, j.value)
        assert t.unit.to_string() == j.unit.to_string()
    tt, jt = tcu.beams_to_bintable(tb), jcu.beams_to_bintable(jb)
    assert tt.columns.keys() == jt.columns.keys()
    for k in jt.columns:
        np.testing.assert_array_equal(tt.columns[k], jt.columns[k])
    assert tt.header["NCHAN"] == jt.header["NCHAN"] == 5


class _AstropyTable:
    """A BEAMS table as an astropy HDU presents it: header and ``data``
    (the form the JAX function reads; its own BinTableHDU has no
    ``data``)."""

    def __init__(self, table):
        self.header, self.data = table.header, table.columns


def test_try_load_beams_reads_headers_hdus_and_beam_tables(tmp_path):
    vr, _ = make_vr_cube_file(tmp_path, shape=(4, 3, 2))
    single, _ = make_cube_file(tmp_path)
    thdus, jhdus = t_read_fits(vr), read_fits(vr)
    j = jcu.try_load_beams([jhdus[0], _AstropyTable(jhdus[1])])
    for hdus in (thdus, [thdus[0], _AstropyTable(thdus[1])]):
        t = tcu.try_load_beams(hdus)
        assert type(t).__name__ == type(j).__name__ == "Beams"
        np.testing.assert_array_equal(t.major.value, j.major.value)
        np.testing.assert_array_equal(t.pa.value, j.pa.value)
    th, jh = t_read_fits(single)[0], read_fits(single)[0]
    for tt, jj in ((tcu.try_load_beams(th), jcu.try_load_beams(jh)),
                   (tcu.try_load_beams(th.header),
                    jcu.try_load_beams(jh.header)),
                   (tcu.try_load_beams([th]), jcu.try_load_beams([jh])),
                   (tcu.try_load_beam(th.header),
                    jcu.try_load_beam(jh.header))):
        assert type(tt).__name__ == type(jj).__name__ == "Beam"
        assert (tt.major_rad, tt.pa_rad) == (jj.major_rad, jj.pa_rad)
    nobeam = base_header(beam=False)
    assert tcu.try_load_beams(nobeam) is None is jcu.try_load_beams(nobeam)
    bad = base_header()
    bad["BMAJ"] = "garbage"
    assert tcu.try_load_beam(bad) is None is jcu.try_load_beam(bad)


def test_iterator_strategy():
    class Big:
        size = 10 ** 9

    class Small:
        size = 10

    for c in (Big, Small):
        assert tcu.iterator_strategy(c) == jcu.iterator_strategy(c)


# -- persistence --------------------------------------------------------------

def _assert_store_cube_equal(t, j):
    """Data, mask, WCS cards, unit, fill value and beams bitwise equal."""
    assert_cube_equal(t, j)
    assert t._fill_value == j._fill_value or (
        np.isnan(t._fill_value) and np.isnan(j._fill_value))
    if hasattr(j, "unmasked_beams"):
        for a, b in zip(t.unmasked_beams, j.unmasked_beams):
            assert (a.major_rad, a.minor_rad, a.pa_rad) == \
                (b.major_rad, b.minor_rad, b.pa_rad)
        np.testing.assert_array_equal(t.goodbeams_mask, j.goodbeams_mask)
    else:
        assert t.beam.major_rad == j.beam.major_rad
        assert t.beam.pa_rad == j.beam.pa_rad


def _stored_pairs(tmp_path):
    path, _ = write_cube(tmp_path)
    tc, jc = read_both(path)
    yield (tc.with_mask(tc > T.Quantity(0.6, "Jy/beam")),
           jc.with_mask(jc > J.Quantity(0.6, "Jy/beam")))
    vr, _ = make_vr_cube_file(tmp_path, shape=(4, 3, 2))
    yield read_both(vr)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stores_cross_between_the_packages(tmp_path, writer):
    for i, (tc, jc) in enumerate(_stored_pairs(tmp_path)):
        store = str(tmp_path / f"store{i}")
        if writer == "jax":
            jper.save_cube(jc, store)
            t = tper.load_cube(store, device="cpu")
            j = jper.load_cube(store)
        else:
            tper.save_cube(tc, store)
            j = jper.load_cube(store)
            t = tper.load_cube(store, device="cpu")
        assert sorted(os.listdir(store)) == ["data.npy", "meta.json"]
        _assert_store_cube_equal(t, j)
        np.testing.assert_array_equal(t.get_mask_array(),
                                      tc.get_mask_array())


def test_store_keeps_a_fill_value_and_raw_data(tmp_path):
    path, data = write_cube(tmp_path)
    tc, jc = read_both(path)
    tm = tc.with_mask(tc > T.Quantity(0.6, "Jy/beam")).with_fill_value(-1.0)
    jm = jc.with_mask(jc > J.Quantity(0.6, "Jy/beam")).with_fill_value(-1.0)
    for name, cube in (("t", tm), ("j", jm)):
        store = str(tmp_path / name)
        (tper if name == "t" else jper).save_cube(cube, store,
                                                  include_mask=False)
        with open(os.path.join(store, "meta.json")) as f:
            meta = f.read()
        back = tper.load_cube(store, device="cpu")
        assert back._fill_value == -1.0
        np.testing.assert_array_equal(back._data.numpy(),
                                      data.astype(np.float32))
    with open(os.path.join(str(tmp_path / "t"), "meta.json")) as f:
        assert f.read() == meta


def test_sharded_jax_store_assembles_on_one_device(tmp_path):
    """A store written from a JAX cube sharded over the CPU mesh (one
    ``shard_<n>.npy`` a device, no ``data.npy``) loads into one tensor."""
    from spectral_cube_tpu.io.streaming import read_sharded_cube
    from spectral_cube_tpu.parallel import CubeMesh
    path, data = make_cube_file(tmp_path, shape=(8, 16, 16))
    cmesh = CubeMesh()
    assert cmesh.n_devices >= 2
    cube = read_sharded_cube(path, cmesh)
    store = str(tmp_path / "sharded")
    jper.save_cube(cube, store)
    files = os.listdir(store)
    assert "data.npy" not in files
    assert sum(f.startswith("shard_") for f in files) == cmesh.n_devices
    t = tper.load_cube(store, device="cpu")
    assert t._data.device == torch.device("cpu")
    np.testing.assert_array_equal(t._data.numpy(), np.asarray(cube._data))
    np.testing.assert_array_equal(t.get_mask_array(),
                                  np.isfinite(data))
    # onto a port mesh of the same grid: shard by shard, no assembly
    tmesh = T.CubeMesh(devices=["cpu"] * cmesh.n_devices,
                       shape=tuple(cmesh.grid))
    onto = tper.load_cube(store, cmesh=tmesh)
    assert isinstance(onto, T.ShardedCube) and tmesh.counters["gathers"] == 0
    np.testing.assert_array_equal(onto.cube._data.numpy(),
                                  np.asarray(cube._data))
