"""Torch port, StokesSpectralCube against the JAX package: construction
and its checks, the common mask, ``transform_basis`` in both directions,
the delegated cuts and ``with_spectral_unit``, 4-D FITS read and write,
and a JAX Stokes cube crossing through ``interop.cube_from_arrays``.

Mirrors ``tests/test_stokes.py`` by name.  Component data, masks and WCS
cards are bitwise equal to the JAX package's (the transforms are the same
float32 operations in the same order); a feed -> sky -> feed round trip
returns half the input (the reference's normalization) within 1e-6.
"""

import warnings

import numpy as np
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu.io.fits_low import HDU, write_fits

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.interop import cube_from_arrays
from spectral_cube_tpu_torch.utils import StokesWarning

from conftest import base_header, make_cube_file
from test_torch_slicing import assert_cube_equal

SHAPE = (4, 5, 6)


def _components(tmp_path, names, nan=False):
    tcubes, jcubes = {}, {}
    for i, name in enumerate(names):
        path, _ = make_cube_file(tmp_path, f"{name}.fits", shape=SHAPE,
                                 seed=i, with_nan=nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tcubes[name] = T.SpectralCube.read(path, device="cpu")
            jcubes[name] = J.SpectralCube.read(path)
    return tcubes, jcubes


@pytest.fixture
def iquv(tmp_path):
    tcubes, jcubes = _components(tmp_path, "IQUV", nan=True)
    return (T.StokesSpectralCube(tcubes), J.StokesSpectralCube(jcubes),
            tcubes, jcubes)


def assert_stokes_equal(t, j):
    assert isinstance(t, T.StokesSpectralCube)
    assert t.components == j.components
    assert t.shape == j.shape and t.stokes_type == j.stokes_type
    for k in t.components:
        assert_cube_equal(t[k], j[k])


def test_construction_and_access(iquv):
    ts, js, tcubes, _ = iquv
    assert_stokes_equal(ts, js)
    assert ts.stokes_type == "SKY_STOKES"
    assert ts.I is ts["I"] and ts.stokes_data is ts._stokes_data
    assert set(dir(ts)) >= set("IQUV")
    assert ts.wcs is tcubes["I"].wcs and ts.ndim == 3
    with pytest.raises(KeyError):
        ts["XX"]
    with pytest.raises(AttributeError):
        ts.XX
    assert ts.components == list("IQUV") and "shape" in repr(ts)


def test_invalid_component_rejected(iquv):
    _, _, tcubes, _ = iquv
    with pytest.raises(ValueError, match="Invalid Stokes component"):
        T.StokesSpectralCube({"I": tcubes["I"], "BANANA": tcubes["Q"]})
    with pytest.raises(TypeError):
        T.StokesSpectralCube({"I": np.zeros(SHAPE)})


def test_mismatched_shape_and_wcs_rejected(iquv):
    _, _, tcubes, _ = iquv
    with pytest.raises(ValueError, match="same shape"):
        T.StokesSpectralCube({"I": tcubes["I"], "Q": tcubes["Q"][1:]})
    with pytest.raises(ValueError, match="same WCS"):
        T.StokesSpectralCube({"I": tcubes["I"],
                              "Q": tcubes["Q"].with_spectral_unit("GHz")})


def test_common_mask(iquv):
    ts, js, _, _ = iquv
    mask = np.zeros(SHAPE, dtype=bool)
    mask[:, 1, :] = True
    tm, jm = ts.with_mask(mask), js.with_mask(mask)
    assert_stokes_equal(tm, jm)
    filled = tm["I"].filled_data[:].value
    assert np.isnan(filled[:, 0, :]).all()
    tm2 = tm.with_mask(torch.as_tensor(mask[::-1].copy()))
    assert_stokes_equal(tm2, jm.with_mask(mask[::-1].copy()))
    with pytest.raises(TypeError):
        T.StokesSpectralCube(ts.stokes_data, mask=mask)
    with pytest.raises(ValueError, match="broadcastable"):
        T.StokesSpectralCube(ts.stokes_data,
                             mask=T.BooleanArrayMask(np.ones((3, 2), bool)))


def _feeds(c, basis):
    if basis == "Linear":
        return {"XX": c["I"] + c["Q"], "YY": c["I"] - c["Q"],
                "XY": c["U"] - c["V"], "YX": c["U"] + c["V"]}
    return {"RR": c["I"] + c["V"], "LL": c["I"] - c["V"],
            "RL": c["Q"] - c["U"], "LR": c["Q"] + c["U"]}


@pytest.mark.parametrize("basis", ["Linear", "Circular"])
def test_feed_to_sky(iquv, basis):
    _, _, tcubes, jcubes = iquv
    tf = T.StokesSpectralCube(_feeds(tcubes, basis))
    jf = J.StokesSpectralCube(_feeds(jcubes, basis))
    assert_stokes_equal(tf, jf)
    assert_stokes_equal(tf.transform_basis("Sky"), jf.transform_basis("Sky"))


@pytest.mark.parametrize("basis", ["Linear", "Circular"])
def test_sky_to_feed_roundtrip(iquv, basis):
    ts, js, tcubes, _ = iquv
    feed = ts.transform_basis(basis)
    assert_stokes_equal(feed, js.transform_basis(basis))
    back = feed.transform_basis("Sky")
    assert_stokes_equal(back, js.transform_basis(basis).transform_basis("Sky"))
    for comp in "IQUV":
        got = back[comp].unmasked_data[:].value
        want = 0.5 * tcubes[comp].unmasked_data[:].value
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[fin]).max())


def test_transform_basis_noop_and_errors(iquv):
    ts, _, tcubes, _ = iquv
    assert ts.transform_basis("Sky") is ts
    with pytest.raises(ValueError, match="unknown basis"):
        ts.transform_basis("Elliptical")
    lin = ts.transform_basis("Linear")
    with pytest.raises(ValueError, match="requires IQUV"):
        lin.transform_basis("Circular")
    partial = T.StokesSpectralCube({"XX": tcubes["I"], "YY": tcubes["Q"]})
    assert partial.transform_basis("Sky").components == ["I", "Q"]
    mixed = T.StokesSpectralCube({"I": tcubes["I"], "XX": tcubes["Q"]})
    assert mixed.stokes_type == "MIXED"
    with pytest.raises(ValueError, match="cannot transform"):
        mixed.transform_basis("Sky")


def test_delegated_geometry(iquv):
    ts, js, _, _ = iquv
    lo, hi = -321.2, -318.7
    assert_stokes_equal(
        ts.spectral_slab(T.Quantity(lo, "km / s"), T.Quantity(hi, "km / s")),
        js.spectral_slab(J.Quantity(lo, "km / s"), J.Quantity(hi, "km / s")))
    assert_stokes_equal(ts.subcube(xlo=1, xhi=4, ylo=0, yhi=3),
                        js.subcube(xlo=1, xhi=4, ylo=0, yhi=3))
    assert_stokes_equal(ts[1:3, ::-1], js[1:3, ::-1])
    assert_stokes_equal(ts.with_spectral_unit("GHz",
                                              velocity_convention="radio"),
                        js.with_spectral_unit("GHz",
                                              velocity_convention="radio"))
    arr = np.zeros(SHAPE, dtype=bool)
    arr[1:3, 2:4, 1:5] = True
    tm = ts.with_mask(T.BooleanArrayMask(arr, shape=SHAPE))
    jm = js.with_mask(J.BooleanArrayMask(arr, shape=SHAPE))
    assert_stokes_equal(tm.minimal_subcube(), jm.minimal_subcube())
    assert ts.subcube_slices_from_mask(T.BooleanArrayMask(arr)) \
        == js.subcube_slices_from_mask(J.BooleanArrayMask(arr))
    assert_stokes_equal(ts.subcube_from_mask(T.BooleanArrayMask(arr)),
                        js.subcube_from_mask(J.BooleanArrayMask(arr)))


def test_stokes_write_read_roundtrip(iquv, tmp_path):
    ts, js, _, _ = iquv
    path = str(tmp_path / "stokes_out.fits")
    ts.write(path)
    back = T.StokesSpectralCube.read(path, device="cpu")
    jback = J.StokesSpectralCube.read(path)
    assert_stokes_equal(back, jback)
    for k in ts.components:
        np.testing.assert_array_equal(back[k]._data.numpy(),
                                      ts[k]._get_filled_data().numpy())
    with pytest.raises(OSError, match="overwrite"):
        ts.write(path)
    with pytest.raises(ValueError, match="arithmetic sequence"):
        T.StokesSpectralCube({"I": ts["I"], "Q": ts["Q"],
                              "V": ts["V"]}).write(
            str(tmp_path / "iv.fits"))
    one = T.StokesSpectralCube.read(str(tmp_path / "I.fits"), device="cpu")
    assert one.components == ["I"]


def test_read_4d_file_matches_jax(tmp_path):
    """A 4-D IQUV file (numpy order Stokes, spectral, y, x) reads as the
    JAX package's StokesSpectralCube; SpectralCube.read keeps returning
    its I component."""
    from spectral_cube_tpu_torch.io import read_cube
    rng = np.random.RandomState(5)
    data4 = rng.rand(4, *SHAPE).astype(np.float32)
    data4[2, 1, 2, 3] = np.nan
    h = base_header(nx=SHAPE[2], ny=SHAPE[1], nchan=SHAPE[0])
    h["BITPIX"], h["NAXIS"], h["NAXIS4"] = -32, 4, 4
    h["CTYPE4"], h["CRVAL4"], h["CDELT4"], h["CRPIX4"] = \
        "STOKES", 1.0, 1.0, 1.0
    path = str(tmp_path / "iquv.fits")
    write_fits(path, [HDU(data=data4, header=h)])
    ts = read_cube(path, device="cpu")
    assert_stokes_equal(ts, J.StokesSpectralCube.read(path))
    for i, k in enumerate("IQUV"):
        np.testing.assert_array_equal(ts[k]._data.numpy(), data4[i])
    with pytest.warns(StokesWarning, match="I component"):
        i_only = T.SpectralCube.read(path, device="cpu")
    np.testing.assert_array_equal(i_only._data.numpy(), data4[0])


def test_cube_from_arrays_carries_jax_stokes(iquv):
    _, js, _, _ = iquv
    mask = np.zeros(SHAPE, dtype=bool)
    mask[:, 2:, :] = True
    js = js.with_mask(mask)
    ts = cube_from_arrays({k: np.asarray(js.stokes_data[k]._data)
                           for k in js.components},
                          js[js.components[0]].header,
                          mask={k: js[k].get_mask_array()
                                for k in js.components}, device="cpu")
    assert ts.components == js.components
    for k in ts.components:
        np.testing.assert_array_equal(ts[k]._data.numpy(),
                                      np.asarray(js[k]._data))
        np.testing.assert_array_equal(ts[k].get_mask_array(),
                                      np.asarray(js[k].get_mask_array()))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            np.testing.assert_allclose(ts[k].moment0().value,
                                       np.asarray(js[k].moment0().value),
                                       rtol=1e-6)
