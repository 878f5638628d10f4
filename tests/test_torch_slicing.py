"""Torch port, the cube's everyday API against the JAX package: indexing
and subcubes, ``with_spectral_unit``, brightness-unit conversion and
arithmetic, argmax/argmin and world coordinates.

Both packages read the same FITS files; the port runs on CPU tensors.
Mirrors the cases of ``tests/test_cube.py`` by name.  Tolerances: data,
masks, indices and WCS cards bitwise equal; host float64 world
coordinates within 1e-12 relative; moments within 1e-6 rtol after equal
NaN patterns (the numerics contract of the moments).
"""

import pickle
import warnings

import numpy as np
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu.io.fits_low import HDU, write_fits
from spectral_cube_tpu.utils import WCSCelestialError as JWCSCelestialError

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.masks import fused_predicate, is_data_local
from spectral_cube_tpu_torch.utils import (PossiblySlowWarning,
                                           WCSCelestialError)

from conftest import base_header, make_vr_cube_file

SHAPE = (6, 7, 8)


def write_cube(tmp_path, shape=SHAPE, seed=3, name="c.fits", **hdr):
    """Noise with a line, a NaN voxel, a NaN plane row and an all-NaN
    spectrum (argmax's no-valid case), written as float64 Jy/beam."""
    rng = np.random.RandomState(seed)
    nchan, ny, nx = shape
    data = rng.rand(nchan, ny, nx) + 2.0 * np.exp(
        -0.5 * ((np.arange(nchan) - nchan / 2) / 1.5) ** 2)[:, None, None]
    data[1, 2, 3] = np.nan
    data[min(4, nchan - 1), :, 0] = np.nan
    data[:, min(5, ny - 1), min(6, nx - 1)] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan, **hdr)
    path = str(tmp_path / name)
    write_fits(path, [HDU(data=data, header=h)])
    return path, data


def read_both(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return T.SpectralCube.read(path, device="cpu"), \
            J.SpectralCube.read(path)


@pytest.fixture
def pair(tmp_path):
    path, data = write_cube(tmp_path)
    return read_both(path) + (data,)


def tq(value, unit):
    return T.Quantity(value, unit)


def jq(value, unit):
    return J.Quantity(value, unit)


def assert_cube_equal(t, j):
    """Data, include mask, WCS cards and unit bitwise equal."""
    assert type(t).__name__ == type(j).__name__
    assert t.shape == j.shape
    assert t._data.dtype == torch.float32
    np.testing.assert_array_equal(t._data.numpy(), np.asarray(j._data))
    np.testing.assert_array_equal(t.get_mask_array(),
                                  np.asarray(j.get_mask_array()))
    assert t.wcs.to_header() == j.wcs.to_header()
    assert t.unit.to_string() == j.unit.to_string()


def assert_result_equal(t, j):
    """A cube, a lower-dimensional object or a scalar, as the JAX
    package's."""
    assert type(t).__name__ == type(j).__name__
    if isinstance(t, T.BaseSpectralCube):
        return assert_cube_equal(t, j)
    np.testing.assert_array_equal(np.asarray(t.value), np.asarray(j.value))
    assert t.unit.to_string() == j.unit.to_string()
    if getattr(j, "wcs", None) is not None:
        assert t.wcs.to_header() == j.wcs.to_header()


def assert_moments_close(t, j, rtol=1e-6):
    for order in (0, 1, 2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a = np.asarray(t.moment(order=order).value)
            b = np.asarray(j.moment(order=order).value)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fin = ~np.isnan(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=rtol,
                                   atol=rtol * np.abs(b[fin]).max())


VIEWS = [
    np.s_[1:4], np.s_[:, 1:5, 2:7], np.s_[::-1], np.s_[:, ::-1],
    np.s_[:, :, ::-1], np.s_[-4:], np.s_[1:5, -3:, ::-1], np.s_[4:1:-1],
    np.s_[::2], 2, -1, np.s_[:, 3, 4], np.s_[::-1, 3, 4], np.s_[1, 2, 3],
    np.s_[:, 2], np.s_[:, :, 4], np.s_[2, 1:4, 2:6], np.s_[2:5, 3, 4],
]
VIEW_IDS = [f"v{i}" for i in range(len(VIEWS))]


@pytest.mark.parametrize("view", VIEWS, ids=VIEW_IDS)
def test_getitem_variants(pair, view):
    tc, jc, _ = pair
    assert_result_equal(tc[view], jc[view])


@pytest.mark.parametrize("view", VIEWS, ids=VIEW_IDS)
def test_getitem_applies_mask(pair, view):
    tc, jc, _ = pair
    tm = tc.with_mask(tc > tq(0.5, "Jy/beam"))
    jm = jc.with_mask(jc > jq(0.5, "Jy/beam"))
    assert_result_equal(tm[view], jm[view])


def test_getitem_result_types(pair):
    tc, _, data = pair
    assert isinstance(tc[0], T.Slice) and tc[0].shape == SHAPE[1:]
    assert isinstance(tc[:, 1, 1], T.OneDSpectrum)
    scalar = tc[0, 0, 0]
    assert isinstance(scalar, T.Quantity)
    assert float(scalar.value) == np.float32(data[0, 0, 0])
    with pytest.raises(IndexError):
        tc[0, 0, 0, 0]


def test_cut_storage(pair):
    """A channel range shares the parent's storage; a spatial cut and a
    reversed axis are contiguous copies (every kernel takes contiguous
    data)."""
    tc, _, _ = pair
    slab = tc[1:4]
    assert slab._data.data_ptr() == tc._data[1].data_ptr()
    for view in (np.s_[:, 1:5, 2:7], np.s_[::-1], np.s_[:, :, ::-1]):
        sub = tc[view]
        assert sub._data.is_contiguous()
        assert sub._data.untyped_storage().data_ptr() \
            != tc._data.untyped_storage().data_ptr()


@pytest.mark.parametrize("view", [np.s_[::-1], np.s_[-3:-1], np.s_[:, ::-1],
                                  np.s_[:, :, ::-1], np.s_[::-1, ::-1]],
                         ids=["spec", "negbounds", "y", "x", "spec_y"])
def test_negative_slice_wcs(pair, view):
    """Negative steps and bounds, with a comparison mask: data, mask, WCS
    as the JAX package's, and the reversed cube's moments equal the
    forward cube's (torch refuses negative steps: masks.index_view)."""
    tc, jc, _ = pair
    tm = tc.with_mask(tc > tq(0.4, "Jy/beam"))
    jm = jc.with_mask(jc > jq(0.4, "Jy/beam"))
    assert_cube_equal(tm[view], jm[view])
    assert_moments_close(tm[view], jm[view])
    sa = np.asarray(jc.spectral_axis.value)
    np.testing.assert_allclose(tm[view].spectral_axis.value,
                               sa[view if isinstance(view, slice)
                                  else view[0]], rtol=1e-12)


def test_reversed_slice_wcs(pair):
    tc, jc, data = pair
    rev = tc[::-1]
    np.testing.assert_allclose(rev.spectral_axis.value,
                               tc.spectral_axis.value[::-1], rtol=1e-12)
    np.testing.assert_array_equal(rev.unmasked_data[:].value,
                                  data[::-1].astype(np.float32))
    m_fwd = tc.moment1().value
    m_rev = rev.moment1().value
    np.testing.assert_array_equal(np.isnan(m_fwd), np.isnan(m_rev))
    fin = ~np.isnan(m_fwd)
    np.testing.assert_allclose(m_rev[fin], m_fwd[fin], rtol=1e-6)


@pytest.mark.parametrize("lo,hi", [(-321.2, -318.7), (-318.7, -321.2),
                                   (-320.0, -316.0), (-400.0, 0.0)])
def test_spectral_slab(pair, lo, hi):
    tc, jc, _ = pair
    ts = tc.spectral_slab(tq(lo, "km/s"), tq(hi, "km/s"))
    js = jc.spectral_slab(jq(lo, "km/s"), jq(hi, "km/s"))
    assert_cube_equal(ts, js)


def test_closest_spectral_channel_and_reversed_slab(pair):
    tc, jc, _ = pair
    sv = tc.spectral_axis
    assert tc.closest_spectral_channel(sv[2]) == 2
    assert tc.closest_spectral_channel(sv[2].to("m / s")) == 2
    ghz = tq(1.4219e9, "Hz")
    assert tc.closest_spectral_channel(ghz) \
        == jc.closest_spectral_channel(jq(1.4219e9, "Hz"))
    assert_cube_equal(tc.spectral_slab(sv[2], sv[0]),
                      jc.spectral_slab(jc.spectral_axis[2],
                                       jc.spectral_axis[0]))


@pytest.mark.parametrize("bounds", [
    dict(xlo=1, xhi=5, ylo=2, yhi=6), dict(zlo=1, zhi=4),
    dict(xlo="min", xhi=3), dict(ylo=4, yhi="max", zlo=2)],
    ids=["xy", "z", "xmin", "ymax"])
def test_subcube(pair, bounds):
    tc, jc, _ = pair
    assert_cube_equal(tc.subcube(**bounds), jc.subcube(**bounds))


def test_subcube_world_bounds(pair):
    tc, jc, _ = pair
    _, lat, lon = jc.world[0, :, :]
    lonv, latv = np.asarray(lon.value), np.asarray(lat.value)
    for kw in (dict(xlo=lonv.max(), xhi=lonv.min()),
               dict(xlo=lonv[0, 2], xhi=lonv[0, 2]),
               dict(ylo=latv[1, 0], yhi=latv[4, 0])):
        assert_cube_equal(
            tc.subcube(**{k: tq(v, "deg") for k, v in kw.items()}),
            jc.subcube(**{k: jq(v, "deg") for k, v in kw.items()}))
    sv = np.asarray(jc.spectral_axis.value)
    assert_cube_equal(tc.subcube(zlo=tq(sv[4], "km/s"),
                                 zhi=tq(sv[1], "km/s")),
                      jc.subcube(zlo=jq(sv[4], "km/s"),
                                 zhi=jq(sv[1], "km/s")))


def test_subcube_world_bounds_inclusive_and_cutout_safe(pair):
    tc, jc, _ = pair
    w = jc.world[:, :, :]
    lon, lat = np.asarray(w[2].value), np.asarray(w[1].value)
    for kw in (dict(xlo=lon.min(), xhi=lon.max()),
               dict(ylo=lat.min(), yhi=lat.max()),
               dict(xlo=lon[0, 0, 1], xhi=lon[0, 0, 1])):
        t = tc.subcube(**{k: tq(v, "deg") for k, v in kw.items()})
        assert_cube_equal(t, jc.subcube(
            **{k: jq(v, "deg") for k, v in kw.items()}))


@pytest.mark.parametrize("spatial_only", [False, True])
def test_minimal_subcube(pair, spatial_only):
    tc, jc, _ = pair
    arr = np.zeros(SHAPE, dtype=bool)
    arr[1:3, 1:2, 0:2] = True
    arr[4, 5, 6] = True
    t = tc.with_mask(T.BooleanArrayMask(arr)).minimal_subcube(
        spatial_only=spatial_only)
    j = jc.with_mask(J.BooleanArrayMask(arr)).minimal_subcube(
        spatial_only=spatial_only)
    assert_cube_equal(t, j)
    assert tc.subcube_slices_from_mask(T.BooleanArrayMask(arr)) \
        == jc.subcube_slices_from_mask(J.BooleanArrayMask(arr))
    empty = np.zeros(SHAPE, dtype=bool)
    assert tc.subcube_slices_from_mask(T.BooleanArrayMask(empty)) \
        == jc.subcube_slices_from_mask(J.BooleanArrayMask(empty))
    assert_cube_equal(tc.subcube_from_mask(T.BooleanArrayMask(arr)),
                      jc.subcube_from_mask(J.BooleanArrayMask(arr)))
    assert tc.unmasked_copy().minimal_subcube().shape == SHAPE


def test_subcube_moments_fuse_the_mask(pair):
    """A spatial subcube of a comparison-masked cube keeps a mask the
    moments kernel fuses, and its moments are the same crop of the full
    slab's moments and the JAX package's."""
    tc, jc, _ = pair
    thr = 0.6
    tm = tc.with_mask(tc > tq(thr, "Jy/beam"))
    jm = jc.with_mask(jc > jq(thr, "Jy/beam"))
    view = np.s_[1:5, 1:6, 2:7]
    sub = tm[view]
    assert is_data_local(sub.mask)
    assert fused_predicate(sub.mask) == (1, thr)
    assert_moments_close(sub, jm[view])
    for order in (0, 1, 2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            full = tm[1:5].moment(order=order).value[1:6, 2:7]
            part = sub.moment(order=order).value
        np.testing.assert_array_equal(np.isnan(full), np.isnan(part))
        fin = ~np.isnan(full)
        np.testing.assert_allclose(part[fin], full[fin], rtol=1e-6)


@pytest.mark.parametrize("unit,conv", [
    ("GHz", "radio"), ("Hz", None), ("m/s", "optical"), ("km/s", "radio"),
    ("um", None), ("km/s", "relativistic")])
def test_with_spectral_unit_roundtrip(pair, unit, conv):
    tc, jc, _ = pair
    t = tc.with_spectral_unit(unit, velocity_convention=conv)
    j = jc.with_spectral_unit(unit, velocity_convention=conv)
    assert t.wcs.to_header() == j.wcs.to_header()
    np.testing.assert_array_equal(t.spectral_axis.value,
                                  np.asarray(j.spectral_axis.value))
    assert t.velocity_convention == j.velocity_convention
    back = t.with_spectral_unit("km/s", velocity_convention="radio")
    np.testing.assert_allclose(back.spectral_axis.value,
                               tc.spectral_axis.value, rtol=1e-10)
    assert t._data is tc._data


def test_spectral_properties(pair):
    tc, jc, _ = pair
    np.testing.assert_array_equal(tc.spectral_extrema.value,
                                  np.asarray(jc.spectral_extrema.value))
    assert tc.velocity.wcs.to_header() == jc.velocity.wcs.to_header()
    assert tc.velocity_convention == jc.velocity_convention
    assert tc.base is tc._data
    with pytest.raises(NotImplementedError):
        tc.chunked()


def test_invalid_rest_value_raises(pair):
    tc, _, _ = pair
    for rest in (50, tq(50, "K")):
        with pytest.raises(ValueError, match="spectral equivalence"):
            tc.with_spectral_unit("GHz", rest_value=rest)


def test_unit_conversion_jybm_k_roundtrip(pair):
    tc, jc, _ = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tk, jk = tc.to("K"), jc.to("K")
        assert_cube_equal(tk, jk)
        back = tk.to("Jy / beam")
        assert_cube_equal(back, jk.to("Jy / beam"))
    np.testing.assert_allclose(back._data.numpy(), tc._data.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("unit", ["mJy / beam", "Jy / sr", "Jy / pix"])
def test_unit_conversion_scaling(pair, unit):
    tc, jc, _ = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_cube_equal(tc.to(unit), jc.to(unit))
        # a frequency axis gives the same factors as the velocity axis
        assert_cube_equal(tc.with_spectral_unit("GHz").to(unit),
                          jc.with_spectral_unit("GHz").to(unit))


ARITH = {
    "mul": lambda c, q: c * 2,
    "rmul": lambda c, q: 3 * c,
    "add_q": lambda c, q: c + q(1.0, "Jy/beam"),
    "sub_q": lambda c, q: c - q(0.5, "Jy/beam"),
    "rsub": lambda c, q: 1.0 - c.unitless,
    "self_sub": lambda c, q: c - c,
    "self_div": lambda c, q: c / c,
    "self_mul": lambda c, q: c * c,
    "div": lambda c, q: c / 3.0,
    "rdiv": lambda c, q: 2.0 / c,
    "mul_q": lambda c, q: c * q(2.0, "K"),
    "mul_array": lambda c, q: c * np.linspace(0.5, 2.0, SHAPE[2]),
    "add_array": lambda c, q: c.unitless + np.arange(SHAPE[2], dtype=float),
    "div_unit": lambda c, q: c / q(1.0, "km/s").unit,
    "pow2": lambda c, q: c ** 2,
    "pow3": lambda c, q: c ** 3,
    "abs": lambda c, q: abs(c - q(0.8, "Jy/beam")),
}


@pytest.mark.parametrize("name", sorted(ARITH))
def test_arithmetic(pair, name):
    tc, jc, _ = pair
    assert_cube_equal(ARITH[name](tc, tq), ARITH[name](jc, jq))


def test_arithmetic_errors(pair):
    tc, _, _ = pair
    with pytest.raises(NotImplementedError):
        tc // 2
    with pytest.raises(ValueError, match="Quantity"):
        tc + 1.0
    with pytest.raises(ValueError, match="shapes"):
        tc + tc[1:]


def test_cube_pow_units(pair):
    tc, jc, _ = pair
    sq = tc ** 2
    assert sq.unit.to_string() == (jc ** 2).unit.to_string()
    assert sq.unit == tc.unit ** 2
    np.testing.assert_array_equal(sq.unmasked_data[:].value,
                                  np.asarray((jc ** 2)._data))


def test_float64_operand_keeps_float32(pair):
    """Arrays of float64 operate on float32 data in float32, as JAX with
    64-bit mode off computes them; torch alone would promote."""
    tc, jc, _ = pair
    f64 = np.linspace(0.5, 2.0, SHAPE[2])
    for t, j in ((tc * f64, jc * f64),
                 (tc * tq(f64, "K"), jc * jq(f64, "K")),
                 (tc * torch.as_tensor(f64), jc * f64),
                 (tc.unitless - f64, jc.unitless - f64)):
        assert t._data.dtype == torch.float32
        assert_cube_equal(t, j)
    other = T.SpectralCube(tc._data.double(), tc.wcs, mask=tc.mask,
                           header=tc._header)
    out = tc + other
    assert out._data.dtype == torch.float32
    assert_cube_equal(out, jc + jc)


def test_slab_operations_leave_parent_unchanged(pair):
    """A channel slab shares its parent's storage; no ported operation on
    it writes into that storage."""
    tc, _, _ = pair
    parent = tc._data.clone()
    slab = tc[1:5]
    assert slab._data.data_ptr() == tc._data[1].data_ptr()
    kern = np.array([0.25, 0.5, 0.25])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ops = [
            lambda s: s * 2, lambda s: s + tq(1.0, "Jy/beam"),
            lambda s: s - s, lambda s: 2.0 / s, lambda s: s ** 2,
            lambda s: abs(s), lambda s: s.to("K"), lambda s: s.unitless,
            lambda s: s.with_spectral_unit("GHz"),
            lambda s: s.with_mask(s > tq(0.5, "Jy/beam")).moment0(),
            lambda s: s.moment1(), lambda s: s.argmax(axis=0),
            lambda s: s.argmax_world(axis=0), lambda s: s.sigma_clip(2.0),
            lambda s: s.spectral_smooth(kern),
            lambda s: s.spectral_interpolate(s.spectral_axis[::2],
                                             suppress_smooth_warning=True,
                                             fill_value=0.0),
            lambda s: s.downsample_axis(2, 0), lambda s: s[::-1],
            lambda s: s.subcube(xlo=1, xhi=4), lambda s: s.minimal_subcube(),
            lambda s: s.apply_everywhere(lambda q: q * 2),
            lambda s: s.filled(0.0), lambda s: s.flattened(),
            lambda s: s.sum(axis=0), lambda s: s.statistics(),
            lambda s: s.sigma_clip_spectrally(1.0),
        ]
        for op in ops:
            op(slab)
            np.testing.assert_array_equal(tc._data.numpy(), parent.numpy())


@pytest.mark.parametrize("axis", [None, 0, 1, 2])
def test_argmax_argmin(pair, axis):
    tc, jc, data = pair
    np.testing.assert_array_equal(tc.argmax(axis=axis), jc.argmax(axis=axis))
    np.testing.assert_array_equal(tc.argmin(axis=axis), jc.argmin(axis=axis))
    filled = np.where(np.isfinite(data), data.astype(np.float32), -np.inf)
    if axis is not None:
        np.testing.assert_array_equal(tc.argmax(axis=axis),
                                      filled.argmax(axis=axis))


def test_argmax_world(pair):
    tc, jc, data = pair
    t, j = tc.argmax_world(axis=0), jc.argmax_world(axis=0)
    assert_result_equal(t, j)
    sv = tc.spectral_axis.value
    filled = np.where(np.isfinite(data), data.astype(np.float32), -np.inf)
    exp = sv[filled.argmax(axis=0)]
    exp[~np.isfinite(data).any(axis=0)] = np.nan
    np.testing.assert_array_equal(t.value, exp)
    assert_result_equal(tc.argmin_world(axis=0), jc.argmin_world(axis=0))


def test_argmax_world_spectral(pair):
    tc, jc, _ = pair
    arr = np.ones(SHAPE, dtype=bool)
    arr[:, 0, 0] = False
    t = tc.with_mask(arr).argmax_world(axis=0)
    assert np.isnan(t.value[0, 0])
    assert_result_equal(t, jc.with_mask(arr).argmax_world(axis=0))


def test_argmax_world_spatial_gate(pair):
    tc, jc, _ = pair
    for axis in (1, 2):
        for method in ("argmax_world", "argmin_world"):
            with pytest.raises(WCSCelestialError):
                getattr(tc, method)(axis=axis)
            with pytest.raises(JWCSCelestialError):
                getattr(jc, method)(axis=axis)


def test_argmax_world_spatial_car(tmp_path):
    path, _ = write_cube(tmp_path, shape=(4, 5, 6))
    from spectral_cube_tpu.io.fits_low import read_fits
    hdus = read_fits(path)
    h = hdus[0].header
    h["CTYPE1"], h["CTYPE2"], h["CRVAL2"] = "RA---CAR", "DEC--CAR", 0.0
    car = str(tmp_path / "car.fits")
    write_fits(car, [HDU(data=hdus[0].data, header=h)])
    tc, jc = read_both(car)
    for axis in (1, 2):
        assert_result_equal(tc.argmax_world(axis=axis),
                            jc.argmax_world(axis=axis))
    spines_t, spines_j = tc.world_spines(), jc.world_spines()
    for a, b in zip(spines_t, spines_j):
        np.testing.assert_allclose(a.value, np.asarray(b.value), rtol=1e-12)


@pytest.mark.parametrize("view", [np.s_[:, :, :], np.s_[0, :, :],
                                  np.s_[1:3, 2, ::-1], np.s_[::-1, 0, 0]],
                         ids=["all", "plane", "row", "spectrum"])
def test_world_coordinates(pair, view):
    tc, jc, _ = pair
    for a, b in zip(tc.world[view], jc.world[view]):
        assert a.unit.to_string() == b.unit.to_string()
        np.testing.assert_allclose(a.value, np.asarray(b.value), rtol=1e-12)


def test_world_extrema_and_maps(pair):
    tc, jc, _ = pair
    np.testing.assert_allclose(tc.world_extrema.value,
                               np.asarray(jc.world_extrema.value),
                               rtol=1e-12)
    np.testing.assert_allclose(tc.longitude_extrema.value,
                               np.asarray(jc.longitude_extrema.value),
                               rtol=1e-12)
    np.testing.assert_allclose(tc.latitude_extrema.value,
                               np.asarray(jc.latitude_extrema.value),
                               rtol=1e-12)
    for a, b in zip(tc.spatial_coordinate_map, jc.spatial_coordinate_map):
        np.testing.assert_allclose(a.value, np.asarray(b.value), rtol=1e-12)
    with pytest.warns(PossiblySlowWarning):
        ft = tc.flattened_world()
    for a, b in zip(ft, jc.flattened_world()):
        np.testing.assert_allclose(a.value, np.asarray(b.value), rtol=1e-12)
    with pytest.raises(WCSCelestialError):
        tc.world_spines()
    for a, b in zip(tc._pix_cen(), jc._pix_cen()):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for a, b in zip(tc._pix_size(), jc._pix_size()):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for axis in (0, 1, 2):
        assert tc._pix_size_slice(axis) == jc._pix_size_slice(axis)


@pytest.mark.parametrize("view", [(), np.s_[1:3], np.s_[::-1, 2:5, 1]],
                         ids=["all", "slab", "rev"])
def test_filled_and_flattened(pair, view):
    tc, jc, _ = pair
    tm = tc.with_mask(tc > tq(0.5, "Jy/beam")).with_fill_value(-1.0)
    jm = jc.with_mask(jc > jq(0.5, "Jy/beam")).with_fill_value(-1.0)
    v = view if view else (slice(None),)
    np.testing.assert_array_equal(tm.filled_data[v].value,
                                  np.asarray(jm.filled_data[v].value))
    np.testing.assert_array_equal(tm.unitless_filled_data[v],
                                  np.asarray(jm.unitless_filled_data[v]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(tm.flattened(view).value,
                                      np.asarray(jm.flattened(view).value))
        np.testing.assert_array_equal(tm.filled().value,
                                      np.asarray(jm.filled().value))
        w = np.linspace(0.0, 1.0, tc.size).reshape(SHAPE)
        np.testing.assert_array_equal(
            tm.flattened(view, weights=w).value,
            np.asarray(jm.flattened(view, weights=w).value))
    with pytest.raises(TypeError):
        iter(tm.filled_data)


def test_sigma_clip_and_apply_everywhere(pair):
    tc, jc, _ = pair
    assert_cube_equal(tc.sigma_clip(1.0), jc.sigma_clip(1.0))
    assert_cube_equal(tc.apply_everywhere(lambda q: q * 2),
                      jc.apply_everywhere(lambda q: q * 2))
    assert_cube_equal(tc.apply_everywhere(lambda q, x: q + x,
                                          tq(1.0, "Jy/beam")),
                      jc.apply_everywhere(lambda q, x: q + x,
                                          jq(1.0, "Jy/beam")))
    assert_cube_equal(tc._apply_everywhere(lambda d, x: d - x, 0.5,
                                           check_units=False),
                      jc._apply_everywhere(lambda d, x: d - x, 0.5,
                                           check_units=False))


def test_huge_operation_guard(pair, monkeypatch):
    tc, _, _ = pair
    monkeypatch.setattr(type(tc), "_is_huge", property(lambda self: True))
    for op in (lambda c: c * 2, lambda c: c.to("K"),
               lambda c: c.apply_everywhere(lambda q: q)):
        with pytest.raises(ValueError, match="allow_huge_operations"):
            op(tc)
    tc.allow_huge_operations = True
    assert_cube_equal((tc * 2) / 2, tc)


def test_cube_pickles(pair):
    tc, jc, _ = pair
    tm = tc.with_mask(tc > tq(0.5, "Jy/beam"))[1:5, ::-1]
    back = pickle.loads(pickle.dumps(tm))
    assert back.device == torch.device("cpu")
    assert_cube_equal(back, jc.with_mask(jc > jq(0.5, "Jy/beam"))[1:5, ::-1])


def test_vrsc_negative_slice_wcs_and_tolerance(tmp_path):
    pv, vdata = make_vr_cube_file(tmp_path, shape=(5, 8, 8))
    tv, jv = read_both(pv)
    for view in (np.s_[-4:], np.s_[::-1], np.s_[1:4, 2:6, ::-1]):
        t, j = tv[view], jv[view]
        assert_cube_equal(t, j)
        np.testing.assert_array_equal(t.unmasked_beams.major.value,
                                      j.unmasked_beams.major.value)
    np.testing.assert_allclose(tv[-4:].spectral_axis.value,
                               tv[1:5].spectral_axis.value, rtol=1e-12)
    derived = tv.with_mask(np.isfinite(vdata))
    assert derived._wcs_tolerance is not None
    derived.with_mask(np.isfinite(vdata))
    with pytest.raises(NotImplementedError, match="2D plane"):
        tv[:, 1]


def test_vrsc_to_kelvin_per_channel(tmp_path):
    """Per-channel factors (one beam each) in float32, and the moments of
    a cut cube, as the JAX package's."""
    pv, _ = make_vr_cube_file(tmp_path, shape=(5, 8, 8))
    tv, jv = read_both(pv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tk, jk = tv[1:4].to("K"), jv[1:4].to("K")
    assert tk._data.dtype == torch.float32
    assert_cube_equal(tk, jk)
    np.testing.assert_array_equal(tv[1:4].jtok_factors(),
                                  jv[1:4].jtok_factors())
    tv.beam_threshold = jv.beam_threshold = 2.0
    assert_moments_close(tv[1:4, 2:7, 1:6], jv[1:4, 2:7, 1:6])
