"""Torch port, the 1-D and 2-D results against the JAX package: Slice and
Projection (world coordinates, extrema, subimage, brightness-unit
conversion), OneDSpectrum and VaryingResolutionOneDSpectrum (spectral
axis, ``with_spectral_unit``, indexing, filled data, beams).

Mirrors ``tests/test_projection.py`` by name.  Values, masks and WCS
cards are bitwise equal to the JAX package's; host float64 world
coordinates within 1e-12 relative; unit round trips within the JAX
tests' 1e-5.
"""

import warnings

import numpy as np
import pytest

import spectral_cube_tpu as J
from spectral_cube_tpu.lower_dimensional_structures import (
    VaryingResolutionOneDSpectrum as JVRODS)

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.wcs import WCSCelestialError

from conftest import make_vr_cube_file
from test_torch_slicing import read_both, write_cube


@pytest.fixture
def pair(tmp_path):
    path, data = write_cube(tmp_path)
    tc, jc = read_both(path)
    return (tc.with_mask(tc > T.Quantity(0.5, "Jy/beam")),
            jc.with_mask(jc > J.Quantity(0.5, "Jy/beam")), data)


def assert_ldo_equal(t, j):
    assert type(t).__name__ == type(j).__name__
    np.testing.assert_array_equal(np.asarray(t.value), np.asarray(j.value))
    assert t.unit.to_string() == j.unit.to_string()
    if j.wcs is not None:
        assert t.wcs.to_header() == j.wcs.to_header()


def test_slice_is_a_projection_with_the_beam(pair):
    tc, jc, _ = pair
    t, j = tc[2], jc[2]
    assert isinstance(t, T.Slice) and isinstance(t, T.Projection)
    assert_ldo_equal(t, j)
    assert t.beam.major_rad == j.beam.major_rad
    np.testing.assert_array_equal(t.mask.include().numpy(),
                                  np.asarray(j.mask.include()))


def test_spatial_world_extrema_2d(pair):
    tc, jc, _ = pair
    plane, jplane = tc[0], jc[0]
    for attr in ("world_extrema", "longitude_extrema", "latitude_extrema"):
        np.testing.assert_allclose(getattr(plane, attr).value,
                                   getattr(tc, attr).value, rtol=1e-12)
        np.testing.assert_allclose(getattr(plane, attr).value,
                                   np.asarray(getattr(jplane, attr).value),
                                   rtol=1e-12)


@pytest.mark.parametrize("view", [np.s_[:, :], np.s_[::2, :],
                                  np.s_[::-1, 1:5], np.s_[3, :]],
                         ids=["all", "step", "rev", "row"])
def test_spatial_world_2d_views(pair, view):
    tc, jc, _ = pair
    plane, jplane = tc.moment0(), jc.moment0()
    for a, b in zip(plane.world[view], jplane.world[view]):
        np.testing.assert_allclose(a.value, np.asarray(b.value), rtol=1e-12)
    for a, b in zip(plane.flattened_world(view=view),
                    jplane.flattened_world(view=view)):
        np.testing.assert_allclose(a.value, np.asarray(b.value), rtol=1e-12)
    _, latc, lonc = tc.world[(0,) + view]
    lat2, lon2 = plane.world[view]
    np.testing.assert_allclose(lat2.value, latc.value, rtol=1e-12)
    np.testing.assert_allclose(lon2.value, lonc.value, rtol=1e-12)


@pytest.mark.parametrize("bounds", [
    dict(xlo=1, xhi=5, ylo=2, yhi=6), dict(xlo="min", xhi=3),
    dict(ylo=4, yhi="max")], ids=["xy", "xmin", "ymax"])
def test_projection_subimage(pair, bounds):
    tc, jc, _ = pair
    assert_ldo_equal(tc.max(axis=0).subimage(**bounds),
                     jc.max(axis=0).subimage(**bounds))


def test_projection_subimage_world_bounds(pair):
    tc, jc, _ = pair
    _, lat, lon = jc.world[0, :, :]
    lonv, latv = np.asarray(lon.value), np.asarray(lat.value)
    kw = dict(xlo=lonv[0, 6], xhi=lonv[0, 2], ylo=latv[1, 0],
              yhi=latv[4, 0])
    assert_ldo_equal(
        tc.max(axis=0).subimage(**{k: T.Quantity(v, "deg")
                                 for k, v in kw.items()}),
        jc.max(axis=0).subimage(**{k: J.Quantity(v, "deg")
                                 for k, v in kw.items()}))


def test_projection_subimage_nocelestial_fail(pair):
    tc, _, _ = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pv = tc.moment0(axis=1)
    with pytest.raises(WCSCelestialError):
        T.Projection(pv.value, wcs=pv.wcs).subimage(xlo=1)


def test_shrink_mask(pair):
    tc, _, _ = pair
    full = tc.unmasked_copy()[2]
    assert full.shrink_mask()._mask is None
    masked = tc[2]
    assert masked.shrink_mask()._mask is not None


def test_onedspectrum_spectral_axis(pair):
    tc, jc, _ = pair
    t, j = tc[:, 1, 1], jc[:, 1, 1]
    assert isinstance(t, T.OneDSpectrum)
    assert_ldo_equal(t, j)
    np.testing.assert_array_equal(t.spectral_axis.value,
                                  np.asarray(j.spectral_axis.value))
    assert t.beam.major_rad == j.beam.major_rad


@pytest.mark.parametrize("unit,conv", [("m / s", None), ("GHz", "radio"),
                                       ("Hz", None), ("km/s", "optical")])
def test_onedspectrum_with_spectral_unit(pair, unit, conv):
    tc, jc, _ = pair
    t = tc[:, 1, 1].with_spectral_unit(unit, velocity_convention=conv)
    j = jc[:, 1, 1].with_spectral_unit(unit, velocity_convention=conv)
    assert t.wcs.to_header() == j.wcs.to_header()
    np.testing.assert_array_equal(t.spectral_axis.value,
                                  np.asarray(j.spectral_axis.value))
    assert str(t.spectral_axis.unit) == str(j.spectral_axis.unit)
    assert str((t * 2).spectral_axis.unit) == str(t.spectral_axis.unit)


@pytest.mark.parametrize("view", [np.s_[1:4], np.s_[-2:], np.s_[::-1],
                                  np.s_[4:0:-1], 2],
                         ids=["slab", "neg", "rev", "revbounds", "scalar"])
def test_onedspectrum_getitem(pair, view):
    tc, jc, _ = pair
    t, j = tc[:, 1, 2][view], jc[:, 1, 2][view]
    assert type(t).__name__ == type(j).__name__
    np.testing.assert_array_equal(np.asarray(t.value), np.asarray(j.value))
    if isinstance(t, T.OneDSpectrum):
        assert_ldo_equal(t, j)
        np.testing.assert_array_equal(t.mask.include().numpy(),
                                      np.asarray(j.mask.include()))


@pytest.mark.parametrize("view", [np.s_[:], np.s_[1:4], np.s_[::-1]],
                         ids=["all", "slab", "rev"])
def test_onedspectrum_filled_data(pair, view):
    tc, jc, _ = pair
    t = tc[:, 2, 3].with_fill_value(-5.0)
    j = jc[:, 2, 3].with_fill_value(-5.0)
    np.testing.assert_array_equal(t.filled_data[view].value,
                                  np.asarray(j.filled_data[view].value))
    np.testing.assert_array_equal(t.unitless_filled_data[view],
                                  np.asarray(j.unitless_filled_data[view]))


def test_onedspectrum_negative_slice_wcs(pair):
    tc, _, _ = pair
    spec = tc[:, 1, 1]
    n = spec.size
    np.testing.assert_allclose(spec[-2:].spectral_axis.value,
                               spec[n - 2:n].spectral_axis.value, rtol=1e-12)


@pytest.mark.parametrize("view", [np.s_[:, 1, 1], np.s_[1:4, 2, 2],
                                  np.s_[::-1, 0, 1]],
                         ids=["all", "slab", "rev"])
def test_vr_onedspectrum_beams(tmp_path, view):
    path, _ = make_vr_cube_file(tmp_path, shape=(5, 4, 3))
    tv, jv = read_both(path)
    t, j = tv[view], jv[view]
    assert isinstance(t, T.VaryingResolutionOneDSpectrum)
    assert isinstance(j, JVRODS)
    assert_ldo_equal(t, j)
    np.testing.assert_array_equal(t.unmasked_beams.major.value,
                                  j.unmasked_beams.major.value)
    np.testing.assert_array_equal(t.goodbeams_mask, j.goodbeams_mask)
    t2 = t[1:3]
    np.testing.assert_array_equal(t2.beams.major.value,
                                  j[1:3].beams.major.value)
    assert len((t * 2).beams) == t.size


BUNITS_2D = ["Jy / beam", "K", "Jy / sr", "Jy / pix", "mJy / beam", "mK"]
BUNITS_1D = ["Jy / beam", "K", "mJy / beam", "mK"]


def _with_unit(cube, unit, mod):
    cube._meta["BUNIT"] = unit
    cube._unit = mod.Unit(unit)
    return cube


@pytest.mark.parametrize("init_unit", BUNITS_2D)
def test_unit_conversions_general_2D(pair, init_unit):
    tc, jc, _ = pair
    tp = _with_unit(tc, init_unit, T)[0]
    jp = _with_unit(jc, init_unit, J)[0]
    for targ in BUNITS_2D:
        new, jnew = tp.to(targ), jp.to(targ)
        assert_ldo_equal(new, jnew)
        np.testing.assert_allclose(new.to(init_unit).value, tp.value,
                                   rtol=1e-5)


@pytest.mark.parametrize("init_unit", BUNITS_1D)
def test_unit_conversions_general_1D(pair, init_unit):
    tc, jc, _ = pair
    ts = _with_unit(tc, init_unit, T)[:, 0, 0]
    js = _with_unit(jc, init_unit, J)[:, 0, 0]
    for targ in BUNITS_1D:
        new, jnew = ts.to(targ), js.to(targ)
        assert_ldo_equal(new, jnew)
        np.testing.assert_allclose(new.to(init_unit).value, ts.value,
                                   rtol=1e-5)


@pytest.mark.parametrize("init_unit", BUNITS_1D)
def test_multibeams_unit_conversions_general_1D(tmp_path, init_unit):
    path, _ = make_vr_cube_file(tmp_path, shape=(5, 4, 3))
    tv, jv = read_both(path)
    ts = _with_unit(tv, init_unit, T)[:, 0, 0]
    js = _with_unit(jv, init_unit, J)[:, 0, 0]
    for targ in BUNITS_1D:
        new, jnew = ts.to(targ), js.to(targ)
        assert_ldo_equal(new, jnew)
        np.testing.assert_allclose(new.to(init_unit).value, ts.value,
                                   rtol=1e-5)


def test_beam_jtok_2D(pair):
    tc, jc, _ = pair
    plane = tc[0]
    freq = tc.with_spectral_unit("GHz").spectral_axis[0]
    jtok = float(plane.beam.jtok(freq).value)
    k1 = plane.to("K", equivalencies=plane.beam.jtok_equiv(freq), freq=freq)
    np.testing.assert_allclose(k1.value, plane.value * jtok, rtol=1e-6)
    jfreq = jc.with_spectral_unit("GHz").spectral_axis[0]
    assert_ldo_equal(plane.to("K", freq=freq), jc[0].to("K", freq=jfreq))


# -- from_hdu / read, and a spectrum's spectral_interpolate / _smooth --------

@pytest.mark.parametrize("kind", ["projection", "spectrum", "vr_spectrum"])
def test_from_hdu_and_read_match_jax(pair, tmp_path, kind):
    """A Projection and a OneDSpectrum round-trip through their HDU and a
    FITS file; a spectrum beside a BEAMS table reads back as a
    VaryingResolutionOneDSpectrum (reference tests/test_io.py:127-136)."""
    tc, jc, _ = pair
    if kind == "projection":
        t, j, cls, jcls = tc[2], jc[2], T.Projection, J.Projection
    elif kind == "spectrum":
        t, j, cls, jcls = tc[:, 2, 3], jc[:, 2, 3], T.OneDSpectrum, \
            J.OneDSpectrum
    else:
        path, _ = make_vr_cube_file(tmp_path, shape=(5, 4, 3))
        tv, jv = read_both(path)
        t, j, cls, jcls = tv[:, 1, 1], jv[:, 1, 1], T.OneDSpectrum, \
            J.OneDSpectrum
    tb, jb = cls.from_hdu(t.hdu), jcls.from_hdu(j.hdu)
    assert_ldo_equal(tb, jb)
    out_t, out_j = str(tmp_path / "t.fits"), str(tmp_path / "j.fits")
    t.write(out_t)
    j.write(out_j)
    for path in (out_t, out_j):
        tr, jr = cls.read(path), jcls.read(path)
        assert_ldo_equal(tr, jr)
        assert_ldo_equal(cls.from_hdu(T.io.fits_low.read_fits(path)), jr)
        if kind == "vr_spectrum":
            assert isinstance(tr, T.VaryingResolutionOneDSpectrum)
            np.testing.assert_array_equal(tr.unmasked_beams.major.value,
                                          jr.unmasked_beams.major.value)
        else:
            assert tr.beam.major_rad == jr.beam.major_rad
    with pytest.raises(IOError):
        cls.from_hdu([T.io.fits_low.BinTableHDU(name="BEAMS")])


def _spectra(pair, tmp_path, vr):
    if not vr:
        tc, jc, _ = pair
        return tc[:, 2, 3], jc[:, 2, 3]
    path, _ = make_vr_cube_file(tmp_path, shape=(6, 4, 3))
    tv, jv = read_both(path)
    return tv[:, 1, 1], jv[:, 1, 1]


@pytest.mark.parametrize("vr", [False, True])
@pytest.mark.parametrize("grid", ["mid", "reversed", "fill", "coarse"])
def test_onedspectrum_spectral_interpolate_matches_jax(pair, tmp_path, vr,
                                                       grid):
    t, j = _spectra(pair, tmp_path, vr)
    sv = np.asarray(t.spectral_axis.value)
    kw = {"suppress_smooth_warning": True}
    if grid == "mid":
        new = (sv[1:] + sv[:-1]) / 2
    elif grid == "reversed":
        new = sv[::-1]
    elif grid == "fill":
        new = np.linspace(sv[0] - 1.0, sv[-1] + 1.0, sv.size)
        kw["fill_value"] = -5.0
    else:
        new = sv[::2]
        kw = {}
    q = T.Quantity(new, t.spectral_axis.unit)
    jq = J.Quantity(new, j.spectral_axis.unit)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tr = t.spectral_interpolate(q, **kw)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jr = j.spectral_interpolate(jq, **kw)
    assert sorted(w.category.__name__ for w in tw) == \
        sorted(w.category.__name__ for w in jw)
    assert_ldo_equal(tr, jr)
    np.testing.assert_array_equal(tr.mask.include(),
                                  np.asarray(jr.mask.include()))
    if vr:
        kept = tr._beams is not None
        assert kept == (jr._beams is not None) == (new.size == sv.size)


@pytest.mark.parametrize("vr", [False, True])
def test_onedspectrum_spectral_smooth_matches_jax(pair, tmp_path, vr):
    t, j = _spectra(pair, tmp_path, vr)
    for kernel in (np.array([0.25, 0.5, 0.25]), np.hanning(5)):
        tr = t.spectral_smooth(kernel, device="cpu")
        jr = j.spectral_smooth(kernel)
        assert type(tr).__name__ == type(jr).__name__
        a, b = np.asarray(tr.value), np.asarray(jr.value)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(b)], b[~np.isnan(b)],
                                   rtol=1e-6, atol=1e-7)
        assert tr.wcs.to_header() == jr.wcs.to_header()
