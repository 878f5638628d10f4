"""Torch port, the module functions of ``wcs_utils`` and ``cube_utils``
against the JAX package.

Mirrors ``tests/test_wcs_utils.py`` by name.  Each case runs the same
call through both packages on the same WCS (built by each package's own
``WCS``) and checks the cards bitwise equal, then keeps the reference's
own expected numbers.
"""

import warnings

import numpy as np
import pytest

import spectral_cube_tpu as J
from spectral_cube_tpu import wcs_utils as jw
from spectral_cube_tpu import cube_utils as jcu
from spectral_cube_tpu.wcs import WCS as JWCS

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import wcs_utils as tw
from spectral_cube_tpu_torch import cube_utils as tcu
from spectral_cube_tpu_torch.wcs import WCS as TWCS

from conftest import make_cube_file


def _pair(naxis, **attrs):
    """The same WCS in each package."""
    out = []
    for cls in (TWCS, JWCS):
        w = cls(naxis=naxis)
        for k, v in attrs.items():
            setattr(w, k, v() if callable(v) else v)
        out.append(w)
    return out


def _wcs3(ctypes=("RA---SIN", "DEC--SIN", "VRAD")):
    return _pair(3, ctype=lambda: list(ctypes),
                 cunit=lambda: ["deg", "deg", "m s-1"])


def assert_wcs_equal(t, j):
    assert t.to_header() == j.to_header()
    np.testing.assert_array_equal(np.asarray(t.pc), np.asarray(j.pc))
    assert t.pixel_shape == j.pixel_shape


@pytest.fixture
def adv(tmp_path):
    path, data = make_cube_file(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return T.SpectralCube.read(path, device="cpu"), J.SpectralCube.read(path)


def test_wcs_dropping_and_swapping():
    t, j = _wcs3()
    assert_wcs_equal(tw.drop_axis(t, 0), jw.drop_axis(j, 0))
    assert_wcs_equal(tw.wcs_swapaxes(t, 0, 2), jw.wcs_swapaxes(j, 0, 2))
    assert_wcs_equal(tw.reindex_wcs(t, [2, 1, 0]), jw.reindex_wcs(j, [2, 1, 0]))
    assert list(tw.reindex_wcs(t, [2, 1, 0]).ctype) == \
        ["VRAD", "DEC--SIN", "RA---SIN"]


def test_add_stokes():
    t, j = _wcs3()
    for ii in range(4):
        out = tw.add_stokes_axis_to_wcs(t, ii)
        assert_wcs_equal(out, jw.add_stokes_axis_to_wcs(j, ii))
        assert out.naxis == 4 and out.ctype[ii] == "STOKES"


def test_axis_names():
    for ctypes in (("RA---SIN", "DEC--SIN", "VRAD"),
                   ("VOPT", "RA---TAN", "DEC--TAN")):
        t, j = _wcs3(ctypes)
        assert tw.axis_names(t) == jw.axis_names(j)
    assert tw.axis_names(_wcs3()[0]) == ["RA", "DEC", "VRAD"]


def test_wcs_slice():
    t, j = _pair(3, crpix=[50., 45., 30.])
    view = (slice(10, 20), slice(None), slice(20, 30))
    out = tw.slice_wcs(t, view)
    assert_wcs_equal(out, jw.slice_wcs(j, view))
    np.testing.assert_allclose(out.crpix, [30., 45., 20.])
    fits_view = (slice(20, 30), slice(None), slice(10, 20))
    assert_wcs_equal(tw.slice_wcs(t, fits_view, numpy_order=False),
                     jw.slice_wcs(j, fits_view, numpy_order=False))


def test_wcs_slice_reversal_and_roundtrip():
    t, j = _pair(3, crpix=[50., 45., 30.], crval=[0., 0., 0.],
                 cdelt=[1., 1., 1.])
    view = (slice(None, None, -1), slice(None), slice(None))
    shape = [100, 150, 200]
    tr, jr = t, j
    for _ in range(4):
        tr = tw.slice_wcs(tr, view, shape=shape)
        jr = jw.slice_wcs(jr, view, shape=shape)
        assert_wcs_equal(tr, jr)
    assert tw.check_equality(tr, tw.slice_wcs(tw.slice_wcs(
        t, view, shape=shape), view, shape=shape))


@pytest.mark.parametrize("view", [slice(0, None, 1), slice(0, None, 2),
                                  slice(0, None, 4), slice(2, None, 1),
                                  slice(2, None, 2), slice(2, None, 4)])
def test_wcs_downsampling_crpix(view):
    t, j = _pair(1, ctype=["FREQ"], crpix=[1.])
    out = tw.slice_wcs(t, view)
    assert out.crpix[0] == jw.slice_wcs(j, view).crpix[0]
    expected = {(0, 1): 1, (0, 2): 0.75, (0, 4): 0.625, (2, 1): -1,
                (2, 2): -0.25, (2, 4): 0.125}[(view.start, view.step)]
    assert out.crpix[0] == expected


def test_wcs_comparison_tolerance():
    pairs = [_pair(3, crpix=c) for c in ([50., 45., 30.], [50., 45., 30.],
                                         [50., 45., 31.],
                                         [50., 45., 30.0001])]
    for tol in (0.0, 1e-3, 1e1):
        for a in range(4):
            for b in range(4):
                assert tw.check_equality(pairs[a][0], pairs[b][0],
                                         wcs_tolerance=tol) == \
                    jw.check_equality(pairs[a][1], pairs[b][1],
                                      wcs_tolerance=tol)
    assert not tw.check_equality(pairs[0][0], pairs[3][0])
    assert tw.check_equality(pairs[0][0], pairs[3][0], wcs_tolerance=1e-3)


def test_strip_wcs_from_header(adv):
    t, j = adv
    stripped = tw.strip_wcs_from_header(t.header)
    assert list(stripped.keys()) == \
        list(jw.strip_wcs_from_header(j.header).keys())
    for k in stripped.keys():
        for frag in ("CRPIX", "CRVAL", "CDELT", "CTYPE", "CUNIT", "PC",
                     "NAXIS", "RESTFRQ"):
            assert not str(k).startswith(frag), k


def test_diagonal_wcs_to_cdelt():
    t, j = _wcs3()
    for w in (t, j):
        w.cdelt = [1., 2., 3.]
        w.pc = np.diag([2., 1., 0.5])
    out = tw.diagonal_wcs_to_cdelt(t)
    assert_wcs_equal(out, jw.diagonal_wcs_to_cdelt(j))
    np.testing.assert_allclose(out.cdelt, [2., 2., 1.5])
    t.pc = np.array([[1., 0.1, 0], [0, 1, 0], [0, 0, 1.]])
    assert tw.diagonal_wcs_to_cdelt(t) is t


def test_pixel_axis_correlation_gate():
    t, j = _wcs3()
    for axis in (0, 1, 2):
        assert tw.is_pixel_axis_to_wcs_correlated(t, axis) == \
            jw.is_pixel_axis_to_wcs_correlated(j, axis)
    assert tw.is_pixel_axis_to_wcs_correlated(t, 1)
    assert not tw.is_pixel_axis_to_wcs_correlated(t, 0)


def test_find_spatial_pixel_index(adv):
    t, j = adv
    from spectral_cube_tpu_torch.units import Quantity as TQ
    from spectral_cube_tpu.units import Quantity as JQ
    for bounds in (("min", "max", "min", "max"), (0, 1, 1, 2)):
        assert tw.find_spatial_pixel_index(t, *bounds) == \
            jw.find_spatial_pixel_index(j, *bounds)
    lon = float(t.world_extrema[0].value.mean())
    assert tw.find_spatial_pixel_index(
        t, TQ(lon - 1e-3, "deg"), TQ(lon + 1e-3, "deg"), "min", "max") == \
        jw.find_spatial_pixel_index(
            j, JQ(lon - 1e-3, "deg"), JQ(lon + 1e-3, "deg"), "min", "max")


def test_cube_utils_misc(adv):
    t, j = adv
    assert tcu.is_huge(t) == jcu.is_huge(j)
    assert tcu.iterator_strategy(t) == jcu.iterator_strategy(j) == "cube"
    assert str(tcu.convert_bunit("JY/BEAM")) == "Jy / beam"
    with pytest.warns(UserWarning):
        assert tcu.convert_bunit("notaunit~~") is None
    from spectral_cube_tpu_torch.units import Quantity
    from spectral_cube_tpu.units import Quantity as JQ
    beams = [T.Beam(Quantity(a, "arcsec")) for a in (1.0, 2.0, 3.0)]
    assert tcu.largest_beam(beams) == beams[2]
    assert tcu.smallest_beam(beams) == beams[0]
    maj, _, _ = tcu.beam_props(beams, includemask=[True, False, True])
    jbeams = [J.Beam(JQ(a, "arcsec")) for a in (1.0, 2.0, 3.0)]
    jmaj, _, _ = jcu.beam_props(jbeams, includemask=[True, False, True])
    np.testing.assert_array_equal(np.asarray(maj.value),
                                  np.asarray(jmaj.value))
    assert maj.to_value("arcsec") == pytest.approx([1.0, 3.0])
    assert tcu.beams_to_bintable(beams).header["NCHAN"] == 3


def test_try_load_beam_paths(adv):
    t, _ = adv
    hdr = dict(t.header)
    hdr["BMAJ"], hdr["BMIN"], hdr["BPA"] = 1e-3, 1e-3, 0.0
    b = tcu.try_load_beam(hdr)
    assert b is not None and abs(b.major.to_value("deg") - 1e-3) < 1e-12
    assert tcu.try_load_beam({}) is None


def test_wcs_swapping():
    t, j = _pair(4, pc=lambda: np.diag(np.arange(1.0, 5.0)))
    for (a, b), diag in [((0, 1), [2, 1, 3, 4]), ((0, 3), [4, 2, 3, 1]),
                         ((2, 3), [1, 2, 4, 3])]:
        out = tw.wcs_swapaxes(t, a, b)
        assert_wcs_equal(out, jw.wcs_swapaxes(j, a, b))
        np.testing.assert_array_equal(np.diag(np.asarray(out.pc)), diag)


def test_pixel_shape_preserved_on_reindex():
    t, j = _pair(3, ctype=lambda: ["GLON-CAR", "GLAT-CAR", "VRAD"],
                 pixel_shape=(4321, 2161, 118))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for ax in (0, 2):
            assert tw.drop_axis(t, ax).pixel_shape == \
                jw.drop_axis(j, ax).pixel_shape
    assert tuple(tw.wcs_swapaxes(t, 0, 2).pixel_shape) == (118, 2161, 4321)
    assert tuple(tw.add_stokes_axis_to_wcs(t, 0).pixel_shape) == \
        (1, 4321, 2161, 118)
    assert tw.drop_axis(TWCS(naxis=3), 2).pixel_shape is None


def test_reversal_roundtrip():
    t, j = _pair(3, crpix=lambda: np.array([50.0, 45.0, 30.0]),
                 crval=lambda: np.zeros(3), cdelt=lambda: np.ones(3))
    view = (slice(None, None, -1), slice(None), slice(None))
    shape = [100, 150, 200]

    def spaxis(wx):
        return np.asarray(wx.pix2world(np.zeros(100), np.zeros(100),
                                       np.arange(100.0))[2])

    wn = tw.slice_wcs(t, view, shape=shape)
    np.testing.assert_array_equal(spaxis(wn),
                                  spaxis(jw.slice_wcs(j, view, shape=shape)))
    np.testing.assert_allclose(spaxis(t), spaxis(wn)[::-1])


def test_wcs_slice_unmatched_celestial():
    t, _ = _pair(3, ctype=lambda: ["RA---TAN", "DEC--TAN", "FREQ"],
                 crpix=lambda: np.array([50.0, 45.0, 30.0]))
    for ax in (0, 1):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            tw.drop_axis(t, ax)
        assert any("removed" in str(x.message) for x in rec)
