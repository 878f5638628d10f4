"""Torch port, varying-resolution cubes (BEAMS tables, degenerate-Stokes
4-D FITS, per-channel ``convolve_to`` on both routes, ``run_pipeline``)
and ``Projection.convolve_to`` / ``reproject``, against the JAX package.

Both packages read the same FITS files; the port runs on CPU tensors,
where every kernel wrapper takes its plain PyTorch version.  Mirrors
``tests/test_vrsc.py`` and the BEAMS / 4-D cases of ``tests/test_io.py``.
Tolerances: beams and factors exact (the same host arithmetic); data
read bit for bit; the separable route at test_torch_convolve.py's 1e-6 of
the data scale; the FFT route at rtol 1e-5 with atol 1e-6 * max|x| where
the normalized convolution's denominator is at least 0.1, den-weighted
below it; the pipeline at test_torch_pipeline.py's tolerances; NaN
patterns exact everywhere.
"""

import warnings
from collections import OrderedDict

import numpy as np
import jax
import pytest

import spectral_cube_tpu as J
from spectral_cube_tpu.io.fits_low import HDU, BinTableHDU, write_fits
from spectral_cube_tpu.parallel import CubeMesh
from spectral_cube_tpu.utils import (BeamAverageWarning as JBeamAvgW,
                                     NonFiniteBeamsWarning as JNonFiniteW)

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.beams import BeamError, BeamUnitsError
from spectral_cube_tpu_torch.interop import cube_from_arrays
from spectral_cube_tpu_torch.ops import convolve as tconv
from spectral_cube_tpu_torch.utils import (BeamAverageWarning,
                                           NonFiniteBeamsWarning,
                                           StokesWarning)

from conftest import base_header, make_vr_cube_file
from test_torch_convolve import _den64, assert_fft_close
from test_torch_regrid import _rotated_header as _rotated

PIX_DEG = 2.0 / 3600.0


def _read_both(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return T.SpectralCube.read(path, device="cpu"), \
            J.SpectralCube.read(path)


@pytest.fixture
def vr_pair(tmp_path):
    path, data = make_vr_cube_file(tmp_path)
    return _read_both(path) + (data,)


def _beams_table(major, minor, pa, npol=1):
    n = len(major)
    cols = OrderedDict(
        BMAJ=np.tile(np.asarray(major, "f4"), npol),
        BMIN=np.tile(np.asarray(minor, "f4"), npol),
        BPA=np.tile(np.asarray(pa, "f4"), npol),
        CHAN=np.tile(np.arange(n, dtype="i4"), npol),
        POL=np.repeat(np.arange(npol, dtype="i4"), n))
    bt = BinTableHDU(columns=cols, name="BEAMS",
                     units={"BMAJ": "arcsec", "BMIN": "arcsec",
                            "BPA": "deg"})
    bt.header["NCHAN"] = n
    bt.header["NPOL"] = npol
    return bt


def drift_beams(n, pa=(30.0, 34.0), groups=1):
    """Beams drifting 6.0"->6.6" by 4.5"->4.95" at PA pa[0]->pa[1] (the
    varying-resolution cell's), constant over runs of ``groups``
    channels."""
    t = (np.arange(n) // groups) * groups / max(n - 1, 1)
    return (6.0 + 0.6 * t, 4.5 + 0.45 * t, pa[0] + (pa[1] - pa[0]) * t)


def write_vr(path, shape=(8, 30, 34), pa=(30.0, 34.0), groups=1,
             nan_beams=(), stokes=False, seed=0, border=True):
    """A Gaussian line on noise with a NaN pixel and (``border``) a NaN
    border, Jy/beam, 2" pixels, and a CASA-layout BEAMS table; 4-D with a
    degenerate STOKES axis when ``stokes``.  Returns the (spec, y, x)
    data."""
    nchan, ny, nx = shape
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:ny, 0:nx]
    amp = 3.0 * np.exp(-0.5 * (((yy - ny / 2) / 6.0) ** 2
                               + ((xx - nx / 2) / 8.0) ** 2))
    v = np.arange(nchan)[:, None, None]
    data = amp * np.exp(-0.5 * ((v - nchan / 2) / 2.0) ** 2)
    data = (data + 0.3 * rng.randn(nchan, ny, nx)).astype(np.float32)
    r2 = ((yy - ny / 2) / (0.47 * ny)) ** 2 + ((xx - nx / 2) / (0.47 * nx)) ** 2
    if border:
        data[:, r2 > 1.0] = np.nan
    data[2, ny // 2, nx // 3] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan, beam=False)
    h["BITPIX"] = -32
    h["CDELT1"], h["CDELT2"] = -PIX_DEG, PIX_DEG
    h["CRPIX1"], h["CRPIX2"] = nx / 2, ny / 2
    h["CASAMBM"] = True
    major, minor, bpa = drift_beams(nchan, pa, groups)
    for c in nan_beams:
        major[c] = minor[c] = np.nan
    payload = data
    if stokes:
        h["NAXIS"], h["NAXIS4"] = 4, 1
        h["CTYPE4"], h["CRVAL4"], h["CDELT4"], h["CRPIX4"] = \
            "STOKES", 1.0, 1.0, 1.0
        payload = data[None]
    write_fits(str(path), [HDU(data=payload, header=h),
                           _beams_table(major, minor, bpa)])
    return data


def _same_beams(tb, jb):
    for a, b in zip(tb, jb):
        for attr in ("major_rad", "minor_rad", "pa_rad"):
            u, v = getattr(a, attr), getattr(b, attr)
            assert u == v or (np.isnan(u) and np.isnan(v))


# -- the class (tests/test_vrsc.py) --------------------------------------

def test_beams_attached(vr_pair):
    tc, jc, _ = vr_pair
    assert isinstance(tc, T.VaryingResolutionSpectralCube)
    assert isinstance(tc, T.BaseSpectralCube)
    assert not isinstance(tc, T.SpectralCube)
    assert len(tc.unmasked_beams) == tc.shape[0]
    _same_beams(tc.unmasked_beams, jc.unmasked_beams)
    np.testing.assert_array_equal(tc._data.numpy(), np.asarray(jc._data))
    np.testing.assert_array_equal(tc.get_mask_array(),
                                  np.asarray(jc.get_mask_array()))


def test_beam_length_mismatch_raises(vr_pair):
    tc, _, _ = vr_pair
    with pytest.raises(ValueError, match="does not match"):
        T.VaryingResolutionSpectralCube(
            data=tc._data, wcs=tc.wcs,
            beams=T.Beams(major=T.Quantity([1, 2], "arcsec")))
    with pytest.raises(ValueError, match="requires beams"):
        T.VaryingResolutionSpectralCube(data=tc._data, wcs=tc.wcs)


def test_nonfinite_beams_masked(tmp_path):
    majors = np.array([1.0, np.nan, 1.2, 1.3], dtype="f4")
    path, _ = make_vr_cube_file(tmp_path, major_arcsec=majors)
    with pytest.warns(NonFiniteBeamsWarning):
        tc = T.SpectralCube.read(path, device="cpu")
    with pytest.warns(JNonFiniteW):
        jc = J.SpectralCube.read(path)
    np.testing.assert_array_equal(tc.goodbeams_mask, jc.goodbeams_mask)
    assert not tc.goodbeams_mask[1]
    filled = tc._get_filled_data().numpy()
    assert np.isnan(filled[1]).all()
    np.testing.assert_array_equal(filled, np.asarray(jc._get_filled_data()))
    assert len(tc.beams) == 3


@pytest.mark.parametrize("view", [slice(1, 3), 2, (slice(None), 1, 1)],
                         ids=["slab", "channel", "spectrum"])
def test_slicing_matches_jax(vr_pair, view):
    """A channel range cuts the beams with the data; one channel is a
    Slice with that channel's beam; a spectrum carries the beams (the
    JAX package's cube.py:2423-2470)."""
    tc, jc, _ = vr_pair
    t, j = tc[view], jc[view]
    assert type(t).__name__ == type(j).__name__
    if isinstance(t, T.VaryingResolutionSpectralCube):
        np.testing.assert_array_equal(t._data.numpy(), np.asarray(j._data))
        np.testing.assert_array_equal(t.goodbeams_mask, j.goodbeams_mask)
        assert t.wcs.to_header() == j.wcs.to_header()
        _same_beams(t.unmasked_beams, j.unmasked_beams)
    elif isinstance(t, T.Slice):
        np.testing.assert_array_equal(t.value, np.asarray(j.value))
        _same_beams([t.beam], [j.beam])
    else:
        np.testing.assert_array_equal(t.value, np.asarray(j.value))
        _same_beams(t.unmasked_beams, j.unmasked_beams)


def test_jtok_factors_match_jax(vr_pair):
    tc, jc, _ = vr_pair
    np.testing.assert_array_equal(tc.jtok_factors(), jc.jtok_factors())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tk, jk = tc.to("K"), jc.to("K")
    np.testing.assert_array_equal(tk._data.numpy(), np.asarray(jk._data))
    assert tk.unit.to_string() == jk.unit.to_string()


def test_moment_requires_matched_beams(vr_pair):
    tc, jc, _ = vr_pair
    for cube in (tc, jc):
        with pytest.raises(ValueError):
            cube.moment0()
        with pytest.raises(ValueError):
            cube.sum(axis=0)
        with pytest.raises(ValueError):
            cube.sum()
    np.testing.assert_allclose(tc.sum(axis=1).value,
                               np.asarray(jc.sum(axis=1).value), rtol=1e-6)


def test_beam_threshold_override_and_average_beam(vr_pair):
    """A loose threshold lets the spectral reductions run; they carry the
    average beam with the averaging warning (reference issue364,
    tests/test_vrsc.py:160-176)."""
    tc, jc, _ = vr_pair
    tc.beam_threshold = jc.beam_threshold = 2.0
    with pytest.warns(BeamAverageWarning):
        t0 = tc.moment0()
    with pytest.warns(JBeamAvgW):
        j0 = jc.moment0()
    np.testing.assert_allclose(t0.value, np.asarray(j0.value), rtol=1e-5)
    _same_beams([t0.beam], [j0.beam])
    assert t0.meta["beam"] is t0.beam
    with pytest.warns(BeamAverageWarning):
        tmax = tc.max(axis=0)
    assert tmax.beam is not None


def test_identify_and_mask_bad_beams(tmp_path):
    majors = np.array([1.0, 1.01, 5.0, 1.02], dtype="f4")
    path, _ = make_vr_cube_file(tmp_path, major_arcsec=majors)
    tc, jc = _read_both(path)
    good = tc.identify_bad_beams(threshold=0.5)
    assert list(good) == [True, True, False, True]
    np.testing.assert_array_equal(good, jc.identify_bad_beams(0.5))
    tm, jm = tc.mask_out_bad_beams(0.5), jc.mask_out_bad_beams(0.5)
    assert np.isnan(tm._get_filled_data().numpy()[2]).all()
    np.testing.assert_array_equal(tm.goodbeams_mask, jm.goodbeams_mask)
    np.testing.assert_array_equal(tm.get_mask_array(),
                                  np.asarray(jm.get_mask_array()))


def test_average_and_common_beams(vr_pair):
    tc, jc, _ = vr_pair
    _same_beams([tc.average_beams()], [jc.average_beams()])
    _same_beams([tc.average_beams(mask=None)], [jc.average_beams(mask=None)])
    cb = tc.common_beam()
    _same_beams([cb], [jc.common_beam()])
    for b in tc.beams:
        cb.deconvolve(b)
    with pytest.raises(ValueError):
        tc.average_beams(threshold=0.01)


def test_spectral_interpolate_and_smooth_raise(vr_pair):
    tc, _, _ = vr_pair
    with pytest.raises(AttributeError):
        tc.spectral_interpolate(T.Quantity(np.array([-321.0, -320.0]),
                                           "km / s"))
    with pytest.raises(AttributeError):
        tc.spectral_smooth(np.ones(3) / 3)


def test_with_beams(vr_pair):
    tc, jc, _ = vr_pair
    nb = T.Beams(major=T.Quantity([2, 2, 2, 2], "arcsec"))
    with pytest.raises(BeamUnitsError):
        tc.with_beams(nb)
    with pytest.raises(ValueError, match="same size"):
        tc.with_beams(T.Beams(major=T.Quantity([2, 2], "arcsec")),
                      raise_error_jybm=False)
    out = tc.with_beams(nb, raise_error_jybm=False)
    jout = jc.with_beams(J.Beams(major=J.Quantity([2, 2, 2, 2], "arcsec")),
                         raise_error_jybm=False)
    assert out.unmasked_beams[0].major.to_value("arcsec") == \
        pytest.approx(2.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_allclose(out.moment0().value,
                                   np.asarray(jout.moment0().value),
                                   rtol=1e-5)


def test_header_hdulist_and_pixels_per_beam(vr_pair):
    tc, jc, _ = vr_pair
    assert tc.header["CASAMBM"] is True
    assert "BMAJ" not in tc.header
    hdus = tc.hdulist
    assert [getattr(h, "name", "") for h in hdus[1:]] == ["BEAMS"]
    assert hdus[1].header["NCHAN"] == 4 and hdus[1].header["NPOL"] == 1
    mc, jm = (c.mask_channels([True, False, True, True]) for c in (tc, jc))
    np.testing.assert_allclose(mc.pixels_per_beam, jm.pixels_per_beam,
                               rtol=1e-12)
    assert len(mc.pixels_per_beam) == 3
    np.testing.assert_array_equal(mc.goodbeams_mask, jm.goodbeams_mask)
    np.testing.assert_array_equal(mc.get_mask_array(),
                                  np.asarray(jm.get_mask_array()))


def test_mask_channels_single_beam(tmp_path):
    """BaseSpectralCube.mask_channels (the JAX package's cube.py:594-604)
    on a single-beam cube, and its argument checks."""
    path, _ = make_vr_cube_file(tmp_path)
    h = base_header(nx=2, ny=3, nchan=4)
    p = str(tmp_path / "sb.fits")
    write_fits(p, [HDU(data=np.arange(24.0).reshape(4, 3, 2), header=h)])
    tc, jc = _read_both(p)
    good = [True, False, False, True]
    np.testing.assert_array_equal(
        tc.mask_channels(good)._get_filled_data().numpy(),
        np.asarray(jc.mask_channels(good)._get_filled_data()))
    with pytest.raises(ValueError, match="one-dimensional"):
        tc.mask_channels([[True]])
    with pytest.raises(ValueError, match="length"):
        tc.mask_channels([True, False])


# -- FITS (tests/test_io.py) -----------------------------------------------

def test_write_read_roundtrip_both_ways(vr_pair, tmp_path):
    tc, jc, data = vr_pair
    tc.write(str(tmp_path / "t.fits"))
    jback = J.SpectralCube.read(str(tmp_path / "t.fits"))
    assert isinstance(jback, J.VaryingResolutionSpectralCube)
    _same_beams(jback.unmasked_beams, [
        J.Beam(b.major_rad, b.minor_rad, b.pa_rad)
        for b in tc.unmasked_beams])
    np.testing.assert_array_equal(np.asarray(jback._data),
                                  tc._data.numpy())
    jc.write(str(tmp_path / "j.fits"))
    tback = T.SpectralCube.read(str(tmp_path / "j.fits"), device="cpu")
    assert isinstance(tback, T.VaryingResolutionSpectralCube)
    np.testing.assert_allclose(tback.unmasked_beams.major.value,
                               jc.unmasked_beams.major.value, rtol=1e-6)


def test_beam_table_units_honored():
    """TUNITn: AIPS writes degrees (reference regression #737); a
    unitless table defaults to arcsec/arcsec/deg."""
    from spectral_cube_tpu_torch.cube import _beams_from_bintable
    from spectral_cube_tpu.cube import _beams_from_bintable as j_from
    bt = _beams_table([1.0, 1.5], [0.8, 1.2], [0.0, 10.0])
    for units in ({"BMAJ": "deg", "BMIN": "deg", "BPA": "deg"}, {}):
        bt.units = units
        tb, jb = _beams_from_bintable(bt), j_from(bt)
        _same_beams(tb, jb)
    np.testing.assert_allclose(tb.major.to_value("arcsec"), [1.0, 1.5],
                               rtol=1e-6)


@pytest.mark.parametrize("beams", [False, True])
def test_4d_degenerate_stokes_reads_as_3d(tmp_path, beams):
    """A 4-D file with one Stokes plane returns that plane's cube: a
    VaryingResolutionSpectralCube when it has a BEAMS table (the shared
    NPOL=1 rows), else a SpectralCube (tests/test_io.py:162-172)."""
    path = tmp_path / "s1.fits"
    data = write_vr(path, shape=(5, 12, 14), stokes=True)
    if not beams:
        from spectral_cube_tpu.io.fits_low import read_fits
        img = read_fits(str(path))[0]
        img.header["BMAJ"] = 6.0 / 3600
        img.header["BMIN"] = 4.5 / 3600
        img.header["BPA"] = 30.0
        path = tmp_path / "s1_single.fits"
        write_fits(str(path), [HDU(data=np.asarray(img.data),
                                   header=img.header)])
    tc, jc = _read_both(str(path))
    cls = T.VaryingResolutionSpectralCube if beams else T.SpectralCube
    assert type(tc) is cls
    assert type(jc).__name__ == cls.__name__
    np.testing.assert_array_equal(tc._data.numpy(), data)
    np.testing.assert_array_equal(tc._data.numpy(), np.asarray(jc._data))
    assert tc.wcs.naxis == 3
    np.testing.assert_array_equal(tc.spectral_axis.value,
                                  jc.spectral_axis.value)
    if beams:
        _same_beams(tc.unmasked_beams, jc.unmasked_beams)
    else:
        assert tc.beam.major_rad == jc.beam.major_rad


def _stokes_file(tmp_path, crval4, cdelt4=1.0, beam_rows=None):
    rng = np.random.RandomState(3)
    data4 = rng.rand(2, 4, 3, 2).astype(np.float32)
    h = base_header(beam=beam_rows is None)
    h["BITPIX"] = -32
    h["NAXIS"], h["NAXIS4"] = 4, 2
    h["CTYPE4"], h["CRVAL4"], h["CDELT4"], h["CRPIX4"] = \
        "STOKES", crval4, cdelt4, 1.0
    hdus = [HDU(data=data4, header=h)]
    if beam_rows is not None:
        hdus.append(beam_rows)
    path = str(tmp_path / f"stokes{crval4}.fits")
    write_fits(path, hdus)
    return path, data4


def test_read_stokes_extracts_I_with_warning(tmp_path):
    """SpectralCube.read of a 4-D Stokes file returns the I component with
    a StokesWarning (reference io/core.py:175-192); io.read_cube returns
    the StokesSpectralCube, as the JAX package's does."""
    from spectral_cube_tpu_torch.io import read_cube
    from spectral_cube_tpu.io import read_cube as jread_cube
    path, data4 = _stokes_file(tmp_path, 1.0)
    with pytest.warns(StokesWarning, match="I component"):
        tc = T.SpectralCube.read(path, device="cpu")
    np.testing.assert_array_equal(tc._data.numpy(), data4[0])
    ts, js = read_cube(path, device="cpu"), jread_cube(path)
    assert isinstance(ts, T.StokesSpectralCube)
    assert ts.components == js.components == ["I", "Q"]
    for k in ts.components:
        np.testing.assert_array_equal(ts[k]._data.numpy(),
                                      np.asarray(js[k]._data))


def test_read_stokes_without_I_raises(tmp_path):
    path, _ = _stokes_file(tmp_path, -5.0, -1.0)   # XX, YY
    with pytest.raises(ValueError, match="does not have an I component"):
        T.SpectralCube.read(path, device="cpu")
    with pytest.raises(ValueError, match="does not have an I component"):
        J.SpectralCube.read(path)


def test_4d_stokes_with_per_pol_beams(tmp_path):
    """A BEAMS table with NPOL=2 gives each Stokes plane its own rows
    (POL column); SpectralCube.read's I component takes POL 0's."""
    bt = _beams_table([1.0, 1.1, 1.2, 1.3], [0.8, 0.9, 1.0, 1.1],
                      [0.0] * 4, npol=2)
    bt.columns["BMAJ"][4:] *= 2.0
    path, data4 = _stokes_file(tmp_path, 1.0, beam_rows=bt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tc = T.SpectralCube.read(path, device="cpu")
        js = J.StokesSpectralCube.read(path)
    assert isinstance(tc, T.VaryingResolutionSpectralCube)
    _same_beams(tc.unmasked_beams, js["I"].unmasked_beams)
    np.testing.assert_allclose(tc.unmasked_beams.major.to_value("arcsec"),
                               [1.0, 1.1, 1.2, 1.3], rtol=1e-6)
    np.testing.assert_array_equal(tc._data.numpy(), data4[0])


# -- convolution ------------------------------------------------------------

def _route_case(tmp_path, pa, groups, nan_beams=()):
    path = tmp_path / "vr.fits"
    write_vr(path, shape=(8, 30, 34), pa=pa, groups=groups,
             nan_beams=nan_beams)
    return _read_both(str(path))


@pytest.mark.parametrize("case", ["separable", "fft", "fft_nan_beams"])
def test_convolve_to_routes_match_jax(tmp_path, case):
    """PA 0 beams in 2-channel groups deconvolve to rank-1 kernels: the
    per-channel separable route (kernel 2).  Beams at PA 30-34 deg give
    rank-5 kernels: the FFT route.  Channels with NaN beams are NaN."""
    pa, groups = ((0.0, 0.0), 2) if case == "separable" else ((30.0, 34.0),
                                                              1)
    nan_beams = (3,) if case == "fft_nan_beams" else ()
    tc, jc = _route_case(tmp_path, pa, groups, nan_beams)
    target = 12.0 if case == "separable" else None
    if target is None:
        tt, jt = tc.common_beam(), jc.common_beam()
    else:
        tt = T.Beam(T.Quantity(12.0, "arcsec"), T.Quantity(12.0, "arcsec"),
                    T.Quantity(0, "deg"))
        jt = J.Beam(J.Quantity(12.0, "arcsec"), J.Quantity(12.0, "arcsec"),
                    J.Quantity(0, "deg"))
    K.reset_launch_counts()
    tout = tc.convolve_to(tt)
    last = tconv.convolve_cube_to_beam.last
    jout = jc.convolve_to(jt)
    assert isinstance(tout, T.SpectralCube)
    assert tout.beam.major_rad == jout.beam.major_rad
    assert last["route"] == ("per_channel_separable" if case == "separable"
                             else "fft")
    # a NaN beam's channel takes the target (the common beam, channel 7's)
    assert last["groups"] == {"separable": 4, "fft": 8,
                              "fft_nan_beams": 7}[case]
    got, ref = tout._data.numpy(), np.asarray(jout._data)
    for c in nan_beams:
        assert np.isnan(got[c]).all()
    data = tc._get_filled_data(fill=np.nan).numpy()
    pix = np.radians(PIX_DEG)
    beams = [b if good else tt
             for b, good in zip(tc.unmasked_beams, tc.goodbeams_mask)]
    kernels = [None if tt.deconvolve(b).major_rad <= 0
               else tt.deconvolve(b).as_kernel(pix) for b in beams]
    scale = float(np.nanmax(np.abs(data)))
    if case == "separable":
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        fin = ~np.isnan(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=0,
                                   atol=1e-6 * float(np.abs(ref[fin]).max()))
    else:
        den = _den64(data, kernels, np.arange(len(kernels)))
        # the Jy/beam factors rescale values; the tolerance follows them
        assert_fft_close(got, ref, den, scale * max(1.0, float(np.nanmax(
            np.abs(ref)) / scale)))
    np.testing.assert_array_equal(tout.get_mask_array(),
                                  np.asarray(jout.get_mask_array()))
    assert all(n == 0 for n in K.launch_counts().values())


def test_convolve_to_allow_smaller_passes_channels_through(tmp_path):
    path, data = make_vr_cube_file(tmp_path, shape=(4, 16, 16))
    tc, jc = _read_both(path)
    majs = tc.unmasked_beams.major.to_value("arcsec").copy()
    majs[1] = majs.max() * 3.0
    tc = tc.with_beams(T.Beams(major=T.Quantity(majs, "arcsec")),
                       raise_error_jybm=False)
    jc = jc.with_beams(J.Beams(major=J.Quantity(majs, "arcsec")),
                       raise_error_jybm=False)
    tt = tc.unmasked_beams[0].convolve(tc.unmasked_beams[0])
    jt = jc.unmasked_beams[0].convolve(jc.unmasked_beams[0])
    with pytest.raises(BeamError):
        tc.convolve_to(tt)
    tout = tc.convolve_to(tt, allow_smaller=True)
    jout = jc.convolve_to(jt, allow_smaller=True)
    got = tout._data.numpy()
    np.testing.assert_allclose(got[1], data[1].astype(np.float32),
                               rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jout._data), rtol=1e-5,
                               atol=1e-6)


def test_convolve_to_nan_beam_warns_once(tmp_path):
    path, _ = make_vr_cube_file(tmp_path, shape=(5, 8, 8))
    tc, _ = _read_both(path)
    majs = tc.unmasked_beams.major.to_value("arcsec").copy()
    majs[2] = np.nan
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        vr2 = tc.with_beams(T.Beams(major=T.Quantity(majs, "arcsec")),
                            raise_error_jybm=False)
        derived = vr2.with_fill_value(0.0)
    assert sum("Non-finite" in str(w.message) for w in rec) == 1
    assert not derived.get_mask_array()[2].any()
    out = vr2.convolve_to(vr2.common_beam())
    a = out._data.numpy()
    assert np.isnan(a[2]).all() and np.isfinite(a[0]).any()


# -- the pipeline -------------------------------------------------------------

@pytest.mark.parametrize("route", ["separable", "fft"])
def test_run_pipeline_vrsc_matches_jax(tmp_path, route):
    """run_pipeline on a varying-resolution cube read from a degenerate
    4-D file: the common beam (no target beam given), SNR mask, moments,
    statistics and a reprojection onto the grid rotated by 3 deg, both
    packages (the JAX one on a one-device mesh).  No NaN border here: the
    common beam's deconvolution kernels are sub-pixel, so at a border
    voxel the normalized convolution divides by a denominator near its
    1e-6 floor and the two packages' float32 roundings part
    (test_convolve_to_routes_match_jax holds that case, den-weighted)."""
    path = tmp_path / "vr4.fits"
    pa, groups = ((0.0, 0.0), 2) if route == "separable" else ((30.0, 34.0),
                                                               1)
    write_vr(path, shape=(12, 30, 34), pa=pa, groups=groups, stokes=True,
             border=False)
    tc, jc = _read_both(str(path))
    assert isinstance(tc, T.VaryingResolutionSpectralCube)
    conv = tc.convolve_to(tc.common_beam())
    assert tconv.convolve_cube_to_beam.last["route"] == (
        "per_channel_separable" if route == "separable" else "fft")
    from test_torch_pipeline import _assert_cubes, _assert_linewidth, \
        _gap_threshold
    noise = _gap_threshold(conv._data.numpy())
    K.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = J.run_pipeline(jc, CubeMesh(devices=jax.devices()[:1]),
                              snr_threshold=1.0,
                              target_header=_rotated(jc.header, 3.0),
                              noise_estimate=noise)
        tres = T.run_pipeline(tc, snr_threshold=1.0,
                              target_header=_rotated(tc.header, 3.0),
                              noise_estimate=noise)
    m0t, m1t, lwt = (np.asarray(x.value) for x in tres["moments"])
    m0j, m1j, lwj = (np.asarray(x.value) for x in jres["moments"])
    assert np.array_equal(np.isnan(m0t), np.isnan(m0j))
    fin = np.isfinite(m0j)
    assert fin.sum() > 100
    np.testing.assert_allclose(m0t[fin], m0j[fin], rtol=3e-5, atol=1e-6)
    assert np.array_equal(np.isfinite(m1t), np.isfinite(m1j))
    fin = np.isfinite(m1j)
    np.testing.assert_allclose(m1t[fin], m1j[fin], rtol=3e-5, atol=1e-4)
    _assert_linewidth(lwt, lwj)
    assert tres["statistics"]["npts"] == jres["statistics"]["npts"]
    for key in ("mean", "sigma", "sum", "max", "min", "rms", "sumsq"):
        np.testing.assert_allclose(float(tres["statistics"][key].value),
                                   float(jres["statistics"][key].value),
                                   rtol=2e-5, atol=1e-7)
    _assert_cubes(tres["cube"]._data.numpy(), jres["cube"]._data, 1e-5)
    assert all(n == 0 for n in K.launch_counts().values())


def test_run_pipeline_vrsc_nan_beams(tmp_path):
    """Flagged planes (NaN beams) come out NaN from the common-beam
    convolution, and the pipeline runs past them; its convolution equals
    the JAX package's VaryingResolutionSpectralCube.convolve_to."""
    path = tmp_path / "vr.fits"
    write_vr(path, shape=(10, 24, 26), nan_beams=(4, 5))
    tc, jc = _read_both(str(path))
    tres = T.run_pipeline(tc, snr_threshold=2.0)
    out = tres["cube"]._data.numpy()
    assert np.isnan(out[4:6]).all()
    jconv = jc.convolve_to(jc.common_beam())
    data = tc._get_filled_data(fill=np.nan).numpy()
    cb = tc.common_beam()
    pix = np.radians(PIX_DEG)
    kernels = [None if not g or cb.deconvolve(b).major_rad <= 0
               else cb.deconvolve(b).as_kernel(pix)
               for b, g in zip(tc.unmasked_beams, tc.goodbeams_mask)]
    assert_fft_close(out, np.asarray(jconv._data),
                     _den64(data, kernels, np.arange(10)),
                     float(np.nanmax(np.abs(out))))
    assert np.isfinite(tres["moments"][0].value).any()


def test_cube_from_arrays_carries_jax_vrsc(tmp_path):
    path = tmp_path / "vr.fits"
    write_vr(path, shape=(6, 16, 18), nan_beams=(2,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jc = J.SpectralCube.read(str(path))
        tc = cube_from_arrays(np.asarray(jc._data), jc.header,
                              beams=jc.unmasked_beams,
                              goodbeams_mask=jc.goodbeams_mask, device="cpu")
    assert isinstance(tc, T.VaryingResolutionSpectralCube)
    np.testing.assert_array_equal(tc.goodbeams_mask, jc.goodbeams_mask)
    _same_beams(tc.unmasked_beams, jc.unmasked_beams)
    _same_beams([tc.common_beam()], [jc.common_beam()])


# -- Projection ------------------------------------------------------------

def _projection_pair(tmp_path):
    path = tmp_path / "p.fits"
    write_vr(path, shape=(3, 26, 30))
    tc, jc = _read_both(str(path))
    tb = tc.unmasked_beams[0]
    jb = jc.unmasked_beams[0]
    img = tc._data.numpy()[1].copy()
    img[5, 6] = np.nan
    wcs_t, wcs_j = tc.wcs.celestial, jc.wcs.celestial
    tp = T.Projection(img, unit=tc.unit, wcs=wcs_t, beam=tb)
    jp = J.Projection(img, unit=jc.unit, wcs=wcs_j, beam=jb)
    return tc, jc, tp, jp


def test_projection_convolve_to_matches_jax(tmp_path):
    tc, jc, tp, jp = _projection_pair(tmp_path)
    tt = T.Beam(T.Quantity(10.0, "arcsec"), T.Quantity(8.0, "arcsec"),
                T.Quantity(20, "deg"))
    jt = J.Beam(J.Quantity(10.0, "arcsec"), J.Quantity(8.0, "arcsec"),
                J.Quantity(20, "deg"))
    got = tp.convolve_to(tt, device="cpu")
    ref = jp.convolve_to(jt)
    assert isinstance(got, T.Projection)
    assert got.beam.major_rad == ref.beam.major_rad
    assert str(got.unit) == str(ref.unit)
    k = tt.deconvolve(tp.beam).as_kernel(np.radians(PIX_DEG))
    img = np.asarray(tp.value)[None]
    den = _den64(img, [k], np.zeros(1, np.int64))[0]
    assert_fft_close(np.asarray(got.value), np.asarray(ref.value), den,
                     float(np.nanmax(np.abs(np.asarray(ref.value)))))


@pytest.mark.parametrize("order", ["bilinear", "nearest-neighbor"])
def test_projection_reproject_matches_jax(tmp_path, order):
    tc, jc, tp, jp = _projection_pair(tmp_path)
    th = _rotated(tc.header, 3.0)
    jh = _rotated(jc.header, 3.0)
    got = tp.reproject(th, order=order, device="cpu")
    ref = jp.reproject(jh, order=order)
    assert isinstance(got, T.Projection)
    g, r = np.asarray(got.value), np.asarray(ref.value)
    assert g.shape == r.shape
    assert np.array_equal(np.isnan(g), np.isnan(r))
    fin = ~np.isnan(r)
    np.testing.assert_allclose(g[fin], r[fin], atol=5e-6)
    assert got.beam is tp.beam
