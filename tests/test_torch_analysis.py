"""Torch port, spectral stacking and Fourier shifting against the JAX
package: ``fourier_shift`` (integer and fractional shifts, NaN, all-NaN,
padding, another axis), ``stack_spectra`` (with and without
``pad_edges``, weights, a custom stack function, a varying-resolution
cube) and ``stack_cube`` (two lines of one cube, a list of cubes, and a
varying-resolution cube with ``convolve_beam``).

Both packages read the same FITS files; the port runs on CPU tensors.
Tolerances: FFT shifts in complex64 within 1e-5 of the largest value; the
NaN pattern equal except at samples whose shifted NaN mask lies within
1e-5 of the 0.5 threshold in the JAX package (counted and reported);
stacked cubes within 1e-5 of the largest value after equal NaN patterns.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import spectral_cube_tpu as J
from spectral_cube_tpu import analysis_utilities as ja
from spectral_cube_tpu.io.fits_low import HDU, write_fits

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import analysis_utilities as ta

from conftest import base_header, make_beams_table


def _jax_mask_shift(x, shift, axis):
    """The shifted NaN mask the JAX package thresholds at 0.5
    (analysis_utilities.py:51-71), per sample of ``x`` moved along
    ``axis``."""
    nanmask = ~np.isfinite(np.moveaxis(x, axis, -1))
    flat = jnp.asarray(nanmask.reshape(-1, nanmask.shape[-1]), jnp.float32)
    m = jnp.fft.fftfreq(flat.shape[1])
    phase = jnp.exp(-2j * np.pi * m[None, :] * jnp.float32(shift))
    ms = np.asarray(jnp.real(jnp.fft.ifft(jnp.fft.fft(flat, axis=1) * phase,
                                          axis=1)))
    return np.moveaxis(ms.reshape(nanmask.shape), -1, axis)


def _assert_shift_equal(got, ref, x, shift, axis):
    """Values within 1e-5 of the largest; NaN patterns equal except where
    the JAX mask lies within 1e-5 of 0.5.  Returns that count."""
    assert got.shape == ref.shape
    flips = np.isnan(got) != np.isnan(ref)
    borderline = 0
    if flips.any():
        ms = _jax_mask_shift(x, shift, axis)
        near = np.abs(ms - 0.5) < 1e-5
        assert not (flips & ~near).any()
        borderline = int(near.sum())
        print(f"{borderline} samples within 1e-5 of the mask threshold, "
              f"{int(flips.sum())} of them flipped")
    both = ~np.isnan(got) & ~np.isnan(ref)
    scale = max(np.abs(ref[both]).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got[both], ref[both], atol=1e-5 * scale)
    return borderline


def _wave(n, seed):
    rng = np.random.RandomState(seed)
    return np.sin(np.linspace(0, 4 * np.pi, n)) + 0.1 * rng.randn(n)


@pytest.mark.parametrize("case", ["integer", "fraction", "nan", "half",
                                  "all_nan", "pad", "pad_size", "axis1"])
def test_fourier_shift_matches_jax(case):
    x, shift, kw = _wave(64, 1), 3.3, {}
    if case == "integer":
        x, shift = np.zeros(32), 5
        x[10] = 1.0
    elif case == "nan":
        x[20] = np.nan
    elif case == "half":
        x[20:23] = np.nan
        shift = 2.5
    elif case == "all_nan":
        x = np.full(16, np.nan)
    elif case == "pad":
        x, shift, kw = np.ones(8), 2.5, {"add_pad": True}
    elif case == "pad_size":
        x[5] = np.nan
        shift, kw = -1.7, {"add_pad": True, "pad_size": (3, 4)}
    elif case == "axis1":
        x = np.stack([_wave(40, s) for s in range(3)])
        x[1, 7] = np.nan
        kw = {"axis": 1}
    got = ta.fourier_shift(x, shift, device="cpu", **kw)
    ref = np.asarray(ja.fourier_shift(x, shift, **kw))
    _assert_shift_equal(got, ref, np.asarray(ja.fourier_shift(
        x, 0, **kw)) if kw.get("add_pad") else x, shift, kw.get("axis", 0))
    if case == "integer":
        assert np.argmax(got) == 15


def _shifted_line_file(tmp_path, nchan=64, ny=4, nx=5, beams=None):
    """test_analysis.py:37-48's cube: a Gaussian line at a known, distinct
    velocity in each spaxel (and a NaN voxel); with ``beams``, a BEAMS
    table of those major axes."""
    rng = np.random.RandomState(0)
    v = np.arange(nchan, dtype=float)
    centers = 20 + 20 * rng.rand(ny, nx)
    data = np.exp(-0.5 * ((v[:, None, None] - centers[None]) / 4.0) ** 2)
    data[30, 1, 2] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan, ctype3="VRAD", cunit3="km/s",
                    crval3=0.0, cdelt3=1.0, beam=beams is None)
    path = str(tmp_path / "shifted.fits")
    hdus = [HDU(data=data, header=h)]
    if beams is not None:
        h["CASAMBM"] = True
        hdus.append(make_beams_table(nchan, beams))
    write_fits(path, hdus)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (T.SpectralCube.read(path, device="cpu"),
                J.SpectralCube.read(path), centers)


def _assert_spectrum_equal(t, j):
    assert type(t).__name__ == type(j).__name__
    a, b = np.asarray(t.value, float), np.asarray(j.value, float)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    both = ~np.isnan(b)
    np.testing.assert_allclose(a[both], b[both],
                               atol=1e-5 * np.abs(b[both]).max())
    assert t.wcs.to_header() == j.wcs.to_header()
    assert t.unit.to_string() == j.unit.to_string()


@pytest.mark.parametrize("pad_edges", [True, False])
def test_stack_spectra_matches_jax(tmp_path, pad_edges):
    tc, jc, centers = _shifted_line_file(tmp_path)
    t = ta.stack_spectra(tc, T.Quantity(centers, "km / s"),
                         v0=T.Quantity(32.0, "km / s"), pad_edges=pad_edges)
    j = ja.stack_spectra(jc, J.Quantity(centers, "km / s"),
                         v0=J.Quantity(32.0, "km / s"), pad_edges=pad_edges)
    _assert_spectrum_equal(t, j)
    assert (t.size > tc.shape[0]) == pad_edges
    sv = np.asarray(t.spectral_axis.value)
    assert sv[np.nanargmax(t.value)] == pytest.approx(32.0, abs=1.0)


def test_stack_spectra_options_match_jax(tmp_path):
    tc, jc, centers = _shifted_line_file(tmp_path)
    w = np.random.RandomState(3).rand(*centers.shape)
    for kw in ({"weights": w}, {"stack_function": np.nanmedian},
               {"xy_posns": (np.array([0, 1, 3]), np.array([4, 2, 0]))},
               {}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = ta.stack_spectra(tc, centers, **kw)
            j = ja.stack_spectra(jc, centers, **kw)
        _assert_spectrum_equal(t, j)
    bad = centers.copy()
    bad[0, 0] = 1e6
    with pytest.warns(T.utils.BadVelocitiesWarning):
        t = ta.stack_spectra(tc, T.Quantity(bad, "km / s"))
    with pytest.warns(J.utils.BadVelocitiesWarning):
        j = ja.stack_spectra(jc, J.Quantity(bad, "km / s"))
    _assert_spectrum_equal(t, j)
    for vel, kw in ((np.full_like(centers, np.nan), {}), (centers[:2], {}),
                    (centers, {"v0": T.Quantity(1e9, "km / s")}),
                    (centers, {"weights": w, "stack_function": np.nanmean})):
        with pytest.raises(ValueError):
            ta.stack_spectra(tc, vel, **kw)


def test_stack_spectra_of_a_vrsc_keeps_its_beams(tmp_path):
    """Unpadded, the stack of a varying-resolution cube keeps its
    per-channel beams.  Padded, it has more channels than beams, which
    the port's spectrum refuses (the reference's length check,
    base_class.py:509-512) where the JAX package builds it."""
    tc, jc, centers = _shifted_line_file(
        tmp_path, beams=np.linspace(1.0, 1.3, 64))
    t = ta.stack_spectra(tc, centers, pad_edges=False)
    j = ja.stack_spectra(jc, centers, pad_edges=False)
    _assert_spectrum_equal(t, j)
    assert [b.major_rad for b in t.unmasked_beams] == \
        [b.major_rad for b in j.unmasked_beams]
    with pytest.raises(ValueError, match="same size"):
        ta.stack_spectra(tc, centers)


def _two_line_file(tmp_path, name="twoline.fits", beams=None, nchan=128,
                   ny=3, nx=3):
    """test_analysis.py:99-125's cube: two Gaussian lines in frequency,
    with ``beams`` a BEAMS table of those major axes (arcsec)."""
    f0, df = 100e9, 1e6
    freqs = f0 + np.arange(nchan) * df
    spec = (np.exp(-0.5 * ((freqs - 100.02e9) / 3e6) ** 2)
            + np.exp(-0.5 * ((freqs - 100.08e9) / 3e6) ** 2))
    rng = np.random.RandomState(4)
    data = spec[:, None, None] * (1 + 0.1 * rng.rand(1, ny, nx))
    h = base_header(nx=nx, ny=ny, nchan=nchan, ctype3="FREQ", cunit3="Hz",
                    crval3=f0, cdelt3=df, beam=beams is None)
    path = str(tmp_path / name)
    hdus = [HDU(data=data, header=h)]
    if beams is not None:
        h["CASAMBM"] = True
        hdus.append(make_beams_table(nchan, beams))
    write_fits(path, hdus)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (T.SpectralCube.read(path, device="cpu"),
                J.SpectralCube.read(path))


def _assert_stacked_equal(t, j):
    assert type(t).__name__ == type(j).__name__
    assert t.shape == j.shape
    a, b = t.unitless_filled_data[:], np.asarray(j.filled_data[:].value)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    both = ~np.isnan(b)
    np.testing.assert_allclose(a[both], b[both],
                               atol=1e-5 * np.abs(b[both]).max())
    assert t.wcs.to_header() == j.wcs.to_header()
    assert [float(v.value) for v in t.meta["stacked_lines"]] == \
        [float(v.value) for v in j.meta["stacked_lines"]]


def _lines(Q):
    return [Q(100.02e9, "Hz"), Q(100.08e9, "Hz"), Q(90e9, "Hz")]


def test_stack_cube_two_lines_matches_jax(tmp_path):
    tc, jc = _two_line_file(tmp_path)
    t = ta.stack_cube(tc, _lines(T.Quantity), vmin=T.Quantity(-40, "km / s"),
                      vmax=T.Quantity(40, "km / s"))
    j = ja.stack_cube(jc, _lines(J.Quantity), vmin=J.Quantity(-40, "km / s"),
                      vmax=J.Quantity(40, "km / s"))
    _assert_stacked_equal(t, j)
    assert len(t.meta["stacked_lines"]) == 2
    sv = np.asarray(t.spectral_axis.value)
    assert abs(sv[np.nanargmax(t.unitless_filled_data[:, 1, 1])]) < 5.0
    t, tcut = ta.stack_cube([tc, tc], _lines(T.Quantity)[:2],
                            vmin=T.Quantity(-40, "km / s"),
                            vmax=T.Quantity(40, "km / s"),
                            average=np.nanmedian, return_cutouts=True)
    j, jcut = ja.stack_cube([jc, jc], _lines(J.Quantity)[:2],
                            vmin=J.Quantity(-40, "km / s"),
                            vmax=J.Quantity(40, "km / s"),
                            average=np.nanmedian, return_cutouts=True)
    _assert_stacked_equal(t, j)
    assert len(tcut) == len(jcut) == 4
    with pytest.raises(ValueError):
        ta.stack_cube(tc, [T.Quantity(50e9, "Hz")],
                      vmin=T.Quantity(-40, "km / s"),
                      vmax=T.Quantity(40, "km / s"))


def test_stack_cube_of_a_vrsc_convolves_to_the_beam(tmp_path):
    """A varying-resolution cube's slabs are convolved to
    ``convolve_beam`` (the port's convolution routes) before stacking."""
    tc, jc = _two_line_file(tmp_path, beams=np.linspace(1.0, 1.6, 128),
                            ny=12, nx=14)
    kw = dict(vmin=(-40, "km / s"), vmax=(40, "km / s"))

    def run(mod, Q, cube, beam):
        return mod.stack_cube(cube, _lines(Q), vmin=Q(*kw["vmin"]),
                              vmax=Q(*kw["vmax"]), convolve_beam=beam)

    tb = T.Beam(T.Quantity(5.0, "arcsec"), T.Quantity(4.0, "arcsec"),
                T.Quantity(20.0, "deg"))
    jb = J.Beam(J.Quantity(5.0, "arcsec"), J.Quantity(4.0, "arcsec"),
                J.Quantity(20.0, "deg"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t, j = run(ta, T.Quantity, tc, tb), run(ja, J.Quantity, jc, jb)
    _assert_stacked_equal(t, j)
    assert t.beam.major_rad == pytest.approx(tb.major_rad)
    with pytest.raises(ValueError, match="convolve_beam"):
        run(ta, T.Quantity, tc, None)
    with pytest.raises(ValueError, match="convolve_beam"):
        ta.stack_cube([tc, tc], _lines(T.Quantity), vmin=T.Quantity(-40,
                      "km / s"), vmax=T.Quantity(40, "km / s"))


def test_get_chunks_matches_jax():
    for n, c in ((10, 3), (9, 3), (5, 5), (4, 7)):
        a, b = ta.get_chunks(n, c), ja.get_chunks(n, c)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
