"""Torch port, the analysis pipeline and the cube methods on its path,
against the JAX package.

Both packages read the same FITS file (or, through
``interop.cube_from_arrays``, the same host state); the port runs on CPU
tensors, where every kernel wrapper takes its plain PyTorch version.  The
pipeline tolerances are the JAX package's own for its sharded pipeline
against the single-device chain (test_parallel.py:779-788): mom0 3e-5,
mom1 3e-5 / 1e-4 absolute, linewidth 1e-4, statistics 2e-5, NaN patterns
exact.  The SNR threshold sits in a gap of the convolved values, so a
voxel within rounding of it cannot flip between the two convolutions.
"""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu.parallel import CubeMesh
from spectral_cube_tpu.io.fits_low import HDU, write_fits

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.interop import cube_from_arrays
from spectral_cube_tpu_torch.ops.regrid import reproject_image

from conftest import base_header

REPO = Path(__file__).resolve().parent.parent
PIX_DEG = 2.0 / 3600.0


def _write_cube(path, shape=(16, 30, 36), seed=0):
    """A Gaussian line on noise with a NaN border (a primary-beam cutoff)
    and an elliptical, rotated beam; float32 on disk."""
    nchan, ny, nx = shape
    rng = np.random.RandomState(seed)
    v = np.arange(nchan)
    yy, xx = np.mgrid[0:ny, 0:nx]
    amp = 3.0 * np.exp(-0.5 * (((yy - ny / 2) / 6.0) ** 2
                               + ((xx - nx / 2) / 8.0) ** 2))
    centre = nchan / 2 + 2.0 * (xx - nx / 2) / nx
    data = amp[None] * np.exp(-0.5 * ((v[:, None, None] - centre[None])
                                      / 2.0) ** 2)
    data = (data + 0.3 * rng.randn(nchan, ny, nx)).astype(np.float32)
    r2 = ((yy - ny / 2) / (0.48 * ny)) ** 2 + ((xx - nx / 2) / (0.48 * nx)) ** 2
    data[:, r2 > 1.0] = np.nan
    data[3, 10, 12] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan)
    h["BITPIX"] = -32
    h["CDELT1"] = -PIX_DEG
    h["CDELT2"] = PIX_DEG
    h["CRPIX1"] = nx / 2
    h["CRPIX2"] = ny / 2
    h["BMAJ"] = 6.0 / 3600.0
    h["BMIN"] = 4.5 / 3600.0
    h["BPA"] = 30.0
    write_fits(str(path), [HDU(data=data, header=h)])
    return data


@pytest.fixture
def fits_path(tmp_path):
    p = tmp_path / "line.fits"
    _write_cube(p)
    return p


def _beams(major, minor, pa):
    return (J.Beam(J.Quantity(major, "arcsec"), J.Quantity(minor, "arcsec"),
                   J.Quantity(pa, "deg")),
            T.Beam(T.Quantity(major, "arcsec"), T.Quantity(minor, "arcsec"),
                   T.Quantity(pa, "deg")))


def _gap_threshold(values, lo_q=60.0, hi_q=80.0):
    """Midpoint of the widest gap between sorted finite values in a
    quantile band: no value lies within rounding of it."""
    v = np.sort(values[np.isfinite(values)].astype(np.float64))
    lo, hi = np.searchsorted(v, np.percentile(v, [lo_q, hi_q]))
    i = lo + int(np.argmax(np.diff(v[lo:hi])))
    assert (v[i + 1] - v[i]) > 1e-5 * abs(v[i])
    return 0.5 * (v[i] + v[i + 1])


def _shifted(header, dx=0.37, dy=-0.61):
    h = header.__class__(header)
    h["CRPIX1"] = float(h["CRPIX1"]) + dx
    h["CRPIX2"] = float(h["CRPIX2"]) + dy
    return h


def _assert_cubes(t, j, atol):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    assert np.array_equal(np.isnan(t), np.isnan(j))
    fin = ~np.isnan(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=1e-5, atol=atol)


def _assert_linewidth(t, j, rtol=1e-4, atol=1e-4):
    """Linewidths agree where finite, with equal NaN patterns: a spaxel
    with one included channel has linewidth 0 in both packages."""
    t, j = np.asarray(t), np.asarray(j)
    assert np.array_equal(np.isfinite(t), np.isfinite(j))
    both = np.isfinite(t)
    np.testing.assert_allclose(t[both], j[both], rtol=rtol, atol=atol)


def test_run_pipeline_matches_jax(fits_path):
    """read -> convolve_to (elliptical target) -> SNR mask -> moments +
    statistics -> reproject (translated target), both packages."""
    jbeam, tbeam = _beams(12.0, 10.0, 10.0)
    K.reset_launch_counts()
    tcube = T.SpectralCube.read(str(fits_path), device="cpu")
    jcube = J.SpectralCube.read(str(fits_path))
    conv = tcube.convolve_to(tbeam)._data.numpy()
    noise = _gap_threshold(conv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = J.run_pipeline(jcube, CubeMesh(devices=jax.devices()[:1]),
                              snr_threshold=1.0, target_beam=jbeam,
                              target_header=_shifted(jcube.header),
                              noise_estimate=noise)
        tres = T.run_pipeline(tcube, snr_threshold=1.0, target_beam=tbeam,
                              target_header=_shifted(tcube.header),
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
    assert str(tres["moments"][0].unit) == str(jres["moments"][0].unit)
    counts = K.launch_counts()
    assert {"moments", "conv_sep", "resample2"} <= set(counts)
    assert all(n == 0 for n in counts.values()), counts


def test_run_pipeline_noise_from_mad_std(fits_path):
    """Without a noise estimate the threshold comes from mad_std of the
    convolved cube, as in the JAX package."""
    jbeam, tbeam = _beams(12.0, 12.0, 0.0)
    tcube = T.SpectralCube.read(str(fits_path), device="cpu")
    jcube = J.SpectralCube.read(str(fits_path))
    tconv, jconv = tcube.convolve_to(tbeam), jcube.convolve_to(jbeam)
    np.testing.assert_allclose(tconv.mad_std().value, jconv.mad_std().value,
                               rtol=1e-5)
    tres = T.run_pipeline(tcube, snr_threshold=2.0, target_beam=tbeam)
    st = tres["statistics"]
    thr = 2.0 * float(tconv.mad_std().value)
    vals = tconv._data.numpy()
    assert st["npts"] == int(np.sum(vals > np.float32(thr)))
    assert float(st["min"].value) > thr
    assert tres["cube"].shape == tcube.shape


@pytest.mark.parametrize("mask_kind", ["fused", "array", "none"])
def test_cube_moments_and_statistics_match_jax(fits_path, mask_kind):
    tcube = T.SpectralCube.read(str(fits_path), device="cpu")
    jcube = J.SpectralCube.read(str(fits_path))
    thr = _gap_threshold(tcube._data.numpy())
    if mask_kind == "fused":
        tcube = tcube.with_mask(tcube > T.Quantity(thr, tcube.unit))
        jcube = jcube.with_mask(jcube > J.Quantity(thr, jcube.unit))
    elif mask_kind == "array":
        inc = np.asarray(jcube._data) > thr
        tcube, jcube = tcube.with_mask(inc), jcube.with_mask(inc)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in ("moment0", "moment1", "moment2", "linewidth_sigma",
                     "linewidth_fwhm"):
            t = getattr(tcube, name)()
            j = getattr(jcube, name)()
            assert str(t.unit) == str(j.unit)
            if name.startswith("linewidth"):
                _assert_linewidth(t.value, j.value)
            else:
                _assert_cubes(t.value, j.value, 1e-4)
    ts, js = tcube.statistics(), jcube.statistics()
    assert ts["npts"] == js["npts"]
    for key in ("mean", "sigma", "sum", "max", "min", "rms", "sumsq"):
        np.testing.assert_allclose(float(ts[key].value),
                                   float(js[key].value), rtol=2e-5,
                                   atol=1e-7)


def test_cube_reductions_match_jax(fits_path):
    tcube = T.SpectralCube.read(str(fits_path), device="cpu")
    jcube = J.SpectralCube.read(str(fits_path))
    for name, args in (("mad_std", ()), ("median", ()),
                       ("percentile", (25.0,)), ("sum", ()), ("max", ())):
        t = getattr(tcube, name)(*args)
        j = getattr(jcube, name)(*args)
        np.testing.assert_allclose(t.value, float(j.value), rtol=1e-5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t0 = getattr(tcube, name)(*args, axis=0)
            j0 = getattr(jcube, name)(*args, axis=0)
        _assert_cubes(t0.value, j0.value, 1e-5)


def test_cube_accessors_match_jax(fits_path, tmp_path):
    tcube = T.SpectralCube.read(str(fits_path), device="cpu")
    jcube = J.SpectralCube.read(str(fits_path))
    assert tcube.shape == jcube.shape
    assert str(tcube.unit) == str(jcube.unit)
    assert tcube.device == torch.device("cpu")
    np.testing.assert_array_equal(tcube.spectral_axis.value,
                                  jcube.spectral_axis.value)
    np.testing.assert_array_equal(tcube._spectral_offsets(),
                                  jcube._spectral_offsets())
    assert tcube._spectral_pix_size() == jcube._spectral_pix_size()
    assert tcube.beam.major_rad == jcube.beam.major_rad
    np.testing.assert_array_equal(tcube.unmasked_data[:].value,
                                  np.asarray(jcube.unmasked_data[:].value))
    thr = T.Quantity(1.0, tcube.unit)
    tm = tcube.with_mask(tcube > thr).with_fill_value(-5.0)
    jm = jcube.with_mask(jcube > J.Quantity(1.0, jcube.unit)) \
        .with_fill_value(-5.0)
    np.testing.assert_array_equal(tm._get_filled_data().numpy(),
                                  np.asarray(jm._get_filled_data()))
    np.testing.assert_array_equal(tm.get_mask_array(), jm.get_mask_array())
    for key in ("CRPIX1", "CDELT3", "CTYPE3", "BMAJ", "BPA", "BUNIT"):
        assert tcube.header[key] == jcube.header[key]
    out = tmp_path / "port.fits"
    tm.write(str(out))
    back = J.SpectralCube.read(str(out))
    np.testing.assert_array_equal(np.asarray(back._data),
                                  tm._get_filled_data().numpy())
    with pytest.raises(ValueError, match="Quantity"):
        tcube > 1.0


def test_convolve_to_and_reproject_match_jax(fits_path):
    jbeam, tbeam = _beams(12.0, 10.0, 10.0)
    tcube = T.SpectralCube.read(str(fits_path), device="cpu")
    jcube = J.SpectralCube.read(str(fits_path))
    tc, jc = tcube.convolve_to(tbeam), jcube.convolve_to(jbeam)
    _assert_cubes(tc._data.numpy(), jc._data, 1e-5)
    assert tc.beam.major_rad == jc.beam.major_rad
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = tc.reproject(_shifted(tc.header, 1.25, 0.5))
        jr = jc.reproject(_shifted(jc.header, 1.25, 0.5))
    _assert_cubes(tr._data.numpy(), jr._data, 1e-5)
    np.testing.assert_array_equal(tr.get_mask_array(),
                                  np.asarray(jr.get_mask_array()))
    np.testing.assert_allclose(tr.wcs.crpix, jr.wcs.crpix)


def test_cube_from_arrays_carries_jax_state(fits_path):
    """interop: the port's cube from a JAX cube's numpy state (data,
    header cards, include mask, beam) gives the same moments."""
    jcube = J.SpectralCube.read(str(fits_path))
    jcube = jcube.with_mask(jcube > J.Quantity(0.9, jcube.unit))
    tcube = cube_from_arrays(np.asarray(jcube._data), jcube.header,
                             mask=jcube.get_mask_array(), beam=jcube.beam,
                             device="cpu")
    assert tcube.beam.major_rad == jcube.beam.major_rad
    assert str(tcube.unit) == str(jcube.unit)
    np.testing.assert_array_equal(tcube.spectral_axis.value,
                                  jcube.spectral_axis.value)
    _assert_cubes(tcube.moment1().value, jcube.moment1().value, 1e-4)
    assert tcube.statistics()["npts"] == jcube.statistics()["npts"]
    plain = cube_from_arrays(np.asarray(jcube._data), list(
        (k, jcube.header[k]) for k in jcube.header), device="cpu")
    assert plain.get_mask_array().sum() == np.isfinite(
        np.asarray(jcube._data)).sum()


def test_unported_paths_raise(fits_path):
    """``run_pipeline(cmesh=)`` runs sharded over a mesh and gives the
    unsharded results (JAX's single-device mesh run as the reference of
    test_run_pipeline_matches_jax); a FITS file read as a CASA image
    raises as it does in the JAX package."""
    from spectral_cube_tpu.utils import FITSReadError as JFITSReadError
    from spectral_cube_tpu_torch.utils import FITSReadError
    tcube = T.SpectralCube.read(str(fits_path), device="cpu")
    tbeam = _beams(12.0, 12.0, 0.0)[1]
    cmesh = T.CubeMesh(devices=["cpu"] * 4)
    kw = dict(snr_threshold=1.0, target_beam=tbeam,
              target_header=_shifted(tcube.header), noise_estimate=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sharded = T.run_pipeline(tcube, cmesh=cmesh, **kw)
        plain = T.run_pipeline(tcube, **kw)
    assert cmesh.counters["gathers"] == 0
    for a, b in zip(sharded["moments"], plain["moments"]):
        _assert_linewidth(a.value, b.value, rtol=3e-5, atol=1e-4)
    assert sharded["statistics"]["npts"] == plain["statistics"]["npts"]
    _assert_cubes(sharded["cube"].cube._data.numpy(),
                  plain["cube"]._data.numpy(), 1e-6)
    assert isinstance(sharded["cube"], T.ShardedCube)
    with pytest.raises(TypeError, match="cmesh must be a CubeMesh"):
        T.run_pipeline(tcube, cmesh=object())
    with pytest.raises(FITSReadError, match="is not a CASA image directory"):
        T.SpectralCube.read(str(fits_path), format="casa_image",
                            device="cpu")
    with pytest.raises(JFITSReadError,
                       match="is not a CASA image directory"):
        J.SpectralCube.read(str(fits_path), format="casa_image")


def test_entry_points_default_to_cuda(fits_path, monkeypatch):
    """Without a device the entry points put the cube on the CUDA device;
    where CUDA is absent they raise instead of falling back to the CPU.
    A tensor keeps its own device, and an explicit device='cpu' works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.SpectralCube.read(str(fits_path))
    data = np.zeros((4, 5, 6), np.float32)
    h = base_header(nx=6, ny=5, nchan=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cube_from_arrays(data, h)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.SpectralCube(data, T.WCS(header=h), header=h)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reproject_image(data[0], T.WCS(header=h), h)
    cube = T.SpectralCube(torch.as_tensor(data), T.WCS(header=h), header=h)
    assert cube.device == torch.device("cpu")
    assert cube._new_cube_with(data=data + 1).device == torch.device("cpu")
    assert T.SpectralCube.read(str(fits_path), device="cpu").device \
        == torch.device("cpu")
    # the CASA and CLASS loaders and the registry
    from spectral_cube_tpu_torch.io import read_cube
    from spectral_cube_tpu_torch.io.casa_image import load_casa_image
    from spectral_cube_tpu_torch.io.casa_writer import write_casa_image
    from spectral_cube_tpu_torch.io.class_lmv import load_lmv_cube
    from test_io import _build_type2_lmv
    image = str(fits_path) + ".image"
    write_casa_image(T.SpectralCube.read(str(fits_path), device="cpu"),
                     image)
    lmv = str(fits_path) + ".lmv"
    with open(lmv, "wb") as fh:
        fh.write(_build_type2_lmv("<"))
    for call in (lambda: load_casa_image(image), lambda: read_cube(image),
                 lambda: load_lmv_cube(lmv), lambda: read_cube(lmv),
                 lambda: T.StokesSpectralCube.read(image)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for path in (image, lmv):
        assert read_cube(path, device="cpu").device == torch.device("cpu")


def test_port_imports_no_jax():
    code = ("import sys, spectral_cube_tpu_torch; "
            "import spectral_cube_tpu_torch.stokes, "
            "spectral_cube_tpu_torch.lower_dimensional_structures, "
            "spectral_cube_tpu_torch.cube_utils, "
            "spectral_cube_tpu_torch.interop, "
            "spectral_cube_tpu_torch.io.fits, "
            "spectral_cube_tpu_torch.persistence, "
            "spectral_cube_tpu_torch.analysis_utilities, "
            "spectral_cube_tpu_torch.io.casa_image, "
            "spectral_cube_tpu_torch.io.casa_writer, "
            "spectral_cube_tpu_torch.io.casa_masks, "
            "spectral_cube_tpu_torch.io.class_lmv, "
            "spectral_cube_tpu_torch.region, "
            "spectral_cube_tpu_torch.wcs_utils, "
            "spectral_cube_tpu_torch.visualization_tools, "
            "spectral_cube_tpu_torch.ytcube; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'spectral_cube_tpu.'))"
            " or m == 'spectral_cube_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=str(REPO), check=True,
                   timeout=120)
