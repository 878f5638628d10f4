"""Torch port, host layer: the modules copied from the JAX package (units,
beams, WCS, FITS I/O with tile compression) held against the same oracles
and against the JAX package's own results.

The WCS projections meet the independent 40-digit golden table at the JAX
tests' 1e-10 / 1e-9 (test_wcs_golden.py); the CFITSIO-written compressed
fixtures decode bit for bit (test_tile_compress.py:198); beam algebra and
unit conversions equal the JAX package's to 1e-12.
"""

import json
import os

import numpy as np
import pytest

import spectral_cube_tpu as J
from spectral_cube_tpu.io.fits_low import HDU, write_fits

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.io.fits_low import read_fits
from spectral_cube_tpu_torch.wcs import projections as prj

from conftest import base_header, make_vr_cube_file

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "data", "wcs_golden.json")) as f:
    GOLDEN = json.load(f)
_FIXDIR = os.path.join(HERE, "data", "compressed")


def _entry_pv(entry):
    if entry.get("pv_from_m0"):
        return {m: v for m, v in enumerate(entry["pv"])}
    return tuple(entry["pv"])


@pytest.mark.parametrize("code", sorted(GOLDEN["projections"]))
def test_projection_roundtrip_vs_golden(code):
    entry = GOLDEN["projections"][code]
    pv = _entry_pv(entry)
    for p in entry["points"]:
        x, y = prj.proj_native2xy(code.split(":")[0], np.float64(p["phi"]),
                                  np.float64(p["theta"]), pv=pv)
        assert abs(float(x) - float(p["x"])) < 1e-10, (code, p)
        assert abs(float(y) - float(p["y"])) < 1e-10, (code, p)
        phi, theta = prj.proj_xy2native(code.split(":")[0],
                                        np.float64(p["x"]),
                                        np.float64(p["y"]), pv=pv)
        dphi = (float(phi) - p["phi"] + 180.0) % 360.0 - 180.0
        if abs(p["theta"]) < 90 - 1e-9:
            assert abs(dphi) < 1e-9, (code, p)
        assert abs(float(theta) - p["theta"]) < 1e-9, (code, p)


@pytest.mark.parametrize("name", ["rice_d1", "rice_d2", "gzip2_nod",
                                  "rice_int32", "gzip1_lossless"])
def test_cfitsio_fixture_decodes_bit_exact(name):
    expected = np.load(os.path.join(_FIXDIR, f"{name}_expected.npy"))
    imgs = [h for h in read_fits(os.path.join(_FIXDIR, f"{name}.fits"))
            if getattr(h, "is_image", False) and h.data is not None]
    assert len(imgs) == 1
    got = np.asarray(imgs[0].data).astype(expected.dtype)
    e64 = expected.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(got.astype(np.float64)),
                                  np.isnan(e64))
    fin = ~np.isnan(e64)
    np.testing.assert_array_equal(got[fin], expected[fin])


@pytest.mark.parametrize("ctype3,cunit3,crval3,cdelt3", [
    ("VRAD", "km/s", -321.2, 1.28), ("FREQ", "Hz", 1.42e9, -2.5e4),
    ("VOPT", "m/s", 1.2e5, 850.0)])
def test_wcs_pixel_world_matches_jax(ctype3, cunit3, crval3, cdelt3):
    h = base_header(nx=9, ny=7, nchan=5, ctype3=ctype3, cunit3=cunit3,
                    crval3=crval3, cdelt3=cdelt3)
    jw, tw = J.WCS(header=h), T.WCS(header=dict(h.items()))
    px = np.array([0.0, 3.5, 8.0])
    py = np.array([0.0, 2.25, 6.0])
    pz = np.array([0.0, 1.5, 4.0])
    for a, b in zip(tw.pix2world(px, py, pz), jw.pix2world(px, py, pz)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(tw.spectral_axis_values(5),
                               jw.spectral_axis_values(5), rtol=1e-12)
    assert str(tw.spectral_unit) == str(jw.spectral_unit)


def test_beam_algebra_matches_jax():
    args = [(6.0, 4.5, 30.0), (12.0, 10.0, 10.0), (3.0, 3.0, 0.0)]
    jb = [J.Beam(J.Quantity(a, "arcsec"), J.Quantity(b, "arcsec"),
                 J.Quantity(c, "deg")) for a, b, c in args]
    tb = [T.Beam(T.Quantity(a, "arcsec"), T.Quantity(b, "arcsec"),
                 T.Quantity(c, "deg")) for a, b, c in args]
    for (j1, t1), (j2, t2) in [((jb[1], tb[1]), (jb[0], tb[0])),
                               ((jb[1], tb[1]), (jb[2], tb[2]))]:
        jd, td = j1.deconvolve(j2), t1.deconvolve(t2)
        np.testing.assert_allclose(
            [td.major_rad, td.minor_rad, td.pa_rad],
            [jd.major_rad, jd.minor_rad, jd.pa_rad], rtol=1e-12, atol=1e-15)
        pix = np.radians(2.0 / 3600.0)
        np.testing.assert_array_equal(td.as_kernel(pix), jd.as_kernel(pix))
        jc, tc = j1.convolve(j2), t1.convolve(t2)
        np.testing.assert_allclose(tc.major_rad, jc.major_rad, rtol=1e-12)
    np.testing.assert_allclose(tb[0].sr.value, jb[0].sr.value, rtol=1e-12)


@pytest.mark.parametrize("src,dst,value", [("km/s", "m/s", 3.5),
                                           ("Jy/beam", "mJy/beam", 0.25),
                                           ("deg", "arcsec", 1e-3),
                                           ("GHz", "Hz", 230.538)])
def test_unit_conversions_match_jax(src, dst, value):
    a = T.Quantity(value, src).to_value(dst)
    b = J.Quantity(value, src).to_value(dst)
    np.testing.assert_allclose(a, b, rtol=1e-15)
    assert T.Unit.parse(src).to_string() == J.Unit.parse(src).to_string()


def test_fits_roundtrip_and_unported_inputs(tmp_path):
    """A cube written by the JAX package reads into the port (orientation,
    mask, beam), writes back, and re-reads unchanged; a varying-beam file
    reads as a VaryingResolutionSpectralCube with the JAX package's beams,
    and a 4-D file with several Stokes components reads through
    ``io.read_cube`` as the JAX package's StokesSpectralCube."""
    rng = np.random.RandomState(1)
    data = rng.rand(4, 5, 6).astype(np.float32)
    data[1, 2, 3] = np.nan
    h = base_header(nx=6, ny=5, nchan=4)
    h["BITPIX"] = -32
    p = str(tmp_path / "c.fits")
    write_fits(p, [HDU(data=data, header=h)])
    cube = T.SpectralCube.read(p, device="cpu")
    np.testing.assert_array_equal(cube.unmasked_data[:].value, data)
    assert cube.get_mask_array().sum() == np.isfinite(data).sum()
    out = str(tmp_path / "back.fits")
    cube.write(out)
    back = T.SpectralCube.read(out, device="cpu")
    np.testing.assert_array_equal(back._data.numpy(), data)
    assert back.beam.major_rad == cube.beam.major_rad
    with pytest.raises(OSError, match="overwrite"):
        cube.write(out)
    vr, vdata = make_vr_cube_file(tmp_path)
    tvr = T.SpectralCube.read(vr, device="cpu")
    jvr = J.SpectralCube.read(vr)
    assert isinstance(tvr, T.VaryingResolutionSpectralCube)
    np.testing.assert_array_equal(tvr._data.numpy(), np.asarray(jvr._data))
    np.testing.assert_array_equal(tvr.unmasked_beams.major.value,
                                  jvr.unmasked_beams.major.value)
    h = base_header(nx=6, ny=5, nchan=4)
    h["NAXIS"], h["NAXIS4"], h["CTYPE4"] = 4, 2, "STOKES"
    h["CRVAL4"], h["CDELT4"], h["CRPIX4"] = 1.0, 1.0, 1.0
    p4 = str(tmp_path / "iq.fits")
    write_fits(p4, [HDU(data=np.stack([data, data]), header=h)])
    from spectral_cube_tpu_torch.io import read_cube
    ts, js = read_cube(p4, device="cpu"), J.io.read_cube(p4)
    assert isinstance(ts, T.StokesSpectralCube)
    assert ts.components == js.components == ["I", "Q"]
    for k in ts.components:
        np.testing.assert_array_equal(ts[k]._data.numpy(),
                                      np.asarray(js[k]._data))
