"""Torch port, DS9 and CRTF region subcubes against the JAX package.

Mirrors ``tests/test_regions_ref.py`` by name (its 21 tests).  The
parsers give the same Region objects, ``region_to_mask`` the same
boolean plane (both rasterise on the host in float64), and
``subcube_from_ds9region`` / ``_crtfregion`` / ``_regions`` the same
subcube: data, include mask, WCS cards and unit bitwise equal, for every
shape, frame, exclusion and composite, and for the spectral slab of a
region's ``range`` / ``veltype`` / ``restfreq``.  Tests that read the
reference library's .reg files skip where they are absent, as in the JAX
package's tests; the grid below them covers the same shapes and frames
with regions written here.
"""

import warnings

import numpy as np
import pytest

import spectral_cube_tpu as J
from spectral_cube_tpu import region as jr
from spectral_cube_tpu.units import Quantity as JQ

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import region as tr
from spectral_cube_tpu_torch.units import Quantity as TQ

from conftest import make_cube_file
from test_regions_ref import BASE, requires_data
from test_torch_slicing import assert_cube_equal


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def cubes(tmp_path, shape, name="adv.fits", **kwargs):
    path, data = make_cube_file(tmp_path, name=name, shape=shape, **kwargs)
    return (T.SpectralCube.read(path, device="cpu"), J.SpectralCube.read(path),
            data)


def assert_regions_equal(t_regs, j_regs):
    assert len(t_regs) == len(j_regs)
    for t, j in zip(t_regs, j_regs):
        assert (t.shape, t.frame, t.exclude) == (j.shape, j.frame, j.exclude)
        np.testing.assert_array_equal(np.asarray(t.params, dtype=float),
                                      np.asarray(j.params, dtype=float))


def assert_subcube_equal(t, j):
    """A region subcube: bitwise the JAX package's, with the region's mask
    kept as one (1, ny, nx) plane on the cube's device."""
    assert_cube_equal(t, j)
    plane = t.mask._mask2 if isinstance(t.mask, T.CompositeMask) else t.mask
    assert isinstance(plane, T.BooleanArrayMask)
    assert tuple(plane._mask.shape) == (1,) + t.shape[1:]
    assert plane._mask.device == t.device


def ds9_parity(tcube, jcube, text):
    """The same DS9 region through both packages: parse, rasterise, cut."""
    t_regs, j_regs = tr.parse_ds9_region(text), jr.parse_ds9_region(text)
    assert_regions_equal(t_regs, j_regs)
    for t, j in zip(t_regs, j_regs):
        np.testing.assert_array_equal(
            tr.region_to_mask(t, tcube.wcs, tcube.shape),
            jr.region_to_mask(j, jcube.wcs, jcube.shape))
    sub = tcube.subcube_from_ds9region(text)
    assert_subcube_equal(sub, jcube.subcube_from_ds9region(text))
    return sub, t_regs


# ---------------------------------------------------------------------------
# the reference's .reg files (test_regions_ref.py)
# ---------------------------------------------------------------------------

@requires_data
def test_fk5_and_pixel_circle_agree(tmp_path):
    for name in ("255-fk5.reg", "255-pixel.reg"):
        text = open(BASE + name).read()
        assert_regions_equal(tr.parse_ds9_region(text),
                             jr.parse_ds9_region(text))


@requires_data
def test_fk5_box_parse():
    for name in ("fk5.reg", "fk5_twoboxes.reg"):
        text = open(BASE + name).read()
        assert_regions_equal(tr.parse_ds9_region(text),
                             jr.parse_ds9_region(text))


@requires_data
def test_image_box_mask(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (2, 4, 4))
    text = open(BASE + "image.reg").read()
    t = tr.region_to_mask(tr.parse_ds9_region(text)[0], tcube.wcs,
                          tcube.shape)
    np.testing.assert_array_equal(t, jr.region_to_mask(
        jr.parse_ds9_region(text)[0], jcube.wcs, jcube.shape))


def test_ds9_annulus(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (4, 21, 21))
    sub, regs = ds9_parity(tcube, jcube, "image; annulus(11, 11, 3, 8)")
    yy, xx = np.mgrid[0:21, 0:21].astype(float)
    d2 = (xx - 10) ** 2 + (yy - 10) ** 2
    np.testing.assert_array_equal(
        tr.region_to_mask(regs[0], tcube.wcs, tcube.shape),
        (d2 >= 9) & (d2 <= 64))


def test_ds9_panda_sector(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (4, 21, 21))
    _, regs = ds9_parity(tcube, jcube,
                         "image; panda(11, 11, 0, 90, 1, 0, 8, 1)")
    m = tr.region_to_mask(regs[0], tcube.wcs, tcube.shape)
    assert m[12, 12] and not m[8, 8] and not m[12, 8]


def test_ds9_exclusion_composite(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (4, 21, 21))
    sub, _ = ds9_parity(tcube, jcube,
                        "image; circle(11, 11, 8); -circle(11, 11, 3)")
    yy, xx = np.mgrid[0:21, 0:21].astype(float)
    d2 = (xx - 10) ** 2 + (yy - 10) ** 2
    full = (d2 <= 64) & ~(d2 <= 9)
    ys, xs = np.where(full.any(axis=1))[0], np.where(full.any(axis=0))[0]
    np.testing.assert_array_equal(
        sub.get_mask_array()[0], full[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1])


def test_composite_region_objects(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (4, 21, 21))
    for op in ("__and__", "__or__", "__xor__"):
        t = getattr(tr.Region("circle", "image", [10, 10, 5]), op)(
            tr.Region("circle", "image", [14, 10, 5]))
        j = getattr(jr.Region("circle", "image", [10, 10, 5]), op)(
            jr.Region("circle", "image", [14, 10, 5]))
        assert isinstance(t, tr.CompositeRegion)
        np.testing.assert_array_equal(
            tr.region_to_mask(t, tcube.wcs, tcube.shape),
            jr.region_to_mask(j, jcube.wcs, jcube.shape))
        assert_subcube_equal(tcube.subcube_from_regions([t]),
                             jcube.subcube_from_regions([j]))
    with pytest.raises(ValueError, match="unknown composite"):
        tr.CompositeRegion(t, t, "nand")


def test_crtf_annulus(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (4, 21, 21))
    text = "#CRTFv0\nannulus[[11pix, 11pix], [3pix, 8pix]]"
    assert_regions_equal(tr.parse_crtf_region(text),
                         jr.parse_crtf_region(text))
    assert_subcube_equal(tcube.subcube_from_crtfregion(text),
                         jcube.subcube_from_crtfregion(text))


def test_galactic_fk5_rotation_anchors():
    rng = np.random.RandomState(2)
    ras, decs = rng.uniform(0, 360, 20), rng.uniform(-89, 89, 20)
    for t_fn, j_fn in ((tr.galactic_to_fk5, jr.galactic_to_fk5),
                       (tr.fk5_to_galactic, jr.fk5_to_galactic)):
        for a, b in zip(t_fn(ras, decs), j_fn(ras, decs)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ra, dec = tr.galactic_to_fk5(0.0, 0.0)
    assert float(ra) == pytest.approx(266.40499, abs=2e-3)
    assert float(dec) == pytest.approx(-28.93617, abs=2e-3)


def test_galactic_region_on_equatorial_cube(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (4, 21, 21))
    lc, bc = tr.fk5_to_galactic(23.1837, 30.5765)
    sub, regs = ds9_parity(
        tcube, jcube, f"galactic; circle({float(lc)}, {float(bc)}, 0.003)")
    np.testing.assert_array_equal(
        tr.region_to_mask(regs[0], tcube.wcs, tcube.shape),
        tr.region_to_mask(tr.parse_ds9_region(
            "fk5; circle(23.1837, 30.5765, 0.003)")[0], tcube.wcs,
            tcube.shape))


def test_ecliptic_fk4_supergalactic_anchors():
    rng = np.random.RandomState(5)
    ras, decs = rng.uniform(0, 360, 20), rng.uniform(-89, 89, 20)
    for name in ("ecliptic_to_fk5", "fk5_to_ecliptic", "fk4_to_fk5",
                 "fk5_to_fk4", "supergalactic_to_galactic",
                 "galactic_to_supergalactic"):
        for a, b in zip(getattr(tr, name)(ras, decs),
                        getattr(jr, name)(ras, decs)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    l0, b0 = tr.supergalactic_to_galactic(0.0, 0.0)
    assert float(l0) == pytest.approx(137.37, abs=1e-9)


def test_ecliptic_and_b1950_regions_on_equatorial_cube(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (2, 24, 24))
    lon, lat = tcube.wcs.celestial.pix2world(np.array([12.0]),
                                             np.array([12.0]))
    ra, dec = float(np.asarray(lon)[0]), float(np.asarray(lat)[0])
    radius = 6.283 * abs(tcube.wcs.cdelt[0]) * tcube.wcs.cunit[0].to("deg")
    el, eb = tr.fk5_to_ecliptic(ra, dec)
    r4, d4 = tr.fk5_to_fk4(ra, dec)
    ref, _ = ds9_parity(tcube, jcube, f"fk5\ncircle({ra}, {dec}, {radius})")
    for text in (f"ecliptic\ncircle({float(el)}, {float(eb)}, {radius})",
                 f"b1950\ncircle({float(r4)}, {float(d4)}, {radius})"):
        sub, _ = ds9_parity(tcube, jcube, text)
        np.testing.assert_array_equal(sub.get_mask_array(),
                                      ref.get_mask_array())


def test_crtf_parser_full_forms():
    for text in (
            "poly[[10deg,10deg],[11deg,10deg],[11deg,11deg],[10deg,11deg]]",
            "circle[[18h12m24s, -23d11m00s], 4arcsec]",
            "box[[272deg,-23deg],[273deg,-22deg]]",
            "rotbox[[12deg,-1deg],[2arcmin,1arcmin],45deg]",
            "ellipse[[12deg,-1deg],[40arcsec,20arcsec],30deg]",
            "circle[[1:36:14.9, +29:56:07.6], 3arcsec], coord=B1950",
            "-centerbox[[10pix, 12pix], [4pix, 6pix]]",
            "circle[[120deg, 10deg], 1deg], coord=GALACTIC",
            "circle[[30deg, 5deg], 1deg], coord=SUPERGAL",
            "circle[[30deg, 5deg], 1deg], coord=ECLIPTIC"):
        assert_regions_equal(tr.parse_crtf_region(text),
                             jr.parse_crtf_region(text))


def test_sky_rotated_box_handedness(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (2, 40, 40), name="rb.fits")
    ext = tcube.world_extrema
    lonc, latc = float(ext[0].value.mean()), float(ext[1].value.mean())
    sub, regs = ds9_parity(tcube, jcube,
                           f'fk5; box({lonc}, {latc}, 80", 20", 45)')
    yy, xx = np.nonzero(tr.region_to_mask(regs[0], tcube.wcs, tcube.shape))
    v = np.linalg.eigh(np.cov(np.stack([xx - xx.mean(),
                                        yy - yy.mean()])))[1][:, 1]
    assert abs(np.degrees(np.arctan2(v[1], v[0])) % 180 - 135) < 8


@requires_data
@pytest.mark.parametrize("regfile", ["255-fk5.reg", "255-pixel.reg"])
def test_ds9region_255(regfile, tmp_path):
    from ref_fixtures import jybeam_header
    from spectral_cube_tpu.io.fits_low import HDU, write_fits
    h = jybeam_header()
    h["BUNIT"], h["NAXIS"] = "K", 3
    h["NAXIS1"], h["NAXIS2"], h["NAXIS3"] = 5, 5, 2
    for k in ("CDELT4", "CRPIX4", "CRVAL4", "CTYPE4", "CUNIT4", "NAXIS4"):
        del h[k]
    p = str(tmp_path / "255.fits")
    write_fits(p, [HDU(data=np.arange(50.0).reshape(2, 5, 5), header=h)])
    tcube, jcube = T.SpectralCube.read(p, device="cpu"), J.SpectralCube.read(p)
    text = open(BASE + regfile).read()
    sub = tcube.subcube_from_regions(tr.parse_ds9_region(text))
    assert_subcube_equal(sub, jcube.subcube_from_regions(
        jr.parse_ds9_region(text)))
    np.testing.assert_array_equal(sub.filled_data[0, :, :].value,
                                  [[11, 12], [16, 17]])


@requires_data
@pytest.mark.parametrize("regfile", [
    "fk5.reg", "fk5_twoboxes.reg", "image.reg", "partial_overlap_image.reg",
    "no_overlap_image.reg", "partial_overlap_fk5.reg", "no_overlap_fk5.reg"])
def test_ds9region_new(regfile, tmp_path):
    from ref_fixtures import data_adv
    path, _ = data_adv(tmp_path)
    tcube, jcube = T.SpectralCube.read(path, device="cpu"), \
        J.SpectralCube.read(path)
    text = open(BASE + regfile).read()
    if regfile.startswith("no_overlap"):
        with pytest.raises(ValueError):
            tcube.subcube_from_regions(tr.parse_ds9_region(text))
        return
    assert_subcube_equal(
        tcube.subcube_from_regions(tr.parse_ds9_region(text)),
        jcube.subcube_from_regions(jr.parse_ds9_region(text)))


def test_image_ellipse_rasterization(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (2, 16, 16))
    _, regs = ds9_parity(tcube, jcube, "image; ellipse(8.0,7.0,5.0,2.5,30.0)")
    assert 20 < tr.region_to_mask(regs[0], tcube.wcs, tcube.shape).sum()


def test_image_polygon_rasterization_matches_matplotlib(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (2, 20, 20))
    verts = [(3, 3), (17, 4), (15, 16), (10, 8), (4, 17)]
    flat = ", ".join(f"{x},{y}" for x, y in verts)
    _, regs = ds9_parity(tcube, jcube, f"image; polygon({flat})")
    m = tr.region_to_mask(regs[0], tcube.wcs, tcube.shape)
    assert m[5, 8] and not m[18, 18]


def test_sky_polygon_rasterization(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (2, 12, 12))
    lon, lat = tcube.wcs.celestial.pix2world(np.array([1.6, 8.4, 8.4, 1.6]),
                                             np.array([2.6, 2.6, 6.4, 6.4]))
    flat = ", ".join(f"{float(x)},{float(y)}"
                     for x, y in zip(np.asarray(lon), np.asarray(lat)))
    _, regs = ds9_parity(tcube, jcube, f"fk5; polygon({flat})")
    exp = np.zeros((12, 12), bool)
    exp[3:7, 2:9] = True
    np.testing.assert_array_equal(
        tr.region_to_mask(regs[0], tcube.wcs, tcube.shape), exp)


def test_panda_wrapped_sector(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (2, 15, 15))
    _, regs = ds9_parity(tcube, jcube, "image; panda(8,8,300,60,1,2,6,1)")
    m = tr.region_to_mask(regs[0], tcube.wcs, tcube.shape)
    assert m[7, 11] and not m[7, 3]


def test_subcube_from_image_ellipse_end_to_end(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (3, 16, 16))
    sub, _ = ds9_parity(tcube, jcube, "image; ellipse(8,8,4,2,0)")
    filled = sub.filled_data[:].value
    assert filled.shape[0] == 3 and filled.shape[1] < 16
    assert np.isnan(filled[:, 0, 0]).all()


# ---------------------------------------------------------------------------
# the port only: every shape in every frame, the spectral slab, Stokes
# ---------------------------------------------------------------------------

SHAPES = {
    "circle": "circle({x}, {y}, {r})",
    "ellipse": "ellipse({x}, {y}, {r}, {h}, 25)",
    "box": "box({x}, {y}, {r}, {h}, 35)",
    "annulus": "annulus({x}, {y}, {h}, {r})",
    "panda": "panda({x}, {y}, 20, 200, 1, {h}, {r}, 1)",
}
FRAMES = ["image", "fk5", "icrs", "galactic", "ecliptic", "fk4"]


def _centre_in(frame, tcube):
    """The cube's centre pixel in ``frame``, as DS9 writes it."""
    ny, nx = tcube.shape[1:]
    if frame == "image":
        return (nx + 1) / 2.0, (ny + 1) / 2.0, 6.0, 3.5
    lon, lat = tcube.wcs.celestial.pix2world(np.array([(nx - 1) / 2.0]),
                                             np.array([(ny - 1) / 2.0]))
    lon, lat = float(np.asarray(lon)[0]), float(np.asarray(lat)[0])
    to = {"galactic": tr.fk5_to_galactic, "ecliptic": tr.fk5_to_ecliptic,
          "fk4": tr.fk5_to_fk4}.get(frame)
    if to is not None:
        lon, lat = (float(v) for v in to(lon, lat))
    pix = abs(tcube.wcs.cdelt[0]) * tcube.wcs.cunit[0].to("deg")
    return lon, lat, 6.0 * pix, 3.5 * pix


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shape_in_frame_matches_jax(tmp_path, shape, frame):
    tcube, jcube, _ = cubes(tmp_path, (3, 19, 17))
    x, y, r, h = _centre_in(frame, tcube)
    ds9_parity(tcube, jcube,
               f"{frame}; " + SHAPES[shape].format(x=x, y=y, r=r, h=h))


@pytest.mark.parametrize("frame", ["image", "fk5", "galactic"])
def test_exclusions_and_polygons_match_jax(tmp_path, frame):
    tcube, jcube, _ = cubes(tmp_path, (3, 19, 17))
    x, y, r, h = _centre_in(frame, tcube)
    s = 1.0 if frame == "image" else abs(tcube.wcs.cdelt[1])
    poly = ", ".join(f"{x + dx * s},{y + dy * s}"
                     for dx, dy in ((-7, -6), (6, -5), (4, 7), (0, 1),
                                    (-6, 6)))
    text = (f"{frame}; polygon({poly}); -circle({x}, {y}, {h}); "
            f"-box({x}, {y}, {r}, {h / 3}, 10)")
    ds9_parity(tcube, jcube, text)


def test_no_overlap_raises_and_allow_empty(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (3, 10, 10))
    with pytest.raises(ValueError, match="empty"):
        tcube.subcube_from_ds9region("image; circle(100, 100, 2)")
    t = tcube.subcube_from_ds9region("image; circle(100, 100, 2)",
                                     allow_empty=True)
    j = jcube.subcube_from_ds9region("image; circle(100, 100, 2)",
                                     allow_empty=True)
    assert t.shape == j.shape


def test_region_file_is_read(tmp_path):
    tcube, jcube, _ = cubes(tmp_path, (3, 12, 12))
    ds9 = tmp_path / "r.reg"
    ds9.write_text("# Region file\nglobal color=green\nimage\n"
                   "circle(6, 6, 3)\n")
    crtf = tmp_path / "r.crtf"
    crtf.write_text("#CRTFv0\nbox[[2pix, 3pix], [9pix, 8pix]]\n")
    assert_subcube_equal(tcube.subcube_from_ds9region(str(ds9)),
                         jcube.subcube_from_ds9region(str(ds9)))
    assert_subcube_equal(tcube.subcube_from_crtfregion(str(crtf)),
                         jcube.subcube_from_crtfregion(str(crtf)))


def test_regions_spectral_range(tmp_path):
    """A region's meta['range'] selects a spectral slab, also as
    frequencies and as GAMMA / BETA / Z velocities with their veltype and
    restfreq (the JAX package's test_ref_values.py:214-255)."""
    from ref_fixtures import data_adv
    from spectral_cube_tpu_torch.units import (
        doppler_optical, doppler_z, doppler_beta, doppler_gamma, spectral)
    from spectral_cube_tpu_torch.wcs.spectral import _rest_freq_si
    path, data = data_adv(tmp_path)
    tcube = T.SpectralCube.read(path, device="cpu")
    jcube = J.SpectralCube.read(path)
    rf = TQ(_rest_freq_si(tcube._wcs), "Hz").to("GHz",
                                                equivalencies=spectral())
    vel = [TQ(-318.0, "km/s"), TQ(-320.0, "km/s")]
    freq = [v.to("GHz", equivalencies=doppler_optical(rf)) for v in vel]
    metas = [{"range": vel}, {"range": freq}]
    for veltype, conv in (("GAMMA", doppler_gamma), ("BETA", doppler_beta),
                          ("Z", doppler_z)):
        metas.append({"range": [f.to("km/s", equivalencies=conv(rf))
                                for f in freq],
                      "veltype": veltype, "restfreq": rf})

    def jmeta(meta):
        out = dict(meta)
        out["range"] = [JQ(float(q.value), q.unit.to_string())
                        for q in meta["range"]]
        if "restfreq" in meta:
            out["restfreq"] = JQ(float(meta["restfreq"].value), "GHz")
        return out

    box = [0.5, 1.0, 2.0, 1.0]
    dsum = np.nansum(data[1:-1, 1, :])
    for meta in metas:
        t = tcube.subcube_from_regions([tr.Region("box", "image", box,
                                                  meta=meta)])
        j = jcube.subcube_from_regions([jr.Region("box", "image", box,
                                                  meta=jmeta(meta))])
        assert_subcube_equal(t, j)
        np.testing.assert_allclose(float(t.sum().value), dsum, rtol=1e-7)
    with pytest.raises(ValueError, match="BOGUS"):
        tcube.subcube_from_regions([tr.Region(
            "box", "image", box, meta={"range": vel, "veltype": "BOGUS"})])


def test_stokes_cube_region_cuts(tmp_path):
    tparts, jparts = {}, {}
    for i, name in enumerate("IV"):
        p, _ = make_cube_file(tmp_path, f"{name}.fits", shape=(3, 14, 13),
                              seed=i)
        tparts[name] = T.SpectralCube.read(p, device="cpu")
        jparts[name] = J.SpectralCube.read(p)
    ts, js = T.StokesSpectralCube(tparts), J.StokesSpectralCube(jparts)
    regs = "image; circle(7, 7, 4); -circle(7, 7, 1.5)"
    crtf = "box[[3pix, 4pix], [10pix, 11pix]]"
    for t, j in ((ts.subcube_from_ds9region(regs),
                  js.subcube_from_ds9region(regs)),
                 (ts.subcube_from_crtfregion(crtf),
                  js.subcube_from_crtfregion(crtf)),
                 (ts.subcube_from_regions(tr.parse_ds9_region(regs),
                                          minimize=False),
                  js.subcube_from_regions(jr.parse_ds9_region(regs),
                                          minimize=False))):
        assert isinstance(t, T.StokesSpectralCube)
        assert t.components == j.components
        for k in t.components:
            assert_subcube_equal(t[k], j[k])
