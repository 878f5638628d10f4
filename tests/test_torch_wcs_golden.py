"""Torch port, the golden WCS oracles against the port's WCS stack.

Mirrors ``tests/test_wcs_golden.py`` by name.  ``data/wcs_golden.json``
holds projection and pole-rotation values from an independent 40-digit
implementation; the port's host float64 projections meet them at the
JAX package's tolerances (1e-10 forward, 1e-9 inverse), and give the JAX
package's numbers bitwise.  The Greisen et al. (2006) worked examples
read the reference library's ``greisen2006.hdr`` and skip where it is
absent, as in the JAX package.  The port evaluates projections on the
host only, so the JAX package's jit (device-path) cases become host
cases held against the JAX package's host values.
"""

import numpy as np
import pytest

from spectral_cube_tpu.wcs import projections as jprj
from spectral_cube_tpu.wcs import WCS as JWCS

from spectral_cube_tpu_torch.wcs import projections as prj
from spectral_cube_tpu_torch.wcs import WCS, convert_spectral_axis

from test_wcs_golden import (GOLDEN, GREISEN, _entry_pv, _read_text_header,
                             requires_greisen)


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("code", sorted(GOLDEN["projections"]))
def test_projection_forward_vs_golden(code):
    entry = GOLDEN["projections"][code]
    pv = _entry_pv(entry)
    name = code.split(":")[0]
    for p in entry["points"]:
        out = prj.proj_native2xy(name, np.float64(p["phi"]),
                                 np.float64(p["theta"]), pv=pv)
        assert abs(float(out[0]) - float(p["x"])) < 1e-10, (code, p)
        assert abs(float(out[1]) - float(p["y"])) < 1e-10, (code, p)
        _same(out, jprj.proj_native2xy(name, np.float64(p["phi"]),
                                       np.float64(p["theta"]), pv=pv))


@pytest.mark.parametrize("code", sorted(GOLDEN["projections"]))
def test_projection_inverse_vs_golden(code):
    entry = GOLDEN["projections"][code]
    pv = _entry_pv(entry)
    name = code.split(":")[0]
    for p in entry["points"]:
        phi, theta = prj.proj_xy2native(name, np.float64(p["x"]),
                                        np.float64(p["y"]), pv=pv)
        dphi = (float(phi) - p["phi"] + 180.0) % 360.0 - 180.0
        if abs(p["theta"]) < 90 - 1e-9:
            assert abs(dphi) < 1e-9, (code, p)
        assert abs(float(theta) - p["theta"]) < 1e-9, (code, p)
        _same((phi, theta), jprj.proj_xy2native(
            name, np.float64(p["x"]), np.float64(p["y"]), pv=pv))


def test_pole_rotation_vs_golden():
    for case in GOLDEN["rotations"]:
        ap, dp, pp = case["alpha_p"], case["delta_p"], case["phi_p"]
        for p in case["points"]:
            lon, lat = prj.native_to_celestial(
                np.float64(p["phi"]), np.float64(p["theta"]), ap, dp, pp)
            dlon = (float(lon) - float(p["alpha"]) + 180.0) % 360.0 - 180.0
            if abs(float(p["delta"])) < 90 - 1e-5:
                assert abs(dlon * np.cos(np.radians(float(p["delta"])))) \
                    < 1e-10
            assert abs(float(lat) - float(p["delta"])) < 1e-10
            _same((lon, lat), jprj.native_to_celestial(
                np.float64(p["phi"]), np.float64(p["theta"]), ap, dp, pp))
            back = prj.celestial_to_native(float(p["alpha"]),
                                           float(p["delta"]), ap, dp, pp)
            _same(back, jprj.celestial_to_native(
                float(p["alpha"]), float(p["delta"]), ap, dp, pp))


def _wcs_for_key(hdr, key):
    from spectral_cube_tpu_torch.units import Unit
    w = WCS(naxis=1)
    suffix = "" if key == " " else key
    w.ctype[0] = str(hdr[f"CTYPE3{suffix}"])
    w.crval[0] = float(hdr[f"CRVAL3{suffix}"])
    w.cdelt[0] = float(hdr[f"CDELT3{suffix}"])
    w.crpix[0] = float(hdr[f"CRPIX3{suffix}"])
    w.cunit[0] = Unit.parse(str(hdr[f"CUNIT3{suffix}"]))
    w.restfrq = float(hdr.get(f"RESTFRQ{suffix}", 0.0) or 0.0)
    w.restwav = float(hdr.get(f"RESTWAV{suffix}", 0.0) or 0.0)
    return w


@requires_greisen
@pytest.mark.parametrize("key", ["Z", "W", "R", "V"])
def test_greisen2006_worked_examples(key):
    from spectral_cube_tpu_torch.units import Quantity
    hdr = _read_text_header(GREISEN)
    wcs0, wcs1 = _wcs_for_key(hdr, "F"), _wcs_for_key(hdr, key)
    rest = None
    if key in ("R", "V", "Z"):
        if wcs1.restfrq:
            rest = Quantity(wcs1.restfrq, "Hz")
        elif wcs1.restwav:
            rest = Quantity(wcs1.restwav, "m")
    wcs2 = convert_spectral_axis(wcs0, wcs1.cunit[0], wcs1.ctype[0],
                                 rest_value=rest)
    assert wcs2.ctype[wcs2.spec] == wcs1.ctype[0]
    np.testing.assert_allclose(wcs2.crval[wcs2.spec], wcs1.crval[0],
                               rtol=1e-3)
    np.testing.assert_allclose(wcs2.cdelt[wcs2.spec], wcs1.cdelt[0],
                               rtol=1e-3)


HEADERS = [
    (("RA---CEA", "DEC--CEA"), {"PV2_1": 0.5}),
    (("RA---AZP", "DEC--AZP"), {"PV2_1": 2.0}),
    (("RA---MER", "DEC--MER"), {}),
    (("RA---COE", "DEC--COE"), {"PV2_1": -30.0, "PV2_2": 20.0}),
    (("RA---COP", "DEC--COP"), {"PV2_1": 45.0, "PV2_2": 10.0}),
    (("RA---COD", "DEC--COD"), {"PV2_1": 40.0, "PV2_2": 15.0}),
    (("RA---COO", "DEC--COO"), {"PV2_1": 35.0, "PV2_2": 12.0}),
    (("RA---SIN", "DEC--SIN"), {"PV2_1": 0.0, "PV2_2": -2.0}),
    (("RA---AZP", "DEC--AZP"), {"PV2_1": 2.0, "PV2_2": 30.0}),
    (("RA---ZPN", "DEC--ZPN"), {"PV2_0": 0.0, "PV2_1": 1.0, "PV2_3": 0.3}),
    (("RA---CYP", "DEC--CYP"), {"PV2_1": 1.0, "PV2_2": 0.7071}),
    (("RA---PAR", "DEC--PAR"), {}),
    (("RA---BON", "DEC--BON"), {"PV2_1": 45.0}),
    (("RA---PCO", "DEC--PCO"), {}),
    (("RA---MOL", "DEC--MOL"), {})]


@pytest.mark.parametrize("ctype_pair,pv_cards", HEADERS,
                         ids=[c[0][0][-3:] + str(i)
                              for i, c in enumerate(HEADERS)])
def test_full_pix2world_with_pv(ctype_pair, pv_cards):
    h = {"CTYPE1": ctype_pair[0], "CTYPE2": ctype_pair[1],
         "CRVAL1": 150.0,
         "CRVAL2": (0.0 if "M" in ctype_pair[0][-3:]
                    else pv_cards.get("PV2_1", -30.0)),
         "CRPIX1": 10.0, "CRPIX2": 12.0, "CDELT1": -0.01, "CDELT2": 0.01,
         "CUNIT1": "deg", "CUNIT2": "deg"}
    h.update(pv_cards)
    w, jw = WCS(header=h), JWCS(header=h)
    xs = np.array([0.0, 5.0, 9.0, 18.0])
    ys = np.array([0.0, 3.0, 11.0, 20.0])
    lon, lat = w.pix2world(xs, ys)
    _same((lon, lat), jw.pix2world(xs, ys))
    xb, yb = w.world2pix(np.asarray(lon), np.asarray(lat))
    np.testing.assert_allclose(np.asarray(xb), xs, atol=1e-8)
    np.testing.assert_allclose(np.asarray(yb), ys, atol=1e-8)


def test_szp_reductions():
    phi = np.array([0.0, 30, -120, 179.5, 10, -45])
    th = np.array([89.0, 60, 45, 75, 30.5, 52.3])
    for mu in (0.5, 2.0, 5.0):
        xa, ya = prj.proj_native2xy("AZP", phi, th, pv=(mu,))
        xs, ys = prj.proj_native2xy("SZP", phi, th, pv=(mu, 77.0, 90.0))
        np.testing.assert_allclose(xs, xa, atol=1e-10)
        np.testing.assert_allclose(ys, ya, atol=1e-10)
    xt, yt = prj.proj_native2xy("TAN", phi, th)
    xs, ys = prj.proj_native2xy("SZP", phi, th, pv=(0.0, 123.0, 4.0))
    np.testing.assert_allclose(xs, xt, atol=1e-10)
    _same((xs, ys), jprj.proj_native2xy("SZP", phi, th,
                                        pv=(0.0, 123.0, 4.0)))


@pytest.mark.parametrize("code", ["TSC", "QSC"])
def test_tsc_qsc_face_edge_continuity(code):
    for p0, t0 in [(45.0, 0.0), (-45.0, 0.0), (135.0, 0.0), (225.0, 0.0),
                   (0.0, 45.0), (0.0, -45.0), (30.0, 45.0), (-30.0, -45.0)]:
        eps = 1e-9
        x1, y1 = prj.proj_native2xy(code, p0 - eps, t0 - eps)
        x2, y2 = prj.proj_native2xy(code, p0 + eps, t0 + eps)
        _same((x1, y1), jprj.proj_native2xy(code, p0 - eps, t0 - eps))
        _same((x2, y2), jprj.proj_native2xy(code, p0 + eps, t0 + eps))
        dx = abs((float(x1) - float(x2) + 180.0) % 360.0 - 180.0)
        assert dx < 1e-6 and abs(float(y1) - float(y2)) < 1e-6, (p0, t0)


@pytest.mark.parametrize("code", ["QSC", "XPH", "HPX", "TSC", "AIR"])
def test_sphere_sample_roundtrip_matches_jax(code):
    """A random sample of the sphere: the port's forward and inverse
    projections give the JAX package's values bitwise, and invert."""
    pv = (45.0,) if code == "AIR" else ()
    rng = np.random.default_rng(7)
    phi = rng.uniform(-180.0, 180.0, 2000)
    theta = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, 2000)))
    if code == "AIR":
        theta = np.abs(theta) * 0.9 + 5.0
    x, y = prj.proj_native2xy(code, phi, theta, pv=pv)
    _same((x, y), jprj.proj_native2xy(code, phi, theta, pv=pv))
    p2, t2 = prj.proj_xy2native(code, x, y, pv=pv)
    _same((p2, t2), jprj.proj_xy2native(code, x, y, pv=pv))
    dphi = (p2 - phi + 180.0) % 360.0 - 180.0
    assert np.max(np.abs(dphi) * np.cos(np.radians(theta))) < 1e-8
    assert np.max(np.abs(t2 - theta)) < 1e-8


def test_hpx_even_k_seam():
    pv = (4.0, 2.0)
    for lon, th in [(-179.0, -75.0), (179.0, -80.0), (-135.5, -70.0)]:
        x, y = prj.proj_native2xy("HPX", lon, th, pv=pv)
        _same((x, y), jprj.proj_native2xy("HPX", lon, th, pv=pv))
        p2, t2 = prj.proj_xy2native("HPX", float(x), float(y), pv=pv)
        _same((p2, t2), jprj.proj_xy2native("HPX", float(x), float(y),
                                            pv=pv))
        dlon = (float(p2) - lon + 180.0) % 360.0 - 180.0
        assert abs(dlon) < 1e-9 and abs(float(t2) - th) < 1e-9


def test_xph_layout_and_roundtrip():
    rt = np.sqrt(0.5)
    x, y = prj.proj_native2xy("XPH", 0.0, 90.0)
    _same((x, y), jprj.proj_native2xy("XPH", 0.0, 90.0))
    assert abs(float(x)) < 1e-12 and abs(float(y)) < 1e-12
    for lon, sx, sy in [(-135.0, -1, 1), (-45.0, -1, -1),
                        (45.0, 1, -1), (135.0, 1, 1)]:
        x, y = prj.proj_native2xy("XPH", lon, -90.0)
        _same((x, y), jprj.proj_native2xy("XPH", lon, -90.0))
        assert abs(float(x) - sx * 180.0 * rt) < 1e-9
        assert abs(float(y) - sy * 180.0 * rt) < 1e-9
        p2, t2 = prj.proj_xy2native("XPH", float(x), float(y))
        _same((p2, t2), jprj.proj_xy2native("XPH", float(x), float(y)))


def test_xph_header_roundtrip():
    """An --XPH header round-trips through the port's pixel <-> world
    machinery as through the JAX package's."""
    ws = []
    for cls in (WCS, JWCS):
        w = cls(naxis=2)
        w.wcs.ctype = ["RA---XPH", "DEC--XPH"]
        w.wcs.crval = [180.0, 90.0]
        w.wcs.crpix = [50.0, 50.0]
        w.wcs.cdelt = [-1.0, 1.0]
        ws.append(w)
    px = np.array([10.0, 50.0, 80.0, 30.0])
    py = np.array([20.0, 50.0, 70.0, 90.0])
    lon, lat = ws[0].wcs_pix2world(px, py, 0)
    _same((lon, lat), ws[1].wcs_pix2world(px, py, 0))
    px2, py2 = ws[0].wcs_world2pix(lon, lat, 0)
    np.testing.assert_allclose(px2, px, atol=1e-6)
    np.testing.assert_allclose(py2, py, atol=1e-6)
