"""The plain reference against float64 NumPy forms at tiny shapes, and
the control's arithmetic."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from cubebench import cubegen
from cubebench.reference import beam, conv, numerics, pipeline, select
from cubebench.reference import spectral


def _cube(shape, seed):
    return cubegen.make_cube(shape, seed, torch.device("cpu"))


def _np_nconv2d(x, kern):
    """astropy convolve's normalised convolution, float64, by loops."""
    c, ny, nx = x.shape
    ky, kx = kern.shape
    hy, hx = (ky - 1) // 2, (kx - 1) // 2
    valid = np.isfinite(x)
    num = np.pad(np.where(valid, x, 0.0), ((0, 0), (hy, hy), (hx, hx)))
    bad = np.pad((~valid).astype(float), ((0, 0), (hy, hy), (hx, hx)))
    out = np.zeros((c, ny, nx))
    den = np.zeros((c, ny, nx))
    for a in range(ky):
        for b in range(kx):
            k = kern[ky - 1 - a, kx - 1 - b]
            out += k * num[:, a:a + ny, b:b + nx]
            den += k * bad[:, a:a + ny, b:b + nx]
    den = 1.0 - den
    res = np.where(den > 1e-6, out / np.where(den > 1e-6, den, 1), np.nan)
    return np.where(valid.any((1, 2))[:, None, None], res, np.nan), den


def test_beam_deconvolution_round_trips():
    maj, mnr, pa = beam.deconvolve((12.0, 12.0, 0.0), (6.0, 4.5, 30.0))
    # convolving the cube's beam with the result gives the target beam
    a = beam._abc(maj, mnr, pa)
    b = beam._abc(6.0 * beam.ARCSEC, 4.5 * beam.ARCSEC, math.radians(30))
    t = beam._abc(12.0 * beam.ARCSEC, 12.0 * beam.ARCSEC, 0.0)
    assert np.allclose([x + y for x, y in zip(a, b)], t, rtol=1e-12,
                       atol=1e-20)
    assert math.degrees(pa) % 180 == pytest.approx(120.0)


def test_separable_pairs_rebuild_the_kernel():
    kern = beam.kernel(beam.deconvolve((12, 12, 0), (6, 4.5, 30)),
                       2.0 * beam.ARCSEC)
    yt, xt = beam.separable(kern)
    assert np.allclose(np.einsum("ri,rj->ij", yt, xt), kern, atol=1e-14)
    assert kern.shape == (19, 19) and kern.sum() == pytest.approx(1.0)


def test_normalized_conv2d_matches_numpy():
    x = _cube((16, 20, 24), 11)
    x[1, 3:9, 4:7] = float("nan")
    x[2] = float("nan")
    kern = beam.kernel(beam.deconvolve((12, 12, 0), (6, 4.5, 30)),
                       4.0 * beam.ARCSEC)
    pairs = conv.separable_pairs(kern, beam.separable)
    got, den = conv.normalized_conv2d(x, pairs)
    want, wden = _np_nconv2d(x.double().numpy(), kern)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    fin = np.isfinite(want)
    assert np.allclose(got.numpy()[fin], want[fin], rtol=1e-5, atol=1e-5)
    assert np.allclose(den.numpy(), wden, atol=1e-6)


def test_normalized_conv_axis0_matches_numpy():
    x = _cube((30, 4, 5), 12)
    x[10:14, 1, 1] = float("nan")
    x[:, 2, 2] = float("nan")
    taps = cubegen.gaussian_taps(2.0)
    got = conv.normalized_conv_axis0(x, taps).numpy()
    xn = x.double().numpy()
    h = (len(taps) - 1) // 2
    valid = np.isfinite(xn)
    num = np.pad(np.where(valid, xn, 0), ((h, h), (0, 0), (0, 0)))
    bad = np.pad((~valid).astype(float), ((h, h), (0, 0), (0, 0)))
    n = x.shape[0]
    out = sum(taps[len(taps) - 1 - o] * num[o:o + n] for o in range(len(taps)))
    den = 1 - sum(taps[len(taps) - 1 - o] * bad[o:o + n]
                  for o in range(len(taps)))
    ok = den > 1e-6
    want = np.where(valid.any(0) & ok, out / np.where(ok, den, 1), np.nan)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    # float32's error of num / den grows as 1 / den
    err = np.abs(got[fin] - want[fin]) * den[fin]
    assert np.all(err <= 1e-6 * np.maximum(1.0, np.abs(want[fin])))


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1001])
def test_median_is_numpys(n):
    rng = np.random.default_rng(n)
    v = rng.standard_normal(n).astype(np.float32)
    v[::5] = np.round(v[::5], 1)
    v[::7] = -0.0
    t = torch.from_numpy(v)

    def blocks():
        yield t[: n // 2]
        yield t[n // 2:]
    assert select.median(blocks, n) == pytest.approx(
        float(np.median(v.astype(np.float64))), rel=1e-7, abs=1e-30)
    ranks = select.order_statistics(blocks, [0, n - 1, n // 3])
    s = np.sort(v)
    assert ranks[0] == s[0] and ranks[n - 1] == s[-1]
    assert ranks[n // 3] == s[n // 3]


def _np_clip(spec, sigma, iters):
    s = np.sort(spec[np.isfinite(spec)].astype(np.float64))
    lo, hi = 0, s.size
    for _ in range(iters):
        if hi - lo <= 0:
            break
        band = s[lo:hi]
        centre = np.median(band)
        std = band.std()
        lo = max(lo, int(np.searchsorted(s, centre - sigma * std, "left")))
        hi = min(hi, int(np.searchsorted(s, centre + sigma * std, "right")))
    if hi <= lo:
        return np.full(spec.shape, np.nan)
    keep = np.isfinite(spec) & (spec >= s[lo]) & (spec <= s[hi - 1])
    return np.where(keep, spec, np.nan)


def test_clip_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((50, 200)).astype(np.float32)
    x[3, 10:30] = np.nan
    x[4] = np.nan
    x[5, :] = 1.5
    got = spectral.clip_spectra(torch.from_numpy(x), 1.0, 5).numpy()
    want = np.stack([_np_clip(r, 1.0, 5) for r in x])
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_pipeline_products_match_numpy(root):
    cfg = json.loads((root / "cubebench" / "configs"
                      / "casa-623x768x768.json").read_text())
    shape = (16, 40, 40)
    x = _cube(shape, 21)
    draw = {"dx": 0.3, "dy": -0.45}
    got, stream = pipeline.apply(x, cfg, {"snr_threshold": 3.0,
                                          "noise": "mad_std"}, draw)
    got["cube"], trust = stream.materialize()
    assert trust.shape == x.shape
    kern = beam.convolution_kernel(cfg)
    c, _ = _np_nconv2d(x.double().numpy(), kern)
    c *= beam.area_ratio(cfg["target_beam"], cfg["beam"])
    fin = np.isfinite(c)
    med = np.median(c[fin])
    sigma = 1.482602218505602 * np.median(np.abs(c[fin] - med))
    assert got["sigma"] == pytest.approx(sigma, rel=1e-5)
    inc = fin & (c > 3.0 * got["sigma"])
    w = np.where(inc, c, 0.0)
    off = np.arange(shape[0])[:, None, None] * cfg["header"]["cdelt3_m_s"]
    s0 = w.sum(0)
    with np.errstate(invalid="ignore", divide="ignore"):
        m1 = (w * off).sum(0) / s0
        lw = np.sqrt((w * (off - m1) ** 2).sum(0) / s0)
    some = inc.any(0)
    trust = got["trust_spaxel"] & some
    assert np.array_equal(np.isnan(got["mom0"]), ~some)
    assert np.allclose(got["mom0"][trust],
                       (s0 * cfg["header"]["cdelt3_m_s"])[trust], rtol=1e-5)
    assert np.allclose(got["mom1"][trust],
                       (m1 + cfg["header"]["crval3_m_s"])[trust], rtol=1e-6)
    assert np.allclose(got["linewidth"][trust], lw[trust], rtol=1e-4,
                       atol=1e-3)
    vals = c[inc]
    st = got["statistics"]
    assert st["npts"] == vals.size
    assert st["sum"] == pytest.approx(vals.sum(), rel=1e-5)
    assert st["sigma"] == pytest.approx(vals.std(ddof=1), rel=1e-5)
    # the translation: output (j, i) reads input (j - dy, i - dx)
    filled = np.where(inc, c, np.nan)
    y = np.arange(40) - draw["dy"]
    xs = np.arange(40) - draw["dx"]
    j, i = 10, 17
    y0, x0 = int(np.floor(y[j])), int(np.floor(xs[i]))
    wy, wx = y[j] - y0, xs[i] - x0
    f = filled[:, y0:y0 + 2, x0:x0 + 2]
    want = ((1 - wy) * ((1 - wx) * f[:, 0, 0] + wx * f[:, 0, 1])
            + wy * ((1 - wx) * f[:, 1, 0] + wx * f[:, 1, 1]))
    cube = got["cube"][:, j, i].double().numpy()
    assert np.array_equal(np.isnan(cube), np.isnan(want))
    assert np.allclose(cube[np.isfinite(want)], want[np.isfinite(want)],
                       rtol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0,
                      float("nan"), float("inf")])
    r = numerics.round_mantissa(x, numerics.TF32_BITS)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10
    assert r[2] == 1.0 + 2 ** -10 and r[3] == -3.0
    assert torch.isnan(r[4]) and torch.isinf(r[5])
    assert numerics.IEEE(x) is x


def test_reference_imports_nothing_of_the_program(root):
    code = ("import sys; sys.path.insert(0, %r); "
            "import cubebench.reference.chains, cubebench.roofline; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'spectral_cube_tpu_torch', 'spectral_cube_tpu', 'jax', "
            "'jaxlib', 'flax'}); print(bad); sys.exit(1 if bad else 0)"
            % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
