"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``: each skips, with its
reason, where ``torch.cuda.is_available()`` is false.  The file imports
neither JAX nor the JAX package, so it also runs on a machine without
them (the README names the command).  Tolerances: 1e-6 relative between
the kernel and its plain version of the same numerics (only the order of
float32 roundings differs), NaN patterns exact; the sigma clip exactly
(its kernel and plain version sum in one order); the fused smooth +
interpolation 3e-5 / 1e-5 (the JAX kernels' own tolerance).
"""

import numpy as np
import pytest
import torch

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.io.fits_low import Header
from spectral_cube_tpu_torch.kernels import conv_sep as kconv
from spectral_cube_tpu_torch.kernels import moments as kmom
from spectral_cube_tpu_torch.kernels import resample2 as kres
from spectral_cube_tpu_torch.kernels import sigma_clip as kclip
from spectral_cube_tpu_torch.kernels import smooth_interp as ksi
from spectral_cube_tpu_torch.ops import convolve as tconv
from spectral_cube_tpu_torch.ops import interpolate as tinterp
from spectral_cube_tpu_torch.ops import moments as tmom
from spectral_cube_tpu_torch.ops import smoothing as tsmooth
from spectral_cube_tpu_torch.wcs import WCS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _close(got, want, rtol=1e-6, atol=1e-6):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _noise_cube(shape, seed):
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32)
    data[1, 2:5, 3:9] = np.nan
    data[-1] = np.nan
    data[0, 1, 1] = np.inf
    return torch.as_tensor(data)


@pytest.mark.parametrize("nchan", [7, 32, 33, 1100])
@pytest.mark.parametrize("mask", ["none", "fused", "include"])
def test_moments_kernel_matches_plain(cuda, nchan, mask):
    x = _noise_cube((nchan, 13, 45), nchan) + 2.0
    coords = np.linspace(-3.0, 7.0, nchan)
    inc = (x > 1.5) if mask == "include" else None
    op, thr = (1, 1.7) if mask == "fused" else (0, 0.0)
    for with_stats in (False, True):
        want = kmom.moments_planes_plain(x, coords, op, thr, inc, with_stats)
        n0 = kmom.moments_planes.launches
        got = kmom.moments_planes(x.to(cuda), coords, op, thr,
                                  None if inc is None else inc.to(cuda),
                                  with_stats)
        assert kmom.moments_planes.launches == n0 + 1
        assert torch.equal(got[1].cpu(), want[1])
        fin_w = tmom.finalize_planes(*want, 0.0, 1.0, with_stats)
        fin_g = tmom.finalize_planes(got[0].cpu(), got[1].cpu(), 0.0, 1.0,
                                     with_stats)
        for a, b in zip(fin_g[:3], fin_w[:3]):
            _close(a, b, rtol=2e-6, atol=1e-6)
        if with_stats:
            for key in ("npts", "min", "max", "sum", "mean", "sigma",
                        "rms", "sumsq"):
                np.testing.assert_allclose(float(fin_g[3][key]),
                                           float(fin_w[3][key]), rtol=2e-6)


@pytest.mark.parametrize("kshape,theta", [((9, 9), 0.0), ((11, 11), 0.3),
                                          ((8, 6), 0.2), ((41, 41), 0.5)])
def test_conv_kernel_matches_plain(cuda, kshape, theta):
    x = _noise_cube((4, 37, 70), 1)
    y = np.arange(kshape[0]) - (kshape[0] - 1) / 2
    xx = np.arange(kshape[1]) - (kshape[1] - 1) / 2
    Y, X = np.meshgrid(y, xx, indexing="ij")
    yr = Y * np.cos(theta) + X * np.sin(theta)
    xr = -Y * np.sin(theta) + X * np.cos(theta)
    s = kshape[0] / 5.0
    k = np.exp(-0.5 * ((yr / s) ** 2 + (xr / (0.7 * s)) ** 2))
    k /= k.sum()
    want = tconv.convolve2d_separable(x, k)
    n0 = kconv.conv_sep.launches
    got = tconv.convolve2d_separable(x.to(cuda), k)
    assert kconv.conv_sep.launches == n0 + 1
    _close(got, want, rtol=1e-5, atol=2e-6)


def test_conv_kernel_groups_interleaved(cuda):
    x = _noise_cube((6, 50, 33), 2)
    rng = np.random.RandomState(0)
    ytaps = [rng.rand(5, 2), rng.rand(8, 1), np.ones((1, 1))]
    xtaps = [rng.rand(7, 2), rng.rand(4, 1), np.ones((1, 1))]
    gi = np.array([2, 0, 1, 0, 1, 2], np.int32)
    want = tconv._convolve_groups(x, ytaps, xtaps, gi)
    got = tconv._convolve_groups(x.to(cuda), ytaps, xtaps, gi)
    _close(got, want, rtol=1e-5, atol=2e-6)
    # identity group: a clean channel passes through unchanged
    torch.testing.assert_close(got[5].cpu(), x[5], equal_nan=True)


@pytest.mark.parametrize("ay,by,ax,bx", [(1.0, 0.37, 1.0, -1.61),
                                         (0.93, 3.2, 1.07, -2.6),
                                         (1.0, 2.0, 1.0, 0.0)])
def test_resample_kernel_matches_plain(cuda, ay, by, ax, bx):
    x = _noise_cube((5, 40, 67), 3)
    ny, nx = 36, 70
    ys = np.clip(np.arange(ny) * ay + by, 0, 39)
    xs = np.clip(np.arange(nx) * ax + bx, 0, 66)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, 38)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, 65)
    wy, wx = (ys - y0).astype(np.float32), (xs - x0).astype(np.float32)
    valid = np.ones((ny, nx), bool)
    valid[:2] = False
    valid[:, -3:] = False
    zvalid = np.array([1, 1, 0, 1, 1], bool)
    want = kres.resample2_plain(x, y0, wy, x0, wx, valid, zvalid)
    n0 = kres.resample2.launches
    got = kres.resample2(x.to(cuda), y0, wy, x0, wx, valid, zvalid)
    assert kres.resample2.launches == n0 + 1
    _close(got, want)


def _header(nchan, ny, nx):
    h = Header()
    for k, v in (("NAXIS", 3), ("NAXIS1", nx), ("NAXIS2", ny),
                 ("NAXIS3", nchan), ("CTYPE1", "RA---SIN"),
                 ("CRVAL1", 23.18), ("CDELT1", -2.0 / 3600),
                 ("CRPIX1", nx / 2), ("CUNIT1", "deg"),
                 ("CTYPE2", "DEC--SIN"), ("CRVAL2", 30.57),
                 ("CDELT2", 2.0 / 3600), ("CRPIX2", ny / 2),
                 ("CUNIT2", "deg"), ("CTYPE3", "VRAD"), ("CRVAL3", -3.2e5),
                 ("CDELT3", 1.28e3), ("CRPIX3", 1.0), ("CUNIT3", "m/s"),
                 ("BUNIT", "Jy/beam"), ("BMAJ", 6.0 / 3600),
                 ("BMIN", 4.5 / 3600), ("BPA", 30.0)):
        h[k] = v
    return h


def test_pipeline_on_cuda_matches_cpu(cuda):
    """run_pipeline on a CUDA cube goes through all three kernels and
    agrees with the same pipeline on the CPU (plain versions)."""
    nchan, ny, nx = 40, 48, 52
    rng = np.random.RandomState(5)
    v = np.arange(nchan)
    data = (2.0 * np.exp(-0.5 * ((v - 20) / 3.0) ** 2)[:, None, None]
            + 0.3 * rng.randn(nchan, ny, nx)).astype(np.float32)
    data[:, :3] = np.nan
    h = _header(nchan, ny, nx)
    target = Header(h)
    target["CRPIX1"] = h["CRPIX1"] + 0.37
    beam = T.Beam(T.Quantity(12.0, "arcsec"), T.Quantity(12.0, "arcsec"),
                  T.Quantity(0.0, "deg"))
    # an SNR threshold in a gap of the convolved values, so no voxel sits
    # within rounding of it in either convolution
    conv = T.SpectralCube(data, WCS(header=h), header=h,
                         device="cpu").convolve_to(beam)
    v = np.sort(conv._data.numpy()[np.isfinite(conv._data.numpy())])
    lo, hi = np.searchsorted(v, np.percentile(v, [60.0, 80.0]))
    i = lo + int(np.argmax(np.diff(v[lo:hi])))
    noise = 0.5 * (float(v[i]) + float(v[i + 1]))
    out = {}
    for dev in ("cpu", cuda):
        cube = T.SpectralCube(data, WCS(header=h), header=h, device=dev)
        K.reset_launch_counts()
        out[str(dev)] = T.run_pipeline(cube, snr_threshold=1.0,
                                       target_beam=beam, target_header=target,
                                       noise_estimate=noise)
        counts = K.launch_counts()
        pipeline = [counts[k] for k in ("moments", "conv_sep", "resample2")]
        if str(dev) == "cpu":
            assert all(n == 0 for n in counts.values()), counts
        else:
            assert all(n > 0 for n in pipeline), counts
    a, b = out["cpu"], out[str(cuda)]
    for pa, pb in zip(a["moments"], b["moments"]):
        va, vb = np.asarray(pa.value), np.asarray(pb.value)
        both = np.isfinite(va) & np.isfinite(vb)
        assert both.sum() > 0.5 * va.size
        np.testing.assert_allclose(vb[both], va[both], rtol=1e-4, atol=1e-4)
    assert a["statistics"]["npts"] == b["statistics"]["npts"]
    _close(b["cube"]._data, a["cube"]._data, rtol=1e-5, atol=1e-5)


def _spectra(shape, seed):
    """Noise with a NaN hole inside some spectra, an all-NaN spectrum and
    +-inf (missing, like NaN)."""
    rng = np.random.RandomState(seed)
    data = (2.0 * rng.randn(*shape)).astype(np.float32)
    nchan = shape[0]
    data[nchan // 3:nchan // 3 + 4, 1, 3:9] = np.nan
    data[:, 2, 7] = np.nan
    data[nchan // 2, 0, 0] = np.inf
    data[nchan // 2, 0, 1] = -np.inf
    return torch.as_tensor(data)


@pytest.mark.parametrize("nchan,use_mean", [(623, False), (623, True),
                                            (37, False), (1, False),
                                            (4096, False), (20000, False),
                                            (30000, True)])
def test_sigma_clip_kernel_matches_plain(cuda, nchan, use_mean):
    """Bitwise, at ragged shapes (nx = 100), one channel to 30000 (past
    shared memory: the rows then live in the global workspace)."""
    x = _spectra((nchan, 3, 100), nchan)
    for sigma, maxiters in ((1.0, 5), (2.5, 3)):
        want = kclip.sigma_clip_plain(x, sigma, maxiters, use_mean)
        n0 = kclip.sigma_clip.launches
        got = kclip.sigma_clip(x.to(cuda), sigma, maxiters, use_mean).cpu()
        assert kclip.sigma_clip.launches == n0 + 1
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("nin,step", [(623, 2), (100, 3), (40, 1)])
def test_smooth_interp_kernel_matches_plain(cuda, nin, step):
    x = _spectra((nin, 3, 100), nin)
    inaxis = np.arange(nin) * 1.5
    outaxis = inaxis[::step] + 0.4
    kern = tsmooth.gaussian_kernel1d(2.0)
    idx, frac = tinterp.interp_weights(inaxis, outaxis)
    S, I, M, bands = tinterp._si_operators(kern / kern.sum(), idx, frac,
                                           nin)
    want = ksi.smooth_interp_plain(x, M, S, I)
    n0 = ksi.smooth_interp.launches
    got = ksi.smooth_interp(x.to(cuda), M, S, I, bands)
    assert ksi.smooth_interp.launches == n0 + 1
    _close(got, want, rtol=3e-5, atol=1e-5)
    flat = ksi.smooth_interp(x.reshape(nin, -1).to(cuda), M, S, I)
    _close(flat.reshape(got.shape), want, rtol=3e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(30000,), (623, 41)])
def test_sigma_clip_op_takes_the_kernel_at_any_shape(cuda, shape):
    """sigma_clip_spectrally on a CUDA float32 array launches the kernel
    for a single long spectrum and for a 2-D array alike."""
    rng = np.random.RandomState(len(shape))
    x = torch.as_tensor(rng.randn(*shape).astype(np.float32))
    want = tsmooth.sigma_clip_spectrally(x, 1.5)
    n0 = kclip.sigma_clip.launches
    got = tsmooth.sigma_clip_spectrally(x.to(cuda), 1.5).cpu()
    assert kclip.sigma_clip.launches == n0 + 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def test_spectral_path_on_cuda_matches_cpu(cuda):
    """spectral_smooth -> spectral_interpolate(smooth_kernel) ->
    sigma_clip_spectrally on a CUDA cube launches both spectral kernels
    and agrees with the CPU run (plain versions)."""
    nchan, ny, nx = 64, 20, 36
    data = _spectra((nchan, ny, nx), 9).numpy() + np.exp(
        -0.5 * ((np.arange(nchan)[:, None, None] - 30) / 4.0) ** 2)
    data[:, :, :2] = np.nan
    h = _header(nchan, ny, nx)
    h["BUNIT"] = "K"
    kern = tsmooth.gaussian_kernel1d(2.0)
    out = {}
    for dev in ("cpu", cuda):
        cube = T.SpectralCube(data, WCS(header=h), header=h, device=dev)
        cube = cube.with_mask(T.LazyMask(torch.isfinite, cube=cube))
        K.reset_launch_counts()
        sm = cube.spectral_smooth(kern)
        si = sm.spectral_interpolate(sm.spectral_axis[::2],
                                     smooth_kernel=kern)
        out[str(dev)] = si.sigma_clip_spectrally(1.0)
        counts = K.launch_counts()
        if str(dev) == "cpu":
            assert all(n == 0 for n in counts.values()), counts
        else:
            assert counts["smooth_interp"] == 1, counts
            assert counts["sigma_clip"] == 1, counts
    # the two devices' smoothing products round differently, so a sample
    # within rounding of a clip threshold may fall either way
    a, b = out["cpu"]._data, out[str(cuda)]._data.cpu()
    flips = torch.isnan(a) != torch.isnan(b)
    assert int(flips.sum()) <= 1e-3 * a.numel()
    both = ~torch.isnan(a) & ~torch.isnan(b)
    # five 1-sigma clips keep ~8% of a Gaussian's samples
    assert int(both.sum()) > 0.03 * a.numel()
    torch.testing.assert_close(b[both], a[both], rtol=1e-5, atol=1e-5)
