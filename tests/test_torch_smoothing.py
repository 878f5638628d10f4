"""Torch port, spectral/spatial smoothing, median filters and sigma clipping
(``ops/smoothing.py``, kernel 4 ``kernels/sigma_clip.py``) against the JAX
package.

The same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode, or its jnp path) and through the port on CPU tensors,
where the kernel's wrapper runs its plain PyTorch version.  Tolerances:
the sigma clip's kept values are copies of the input, so NaN patterns and
values are held exactly; banded convolutions 1e-6 relative (the numerics
contract of the JAX package) where the normalized-convolution denominator is
well conditioned; median filters exactly (both sort the same values).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.ops import smoothing as jsm
from spectral_cube_tpu.ops.clip_pallas import sigma_clip_fused

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.kernels import sigma_clip as kclip
from spectral_cube_tpu_torch.ops import smoothing as tsm


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got[fin], want[fin])


def _assert_close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _holes(shape, seed, kind):
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32) + 1.0
    if kind in ("holes", "allnan"):
        data[3:6, 1, 2] = np.nan
        data[0, 2, 1] = np.nan
        data[-1, 0, 0] = np.inf
    if kind == "allnan":
        data[:, 2, 3] = np.nan
    return data


def test_gaussian_kernel1d_matches_jax():
    for stddev, size in ((2.0, None), (0.7, None), (1.5, 9)):
        np.testing.assert_array_equal(tsm.gaussian_kernel1d(stddev, size),
                                      jsm.gaussian_kernel1d(stddev, size))


@pytest.mark.parametrize("kind", ["clean", "holes", "allnan"])
@pytest.mark.parametrize("nchan", [40, 600])
def test_convolve1d_nan_matches_jax(kind, nchan):
    """Dense banded product (40 channels) and the overlap-save blocks
    (600 channels), clean, with NaN holes and an all-NaN spectrum."""
    data = _holes((nchan, 4, 5), nchan, kind)
    kern = jsm.gaussian_kernel1d(2.0)
    got = tsm.convolve1d_nan(torch.as_tensor(data), kern).numpy()
    want = np.asarray(jsm.convolve1d_nan(jnp.asarray(data), kern))
    _assert_close(got, want, rtol=1e-6, atol=1e-6)
    if kind == "allnan":
        assert np.isnan(got[:, 2, 3]).all()


def test_convolve1d_nan_other_axis_and_asymmetric_kernel():
    data = _holes((12, 30, 7), 3, "holes")
    kern = np.array([0.1, 0.5, 0.2, 0.05])
    got = tsm.convolve1d_nan(torch.as_tensor(data), kern, axis=1).numpy()
    want = np.asarray(jsm.convolve1d_nan(jnp.asarray(data), kern, axis=1))
    _assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["separable", "full_rank"])
def test_spatial_smooth_cube_matches_jax(kind):
    """A Gaussian takes the separable convolution kernel's plain version;
    a random full-rank kernel the conv2d path."""
    data = _holes((5, 20, 23), 7, "allnan")
    data[2, :, :] = np.nan
    if kind == "separable":
        y = np.arange(7) - 3.0
        kern = np.exp(-0.5 * (y[:, None] ** 2 + (y[None, :] / 1.5) ** 2))
    else:
        kern = np.random.RandomState(2).rand(5, 4) + 0.1
    got = tsm.spatial_smooth_cube(torch.as_tensor(data), kern).numpy()
    want = np.asarray(jsm.spatial_smooth_cube(jnp.asarray(data), kern))
    _assert_close(got, want, rtol=1e-5, atol=2e-6)
    assert np.isnan(got[2]).all()


@pytest.mark.parametrize("size", [3, 4, 7])
def test_spectral_median_filter_matches_jax(size):
    """Odd and even windows (numpy averages the two middle values, where
    torch.median would take the lower), NaN propagation, reflect edges."""
    data = _holes((9, 3, 4), size, "holes")
    got = tsm.spectral_median_filter_cube(torch.as_tensor(data), size)
    want = jsm.spectral_median_filter_cube(jnp.asarray(data), size)
    _assert_same(got.numpy(), want)


@pytest.mark.parametrize("size", [3, (2, 3), (4, 1)])
def test_spatial_median_filter_matches_jax(size):
    data = _holes((3, 7, 6), 4, "holes")
    got = tsm.spatial_median_filter_cube(torch.as_tensor(data), size)
    want = jsm.spatial_median_filter_cube(jnp.asarray(data), size)
    _assert_same(got.numpy(), want)


def _clip_case(nchan, seed):
    """The JAX test's case (test_smoothing.py:548-568): a NaN hole, an
    all-NaN spaxel, +inf and -inf treated as missing."""
    rng = np.random.RandomState(seed)
    data = rng.randn(nchan, 8, 128).astype(np.float32) * 2.0
    data[3, 2, 5] = np.nan
    data[:, 1, 7] = np.nan
    data[min(10, nchan - 1), 0, 0] = np.inf
    data[min(11, nchan - 1), 0, 1] = -np.inf
    return data


@pytest.mark.parametrize("use_mean,nchan", [(False, 37), (True, 37),
                                            (False, 64), (True, 64)])
def test_sigma_clip_plain_matches_fused_pallas(use_mean, nchan):
    """Kernel 4's plain version, bitwise against the fused Pallas kernel
    in interpret mode and against the sorted-band jnp path."""
    data = _clip_case(nchan, 5)
    got = kclip.sigma_clip(torch.as_tensor(data), 1.0, 5, use_mean).numpy()
    fused = np.asarray(sigma_clip_fused(data, 1.0, 5, use_mean,
                                        interpret=True))
    band = np.asarray(jsm.sigma_clip_spectrally(
        jnp.asarray(data), sigma=1.0, maxiters=5,
        cenfunc="mean" if use_mean else "median"))
    _assert_same(got, fused)
    _assert_same(got, band)
    assert np.isnan(got[:, 1, 7]).all()
    assert 0.3 < np.isnan(got).mean() < 0.99


@pytest.mark.parametrize("reference", ["fused_pallas", "jnp_band"])
def test_sigma_clip_plain_keeps_a_spectrum_at_a_rounded_threshold(reference):
    """A 2-channel spectrum whose clip band edge depends on the last bit
    of a float32 square root: the correctly rounded root keeps both
    samples, as the JAX package and the card do (the CPU's float32
    torch.sqrt, not correctly rounded, clipped both)."""
    spectrum = np.array([-3.6108625, -0.02096638], np.float32)
    # every spaxel of the (8, 128) tile the fused kernel takes
    data = np.ascontiguousarray(np.broadcast_to(spectrum[:, None, None],
                                                (2, 8, 128)))
    got = kclip.sigma_clip_plain(torch.as_tensor(data), 1.0, 5,
                                 False).numpy()
    if reference == "fused_pallas":
        want = np.asarray(sigma_clip_fused(data, 1.0, 5, False,
                                           interpret=True))
    else:
        want = np.asarray(jsm.sigma_clip_spectrally(
            jnp.asarray(data), sigma=1.0, maxiters=5, cenfunc="median"))
    _assert_same(got, want)
    _assert_same(got, data)


@pytest.mark.parametrize("stdfunc", ["std", "mad_std"])
@pytest.mark.parametrize("cenfunc", ["median", "mean"])
def test_sigma_clip_spectrally_matches_jax_ragged(stdfunc, cenfunc):
    """A ragged (23, 7, 33) cube, both centres, std and mad_std, against
    the jnp path; maxiters 0 keeps every finite sample."""
    rng = np.random.RandomState(9)
    data = rng.randn(23, 7, 33).astype(np.float32)
    data[4, 2, 3] = np.nan
    data[:, 6, 32] = np.nan
    data[7, 1, 1] = 40.0
    for sigma, maxiters in ((1.5, 5), (2.5, 2), (1.0, 0)):
        got = tsm.sigma_clip_spectrally(torch.as_tensor(data), sigma,
                                        maxiters, cenfunc, stdfunc).numpy()
        want = np.asarray(jsm.sigma_clip_spectrally(
            jnp.asarray(data), sigma, maxiters, cenfunc, stdfunc))
        _assert_same(got, want)
    assert np.isnan(got).sum() == np.isnan(data).sum()


def test_band_sum_runs_in_the_kernels_order():
    """band_sum adds per lane l the rows l, l+32, ... in turn, then an xor
    butterfly over the lanes: the order csrc/sigma_clip.cu uses, which
    makes kernel and plain version agree bitwise."""
    rng = np.random.RandomState(1)
    vals = (rng.randn(75, 3) * 10.0 ** rng.randint(-3, 4, (75, 3))) \
        .astype(np.float32)
    band = np.ones((75, 3), bool)
    band[:9, 0] = False
    band[60:, 1] = False
    got = kclip.band_sum(torch.as_tensor(vals), torch.as_tensor(band))
    for col in range(3):
        lanes = np.zeros(32, np.float32)
        for i in range(75):
            if band[i, col]:
                lanes[i % 32] = np.float32(lanes[i % 32] + vals[i, col])
        off = 16
        while off:
            lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
            off //= 2
        assert got[col].item() == lanes[0]


@pytest.mark.parametrize("nchan,R", [(1, 1), (32, 1), (33, 2), (512, 16),
                                     (513, 32), (1024, 32), (1025, 0)])
def test_sigma_clip_plan_register_classes(nchan, R):
    """The kernel sorts up to 1024 channels in registers, R = npad / 32
    values a lane (npad the power of two at or above nchan, at least 32);
    longer spectra take the shared-memory network (R = 0)."""
    p = kclip.plan(nchan)
    assert p.R == R
    if R == 0:
        assert p == kclip.Plan(0, 0, 0, 0)
        return
    assert p.warps == kclip.REG_WARPS and p.spaxels in kclip.REG_SPAXELS
    pitch = nchan | 1
    assert p.smem == 4 * (p.spaxels * pitch + p.warps * 33 * R
                          + 3 * p.spaxels)
    assert p.smem + kclip.SMEM_RESERVED <= kclip.SMEM_SM


@pytest.mark.parametrize("nchan,spaxels", [(312, 32), (623, 16), (1024, 8)])
def test_sigma_clip_plan_keeps_warps_resident(nchan, spaxels):
    """At the spectral path's lengths the plan takes the most spaxels a
    block that still leave 24 warps resident on an SM."""
    p = kclip.plan(nchan)
    assert p.spaxels == spaxels
    blocks = kclip.SMEM_SM // (p.smem + kclip.SMEM_RESERVED)
    assert blocks * p.warps >= kclip.WARPS_TARGET


def test_sigma_clip_plan_rejects_empty_spectra():
    with pytest.raises(ValueError, match="nchan"):
        kclip.plan(0)


def test_sigma_clip_options():
    data = torch.as_tensor(_clip_case(16, 2))
    with pytest.raises(NotImplementedError, match="cenfunc"):
        tsm.sigma_clip_spectrally(data, cenfunc=np.max)
    with pytest.raises(NotImplementedError, match="stdfunc"):
        tsm.sigma_clip_spectrally(data, stdfunc="iqr")
    K.reset_launch_counts()
    out = tsm.sigma_clip_spectrally(data.double(), 2.0)
    assert out.dtype == torch.float64
    _assert_same(out.float().numpy(),
                 tsm.sigma_clip_spectrally(data, 2.0).numpy())
    assert K.launch_counts()["sigma_clip"] == 0


def test_sigma_clip_routes_every_float32_std_clip_to_the_wrapper(
        monkeypatch):
    """float32 data with stdfunc='std' reaches kernel 4's wrapper at any
    shape and spectrum length (on a CUDA tensor the wrapper launches the
    kernel or raises); mad_std and float64 stay plain."""
    calls = []
    wrapper = kclip.sigma_clip

    def spy(data, *args):
        calls.append(tuple(data.shape))
        return wrapper(data, *args)

    monkeypatch.setattr(kclip, "sigma_clip", spy)
    rng = np.random.RandomState(4)
    for shape in ((20000,), (40, 3), (16, 2, 3)):
        x = torch.as_tensor(rng.randn(*shape).astype(np.float32))
        out = tsm.sigma_clip_spectrally(x, 2.0)
        assert calls[-1] == shape and out.shape == shape
    n = len(calls)
    tsm.sigma_clip_spectrally(x, 2.0, stdfunc="mad_std")
    tsm.sigma_clip_spectrally(x.double(), 2.0)
    assert len(calls) == n


def _cubes(tmp_path, shape=(20, 9, 11), seed=3, bunit="K"):
    """The same FITS cube read by both packages (NaN border column and a
    NaN hole), with a line on noise."""
    import spectral_cube_tpu as J
    from spectral_cube_tpu.io.fits_low import HDU, write_fits
    from conftest import base_header
    nchan, ny, nx = shape
    rng = np.random.RandomState(seed)
    data = (rng.randn(*shape) + 3.0 * np.exp(
        -0.5 * ((np.arange(nchan)[:, None, None] - nchan / 2) / 2.0) ** 2)
    ).astype(np.float32)
    data[:, :, 0] = np.nan
    data[4:6, 3, 4] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan, bunit=bunit)
    h["BITPIX"] = -32
    p = str(tmp_path / "smooth.fits")
    write_fits(p, [HDU(data=data, header=h)])
    return T.SpectralCube.read(p, device="cpu"), J.SpectralCube.read(p)


def _assert_cube(tc, jc, rtol=1e-6, atol=1e-6, exact=False):
    assert tc.shape == jc.shape
    t = tc._get_filled_data(fill=np.nan).numpy()
    j = np.asarray(jc._get_filled_data(fill=np.nan))
    if exact:
        _assert_same(t, j)
    else:
        _assert_close(t, j, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(tc.get_mask_array(),
                                  np.asarray(jc.get_mask_array()))


def test_cube_smoothing_methods_match_jax(tmp_path):
    tcube, jcube = _cubes(tmp_path)
    kern = jsm.gaussian_kernel1d(1.5)
    _assert_cube(tcube.spectral_smooth(kern), jcube.spectral_smooth(kern))
    _assert_cube(tcube.spectral_smooth_median(4),
                 jcube.spectral_smooth_median(4), exact=True)
    y = np.arange(5) - 2.0
    k2 = np.exp(-0.5 * (y[:, None] ** 2 + y[None, :] ** 2))
    _assert_cube(tcube.spatial_smooth(k2), jcube.spatial_smooth(k2),
                 rtol=1e-5, atol=2e-6)
    _assert_cube(tcube.spatial_smooth_median(3),
                 jcube.spatial_smooth_median(3), exact=True)
    from scipy import ndimage
    _assert_cube(tcube.spectral_filter(3, ndimage.maximum_filter),
                 jcube.spectral_filter(3, ndimage.maximum_filter),
                 exact=True)
    _assert_cube(tcube.spatial_filter(3, ndimage.minimum_filter),
                 jcube.spatial_filter(3, ndimage.minimum_filter),
                 exact=True)


def test_cube_sigma_clip_matches_jax(tmp_path):
    tcube, jcube = _cubes(tmp_path, shape=(31, 8, 13))
    K.reset_launch_counts()
    for kw in ({}, {"cenfunc": "mean"}, {"stdfunc": "mad_std"}):
        t = tcube.sigma_clip_spectrally(1.2, **kw)
        j = jcube.sigma_clip_spectrally(1.2, **kw)
        _assert_cube(t, j, exact=True)
        assert t.device == torch.device("cpu")
    assert K.launch_counts()["sigma_clip"] == 0
    hits = []
    tcube.sigma_clip_spectrally(2.0, update_function=lambda: hits.append(1))
    assert len(hits) == 8 * 13
    with pytest.raises(ValueError, match="incompatible"):
        tcube.sigma_clip_spectrally(2.0, parallel=False, num_cores=4)
    with pytest.raises(TypeError, match="unsupported sigma_clip"):
        tcube.sigma_clip_spectrally(2.0, grow=1)


def test_jybeam_spatial_smoothing_guard(tmp_path):
    from spectral_cube_tpu_torch.beams import BeamUnitsError
    tcube, _ = _cubes(tmp_path, bunit="JY/BEAM")
    with pytest.raises(BeamUnitsError):
        tcube.spatial_smooth_median(3)
    with pytest.raises(BeamUnitsError):
        tcube.check_jybeam_smoothing()
    assert tcube.spatial_smooth_median(3, raise_error_jybm=False).shape \
        == tcube.shape
    with pytest.raises(T.units.UnitsError, match="without a unit"):
        tcube.spectral_smooth(T.Quantity(np.ones(3), "km/s"))
