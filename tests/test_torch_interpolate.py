"""Torch port, spectral interpolation, the fused smooth + interpolation
(kernel 5, ``kernels/smooth_interp.py``), downsampling, and the spectral
path through the cube methods, against the JAX package.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode, or its jnp path) and through the port on CPU tensors,
where the kernel's wrapper runs its plain PyTorch version.  Tolerances
for the fused smooth + interpolation are those of the JAX kernels' own
tests (test_banded_pallas.py:98-213): NaN patterns exact, 3e-5 / 1e-5
where the smoothing denominator is well conditioned and 5e-3 / 1e-3 where
it is not (a window that is nearly all NaN, where float32 rounding of den
is amplified by 1/den).  Gathers and block reductions agree to 1e-6.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu.io.fits_low import HDU, write_fits
from spectral_cube_tpu.ops import interpolate as jip
from spectral_cube_tpu.ops.banded_pallas import (smooth_interp_strips,
                                                 smooth_interp_strips_3d)
from spectral_cube_tpu.ops.smoothing import gaussian_kernel1d

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.kernels import smooth_interp as ksi
from spectral_cube_tpu_torch.ops import interpolate as tip
from spectral_cube_tpu_torch.ops import smoothing as tsm

from conftest import base_header


def _operators(nin, kern, outaxis=None):
    """(M, S, I) as the JAX kernels' tests build them."""
    inaxis = np.arange(nin, dtype=np.float64)
    outaxis = inaxis[::2] if outaxis is None else outaxis
    k = np.asarray(kern, np.float64)
    k = k / k.sum()
    S = tsm._banded_conv_matrix(nin, k)
    idx, frac = tip.interp_weights(inaxis, outaxis)
    I = tip._interp_matrix(idx, frac, nin)
    M = (I.astype(np.float64) @ S.astype(np.float64)).astype(np.float32)
    return M, S, I, inaxis, outaxis


def _oracle(data, kern, inaxis, outaxis):
    """Independent float64 chain (test_banded_pallas.py:71-94): normalized
    banded smooth, then 2-tap interp with NaN poisoning, and the outputs
    that draw on an ill-conditioned (den < 0.05) smooth window."""
    nin = data.shape[0]
    k = np.asarray(kern, np.float64)
    k = k / k.sum()
    S = tsm._banded_conv_matrix(nin, k).astype(np.float64)
    v = np.isfinite(data)
    num = S @ np.where(v, data, 0.0).astype(np.float64)
    den = 1.0 - S @ (~v).astype(np.float64)
    sm = np.where(den > 1e-6, num / np.where(den > 1e-6, den, 1.0), np.nan)
    sm = np.where(np.any(v, axis=0, keepdims=True), sm, np.nan)
    idx, frac = tip.interp_weights(inaxis, outaxis)
    I = tip._interp_matrix(idx, frac, nin).astype(np.float64)
    gap = np.isnan(sm)
    out = I @ np.where(gap, 0.0, sm)
    out = np.where(I @ gap.astype(np.float64) > 0, np.nan, out)
    return out, (I @ (den < 0.05).astype(np.float64)) > 0


def _assert_si(got, want, illcond):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want) & ~illcond
    np.testing.assert_allclose(got[ok], want[ok], rtol=3e-5, atol=1e-5)
    loose = np.isfinite(want) & illcond
    np.testing.assert_allclose(got[loose], want[loose], rtol=5e-3,
                               atol=1e-3)


KERN17 = np.exp(-0.5 * ((np.arange(17) - 8) / 2.0) ** 2)


@pytest.mark.parametrize("dirty", [False, True])
def test_smooth_interp_plain_matches_strips_3d(dirty):
    """(128, 16, 128) slabs, with a NaN hole, an all-NaN spaxel and an
    edge NaN, as test_smooth_interp_strips_3d has them.  (128 channels:
    the TPU kernels' strip planner needs at least 128.)"""
    rng = np.random.RandomState(5)
    nin, ny, nx = 128, 16, 128
    data = rng.randn(nin, ny, nx).astype(np.float32)
    if dirty:
        data[40:60, 3, 5] = np.nan
        data[:, 7, 9] = np.nan
        data[0, 12, 100] = np.nan
    M, S, I, inaxis, outaxis = _operators(nin, KERN17)
    got = ksi.smooth_interp(torch.as_tensor(data), M, S, I).numpy()
    ref = np.asarray(smooth_interp_strips_3d(jnp.asarray(data), M, S, I,
                                             interpret=True))
    exp, ill = _oracle(data.reshape(nin, -1), KERN17, inaxis, outaxis)
    ill = ill.reshape(ref.shape)
    _assert_si(got, ref, ill)
    _assert_si(got, exp.reshape(ref.shape), ill)


@pytest.mark.parametrize("dirty", [False, True])
def test_smooth_interp_plain_matches_strips_flat(dirty):
    """The flat (nin, S) form at (128, 256)."""
    rng = np.random.RandomState(1)
    nin = 128
    data = rng.randn(nin, 256).astype(np.float32)
    if dirty:
        data[40:60, 3] = np.nan
        data[:, 7] = np.nan
        data[0, 100] = np.nan
        data[1:127, 200] = np.nan       # a nearly-all-NaN window
    M, S, I, inaxis, outaxis = _operators(nin, KERN17)
    got = ksi.smooth_interp(torch.as_tensor(data), M, S, I).numpy()
    ref = np.asarray(smooth_interp_strips(jnp.asarray(data), M, S, I,
                                          interpret=True))
    exp, ill = _oracle(data, KERN17, inaxis, outaxis)
    _assert_si(got, ref, ill)
    _assert_si(got, exp, ill)


def test_smooth_interp_plain_cancellation():
    """A negative-tap kernel cancels entries of M = I @ S that the chain
    still reads (test_banded_pallas.py:180-213): dirtiness comes from the
    input's finiteness, so NaN in cancelled columns still renormalize."""
    rng = np.random.RandomState(3)
    nin = 256
    kern = np.array([1.0, -1.0, 1.0])
    M, S, I, inaxis, outaxis = _operators(
        nin, kern, np.arange(nin, dtype=np.float64)[:248] + 0.5)
    pat = (np.abs(I).astype(np.float64) @ np.abs(S).astype(np.float64)) > 0
    assert (pat & (M == 0.0)).any()
    data = rng.randn(nin, 256).astype(np.float32)
    data[50, 0] = np.nan
    data[128:131, 5] = np.nan
    got = ksi.smooth_interp(torch.as_tensor(data), M, S, I).numpy()
    ref = np.asarray(smooth_interp_strips(jnp.asarray(data), M, S, I,
                                          interpret=True))
    exp, ill = _oracle(data, kern, inaxis, outaxis)
    _assert_si(got, ref, ill)
    _assert_si(got, exp, ill)


def test_band_rows_cover_every_nonzero():
    """The kernel's compact bands reproduce the dense operators; exact
    grid hits leave one tap per interpolation row, others two."""
    for shift, width in ((0.0, 1), (0.25, 2)):
        M, S, I, _, _ = _operators(40, KERN17, np.arange(40.0)[::2] + shift)
        for A in (M, S, I):
            start, taps = ksi.band_rows(A)
            dense = np.zeros_like(A)
            for r in range(A.shape[0]):
                dense[r, start[r]:start[r] + taps.shape[1]] = taps[r]
            np.testing.assert_array_equal(dense, A)
        assert ksi.band_rows(I)[1].shape[1] == width


@pytest.mark.parametrize("nin,ncol,aligned,tile,staging,stages", [
    (623, 768 * 768, True, 32, "cp.async16", 2),   # the spectral path's view
    (623, 41, True, 32, "cp.async4", 2),           # rows of 164 bytes
    (623, 300, False, 32, "cp.async4", 2),         # a base off 16 bytes
    (40, 300, True, 32, "cp.async16", 2),
    (904, 300, True, 32, "cp.async16", 2),         # the widest ring's last
    (905, 300, True, 16, "cp.async16", 2),
    (2000, 300, True, 8, "cp.async16", 2),
    (2000, 41, True, 8, "cp.async4", 2),
    (7300, 300, True, 2, "cp.async4", 2),          # 8-byte rows
    (28928, 8, True, 1, "cp.async4", 2),
    (28929, 8, True, 1, "cp.async4", 1),           # one slab: no ring
])
def test_smooth_interp_plan(nin, ncol, aligned, tile, staging, stages):
    """The widest tile whose ring of two slabs fits a block, one slab where
    two do not; 16-byte copies only where every row of the view is 16-byte
    aligned."""
    p = ksi.plan(nin, ncol, aligned)
    assert (p.tile, p.staging, p.stages) == (tile, staging, stages)
    assert p.smem == stages * nin * tile * 4 <= ksi.SMEM_MAX


def test_smooth_interp_plan_declines_spectra_past_shared_memory():
    assert ksi.plan(57856, 8).stages == 1
    assert ksi.plan(57857, 8) is None


@pytest.mark.parametrize("descending", [False, True])
def test_interp_weights_and_compose_match_jax(descending):
    inaxis = np.linspace(-3.0, 40.0, 37)
    if descending:
        inaxis = inaxis[::-1]
    outaxis = np.linspace(-5.0, 43.0, 20)
    idx_t, frac_t = tip.interp_weights(inaxis, outaxis)
    idx_j, frac_j = jip.interp_weights(inaxis, outaxis)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(frac_t, frac_j)
    S = tsm._banded_conv_matrix(37, gaussian_kernel1d(1.5))
    np.testing.assert_array_equal(
        tip.compose_interp_banded(idx_t, frac_t, S, np.float32),
        jip.compose_interp_banded(idx_j, frac_j, S, np.float32))
    with pytest.raises(ValueError, match="at least 2"):
        tip.interp_weights([1.0], outaxis)


def test_interp_cube_spectral_matches_jax_with_include():
    rng = np.random.RandomState(4)
    data = rng.randn(11, 3, 4).astype(np.float32)
    data[5, 1, 1] = np.nan
    inc = rng.rand(11, 3, 4) > 0.2
    inaxis = np.arange(11) * 2.0
    for outaxis in (np.linspace(0.0, 20.0, 7), inaxis[::2] + 1.0,
                    np.linspace(-3.0, 25.0, 9)):
        got, ginc = tip.interp_cube_spectral(torch.as_tensor(data), inaxis,
                                             outaxis, torch.as_tensor(inc))
        want, winc = jip.interp_cube_spectral(jnp.asarray(data), inaxis,
                                              outaxis, jnp.asarray(inc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, equal_nan=True)
        np.testing.assert_array_equal(ginc.numpy(), np.asarray(winc))


@pytest.mark.parametrize("estimator", ["mean", "sum", "median", "max",
                                       "min"])
@pytest.mark.parametrize("truncate", [False, True])
def test_downsample_axis_matches_jax(estimator, truncate):
    rng = np.random.RandomState(6)
    data = rng.randn(10, 5, 7).astype(np.float32)
    data[0:4, 0, 0] = np.nan          # an all-NaN block
    data[5, 1, 2] = np.nan
    for axis, factor in ((0, 4), (1, 2), (2, 3)):
        got = tip.downsample_axis(torch.as_tensor(data), factor, axis,
                                  estimator, truncate).numpy()
        want = np.asarray(jip.downsample_axis(jnp.asarray(data), factor,
                                              axis, estimator, truncate))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   equal_nan=True)
        inc = torch.as_tensor(np.isfinite(data))
        np.testing.assert_array_equal(
            tip.downsample_include(inc, factor, axis, truncate).numpy(),
            np.asarray(jip.downsample_include(jnp.asarray(np.isfinite(data)),
                                              factor, axis, truncate)))


def test_smooth_interp_cube_matches_jax():
    """The op, float32 through the plain kernel version, against the JAX
    op's CPU chain, with an include mask; float64 takes the chain."""
    rng = np.random.RandomState(8)
    data = rng.randn(30, 4, 6).astype(np.float32)
    data[10:12, 1, 1] = np.nan
    inc = rng.rand(30, 4, 6) > 0.1
    inaxis = np.arange(30) * 1.5 + 3.0
    outaxis = inaxis[1::2] + 0.3
    kern = gaussian_kernel1d(2.0)
    got, ginc = tip.smooth_interp_cube(torch.as_tensor(data), kern, inaxis,
                                       outaxis, torch.as_tensor(inc))
    want, winc = jip.smooth_interp_cube(jnp.asarray(data), kern, inaxis,
                                        outaxis, jnp.asarray(inc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(ginc.numpy(), np.asarray(winc))
    g64, _ = tip.smooth_interp_cube(torch.as_tensor(data).double(), kern,
                                    inaxis, outaxis)
    assert g64.dtype == torch.float64
    np.testing.assert_allclose(g64.numpy(), got.numpy(), rtol=3e-5,
                               atol=1e-5, equal_nan=True)


def test_linear_spectral_wcs_matches_jax():
    h = base_header(nx=3, ny=4, nchan=9)
    tw, jw = T.WCS(header=h), J.WCS(header=h)
    out = np.linspace(-300.0, -290.0, 5)
    a, b = tip.linear_spectral_wcs(tw, out), jip.linear_spectral_wcs(jw, out)
    for attr in ("crpix", "crval", "cdelt", "pc"):
        np.testing.assert_array_equal(np.asarray(getattr(a, attr)),
                                      np.asarray(getattr(b, attr)))
    assert list(a.ctype) == list(b.ctype)


def _write(path, shape=(48, 24, 40), seed=21):
    """A line on noise with a NaN border (two columns and a row) and a
    NaN hole inside some spectra; float32 on disk."""
    nchan, ny, nx = shape
    rng = np.random.RandomState(seed)
    v = np.arange(nchan)[:, None, None]
    data = (4.0 * np.exp(-0.5 * ((v - nchan / 2) / 3.0) ** 2)
            + rng.randn(*shape)).astype(np.float32)
    data[:, :, :2] = np.nan
    data[:, -1, :] = np.nan
    data[nchan // 2 - 4:nchan // 2 - 1, 5:8, nx // 4:nx // 4 + 2] = np.nan
    data[0, 3, nx - 4] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan, bunit="K")
    h["BITPIX"] = -32
    write_fits(str(path), [HDU(data=data, header=h)])


def _compare(tc, jc):
    assert tc.shape == jc.shape
    t = tc._get_filled_data(fill=np.nan).numpy()
    j = np.asarray(jc._get_filled_data(fill=np.nan))
    assert np.array_equal(np.isnan(t), np.isnan(j))
    fin = ~np.isnan(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=3e-5, atol=1e-5)
    np.testing.assert_array_equal(tc.get_mask_array(),
                                  np.asarray(jc.get_mask_array()))
    np.testing.assert_allclose(tc.spectral_axis.value,
                               np.asarray(jc.spectral_axis.value),
                               rtol=1e-12)
    for key in ("CRVAL3", "CDELT3", "CRPIX3", "CTYPE3", "NAXIS3"):
        assert tc.header[key] == jc.header[key]


def test_spectral_path_matches_jax(tmp_path):
    """The slice as a whole, read from FITS by both packages:
    spectral_smooth, then spectral_interpolate onto every second channel
    with a smooth kernel (the fused branch under the read's finiteness
    mask), then sigma_clip_spectrally; on the CPU no kernel launches."""
    p = tmp_path / "spec.fits"
    _write(p)
    tcube = T.SpectralCube.read(str(p), device="cpu")
    jcube = J.SpectralCube.read(str(p))
    kern = gaussian_kernel1d(2.0)
    K.reset_launch_counts()
    ts, js = tcube.spectral_smooth(kern), jcube.spectral_smooth(kern)
    _compare(ts, js)
    grid = tcube.spectral_axis[::2]
    ti = ts.spectral_interpolate(grid, smooth_kernel=kern)
    ji = js.spectral_interpolate(J.Quantity(grid.value, str(grid.unit)),
                                 smooth_kernel=kern)
    assert isinstance(ti.mask, T.LazyMask) and ti.shape[0] == 24
    _compare(ti, ji)
    tc, jc = ti.sigma_clip_spectrally(1.0), ji.sigma_clip_spectrally(1.0)
    _compare(tc, jc)
    assert np.isnan(tc._data.numpy()).mean() > 0.3
    assert all(n == 0 for n in K.launch_counts().values())


def test_spectral_interpolate_branches_match_jax(tmp_path):
    """The data-local comparison-mask branch (smooth, then re-evaluate the
    mask on the smoothed data), an array mask (fused, mask transformed),
    the plain interpolation with a fill value, and a reversed grid."""
    p = tmp_path / "spec.fits"
    _write(p, shape=(30, 10, 12), seed=2)
    tcube = T.SpectralCube.read(str(p), device="cpu")
    jcube = J.SpectralCube.read(str(p))
    kern = gaussian_kernel1d(1.5)
    grid = tcube.spectral_axis.value[1::2] + 0.1
    tm = tcube.with_mask(tcube > T.Quantity(0.5, "K"))
    jm = jcube.with_mask(jcube > J.Quantity(0.5, "K"))
    _compare(tm.spectral_interpolate(grid, smooth_kernel=kern),
             jm.spectral_interpolate(grid, smooth_kernel=kern))
    inc = np.isfinite(np.asarray(jcube._data)) \
        & (np.random.RandomState(0).rand(30, 10, 12) > 0.05)
    _compare(tcube.with_mask(inc).spectral_interpolate(
        grid, smooth_kernel=kern),
        jcube.with_mask(inc).spectral_interpolate(grid, smooth_kernel=kern))
    wide = np.linspace(grid[0] - 5.0, grid[-1] + 5.0, 12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _compare(tcube.spectral_interpolate(wide, fill_value=-1.0),
                 jcube.spectral_interpolate(wide, fill_value=-1.0))
        _compare(tcube.spectral_interpolate(wide, fill_value=-1.0,
                                            smooth_kernel=kern),
                 jcube.spectral_interpolate(wide, fill_value=-1.0,
                                            smooth_kernel=kern))
        rev = tcube.spectral_axis.value[::-1]
        _compare(tcube.spectral_interpolate(rev),
                 jcube.spectral_interpolate(rev))
    with pytest.raises(ValueError, match="linear"):
        tcube.spectral_interpolate(np.array([0.0, 1.0, 3.0]))


def test_spectral_interpolate_with_mask_reference_values(tmp_path):
    """Reference test_regrid.py:318-347 through the port: a reversed
    spectral axis, two masked channels NaN out the midpoints they touch,
    giving exactly [0, 0.5, nan, nan]."""
    h = base_header(nx=2, ny=2, nchan=5, bunit="K")
    h["CDELT3"] = -h["CDELT3"]
    d = np.zeros((5, 2, 2))
    d[2] = 1.0
    p = str(tmp_path / "delta.fits")
    write_fits(p, [HDU(data=d, header=h)])
    cube = T.SpectralCube.read(p, device="cpu")
    mask = np.ones(cube.shape, dtype=bool)
    mask[:2] = False
    sa = cube.spectral_axis.value
    sg = (sa[1:] + sa[:-1]) / 2.0
    result = cube.with_mask(mask).spectral_interpolate(sg[::-1])
    np.testing.assert_almost_equal(
        result._get_filled_data(fill=np.nan)[:, 0, 0].numpy(),
        [0.0, 0.5, np.nan, np.nan])


def test_cube_downsample_axis_matches_jax(tmp_path):
    p = tmp_path / "spec.fits"
    _write(p, shape=(14, 9, 10), seed=4)
    tcube = T.SpectralCube.read(str(p), device="cpu")
    jcube = J.SpectralCube.read(str(p))
    for axis, factor, est in ((0, 3, "mean"), (1, 2, "median"),
                              (2, 4, "max")):
        t = tcube.downsample_axis(factor, axis, estimator=est)
        j = jcube.downsample_axis(factor, axis, estimator=est)
        assert t.shape == j.shape
        np.testing.assert_allclose(t._data.numpy(), np.asarray(j._data),
                                   rtol=1e-6, atol=1e-7, equal_nan=True)
        np.testing.assert_array_equal(t.get_mask_array(),
                                      np.asarray(j.get_mask_array()))
        np.testing.assert_allclose(t.wcs.crpix, j.wcs.crpix)
        np.testing.assert_allclose(t.wcs.cdelt, j.wcs.cdelt)
