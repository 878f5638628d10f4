"""Torch port, kernel 2 (per-channel separable normalized convolution)
against the JAX package.

The same numpy inputs go through the JAX function (its Pallas strips
kernels in interpret mode, or its dense einsum path) and through the port
on CPU tensors, where the kernel's wrapper runs its plain PyTorch version;
a float64 scipy oracle convolves with the full 2-D kernel.  Tolerances:
rtol 3e-5 / atol 1e-5 against float64 for unit-variance noise data, the
JAX strips-kernel tests' own (test_banded_pallas.py:268); 1e-6 relative to
the data scale between two f32 implementations, and on smooth positive
data against float64 (CLAUDE.md's 1e-6 contract); NaN pattern exact first.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal
import torch

from spectral_cube_tpu.beams import Beam as JBeam
from spectral_cube_tpu.ops import banded_pallas as jbp
from spectral_cube_tpu.ops import convolve as jconv
from spectral_cube_tpu.ops.smoothing import _banded_conv_matrix as j_banded
from spectral_cube_tpu.units import Quantity as JQ

from spectral_cube_tpu_torch.beams import Beam as TBeam
from spectral_cube_tpu_torch.kernels import conv_sep as kconv
from spectral_cube_tpu_torch.ops import convolve as tconv
from spectral_cube_tpu_torch.ops.smoothing import _banded_conv_matrix
from spectral_cube_tpu_torch.units import Quantity as TQ


def _gauss2d(sig_y, sig_x, theta=0.0, size=15):
    x = np.arange(size) - size // 2
    yy, xx = np.meshgrid(x, x, indexing="ij")
    yr = yy * np.cos(theta) + xx * np.sin(theta)
    xr = -yy * np.sin(theta) + xx * np.cos(theta)
    k = np.exp(-0.5 * ((yr / sig_y) ** 2 + (xr / sig_x) ** 2))
    return k / k.sum()


def scipy_oracle(data, kernels, group_idx):
    """float64 normalized convolution with the full 2-D kernels, zero-fill
    boundary, centred at (k - 1) // 2 (the banded-matrix convention)."""
    out = np.empty(data.shape, np.float64)
    for c in range(data.shape[0]):
        k = np.asarray(kernels[group_idx[c]], np.float64)
        cy, cx = (k.shape[0] - 1) // 2, (k.shape[1] - 1) // 2
        ny, nx = data.shape[1:]

        def conv(a):
            return scipy.signal.convolve2d(a, k, mode="full")[
                cy:cy + ny, cx:cx + nx]
        v = np.isfinite(data[c])
        num = conv(np.where(v, data[c], 0.0).astype(np.float64))
        den = 1.0 - conv((~v).astype(np.float64))
        o = np.where(den > 1e-6, num / np.where(den > 1e-6, den, 1.0),
                     np.nan)
        out[c] = o if v.any() else np.nan
    return out


def _run_groups(data, kernels, group_idx):
    facs = [jconv.separable_factors(k) for k in kernels]
    return tconv._convolve_groups(torch.as_tensor(data),
                                  [f[0] for f in facs], [f[1] for f in facs],
                                  group_idx).numpy()


def _dense_ops(kernels, ny, nx):
    facs = [jconv.separable_factors(k) for k in kernels]
    r = max(f[0].shape[1] for f in facs)
    my = np.zeros((len(kernels), r, ny, ny), np.float32)
    mx = np.zeros((len(kernels), r, nx, nx), np.float32)
    for g, (yt, xt) in enumerate(facs):
        for i in range(yt.shape[1]):
            my[g, i] = j_banded(ny, yt[:, i])
            mx[g, i] = j_banded(nx, xt[:, i])
    return my, mx


KERNELS = [_gauss2d(2.0, 2.0), _gauss2d(3.0, 1.5, theta=0.15),
           _gauss2d(2.5, 1.8, theta=0.1)]


@pytest.mark.parametrize("dirty", [False, True])
def test_interleaved_groups_match_pallas_strips(dirty):
    """Three groups (rank 1 and rank > 1), interleaved over channels,
    against per_channel_conv_strips in interpret mode and the oracle."""
    rng = np.random.RandomState(2)
    nchan, ny, nx = 6, 128, 128      # the strips kernel's K=128 planes
    data = rng.randn(nchan, ny, nx).astype(np.float32)
    if dirty:
        data[1, 30:40, 50:60] = np.nan
        data[4] = np.nan               # all-NaN channel
    group_idx = np.array([0, 1, 2, 1, 0, 2], np.int32)
    assert max(jconv.separable_factors(k)[0].shape[1] for k in KERNELS) > 1
    got = _run_groups(data, KERNELS, group_idx)
    my, mx = _dense_ops(KERNELS, ny, nx)
    ref = np.asarray(jbp.per_channel_conv_strips(
        jnp.asarray(data), my, mx, group_idx, interpret=True))
    exp = scipy_oracle(data, KERNELS, group_idx)
    assert np.array_equal(np.isnan(got), np.isnan(exp))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(exp)
    np.testing.assert_allclose(got[ok], exp[ok], rtol=3e-5, atol=1e-5)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=3e-5, atol=1e-5)


def test_contiguous_groups_match_blocked_strips():
    """Contiguous groups: the TPU's channel-blocked kernel; on the card
    the same kernel as interleaved groups."""
    rng = np.random.RandomState(4)
    nchan, ny, nx = 4, 128, 128
    data = rng.randn(nchan, ny, nx).astype(np.float32)
    data[2, 3:6, 7:30] = np.nan
    group_idx = np.array([0, 0, 1, 1], np.int32)
    kernels = KERNELS[1:]
    got = _run_groups(data, kernels, group_idx)
    my, mx = _dense_ops(kernels, ny, nx)
    ref = np.asarray(jbp.per_channel_conv_strips_blocked(
        jnp.asarray(data), my, mx, group_idx, cb=2, interpret=True))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=3e-5, atol=1e-5)


@pytest.mark.parametrize("kshape,theta", [((9, 9), 0.0), ((11, 11), 0.3),
                                          ((8, 8), 0.0), ((6, 10), 0.3)])
def test_convolve2d_separable_matches_jax_and_scipy(kshape, theta):
    """Odd and even kernels, rank 1 and rank > 1, on a ragged plane with
    a NaN patch and an all-NaN channel, against the JAX dense path and the
    float64 oracle; the clean channel is a plain convolution."""
    rng = np.random.RandomState(9)
    data = (1.0 + rng.rand(5, 23, 37)).astype(np.float32)
    data[1, 4:9, 10:14] = np.nan
    data[3] = np.nan
    y = np.arange(kshape[0]) - (kshape[0] - 1) / 2
    x = np.arange(kshape[1]) - (kshape[1] - 1) / 2
    yy, xx = np.meshgrid(y, x, indexing="ij")
    yr = yy * np.cos(theta) + xx * np.sin(theta)
    xr = -yy * np.sin(theta) + xx * np.cos(theta)
    k = np.exp(-0.5 * ((yr / 2.2) ** 2 + (xr / 1.3) ** 2))
    k /= k.sum()
    got = tconv.convolve2d_separable(torch.as_tensor(data), k).numpy()
    ref = np.asarray(jconv.convolve2d_separable(jnp.asarray(data), k))
    exp = scipy_oracle(data, [k], np.zeros(5, np.int32))
    assert np.array_equal(np.isnan(got), np.isnan(exp))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(exp)
    np.testing.assert_allclose(got[ok], exp[ok], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lengths", [(5, 5), (4, 7), (1, 6), (8, 3, 2)])
def test_tap_stack_reproduces_banded_matrices(lengths):
    """One (G, r, L) stack with one centre offset places every group's
    flipped taps where _banded_conv_matrix puts them, odd or even."""
    rng = np.random.RandomState(len(lengths))
    taps = [rng.rand(n, 2) for n in lengths]
    stack, h = tconv._tap_stack(taps)
    n = 13
    for g, t in enumerate(taps):
        for i in range(2):
            dense = np.zeros((n, n), np.float32)
            for o, kv in enumerate(stack[g, i]):
                d = o - h
                idx = np.arange(max(0, -d), min(n, n - d))
                dense[idx, idx + d] = kv
            np.testing.assert_array_equal(dense,
                                          _banded_conv_matrix(n, t[:, i]))
            np.testing.assert_array_equal(dense, j_banded(n, t[:, i]))


def test_convolve_cube_to_beam_matches_jax_several_groups():
    """Per-channel beams (three groups, contiguous and interleaved) in the
    JAX package's beam grouping, with the Jy/beam factors."""
    rng = np.random.RandomState(6)
    data = rng.randn(6, 24, 20).astype(np.float32)
    data[2, :3, :4] = np.nan
    pix = np.radians(1.0 / 3600.0)
    majors = [2.0, 2.0, 2.5, 3.0, 2.5, 2.0]
    jbeams = [JBeam(JQ(m, "arcsec"), JQ(m, "arcsec"), JQ(0, "deg"))
              for m in majors]
    tbeams = [TBeam(TQ(m, "arcsec"), TQ(m, "arcsec"), TQ(0, "deg"))
              for m in majors]
    jt = JBeam(JQ(6.0, "arcsec"), JQ(6.0, "arcsec"), JQ(0, "deg"))
    tt = TBeam(TQ(6.0, "arcsec"), TQ(6.0, "arcsec"), TQ(0, "deg"))
    from spectral_cube_tpu.units import Unit as JUnit
    from spectral_cube_tpu_torch.units import Unit as TUnit
    got, tf = tconv.convolve_cube_to_beam(torch.as_tensor(data), tbeams, tt,
                                          pix, unit=TUnit.parse("Jy/beam"))
    ref, jf = jconv.convolve_cube_to_beam(jnp.asarray(data), jbeams, jt, pix,
                                          unit=JUnit.parse("Jy/beam"))
    np.testing.assert_allclose(tf, jf, rtol=1e-12)
    got, ref = got.numpy(), np.asarray(ref)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=3e-5, atol=1e-5)


def test_non_separable_kernel_raises(monkeypatch):
    """Kernels that do not SVD-separate take the JAX package's FFT path;
    the port raises instead of degrading."""
    rng = np.random.RandomState(1)
    k = rng.rand(9, 9)
    data = torch.zeros((2, 16, 16))
    assert tconv.convolve2d_separable(data, k) is None
    assert tconv.convolve_per_channel_separable(
        data, [k], np.zeros(2, np.int32)) is None
    monkeypatch.setattr(tconv, "separable_factors",
                        lambda *a, **kw: None)
    b = TBeam(TQ(2.0, "arcsec"), TQ(2.0, "arcsec"), TQ(0, "deg"))
    t = TBeam(TQ(5.0, "arcsec"), TQ(5.0, "arcsec"), TQ(0, "deg"))
    with pytest.raises(NotImplementedError, match="FFT"):
        tconv.convolve_cube_to_beam(data, b, t, np.radians(1 / 3600.0))


def test_plain_clean_channels_skip_the_denominator():
    """A clean channel's output is the plain convolution bit for bit (den
    is 1 exactly), whatever the other channels hold; CPU tensors never
    touch the kernel counter."""
    kconv.conv_sep.launches = 0
    rng = np.random.RandomState(3)
    data = rng.rand(3, 12, 14).astype(np.float32)
    k = _gauss2d(1.5, 1.0, theta=0.4, size=7)
    clean = tconv.convolve2d_separable(torch.as_tensor(data), k)
    data[1, 2, 2] = np.nan
    mixed = tconv.convolve2d_separable(torch.as_tensor(data), k)
    assert torch.equal(clean[0], mixed[0])
    assert torch.equal(clean[2], mixed[2])
    assert not torch.equal(clean[1], mixed[1])
    assert kconv.conv_sep.launches == 0
