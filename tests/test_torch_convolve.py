"""Torch port, kernel 2 (per-channel separable normalized convolution)
and the FFT route against the JAX package.

The same numpy inputs go through the JAX function (its Pallas strips
kernels in interpret mode, or its dense einsum path) and through the port
on CPU tensors, where the kernel's wrapper runs its plain PyTorch version;
a float64 scipy oracle convolves with the full 2-D kernel.  Tolerances:
rtol 3e-5 / atol 1e-5 against float64 for unit-variance noise data, the
JAX strips-kernel tests' own (test_banded_pallas.py:268); 1e-6 relative to
the data scale between two f32 implementations, and on smooth positive
data against float64 (CLAUDE.md's 1e-6 contract); NaN pattern exact first.
The FFT route: rtol 1e-5 with atol 1e-6 * max|x| where the normalized
convolution's denominator is at least 0.1, den-weighted below it
(:func:`assert_fft_close`).
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


def _den64(data, kernels, group_idx):
    """float64 denominator 1 - K*~isfinite of each channel: the valid
    fraction of the kernel's footprint, by which the normalized
    convolution divides."""
    den = np.ones(data.shape, np.float64)
    for c in range(data.shape[0]):
        k = kernels[group_idx[c]]
        if k is None:
            continue
        k = np.asarray(k, np.float64)
        cy, cx = (k.shape[0] - 1) // 2, (k.shape[1] - 1) // 2
        ny, nx = data.shape[1:]
        bad = (~np.isfinite(data[c])).astype(np.float64)
        den[c] = 1.0 - scipy.signal.convolve2d(bad, k, mode="full")[
            cy:cy + ny, cx:cx + nx]
    return den


def assert_fft_close(got, ref, den, scale):
    """The FFT route's tolerance: NaN patterns equal; rtol 1e-5 with atol
    1e-6 * max|x| where den >= 0.1; elsewhere the division by den
    amplifies float32 rounding, so |got - ref| * den must stay within
    1e-6 * max|x|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    strong = fin & (den >= 0.1)
    np.testing.assert_allclose(got[strong], ref[strong], rtol=1e-5,
                               atol=1e-6 * scale)
    weak = fin & (den < 0.1)
    assert (np.abs(got[weak] - ref[weak]) * den[weak]).max(initial=0.0) \
        <= 1e-6 * scale


def _nan_data(shape, seed):
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32)
    ny, nx = shape[1:]
    data[1, 1:4, 2:6] = np.nan         # a flagged patch
    data[1, ny // 2, 3] = np.nan
    data[2] = np.nan                   # an all-NaN channel
    data[-1, ny - 2, nx // 3] = np.inf  # inf is invalid like NaN
    return data


def test_non_separable_kernel_raises(monkeypatch):
    """Kernels that do not SVD-separate decline both separable routes and
    take the FFT route, as in the JAX package: with ``separable_factors``
    declining in both packages, ``convolve_cube_to_beam`` convolves by
    FFT and matches the JAX package's FFT route."""
    rng = np.random.RandomState(1)
    k = rng.rand(9, 9)
    data = _nan_data((4, 16, 18), 2)
    td = torch.as_tensor(data)
    assert tconv.convolve2d_separable(td, k) is None
    assert tconv.convolve_per_channel_separable(
        td, [k], np.zeros(4, np.int32)) is None
    for mod in (tconv, jconv):
        monkeypatch.setattr(mod, "separable_factors", lambda *a, **kw: None)
    pix = np.radians(1 / 3600.0)
    tb, tt = (TBeam(TQ(v, "arcsec"), TQ(v, "arcsec"), TQ(0, "deg"))
              for v in (2.0, 5.0))
    jb, jt = (JBeam(JQ(v, "arcsec"), JQ(v, "arcsec"), JQ(0, "deg"))
              for v in (2.0, 5.0))
    got, _ = tconv.convolve_cube_to_beam(td, tb, tt, pix)
    assert tconv.convolve_cube_to_beam.last["route"] == "fft"
    ref, _ = jconv.convolve_cube_to_beam(jnp.asarray(data), jb, jt, pix)
    kern = tt.deconvolve(tb).as_kernel(pix)
    assert_fft_close(got.numpy(), ref,
                     _den64(data, [kern], np.zeros(4, np.int32)),
                     float(np.nanmax(np.abs(np.where(np.isinf(data), 0,
                                                     data)))))


def _drift_beams(n, pa0, pa1, pkg):
    B, Q = (TBeam, TQ) if pkg == "t" else (JBeam, JQ)
    return [B(Q(a, "arcsec"), Q(b, "arcsec"), Q(c, "deg"))
            for a, b, c in zip(np.linspace(6.0, 6.6, n),
                               np.linspace(4.5, 4.95, n),
                               np.linspace(pa0, pa1, n))]


@pytest.mark.parametrize("target", ["common", "circular12"])
def test_fft_route_matches_jax_drifting_beams(target):
    """Per-channel elliptical beams at PA 30-34 deg drifting 6.0"->6.6" by
    4.5"->4.95" (the varying-resolution cell's beams): their deconvolution
    kernels have SVD rank 5, above the per-channel separable route's 4, so
    both packages take the FFT route, with one transfer per beam group."""
    n = 6
    data = _nan_data((n, 40, 44), 0)
    data[4, 30:, :] = np.nan          # a primary-beam-like border
    pix = np.radians(2 / 3600.0)
    tb, jb = _drift_beams(n, 30, 34, "t"), _drift_beams(n, 30, 34, "j")
    if target == "common":
        from spectral_cube_tpu_torch.beams import Beams as TBeams
        from spectral_cube_tpu.beams import Beams as JBeams
        tt, jt = TBeams(beams=tb).common_beam(), JBeams(beams=jb).common_beam()
        assert tt.major_rad == jt.major_rad
    else:
        tt = TBeam(TQ(12.0, "arcsec"), TQ(12.0, "arcsec"), TQ(0, "deg"))
        jt = JBeam(JQ(12.0, "arcsec"), JQ(12.0, "arcsec"), JQ(0, "deg"))
    got, tf = tconv.convolve_cube_to_beam(torch.as_tensor(data), tb, tt, pix)
    last = tconv.convolve_cube_to_beam.last
    assert last["route"] == "fft" and last["groups"] == n
    ref, jf = jconv.convolve_cube_to_beam(jnp.asarray(data), jb, jt, pix)
    np.testing.assert_array_equal(tf, jf)
    kernels = [None if tt.deconvolve(b).major_rad <= 0
               else tt.deconvolve(b).as_kernel(pix) for b in tb]
    scale = float(np.nanmax(np.abs(np.where(np.isinf(data), 0, data))))
    assert_fft_close(got.numpy(), ref, _den64(data, kernels, np.arange(n)),
                     scale)


@pytest.mark.parametrize("ndim", [2, 3])
def test_convolve2d_nan_fft_matches_jax(ndim):
    data = _nan_data((4, 24, 20), 5)
    k = _gauss2d(1.8, 1.1, theta=0.5, size=11) * 3.0   # not normalized
    x = data[1] if ndim == 2 else data
    got = tconv.convolve2d_nan_fft(torch.as_tensor(x), k).numpy()
    ref = np.asarray(jconv.convolve2d_nan_fft(jnp.asarray(x), k))
    assert got.shape == x.shape
    x3 = x[None] if ndim == 2 else x
    den = _den64(x3, [k / k.sum()], np.zeros(x3.shape[0], np.int64))
    assert_fft_close(got, ref, den.reshape(x.shape),
                     float(np.nanmax(np.abs(np.where(np.isinf(x), 0, x)))))


def test_fft_shape_and_transfers_match_jax():
    """fft_shape equals the JAX package's; the transfers built on the
    device equal the JAX package's host float64 rfft2 cast to complex64,
    for kernels of several sizes, odd and even, and the identity."""
    for n in (1, 7, 100, 772, 1000, 1537):
        assert tconv.fft_shape(n) == jconv.fft_shape(n)
    rng = np.random.RandomState(4)
    kernels = [rng.rand(5, 5), rng.rand(3, 7), None, rng.rand(4, 6)]
    fy, fx = 24, 30
    got = tconv._transfers(kernels, fy, fx, torch.device("cpu")).numpy()
    for g, k in enumerate(kernels):
        want = np.ones((fy, fx // 2 + 1)) if k is None \
            else jconv._kernel_transfer(k, fy, fx)
        np.testing.assert_allclose(got[g], want.astype(np.complex64),
                                   rtol=0, atol=1e-6)


def test_dropped_max_plane_gate_routes_agree():
    """The JAX package sends planes above 1024 pixels from the per-channel
    separable route to the FFT route (a TPU memory gate); the port keeps
    the separable route there.  Both routes agree on such a plane."""
    n, ny, nx = 4, 8, 1030
    data = _nan_data((n, ny, nx), 7)
    data[1, 2, 500] = np.nan
    pix = np.radians(1 / 3600.0)
    tb = [TBeam(TQ(v, "arcsec"), TQ(v * 0.8, "arcsec"), TQ(0, "deg"))
          for v in (2.0, 2.2, 2.4, 2.6)]
    jb = [JBeam(JQ(v, "arcsec"), JQ(v * 0.8, "arcsec"), JQ(0, "deg"))
          for v in (2.0, 2.2, 2.4, 2.6)]
    tt = TBeam(TQ(4.0, "arcsec"), TQ(4.0, "arcsec"), TQ(0, "deg"))
    jt = JBeam(JQ(4.0, "arcsec"), JQ(4.0, "arcsec"), JQ(0, "deg"))
    got, _ = tconv.convolve_cube_to_beam(torch.as_tensor(data), tb, tt, pix)
    assert tconv.convolve_cube_to_beam.last["route"] == \
        "per_channel_separable"
    ref, _ = jconv.convolve_cube_to_beam(jnp.asarray(data), jb, jt, pix)
    kernels = [tt.deconvolve(b).as_kernel(pix) for b in tb]
    scale = float(np.nanmax(np.abs(np.where(np.isinf(data), 0, data))))
    assert_fft_close(got.numpy(), ref, _den64(data, kernels, np.arange(n)),
                     scale)


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


def _pairwise_groups(beams):
    """The JAX package's grouping scan (ops/convolve.py:572-582)."""
    groups, idx = [], np.zeros(len(beams), np.int32)
    for i, b in enumerate(beams):
        for g, gb in enumerate(groups):
            if b == gb:
                idx[i] = g
                break
        else:
            groups.append(b)
            idx[i] = len(groups) - 1
    return groups, idx


@pytest.mark.parametrize("case", ["drift", "edge", "random"])
def test_beam_groups_equal_the_pairwise_scan(case):
    """beam_groups gives the scan's groups: equal beams within 1e-10
    relative, position angles equal modulo pi or ignored for circular
    beams, non-finite and zero-size beams one group, first match wins."""
    rad = np.radians(1 / 3600.0)
    if case == "drift":
        t = np.repeat(np.arange(40) / 39.0, 3)
        beams = [TBeam(6 * rad * (1 + 0.1 * x), 4.5 * rad * (1 + 0.1 * x),
                       np.radians(30 + 4 * x)) for x in t]
        beams[5] = TBeam(np.nan, np.nan, 0.0)
    elif case == "edge":
        b = 6 * rad
        beams = [TBeam(b, b, 0.1), TBeam(b, b, 1.3),            # circular
                 TBeam(b, 0.8 * b, 0.2), TBeam(b, 0.8 * b, 0.2 + np.pi),
                 TBeam(b, 0.8 * b, 0.2 - np.pi),
                 TBeam(b * (1 + 5e-11), 0.8 * b, 0.2),          # within
                 TBeam(b * (1 + 3e-10), 0.8 * b, 0.2),          # outside
                 TBeam(b, 0.8 * b, 0.2 + 5e-9),
                 TBeam(b, 0.8 * b, 0.2 + 5e-8),
                 TBeam(np.nan, b, 0.0), TBeam(0.0, 0.0, 0.0),
                 TBeam(b, b * (1 - 5e-13), 2.0),                # ~circular
                 TBeam(b, b * (1 + 6e-11), 0.7)]
    else:
        rng = np.random.RandomState(5)
        base = [TBeam(rng.uniform(4, 8) * rad, rng.uniform(2, 4) * rad,
                      rng.uniform(-3, 3)) for _ in range(12)]
        beams = [base[k] for k in rng.randint(0, 12, 200)]
        beams = [TBeam(b.major_rad * (1 + rng.choice([0, 1e-11, 1e-9])),
                       b.minor_rad, b.pa_rad) for b in beams]
    groups, idx = tconv.beam_groups(beams)
    want_groups, want_idx = _pairwise_groups(beams)
    np.testing.assert_array_equal(idx, want_idx)
    assert [id(g) for g in groups] == [id(g) for g in want_groups]


def _two_gauss(size, s1, s2):
    """A rank-2 kernel of ``size`` x ``size`` taps: two axis-aligned
    elliptical Gaussians, (sigma_y, sigma_x) ``s1`` and ``s2``, summed."""
    x = np.arange(size) - size // 2

    def g(s):
        return np.exp(-0.5 * (x / s) ** 2)
    k = np.outer(g(s1[0]), g(s1[1])) + 0.5 * np.outer(g(s2[0]), g(s2[1]))
    return k / k.sum()


#: (cube shape, kernel taps): 161 taps, past the 147 that one block's
#: shared memory held before the kernel streamed its taps, and 75 taps on
#: a 40 x 44 plane, longer than the plane but within the routes' 2 n
_LONG_TAPS = {"161_taps": ((3, 90, 96), 161),
              "longer_than_plane": ((3, 40, 44), 75)}


@pytest.mark.parametrize("case", list(_LONG_TAPS))
@pytest.mark.parametrize("route", ["separable", "per_channel_separable"])
def test_long_taps_match_jax(case, route):
    """Both separable routes with long rank-2 taps on positive data with a
    NaN border at the plane's edge (there den > 0: the zero fill outside
    the plane counts as valid), a NaN patch and an all-NaN channel,
    against the JAX functions; the tolerance of
    test_convolve2d_separable_matches_jax_and_scipy."""
    shape, size = _LONG_TAPS[case]
    rng = np.random.RandomState(size)
    data = (1.0 + rng.rand(*shape)).astype(np.float32)
    data[:, :3] = np.nan
    data[:, :, -2:] = np.nan
    data[1, 20:25, 30:33] = np.nan
    data[2] = np.nan
    k = _two_gauss(size, (size / 8.0, size / 12.0), (size / 14.0, size / 7.0))
    assert jconv.separable_factors(k)[0].shape[1] == 2
    td, jd = torch.as_tensor(data), jnp.asarray(data)
    if route == "separable":
        got = tconv.convolve2d_separable(td, k)
        ref = jconv.convolve2d_separable(jd, k)
    else:
        small = _gauss2d(2.0, 1.5, size=9)
        gi = np.array([0, 1, 0], np.int32)
        got = tconv.convolve_per_channel_separable(td, [k, small], gi)
        ref = jconv.convolve_per_channel_separable(jd, [k, small], gi)
    got, ref = got.numpy(), np.asarray(ref)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[2]).all() and np.isfinite(got[0]).all()
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-6, atol=1e-6)
