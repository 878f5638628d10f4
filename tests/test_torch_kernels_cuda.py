"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``: each skips, with its
reason, where ``torch.cuda.is_available()`` is false.  The file imports
neither JAX nor the JAX package, so it also runs on a machine without
them (the README names the command).  Tolerances: 1e-6 relative between
the kernel and its plain version of the same numerics (only the order of
float32 roundings differs), NaN patterns exact; the sigma clip exactly
(its kernel and plain version sum in one order); the fused smooth +
interpolation 3e-5 / 1e-5 (the JAX kernels' own tolerance); the filled
resample, the raw resample and the NaN chain of the fused convolve +
reproject bitwise (they round in the plain version's order), its
composed-operator branch 1e-5; the pipeline mode's planes bitwise equal
to the moments kernel's and its cube to the fused convolve + reproject's.
"""

import numpy as np
import pytest
import torch

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.io.fits_low import Header
from spectral_cube_tpu_torch.kernels import conv_reproject as kcr
from spectral_cube_tpu_torch.kernels import conv_sep as kconv
from spectral_cube_tpu_torch.kernels import moments as kmom
from spectral_cube_tpu_torch.kernels import pipeline_fused as kpf
from spectral_cube_tpu_torch.kernels import resample2 as kres
from spectral_cube_tpu_torch.kernels import sigma_clip as kclip
from spectral_cube_tpu_torch.kernels import smooth_interp as ksi
from spectral_cube_tpu_torch.ops import convolve as tconv
from spectral_cube_tpu_torch.ops import interpolate as tinterp
from spectral_cube_tpu_torch.ops import moments as tmom
from spectral_cube_tpu_torch.ops import pipeline_fused as tpf
from spectral_cube_tpu_torch.ops import regrid as tregrid
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


def _close_conv(got, want, x, ytaps, xtaps, hy, hx, gi, rtol=1e-5):
    """The normalized convolution's tolerance: den = 1 - K*~isfinite (the
    valid fraction of the footprint, float64 here) divides float32
    rounding, so NaN patterns must agree where den > 1e-5 and |got - want|
    * min(den, 1) stay within ``rtol`` of the largest |want|; where den >=
    0.1, rtol 1e-5 with atol 2e-6 of that scale."""
    from spectral_cube_tpu_torch.kernels.conv_sep import _apply
    got, want, x = got.cpu().double(), want.cpu().double(), x.cpu()
    yt, xt = torch.as_tensor(ytaps).double(), torch.as_tensor(xtaps).double()
    gi = torch.as_tensor(np.asarray(gi, np.int64))
    den = torch.ones_like(want)
    for g in range(yt.shape[0]):
        sel = torch.nonzero(gi == g).flatten()
        if sel.numel():
            den[sel] = 1.0 - _apply((~torch.isfinite(x[sel])).double(),
                                    yt[g], xt[g], hy, hx)
    flip = torch.isnan(got) != torch.isnan(want)
    assert not bool((flip & (den > 1e-5)).any())
    both = ~torch.isnan(got) & ~torch.isnan(want)
    scale = float(torch.where(both, want.abs(), 0.0).max())
    diff = torch.where(both, (got - want).abs(), 0.0)
    assert float((diff * den.clamp(max=1.0)).max()) <= rtol * scale
    strong = both & (den >= 0.1)
    np.testing.assert_allclose(got[strong].numpy(), want[strong].numpy(),
                               rtol=rtol, atol=2e-6 * scale)


def _conv_case(shape, ly, lx, rank, groups=1, seed=0):
    """Noise with an inf, a NaN patch, a NaN band at the plane's right edge
    (den > 0 there: the zero fill counts as valid) and an all-NaN
    channel; positive random taps (G, rank, L) whose 2-D kernels sum to
    1, centred as _tap_stack centres them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    x[0, 1, 1] = np.inf
    x[1, 2:5, 3:9] = np.nan
    x[:, :, -3:] = np.nan
    x[-1] = np.nan
    yt = (0.2 + rng.rand(groups, rank, ly)).astype(np.float64)
    xt = (0.2 + rng.rand(groups, rank, lx)).astype(np.float64)
    norm = np.einsum("gry,grx->g", yt, xt)
    yt /= norm[:, None, None]
    gi = np.arange(shape[0], dtype=np.int32) % groups
    return (torch.as_tensor(x), torch.as_tensor(yt.astype(np.float32)),
            torch.as_tensor(xt.astype(np.float32)), (ly - 1) // 2,
            (lx - 1) // 2, torch.as_tensor(gi))


@pytest.mark.parametrize("shape", [(3, 45, 77), (3, 70, 132)])
@pytest.mark.parametrize("rank", [1, 5, 8])
@pytest.mark.parametrize("taps", [1, 2, 8, 19, 41, 148, 161, 88])
def test_conv_kernel_every_tap_length(cuda, shape, rank, taps):
    """The streamed kernel at every tap length up to the routes' 2 n (88
    taps: longer than the 45-row plane), ranks 1, 5 and 8, on planes that
    are no multiple of the tile (one whose rows are no multiple of 4, so
    the halo is staged element by element), x taps one shorter than y."""
    x, yt, xt, hy, hx, gi = _conv_case(shape, taps, max(taps - 1, 1), rank,
                                       seed=taps)
    want = kconv.conv_sep_plain(x.to(cuda), yt, xt, hy, hx, gi)
    n0 = kconv.conv_sep.launches
    got = kconv.conv_sep(x.to(cuda), yt, xt, hy, hx, gi)
    torch.cuda.synchronize()
    assert kconv.conv_sep.launches == n0 + 1
    assert torch.isnan(got[-1]).all().item()
    _close_conv(got, want, x, yt, xt, hy, hx, gi)


def test_conv_kernel_groups_of_different_rank_and_length(cuda):
    """Interleaved groups of rank 2, 5 and 1 with 5, 161 and 1 taps: one
    (G, 5, 161) tap stack, zero-padded as _tap_stack pads it."""
    x = _noise_cube((6, 50, 96), 4)
    rng = np.random.RandomState(1)
    ytaps = [rng.rand(5, 2), 0.2 + rng.rand(161, 5), np.ones((1, 1))]
    xtaps = [rng.rand(7, 2), 0.2 + rng.rand(150, 5), np.ones((1, 1))]
    gi = np.array([1, 0, 2, 1, 0, 2], np.int32)
    ys, hy = tconv._tap_stack(ytaps)
    xs, hx = tconv._tap_stack(xtaps)
    want = tconv._convolve_groups(x, ytaps, xtaps, gi)
    got = tconv._convolve_groups(x.to(cuda), ytaps, xtaps, gi)
    _close_conv(got, want, x, ys, xs, hy, hx, gi)
    torch.testing.assert_close(got[2].cpu(), x[2], equal_nan=True)


def _cutoff_cube(nchan, ny, nx, seed):
    """Unit noise, NaN outside a circular primary-beam cutoff."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:ny, 0:nx]
    cut = ((yy - ny / 2) / (0.47 * ny)) ** 2 \
        + ((xx - nx / 2) / (0.47 * nx)) ** 2 > 1.0
    data = rng.randn(nchan, ny, nx).astype(np.float32)
    data[:, cut] = np.nan
    return data


def test_convolve_to_153_taps_on_cuda_matches_cpu(cuda):
    """convolve_to from the 6" x 4.5" beam to 90" at 2" pixels (153 taps,
    rank 3) on a 4 x 768 x 768 NaN-bordered cube: the separable route,
    one conv_sep launch on the card, against the same call on the CPU."""
    data = _cutoff_cube(4, 768, 768, 3)
    h = _header(4, 768, 768)
    beam = T.Beam(T.Quantity(90.0, "arcsec"), T.Quantity(90.0, "arcsec"),
                  T.Quantity(0.0, "deg"))
    out = {}
    for dev in ("cpu", cuda):
        cube = T.SpectralCube(data, WCS(header=h), header=h, device=dev)
        K.reset_launch_counts()
        out[str(dev)] = cube.convolve_to(beam)._data
        assert tconv.convolve_cube_to_beam.last["route"] == "separable"
        assert K.launch_counts()["conv_sep"] == (0 if dev == "cpu" else 1)
    kern = beam.deconvolve(T.Beam(T.Quantity(6.0, "arcsec"),
                                  T.Quantity(4.5, "arcsec"),
                                  T.Quantity(30.0, "deg"))).as_kernel(
        np.radians(2.0 / 3600.0))
    assert kern.shape == (153, 153)
    yt, xt = tconv.separable_factors(kern)
    ys, hy = tconv._tap_stack([yt])
    xs, hx = tconv._tap_stack([xt])
    _close_conv(out[str(cuda)], out["cpu"], torch.as_tensor(data), ys, xs,
                hy, hx, np.zeros(4, np.int32))


def test_fused_convolve_reproject_declines_on_cuda(cuda):
    """A 221-tap kernel: kernel 6's plan does not fit, so
    convolve_reproject_separable runs conv_sep then resample2 on the card
    (no conv_reproject launch) and agrees with the CPU chain, and
    moments_conv_reproject_fused returns None."""
    rng = np.random.RandomState(5)
    data = (1.0 + rng.rand(3, 30, 34)).astype(np.float32)
    data[1, 10:13, 4:9] = np.nan
    data[2, :, -2:] = np.nan
    ys, xs = _axis_maps(30, 34, 1.0, 0.37, 1.0, -0.61)
    g = np.exp(-0.5 * ((np.arange(221) - 110) / (221 / 8.0)) ** 2)
    kern = np.outer(g, g) / np.outer(g, g).sum()
    want = tregrid.convolve_reproject_separable(torch.as_tensor(data), kern,
                                                ys, xs)
    K.reset_launch_counts()
    got = tregrid.convolve_reproject_separable(torch.as_tensor(data,
                                                               device=cuda),
                                               kern, ys, xs)
    counts = K.launch_counts()
    assert tregrid.convolve_reproject_separable.last == {"route": "chain"}
    assert counts["conv_sep"] == 1 and counts["resample2"] == 1, counts
    assert counts["conv_reproject"] == 0, counts
    _close(got, want, rtol=1e-5, atol=1e-6)
    assert tpf.moments_conv_reproject_fused(
        torch.as_tensor(data, device=cuda), kern, ys, xs,
        np.arange(3, dtype=np.float64), 1.0) is None


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
    _equal(got, want)


def _axis_taps(n_out, n_in, a, b):
    s = np.clip(np.arange(n_out) * a + b, 0, n_in - 1)
    i0 = np.clip(np.floor(s).astype(np.int64), 0, n_in - 2)
    return i0, (s - i0).astype(np.float32)


# (input shape, output shape, y map, x map): maps a * i + b; "perm" draws
# far-apart columns in random order
_RAW_LAYOUTS = {
    "nx_out_129_pitch_131": ((3, 37, 131), (41, 129), (0.93, 3.2),
                             (1.07, -2.6)),
    "flipped_y": ((3, 70, 132), (70, 132), (-1.0, 69.3), (1.0, -1.6)),
    "repeated_y": ((3, 40, 67), (50, 70), (0.5, -4.0), (1.0, 2.0)),
    "narrowed": ((2, 195, 400), (64, 130), (3.0, 0.5), (3.0, 0.5)),
    "listed_columns": ((2, 33, 3000), (20, 150), (1.6, 0.2), "perm"),
    "many_strips": ((4, 300, 700), (300, 700), (1.0, 0.25), (1.0, -0.5)),
    "no_valid_channel": ((3, 20, 40), (20, 40), (1.0, 0.5), (1.0, 0.5)),
}


@pytest.mark.parametrize("layout", list(_RAW_LAYOUTS))
def test_resample_kernel_layouts_bitwise(cuda, layout):
    """The raw resample bit for bit against its plain version on the
    layouts its plan treats apart: a row of outputs that is no multiple
    of 4 on input rows that are not 16-byte aligned, a flipped and a
    repeating y0, a downsampling that narrows the strip, columns only a
    list stages, a plane of many strips, every channel invalid; and on a
    base that is not 16-byte aligned (4-byte copies)."""
    shape, (ny, nx), (ay, by), xmap = _RAW_LAYOUTS[layout]
    rng = np.random.RandomState(21)
    x = _noise_cube(shape, 8)
    x[0, :, 5] = np.nan
    y0, wy = _axis_taps(ny, shape[1], ay, by)
    if xmap == "perm":
        x0 = rng.permutation(shape[2] - 1)[:nx]
        wx = rng.rand(nx).astype(np.float32)
    else:
        x0, wx = _axis_taps(nx, shape[2], *xmap)
    wy[::7] = 0.0
    valid = rng.rand(ny, nx) > 0.1
    zvalid = np.ones(shape[0], bool)
    zvalid[1] = False
    if layout == "no_valid_channel":
        zvalid[:] = False
    want = kres.resample2_plain(x, y0, wy, x0, wx, valid, zvalid)
    p = kres.plan(y0, x0, shape[1], shape[2], shape[0])
    if layout == "narrowed":
        assert p.width < 128 and p.form == "span16"
    if layout == "listed_columns":
        assert p.form == "list"
    n0 = kres.resample2.launches
    got = kres.resample2(x.to(cuda), y0, wy, x0, wx, valid, zvalid)
    torch.cuda.synchronize()
    assert kres.resample2.launches == n0 + 1
    _equal(got, want)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x.to(cuda))
    _equal(kres.resample2(xs, y0, wy, x0, wx, valid, zvalid), want)


def test_resample_launch_alone_equals_the_wrapper(cuda):
    """prepare + launch (the taps already on the card) is the wrapper's
    own launch, and a second prepare of the same taps reuses the upload."""
    x = _noise_cube((3, 64, 96), 2).to(cuda)
    y0, wy = _axis_taps(64, 64, 1.0, 0.37)
    x0, wx = _axis_taps(96, 96, 1.0, -0.61)
    valid = np.ones((64, 96), bool)
    prep = kres.prepare(x, y0, wy, x0, wx, valid)
    assert kres.prepare(x, y0, wy, x0, wx, valid) is prep
    _equal(kres.launch(x, prep), kres.resample2(x, y0, wy, x0, wx, valid))


@pytest.mark.parametrize("npix", [(16, 41), (4, 35), (13, 45)])
@pytest.mark.parametrize("nchan", [1, 31, 32, 33, 1100])
def test_moments_kernel_ring_layouts(cuda, nchan, npix):
    """The moments ring on planes whose spaxels take 16-byte copies and a
    tail block (16 x 41), 16-byte data but 4-byte mask copies (4 x 35)
    and 4-byte data with a mask read directly (13 x 45), at 1 to 1100
    channels (partial, whole and many chunks): exact counts, finalized
    moments within 2e-6 of the plain version, and a bool include mask
    (passed as its own bytes) giving the same planes as a uint8 one."""
    rng = np.random.RandomState(nchan + 3)
    data = rng.randn(nchan, *npix).astype(np.float32) + 2.0
    data[nchan // 2, 0, :3] = np.nan
    data[:, 1, 2] = np.nan
    data[0, 2, 1] = np.inf
    x = torch.as_tensor(data)
    coords = np.linspace(-3.0, 7.0, nchan)
    inc = x > 1.5
    for with_stats in (False, True):
        want = kmom.moments_planes_plain(x, coords, 1, 1.7, inc, with_stats)
        got = kmom.moments_planes(x.to(cuda), coords, 1, 1.7, inc.to(cuda),
                                  with_stats)
        same = kmom.moments_planes(x.to(cuda), coords, 1, 1.7,
                                   inc.to(cuda).to(torch.uint8), with_stats)
        assert torch.equal(got[0], same[0]) and torch.equal(got[1], same[1])
        assert torch.equal(got[1].cpu(), want[1])
        fin_w = tmom.finalize_planes(*want, 0.0, 1.0, with_stats)
        fin_g = tmom.finalize_planes(got[0].cpu(), got[1].cpu(), 0.0, 1.0,
                                     with_stats)
        for a, b in zip(fin_g[:3], fin_w[:3]):
            _close(a, b, rtol=2e-6, atol=1e-6)


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


def _clip_edges(nchan, seed):
    """(nchan, 5, 67) spectra for the register classes' edges: noise,
    every second row quantized to a few levels (heavy ties), +-inf, an
    all-NaN spaxel and a spaxel with one finite sample."""
    rng = np.random.RandomState(seed)
    data = (2.0 * rng.randn(nchan, 5, 67)).astype(np.float32)
    data[:, 1::2] = np.round(data[:, 1::2] / 2.0)
    data[nchan // 2, 0, 0] = np.inf
    data[(nchan - 1) // 3, 0, 1] = -np.inf
    data[:, 2, 7] = np.nan
    data[:, 3, 8] = np.nan
    data[nchan - 1, 3, 8] = 1.5
    return torch.as_tensor(data)


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("nchan", [1, 2, 31, 32, 33, 63, 64, 65, 312, 512,
                                   513, 623, 1024, 1025])
def test_sigma_clip_kernel_register_class_edges(cuda, nchan, use_mean):
    """Bitwise against the plain version on both sides of every register
    class (R = 1 .. 32 values a lane) and of the shared-memory network.
    The plain version runs on the card too: its float32 sqrt there is
    correctly rounded, as the kernel's is, while the CPU's can differ by
    an ulp (sqrt(3.2218385) in the 2-channel case), which moves a clip
    threshold."""
    x = _clip_edges(nchan, nchan + 7).to(cuda)
    for sigma, maxiters in ((1.0, 5), (2.0, 3)):
        want = kclip.sigma_clip_plain(x, sigma, maxiters, use_mean).cpu()
        n0 = kclip.sigma_clip.launches
        got = kclip.sigma_clip(x, sigma, maxiters, use_mean).cpu()
        assert kclip.sigma_clip.launches == n0 + 1
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.isnan(got[:, 2, 7]).all()


@pytest.mark.parametrize("ncol", [41, 300, "offset"])
@pytest.mark.parametrize("nin", [40, 623, 2000])
def test_smooth_interp_kernel_both_stagings(cuda, nin, ncol):
    """16-byte copies (ncol 300) and 4-byte ones (ncol 41, or a base off
    16 bytes), NaN at the first and last channel, a hole, an all-NaN
    spectrum."""
    n = 300 if ncol == "offset" else ncol
    rng = np.random.RandomState(nin + n)
    data = rng.randn(nin, n).astype(np.float32)
    data[0, 3] = data[-1, 5] = np.nan
    data[nin // 2:nin // 2 + 3, 9] = np.nan
    data[:, 11] = np.nan
    x = torch.as_tensor(data)
    inaxis = np.arange(nin, dtype=np.float64)
    kern = tsmooth.gaussian_kernel1d(2.0)
    idx, frac = tinterp.interp_weights(inaxis, inaxis[::2] + 0.25)
    S, I, M, bands = tinterp._si_operators(kern / kern.sum(), idx, frac,
                                           nin)
    want = ksi.smooth_interp_plain(x, M, S, I)
    xd = x.to(cuda)
    if ncol == "offset":
        buf = torch.empty(x.numel() + 1, device=cuda)
        xd = buf[1:].view(nin, n)
        xd.copy_(x)
    expect = ksi.plan(nin, n, xd.data_ptr() % 16 == 0).staging
    assert expect == ("cp.async16" if ncol == 300 else "cp.async4")
    n0 = ksi.smooth_interp.launches
    got = ksi.smooth_interp(xd, M, S, I, bands)
    assert ksi.smooth_interp.launches == n0 + 1
    _close(got, want, rtol=3e-5, atol=1e-5)
    assert torch.isnan(got[:, 11]).all().item()


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


def _equal(got, want):
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("ay,by,ax,bx", [(1.0, 0.37, 1.0, -1.61),
                                         (0.93, 3.2, 1.07, -2.6)])
@pytest.mark.parametrize("flags", ["exact", "all", "none"])
def test_filled_resample_kernel_matches_plain(cuda, ay, by, ax, bx, flags):
    """Bitwise, with fractional NaN weights, channels whose weights are all
    zero (flagged as such, flagged like the others, or every channel
    unflagged, which skips the poison test in both), the validity plane
    and zvalid."""
    rng = np.random.RandomState(4)
    fz = torch.as_tensor(rng.randn(5, 40, 67).astype(np.float32))
    wz = torch.zeros_like(fz)
    wz[1, 10, 20] = 0.25
    wz[2, 3:9, 30:40] = 1.0
    wz[4, 39, 66] = 0.75
    ny, nx = 36, 70
    ys = np.clip(np.arange(ny) * ay + by, 0, 39)
    xs = np.clip(np.arange(nx) * ax + bx, 0, 66)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, 38)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, 65)
    wy, wx = (ys - y0).astype(np.float32), (xs - x0).astype(np.float32)
    valid = np.ones((ny, nx), bool)
    valid[:2] = False
    zvalid = np.array([1, 1, 1, 0, 1], bool)
    wz_any = (wz != 0).flatten(1).any(1)
    if flags != "exact":
        wz_any[:] = flags == "all"
    want = kres.resample2_filled_plain(fz, wz, wz_any, y0, wy, x0, wx, valid,
                                       zvalid)
    n0 = kres.resample2_filled.launches
    got = kres.resample2_filled(fz.to(cuda), wz.to(cuda), wz_any, y0, wy,
                                x0, wx, valid, zvalid)
    assert kres.resample2_filled.launches == n0 + 1
    _equal(got, want)
    assert (torch.isnan(want[2]).sum() > torch.isnan(want[0]).sum()) \
        == (flags != "none")


# (input shape, output shape, y map, x map, the filled plan's width and
# form with a second plane of slots); maps as _RAW_LAYOUTS
_FILLED_LAYOUTS = {
    "width128": _RAW_LAYOUTS["many_strips"] + (128, "span16"),
    "width64": ((2, 99, 264), (64, 130), (1.5, 0.5), (2.0, 0.5), 64,
                "span16"),
    "width32": _RAW_LAYOUTS["narrowed"] + (32, "span16"),
    "listed": _RAW_LAYOUTS["listed_columns"] + (128, "list"),
    "pitch_131": _RAW_LAYOUTS["nx_out_129_pitch_131"] + (128, "span4"),
    "flipped": _RAW_LAYOUTS["flipped_y"] + (128, "span16"),
}


@pytest.mark.parametrize("flags", ["mixed", "none"])
@pytest.mark.parametrize("layout", list(_FILLED_LAYOUTS))
def test_filled_resample_kernel_layouts_bitwise(cuda, layout, flags):
    """The filled resample bit for bit against its plain version at each
    width and staging form its plan takes with two planes of slots (128,
    64, 32 columns, listed columns, 4-byte copies on rows that are not
    16-byte aligned, a flip), with fractional NaN weights, a zvalid-0
    channel and an unflagged channel, or every channel unflagged (one
    plane); and on fz and wz whose base is 4-byte but not 16-byte aligned
    (4-byte copies)."""
    shape, (ny, nx), (ay, by), xmap, width, form = _FILLED_LAYOUTS[layout]
    rng = np.random.RandomState(31)
    fz = torch.as_tensor(rng.randn(*shape).astype(np.float32))
    wz = torch.zeros_like(fz)
    hit = torch.as_tensor(rng.rand(*shape[1:]) < 0.02)
    wz[0][hit] = torch.as_tensor(
        rng.choice([0.25, 1.0, 1e-7], int(hit.sum())).astype(np.float32))
    wz[-1] = 1.0               # unflagged: its weights are never read
    y0, wy = _axis_taps(ny, shape[1], ay, by)
    if xmap == "perm":
        x0 = rng.permutation(shape[2] - 1)[:nx]
        wx = rng.rand(nx).astype(np.float32)
    else:
        x0, wx = _axis_taps(nx, shape[2], *xmap)
    valid = rng.rand(ny, nx) > 0.1
    zvalid = np.ones(shape[0], bool)
    if shape[0] > 2:
        zvalid[1] = False
    wz_any = torch.zeros(shape[0], dtype=torch.bool)
    if flags == "mixed":
        wz_any[:-1] = True
    planes = 2 if flags == "mixed" else 1
    p = kres.plan(y0, x0, shape[1], shape[2], shape[0], True, planes)
    if planes == 2:
        assert (p.width, p.form) == (width, form)
    want = kres.resample2_filled_plain(fz, wz, wz_any, y0, wy, x0, wx, valid,
                                       zvalid)
    assert bool(torch.isnan(want[0][torch.as_tensor(valid)]).any()) \
        == (flags == "mixed")
    n0 = kres.resample2_filled.launches
    got = kres.resample2_filled(fz.to(cuda), wz.to(cuda), wz_any.to(cuda),
                                y0, wy, x0, wx, valid, zvalid)
    torch.cuda.synchronize()
    assert kres.resample2_filled.launches == n0 + 1
    _equal(got, want)
    bufs = [torch.empty(fz.numel() + 1, device=cuda) for _ in range(2)]
    fzs, wzs = (b[1:].view(fz.shape) for b in bufs)
    fzs.copy_(fz.to(cuda))
    wzs.copy_(wz.to(cuda))
    _equal(kres.resample2_filled(fzs, wzs, wz_any, y0, wy, x0, wx, valid,
                                 zvalid), want)


def _gauss2d(sy, sx, theta, size):
    x = np.arange(size) - size // 2
    yy, xx = np.meshgrid(x, x, indexing="ij")
    yr = yy * np.cos(theta) + xx * np.sin(theta)
    xr = -yy * np.sin(theta) + xx * np.cos(theta)
    k = np.exp(-0.5 * ((yr / sy) ** 2 + (xr / sx) ** 2))
    return k / k.sum()


def _axis_maps(n_out_y, n_out_x, ay, by, ax, bx):
    ys = np.broadcast_to((np.arange(n_out_y) * ay + by)[:, None],
                         (n_out_y, n_out_x)).astype(np.float64)
    xs = np.broadcast_to((np.arange(n_out_x) * ax + bx)[None, :],
                         (n_out_y, n_out_x)).astype(np.float64)
    return ys.copy(), xs.copy()


#: (ny_out, nx_out, ay, by, ax, bx) on a 45 x 70 input: a translation, a
#: target with 1.5x larger pixels, one with 2x smaller pixels, a flipped y
_MAPPINGS = {"shift": (45, 70, 1.0, 0.37, 1.0, -0.61),
             "coarser": (31, 47, 1.5, 0.2, 1.5, -0.3),
             "finer": (90, 140, 0.5, 0.1, 0.5, 0.3),
             "flipped": (45, 70, -1.0, 43.7, 1.0, 0.4)}


def _fused_case(mapping, nchan=6, theta=0.3, size=11):
    rng = np.random.RandomState(7)
    data = rng.randn(nchan, 45, 70).astype(np.float32) + 0.5
    data[1, 3:7, 10:30] = np.nan          # a NaN channel
    data[1, 0, 0] = np.nan
    data[3] = np.nan                      # an all-NaN channel
    data[4, 44, 69] = np.nan              # a NaN in a corner
    ys, xs = _axis_maps(*_MAPPINGS[mapping])
    k = _gauss2d(2.0, 1.2, theta, size)
    return torch.as_tensor(data), k, ys, xs


@pytest.mark.parametrize("mapping", list(_MAPPINGS))
def test_conv_reproject_kernel_matches_plain(cuda, mapping):
    """Clean channels within 1e-5 of the dense composed products, NaN
    channels bitwise equal to the plain chain, an all-NaN channel NaN."""
    x, k, ys, xs = _fused_case(mapping)
    ops = tregrid._conv_reproject_operators(x.shape, k, ys, xs)
    assert ops is not None
    args = (ops.gy, ops.gx, ops.my, ops.mx, ops.ry, ops.rx, ops.valid)
    want = kcr.conv_reproject_plain(x, *args)
    n0 = kcr.conv_reproject.launches
    got = kcr.conv_reproject(x.to(cuda), *args)
    assert kcr.conv_reproject.launches == n0 + 1
    _close(got, want, rtol=1e-5, atol=1e-5)
    _equal(got[[1, 3, 4]], want[[1, 3, 4]])
    assert torch.isnan(got[3]).all().item()
    # the op on the card: the same kernel through convolve_reproject
    op = tregrid.convolve_reproject_separable(x.to(cuda), k, ys, xs)
    _equal(op, got)


#: (ny_out, nx_out, ay, by, ax, bx) on a 100 x 260 input: more than one
#: tile of every mode along both axes, with partial tiles at the edges
_WIDE = {"shift": (100, 260, 1.0, 0.37, 1.0, -0.61),
         "coarser": (66, 173, 1.5, 0.2, 1.5, -0.3),
         "finer": (198, 518, 0.5, 0.1, 0.5, 0.3),
         "flipped": (100, 260, -1.0, 98.7, 1.0, 0.4)}


def _wide_case(mapping, nchan=40):
    rng = np.random.RandomState(11)
    data = rng.randn(nchan, 100, 260).astype(np.float32) + 0.5
    data[1, 30:36, 100:140] = np.nan      # a NaN channel
    data[1, 0, 0] = np.nan
    data[3] = np.nan                      # an all-NaN channel
    data[4, 99, 259] = np.nan             # a NaN in a corner
    ys, xs = _axis_maps(*_WIDE[mapping])
    return torch.as_tensor(data), _gauss2d(2.0, 1.2, 0.3, 11), ys, xs


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("mapping", list(_WIDE))
def test_fused_kernel_on_a_plane_of_many_tiles(cuda, mapping, mode):
    """Every mode on a 100 x 260 plane, 40 channels (two moment chunks):
    mode 0 within 1e-5 of the plain version, NaN channels bitwise; mode 1
    (finite data) within 1e-5 and bitwise equal to mode 0's clean branch
    where valid; mode 2's planes bitwise equal to the moments kernel's and
    its cube to mode 0's."""
    x, k, ys, xs = _wide_case(mapping)
    ops = tregrid._conv_reproject_operators(x.shape, k, ys, xs)
    assert ops is not None
    args = (ops.gy, ops.gx, ops.my, ops.mx, ops.ry, ops.rx, ops.valid)
    xg = x.to(cuda)
    if mode == 0:
        want = kcr.conv_reproject_plain(x, *args)
        got = kcr.conv_reproject(xg, *args)
        _close(got, want, rtol=1e-5, atol=1e-5)
        _equal(got[[1, 3, 4]], want[[1, 3, 4]])
    elif mode == 1:
        xf = torch.nan_to_num(x)
        gi = np.zeros(x.shape[0], np.int32)
        got = kcr.plain_strips(xf.to(cuda), ops.gy, ops.gx, gi)
        _close(got, kcr.plain_strips_plain(xf, ops.gy, ops.gx, gi),
                 rtol=1e-5, atol=1e-5)
        rep = kcr.conv_reproject(xf.to(cuda), *args)
        ok = torch.as_tensor(ops.valid, device=cuda)
        assert torch.equal(got[:, ok], rep[:, ok])
    else:
        xc = np.linspace(-3.0, 5.0, x.shape[0])
        out, planes, cnt = kpf.pipeline_fused(xg, *args, xc, 1, 0.25)
        kplanes, kcnt = kmom.moments_planes(xg, xc, 1, 0.25, None, True)
        assert torch.equal(cnt, kcnt) and torch.equal(planes, kplanes)
        _equal(out, kcr.conv_reproject(xg, *args))
        _close(out, kcr.conv_reproject_plain(x, *args), rtol=1e-5,
               atol=1e-5)


def test_plain_strips_kernel_two_groups(cuda):
    rng = np.random.RandomState(3)
    nchan, ny, nx, ny_out, nx_out = 7, 40, 70, 30, 50
    x = torch.as_tensor(rng.randn(nchan, ny, nx).astype(np.float32))
    band_y = np.abs(np.arange(ny_out)[:, None] * 1.2
                    - np.arange(ny)[None]) < 3
    band_x = np.abs(np.arange(nx_out)[:, None] * 1.3
                    - np.arange(nx)[None]) < 4
    My = (rng.rand(2, 3, ny_out, ny) * band_y).astype(np.float32)
    Mx = (rng.rand(2, 3, nx_out, nx) * band_x).astype(np.float32)
    My[1, :, 5] = 0.0
    gi = np.array([1, 0, 1, 1, 0, 0, 1], np.int32)
    yb, xb = kcr.bands_of(My), kcr.bands_of(Mx)
    want = kcr.plain_strips_plain(x, yb, xb, gi)
    n0 = kcr.plain_strips.launches
    got = kcr.plain_strips(x.to(cuda), yb, xb, gi)
    assert kcr.plain_strips.launches == n0 + 1
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mapping", ["shift", "coarser", "finer"])
@pytest.mark.parametrize("mask", ["fused", "include"])
def test_pipeline_fused_kernel_equals_the_chain_kernels(cuda, mapping, mask):
    """Planes bitwise equal to the moments kernel's, the cube bitwise equal
    to the fused convolve + reproject kernel's, both on the card, with the
    mask fused (> 0.25) or as an include array (a data-local mask the
    kernel does not fuse); and within tolerance of the plain versions."""
    x, k, ys, xs = _fused_case(mapping, nchan=70)
    xc = np.linspace(-3.0, 5.0, x.shape[0])
    ops = tregrid._conv_reproject_operators(x.shape, k, ys, xs)
    args = (ops.gy, ops.gx, ops.my, ops.mx, ops.ry, ops.rx, ops.valid)
    op, thr, inc = (1, 0.25, None) if mask == "fused" else (
        0, 0.0, (x > 0.25) & (x < 1.5))
    xg = x.to(cuda)
    incg = None if inc is None else inc.to(cuda)
    n0 = kpf.pipeline_fused.launches
    out, planes, cnt = kpf.pipeline_fused(xg, *args, xc, op, thr, incg)
    assert kpf.pipeline_fused.launches == n0 + 1
    kplanes, kcnt = kmom.moments_planes(xg, xc, op, thr, incg, True)
    assert torch.equal(cnt, kcnt)
    assert torch.equal(planes, kplanes)
    _equal(out, kcr.conv_reproject(xg, *args))
    wout, wplanes, wcnt = kpf.pipeline_fused_plain(x, *args, xc, op, thr,
                                                   inc)
    _close(out, wout, rtol=1e-5, atol=1e-5)
    assert torch.equal(cnt.cpu(), wcnt)
    fin_g = tmom.finalize_planes(planes.cpu(), cnt.cpu(), 0.0, 1.0, True)
    fin_w = tmom.finalize_planes(wplanes, wcnt, 0.0, 1.0, True)
    for a, b in zip(fin_g[:3], fin_w[:3]):
        _close(a, b, rtol=3e-6, atol=1e-6)


def test_fused_pipeline_op_on_cuda_matches_cpu(cuda):
    """moments_conv_reproject_fused on a CUDA cube launches the pipeline
    kernel only and agrees with the CPU run (plain versions)."""
    x, k, ys, xs = _fused_case("shift", nchan=40)
    coords = np.arange(40) * 0.5
    mask = T.LazyComparisonMask(torch.gt, 0.25, shape=tuple(x.shape))
    want = tpf.moments_conv_reproject_fused(x, k, ys, xs, coords, 0.5,
                                            mask_expr=mask)
    K.reset_launch_counts()
    got = tpf.moments_conv_reproject_fused(x.to(cuda), k, ys, xs, coords,
                                           0.5, mask_expr=mask)
    counts = K.launch_counts()
    assert counts["pipeline_fused"] == 1 and counts["moments"] == 0, counts
    _close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(got[1:4], want[1:4]):
        _close(a, b, rtol=3e-6, atol=1e-6)
    for key in ("npts", "mean", "sigma", "min", "max"):
        np.testing.assert_allclose(float(got[4][key]), float(want[4][key]),
                                   rtol=3e-6)


def test_reproject_new_spectral_axis_on_cuda_matches_cpu(cuda):
    """cube.reproject onto a coarser, offset spectral axis and a shifted
    grid launches the filled resample once and agrees bitwise with the
    CPU run."""
    nchan, ny, nx = 40, 30, 36
    rng = np.random.RandomState(2)
    data = rng.randn(nchan, ny, nx).astype(np.float32)
    data[7, 4:9, 5] = np.nan
    data[:, 0, :3] = np.nan
    h = _header(nchan, ny, nx)
    t = Header(h)
    t["NAXIS3"] = 19
    t["CDELT3"] = 2 * h["CDELT3"]
    t["CRVAL3"] = h["CRVAL3"] + 0.25 * h["CDELT3"]
    t["CRPIX1"] = h["CRPIX1"] + 0.37
    t["CRPIX2"] = h["CRPIX2"] - 0.61
    out = {}
    for dev in ("cpu", cuda):
        cube = T.SpectralCube(data, WCS(header=h), header=h, device=dev)
        K.reset_launch_counts()
        out[str(dev)] = cube.reproject(t)._data
        counts = K.launch_counts()
        if str(dev) != "cpu":
            assert counts["resample2_filled"] == 1, counts
    _equal(out[str(cuda)], out["cpu"])


def _config2_operator(nchan=512):
    """Bench config 2's composed operator (bench.py:205-211): a 17-tap
    Gaussian smooth (sigma = 2 channels) then interpolation onto every
    second channel, composed in float64, cast to float32."""
    from spectral_cube_tpu_torch.kernels.banded_matmul import row_bands
    coords = np.arange(nchan, dtype=np.float64)
    k = tsmooth.gaussian_kernel1d(2.0)
    M = (tinterp._interp_matrix(*tinterp.interp_weights(coords, coords[::2]),
                                nchan).astype(np.float64)
         @ tsmooth._banded_conv_matrix(nchan, k / k.sum()).astype(
             np.float64)).astype(np.float32)
    return M, row_bands(M)


@pytest.mark.parametrize("S", [1000, 4096])
@pytest.mark.parametrize("nonfinite", [False, True])
def test_banded_matmul_kernel_matches_plain(cuda, S, nonfinite):
    """Kernel 7 against its plain version on bench config 2's operator
    (512 -> 256 channels), a ragged column tile included; with NaN and inf
    the NaN patterns agree (a non-finite value reaches the rows whose span
    covers it).  Finite results also agree with the dense float64
    product."""
    from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
    M, bands = _config2_operator()
    rng = np.random.RandomState(9)
    x = rng.randn(512, S).astype(np.float32)
    if nonfinite:
        x[100, 45] = np.nan
        x[0, 7] = np.inf
        x[511, :40] = np.nan
    xt = torch.as_tensor(x, device=cuda)
    kbm.banded_matmul.launches = 0
    got = kbm.banded_matmul(xt, bands)
    torch.cuda.synchronize()
    assert kbm.banded_matmul.launches == 1
    want = kbm.banded_matmul_plain(xt, bands)
    assert kbm.banded_matmul.launches == 1
    _close(got, want, rtol=2e-6, atol=1e-6)
    if not nonfinite:
        _close(got, torch.as_tensor(M.astype(np.float64) @ x), rtol=2e-6,
               atol=1e-6)
    else:
        g = got.cpu().numpy()
        rows = np.nonzero(M[:, 100])[0]
        assert np.isnan(g[rows, 45]).all()
        assert np.isfinite(np.delete(g[:, 45], rows)).all()


def _irregular_operator():
    """A banded (45, 70) operator of uneven rows (as
    tests/test_torch_banded_matmul.py's): spans of 1 to 12 columns whose
    starts are not monotone, all-zero row 7, one-column rows 3 and 20, a
    zero tap inside row 9's span."""
    rng = np.random.RandomState(11)
    M = np.zeros((45, 70), np.float32)
    for i in range(45):
        n = int(rng.randint(1, 13))
        s = int(rng.randint(0, 70 - n + 1))
        M[i, s:s + n] = rng.randn(n).astype(np.float32) + 2.0
    M[7] = 0.0
    M[3] = 0.0
    M[3, 60] = 1.5
    M[20] = 0.0
    M[20, 0] = -0.75
    M[9] = 0.0
    M[9, 30:36] = 1.0
    M[9, 31] = 0.0
    return M


@pytest.mark.parametrize("S", [1000, 4096, "offset"])
@pytest.mark.parametrize("shape", [(8, 4), (1, 4), (1, 1)])
@pytest.mark.parametrize("which", ["config2", "irregular"])
def test_banded_matmul_kernel_plans_and_edges(cuda, monkeypatch, which,
                                              shape, S):
    """Kernel 7 in each shape of its plan (8 rows a warp on 128-column
    strips, one row a warp, 32-column strips) on bench config 2's operator
    and an irregular one (uneven, non-monotone spans, an empty row, rows
    of one column), S of 1000 (4-byte copies, scalar stores) and 4096
    (16-byte), and 4096 columns on a base one float off (4-byte copies):
    within 2e-6 of its plain version, the same NaN and inf patterns with
    NaN and inf on the edges of row 9's span and just outside it, the
    empty row 0."""
    from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
    monkeypatch.setattr(kbm, "SHAPES", (shape,))
    monkeypatch.setattr(kbm, "_PREPARED", type(kbm._PREPARED)())
    M = _config2_operator()[0] if which == "config2" \
        else _irregular_operator()
    bands = kbm.row_bands(M)
    ncol = 4096 if S == "offset" else S
    x = np.random.RandomState(13).randn(M.shape[1], ncol).astype(np.float32)
    lo, hi = int(bands.start[9]), int(bands.start[9] + bands.length[9])
    x[lo, 3] = np.nan
    x[hi - 1, 4] = np.inf
    x[hi, 5] = np.nan
    x[lo, ncol - 1] = np.inf
    if S == "offset":
        buf = torch.empty(x.size + 1, device=cuda)
        xt = buf[1:].view(x.shape)
        xt.copy_(torch.as_tensor(x))
    else:
        xt = torch.as_tensor(x, device=cuda)
    kbm.banded_matmul.launches = 0
    got = kbm.banded_matmul(xt, bands)
    torch.cuda.synchronize()
    assert kbm.banded_matmul.launches == 1
    assert kbm.prepare(xt, bands).packed.plan[:2] == shape
    want = kbm.banded_matmul_plain(xt, bands)
    _close(got, want, rtol=2e-6, atol=1e-6)
    g = got.cpu().numpy()
    assert np.array_equal(np.isinf(g), np.isinf(want.cpu().numpy()))
    span = (bands.start[:, None] <= np.arange(M.shape[1])) \
        & (np.arange(M.shape[1]) < (bands.start + bands.length)[:, None])
    assert np.array_equal(~np.isfinite(g[:, 3]), span[:, lo])
    assert np.array_equal(~np.isfinite(g[:, 5]), span[:, hi])
    assert not np.isfinite(g[9, [3, 4, ncol - 1]]).any()
    if which == "irregular":
        assert not g[7].any()


def test_banded_matmul_strips_on_cuda(cuda):
    """banded_matmul_strips launches the kernel where the JAX function
    runs, and returns None where it declines (nin < 128)."""
    from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
    M, _ = _config2_operator(256)
    x = torch.randn(256, 640, device=cuda)
    kbm.banded_matmul.launches = 0
    out = kbm.banded_matmul_strips(M, x)
    assert out.device.type == "cuda" and kbm.banded_matmul.launches == 1
    _close(out, torch.as_tensor(M.astype(np.float64)
                                @ x.cpu().numpy().astype(np.float64)),
           rtol=2e-6, atol=1e-6)
    small = tsmooth._banded_conv_matrix(64, np.ones(5) / 5.0)
    assert kbm.banded_matmul_strips(small, torch.zeros(64, 256,
                                                       device=cuda)) is None


def _vr_cube(dev, pa, groups, border, nchan=12, ny=40, nx=44):
    """Beams drifting 6.0"->6.6" by 4.5"->4.95" in runs of ``groups``
    channels, at PA 0 or, from ``pa`` != 0, turning by 4 deg; a NaN pixel
    and (``border``) three NaN rows."""
    rng = np.random.RandomState(4)
    v = np.arange(nchan)
    data = (2.0 * np.exp(-0.5 * ((v - nchan / 2) / 2.0) ** 2)[:, None, None]
            + 0.3 * rng.randn(nchan, ny, nx)).astype(np.float32)
    if border:
        data[:, :3] = np.nan
    data[3, 20, 20] = np.nan
    h = _header(nchan, ny, nx)
    t = (np.arange(nchan) // groups) * groups / (nchan - 1)
    beams = T.Beams(major=T.Quantity(6.0 + 0.6 * t, "arcsec"),
                    minor=T.Quantity(4.5 + 0.45 * t, "arcsec"),
                    pa=T.Quantity(pa + (4.0 * t if pa else 0.0), "deg"))
    cube = T.VaryingResolutionSpectralCube(data, WCS(header=h), header=h,
                                           beams=beams, device=dev)
    return cube.with_mask(T.LazyMask(torch.isfinite, cube=cube)), h


@pytest.mark.parametrize("route", ["per_channel_separable", "fft"])
def test_vrsc_pipeline_on_cuda_matches_cpu(cuda, route):
    """run_pipeline on a varying-resolution CUDA cube (common beam, SNR
    mask, moments, a target rotated by 3 deg) agrees with the CPU run; the
    separable route launches conv_sep, the FFT route no convolution
    kernel (cuFFT).  The FFT case has no NaN border: its sub-pixel kernels
    divide by a denominator near the 1e-6 floor there, where cuFFT's and
    the CPU FFT's roundings part by more than the tolerance."""
    pa, groups = (0.0, 2) if route != "fft" else (30.0, 1)
    out = {}
    for dev in ("cpu", cuda):
        cube, h = _vr_cube(dev, pa, groups, border=route != "fft")
        target = Header(h)
        th = np.deg2rad(3.0)
        target["PC1_1"], target["PC1_2"] = np.cos(th), -np.sin(th)
        target["PC2_1"], target["PC2_2"] = np.sin(th), np.cos(th)
        K.reset_launch_counts()
        out[str(dev)] = T.run_pipeline(cube, snr_threshold=2.0,
                                       target_header=target,
                                       noise_estimate=0.3)
        assert tconv.convolve_cube_to_beam.last["route"] == route
        counts = K.launch_counts()
        if str(dev) != "cpu":
            assert counts["moments"] > 0, counts
            assert (counts["conv_sep"] > 0) == (route != "fft"), counts
    a, b = out["cpu"], out[str(cuda)]
    for pa_, pb in zip(a["moments"][:2], b["moments"][:2]):
        va, vb = np.asarray(pa_.value), np.asarray(pb.value)
        both = np.isfinite(va) & np.isfinite(vb)
        assert both.sum() > 0.5 * va.size
        np.testing.assert_allclose(vb[both], va[both], rtol=1e-4, atol=1e-4)
    assert a["statistics"]["npts"] == b["statistics"]["npts"]
    _close(b["cube"]._data, a["cube"]._data, rtol=1e-5, atol=1e-5)


def test_rotated_gather_on_cuda_matches_cpu(cuda):
    """The four-corner gather (a rotated target, orders 1 and 0) on the
    card agrees with the CPU run; NaN patterns equal."""
    data = _noise_cube((6, 40, 44), 3)
    yy, xx = np.mgrid[0:42, 0:46].astype(np.float64)
    th = np.deg2rad(3.0)
    ys = np.cos(th) * (yy - 19.5) - np.sin(th) * (xx - 21.5) + 19.5
    xs = np.sin(th) * (yy - 19.5) + np.cos(th) * (xx - 21.5) + 21.5
    zs = np.array([0.0, 1.5, 2.25, 4.0])
    for order in (0, 1):
        want = tregrid._bilinear_spatial_then_linear_z(
            torch.as_tensor(data), zs, ys, xs, order)
        got = tregrid._bilinear_spatial_then_linear_z(
            torch.as_tensor(data, device=cuda), zs, ys, xs, order)
        assert got.device.type == "cuda"
        _close(got, want, rtol=1e-6, atol=1e-6)


def test_spectral_array_mask_broadcasts_on_the_card(cuda):
    """A 1-D channel mask (the flagged planes of a varying-resolution
    cube) evaluated against CUDA data moves as its (n,) array and
    broadcasts there: the include is a stride-0 view, not a cube-sized
    copy made on the host and moved across."""
    data = torch.zeros((6, 40, 44), device=cuda)
    m = T.BooleanArrayMask(np.array([True, False, True, True, False, True]),
                           shape=tuple(data.shape))
    inc = m.include(data=data)
    assert inc.device.type == "cuda"
    assert inc.stride()[1:] == (0, 0)
    assert inc.cpu().numpy()[:, 3, 5].tolist() == [True, False, True, True,
                                                   False, True]


@pytest.mark.parametrize("order", [2, 3])
def test_banded_matmul_on_the_spline_operator(cuda, order):
    """Kernel 7 on the spline path's spectral operator (a new axis at twice
    the channel width): ``tz`` and ``|tz|`` against the plain version, and
    the whole spline resample on the card against the CPU run."""
    from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
    data = _noise_cube((64, 24, 28), 9)
    zs = 0.25 + 2.0 * np.arange(31)
    tz = tregrid._spline_1d_matrix(64, zs, order)
    flat = torch.nan_to_num(torch.as_tensor(data, device=cuda)).reshape(64, -1)
    for M in (tz, np.abs(tz)):
        bands = kbm.row_bands(M)
        assert kbm.fits(bands)
        kbm.banded_matmul.launches = 0
        got = kbm.banded_matmul(flat, bands)
        assert kbm.banded_matmul.launches == 1
        _close(got, kbm.banded_matmul_plain(flat, bands))
    ys = np.broadcast_to(np.arange(24.0)[:, None] + 0.37, (24, 28)).copy()
    xs = np.broadcast_to(np.arange(28.0)[None, :] - 0.61, (24, 28)).copy()
    kbm.banded_matmul.launches = 0
    got = tregrid._bilinear_spatial_then_linear_z(
        torch.as_tensor(data, device=cuda), zs, ys, xs, order)
    assert kbm.banded_matmul.launches == 2
    assert tregrid._spectral_product.last == "banded_matmul"
    want = tregrid._bilinear_spatial_then_linear_z(torch.as_tensor(data), zs,
                                                   ys, xs, order)
    _close(got, want, rtol=1e-5, atol=1e-5)
