"""Torch port, kernel 6 (fused convolve + axis-aligned reproject, and its
clean branch, the per-channel banded apply) against the JAX package.

The same numpy inputs go through the JAX functions (the Pallas
``conv_reproject_raw_strips`` and ``per_channel_plain_strips`` kernels in
interpret mode, and ``convolve_reproject_separable`` with its TPU gate
forced open, which then runs its jnp branches on the CPU) and through the
port on CPU tensors, where the kernel's wrappers run their plain PyTorch
versions.  Tolerances are the JAX tests' own: atol 2e-5 after an exact NaN
pattern for the fused kernel (test_banded_pallas.py:440-492), rtol 3e-5 /
atol 1e-5 for the banded apply (:316-338), rtol 2e-5 / atol 1e-6 for
``convolve_reproject_separable`` (test_regrid.py:374-407).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.ops import regrid as jrg
from spectral_cube_tpu.ops.banded_pallas import (conv_reproject_raw_strips,
                                                 per_channel_plain_strips)
from spectral_cube_tpu.ops.convolve import _conv_matrix_1d as j_conv_matrix
from spectral_cube_tpu.ops.interpolate import _interp_matrix as j_interp

from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.kernels import conv_reproject as kcr
from spectral_cube_tpu_torch.ops import regrid as trg


def _gauss2d(sig_y, sig_x, theta=0.0, size=15):
    x = np.arange(size) - size // 2
    yy, xx = np.meshgrid(x, x, indexing="ij")
    yr = yy * np.cos(theta) + xx * np.sin(theta)
    xr = -yy * np.sin(theta) + xx * np.cos(theta)
    k = np.exp(-0.5 * ((yr / sig_y) ** 2 + (xr / sig_x) ** 2))
    return k / k.sum()


def _shift_maps(ny, nx, ty=0.37, tx=0.61):
    ys = np.broadcast_to(np.arange(ny, dtype=np.float64)[:, None] + ty,
                         (ny, nx)).copy()
    xs = np.broadcast_to(np.arange(nx, dtype=np.float64)[None, :] + tx,
                         (ny, nx)).copy()
    return ys, xs


def _run(data, ops):
    return kcr.conv_reproject(torch.as_tensor(data), ops.gy, ops.gx, ops.my,
                              ops.mx, ops.ry, ops.rx, ops.valid).numpy()


@pytest.mark.parametrize("theta", [0.0, 0.2])
def test_conv_reproject_matches_pallas_kernel(theta):
    """Clean channels (composed G), a channel with one NaN voxel (the exact
    chain) and an all-NaN channel, isotropic (rank 1) and rotated (rank >
    1) kernels; the port's host operators equal the JAX ones bitwise."""
    rng = np.random.RandomState(9)
    nchan, ny, nx = 4, 128, 128
    k = _gauss2d(3.0, 1.5, theta=theta, size=15)
    data = rng.randn(nchan, ny, nx).astype(np.float32)
    data[1, 60, 60] = np.nan
    data[2, :, :] = np.nan
    ys, xs = _shift_maps(ny, nx)
    ops = trg._conv_reproject_operators(data.shape, k, ys, xs)
    jops = jrg._conv_reproject_operators(data.shape, k, ys, xs, force=True)
    assert ops.rank == jops[7] == (1 if theta == 0.0 else ops.rank)
    np.testing.assert_array_equal(ops.gy.dense(ny), jops[0])
    np.testing.assert_array_equal(ops.gx.dense(nx), jops[1])
    np.testing.assert_array_equal(ops.valid, jops[6])
    for rows, R in ((ops.ry, jops[4][0, 0]), (ops.rx, jops[5][0, 0])):
        n = np.arange(R.shape[0])
        np.testing.assert_array_equal(R[n, rows.i0], rows.w0)
        np.testing.assert_array_equal(R[n, rows.i0 + 1], rows.w1)
    ref = np.asarray(conv_reproject_raw_strips(jnp.asarray(data), *jops[:7],
                                               interpret=True))
    got = _run(data, ops)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[2]).all() and np.isnan(got[1]).any()
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=2e-5)


@pytest.mark.parametrize("dense_x", [True, False])
def test_plain_strips_matches_pallas_kernel(dense_x):
    """The clean branch on a rank-2 composed convolve + resample operator,
    against the Pallas apply and a float64 oracle."""
    rng = np.random.RandomState(6)
    nz, n = 4, 128
    data = rng.randn(nz, n, n).astype(np.float32)
    k1 = np.exp(-0.5 * ((np.arange(9) - 4) / 1.5) ** 2)
    k2 = np.exp(-0.5 * ((np.arange(9) - 4) / 2.5) ** 2)
    R = j_interp(np.arange(n, dtype=np.int64).clip(0, n - 2),
                 np.full(n, 0.25), n).astype(np.float64)
    Gy = np.stack([(R @ j_conv_matrix(n, k).astype(np.float64))
                   .astype(np.float32) for k in (k1, k2)])[None]
    Gx = np.stack([(R @ j_conv_matrix(n, k).astype(np.float64))
                   .astype(np.float32) for k in (k2, k1)])[None]
    ref = np.asarray(per_channel_plain_strips(
        jnp.asarray(data), Gy, Gx, np.zeros(nz, np.int32), interpret=True,
        dense_x=dense_x))
    got = kcr.plain_strips(torch.as_tensor(data), kcr.bands_of(Gy),
                           kcr.bands_of(Gx), np.zeros(nz, np.int32)).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-5)
    exp = sum(np.einsum("ab,cbx,vx->cav", Gy[0, i].astype(np.float64),
                        data.astype(np.float64),
                        Gx[0, i].astype(np.float64)) for i in range(2))
    np.testing.assert_allclose(got, exp, rtol=3e-5, atol=1e-5)


def test_plain_strips_two_groups_and_rectangular():
    """Channels interleaved over two groups of rectangular operators (one
    with an empty row), against a float64 oracle."""
    rng = np.random.RandomState(3)
    nchan, ny, nx, ny_out, nx_out = 5, 40, 70, 30, 50
    data = rng.randn(nchan, ny, nx).astype(np.float32)
    band_y = np.abs(np.arange(ny_out)[:, None] * 1.2
                    - np.arange(ny)[None]) < 3
    band_x = np.abs(np.arange(nx_out)[:, None] * 1.3
                    - np.arange(nx)[None]) < 4
    My = (rng.rand(2, 2, ny_out, ny) * band_y).astype(np.float32)
    Mx = (rng.rand(2, 2, nx_out, nx) * band_x).astype(np.float32)
    My[1, :, 5] = 0.0
    gi = np.array([1, 0, 1, 1, 0], np.int32)
    yb = kcr.bands_of(My)
    assert yb.start[1, 5] == -1
    np.testing.assert_array_equal(yb.dense(ny), My)
    got = kcr.plain_strips(torch.as_tensor(data), yb, kcr.bands_of(Mx),
                           gi).numpy()
    exp = np.stack([sum(My[g, i].astype(np.float64) @ data[c].astype(
        np.float64) @ Mx[g, i].T.astype(np.float64) for i in range(2))
        for c, g in enumerate(gi)])
    np.testing.assert_allclose(got, exp, rtol=3e-5, atol=1e-5)
    assert (got[[0, 2, 3], 5] == 0).all()


def _matmul_on(monkeypatch):
    monkeypatch.setattr(jrg, "_use_matmul_resample", lambda: True)


@pytest.mark.parametrize("poke_nan", [False, True])
def test_convolve_reproject_separable_matches_jax(monkeypatch, poke_nan):
    """A rescaled, offset target on a non-square input (test_regrid.py:
    374-407), all-finite and with NaN in two channels, against the JAX
    function with its TPU gate open."""
    _matmul_on(monkeypatch)
    rng = np.random.RandomState(13)
    x1 = np.arange(9) - 4
    kern = np.exp(-0.5 * np.add.outer(x1 ** 2, x1 ** 2) / 1.5 ** 2)
    ny_in, nx_in = 20, 18
    ys = np.broadcast_to(np.linspace(-0.4, ny_in - 0.7, 16)[:, None],
                         (16, 14)).copy()
    xs = np.broadcast_to(np.linspace(0.3, nx_in - 0.2, 14)[None, :],
                         (16, 14)).copy()
    if poke_nan:
        rng.rand(4, ny_in, nx_in)
    data = rng.rand(4, ny_in, nx_in).astype("f4")
    if poke_nan:
        data[0, 3, 3] = np.nan
        data[2, 10:12, 5] = np.nan
    ref = np.asarray(jrg.convolve_reproject_separable(jnp.asarray(data), kern,
                                                      ys, xs))
    got = trg.convolve_reproject_separable(torch.as_tensor(data), kern, ys,
                                           xs)
    assert got is not None and got.dtype == torch.float32
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got).any()     # the first output row is out of range
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6,
                               equal_nan=True)


def _kern9():
    x1 = np.arange(9) - 4
    return np.exp(-0.5 * np.add.outer(x1 ** 2, x1 ** 2) / 1.5 ** 2)


@pytest.mark.parametrize("case", ["rotated", "non_separable", "too_large",
                                  "singleton_axis"])
def test_convolve_reproject_separable_declines_where_jax_does(monkeypatch,
                                                              case):
    _matmul_on(monkeypatch)
    rng = np.random.RandomState(1)
    kern = _kern9()
    shape, (ys, xs) = (4, 20, 18), _shift_maps(16, 14, 0.2, 0.3)
    if case == "rotated":
        ys = ys + 0.01 * np.arange(14)[None, :]
    elif case == "non_separable":
        kern = rng.rand(15, 15)      # full rank: no SVD-separable form
    elif case == "too_large":
        shape, (ys, xs) = (1, 4100, 3), _shift_maps(4100, 2, 0.2, 0.3)
    else:
        shape, (ys, xs) = (2, 1, 18), _shift_maps(1, 14, 0.0, 0.3)
    data = rng.rand(*shape).astype("f4")
    want = jrg.convolve_reproject_separable(jnp.asarray(data), kern, ys, xs)
    got = trg.convolve_reproject_separable(torch.as_tensor(data), kern, ys,
                                           xs)
    assert want is None and got is None


def test_bands_keep_the_composed_values():
    """G bands hold exactly the host-composed float32 values, K + 1 taps
    per row and rank, and the chain's taps are conv_sep's."""
    k = _gauss2d(2.0, 1.2, 0.3, 11)
    ys, xs = _shift_maps(40, 52, 0.37, -0.61)
    ops = trg._conv_reproject_operators((3, 40, 52), k, ys, xs)
    assert ops.gy.taps.shape == (1, ops.rank, 40, 12)
    assert ops.gx.taps.shape == (1, ops.rank, 52, 12)
    assert ops.my.taps.shape == (ops.rank, 11) and ops.my.half == 5
    kb = kcr.bands_of(ops.gy.dense(40))
    np.testing.assert_array_equal(kb.taps, ops.gy.taps)
    # x starts 0.61 px before the plane, y ends 0.37 px past it
    assert not ops.valid[:, 0].any() and not ops.valid[-1].any()
    assert ops.valid[:-1, 1:].all()


def test_plain_versions_leave_the_counters_alone():
    K.reset_launch_counts()
    rng = np.random.RandomState(2)
    data = rng.randn(3, 24, 30).astype(np.float32)
    data[1, 4, 4] = np.nan
    ys, xs = _shift_maps(24, 30)
    ops = trg._conv_reproject_operators(data.shape, _kern9(), ys, xs)
    _run(data, ops)
    kcr.plain_strips(torch.as_tensor(data), ops.gy, ops.gx,
                     np.zeros(3, np.int32))
    assert all(n == 0 for n in K.launch_counts().values())


def _wide_gauss(size):
    """A circular Gaussian of ``size`` taps, sigma size / 8 (rank 1)."""
    x = np.arange(size) - size // 2
    g = np.exp(-0.5 * (x / (size / 8.0)) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


@pytest.mark.parametrize("size,fits,fits2", [(9, True, True),
                                             (147, True, True),
                                             (149, True, False),
                                             (207, True, False),
                                             (209, False, False),
                                             (221, False, False)])
def test_fused_plan_fits_up_to_the_widest_window(size, fits, fits2):
    """Kernel 6's plan, decided from the operators' shapes: the chain's
    window spans L + 1 input rows and columns beyond the output tile, so a
    rank-1 kernel of up to 207 taps fits at some tile of _OUTPUT_TILES on
    this plane and 209 taps and more decline.  The moments mode (2) keeps
    its 32 x 24 input tile and a 14-word moment state per spaxel, and
    declines from 149 taps."""
    shape = (3, 30, 34)
    ys, xs = _shift_maps(30, 34, 0.37, -0.61)
    ops = trg._conv_reproject_operators(shape, _wide_gauss(size), ys, xs)
    assert ops is not None and ops.rank == 1
    assert trg.fused_plan_fits(shape, ops) == fits
    assert trg.fused_plan_fits(shape, ops, mode=2) == fits2
    tiling = kcr.plan(0, shape, ops.gy, ops.gx,
                      (ops.my, ops.mx, ops.ry, ops.rx))
    assert (tiling is not None) == fits
    if fits:
        assert tiling[0]["smem"] <= 232448


def test_fused_plan_declines_a_strong_upsampling_in_moments_mode():
    """Mode 2 groups the outputs by the input tile that holds their
    sample: 1100 output columns from an 8-column plane put more than the
    kernel's 1024 outputs per pass on one tile, so the moments mode
    declines while mode 0, which tiles the outputs, fits."""
    shape = (3, 12, 8)
    ys = np.broadcast_to(np.arange(12, dtype=np.float64)[:, None],
                         (12, 1100)).copy()
    xs = np.broadcast_to(np.linspace(0.0, 7.0, 1100)[None, :],
                         (12, 1100)).copy()
    ops = trg._conv_reproject_operators(shape, _kern9(), ys, xs)
    assert trg.fused_plan_fits(shape, ops)
    assert not trg.fused_plan_fits(shape, ops, mode=2)


def test_declined_plan_takes_the_jax_chain():
    """Where kernel 6's plan does not fit (a 221-tap kernel),
    convolve_reproject_separable computes the JAX function's two-stage
    chain (regrid.py:619-626: convolve2d_separable with the normalized
    kernel, then the bilinear resample, out-of-range outputs NaN) and
    moments_conv_reproject_fused returns None, as the JAX function does
    when its planner declines; a 9-tap kernel keeps the fused route.
    Tolerance: test_convolve_reproject_separable_matches_jax's."""
    from spectral_cube_tpu.ops import convolve as jconv
    from spectral_cube_tpu_torch.ops import pipeline_fused as tpf
    rng = np.random.RandomState(5)
    data = (1.0 + rng.rand(3, 30, 34)).astype(np.float32)
    data[1, 10:13, 4:9] = np.nan
    data[2, :, -2:] = np.nan
    ys, xs = _shift_maps(30, 34, 0.37, -0.61)
    kern = _wide_gauss(221)
    K.reset_launch_counts()
    got = trg.convolve_reproject_separable(torch.as_tensor(data), kern, ys,
                                           xs)
    assert trg.convolve_reproject_separable.last == {"route": "chain"}
    assert all(n == 0 for n in K.launch_counts().values())
    conv = jconv.convolve2d_separable(jnp.asarray(data), kern / kern.sum())
    ref = np.asarray(jrg._bilinear_spatial_then_linear_z(
        conv, np.arange(3, dtype=np.float64), ys, xs, 1))
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[:, :, 0]).all() and np.isfinite(got[0, :-1, 1:]).all()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6,
                               equal_nan=True)
    coords = np.arange(3, dtype=np.float64)
    assert tpf.moments_conv_reproject_fused(torch.as_tensor(data), kern, ys,
                                            xs, coords, 1.0) is None
    trg.convolve_reproject_separable(torch.as_tensor(data), _kern9(), ys, xs)
    assert trg.convolve_reproject_separable.last == {"route": "fused"}


def _dense_from_blobs(ap, n_in, n_out, G, r, y_axis):
    """Every output's G row as the kernel reads it from the tap blobs of
    the axis plan ``ap`` ((G, r, n_out, n_in) float32), checking on the
    way that each read lies in the tile's window ``[win0, win0 + reach)``
    and that padded taps are zero."""
    W4, RP = ap["width"], -(-r // 4) * 4
    out = np.zeros((G, r, n_out, n_in), np.float32)
    seen = np.zeros((G, n_out), int)
    tiles = ap["tiles"]
    for g in range(G):
        for t in range(tiles):
            b = ap["blob"][ap["blob_off"][g * tiles + t]:
                           ap["blob_off"][g * tiles + t + 1]]
            f = b.view(np.float32)
            outs = ap["perm"][ap["off"][t]:ap["off"][t + 1]]
            w0 = int(ap["win0"][g, t])
            for k in range(-(-outs.size // 8)):
                s0, uni, pos, cnt = (int(v) for v in b[12 * k:12 * k + 4])
                d = b[12 * k + 4:12 * k + 12]
                assert cnt == min(8, outs.size - 8 * k) and pos % 4 == 0
                for m in range(cnt):
                    if uni:
                        assert d[m] == m
                        taps = (f[pos:pos + W4 * RP].reshape(W4, RP)[:, :r].T
                                if y_axis else
                                f[pos:pos + r * W4].reshape(r, W4))
                        first, last = s0 + m, s0 + W4 + 7
                    else:
                        taps = (f[pos:pos + 8 * W4 * RP].reshape(
                            8, W4, RP)[m, :, :r].T if y_axis else
                            f[pos:pos + 8 * r * W4].reshape(8, r, W4)[m])
                        first = s0 + int(d[m])
                        last = first + W4
                    assert w0 <= first and last <= w0 + ap["reach"]
                    cols = first + np.arange(W4)
                    inside = (cols >= 0) & (cols < n_in)
                    assert (taps[:, ~inside] == 0).all()
                    o = outs[8 * k + m]
                    out[g, :, o][:, cols[inside]] = taps[:, inside]
                    seen[g, o] += 1
    assert (seen == 1).all()
    return out


_MAPPINGS = {"shift": (45, 70, 1.0, 0.37, 1.0, -0.61),
             "coarser": (31, 47, 1.5, 0.2, 1.5, -0.3),
             "finer": (90, 140, 0.5, 0.1, 0.5, 0.3),
             "flipped": (45, 70, -1.0, 43.7, 1.0, 0.4)}


def _axis_maps(ny, nx, ay, by, ax, bx):
    ys = np.broadcast_to((np.arange(ny) * ay + by)[:, None], (ny, nx))
    xs = np.broadcast_to((np.arange(nx) * ax + bx)[None, :], (ny, nx))
    return ys.astype(np.float64), xs.astype(np.float64)


@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("mapping", list(_MAPPINGS))
def test_tap_blobs_reproduce_the_dense_operators(mapping, mode):
    """The kernel's tap layout (descriptors of 8 outputs, uniform or per
    output) holds exactly ``Bands.dense()`` of both axes, for a
    translation, a coarser and a finer target and a flipped y axis, in the
    output tiling (mode 0) and the input tiling (mode 2); every read lies
    in the staged window."""
    ny, nx = 45, 70
    ys, xs = _axis_maps(*_MAPPINGS[mapping])
    ops = trg._conv_reproject_operators((6, ny, nx),
                                        _gauss2d(2.0, 1.2, 0.3, 11), ys, xs)
    py, px = kcr.plan(mode, (6, ny, nx), ops.gy, ops.gx,
                      (ops.my, ops.mx, ops.ry, ops.rx))
    r = ops.rank
    assert r > 1
    for ap, bands, n_in, y_axis in ((py, ops.gy, ny, True),
                                    (px, ops.gx, nx, False)):
        n_out = bands.start.shape[1]
        got = _dense_from_blobs(ap, n_in, n_out, 1, r, y_axis)
        np.testing.assert_array_equal(got, bands.dense(n_in))


def test_tap_blobs_two_groups_with_an_empty_row():
    """Two groups of rectangular operators, one with a row that has no
    taps (it reads zeros from its tile's window), in the clean-only
    tiling."""
    rng = np.random.RandomState(3)
    ny, nx, ny_out, nx_out = 40, 70, 30, 50
    band_y = np.abs(np.arange(ny_out)[:, None] * 1.2
                    - np.arange(ny)[None]) < 3
    band_x = np.abs(np.arange(nx_out)[:, None] * 1.3
                    - np.arange(nx)[None]) < 4
    My = (rng.rand(2, 3, ny_out, ny) * band_y).astype(np.float32)
    Mx = (rng.rand(2, 3, nx_out, nx) * band_x).astype(np.float32)
    My[1, :, 5] = 0.0
    yb, xb = kcr.bands_of(My), kcr.bands_of(Mx)
    py, px = kcr.plan(1, (7, ny, nx), yb, xb)
    np.testing.assert_array_equal(
        _dense_from_blobs(py, ny, ny_out, 2, 3, True), My)
    np.testing.assert_array_equal(
        _dense_from_blobs(px, nx, nx_out, 2, 3, False), Mx)


def _pipeline_ops(n=768):
    """The pipeline's shape: the 19 x 19 kernel from a 6" x 4.5" beam at
    PA 30 deg to 12" on 2" pixels (rank 5) and a grid shifted by (0.37,
    -0.61) px on an n x n plane."""
    import spectral_cube_tpu_torch as T
    arcsec = lambda v: T.Quantity(v, "arcsec")  # noqa: E731
    cube = T.Beam(arcsec(6.0), arcsec(4.5), T.Quantity(30.0, "deg"))
    target = T.Beam(arcsec(12.0), arcsec(12.0), T.Quantity(0.0, "deg"))
    k = target.deconvolve(cube).as_kernel(np.radians(2.0 / 3600.0))
    ys, xs = _shift_maps(n, n, 0.37, -0.61)
    ops = trg._conv_reproject_operators((4, n, n), k, ys, xs)
    assert ops.rank == 5 and ops.gy.taps.shape[3] == 20
    return ops


def test_tap_blobs_at_the_pipeline_shape():
    """768 x 768, rank 5, 20 G taps per row: the blobs reproduce the dense
    operators, and every descriptor is uniform but those whose bands the
    plane's edges clip (two at each end of each axis)."""
    ops = _pipeline_ops()
    py, px = kcr.plan(0, (4, 768, 768), ops.gy, ops.gx,
                      (ops.my, ops.mx, ops.ry, ops.rx))
    for ap, bands, y_axis in ((py, ops.gy, True), (px, ops.gx, False)):
        np.testing.assert_array_equal(
            _dense_from_blobs(ap, 768, 768, 1, 5, y_axis), bands.dense(768))
        uniform = []
        for t in range(ap["tiles"]):
            b = ap["blob"][ap["blob_off"][t]:ap["blob_off"][t + 1]]
            n8 = -(-(ap["off"][t + 1] - ap["off"][t]) // 8)
            uniform += list(b[1:12 * n8:12])
        assert len(uniform) == 96 and sum(uniform) == 92


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plan_mirrors_the_kernel_layout(mode):
    """plan() picks the first tile of its list whose block fits twice in
    an SM's shared memory, and its bytes are layout()'s arithmetic
    (_smem_bytes, which _launch holds against sct_conv_reproject_smem):
    at the pipeline's shape every mode fits two blocks, 32 output rows
    deep; modes 0 and 1 take 64 columns, since the 128-column tile before
    it in the list does not fit twice, and mode 2 its 32 x 24 input
    tile."""
    ops = _pipeline_ops()
    shape = (4, 768, 768)
    chain = None if mode == 1 else (ops.my, ops.mx, ops.ry, ops.rx)
    py, px = kcr.plan(mode, shape, ops.gy, ops.gx, chain)
    ky = 0 if mode == 1 else 19
    assert py["smem"] == kcr._smem_bytes(mode, 5, py, px, ky, ky)
    assert py["smem"] <= kcr._TWO_BLOCKS
    assert py["max_count"] == 32
    if mode == 2:
        assert (py["tiles"], px["tiles"]) == (24, 32)
        return
    assert kcr._OUTPUT_TILES[:2] == ((32, 128), (32, 64))
    assert (py["tiles"], px["tiles"], px["max_count"]) == (24, 12, 64)
    wide = kcr._axis_plan(768, ops.gx, 128, chain and (19, int(ops.mx.half)),
                          chain and ops.rx.i0)
    wide.update(kcr._blobs(wide, ops.gx, False))
    assert kcr._smem_bytes(mode, 5, py, wide, ky, ky) > kcr._TWO_BLOCKS
