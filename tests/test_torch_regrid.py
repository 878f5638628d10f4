"""Torch port, kernel 3 (axis-aligned 2-tap resample, from raw data and
from NaN-filled data with a NaN-weight plane), reprojection onto a new
spectral axis, the four-corner gather (rotated targets, order 0) and the
spline orders 2 and 3 (the spectral operator through kernel 7), against
the JAX package.

The same numpy inputs go through the JAX functions (the Pallas
``per_channel_shift_lerp`` / ``per_channel_resample_raw_strips`` /
``per_channel_resample_strips`` kernels in interpret mode, and
``_bilinear_spatial_then_linear_z``, which takes its gather path on the
CPU) and through the port on CPU tensors, where the kernel's wrappers run
their plain PyTorch versions.  Tolerance: atol 5e-6 on unit-variance data,
the JAX raw-strips test's own (test_banded_pallas.py:381), rtol 3e-5 /
atol 1e-5 for the filled resample (:284-312), after an exact NaN
pattern.  The spline cases are the JAX tests' own inputs
(test_regrid.py:950-1056): equal NaN patterns and atol 5e-6 against the
JAX package, and the JAX tests' tolerances against scipy's
``map_coordinates``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu.io.fits_low import HDU, write_fits
from spectral_cube_tpu.ops import banded_pallas as jbp
from spectral_cube_tpu.ops import regrid as jregrid
from spectral_cube_tpu.ops.interpolate import _interp_matrix as j_interp

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.kernels import resample2 as kres
from spectral_cube_tpu_torch.ops import regrid as tregrid
from spectral_cube_tpu_torch.ops.interpolate import _interp_matrix

from conftest import base_header


def _data(shape, seed):
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32)
    data[1, 3, 40] = np.nan
    data[1, 10, 7] = np.inf            # inf clamps, only NaN poisons
    data[-1] = np.nan                  # all-NaN channel
    return data


def _small_data(shape, seed):
    """_data's pattern at any shape: one NaN, one inf, an all-NaN last
    channel."""
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32)
    _, ny, nx = shape
    data[1, 2, 3] = np.nan
    data[1, ny - 3, nx // 2] = np.inf
    data[-1] = np.nan
    return data


def _maps(ny_out, nx_out, ay, by, ax, bx):
    ys = np.broadcast_to((np.arange(ny_out) * ay + by)[:, None],
                         (ny_out, nx_out)).astype(np.float64)
    xs = np.broadcast_to((np.arange(nx_out) * ax + bx)[None, :],
                         (ny_out, nx_out)).astype(np.float64)
    return ys.copy(), xs.copy()


def _both(data, ys, xs):
    zs = np.arange(data.shape[0], dtype=np.float64)
    got = tregrid._bilinear_spatial_then_linear_z(
        torch.as_tensor(data), zs, ys, xs, 1).numpy()
    ref = np.asarray(jregrid._bilinear_spatial_then_linear_z(
        jnp.asarray(data), zs, ys, xs, 1))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=5e-6)
    return got


@pytest.mark.parametrize("ty,tx", [(0.37, 0.61), (-0.4, 2.25), (3.0, -1.0)])
def test_translation_matches_shift_lerp_and_gather(ty, tx):
    nchan, ny, nx = 3, 64, 128
    data = _data((nchan, ny, nx), 13)
    ys, xs = _maps(ny, nx, 1.0, ty, 1.0, tx)
    tr = tregrid._translation_params(ys, xs, ny, nx)
    assert tr == jregrid._translation_params(ys, xs, ny, nx)
    got = _both(data, ys, xs)
    maps = tregrid.bilinear_host_maps(np.arange(nchan, dtype=float), ys, xs,
                                      nchan, ny, nx, 1)
    valid = maps[4] & maps[5]
    ref = np.asarray(jbp.per_channel_shift_lerp(
        data, tr[0], tr[1], tr[2], tr[3], valid, None, interpret=True))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=5e-6)


def test_scaled_target_matches_raw_strips_and_float64():
    """A scaled, offset axis-aligned target with out-of-range edges
    (valid_plane), NaN poisoning and zvalid, against the TPU raw-input
    kernel and a float64 oracle of the staged path."""
    nchan, ny, nx = 4, 128, 128
    data = _data((nchan, ny, nx), 11)
    ys, xs = _maps(ny, nx, 0.93, 3.2, 1.07, -2.6)
    assert tregrid._translation_params(ys, xs, ny, nx) is None
    got = _both(data, ys, xs)
    (_, _, _, _, yv, xv, y0, _, wy, x0, _, wx) = tregrid.bilinear_host_maps(
        np.arange(nchan, dtype=float), ys, xs, nchan, ny, nx, 1)
    valid = yv & xv
    assert not valid.all()
    zvalid = np.array([1, 1, 0, 1], bool)
    out = kres.resample2(torch.as_tensor(data), y0[:, 0], wy[:, 0],
                         x0[0, :], wx[0, :], valid, zvalid).numpy()
    my = _interp_matrix(y0[:, 0].astype(np.int64), wy[:, 0], ny)
    mx = _interp_matrix(x0[0, :].astype(np.int64), wx[0, :], nx)
    np.testing.assert_array_equal(my, j_interp(y0[:, 0].astype(np.int64),
                                               wy[:, 0], ny))
    ref = np.asarray(jbp.per_channel_resample_raw_strips(
        data, my[None, None], mx[None, None], np.zeros(nchan, np.int32),
        valid_plane=valid, zvalid=zvalid.astype(np.int32), interpret=True))
    filled = np.nan_to_num(data).astype(np.float64)
    oracle = np.einsum("ab,cbx,vx->cav", my.astype(np.float64), filled,
                       mx.astype(np.float64))
    wn = np.einsum("ab,cbx,vx->cav", my.astype(np.float64),
                   np.isnan(data).astype(np.float64), mx.astype(np.float64))
    oracle[wn > 1e-6] = np.nan
    oracle[:, ~valid] = np.nan
    oracle[~zvalid] = np.nan
    for other in (ref, oracle):
        assert np.array_equal(np.isnan(out), np.isnan(other))
        fin = ~np.isnan(other)
        np.testing.assert_allclose(out[fin], other[fin], atol=5e-6)
    np.testing.assert_array_equal(np.isnan(out[[0, 1, 3]]),
                                  np.isnan(got[[0, 1, 3]]))


def test_zero_weight_nan_neighbour_never_poisons():
    """Integer shifts and exact hits put weight 0 on the second tap: a NaN
    there must not poison the output (banded_pallas.py:1559-1561)."""
    nchan, ny, nx = 2, 8, 12
    data = np.arange(nchan * ny * nx, dtype=np.float32).reshape(nchan, ny,
                                                                 nx)
    data[0, 4, 6] = np.nan
    ys, xs = _maps(ny, nx, 1.0, 1.0, 1.0, 0.0)
    got = _both(data, ys, xs)
    nan_at = np.argwhere(np.isnan(got))
    # only the output that samples (4, 6) exactly is NaN
    assert nan_at.tolist() == [[0, 3, 6]] + [[c, ny - 1, x] for c in (0, 1)
                                            for x in range(nx)]


def test_host_maps_are_the_jax_maps():
    ys, xs = _maps(10, 14, 0.8, -1.3, 1.2, 0.4)
    zs = np.arange(5, dtype=np.float64)
    a = tregrid.bilinear_host_maps(zs, ys, xs, 5, 9, 13, 1)
    b = jregrid.bilinear_host_maps(zs, ys, xs, 5, 9, 13, 1)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_unported_reprojections_raise():
    """Order 0, rotated targets and a new spectral axis run and agree with
    the JAX package; an order outside 0-3, or a name reproject_interp does
    not document, raises ValueError in both packages (the spline orders
    run: see the spline tests below)."""
    data = _small_data((3, 6, 6), 3)
    td = torch.as_tensor(data)
    ys, xs = _maps(6, 6, 1.0, 0.2, 1.0, 0.3)
    zs = np.arange(3, dtype=np.float64)
    rot_y = ys + 0.1 * np.arange(6)[None, :]
    for z, y, order in ((zs, ys, 0), (zs * 0.5, ys, 1), (zs, rot_y, 1),
                        (zs * 0.5, rot_y, 0)):
        got = tregrid._bilinear_spatial_then_linear_z(td, z, y, xs, order)
        ref = np.asarray(jregrid._bilinear_spatial_then_linear_z(
            jnp.asarray(data), z, y, xs, order))
        assert got.shape == (3, 6, 6)
        assert np.array_equal(np.isnan(got.numpy()), np.isnan(ref))
        fin = ~np.isnan(ref)
        np.testing.assert_allclose(got.numpy()[fin], ref[fin], atol=5e-6)
    for order in (4, -1, "biquintic"):
        for mod in (tregrid, jregrid):
            with pytest.raises(ValueError, match="order"):
                mod._order_int(order)


def _rotation_maps(ny_out, nx_out, ny_in, nx_in, deg, shift=(0.0, 0.0)):
    """Maps of a target rotated by ``deg`` about the input's centre (bench
    config 7's form, bench.py:575-582), optionally shifted."""
    th = np.deg2rad(deg)
    c, s = np.cos(th), np.sin(th)
    yy, xx = np.mgrid[0:ny_out, 0:nx_out].astype(np.float64)
    cy, cx = (ny_in - 1) / 2.0, (nx_in - 1) / 2.0
    ys = c * (yy - cy) - s * (xx - cx) + cy + shift[0]
    xs = s * (yy - cy) + c * (xx - cx) + cx + shift[1]
    return ys, xs


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("spectral", ["identity", "lerp", "clean"])
def test_rotated_gather_matches_jax(order, spectral):
    """The four-corner gather (rotated targets, and order 0) against the
    JAX package's gather path (regrid.py:351-408), on data with NaN (the
    poison gathers run), an inf (clamped, never poisons) and an all-NaN
    channel, and on all-finite data (the poison gathers skipped); the
    output grid is larger than the input so some outputs fall outside."""
    nchan, ny, nx = 4, 20, 24
    data = _small_data((nchan, ny, nx), 11)
    if spectral == "clean":
        data = np.random.RandomState(2).randn(nchan, ny, nx).astype(
            np.float32)
    zs = np.arange(nchan, dtype=np.float64)
    if spectral == "lerp":
        zs = np.array([0.0, 0.6, 1.25, 2.9, 3.0, 3.5])
    ys, xs = _rotation_maps(22, 26, ny, nx, 3.0, (0.4, -0.7))
    got = tregrid._bilinear_spatial_then_linear_z(torch.as_tensor(data), zs,
                                                  ys, xs, order).numpy()
    ref = np.asarray(jregrid._bilinear_spatial_then_linear_z(
        jnp.asarray(data), zs, ys, xs, order))
    assert got.shape == ref.shape == (zs.size, 22, 26)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert 0 < np.isnan(ref).sum() < ref.size
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=5e-6)


def test_rotated_gather_poisons_like_the_staged_oracle():
    """The poison branch against an independent float64 corner-gather
    replicate (tests/test_regrid.py:1081-1127's case)."""
    rng = np.random.RandomState(21)
    n = 32
    data = rng.rand(3, n, n).astype(np.float32)
    data[1, 10:13, 20] = np.nan
    data[2] = np.nan
    zs = np.arange(3, dtype=np.float64)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    th, c0 = 0.1, (n - 1) / 2.0
    ys = c0 + np.cos(th) * (yy - c0) + np.sin(th) * (xx - c0)
    xs = c0 - np.sin(th) * (yy - c0) + np.cos(th) * (xx - c0)
    got = tregrid._bilinear_spatial_then_linear_z(torch.as_tensor(data), zs,
                                                  ys, xs, 1).numpy()
    yv = (ys >= -1e-3) & (ys <= n - 1 + 1e-3)
    xv = (xs >= -1e-3) & (xs <= n - 1 + 1e-3)
    ycl, xcl = np.clip(ys, 0, n - 1), np.clip(xs, 0, n - 1)
    y0 = np.clip(ycl.astype(np.int64), 0, n - 2)
    x0 = np.clip(xcl.astype(np.int64), 0, n - 2)
    wy, wx = ycl - y0, xcl - x0
    exp = np.empty((3, n, n))
    for c in range(3):
        d = data[c].astype(np.float64)
        f, w = np.nan_to_num(d), np.isnan(d).astype(np.float64)
        acc = np.zeros((n, n))
        wn = np.zeros((n, n))
        for dy, dx, wt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                           (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
            acc += f[y0 + dy, x0 + dx] * wt
            wn += w[y0 + dy, x0 + dx] * wt
        exp[c] = np.where((wn > 1e-6) | ~(yv & xv), np.nan, acc)
    assert np.array_equal(np.isnan(got), np.isnan(exp))
    fin = ~np.isnan(exp)
    np.testing.assert_allclose(got[fin], exp[fin], rtol=1e-6, atol=1e-6)


def _rotated_header(h, deg):
    """``h`` with its celestial grid rotated by ``deg`` about CRPIX (same
    projection, pixel size and reference point)."""
    t = h.__class__(h)
    th = np.deg2rad(deg)
    c, s = np.cos(th), np.sin(th)
    t["PC1_1"], t["PC1_2"], t["PC2_1"], t["PC2_2"] = c, -s, s, c
    return t


@pytest.mark.parametrize("order", ["bilinear", "nearest-neighbor"])
def test_cube_reproject_rotated_matches_jax(tmp_path, order):
    """``cube.reproject`` onto a rotated target, through both packages'
    cube API (tests/test_regrid.py:1081's gather path end to end)."""
    nchan, ny, nx = 3, 18, 20
    data = _small_data((nchan, ny, nx), 17)
    h = base_header(nx=nx, ny=ny, nchan=nchan)
    h["BITPIX"] = -32
    h["CRPIX1"], h["CRPIX2"] = nx / 2, ny / 2
    path = str(tmp_path / "c.fits")
    write_fits(path, [HDU(data=data, header=h)])
    tcube = T.SpectralCube.read(path, device="cpu")
    jcube = J.SpectralCube.read(path)
    target = _rotated_header(tcube.header, 3.0)
    tr = tcube.reproject(target, order=order)
    jr = jcube.reproject(_rotated_header(jcube.header, 3.0), order=order)
    got, ref = tr._data.numpy(), np.asarray(jr._data)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert fin.mean() > 0.5
    np.testing.assert_allclose(got[fin], ref[fin], atol=5e-6)
    np.testing.assert_array_equal(tr.get_mask_array(),
                                  np.asarray(jr.get_mask_array()))


@pytest.mark.parametrize("dense_x", [True, False])
def test_filled_resample_matches_pallas_kernel(dense_x):
    """Kernel 3's filled entry (plain version) against the Pallas kernel on
    its test's inputs (test_banded_pallas.py:284-312) plus a fractional
    NaN weight, and against a float64 oracle."""
    rng = np.random.RandomState(5)
    nz, ny_in, nx_in = 3, 136, 128
    ny_out, nx_out = 128, 128
    fz = rng.randn(nz, ny_in, nx_in).astype(np.float32)
    wz = np.zeros_like(fz)
    wz[1, 40, 40] = 1.0          # one poisoned sample in channel 1
    wz[2, 70, 20] = 0.25         # a lerped NaN weight in channel 2
    y0 = np.arange(ny_out, dtype=np.int64)
    wy = np.full(ny_out, 0.37, np.float32)
    x0 = np.clip(np.arange(nx_out, dtype=np.int64), 0, nx_in - 2)
    wx = np.full(nx_out, 0.61, np.float32)
    my = j_interp(y0, wy, ny_in)
    mx = j_interp(x0, wx, nx_in)
    ref = np.asarray(jbp.per_channel_resample_strips(
        jnp.asarray(fz), jnp.asarray(wz), my[None, None], mx[None, None],
        np.zeros(nz, np.int32), interpret=True, dense_x=dense_x))
    valid = np.ones((ny_out, nx_out), bool)
    got = kres.resample2_filled(torch.as_tensor(fz), torch.as_tensor(wz),
                                torch.as_tensor((wz != 0).any((1, 2))), y0,
                                wy, x0, wx, valid).numpy()
    exp = np.einsum("ab,cbx,vx->cav", my.astype(np.float64),
                    fz.astype(np.float64), mx.astype(np.float64))
    wn = np.einsum("ab,cbx,vx->cav", my.astype(np.float64),
                   wz.astype(np.float64), mx.astype(np.float64))
    exp = np.where(wn > 1e-6, np.nan, exp)
    for other in (ref, exp):
        assert np.array_equal(np.isnan(got), np.isnan(other))
        fin = np.isfinite(other)
        np.testing.assert_allclose(got[fin], other[fin], rtol=3e-5,
                                   atol=1e-5)
    assert np.isnan(got[1]).any() and np.isnan(got[2]).any()
    assert not np.isnan(got[0]).any()


def _spectral_cube_file(path, nchan=24, ny=10, nx=12, seed=3):
    rng = np.random.RandomState(seed)
    data = rng.randn(nchan, ny, nx).astype(np.float32)
    data[5, 4, 6] = np.nan         # a hi channel at zf = 0 (output 2 below)
    data[11, 2:4, 3] = np.nan      # a hi channel at zf = 0.5
    data[:, 0, 0] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan)
    h["BITPIX"] = -32
    write_fits(str(path), [HDU(data=data, header=h)])
    return h


def _target(h, nz, step, start, dx=0.37, dy=-0.61):
    t = h.__class__(h)
    t["NAXIS3"] = nz
    t["CDELT3"] = h["CDELT3"] * step
    t["CRVAL3"] = h["CRVAL3"] + start * h["CDELT3"]
    t["CRPIX1"] = h["CRPIX1"] + dx
    t["CRPIX2"] = h["CRPIX2"] + dy
    return t


@pytest.mark.parametrize("step,start,nz", [(2.0, 0.0, 11), (2.0, 0.25, 13),
                                           (0.5, 1.5, 30)])
def test_reproject_onto_new_spectral_axis_matches_jax(tmp_path, step, start,
                                                      nz):
    """SpectralCube.reproject onto a target with a coarser or finer, offset
    spectral axis and a shifted spatial grid, read from FITS by both
    packages: the port's staged branch (spectral lerp, then the filled
    resample) against the JAX package's (its gather path on the CPU).  A
    NaN in a hi channel at zf = 0 must not poison; channels past the input
    axis are NaN."""
    p = tmp_path / "cube.fits"
    h = _spectral_cube_file(p)
    target = _target(h, nz, step, start)
    tcube = T.SpectralCube.read(str(p), device="cpu")
    jcube = J.SpectralCube.read(str(p))
    K.reset_launch_counts()
    tr = tcube.reproject(target)
    jr = jcube.reproject(target)
    assert all(n == 0 for n in K.launch_counts().values())
    got = tr._data.numpy()
    ref = np.asarray(jr._data)
    assert got.shape == ref.shape == (nz, 10, 12)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=5e-6)
    np.testing.assert_array_equal(np.asarray(tr.mask.include()),
                                  np.asarray(jr.mask.include()))
    assert np.isnan(got[-1]).all() == (start + step * (nz - 1) > 23)
    if start == 0.0 and step == 2.0:
        # output 2 samples input channel 4 exactly; its hi neighbour 5
        # holds a NaN at (4, 6) with weight 0
        zs = tregrid.reproject_mappings(tcube.wcs, target, 24)[0]
        assert abs(zs[2] - 4.0) < 1e-9
        assert np.isfinite(got[2, 3:6, 5:8]).all()


def test_staged_weight_flags_are_the_weight_planes():
    """The channel flags handed to the filled resample are exactly the
    channels whose lerped NaN weight plane is not all zero."""
    rng = np.random.RandomState(4)
    data = torch.as_tensor(rng.randn(9, 5, 6).astype(np.float32))
    data[2, 1, 1] = float("nan")
    data[6, 3, 2] = float("nan")
    z0 = np.array([0, 1, 2, 1, 5, 6, 7, 3], np.int32)
    zf = np.array([0.0, 1.0, 0.0, 0.5, 1.0, 0.0, 0.25, 1.0], np.float32)
    fz, wz, wz_any = tregrid._zlerp_filled(data, z0, zf)
    assert torch.equal(wz_any, (wz != 0).flatten(1).any(1))
    assert wz_any.tolist() == [False, True, True, True, True, True, False,
                               False]
    assert not torch.isnan(fz).any()


@pytest.mark.parametrize("flagged", [True, False])
def test_filled_resample_poisons_only_flagged_channels(flagged):
    """The filled resample's function, in its plain version as in the
    kernel: the poison test runs in the channels the flags name, and an
    unflagged channel's weight plane is not read."""
    rng = np.random.RandomState(6)
    fz = torch.as_tensor(rng.randn(2, 6, 7).astype(np.float32))
    wz = torch.zeros_like(fz)
    wz[1, 2, 3] = 0.5
    y0, x0 = np.arange(5), np.arange(6)
    wy = np.full(5, 0.25, np.float32)
    wx = np.full(6, 0.5, np.float32)
    valid = np.ones((5, 6), bool)
    wz_any = torch.tensor([False, flagged])
    got = kres.resample2_filled(fz, wz, wz_any, y0, wy, x0, wx, valid)
    plain = kres.resample2_filled_plain(fz, wz, wz_any, y0, wy, x0, wx, valid)
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(plain))
    assert not torch.isnan(got[0]).any()
    assert bool(torch.isnan(got[1]).any()) == flagged
    unread = wz.clone()
    unread[0] = 1.0
    assert torch.equal(
        kres.resample2_filled(fz, unread, wz_any, y0, wy, x0, wx,
                              valid).isnan(), got.isnan())
    with pytest.raises(ValueError, match="one flag per channel"):
        kres.resample2_filled(fz, wz, wz_any[:1], y0, wy, x0, wx, valid)


def test_reproject_image_and_mosaic_add_match_jax():
    rng = np.random.RandomState(8)
    h = base_header(nx=14, ny=11, nchan=3)
    img = rng.randn(11, 14).astype(np.float32)
    img[4, 5] = np.nan
    t2 = _target(h, 3, 1.0, 0.0, 0.4, -1.3)
    got, gw = tregrid.reproject_image(img, T.WCS(header=h), t2, device="cpu")
    ref, jw = jregrid.reproject_image(img, J.WCS(header=h), t2)
    assert got.device == torch.device("cpu")
    same, _ = tregrid.reproject_image(torch.as_tensor(img), T.WCS(header=h),
                                      t2)
    assert torch.equal(torch.isnan(same), torch.isnan(got))
    assert torch.equal(torch.nan_to_num(same), torch.nan_to_num(got))
    assert got.shape == (11, 14) and gw.naxis == jw.naxis == 2
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], atol=5e-6)

    cube = rng.randn(3, 11, 14).astype(np.float32)
    cube[1, 2, 2] = np.nan
    acc = torch.zeros((3, 11, 14))
    w = torch.zeros((3, 11, 14))
    jacc, jw_ = jnp.zeros((3, 11, 14)), jnp.zeros((3, 11, 14))
    for target in (_target(h, 3, 1.0, 0.0, 0.4, -1.3), h):
        acc, w = tregrid.mosaic_add(acc, w, torch.as_tensor(cube),
                                    T.WCS(header=h), target)
        jacc, jw_ = jregrid.mosaic_add(jacc, jw_, jnp.asarray(cube),
                                       J.WCS(header=h), target)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw_))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=1e-5)


def test_plain_version_leaves_the_counter_alone():
    kres.resample2.launches = 0
    data = _data((3, 16, 48), 2)
    ys, xs = _maps(16, 48, 1.0, 0.5, 1.0, 0.5)
    _both(data, ys, xs)
    assert kres.resample2.launches == 0


def _axis_taps(n_out, n_in, a, b):
    """(i0, w) of a linear axis map a * i + b, clipped to the plane: the
    form ``ops/regrid.py::_axis_aligned_taps`` gives the kernel."""
    s = np.clip(np.arange(n_out) * a + b, 0, n_in - 1)
    i0 = np.clip(np.floor(s).astype(np.int64), 0, n_in - 2)
    return i0, (s - i0).astype(np.float32)


def _unpack(packed, shape, ny_out, nx_out):
    """The sections of :func:`kres.pack_taps`'s buffer as arrays."""
    p, words, off = packed
    nchan = shape[0]
    ns = -(-nx_out // p.width)
    steps = p.tile_rows // kres.STEP_ROWS

    def sec(name, n):
        return words[off[name]:off[name] + n]

    step_off = sec("step_off", p.tiles * steps + 1)
    vwords = -(-nx_out // 32)
    return dict(
        rows=sec("rows", 2 * ny_out).reshape(-1, 2),
        cols=sec("cols", 2 * ns * p.width).reshape(-1, 2),
        strips=sec("strips", 2 * ns).reshape(-1, 2),
        list=(sec("list", ns * p.pitch).reshape(ns, p.pitch)
              if p.form == "list" else None),
        step_off=step_off, steps=steps,
        loads=sec("loads", 2 * int(step_off[-1])).reshape(-1, 2),
        valid=sec("valid", ny_out * vwords).view(np.uint32)
        .reshape(ny_out, vwords),
        zvalid=sec("zvalid", nchan),
        wflags=(sec("wflags", nchan) if p.planes == 2
                else np.zeros(nchan, np.int32)))


def _emulate_kernel(raw, y0, packed, ny_out, nx_out, wz=None,
                    channels=None, nplan=None):
    """csrc/resample2.cu's kernel on the CPU from the packed buffer alone,
    every block in turn, in float32 with its order of roundings: the raw
    entry on ``raw``, or with ``wz`` the filled entry on ``raw`` = fz.
    ``channels``: the plan's channels (of ``nplan``) that the data's
    channels are (all of them by default).  Each step's copies land in the ring as soon as they
    are issued (the earliest the card may land them), so a slot that a
    step still reads and a later step's copy overwrites gives a wrong
    value; the ring's tags also check that every output row reads its own
    two input rows.  Returns the output and, per data channel, the rows
    of fz and of wz that its blocks copied."""
    p = packed.plan
    nchan, ny_in, nx_in = raw.shape
    if channels is None:
        channels, nplan = np.arange(nchan), nchan
    t = _unpack(packed, (nplan,) + raw.shape[1:], ny_out, nx_out)
    live = t["zvalid"][channels] != 0        # a zvalid-0 block reads nothing
    flagged = live & (t["wflags"][channels] != 0)
    live_at, flagged_at = np.flatnonzero(live), np.flatnonzero(flagged)
    copies = {"fz": np.zeros(nchan, np.int64), "wz": np.zeros(nchan,
                                                              np.int64)}
    ya = np.asarray(y0, np.int64)
    yb = np.minimum(ya + 1, ny_in - 1)
    f32 = np.float32
    out = np.full((nchan, ny_out, nx_out), 7.0e30, f32)
    for st in range(-(-nx_out // p.width)):
        j = st * p.width + np.arange(p.width)
        inr = j < nx_out
        ct = t["cols"][j]
        pa, pb = ct[:, 0] & 0xffff, ct[:, 0] >> 16
        fx = ct[:, 1].view(f32)
        gx = f32(1) - fx
        s_lo, span = t["strips"][st]
        for tile in range(p.tiles):
            ring = np.full((p.planes, nchan, p.slots, p.pitch), 3.0e30, f32)
            tag = np.full(p.slots, -1)
            so = t["step_off"][tile * t["steps"]:]

            def issue(s):
                if s >= t["steps"]:
                    return
                for row, slot in t["loads"][so[s]:so[s + 1]]:
                    cols = (t["list"][st, :span] if p.form == "list"
                            else s_lo + np.arange(span))
                    ring[0, live, slot, :span] = raw[live_at, row][:, cols]
                    copies["fz"][live] += 1
                    if wz is not None and flagged.any():
                        ring[1, flagged, slot, :span] = \
                            wz[flagged_at, row][:, cols]
                        copies["wz"][flagged] += 1
                    tag[slot] = row

            for s in range(p.depth):
                issue(s)
            for s in range(t["steps"]):
                issue(s + p.depth)
                for i in range(tile * p.tile_rows + s * kres.STEP_ROWS,
                               min(tile * p.tile_rows + (s + 1)
                                   * kres.STEP_ROWS,
                                   (tile + 1) * p.tile_rows, ny_out)):
                    ra, rb = t["rows"][i, 0] & 0xffff, t["rows"][i, 0] >> 16
                    assert (tag[ra], tag[rb]) == (ya[i], yb[i])
                    fy = t["rows"][i, 1:2].view(f32)[0]
                    gy = f32(1) - fy
                    A, B = ring[0][:, ra], ring[0][:, rb]
                    za, zb = A[:, pa], A[:, pb]
                    zc, zd = B[:, pa], B[:, pb]
                    if wz is None:
                        nz = np.nan_to_num
                        ta = gy * nz(za) + fy * nz(zc)
                        tb = gy * nz(zb) + fy * nz(zd)
                        na = gy * np.isnan(za).astype(f32) \
                            + fy * np.isnan(zc).astype(f32)
                        nb = gy * np.isnan(zb).astype(f32) \
                            + fy * np.isnan(zd).astype(f32)
                        poison = gx * na + fx * nb > f32(kres.POISON)
                    else:
                        ta, tb = gy * za + fy * zc, gy * zb + fy * zd
                        poison = np.zeros((nchan, p.width), bool)
                        if flagged.any():           # the second plane
                            WA, WB = ring[1][:, ra], ring[1][:, rb]
                            wn = gx * (gy * WA[:, pa] + fy * WB[:, pa]) \
                                + fx * (gy * WA[:, pb] + fy * WB[:, pb])
                            poison = flagged[:, None] \
                                & (wn > f32(kres.POISON))
                    jj = np.minimum(j, nx_out - 1)
                    bit = (t["valid"][i, jj >> 5] >> (jj & 31)) & 1
                    v = np.where((bit == 1) & ~poison, gx * ta + fx * tb,
                                 f32(np.nan))
                    out[:, i, j[inr]] = v[:, inr]
    out[~live] = np.nan
    return out, copies


def _raw_case(case):
    """(data, y0, wy, x0, wx, valid, zvalid, aligned) of one layout."""
    rng = np.random.RandomState(17)
    zvalid = None
    aligned = True
    if case == "translation":
        shape, out = (3, 64, 300), (64, 300)
        y0, wy = _axis_taps(64, 64, 1.0, -0.61)
        x0, wx = _axis_taps(300, 300, 1.0, 0.37)
    elif case == "flip":
        shape, out = (3, 70, 132), (70, 132)
        y0, wy = _axis_taps(70, 70, -1.0, 69.3)
        x0, wx = _axis_taps(132, 132, 1.0, -1.6)
    elif case == "repeat":
        # clipped rows: the edges repeat one input row; equal y0 runs
        shape, out = (3, 40, 67), (50, 70)
        y0, wy = _axis_taps(50, 40, 0.5, -4.0)
        x0, wx = _axis_taps(70, 67, 1.0, 2.0)
    elif case == "unaligned":
        # nx_out % 4 != 0, an input pitch that is not 16-byte aligned
        shape, out = (3, 37, 131), (41, 129)
        y0, wy = _axis_taps(41, 37, 0.93, 3.2)
        x0, wx = _axis_taps(129, 131, 1.07, -2.6)
        aligned = False
    elif case == "narrowed":
        # a threefold downsampling: 128 columns' spans overflow the ring
        shape, out = (2, 195, 400), (64, 130)
        y0, wy = _axis_taps(64, 195, 3.0, 0.5)
        x0, wx = _axis_taps(130, 400, 3.0, 0.5)
    elif case == "listed":
        # columns far apart in random order: no span fits, listed columns
        shape, out = (2, 33, 3000), (20, 150)
        y0, wy = _axis_taps(20, 33, 1.6, 0.2)
        x0 = rng.permutation(2999)[:150]
        wx = rng.rand(150).astype(np.float32)
    elif case == "many_strips":
        shape, out = (2, 300, 700), (300, 700)
        y0, wy = _axis_taps(300, 300, 1.0, 0.25)
        x0, wx = _axis_taps(700, 700, 1.0, -0.5)
    else:                                   # every channel invalid
        shape, out = (2, 20, 40), (20, 40)
        y0, wy = _axis_taps(20, 20, 1.0, 0.5)
        x0, wx = _axis_taps(40, 40, 1.0, 0.5)
        zvalid = np.zeros(2, bool)
    data = _small_data(shape, 5)
    valid = rng.rand(*out) > 0.1
    if zvalid is None:
        zvalid = np.ones(shape[0], bool)
        zvalid[shape[0] // 2] = shape[0] < 3
    return data, y0, wy, x0, wx, valid, zvalid, aligned


_RAW_CASES = ("translation", "flip", "repeat", "unaligned", "narrowed",
              "listed", "many_strips", "none_valid")


@pytest.mark.parametrize("case", _RAW_CASES)
def test_raw_kernel_layout_reproduces_the_plain_resample(case):
    """The raw kernel's packed taps hold the wrapper's arrays (y and x
    weights, validity, channel flags), and the kernel's walk over them
    (emulated on the CPU with its copies landing as early as the card
    may land them) equals resample2_plain bit for bit."""
    data, y0, wy, x0, wx, valid, zvalid, aligned = _raw_case(case)
    packed = kres.pack_taps(data.shape, y0, wy, x0, wx, valid, zvalid,
                            aligned)
    t = _unpack(packed, data.shape, *valid.shape)
    np.testing.assert_array_equal(t["rows"][:, 1].view(np.float32), wy)
    np.testing.assert_array_equal(
        t["cols"][:len(wx), 1].view(np.float32), wx)
    bits = (t["valid"][:, np.arange(valid.shape[1]) >> 5]
            >> (np.arange(valid.shape[1]) & 31)) & 1
    np.testing.assert_array_equal(bits == 1, valid)
    np.testing.assert_array_equal(t["zvalid"] != 0, zvalid)
    got, copies = _emulate_kernel(data, y0, packed, *valid.shape)
    np.testing.assert_array_equal(copies["fz"] == 0, ~zvalid)
    assert not copies["wz"].any()
    want = kres.resample2_plain(torch.as_tensor(data), y0, wy, x0, wx, valid,
                                zvalid).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


def _filled_case(case):
    """(fz, wz, wz_any, y0, wy, x0, wx, valid, zvalid, aligned, channels,
    nplan) of one filled layout: the data's channels are the plan's
    ``channels`` of ``nplan``; channel 1 of the data is unflagged with a
    weight plane of ones (never read), the others hold fractional NaN
    weights."""
    rng = np.random.RandomState(23)
    if case.startswith("path") or case in ("scaled", "flip"):
        # the path's 311 channels on 768^2, onto the shifted grid, a 1.07x
        # scaled 700^2 grid or a flip; data for three of the channels:
        # flagged, unflagged and zvalid 0
        nplan, ny_in, nx_in = 311, 768, 768
        n_out, a, b = {"scaled": (700, 1.07, 9.0),
                       "flip": (768, -1.0, 767.3)}.get(case,
                                                       (768, 1.0, -0.61))
        y0, wy = _axis_taps(n_out, ny_in, a, b)
        x0, wx = _axis_taps(n_out, nx_in, abs(a), 0.37)
        channels = np.array([0, 5, 9])
        flags = np.ones(nplan, bool)
        flags[5] = False
        if case == "path_unflagged":
            flags[:] = False
        zvalid = np.ones(nplan, bool)
        zvalid[9] = False
        valid = rng.rand(n_out, n_out) > 0.1
        aligned = True
    else:
        data, y0, wy, x0, wx, valid, zvalid, aligned = _raw_case(case)
        nplan, ny_in, nx_in = data.shape
        channels = np.arange(nplan)
        flags = np.ones(nplan, bool)
        flags[1] = False
    fz = rng.randn(len(channels), ny_in, nx_in).astype(np.float32)
    wz = np.zeros_like(fz)
    for c in range(len(channels)):
        if flags[channels[c]]:
            hit = rng.rand(ny_in, nx_in) < 0.01
            wz[c][hit] = rng.choice([0.25, 0.5, 1.0, 1e-7], hit.sum())
        else:
            wz[c] = 1.0
    return (fz, wz, flags, y0, wy, x0, wx, valid, zvalid, aligned, channels,
            nplan)


@pytest.mark.parametrize("case", ["path", "path_unflagged", "scaled", "flip",
                                  "unaligned", "listed"])
def test_filled_kernel_layout_reproduces_the_plain_resample(case):
    """The filled entry's packed taps (flags included) and the kernel's
    walk over them, emulated on the CPU with copies landing as early as
    the card may land them, on the path's shape (311 x 768 x 768 onto the
    shifted grid, flagged or not), a scaled grid, a flip, an unaligned
    plane and listed columns: an unflagged channel copies no wz row, a
    zvalid-0 channel copies nothing, a flagged one copies each staged row
    of both planes once, and the output equals resample2_filled_plain bit
    for bit."""
    (fz, wz, flags, y0, wy, x0, wx, valid, zvalid, aligned, channels,
     nplan) = _filled_case(case)
    shape = (nplan,) + fz.shape[1:]
    packed = kres.pack_taps(shape, y0, wy, x0, wx, valid, zvalid, aligned,
                            flags)
    p = packed.plan
    assert p.planes == (2 if flags.any() else 1)
    t = _unpack(packed, shape, *valid.shape)
    if flags.any():
        np.testing.assert_array_equal(t["wflags"] != 0, flags)
    if case.startswith("path"):
        # two planes of a translation's 49 slots fit two blocks an SM
        assert (p.width, p.form, p.store16, p.slots) == (128, "span16",
                                                          True, 49)
        assert p.smem <= kres.SMEM_SPAN
    got, copies = _emulate_kernel(fz, y0, packed, *valid.shape, wz=wz,
                                  channels=channels, nplan=nplan)
    live = zvalid[channels]
    flagged = live & flags[channels]
    np.testing.assert_array_equal(copies["fz"] == 0, ~live)
    np.testing.assert_array_equal(copies["wz"] == 0, ~flagged)
    np.testing.assert_array_equal(copies["wz"][flagged],
                                  copies["fz"][flagged])
    want = kres.resample2_filled_plain(
        torch.as_tensor(fz), torch.as_tensor(wz),
        torch.as_tensor(flags[channels]), y0, wy, x0, wx, valid,
        zvalid[channels]).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    # the weights poison the first channel only where it is flagged
    assert (np.isnan(want[0]).mean() > (~valid).mean()) == flags.any()


@pytest.mark.parametrize("case,width,form,store16", [
    ("path", 128, "span16", True), ("scaled", 128, "span16", True),
    ("flip", 128, "span16", True), ("unaligned", 128, "span4", False),
    ("narrowed", 64, "span16", False), ("listed", 128, "list", False)])
def test_raw_kernel_plan(case, width, form, store16):
    """The plan on the path's shapes (623 x 768 x 768 onto a shifted or a
    1.07x scaled 700^2 grid), a flip, an unaligned plane, a downsampling
    that narrows the strip and columns that only a list stages: every
    input row of a monotone walk is copied once per tile, the ring holds
    the rows of DEPTH + 1 steps, and a block fits its shared memory."""
    if case in ("path", "scaled", "flip"):
        nchan, ny_in, nx_in = 623, 768, 768
        n_out, a, b = {"path": (768, 1.0, -0.61), "scaled": (700, 1.07, 9.0),
                       "flip": (768, -1.0, 767.3)}[case]
        y0, _ = _axis_taps(n_out, ny_in, a, b)
        x0, _ = _axis_taps(n_out, nx_in, abs(a), 0.37)
        aligned = True
    else:
        _, y0, _, x0, _, _, zv, aligned = _raw_case(case)
        nchan = zv.size
        ny_in, nx_in = {"unaligned": (37, 131), "narrowed": (195, 400),
                        "listed": (33, 3000)}[case]
    p = kres.plan(y0, x0, ny_in, nx_in, nchan, aligned)
    assert (p.width, p.form, p.store16) == (width, form, store16)
    assert p.smem <= kres.SMEM_MAX and p.pitch % 4 == 0
    if form != "list":
        assert p.smem <= kres.SMEM_SPAN
    if case in ("path", "scaled", "flip"):
        assert (p.tiles, p.depth) == (1, kres.DEPTH)
        # a translation's ring: 3 steps of 16 rows and the row below
        assert p.slots == (49 if case != "scaled" else 53)
        packed = kres.pack_taps((nchan, ny_in, nx_in), y0,
                                np.zeros(y0.size, np.float32), x0,
                                np.zeros(x0.size, np.float32),
                                np.ones((y0.size, x0.size), bool),
                                np.ones(nchan, bool))
        t = _unpack(packed, (nchan, ny_in, nx_in), y0.size, x0.size)
        rows = np.unique(np.concatenate([y0, np.minimum(y0 + 1,
                                                         ny_in - 1)]))
        assert t["loads"].shape[0] == rows.size


# -- the spline orders 2 and 3 -----------------------------------------------

def _scipy_spline_oracle(data, zs, ys, xs, order):
    """scipy's 3-D map_coordinates (test_regrid.py:936-946)."""
    import scipy.ndimage as ndi
    nz, ny, nx = len(zs), *ys.shape
    zz = np.broadcast_to(np.asarray(zs)[:, None, None], (nz, ny, nx))
    yy = np.broadcast_to(ys[None], (nz, ny, nx))
    xx = np.broadcast_to(xs[None], (nz, ny, nx))
    return ndi.map_coordinates(data.astype(np.float64), [zz, yy, xx],
                               order=order, mode="constant", cval=np.nan)


def _spline_both(data, zs, ys, xs, order):
    """The port's and the JAX package's spline resample of ``data``: equal
    NaN patterns, values within atol 5e-6.  Returns the port's."""
    got = tregrid._bilinear_spatial_then_linear_z(
        torch.as_tensor(data), zs, ys, xs, order).numpy()
    ref = np.asarray(jregrid._bilinear_spatial_then_linear_z(
        jnp.asarray(data), zs, ys, xs, order))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=5e-6)
    return got


def _rotation(n, th=0.15):
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    c = (n - 1) / 2.0
    return (c + np.cos(th) * (yy - c) + np.sin(th) * (xx - c),
            c - np.sin(th) * (yy - c) + np.cos(th) * (xx - c))


def _spline_case(case):
    """(data, zs, ys, xs, rtol, atol) of test_regrid.py's spline tests:
    an offset (separable), a rotation (prefilter + taps), a new spectral
    axis and a rescaled grid, with those tests' tolerances."""
    if case == "offset":
        data = np.random.RandomState(11).rand(6, 24, 28).astype(np.float32)
        ys, xs = _maps(24, 28, 1.0, 0.37, 1.0, 0.61)
        return data, np.arange(6, dtype=np.float64), ys, xs, 2e-5, 2e-6
    if case == "rotated":
        data = np.random.RandomState(12).rand(3, 32, 32).astype(np.float32)
        ys, xs = _rotation(32)
        return data, np.arange(3, dtype=np.float64), ys, xs, 5e-5, 5e-6
    if case == "spectral":
        data = np.random.RandomState(13).rand(16, 12, 12).astype(np.float32)
        ys, xs = _maps(12, 12, 1.0, 0.25, 1.0, 0.75)
        return data, np.linspace(0.2, 14.7, 9), ys, xs, 5e-5, 5e-6
    data = np.random.RandomState(14).rand(4, 40, 36).astype(np.float32)
    ys, xs = _maps(40, 36, 0.8, 1.3, 1.1, 0.2)
    return data, np.arange(4, dtype=np.float64), ys, xs, 5e-5, 5e-6


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("case", ["offset", "rotated", "spectral", "scaled"])
def test_spline_matches_jax_and_scipy(case, order):
    data, zs, ys, xs, rtol, atol = _spline_case(case)
    got = _spline_both(data, zs, ys, xs, order)
    exp = _scipy_spline_oracle(data, zs, ys, xs, order)
    assert np.array_equal(np.isnan(got), np.isnan(exp))
    fin = np.isfinite(exp)
    np.testing.assert_allclose(got[fin], exp[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("rotated", [False, True])
def test_spline_nan_poisoning_is_local(order, rotated):
    """test_regrid.py:1032-1056's input: poisoning is the |T|-weighted NaN
    mass above 1e-6, local to the taps (scipy's prefilter would smear the
    NaN along the whole line); the NaN-free plane and the far corner
    match the filled-data oracle.  Also on a rotated grid and with a NaN
    reaching a new spectral axis."""
    data = np.random.RandomState(15).rand(2, 48, 48).astype(np.float32)
    data[1, 24, 24] = np.nan
    zs = np.arange(2, dtype=np.float64)
    ys, xs = _rotation(48, 0.1) if rotated else \
        _maps(48, 48, 1.0, 0.4, 1.0, 0.6)
    got = _spline_both(data, zs, ys, xs, order)
    if not rotated:
        assert np.isnan(got[1, 22:25, 22:25]).all()
    filled = np.where(np.isfinite(data), data, 0.0)
    exp = _scipy_spline_oracle(filled, zs, ys, xs, order)
    fin = np.isfinite(exp[0])
    np.testing.assert_allclose(got[0][fin], exp[0][fin], rtol=5e-5,
                               atol=5e-6)
    np.testing.assert_allclose(got[1, :6, 6:12], exp[1, :6, 6:12],
                               rtol=5e-5, atol=5e-6)
    deep = np.random.RandomState(16).rand(12, 10, 10).astype(np.float32)
    deep[5, 4, 4] = np.nan
    _spline_both(deep, np.linspace(0.5, 10.5, 6), *_maps(10, 10, 1.0, 0.3,
                                                         1.0, 0.1), order)


@pytest.mark.parametrize("order,n", [(3, 3), (2, 2), (3, 2), (2, 3)])
def test_spline_tiny_planes_pad_by_edge(order, n):
    """A plane no larger than ``order`` pads its coefficients by edge
    (regrid.py:117-119), one larger by reflection."""
    data = np.random.RandomState(n + order).rand(2, n, n).astype(np.float32)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    got = _spline_both(data, np.arange(2, dtype=np.float64),
                       yy * 0.9 + 0.05 * xx, xx * 0.9 + 0.1, order)
    assert np.isfinite(got).all()


def test_spline_spectral_operator_runs_banded_matmul(monkeypatch):
    """The spectral operator and its absolute value go through kernel 7's
    wrapper (its plain version on the CPU), on the contiguous float32
    (nchan, ny * nx) view; an untouched spectral axis does not."""
    from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
    calls = []
    real = kbm.banded_matmul

    def counting(flat, bands):
        calls.append((tuple(flat.shape), flat.dtype, flat.is_contiguous(),
                      bands.nin))
        return real(flat, bands)

    monkeypatch.setattr(kbm, "banded_matmul", counting)
    declined = tregrid._spectral_product.declined
    data, zs, ys, xs, _, _ = _spline_case("spectral")
    data[3, 4, 5] = np.nan
    _spline_both(data, zs, ys, xs, 3)
    assert calls == [((16, 144), torch.float32, True, 16)] * 2
    assert tregrid._spectral_product.last == "banded_matmul"
    assert tregrid._spectral_product.declined == declined
    calls.clear()
    data, zs, ys, xs, _, _ = _spline_case("offset")
    _spline_both(data, zs, ys, xs, 2)
    assert calls == []


def test_spline_operator_too_wide_for_the_plan_takes_matmul():
    """An operator whose spans no banded_matmul plan fits takes
    torch.matmul in IEEE float32, decided on the host and counted."""
    from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
    rng = np.random.RandomState(5)
    M = rng.rand(8, 1200).astype(np.float32)
    assert not kbm.fits(kbm.row_bands(M))
    with pytest.raises(ValueError, match="too wide"):
        kbm.plan(kbm.row_bands(M))
    cube = torch.as_tensor(rng.rand(1200, 3, 4).astype(np.float32))
    declined = tregrid._spectral_product.declined
    got = tregrid._spectral_product(M, cube)
    assert tregrid._spectral_product.last == "matmul"
    assert tregrid._spectral_product.declined == declined + 1
    want = (M.astype(np.float64) @ cube.numpy().reshape(1200, -1)
            .astype(np.float64)).reshape(8, 3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    band = np.eye(8, 24, dtype=np.float32) + np.eye(8, 24, 1,
                                                    dtype=np.float32)
    assert kbm.fits(kbm.row_bands(band))
    tregrid._spectral_product(band, torch.ones((24, 2, 2)))
    assert tregrid._spectral_product.last == "banded_matmul"


def test_spline_host_operators_are_cached():
    coords = np.linspace(0.3, 9.1, 5)
    a = tregrid._spline_1d_matrix(12, coords, 3)
    assert tregrid._spline_1d_matrix(12, coords.copy(), 3) is a
    assert tregrid._spline_1d_matrix(12, coords, 2) is not a
    np.testing.assert_array_equal(a, jregrid._spline_1d_matrix(12, coords,
                                                               3))


@pytest.mark.parametrize("order", ["biquadratic", "bicubic"])
def test_spline_reproject_entry_points_match_jax(tmp_path, order):
    """``cube.reproject`` onto a new spectral axis and a rotated grid,
    ``Projection.reproject`` and ``reproject_image``, through both
    packages."""
    path = tmp_path / "s.fits"
    h = _spectral_cube_file(path, nchan=12, ny=30, nx=32)
    tcube = T.SpectralCube.read(str(path), device="cpu")
    jcube = J.SpectralCube.read(str(path))
    for target in (_target(h, 5, 2.0, 0.25), _rotated_header(h, 3.0)):
        tr = tcube.reproject(target, order=order)
        jr = jcube.reproject(target, order=order)
        got, ref = tr._data.numpy(), np.asarray(jr._data)
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        fin = ~np.isnan(ref)
        assert fin.mean() > 0.3
        np.testing.assert_allclose(got[fin], ref[fin], atol=5e-6)
        np.testing.assert_array_equal(tr.get_mask_array(),
                                      np.asarray(jr.get_mask_array()))
    tp = tcube[2].reproject(_target(h, 12, 1.0, 0.0), order=order,
                            device="cpu")
    jp = jcube[2].reproject(_target(h, 12, 1.0, 0.0), order=order)
    assert type(tp).__name__ == type(jp).__name__ == "Projection"
    assert np.array_equal(np.isnan(tp.value), np.isnan(jp.value))
    fin = ~np.isnan(jp.value)
    np.testing.assert_allclose(tp.value[fin], jp.value[fin], atol=5e-6)
    img = np.random.RandomState(2).randn(30, 32).astype(np.float32)
    got, _ = tregrid.reproject_image(img, T.WCS(header=h),
                                     _rotated_header(h, 3.0), order=order,
                                     device="cpu")
    ref, _ = jregrid.reproject_image(img, J.WCS(header=h),
                                     _rotated_header(h, 3.0), order=order)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(ref)[fin],
                               atol=5e-6)
