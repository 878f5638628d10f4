"""Torch port, kernel 3 (axis-aligned 2-tap resample, from raw data and
from NaN-filled data with a NaN-weight plane) and reprojection onto a new
spectral axis, against the JAX package.

The same numpy inputs go through the JAX functions (the Pallas
``per_channel_shift_lerp`` / ``per_channel_resample_raw_strips`` /
``per_channel_resample_strips`` kernels in interpret mode, and
``_bilinear_spatial_then_linear_z``, which takes its gather path on the
CPU) and through the port on CPU tensors, where the kernel's wrappers run
their plain PyTorch versions.  Tolerance: atol 5e-6 on unit-variance data,
the JAX raw-strips test's own (test_banded_pallas.py:381), rtol 3e-5 /
atol 1e-5 for the filled resample (:284-312), after an exact NaN
pattern.
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
    """Order 0 and rotated targets still raise; a new spectral axis now
    runs, and agrees with the JAX package's staged path."""
    data = torch.zeros((3, 6, 6))
    ys, xs = _maps(6, 6, 1.0, 0.2, 1.0, 0.3)
    zs = np.arange(3, dtype=np.float64)
    with pytest.raises(NotImplementedError, match="item 9"):
        tregrid._bilinear_spatial_then_linear_z(data, zs, ys, xs, 0)
    got = tregrid._bilinear_spatial_then_linear_z(data, zs * 0.5, ys, xs, 1)
    ref = np.asarray(jregrid._bilinear_spatial_then_linear_z(
        jnp.asarray(data.numpy()), zs * 0.5, ys, xs, 1))
    assert got.shape == (3, 6, 6)
    np.testing.assert_array_equal(got.numpy(), ref)
    rot_y = ys + 0.1 * np.arange(6)[None, :]
    with pytest.raises(NotImplementedError, match="rotated"):
        tregrid._bilinear_spatial_then_linear_z(data, zs, rot_y, xs, 1)


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
