"""Torch port, kernel 3 (axis-aligned 2-tap resample from raw data)
against the JAX package.

The same numpy inputs go through the JAX functions (the Pallas
``per_channel_shift_lerp`` / ``per_channel_resample_raw_strips`` kernels
in interpret mode, and ``_bilinear_spatial_then_linear_z``, which takes
its gather path on the CPU) and through the port on CPU tensors, where the
kernel's wrapper runs its plain PyTorch version.  Tolerance: atol 5e-6 on
unit-variance data, the JAX raw-strips test's own
(test_banded_pallas.py:381), after an exact NaN pattern.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.ops import banded_pallas as jbp
from spectral_cube_tpu.ops import regrid as jregrid
from spectral_cube_tpu.ops.interpolate import _interp_matrix as j_interp

from spectral_cube_tpu_torch.kernels import resample2 as kres
from spectral_cube_tpu_torch.ops import regrid as tregrid
from spectral_cube_tpu_torch.ops.interpolate import _interp_matrix


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
    data = torch.zeros((3, 6, 6))
    ys, xs = _maps(6, 6, 1.0, 0.2, 1.0, 0.3)
    zs = np.arange(3, dtype=np.float64)
    with pytest.raises(NotImplementedError, match="item 9"):
        tregrid._bilinear_spatial_then_linear_z(data, zs, ys, xs, 0)
    with pytest.raises(NotImplementedError, match="spectral axis"):
        tregrid._bilinear_spatial_then_linear_z(data, zs * 0.5, ys, xs, 1)
    rot_y = ys + 0.1 * np.arange(6)[None, :]
    with pytest.raises(NotImplementedError, match="rotated"):
        tregrid._bilinear_spatial_then_linear_z(data, zs, rot_y, xs, 1)


def test_plain_version_leaves_the_counter_alone():
    kres.resample2.launches = 0
    data = _data((3, 16, 48), 2)
    ys, xs = _maps(16, 48, 1.0, 0.5, 1.0, 0.5)
    _both(data, ys, xs)
    assert kres.resample2.launches == 0
