"""Torch port: rotated spline reprojection and the fused convolve +
reproject kernels (#8-#10) as they run on a cube past 2**31 voxels.

The spline path onto a rotated grid with the cube's own spectral axis (the
untouched-axis branch of ``ops/regrid._spline_spatial_then_z``) runs a
slab of output channels at a time (``ops/regrid.SLAB_VOXELS``); here the
constant is set small by ``monkeypatch`` so that a cube of a few thousand
voxels takes many slabs, and each result is held bit for bit against the
one call and against the JAX package's function on the same FITS file at
``tests/test_torch_regrid.py``'s atol 5e-6, NaN patterns equal.  The
whole-pipeline fusion (``ops/pipeline_fused``) runs on a spectrum of more
than 1024 channels, the chunked case of the card-scale cube's 2304
channels, against the JAX package's Pallas kernel in interpret mode and a
float64 oracle at ``tests/test_torch_pipeline_fused.py``'s tolerances; and
the fused kernels' plans take the card-scale cube's planes.
"""

import numpy as np
import pytest
import torch

from spectral_cube_tpu_torch.kernels import conv_reproject as kcr
from spectral_cube_tpu_torch.ops import regrid as tregrid

from test_torch_card_scale_reductions import same_bits
from test_torch_card_scale_vrsc import _cube_sized, _read_both
from test_torch_pipeline_fused import _both, _mk, _oracle_moments, \
    _rel_to_oracle
from test_torch_regrid import _rotated_header, _spectral_cube_file

#: the card-scale cube P (chip_smoke.CARD_P)
CARD_P = (2304, 1024, 1024)


def _rotated_case(tmp_path):
    """Both packages' read of a 12 x 30 x 32 cube with NaN voxels, a NaN
    spectrum and NaN-holding channels, and the header of its grid rotated
    by 3 deg with its own spectral axis."""
    path = tmp_path / "r.fits"
    h = _spectral_cube_file(path, nchan=12, ny=30, nx=32)
    tc, jc = _read_both(str(path))
    return tc, jc, _rotated_header(h, 3.0)


@pytest.mark.parametrize("order", ["biquadratic", "bicubic"])
@pytest.mark.parametrize("slab", [1, 5])
def test_rotated_spline_on_its_own_axis_in_slabs_is_the_one_call(
        monkeypatch, tmp_path, order, slab):
    """The rotated spline path with the cube's own spectral axis in slabs
    of ``slab`` output channels: bit for bit the one slab, and against the
    JAX package at atol 5e-6, NaN patterns equal."""
    tc, jc, target = _rotated_case(tmp_path)
    zs, ys, xs, _ = tregrid.reproject_mappings(
        tc.wcs, target, 12,
        spectral_values_in=np.asarray(tc.spectral_axis.value))
    m = tregrid.spline_host_maps(zs, ys, xs, *tc.shape)
    assert m.z_identity and not m.separable
    one = tc.reproject(target, order=order)
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", slab * 30 * 32)
    got = tc.reproject(target, order=order)
    assert same_bits(got._data, one._data)
    ref = np.asarray(jc.reproject(target, order=order)._data)
    g = got._data.numpy()
    assert np.array_equal(np.isnan(g), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert fin.mean() > 0.3
    np.testing.assert_allclose(g[fin], ref[fin], atol=5e-6)


@pytest.mark.parametrize("grid", ["rotated", "shifted"])
def test_spline_path_on_its_own_axis_makes_the_output_alone(
        monkeypatch, tmp_path, grid):
    """On an untouched spectral axis each slab fills its own channels and
    forms their NaN mask, so the output is the spline path's one
    cube-sized allocation (it held whole-cube fz and wz beside it: R (a)
    rose 4.235 cube bytes at P, its peak 47.12 GiB)."""
    tc, _, target = _rotated_case(tmp_path)
    if grid == "shifted":
        target = target.__class__(target)
        target["PC1_2"] = target["PC2_1"] = 0.0
        target["PC1_1"] = target["PC2_2"] = 1.0
        target["CRPIX1"] += 0.37
    data = tc._get_filled_data(fill=np.nan)
    zs, ys, xs, _ = tregrid.reproject_mappings(
        tc.wcs, target, 12,
        spectral_values_in=np.asarray(tc.spectral_axis.value))
    m = tregrid.spline_host_maps(zs, ys, xs, *tc.shape)
    assert m.z_identity and m.separable == (grid == "shifted")
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", 2 * 30 * 32)
    assert _cube_sized(lambda: tregrid._spline_spatial_then_z(
        data, zs, ys, xs, 3), data.numel() * 4) == 1


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fused_plans_take_the_card_scale_planes(mode):
    """#8-#10's plans on P's 1024 x 1024 planes and the grid shifted by
    (0.37, -0.61) px with chip_smoke's 19 x 19 rank-5 kernel: each fits
    twice in an SM's shared memory, so ``convolve_reproject_separable``
    takes the fused route and ``moments_conv_reproject_fused`` does not
    decline (the shapes alone decide; nothing runs)."""
    import chip_smoke as cs
    kern, ys, xs, ops, _, _, _ = cs.card_c_operators(CARD_P)
    assert ops.rank == 5 and kern.shape == (19, 19)
    assert tregrid.fused_plan_fits(CARD_P, ops, mode)
    py, _ = kcr.plan(mode, CARD_P, ops.gy, ops.gx,
                     None if mode == 1 else (ops.my, ops.mx, ops.ry,
                                             ops.rx))
    assert py["smem"] <= kcr._TWO_BLOCKS


@pytest.mark.parametrize("case", ["clean", "nan"])
def test_fusion_on_a_chunked_spectrum_matches_jax_and_float64(case):
    """``moments_conv_reproject_fused`` on 1056 channels (past the 1024 at
    which the moments kernel takes its chunked form, as P's 2304 do) of a
    128 x 128 plane, NaN runs in two channels for ``nan``: the moments
    within 1e-6 of the float64 oracle, the statistics within 1e-6 of it
    and npts exact; against the JAX package's kernel in interpret mode at
    rtol 2e-6 / 3e-6 on the moments, 3e-6 on the statistics, atol 2e-5 on
    the cube after an exact NaN pattern; and the cube bit for bit
    ``convolve_reproject_separable``'s."""
    data, coords, ys, xs, k = _mk(nchan=1056, ny=128, nx=128, seed=11,
                                  nan_channels=(3, 1040) if case == "nan"
                                  else ())
    (out, m0, m1, m2, stats), (jout, jm0, jm1, jm2, jstats) = _both(
        data, coords, ys, xs, k)
    e0, e1, e2, valid = _oracle_moments(data, coords, 1.0, 0.25)
    for got, exp in ((m0, e0), (m1, e1), (m2, e2)):
        got = got.numpy()
        assert np.array_equal(np.isnan(got), np.isnan(exp))
        assert _rel_to_oracle(got, exp) < 1e-6
    vals = data.astype(np.float64)[valid]
    assert int(stats["npts"]) == vals.size
    assert np.isclose(float(stats["mean"]), vals.mean(), rtol=1e-6)
    assert np.isclose(float(stats["sigma"]), vals.std(ddof=1), rtol=1e-6)
    for got, want, rtol, atol in ((m0, jm0, 2e-6, 1e-7),
                                  (m1, jm1, 2e-6, 2e-5),
                                  (m2, jm2, 3e-6, 2e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=atol)
    for key in ("mean", "sigma", "min", "max", "sum", "npts"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]),
                                   rtol=3e-6)
    o, jo = out.numpy(), np.asarray(jout)
    assert np.array_equal(np.isnan(o), np.isnan(jo))
    fin = ~np.isnan(jo)
    np.testing.assert_allclose(o[fin], jo[fin], atol=2e-5)
    rep = tregrid.convolve_reproject_separable(torch.as_tensor(data), k, ys,
                                               xs)
    assert tregrid.convolve_reproject_separable.last["route"] == "fused"
    assert same_bits(out, rep)
