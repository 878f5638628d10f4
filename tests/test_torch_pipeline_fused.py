"""Torch port, the whole-pipeline fusion (``ops/pipeline_fused.py``,
kernel 6 in its pipeline mode) against the JAX package.

The same numpy inputs go through the JAX ``moments_conv_reproject_fused``
(its Pallas kernel in interpret mode) and through the port on CPU tensors,
where the kernel's wrapper runs its plain PyTorch version (kernel 1's plain
planes beside the plain fused operator).  Tolerances are the JAX file's
own (tests/test_pipeline_fused.py:122-205): 1e-6 relative against a
float64 oracle; between the two float32 implementations rtol 2e-6 / 3e-6
on the moments and 3e-6 on the statistics (they accumulate in chunks of
32 and of 4 channels); atol 2e-5 on the cube after an exact NaN pattern.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.masks import LazyComparisonMask as JLazyComparison
from spectral_cube_tpu.ops.pipeline_fused import (
    moments_conv_reproject_fused as j_fused)

from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch import masks as tmasks
from spectral_cube_tpu_torch.ops import moments as tmom
from spectral_cube_tpu_torch.ops import regrid as trg
from spectral_cube_tpu_torch.ops.pipeline_fused import (
    moments_conv_reproject_fused as t_fused)


def _oracle_moments(data, coords, dx, thresh):
    """The reference cubewise algorithm in float64."""
    d = data.astype(np.float64)
    valid = np.isfinite(d) & (d > thresh)
    w = np.where(valid, d, 0.0)
    x = coords.astype(np.float64)[:, None, None]
    s0 = w.sum(axis=0)
    cnt = valid.sum(axis=0)
    with np.errstate(all="ignore"):
        m1 = (w * x).sum(axis=0) / s0
        m2 = (w * (x - m1[None]) ** 2).sum(axis=0) / s0
        m0 = np.where(cnt > 0, s0 * dx, np.nan)
        m1 = np.where(cnt > 0, m1, np.nan)
        m2 = np.where(cnt > 0, m2, np.nan)
    return m0, m1, m2, valid


def _mk(nchan=32, ny=128, nx=128, seed=0, line_at=None, width=4.0,
        nan_channels=(), nan_spaxel=False):
    """The JAX file's synthesis: a line on noise, NaN runs in some
    channels, optionally an all-NaN spaxel; a (0.37, 0.61) shift."""
    rng = np.random.RandomState(seed)
    v = np.arange(nchan, dtype=np.float64)
    c0 = nchan / 2.0 if line_at is None else float(line_at)
    line = np.exp(-0.5 * ((v - c0) / width) ** 2).astype(np.float32)
    data = (line[:, None, None] * (0.5 + rng.rand(1, ny, nx))
            + 0.05 * rng.randn(nchan, ny, nx)).astype(np.float32)
    for c in nan_channels:
        data[c, ny // 2, : nx // 4] = np.nan
    if nan_spaxel:
        data[:, 1, 5] = np.nan
    ys = np.broadcast_to(np.arange(ny, dtype=np.float64)[:, None] + 0.37,
                         (ny, nx)).copy()
    xs = np.broadcast_to(np.arange(nx, dtype=np.float64)[None, :] + 0.61,
                         (ny, nx)).copy()
    x1 = np.arange(9) - 4
    k = np.exp(-0.5 * np.add.outer(x1 ** 2, x1 ** 2) / 2.0)
    return data, v, ys, xs, k


def _both(data, coords, ys, xs, k, thresh=0.25):
    jmask = JLazyComparison(jnp.greater, thresh, shape=data.shape)
    ref = j_fused(jnp.asarray(data), k, ys, xs, coords, 1.0,
                  mask_expr=jmask, interpret=True)
    tmask = tmasks.LazyComparisonMask(torch.gt, thresh, shape=data.shape)
    got = t_fused(torch.as_tensor(data), k, ys, xs, coords, 1.0,
                  mask_expr=tmask)
    assert ref is not None and got is not None
    return got, ref


def _rel_to_oracle(got, exp):
    ok = np.isfinite(exp)
    scale = np.nanmax(np.abs(exp))
    return (np.abs(np.asarray(got) - exp)[ok]
            / np.maximum(np.abs(exp)[ok], 1e-3 * scale)).max()


@pytest.mark.parametrize("case", ["clean", "nan", "nan_spaxel"])
def test_fused_matches_jax_and_float64_oracle(case):
    nan_channels = (3, 7) if case != "clean" else ()
    data, coords, ys, xs, k = _mk(nan_channels=nan_channels,
                                  nan_spaxel=(case == "nan_spaxel"))
    (out, m0, m1, m2, stats), (jout, jm0, jm1, jm2, jstats) = _both(
        data, coords, ys, xs, k)
    e0, e1, e2, valid = _oracle_moments(data, coords, 1.0, 0.25)
    for got, exp in ((m0, e0), (m1, e1), (m2, e2)):
        got = got.numpy()
        assert np.array_equal(np.isnan(got), np.isnan(exp))
        assert _rel_to_oracle(got, exp) < 1e-6
    for got, want, rtol, atol in ((m0, jm0, 2e-6, 1e-7),
                                  (m1, jm1, 2e-6, 2e-5),
                                  (m2, jm2, 3e-6, 2e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=atol)
    vals = data.astype(np.float64)[valid]
    assert np.isclose(float(stats["mean"]), vals.mean(), rtol=1e-6)
    assert np.isclose(float(stats["sigma"]), vals.std(ddof=1), rtol=1e-6)
    assert int(stats["npts"]) == vals.size
    for key in ("mean", "sigma", "min", "max", "sum", "npts"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]),
                                   rtol=3e-6)
    out, jout = out.numpy(), np.asarray(jout)
    assert np.array_equal(np.isnan(out), np.isnan(jout))
    fin = ~np.isnan(jout)
    np.testing.assert_allclose(out[fin], jout[fin], atol=2e-5)


def test_fused_mom2_narrow_line_far_from_center():
    """A 1.2-channel-wide line at channel 5 of 96: the pair accumulation
    and pair finalization keep mom1 and mom2 at 1e-6 of float64, and agree
    with the JAX kernel."""
    data, coords, ys, xs, k = _mk(nchan=96, line_at=5.0, width=1.2, seed=7)
    (_, m0, m1, m2, _), (_, jm0, jm1, jm2, _) = _both(data, coords, ys, xs,
                                                       k, thresh=0.3)
    _, e1, e2, _ = _oracle_moments(data, coords, 1.0, 0.3)
    assert _rel_to_oracle(m2.numpy(), e2) < 1e-6
    ok = np.isfinite(e1)
    assert (np.abs(m1.numpy() - e1)[ok] / np.abs(e1)[ok]).max() < 1e-6
    np.testing.assert_allclose(m1.numpy(), np.asarray(jm1), rtol=2e-6,
                               atol=2e-5)
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm2), rtol=3e-6,
                               atol=2e-5)


def test_fused_equals_the_two_kernel_chain():
    """The fused op returns the moments of ``moments_012_kernel(...,
    with_stats=True)`` and the cube of ``convolve_reproject_separable``,
    bitwise (the same plain functions on the CPU)."""
    data, coords, ys, xs, k = _mk(nchan=40, ny=48, nx=64,
                                  nan_channels=(4, 33), nan_spaxel=True)
    x = torch.as_tensor(data)
    mask = tmasks.LazyComparisonMask(torch.gt, 0.25, shape=data.shape)
    out, m0, m1, m2, stats = t_fused(x, k, ys, xs, coords, 1.0,
                                     mask_expr=mask)
    cm0, cm1, cm2, cstats = tmom.moments_012_kernel(
        x, coords, 1.0, mask_expr=mask, with_stats=True)
    for a, b in ((m0, cm0), (m1, cm1), (m2, cm2)):
        assert torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0))
    for key in stats:
        assert torch.equal(torch.as_tensor(stats[key]),
                           torch.as_tensor(cstats[key])), key
    cout = trg.convolve_reproject_separable(x, k, ys, xs)
    assert torch.equal(torch.nan_to_num(out, 7.0), torch.nan_to_num(cout, 7.0))


def test_non_fusable_data_local_mask_takes_the_include_array():
    """A data-local mask the kernel cannot evaluate itself (two
    comparisons) is evaluated into an include array, as kernel 1 takes
    it."""
    data, coords, ys, xs, k = _mk(nchan=24, ny=32, nx=40, nan_channels=(5,))
    x = torch.as_tensor(data)
    mask = (tmasks.LazyComparisonMask(torch.gt, 0.25, shape=data.shape)
            & tmasks.LazyComparisonMask(torch.lt, 0.9, shape=data.shape))
    assert tmasks.fused_predicate(mask) is None
    assert tmasks.is_data_local(mask)
    _, m0, m1, m2, stats = t_fused(x, k, ys, xs, coords, 1.0, mask_expr=mask)
    inc = (data > 0.25) & (data < 0.9)
    e0, e1, e2 = (torch.as_tensor(a) for a in tmom.moments_012(
        x, coords, 1.0, include=torch.as_tensor(inc)))
    for got, exp, rtol in ((m0, e0, 2e-6), (m1, e1, 2e-6), (m2, e2, 2e-5)):
        assert torch.equal(torch.isnan(got), torch.isnan(exp))
        torch.testing.assert_close(got, exp, rtol=rtol, atol=1e-6,
                                   equal_nan=True)
    assert int(stats["npts"]) == int((np.isfinite(data) & inc).sum())


def test_fused_gates_return_none():
    data, coords, ys, xs, k = _mk(nchan=8, ny=16, nx=24)
    x = torch.as_tensor(data)
    ys2 = ys + np.linspace(0, 0.5, ys.shape[1])[None, :]
    assert t_fused(x, k, ys2, xs, coords, 1.0) is None
    arr = tmasks.BooleanArrayMask(torch.ones(data.shape, dtype=torch.bool),
                                  shape=data.shape)
    assert t_fused(x, k, ys, xs, coords, 1.0, mask_expr=arr) is None
    assert t_fused(x, np.random.RandomState(0).rand(15, 15), ys, xs, coords,
                   1.0) is None


def test_fused_all_masked_spaxel_nan_moments():
    data, coords, ys, xs, k = _mk(nchan=8, ny=16, nx=24)
    data[:, 0, 0] = -1.0
    mask = tmasks.LazyComparisonMask(torch.gt, 0.25, shape=data.shape)
    K.reset_launch_counts()
    _, m0, m1, m2, _ = t_fused(torch.as_tensor(data), k, ys, xs, coords,
                               1.0, mask_expr=mask)
    assert all(np.isnan(float(m[0, 0])) for m in (m0, m1, m2))
    assert all(n == 0 for n in K.launch_counts().values())
