"""Torch port, kernel 1 (masked moments and statistics) against the JAX
package.

The same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode, or its jnp path) and through the port on CPU tensors,
where the kernel's wrapper runs its plain PyTorch version.  Tolerances are
the JAX tests' own: 2e-6 (mom0/mom1) and 2e-5 (mom2) against a float64
oracle (test_moments.py), 1e-6 between the two f32 implementations of the
same numerics, 2e-5 for statistics (test_moments.py:342), and the NaN
pattern exactly first.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.masks import LazyComparisonMask as JLazyComparison
from spectral_cube_tpu.ops import moments as jmom
from spectral_cube_tpu.ops import reductions as jred

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import masks as tmasks
from spectral_cube_tpu_torch.kernels import moments as kmom
from spectral_cube_tpu_torch.ops import moments as tmom
from spectral_cube_tpu_torch.ops import reductions as tred

from conftest import make_cube_file


def np_moments(d, x, dx, include=None):
    """float64 reference-semantics oracle (_moments.py:170-193)."""
    m = np.isfinite(d)
    if include is not None:
        m &= include
    w = np.where(m, d, 0.0).astype("f8") * dx
    cnt = m.sum(0)
    s0 = w.sum(0)
    x3 = x[:, None, None]
    with np.errstate(all="ignore"):
        mom0 = np.where(cnt > 0, s0, np.nan)
        mom1 = np.where(cnt > 0, (w * x3).sum(0) / s0, np.nan)
        mom2 = np.where(cnt > 0,
                        (w * (x3 - mom1[None]) ** 2).sum(0) / s0, np.nan)
    return mom0, mom1, mom2


def assert_moments(got, want, rtol0=2e-6, rtol2=2e-5, atol2=1e-7):
    """NaN pattern exact, then the relative errors (bench.py:725-734)."""
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert np.array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(np.asarray(got[0]), want[0], rtol=rtol0)
    np.testing.assert_allclose(np.asarray(got[1]), want[1], rtol=rtol0)
    np.testing.assert_allclose(np.asarray(got[2]), want[2], rtol=rtol2,
                               atol=atol2)


def _cube(shape, seed):
    rng = np.random.RandomState(seed)
    data = rng.rand(*shape).astype("f4")
    data[3, 4, 5] = np.nan
    data[:, 0, 0] = np.nan           # all-NaN spaxel
    return data


@pytest.mark.parametrize("mask_kind", ["none", "fused", "include"])
@pytest.mark.parametrize("shape", [(32, 16, 128), (40, 13, 21)])
def test_kernel_moments_match_pallas_and_oracle(mask_kind, shape):
    """Fused predicate, include array and no mask, on a full-tile plane
    and a ragged one, one chunk and two (40 channels)."""
    data = _cube(shape, 42)
    coords = np.arange(shape[0]) * 0.5
    dx = 0.5
    inc = data > 0.3
    jmask = tmask = None
    jinc = tinc = None
    if mask_kind == "fused":
        jmask = JLazyComparison(jnp.greater, 0.3, shape=data.shape)
        tmask = tmasks.LazyComparisonMask(torch.gt, 0.3, shape=data.shape)
        assert tmasks.fused_predicate(tmask) == (1, 0.3)
    elif mask_kind == "include":
        jinc, tinc = jnp.asarray(inc), torch.as_tensor(inc)
    got = tmom.moments_012_kernel(torch.as_tensor(data), coords, dx,
                                  mask_expr=tmask, include=tinc)
    ref = jmom.moments_012_pallas(jnp.asarray(data), coords, dx,
                                  mask_expr=jmask, include=jinc,
                                  interpret=True)
    oracle = np_moments(data, coords, dx,
                        None if mask_kind == "none" else inc)
    assert_moments(got, oracle)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7, equal_nan=True)


def test_one_included_channel_mom2_matches_pallas():
    """A spaxel with exactly one included channel has mom2 = 0, as
    moments_012_pallas gives it (so its linewidth is 0, not NaN); a spaxel
    with none stays NaN."""
    data = _cube((24, 8, 16), 11) + 0.5
    inc = np.zeros(data.shape, bool)
    inc[:, 2:] = True
    inc[:, 0, 1] = False
    for y, x, c in ((0, 2, 5), (1, 0, 0), (1, 1, 23), (0, 3, 11)):
        inc[:, y, x] = False
        inc[c, y, x] = True
    coords = np.arange(24) * 0.37 + 2.0
    got = tmom.moments_012_kernel(torch.as_tensor(data), coords, 0.37,
                                  include=torch.as_tensor(inc))
    ref = jmom.moments_012_pallas(jnp.asarray(data), coords, 0.37,
                                  include=jnp.asarray(inc), interpret=True)
    one = inc.sum(0) == 1
    assert one.sum() == 4 and np.isnan(got[2].numpy()[0, 1])
    assert np.all(got[2].numpy()[one] == 0.0)
    np.testing.assert_array_equal(np.asarray(ref[2])[one], 0.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7, equal_nan=True)
    with np.errstate(invalid="raise"):
        assert np.all(np.sqrt(got[2].numpy()[one]) == 0.0)


def test_plain_moments_012_matches_jax_jnp_path():
    data = _cube((24, 9, 11), 3)
    coords = np.arange(24) * 1.5
    inc = data > 0.2
    got = tmom.moments_012(torch.as_tensor(data), coords, 1.5,
                           include=torch.as_tensor(inc))
    ref = jmom.moments_012(jnp.asarray(data), coords, 1.5,
                           include=jnp.asarray(inc))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("order,axis", [(0, 0), (1, 0), (3, 0), (2, 1),
                                        (1, 2)])
def test_moment_generic_matches_jax(order, axis):
    data = _cube((10, 7, 9), 5)
    n = data.shape[axis]
    coords = np.linspace(-2.0, 3.0, n)
    inc = data > 0.1
    got = tmom.moment_generic(torch.as_tensor(data), coords, 0.7, order,
                              axis=axis, include=torch.as_tensor(inc))
    ref = jmom.moment_generic(jnp.asarray(data), coords, 0.7, order,
                              axis=axis, include=jnp.asarray(inc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=1e-6, equal_nan=True)


def test_kernel_adversarial_narrow_line():
    """A narrow line far from the coordinate centre (the mom2
    cancellation): 1e-6 for mom1 against the float64 oracle, as the
    chunked TPU kernel's guard test (test_moments.py:418) holds it, and
    agreement with that kernel in interpret mode."""
    nchan, ny, nx = 512, 8, 128
    rng = np.random.RandomState(12)
    coords = np.arange(nchan) * 1.0
    line = np.exp(-0.5 * ((coords - 500.0) / 3.0) ** 2).astype("f4")
    data = (line[:, None, None]
            * (0.5 + rng.rand(1, ny, nx)).astype("f4")).astype("f4")
    got = tmom.moments_012_kernel(torch.as_tensor(data), coords, 1.0)
    e0, e1, e2 = np_moments(data, coords, 1.0)
    np.testing.assert_allclose(got[0].numpy(), e0, rtol=2e-6)
    np.testing.assert_allclose(got[1].numpy(), e1, rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), e2, rtol=1e-5, atol=1e-6)
    cc, xbar = jmom._center(coords)
    ref = jmom._moments_pallas_chunked(jnp.asarray(data), cc, xbar, 1.0,
                                       None, None, True, False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def test_kernel_long_axis_matches_chunked_pallas():
    """1024 channels: the TPU dispatcher takes its chunked kernel here;
    the port's one kernel (32-channel chunks) agrees with it and with the
    oracle, with stats."""
    rng = np.random.RandomState(11)
    nchan, ny, nx = 1024, 8, 128
    data = rng.rand(nchan, ny, nx).astype("f4")
    data[5, 1, 1] = np.nan
    data[:, 0, 3] = np.nan
    coords = np.arange(nchan) * 0.5
    tmask = tmasks.LazyComparisonMask(torch.gt, 0.3, shape=data.shape)
    jmask = JLazyComparison(jnp.greater, 0.3, shape=data.shape)
    got = tmom.moments_012_kernel(torch.as_tensor(data), coords, 0.5,
                                  mask_expr=tmask, with_stats=True)
    cc, xbar = jmom._center(coords)
    ref = jmom._moments_pallas_chunked(jnp.asarray(data), cc, xbar, 0.5,
                                       jmask, None, True, True)
    assert_moments(got[:3], np_moments(data, coords, 0.5, data > 0.3))
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7, equal_nan=True)
    for key in ("npts", "min", "max", "sum", "mean", "sigma", "rms",
                "sumsq"):
        np.testing.assert_allclose(float(got[3][key]), float(ref[3][key]),
                                   rtol=2e-5)


def test_statistics_dc_offset_matches_float64():
    """with_stats planes recombine at plane level and keep the DC-offset
    robustness (test_moments.py:305-328 tolerances)."""
    rng = np.random.RandomState(3)
    data = (1000.0 + 0.01 * rng.randn(64, 16, 128)).astype(np.float32)
    data[3, 2, 5] = np.nan
    include = data > 999.995
    st = tmom.statistics_kernel(torch.as_tensor(data),
                                include=torch.as_tensor(include))
    x = data[include & np.isfinite(data)].astype(np.float64)
    assert int(st["npts"]) == x.size
    np.testing.assert_allclose(float(st["mean"]), x.mean(), rtol=1e-6)
    np.testing.assert_allclose(float(st["sigma"]), x.std(ddof=1), rtol=5e-4)
    np.testing.assert_allclose(float(st["min"]), x.min(), rtol=0)
    np.testing.assert_allclose(float(st["max"]), x.max(), rtol=0)
    np.testing.assert_allclose(float(st["rms"]), np.sqrt((x * x).mean()),
                               rtol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_statistics_match_jax_masked_statistics(fused):
    rng = np.random.RandomState(19)
    data = rng.randn(48, 16, 100).astype("f4")
    data[3, 2, 5] = np.nan
    inc = data > -0.5
    if fused:
        st = tmom.statistics_kernel(torch.as_tensor(data),
                                    mask_expr=tmasks.LazyComparisonMask(
                                        torch.gt, -0.5, shape=data.shape))
    else:
        st = tmom.statistics_kernel(torch.as_tensor(data),
                                    include=torch.as_tensor(inc))
    ref = jred.masked_statistics(
        jnp.asarray(data), jred.valid_mask(jnp.asarray(data),
                                           jnp.asarray(inc)))
    plain = tred.masked_statistics(
        torch.as_tensor(data), tred.valid_mask(torch.as_tensor(data),
                                               torch.as_tensor(inc)))
    for key in ("npts", "min", "max", "sum", "mean", "sigma", "rms",
                "sumsq"):
        for got in (st, plain):
            rel = abs(float(got[key]) - float(ref[key])) \
                / max(abs(float(ref[key])), 1e-30)
            assert rel < 2e-5, (key, rel)


def test_statistics_all_masked():
    st = tmom.statistics_kernel(torch.ones((8, 8, 16)),
                                include=torch.zeros((8, 8, 16), dtype=bool))
    assert int(st["npts"]) == 0
    for key in ("mean", "sigma", "min", "max", "sum", "rms"):
        assert np.isnan(float(st[key]))


def test_statistics_reference_anchor(tmp_path):
    """The reference's published statistics() values (BASELINE.md;
    reference tests/test_dask.py:97-107) through the port's cube, at the
    JAX test's 1e-6 (test_cube.py:768)."""
    np.random.seed(96)
    d = np.random.random((4, 3, 2))
    p, _ = make_cube_file(tmp_path, name="anchor.fits", shape=(4, 3, 2))
    cube = T.SpectralCube.read(str(p), device="cpu")._new_cube_with(
        data=d, mask=None)
    st = cube.statistics()
    expected = {"npts": 24, "mean": 0.4941651776136591,
                "sigma": 0.3021908870982011, "sum": 11.85996426272782,
                "sumsq": 7.961125988022091, "min": 0.0363300285196364,
                "max": 0.9662900439556562, "rms": 0.5759458158839716}
    for key, val in expected.items():
        np.testing.assert_allclose(float(getattr(st[key], "value", st[key])),
                                   val, rtol=1e-6)


@pytest.mark.parametrize("axis", [None, 0, 2])
def test_mad_std_and_percentile_match_jax(axis):
    rng = np.random.RandomState(8)
    data = rng.randn(20, 9, 13).astype("f4")
    data[2, 3, 4] = np.nan
    data[:, 1, 1] = np.nan
    inc = data > -1.0
    jd, td = jnp.asarray(data), torch.as_tensor(data)
    jv, tv = jred.valid_mask(jd, jnp.asarray(inc)), \
        tred.valid_mask(td, torch.as_tensor(inc))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pairs = [(tred.masked_mad_std(td, tv, axis=axis),
                  jred.masked_mad_std(jd, jv, axis=axis)),
                 (tred.masked_percentile(td, tv, 37.5, axis=axis),
                  jred.masked_percentile(jd, jv, 37.5, axis=axis)),
                 (tred.masked_median(td, tv, axis=axis),
                  jnp.nanpercentile(jnp.where(jv, jd, jnp.nan), 50.0,
                                    axis=axis))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7, equal_nan=True)


def test_fused_predicate_table():
    gt = tmasks.LazyComparisonMask(torch.gt, 1.5)
    le = tmasks.LazyComparisonMask(torch.le, -2.0)
    fin = tmasks.LazyMask(torch.isfinite)
    assert tmasks.fused_predicate(None) == (0, 0.0)
    assert tmasks.fused_predicate(fin) == (0, 0.0)
    assert tmasks.fused_predicate(fin & gt) == (1, 1.5)
    assert tmasks.fused_predicate(le & fin) == (4, -2.0)
    # two comparisons, an "or" and a stored array go in as include arrays
    assert tmasks.fused_predicate(gt & le) is None
    assert tmasks.fused_predicate(gt | fin) is None
    assert tmasks.fused_predicate(
        tmasks.BooleanArrayMask(np.ones((2, 2, 2), bool))) is None
    assert tmasks.fused_predicate(~gt) is None


def test_plain_planes_chunk_boundaries_and_counter():
    """The plain version at nchan = CHUNK +- 1 agrees with the float64
    oracle, and on CPU tensors the kernel counter stays 0."""
    kmom.moments_planes.launches = 0
    for nchan in (kmom.CHUNK - 1, kmom.CHUNK + 1):
        data = _cube((nchan, 8, 12), nchan)
        coords = np.arange(nchan) * 2.0
        got = tmom.moments_012_kernel(torch.as_tensor(data), coords, 2.0)
        assert_moments(got, np_moments(data, coords, 2.0))
    assert kmom.moments_planes.launches == 0


@pytest.mark.parametrize("npix,data_aligned,mask,mask_aligned,staging,form", [
    (768 * 768, True, False, True, "cp.async16", "none"),
    (768 * 768, True, True, True, "cp.async16", "cp.async16"),
    (768 * 768, True, True, False, "cp.async16", "cp.async4"),
    (13 * 45, True, True, True, "cp.async4", "direct"),
    (4 * 35, True, True, True, "cp.async16", "cp.async4"),
    (4 * 35, False, False, True, "cp.async4", "none"),
    (1, True, True, True, "cp.async4", "direct")])
def test_kernel_plan(npix, data_aligned, mask, mask_aligned, staging, form):
    """The moments kernel's launch: 16-byte copies of the data only where
    a plane's rows of spaxels are 16-byte aligned, the include mask's
    bytes staged 16 or 4 at a time where its rows allow and read directly
    otherwise, a ring of STAGES chunk tiles (the mask's bytes beside them
    when staged), one block per THREADS spaxels with a tail block."""
    p = kmom.plan(npix, data_aligned, mask, mask_aligned)
    assert (p.staging, p.mask, p.stages) == (staging, form, kmom.STAGES)
    assert p.blocks == -(-npix // kmom.THREADS)
    assert (p.blocks * kmom.THREADS == npix) == (npix % kmom.THREADS == 0)
    tile = kmom.CHUNK * kmom.THREADS
    staged = form in ("cp.async16", "cp.async4")
    assert p.smem == kmom.STAGES * tile * (5 if staged else 4)
    assert p.smem <= 232448 - 1024
