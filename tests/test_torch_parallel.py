"""Torch port, the multi-device layer against the JAX package.

The JAX package's ``tests/test_parallel.py``, test for test, on its own
8-device virtual CPU mesh (tests/conftest.py) and on the port's mesh of
eight CPU positions (``CubeMesh(devices=['cpu'] * 8)``, the same 2 x 4
grid): each sharded function of the port is held against the JAX sharded
function on the same inputs and against the port's unsharded function, at
the JAX tests' tolerances, with equal NaN patterns.  Where a JAX test reads
the compiled program's collectives (collective-permute, all-to-all,
all-gather), the port's test reads the mesh's counters (halo exchanges,
all-to-alls, gathers of a cube).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu import parallel as jpar

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch.ops import moments as tmom
from spectral_cube_tpu_torch.ops import regrid as trg
from spectral_cube_tpu_torch.ops import smoothing as tsm
from spectral_cube_tpu_torch.ops import convolve as tcv
from spectral_cube_tpu_torch.ops import interpolate as titp

from conftest import make_cube_file, make_vr_cube_file

pytestmark = pytest.mark.filterwarnings("ignore::Warning")


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) != 8:
        pytest.skip("multi-device tests need the 8-device virtual mesh")
    return jpar.CubeMesh()


@pytest.fixture
def tmesh():
    return tpar.CubeMesh(devices=["cpu"] * 8)


@pytest.fixture
def big_cube():
    rng = np.random.RandomState(3)
    data = rng.rand(16, 24, 32).astype("f4")
    data[4, 5, 6] = np.nan
    coords = np.arange(16) * 0.5
    return data, coords, 0.5


def _np(x):
    if isinstance(x, (T.Quantity, J.Quantity)):
        x = x.value
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, rtol, atol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _read(path):
    return (T.SpectralCube.read(path, device="cpu"),
            J.SpectralCube.read(path))


def _offset_mapping(ny, nx, dy=0.37, dx=0.61):
    ys = np.broadcast_to(np.arange(ny, dtype=np.float64)[:, None] + dy,
                         (ny, nx)).copy()
    xs = np.broadcast_to(np.arange(nx, dtype=np.float64)[None, :] + dx,
                         (ny, nx)).copy()
    return ys, xs


def test_mesh_grid(tmesh, jmesh):
    assert tmesh.n_devices == jmesh.n_devices == 8
    assert tmesh.grid == jmesh.grid
    assert tmesh.axis_names == tuple(jmesh.axis_names)
    assert tpar.mesh._factor2(8) == jpar.mesh._factor2(8) == (2, 4)
    with pytest.raises(ValueError, match="does not match"):
        tpar.CubeMesh(devices=["cpu"] * 8, shape=(3, 3))


def test_default_mesh_needs_cuda(monkeypatch):
    """The default mesh spans the CUDA devices; no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.CubeMesh()


def test_sharded_moments_match_single_device(tmesh, jmesh, big_cube):
    data, coords, dx = big_cube
    want = tmom.moments_012_kernel(torch.from_numpy(data), coords, dx)
    got = tpar.sharded_moments(data, coords, dx, tmesh)
    jgot = jpar.sharded_moments(data, coords, dx, jmesh)
    for i, (g, w, j) in enumerate(zip(got, want, jgot)):
        assert g.layout == "plane"
        tol = (1e-6, 0) if i < 2 else (1e-5, 1e-7)
        _close(g, w, *tol)
        _close(g, j, *tol)
    assert tmesh.counters["halo_exchanges"] == 0
    assert tmesh.counters["all_to_alls"] == 0


def test_sharded_moments_with_mask(tmesh, jmesh, big_cube):
    data, coords, dx = big_cube
    tmask = T.LazyComparisonMask(torch.gt, 0.3, shape=data.shape)
    jmask = J.LazyComparisonMask(jnp.greater, 0.3, shape=data.shape)
    got = tpar.sharded_moments(data, coords, dx, tmesh, mask_expr=tmask)
    want = tmom.moments_012_kernel(torch.from_numpy(data), coords, dx,
                                   mask_expr=tmask)
    jgot = jpar.sharded_moments(data, coords, dx, jmesh, mask_expr=jmask)
    inc = tpar.sharded_moments(data, coords, dx, tmesh,
                               include=data > 0.3)
    for g, w, j, i in zip(got, want, jgot, inc):
        _close(g, w, 1e-5, 1e-7)
        _close(i, w, 1e-5, 1e-7)
        _close(g, j, 1e-5, 1e-7)


def test_sharded_statistics(tmesh, jmesh, big_cube):
    data, _, _ = big_cube
    st = tpar.sharded_statistics(data, tmesh)
    jst = jpar.sharded_statistics(data, jmesh)
    ust = tmom.statistics_kernel(torch.from_numpy(data))
    dd = data[np.isfinite(data)].astype("f8")
    assert st["npts"] == jst["npts"] == dd.size == int(ust["npts"])
    assert st["mean"] == pytest.approx(dd.mean(), rel=1e-6)
    assert st["sigma"] == pytest.approx(dd.std(ddof=1), rel=1e-4)
    assert st["min"] == pytest.approx(dd.min(), rel=1e-6)
    assert st["max"] == pytest.approx(dd.max(), rel=1e-6)
    for key in ("mean", "sigma", "min", "max", "sum", "sumsq", "rms"):
        assert st[key] == pytest.approx(jst[key], rel=1e-5)
        assert st[key] == pytest.approx(float(ust[key]), rel=1e-5)


def test_sharded_statistics_float64(tmesh, jmesh, big_cube):
    """A float64 cube's statistics come from the moments kernel's plain
    with_stats planes, in float32 as the kernel computes, with a mask
    evaluated in float64: the float32 cube's values, the JAX package's
    and the unsharded float64 statistics."""
    data, _, _ = big_cube
    src = torch.from_numpy(data.astype(np.float64))
    mask = T.LazyComparisonMask(torch.gt, 0.3, shape=data.shape)
    st = tpar.sharded_statistics(src, tmesh, mask_expr=mask)
    want = tpar.sharded_statistics(data, tmesh, mask_expr=mask)
    jst = jpar.sharded_statistics(data, jmesh, include=data > 0.3)
    dd = data[np.isfinite(data) & (data > 0.3)].astype("f8")
    assert st["npts"] == want["npts"] == jst["npts"] == dd.size
    assert st["mean"] == pytest.approx(dd.mean(), rel=1e-6)
    assert st["sigma"] == pytest.approx(dd.std(ddof=1), rel=1e-4)
    for key in ("mean", "sigma", "min", "max", "sum", "sumsq", "rms"):
        assert st[key] == pytest.approx(want[key], rel=1e-6)
        assert st[key] == pytest.approx(jst[key], rel=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sharded_statistics_all_masked(tmesh, jmesh, big_cube, dtype):
    """A cube with nothing included gives npts 0 and NaN elsewhere (the
    reference's all-NaN chunks, tests/test_dask.py:110-118)."""
    data = big_cube[0].astype(dtype)
    none = np.zeros(data.shape, bool)
    src = torch.from_numpy(data) if dtype == np.float64 else data
    st = tpar.sharded_statistics(src, tmesh, include=none)
    jst = jpar.sharded_statistics(data, jmesh, include=none)
    assert st["npts"] == jst["npts"] == 0
    for key in ("min", "max", "sum", "sumsq", "mean", "sigma", "rms"):
        assert np.isnan(st[key]) and np.isnan(jst[key])


def test_halo_exchange_convolution(tmesh, jmesh, big_cube):
    """Halo-exchange direct conv == single-device conv (the chunk-overlap
    correctness invariant)."""
    data, _, _ = big_cube
    k = np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25])
    want = tsm.spatial_smooth_cube(torch.from_numpy(data), k)
    got = tpar.sharded_spatial_convolve(data, k, tmesh)
    assert tmesh.counters == {"halo_exchanges": 2, "all_to_alls": 0,
                              "gathers": 0}
    _close(got, want, 1e-5, 1e-6)
    _close(got, jpar.sharded_spatial_convolve(data, k, jmesh), 1e-5, 1e-6)


def test_halo_pad_fills_corners_and_refuses_wide_halos(tmesh):
    """Each padded tile holds its neighbours' rows and columns (corners
    from the diagonal neighbour), zeros past the cube's edge, as
    ``halo_pad`` does in shard_map; a halo wider than a tile raises."""
    data = np.arange(2 * 8 * 16, dtype=np.float32).reshape(2, 8, 16) + 1
    tiles, _, _ = tpar.sharded._pad_spatial(data, tmesh, 0.0)
    padded = tpar.halo_pad(tiles, tmesh, 2, 1)
    full = np.pad(data, ((0, 0), (2, 2), (1, 1)))
    for p, b in enumerate(padded):
        iy, ix = divmod(p, 4)
        np.testing.assert_array_equal(
            b.numpy(), full[:, iy * 4:iy * 4 + 8, ix * 4:ix * 4 + 6])
    with pytest.raises(ValueError, match="wider than"):
        tpar.halo_pad(tiles, tmesh, 5, 0)


def test_sharded_cube_facade(tmp_path, tmesh, jmesh):
    path, data = make_cube_file(tmp_path, shape=(16, 24, 32))
    tc, jc = _read(path)
    sc, jsc = tpar.ShardedCube(tc, tmesh), jpar.ShardedCube(jc, jmesh)
    m0, m1, m2 = sc.moment_maps()
    _close(m0.value, tc.moment0().value, 1e-5)
    _close(m0.value, jsc.moment_maps()[0].value, 1e-5)
    assert str(m0.unit) == str(tc.moment0().unit)
    st = sc.statistics()
    assert st["npts"] == jsc.statistics()["npts"] == np.isfinite(data).sum()
    assert tmesh.counters["gathers"] == 0


def test_sharded_sigma_clip(tmp_path, tmesh, jmesh):
    path, data = make_cube_file(tmp_path, shape=(16, 24, 32))
    tc, jc = _read(path)
    K.reset_launch_counts()
    got = tpar.ShardedCube(tc, tmesh).sigma_clip_spectrally(2.0)
    want = tc.sigma_clip_spectrally(2.0)
    jgot = jpar.ShardedCube(jc, jmesh).sigma_clip_spectrally(2.0)
    _close(got.cube.unmasked_data[:], want.unmasked_data[:], 1e-5)
    _close(got.cube.unmasked_data[:], jgot.cube.unmasked_data[:], 1e-5)
    assert all(n == 0 for n in K.launch_counts().values())


def test_reshard_roundtrip(tmesh, big_cube):
    data, _, _ = big_cube
    d2 = tmesh.reshard(tmesh.shard(data, "spatial"), "spectral",
                       source="spatial")
    out = tmesh.reshard(d2.map(lambda b: b * 2.0), "spatial",
                        source="spectral")
    assert out.layout == "spatial"
    _close(out, data * 2, 1e-6)
    assert tmesh.counters["all_to_alls"] == 4


def _shard_of(jshard, jmesh):
    my, mx = jmesh.grid
    return np.unravel_index(np.argwhere(
        jmesh.mesh.devices.ravel() == jshard.device)[0, 0], (my, mx))


def test_reshard_is_identity_permutation(tmesh, jmesh):
    """The explicit all-to-all reshard is a pure layout change, and every
    position holds the channel block of the same mesh position in the JAX
    array (y-major, P(('y','x'), None, None))."""
    my, mx = tmesh.grid
    n = tmesh.n_devices
    nchan, ny, nx = 2 * n, 4 * my, 4 * mx
    data = np.arange(nchan * ny * nx, dtype=np.float32).reshape(
        nchan, ny, nx)
    out = tmesh.reshard(tmesh.shard(data, "spatial"), "spectral",
                        source="spatial")
    jout = jmesh.reshard(jmesh.shard(data, "spatial"), "spectral",
                         source="spatial")
    np.testing.assert_array_equal(np.asarray(out), data)
    jblocks = {tuple(_shard_of(sh, jmesh)): np.asarray(sh.data)
               for sh in jout.addressable_shards}
    for sh in out.addressable_shards:
        local = sh.data.numpy()
        assert local.shape == (nchan // n, ny, nx)
        blk = sh.position[0] * mx + sh.position[1]
        np.testing.assert_array_equal(
            local, data[blk * (nchan // n):(blk + 1) * (nchan // n)])
        np.testing.assert_array_equal(local, jblocks[tuple(sh.position)])


@pytest.mark.parametrize("shape", [(10, 13, 9), (7, 6, 8)])
def test_reshard_roundtrip_uneven(tmesh, jmesh, shape):
    """Reshard stays correct when no axis divides the mesh evenly (the
    pad-exchange-cut path)."""
    rng = np.random.RandomState(3)
    data = rng.rand(*shape).astype(np.float32)
    d2 = tmesh.reshard(tmesh.shard(data, "spatial"), "spectral",
                       source="spatial")
    out = tmesh.reshard(d2.map(lambda b: b + 1.0), "spatial",
                        source="spectral")
    _close(out, data + 1, 1e-6)

    @jax.jit
    def roundtrip(d):
        d2 = jmesh.reshard(d, "spectral", source="spatial")
        return jmesh.reshard(d2 + 1.0, "spatial", source="spectral")
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(roundtrip(jmesh.shard(data, "spatial"))))


def test_shard_replicates_axes_the_mesh_does_not_divide(tmesh, jmesh):
    """``shard`` keeps ``_compatible_spec``'s rule: a non-dividing axis is
    whole on every position, with a PossiblySlowWarning, as in JAX."""
    from spectral_cube_tpu_torch.utils import PossiblySlowWarning
    data = np.ones((5, 7, 8), dtype="f4")
    with pytest.warns(PossiblySlowWarning):
        t = tmesh.shard(data, "spatial")
    j = jmesh.shard(data, "spatial")
    jidx = {tuple(_shard_of(sh, jmesh)): tuple(s.indices(n)[:2] for s, n in
                                               zip(sh.index, data.shape))
            for sh in j.addressable_shards}
    for sh in t.addressable_shards:
        assert tuple((s.start, s.stop) for s in sh.index) == \
            jidx[tuple(sh.position)]
    with pytest.raises(ValueError, match="plane"):
        tmesh.shard(np.ones((4, 4), "f4"), "spatial")


def test_use_mesh_context(tmesh):
    base = tpar.CubeMesh(devices=["cpu"] * 8)
    tpar.use_mesh(base)
    try:
        assert tpar.default_mesh() is base
        small = tpar.CubeMesh(devices=["cpu"] * 4)
        with tpar.use_mesh(small) as m:
            assert tpar.default_mesh() is small
            assert m.n_devices == 4
        assert tpar.default_mesh() is base
    finally:
        tpar.mesh._DEFAULT_MESH = None


def test_sharded_cube_delegation(tmp_path, tmesh, jmesh):
    """ShardedCube quacks like the cube: metadata without a gather, its
    own methods (``spectral_slab``) shard by shard, un-overridden methods
    on the gathered cube (one counted gather), and cube-returning ones
    sharded again."""
    path, data = make_cube_file(tmp_path, shape=(8, 16, 16))
    tc, jc = _read(path)
    sc = tpar.ShardedCube(tc, tmesh)
    jsc = jpar.ShardedCube(jc, jmesh)
    assert sc.unit == tc.unit
    np.testing.assert_allclose(sc.spectral_axis.value,
                               tc.spectral_axis.value)
    assert tmesh.counters["gathers"] == 0
    sub = sc.spectral_slab(T.Quantity(-321.2, "km / s"),
                           T.Quantity(-318.7, "km / s"))
    jsub = jsc.spectral_slab(J.Quantity(-321.2, "km / s"),
                             J.Quantity(-318.7, "km / s"))
    assert tmesh.counters["gathers"] == 0
    peak = sc.apply_numpy_function(np.nanmax)
    assert tmesh.counters["gathers"] == 1
    assert peak == np.nanmax(data.astype("f4"))
    assert isinstance(sub, tpar.ShardedCube)
    assert sub.shape == jsub.shape and sub.shape[0] == 3
    m0 = sub.moment_maps()[0]
    assert m0.shape == (16, 16)
    _close(m0.value, jsub.moment_maps()[0].value, 1e-5)
    st = sc.statistics()
    assert st["npts"] == np.isfinite(data).sum()
    assert "ShardedCube" in repr(sc)


def test_sharded_convolve_to_matches_unsharded(tmp_path, tmesh, jmesh):
    """ShardedCube.convolve_to agrees with the single-device path and the
    JAX sharded one."""
    path, data = make_vr_cube_file(tmp_path, shape=(8, 16, 16))
    tc, jc = _read(path)
    target = tc.common_beam()
    want = tc.convolve_to(target)
    got = tpar.ShardedCube(tc, tmesh).convolve_to(target)
    jgot = jpar.ShardedCube(jc, jmesh).convolve_to(jc.common_beam())
    _close(got.cube.unmasked_data[:], want.unmasked_data[:], 2e-4, 2e-6)
    _close(got.cube.unmasked_data[:], jgot.cube.unmasked_data[:], 2e-4,
           2e-6)
    assert got.cube.beam == want.beam
    assert type(got.cube).__name__ == "SpectralCube"


def test_collective_structure(tmesh, big_cube):
    """The counters' guarantees (the JAX test reads them from the compiled
    programs): moments and statistics in the spatial layout move no
    data; the reshard is all-to-alls, never a gather of the cube."""
    data, coords, dx = big_cube
    placed = tmesh.shard(data, "spatial")
    tpar.sharded_moments(placed, coords, dx, tmesh)
    tpar.sharded_statistics(placed, tmesh)
    assert tmesh.counters == {"halo_exchanges": 0, "all_to_alls": 0,
                              "gathers": 0}
    tmesh.reshard(placed, "spectral", source="spatial")
    assert tmesh.counters["all_to_alls"] == 2
    assert tmesh.counters["gathers"] == 0


def test_sharded_halo_convolve_matches_unsharded(tmesh, jmesh):
    """The halo-exchange per-channel separable convolution (no all-to-all)
    agrees with the unsharded batched separable path, through conv_sep on
    every shard."""
    rng = np.random.RandomState(5)
    nchan, ny, nx = 6, 24, 32
    data = rng.rand(nchan, ny, nx).astype("f4")
    data[2, 10, 12] = np.nan
    kernels = []
    for g in range(3):
        x = np.arange(9) - 4
        k = np.exp(-0.5 * np.add.outer(x ** 2, x ** 2) / (1.2 + 0.4 * g) ** 2)
        kernels.append(k / k.sum())
    kernels.append(None)
    gidx = (np.arange(nchan) % 4).astype(np.int32)
    want = tcv.convolve_per_channel_separable(torch.from_numpy(data),
                                              kernels, gidx)
    jgot = jpar.sharded.sharded_convolve_per_channel_separable(
        data, kernels, gidx, jmesh)
    K.reset_launch_counts()
    got = tpar.sharded_convolve_per_channel_separable(data, kernels, gidx,
                                                      tmesh)
    assert got is not None
    assert tmesh.counters == {"halo_exchanges": 2, "all_to_alls": 0,
                              "gathers": 0}
    assert K.launch_counts()["conv_sep"] == 0   # the CPU's plain version
    _close(got, want, 2e-5, 2e-6)
    _close(got, jgot, 2e-5, 2e-6)


def test_sharded_halo_convolve_even_kernel(tmesh, jmesh):
    """Even-length kernels need the ceil half-width halo (a floor halo
    drops one tap at every tile boundary)."""
    rng = np.random.RandomState(6)
    data = rng.rand(4, 16, 16).astype("f4")
    k = np.outer(np.hanning(6)[0:4] + 0.1, np.hanning(6)[0:4] + 0.1)
    k /= k.sum()
    gidx = np.zeros(4, dtype=np.int32)
    want = tcv.convolve_per_channel_separable(torch.from_numpy(data), [k],
                                              gidx)
    got = tpar.sharded_convolve_per_channel_separable(data, [k], gidx, tmesh)
    jgot = jpar.sharded.sharded_convolve_per_channel_separable(
        data, [k], gidx, jmesh)
    _close(got, want, 2e-5, 2e-6)
    _close(got, jgot, 2e-5, 2e-6)


def test_halo_convolve_nans_channels_empty_everywhere(tmesh):
    """A channel with no finite value in the whole cube is NaN everywhere,
    though the edge tiles' zero halos are finite (the any_valid
    reduction over the mesh)."""
    data = np.random.RandomState(2).rand(3, 16, 16).astype("f4")
    data[1] = np.nan
    k = np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25])
    got = _np(tpar.sharded_spatial_convolve(data, k, tmesh))
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()
    np.testing.assert_array_equal(
        got, tsm.spatial_smooth_cube(torch.from_numpy(data), k).numpy())


def test_fused_ops_on_sharded_arrays(tmesh, jmesh):
    """The fused smooth + interp runs per shard (smooth_interp's plain
    version here) and matches the chained single-device operators and
    the JAX op on sharded arrays."""
    from spectral_cube_tpu.ops import interpolate as jitp
    from spectral_cube_tpu.ops.smoothing import spectral_smooth_cube
    rng = np.random.RandomState(3)
    data_np = rng.rand(16, 16, 32).astype("f4")
    kern = tsm.gaussian_kernel1d(1.0)
    inaxis = np.arange(16, dtype=np.float64)
    outaxis = inaxis[::2]
    ref, _ = titp.interp_cube_spectral(
        tsm.spectral_smooth_cube(torch.from_numpy(data_np), kern),
        inaxis, outaxis)
    got, inc = tpar.sharded_smooth_interpolate(data_np, kern, inaxis,
                                               outaxis, tmesh)
    assert inc is None
    _close(got, ref, 2e-5, 1e-6)
    jref, _ = jitp.interp_cube_spectral(
        spectral_smooth_cube(jnp.asarray(data_np), kern), inaxis, outaxis)
    _close(got, jref, 2e-5, 1e-6)


@pytest.mark.parametrize("shape,seed", [((9, 10, 10), 1), ((11, 5, 9), 2),
                                        ((6, 8, 13), 3)])
def test_sharded_ops_mesh_unaligned_shapes(tmp_path, tmesh, jmesh, shape,
                                           seed):
    """Sharded ops on cubes whose dims do not divide the mesh (aligned
    tiles internally, cut after) agree with the unsharded results and
    with JAX's, the interpolated mask included; spectral_interpolate
    interpolates RAW data and the mask separately."""
    p, _ = make_cube_file(tmp_path, name=f"u{seed}.fits", shape=shape,
                          seed=seed)
    tc, jc = _read(p)
    m = tc.with_mask(tc > T.Quantity(0.3, tc.unit))
    jm = jc.with_mask(jc > J.Quantity(0.3, jc.unit))
    sc, jsc = tpar.ShardedCube(m, tmesh), jpar.ShardedCube(jm, jmesh)
    m0s = sc.moment_maps()[0]
    _close(m0s.value, m.moment0().value, 2e-5)
    _close(m0s.value, jsc.moment_maps()[0].value, 2e-5)
    st_s, st, jst = sc.statistics(), m.statistics(), jsc.statistics()
    for k in ("npts", "mean", "sigma", "sum", "max", "min"):
        np.testing.assert_allclose(float(st_s[k]), float(st[k]), rtol=1e-5)
        np.testing.assert_allclose(float(st_s[k]), float(jst[k]), rtol=1e-5)
    kern = np.ones((3, 3)) / 9.0
    a = sc.spatial_smooth(kern).cube
    _close(a.unmasked_data[:], m.spatial_smooth(
        kern, raise_error_jybm=False).unmasked_data[:], 3e-5, 1e-6)
    _close(a.unmasked_data[:], jsc.spatial_smooth(kern).cube
           .unmasked_data[:], 3e-5, 1e-6)
    g = m.spectral_axis[::2]
    a = sc.spectral_interpolate(g).cube
    b = m.spectral_interpolate(g)
    jg = jm.spectral_axis[::2]
    ja = jsc.spectral_interpolate(jg).cube
    _close(a.unmasked_data[:], b.unmasked_data[:], 3e-5, 1e-6)
    _close(a.unmasked_data[:], ja.unmasked_data[:], 3e-5, 1e-6)
    np.testing.assert_array_equal(a.get_mask_array(), b.get_mask_array())
    np.testing.assert_array_equal(a.get_mask_array(),
                                  np.asarray(ja.get_mask_array()))


@pytest.mark.parametrize("shape,ksize", [((3, 10, 17), 6),
                                         ((3, 10, 17), 2)])
def test_sharded_fft_fallback_uneven_shape(tmesh, jmesh, shape, ksize):
    """The reshard + FFT route (full-rank EVEN kernel) on mesh-unaligned
    spatial shapes, its FFT planes sized from the MESH-PADDED extent."""
    rng = np.random.RandomState(8)
    data = rng.rand(*shape).astype("f4")
    data[1, 4, 9] = np.nan
    k = rng.rand(ksize, ksize) + 0.05
    k /= k.sum()
    want = tcv.convolve2d_nan_fft(torch.from_numpy(data), k)
    got = tpar.sharded_spatial_convolve(data, k, tmesh)
    # the 6x6 kernel (rank 6, even) takes the FFT route; the 2x2 one
    # separates (rank 2) and stays on the halo route, as in JAX
    assert tmesh.counters["all_to_alls"] == (4 if ksize == 6 else 0)
    assert tmesh.counters["gathers"] == 0
    assert got.shape == shape
    _close(got, want, 2e-4, 2e-5)
    _close(got, jpar.sharded_spatial_convolve(data, k, jmesh), 2e-4, 2e-5)


def test_reshard_generic_path_mesh_unaligned(tmesh, jmesh):
    """reshard without source= takes the array's own layout, also for
    shapes that ``shard`` replicated."""
    data = np.ones((5, 7, 8), dtype="f4")
    b = tmesh.shard(data, "spatial")
    out = tmesh.reshard(b, "spectral")
    assert out.layout == "spectral"
    np.testing.assert_array_equal(np.asarray(out), data)
    jb = jmesh.shard(jnp.asarray(data), "spatial")
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(jmesh.reshard(jb, "spectral")))


def test_reshard_uneven_placement_not_just_roundtrip(tmesh, jmesh):
    """The uneven-shape reshard's placement, position by position, against
    the JAX array's shards: a round trip alone cannot see a symmetric
    layout fault (the all-to-all axes swapped both ways)."""
    my, mx = tmesh.grid
    n = tmesh.n_devices
    nchan, ny, nx = 2 * n, 4 * my - 1, 4 * mx - 3
    data = np.arange(nchan * ny * nx, dtype=np.float32).reshape(
        nchan, ny, nx)
    out = tmesh.reshard(tmesh.shard(data, "spatial"), "spectral",
                        source="spatial")
    jout = jmesh.reshard(jmesh.shard(data, "spatial"), "spectral",
                         source="spatial")
    jblocks = {tuple(_shard_of(sh, jmesh)): (sh.index[0].indices(nchan)[:2],
                                             np.asarray(sh.data))
               for sh in jout.addressable_shards}
    per = nchan // n
    for sh in out.addressable_shards:
        blk = sh.position[0] * mx + sh.position[1]
        assert (sh.index[0].start, sh.index[0].stop) == \
            (blk * per, (blk + 1) * per) == jblocks[tuple(sh.position)][0]
        np.testing.assert_array_equal(sh.data.numpy(),
                                      data[blk * per:(blk + 1) * per])
        np.testing.assert_array_equal(
            sh.data.numpy(), jblocks[tuple(sh.position)][1][:, :ny, :nx])


def _smooth_case(tmp_path, name, shape, seed, **kw):
    p, data = make_cube_file(tmp_path, name=name, shape=shape, seed=seed,
                             **kw)
    tc, jc = _read(p)
    sv = np.asarray(tc.spectral_axis.value)
    mid = (sv[:-1] + sv[1:]) / 2.0
    return tc, jc, mid, tsm.gaussian_kernel1d(1.0)


def test_sharded_smooth_interpolate_matches_unsharded(tmp_path, tmesh,
                                                      jmesh):
    """spectral_interpolate(smooth_kernel=) runs the fused smooth + regrid
    per spatial shard (smooth_interp, once a shard) and matches the
    unsharded API's filled values."""
    tc, jc, mid, kern = _smooth_case(tmp_path, "si.fits", (12, 8, 8), 5)
    ref = tc.spectral_interpolate(T.Quantity(mid, tc.spectral_unit),
                                  smooth_kernel=kern)
    got = tpar.ShardedCube(tc, tmesh).spectral_interpolate(
        T.Quantity(mid, tc.spectral_unit), smooth_kernel=kern)
    jgot = jpar.ShardedCube(jc, jmesh).spectral_interpolate(
        J.Quantity(mid, jc.spectral_unit), smooth_kernel=kern)
    _close(got.cube.filled_data[:], ref.filled_data[:], 2e-5, 1e-6)
    _close(got.cube.filled_data[:], jgot.cube.filled_data[:], 2e-5, 1e-6)


def test_sharded_smooth_interpolate_threshold_mask_parity(tmp_path, tmesh,
                                                          jmesh):
    """A threshold (data-local) mask re-evaluates on the SMOOTHED data,
    sharded as unsharded: each tile smooths its whole spectra and
    evaluates the mask on them, with no gather."""
    tc, jc, mid, kern = _smooth_case(tmp_path, "tm.fits", (10, 8, 8), 9)
    tc = tc.with_mask(tc > T.Quantity(0.3, tc.unit))
    jc = jc.with_mask(jc > J.Quantity(0.3, jc.unit))
    ref = tc.spectral_interpolate(T.Quantity(mid, tc.spectral_unit),
                                  smooth_kernel=kern)
    tmesh.reset_counters()
    got = tpar.ShardedCube(tc, tmesh).spectral_interpolate(
        T.Quantity(mid, tc.spectral_unit), smooth_kernel=kern)
    assert tmesh.counters["gathers"] == 0
    jgot = jpar.ShardedCube(jc, jmesh).spectral_interpolate(
        J.Quantity(mid, jc.spectral_unit), smooth_kernel=kern)
    _close(got.cube.filled_data[:], ref.filled_data[:], 2e-5, 1e-6)
    _close(got.cube.filled_data[:], jgot.cube.filled_data[:], 2e-5, 1e-6)


def test_sharded_smooth_interpolate_unaligned_spatial(tmp_path, tmesh,
                                                      jmesh):
    """Zero padding (not NaN) on mesh-unaligned spatial shapes keeps the
    results the unsharded call's."""
    tc, jc, mid, kern = _smooth_case(tmp_path, "ua.fits", (8, 9, 13), 11,
                                     with_nan=False)
    ref = tc.spectral_interpolate(T.Quantity(mid, tc.spectral_unit),
                                  smooth_kernel=kern)
    got = tpar.ShardedCube(tc, tmesh).spectral_interpolate(
        T.Quantity(mid, tc.spectral_unit), smooth_kernel=kern)
    jgot = jpar.ShardedCube(jc, jmesh).spectral_interpolate(
        J.Quantity(mid, jc.spectral_unit), smooth_kernel=kern)
    _close(got.cube.filled_data[:], ref.filled_data[:], 2e-5, 1e-6)
    _close(got.cube.filled_data[:], jgot.cube.filled_data[:], 2e-5, 1e-6)


def test_vrods_interp_same_length_keeps_goodbeams(tmp_path):
    """A same-length 1-D regrid keeps both the beams and the goodbeams
    mask, in both packages."""
    p, _ = make_vr_cube_file(tmp_path, shape=(4, 3, 2))
    tc, jc = _read(p)
    for c, Q in ((tc.mask_out_bad_beams(10.0), T.Quantity),
                 (jc.mask_out_bad_beams(10.0), J.Quantity)):
        spec = c[:, 1, 1]
        gbm = np.asarray(spec.goodbeams_mask).copy()
        sv = np.asarray(spec.spectral_axis.value)
        out = spec.spectral_interpolate(
            Q(sv + 0.1 * (sv[1] - sv[0]), spec.spectral_axis.unit),
            suppress_smooth_warning=True)
        assert np.all(np.asarray(out.goodbeams_mask) == gbm)
        assert len(out.beams) == gbm.sum()


def test_sharded_spatial_convolve_nonseparable_halo_path(tmesh, jmesh):
    """A full-rank odd kernel (rank 5 > 4) takes the direct halo path: the
    unsharded smoothing on each halo-padded block, NaN hole included."""
    rng = np.random.RandomState(17)
    data = rng.rand(4, 16, 16).astype("f4")
    data[1, 7, 9] = np.nan
    k = rng.rand(5, 5).astype(float) + 0.05
    k /= k.sum()
    want = tsm.spatial_smooth_cube(torch.from_numpy(data), k)
    got = tpar.sharded_spatial_convolve(data, k, tmesh)
    _close(got, want, 3e-5, 3e-6)
    _close(got, jpar.sharded_spatial_convolve(data, k, jmesh), 3e-5, 3e-6)
    assert tmesh.counters["all_to_alls"] == 0


def test_sharded_interp_no_mask_branch(tmesh, jmesh):
    rng = np.random.RandomState(3)
    data = rng.rand(10, 8, 8).astype("f4")
    inax = np.linspace(0.0, 9.0, 10)
    outax = np.linspace(0.5, 8.5, 17)
    want = titp.interp_cube_spectral(torch.from_numpy(data), inax, outax)[0]
    got, inc = tpar.sharded_spectral_interpolate(data, inax, outax, tmesh,
                                                 include=None)
    jgot, _ = jpar.sharded_spectral_interpolate(data, inax, outax, jmesh)
    assert inc is None
    _close(got, want, 2e-5, 2e-6)
    _close(got, jgot, 2e-5, 2e-6)


def test_sharded_smooth_interp_boolean_mask_branch(tmp_path, tmesh, jmesh):
    """A stored BooleanArrayMask rides along the fused kernel (the
    include-carrying branch) and the interpolated mask matches."""
    path, data = make_cube_file(tmp_path, shape=(12, 8, 8))
    tc, jc = _read(path)
    inc = np.random.RandomState(4).rand(*data.shape) > 0.15
    tm = tc.with_mask(T.BooleanArrayMask(inc, wcs=tc.wcs, shape=data.shape),
                      inherit_mask=False)
    jm = jc.with_mask(J.BooleanArrayMask(inc, wcs=jc.wcs, shape=data.shape),
                      inherit_mask=False)
    sv = np.asarray(tc.spectral_axis.value)
    grid = np.linspace(sv[1], sv[-2], 15)
    k = np.hanning(5)[1:-1]
    k /= k.sum()
    want = tm.spectral_interpolate(T.Quantity(grid, tc.spectral_unit),
                                   smooth_kernel=k)
    sc = tpar.ShardedCube(tm, tmesh)
    got = sc.spectral_interpolate(T.Quantity(grid, tc.spectral_unit),
                                  smooth_kernel=k)
    jgot = jpar.ShardedCube(jm, jmesh).spectral_interpolate(
        J.Quantity(grid, jc.spectral_unit), smooth_kernel=k)
    _close(got.cube.filled_data[:], want.filled_data[:], 2e-5, 2e-6)
    _close(got.cube.filled_data[:], jgot.cube.filled_data[:], 2e-5, 2e-6)
    np.testing.assert_array_equal(got.cube.get_mask_array(),
                                  want.get_mask_array())
    np.testing.assert_array_equal(got.cube.get_mask_array(),
                                  np.asarray(jgot.cube.get_mask_array()))


def test_sharded_vr_convolve_fft_fallback(tmp_path, tmesh, jmesh):
    """A kernel too large for a tile takes the reshard + FFT route and
    matches the unsharded result."""
    path, data = make_vr_cube_file(tmp_path, shape=(6, 12, 12))
    tc, jc = _read(path)
    target = tc.common_beam()
    big = T.Beam(major=target.major * 12, minor=target.minor * 12,
                 pa=target.pa)
    jt = jc.common_beam()
    jbig = J.Beam(major=jt.major * 12, minor=jt.minor * 12, pa=jt.pa)
    want = tc.convolve_to(big)
    got = tpar.ShardedCube(tc, tmesh).convolve_to(big)
    jgot = jpar.ShardedCube(jc, jmesh).convolve_to(jbig)
    _close(got.cube.unmasked_data[:], want.unmasked_data[:], 2e-4, 2e-6)
    _close(got.cube.unmasked_data[:], jgot.cube.unmasked_data[:], 2e-4,
           2e-6)


def test_read_use_dask_returns_sharded_cube(tmp_path, tmesh):
    """SpectralCube.read(use_dask=True) gives a ShardedCube on the default
    mesh without changing any cube in place; rechunk, statistics and the
    display are reachable from it."""
    path, data = make_cube_file(tmp_path, "dask.fits", shape=(6, 8, 10))
    with tpar.use_mesh(tmesh):
        sc = T.SpectralCube.read(path, use_dask=True, device="cpu")
    assert isinstance(sc, tpar.ShardedCube) and sc.cmesh is tmesh
    stats = sc.statistics()
    finite = data[np.isfinite(data)]
    np.testing.assert_allclose(float(stats["mean"].value), finite.mean(),
                               rtol=1e-6)
    re = sc.rechunk("spectral")
    assert isinstance(re, tpar.ShardedCube) and re._data.layout == "spectral"
    assert re.statistics()["npts"] == stats["npts"]
    assert len({str(s.device) for s in sc._data.addressable_shards}) == 1
    assert len(sc._data.addressable_shards) == tmesh.n_devices
    assert sc.display_sharding() == "spatial"
    with pytest.warns(T.utils.NotImplementedWarning if hasattr(T, "utils")
                      else Warning):
        with sc.use_dask_scheduler("threads") as same:
            assert same is sc
    plain = T.SpectralCube.read(path, device="cpu")
    assert not isinstance(plain, tpar.ShardedCube)
    np.testing.assert_array_equal(_np(plain.unmasked_data[:]),
                                  _np(sc.cube.unmasked_data[:]))
    saved = sc.rechunk("spatial", save_to_tmp_dir=True)
    np.testing.assert_array_equal(_np(saved.cube.unmasked_data[:]),
                                  _np(plain.filled_data[:]))


def test_unsharded_dask_api(tmp_path, tmesh):
    """The cube's own dask-API names: rechunk (a store round trip with
    save_to_tmp_dir), use_dask_scheduler, display_dask_array, and
    to_sharded onto a mesh."""
    from spectral_cube_tpu_torch.utils import NotImplementedWarning
    path, data = make_cube_file(tmp_path, shape=(4, 6, 8))
    tc = T.SpectralCube.read(path, device="cpu")
    assert tc.rechunk() is tc
    back = tc.rechunk(save_to_tmp_dir=True)
    np.testing.assert_array_equal(_np(back.filled_data[:]),
                                  _np(tc.filled_data[:]))
    with pytest.warns(NotImplementedWarning):
        with tc.use_dask_scheduler() as same:
            assert same is tc
    tc.display_dask_array()
    sc = tc.to_sharded(tmesh)
    assert isinstance(sc, tpar.ShardedCube) and sc.cmesh is tmesh
    np.testing.assert_array_equal(_np(sc.cube.unmasked_data[:]),
                                  _np(tc.unmasked_data[:]))


def test_sharded_reproject_halo_matches_unsharded(tmesh, jmesh, big_cube):
    """A separable offset mapping: the halo strategy (resample2 on every
    shard) equals the unsharded resample, and moves data by halo
    exchanges only."""
    data, _, _ = big_cube
    nchan, ny, nx = data.shape
    zs = np.arange(nchan, dtype=np.float64)
    ys, xs = _offset_mapping(ny, nx)
    want = trg._bilinear_spatial_then_linear_z(torch.from_numpy(data), zs,
                                               ys, xs, 1)
    K.reset_launch_counts()
    got = tpar.sharded_reproject(data, zs, ys, xs, tmesh, order=1)
    assert tmesh.counters == {"halo_exchanges": 2, "all_to_alls": 0,
                              "gathers": 0}
    _close(got, want, 1e-6, 1e-7)
    _close(got, jpar.sharded.sharded_reproject(data, zs, ys, xs, jmesh,
                                               order=1), 1e-6, 1e-7)


def _rotated(ny, nx, deg=3.0):
    theta = np.deg2rad(deg)
    c, s = np.cos(theta), np.sin(theta)
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
    return (c * (yy - cy) - s * (xx - cx) + cy,
            s * (yy - cy) + c * (xx - cx) + cx)


@pytest.mark.parametrize("case", ["rotated", "order0", "beyond_halo",
                                  "spectral", "resizing"])
def test_sharded_reproject_routes(tmesh, jmesh, big_cube, case):
    """Every mapping of the JAX reproject tests: rotated, order 0 and a
    shift beyond one tile's reach take the reshard strategy (all-to-alls,
    never a gather); a regridded spectral axis and a downsampling
    separable mapping the halo one.  Each equals the unsharded resample
    and agrees with JAX's."""
    data, _, _ = big_cube
    nchan, ny, nx = data.shape
    zs = np.arange(nchan, dtype=np.float64)
    order = 1
    if case == "rotated":
        ys, xs = _rotated(ny, nx)
    elif case == "order0":
        ys, xs = _offset_mapping(ny, nx)
        order = 0
    elif case == "beyond_halo":
        # x tiles are 8 columns on the 2x4 mesh: a 20-column shift reaches
        # two tiles away
        ys, xs = _offset_mapping(ny, nx, dy=0.37, dx=-20.0)
    elif case == "spectral":
        zs = np.arange(20, dtype=np.float64) * 0.5 + 0.25
        ys, xs = _offset_mapping(ny, nx, dy=-0.5, dx=1.25)
    else:
        ys = np.broadcast_to(np.arange(ny // 2, dtype=np.float64)[:, None]
                             * 2 + 0.25, (ny // 2, nx // 2)).copy()
        xs = np.broadcast_to(np.arange(nx // 2, dtype=np.float64)[None, :]
                             * 2 + 0.75, (ny // 2, nx // 2)).copy()
    want = trg._bilinear_spatial_then_linear_z(torch.from_numpy(data), zs,
                                               ys, xs, order)
    got = tpar.sharded_reproject(data, zs, ys, xs, tmesh, order=order)
    resharded = case in ("rotated", "order0", "beyond_halo")
    assert (tmesh.counters["all_to_alls"] > 0) == resharded
    # the downsampling mapping's tiles read their own tiles only
    assert (tmesh.counters["halo_exchanges"] > 0) == (case == "spectral")
    assert tmesh.counters["gathers"] == 0
    _close(got, want, 1e-6, 1e-7)
    jgot = jpar.sharded.sharded_reproject(data, zs, ys, xs, jmesh, order=order)
    _close(got, jgot, 1e-6, 1e-7)


def test_sharded_reproject_refuses_spline_orders(tmesh, big_cube):
    data, _, _ = big_cube
    ys, xs = _offset_mapping(24, 32)
    with pytest.raises(ValueError, match="orders 0/1"):
        tpar.sharded_reproject(data, np.arange(16.0), ys, xs, tmesh,
                               order=3)


def test_sharded_cube_reproject_header(tmp_path, tmesh, jmesh):
    """ShardedCube.reproject(header) == cube.reproject (the pipeline's last
    stage), a spline order too (shard by shard, no gather)."""
    path, _ = make_cube_file(tmp_path, name="srep.fits", shape=(6, 16, 16))
    tc, jc = _read(path)
    hdr = tc.header
    hdr["CRVAL1"] = float(hdr["CRVAL1"]) + 0.3 * float(hdr["CDELT1"])
    hdr["CRVAL2"] = float(hdr["CRVAL2"]) + 0.6 * float(hdr["CDELT2"])
    want = tc.reproject(hdr)
    got = tpar.ShardedCube(tc, tmesh).reproject(hdr)
    jhdr = jc.header
    jhdr["CRVAL1"] = float(jhdr["CRVAL1"]) + 0.3 * float(jhdr["CDELT1"])
    jhdr["CRVAL2"] = float(jhdr["CRVAL2"]) + 0.6 * float(jhdr["CDELT2"])
    jgot = jpar.ShardedCube(jc, jmesh).reproject(jhdr)
    _close(got.cube.unmasked_data[:], want.unmasked_data[:], 1e-5, 1e-6)
    _close(got.cube.unmasked_data[:], jgot.cube.unmasked_data[:], 1e-5,
           1e-6)
    assert got.cube.wcs.check_equality(want.wcs, wcs_tolerance=1e-9)
    np.testing.assert_array_equal(got.cube.get_mask_array(),
                                  want.get_mask_array())
    # a CRPIX shift is a translation: the halo strategy, though the WCS
    # round trip leaves ~1e-12 px of noise in the maps
    shifted = tc.header
    shifted["CRPIX1"] = float(shifted["CRPIX1"]) + 0.37
    shifted["CRPIX2"] = float(shifted["CRPIX2"]) - 0.61
    tmesh.reset_counters()
    got = tpar.ShardedCube(tc, tmesh).reproject(shifted)
    assert tmesh.counters == {"halo_exchanges": 2, "all_to_alls": 0,
                              "gathers": 0}
    _close(got.cube.unmasked_data[:], tc.reproject(shifted)
           .unmasked_data[:], 1e-5, 1e-6)
    tmesh.reset_counters()
    rot = tpar.ShardedCube(tc, tmesh).reproject(hdr, order="bicubic")
    assert tmesh.counters["gathers"] == 0
    _close(rot.cube.unmasked_data[:],
           tc.reproject(hdr, order="bicubic").unmasked_data[:], 1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sharded_mad_std_is_the_unsharded_value(tmesh, dtype):
    """mad_std found over the mesh (each shard's values sorted, a
    bisection on their bit patterns, counts summed per step) is the
    unsharded value exactly, for odd and even counts, negative values,
    ties and signed zeros, and a mask; a float64 tensor keyed by its
    64-bit patterns, as the unsharded float64 cube reduces it."""
    from spectral_cube_tpu_torch.ops import reductions as rd
    rng = np.random.RandomState(11)
    for n_nan, ties in ((0, False), (1, False), (1, True)):
        data = (rng.randn(9, 10, 13) * 3 - 1).astype(dtype)
        if ties:
            # repeated values, zeros of both signs at the median
            data = np.round(data * 0.3).astype(dtype)
            data[data == 0] *= np.where(rng.rand(int((data == 0).sum()))
                                        > 0.5, -1, 1).astype(dtype)
        data[0, 0, :n_nan] = np.nan
        inc = rng.rand(*data.shape) > 0.3
        t = torch.from_numpy(data)
        for include in (None, inc):
            want = rd.masked_mad_std(t, rd.valid_mask(
                t, None if include is None else torch.from_numpy(include)))
            got = tpar.sharded_mad_std(t, tmesh, include=include)
            assert got.dtype == want.dtype == t.dtype
            assert float(got) == float(want)
    assert tmesh.counters == {"halo_exchanges": 0, "all_to_alls": 0,
                              "gathers": 0}


def test_sharded_pipeline_float64_cube(tmp_path, tmesh, jmesh):
    """``run_pipeline(cmesh=)`` on a float64 tensor cube, as the port's
    unsharded cube keeps one: its noise, the sharded mad_std of the
    float64 values, is the unsharded value exactly, and the run equals the
    unsharded float64 run (the masked cube bit for bit, the moments within
    rtol 1e-6, the statistics, computed in float32 as the moments kernel
    computes them, within the JAX tests' 1e-5) with no gather of the cube;
    the noise is within rtol 1e-6 of the JAX package's, which holds the
    cube in float32."""
    path, data = make_cube_file(tmp_path, shape=(12, 9, 10))
    tc, jc = _read(path)
    c64 = tc._new_cube_with(data=tc._data.double())
    assert c64.dtype == torch.float64
    noise = tpar.ShardedCube(c64, tmesh).mad_std()
    assert float(noise.value) == float(c64.mad_std().value)
    assert float(noise.value) == pytest.approx(float(jc.mad_std().value),
                                               rel=1e-6)
    tmesh.reset_counters()
    res = T.run_pipeline(c64, tmesh, snr_threshold=1.0)
    assert tmesh.counters["gathers"] == 0
    ref = T.run_pipeline(c64, snr_threshold=1.0)
    np.testing.assert_array_equal(_np(res["cube"].cube.filled_data[:]),
                                  _np(ref["cube"].filled_data[:]))
    for got, want in zip(res["moments"], ref["moments"]):
        _close(got.value, want.value, 1e-6)
    for key in ("npts", "mean", "sigma", "sum", "max", "min", "rms"):
        assert float(_np(res["statistics"][key])) == pytest.approx(
            float(_np(ref["statistics"][key])), rel=1e-5)


def test_with_mask_and_comparisons_stay_sharded(tmp_path, tmesh):
    """``sc > q`` is a data-local mask each shard evaluates; a boolean
    array is sharded beside the data; neither gathers the cube."""
    path, data = make_cube_file(tmp_path, shape=(8, 10, 12))
    tc = T.SpectralCube.read(path, device="cpu")
    sc = tpar.ShardedCube(tc, tmesh)
    q = T.Quantity(0.4, tc.unit)
    arr = np.random.RandomState(1).rand(*data.shape) > 0.2
    for op in ("__gt__", "__ge__", "__lt__", "__le__"):
        m = sc.with_mask(getattr(sc, op)(q)).with_mask(arr)
        u = tc.with_mask(getattr(tc, op)(q)).with_mask(arr)
        _close(m.moment_maps()[0].value, u.moment0().value, 1e-5)
    assert tmesh.counters["gathers"] == 0
    np.testing.assert_array_equal(m.cube.get_mask_array(),
                                  u.get_mask_array())
    with pytest.raises(ValueError, match="Quantity"):
        sc > 0.4


class _Entered(Exception):
    pass


class _OnCard:
    """Stands for a tensor on the fourth card: only its device is read
    before a wrapper makes that device current."""
    device = torch.device("cuda", 3)


def test_kernel_wrappers_enter_the_tensors_device(monkeypatch):
    """Every kernel wrapper (and the bare launches) makes its tensor's
    device current before any CUDA call, so that a shard on cuda:3
    launches there and the C side's per-launch cudaFuncSetAttribute and
    device queries address that card; a CPU tensor enters no device.  The
    CUDA calls are stubbed: entering a device records it and stops."""
    entered = []

    class Recorder:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            entered.append(self.device)
            raise _Entered

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Recorder)
    wrappers = dict(K.WRAPPERS)
    wrappers["resample2.launch"] = K.resample2.launch
    wrappers["banded_matmul.launch"] = K.banded_matmul.launch
    assert len(wrappers) == 12
    for name, fn in wrappers.items():
        entered.clear()
        with pytest.raises(_Entered):
            fn(_OnCard(), None, None, None, None, None, None, None)
        assert entered == [torch.device("cuda", 3)], name
    entered.clear()
    x = torch.ones((3, 4, 5))
    planes, cnt = K.moments.moments_planes(x, np.zeros(3))
    assert entered == [] and int(cnt.sum()) == 60


@pytest.mark.parametrize("tile", [(384, 384), (256, 256), (7, 3)])
def test_kernel_plans_at_shard_shapes(tile):
    """The launch plans the shards see: an aligned 2x2 (384 x 384) or
    3x3 (256 x 256) tile of a 768 x 768 plane plans as the whole plane
    does (16-byte copies), a ragged padded tile of an odd width takes the
    4-byte copies; the sigma clip's plan depends on the channels alone
    (its register class, 32 channels a lane)."""
    from spectral_cube_tpu_torch.kernels import (moments as km,
                                                 sigma_clip as kc,
                                                 smooth_interp as ks)
    npix = tile[0] * tile[1]
    whole, part = km.plan(768 * 768), km.plan(npix)
    assert part.blocks == -(-npix // km.THREADS)
    aligned = npix % 4 == 0
    assert (part.staging == whole.staging) == aligned
    assert part.smem == whole.smem
    for nin in (623, 312):
        got, want = ks.plan(nin, npix), ks.plan(nin, 768 * 768)
        assert got is not None
        assert (got.tile, got.stages, got.smem) == \
            (want.tile, want.stages, want.smem)
        assert (got.staging == "cp.async16") == aligned
        assert kc.plan(nin).R == (1 << (nin - 1).bit_length()) // 32
