"""Torch port: the cube methods a ShardedCube runs shard by shard.

Each method of the four steps (a: metadata and element-wise steps, b:
reductions along the spectral axis and over the cube, c: the spectral
smoothing family, d: the spatial axes through the spectral layout) runs on
the port's 8-position CPU mesh (``CubeMesh(devices=['cpu'] * 8)``, 2 x 4)
over cubes whose shapes divide the mesh and do not, under four masks (none
but the read's finiteness, ``sc > q``, a boolean array, and a stored
include after ``sigma_clip_spectrally``).  Each call must leave the mesh's
``gathers`` counter at 0; steps a-c move no data between positions, step d
reshards by all-to-alls.  Each result is held against the port's unsharded
call and against the JAX package's ShardedCube on its 8-device virtual
CPU mesh:

- ``exact``: bit for bit, where each output element's arithmetic is the
  same (order statistics, extremes, arg-extremes, per-block transforms);
- ``sum``: within rtol 1e-6 with an equal NaN pattern, where a sum runs
  over an axis the mesh splits or is a torch reduction whose plan follows
  the block's shape (and so, on the CPU, the moments kernel's plain
  version, whose sums follow the tile's shape);
- ``moment``: a central moment of order >= 2 (order >= 3 along the
  spectral axis), whose terms cancel, within 1e-6 of the sum of its
  terms' magnitudes (:func:`_term_scale`).

The JAX results are held at the JAX tests' tolerances (rtol 1e-5, atol
1e-6; the term bound at 1e-5).
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu import parallel as jpar

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch.ops import moments as tmom

from conftest import make_cube_file, make_vr_cube_file

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

SHAPES = [(8, 8, 16), (9, 10, 10), (11, 5, 9)]
MASKS = ["none", "gt", "bool", "stored"]
THRESHOLD = 0.3
CLIP = 2.0


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) != 8:
        pytest.skip("multi-device tests need the 8-device virtual mesh")
    return jpar.CubeMesh()


@pytest.fixture(scope="module")
def tmesh():
    return tpar.CubeMesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def cubes(tmp_path_factory, tmesh, jmesh):
    """``cubes(shape, mask)`` -> (ShardedCube, the unsharded cube, the JAX
    ShardedCube), made once a module."""
    made = {}
    tmp = tmp_path_factory.mktemp("sharded_methods")

    def get(shape, mask):
        if (shape, mask) not in made:
            made[shape, mask] = _make(tmp, shape, mask, tmesh, jmesh)
        return made[shape, mask]
    return get


def _make(tmp, shape, mask, tmesh, jmesh):
    seed = sum(shape)
    path, _ = make_cube_file(tmp, name="c%d_%d_%d.fits" % shape,
                             shape=shape, seed=seed)
    tc = T.SpectralCube.read(path, device="cpu")
    jc = J.SpectralCube.read(path)
    sc = tpar.ShardedCube(tc, tmesh)
    if mask == "gt":
        return (sc.with_mask(sc > T.Quantity(THRESHOLD, tc.unit)),
                tc.with_mask(tc > T.Quantity(THRESHOLD, tc.unit)),
                jpar.ShardedCube(jc.with_mask(
                    jc > J.Quantity(THRESHOLD, jc.unit)), jmesh))
    if mask == "bool":
        arr = np.random.RandomState(seed).rand(*shape) > 0.25
        return (sc.with_mask(arr), tc.with_mask(arr),
                jpar.ShardedCube(jc.with_mask(arr), jmesh))
    if mask == "stored":
        # the sharded clip's result with its finiteness as a stored
        # include; the unsharded and JAX cubes hold it as a boolean mask
        clipped = sc.sigma_clip_spectrally(CLIP)
        uclipped = tc.sigma_clip_spectrally(CLIP)
        data = clipped._data.gather(torch.device("cpu"))
        assert torch.equal(torch.isnan(data), torch.isnan(uclipped._data))
        inc = torch.isfinite(uclipped._data)
        stored = tpar.ShardedCube._from_parts(
            tmesh, clipped._data, clipped._template,
            include=clipped._data.map(torch.isfinite))
        return (stored,
                uclipped.with_mask(T.BooleanArrayMask(
                    inc, wcs=tc.wcs, shape=shape), inherit_mask=False),
                jpar.ShardedCube(jc._new_cube_with(
                    data=jnp.asarray(uclipped._data.numpy()),
                    mask=J.BooleanArrayMask(inc.numpy(), wcs=jc.wcs,
                                            shape=shape)), jmesh))
    return sc, tc, jpar.ShardedCube(jc, jmesh)


def _np(x):
    if isinstance(x, tuple):
        return np.array(x)
    x = getattr(x, "value", x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_cube(x):
    return isinstance(x, (tpar.ShardedCube, jpar.ShardedCube,
                          T.BaseSpectralCube, J.BaseSpectralCube))


def _cube_arrays(x):
    """(filled data, mask array) of a cube result, sharded or not."""
    c = x.cube if isinstance(x, (tpar.ShardedCube, jpar.ShardedCube)) else x
    return _np(c.filled_data[:]), np.asarray(c.get_mask_array())


def _exact(name, got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    assert got.dtype == want.dtype, name
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f"), name


def _near(name, got, want, rtol, atol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol,
                               err_msg=name)


def _term_scale(cube, order, axis):
    """Per output element, the float64 sum over the terms of
    ``moment_generic``'s order-``order`` central moment (over s0) of
    |w| (|x - m1| + |x|)^order: a float32 term's rounding, that of the
    centroid m1 (relative to |x|) included, is a few eps of it."""
    data = cube._data.double().numpy()
    valid = np.isfinite(data) & np.broadcast_to(
        cube._include_view().numpy(), data.shape)
    coords, dx = cube._moment_coords(axis)
    x = np.asarray(coords, dtype=float)
    if x.ndim == 1:
        x = x.reshape([-1 if i == axis else 1 for i in range(3)])
    w = np.where(valid, data, 0.0) * dx
    s0 = w.sum(axis)
    with np.errstate(invalid="ignore", divide="ignore"):
        m1 = (w * x).sum(axis) / s0
        return (np.abs(w) * (np.abs(x - np.expand_dims(m1, axis))
                             + np.abs(x)) ** order).sum(axis) / np.abs(s0)


def _hold(name, kind, got, want, jgot, unsharded):
    """``got`` against the unsharded ``want`` as ``kind`` says, and
    against the JAX result ``jgot`` at the JAX tests' tolerances."""
    if _is_cube(got):
        gd, gm = _cube_arrays(got)
        wd, wm = _cube_arrays(want)
        jd, jm = _cube_arrays(jgot)
        c = got.cube
        assert c.shape == want.shape, name
        assert str(c.unit) == str(want.unit), name
        assert c.wcs.to_header() == want.wcs.to_header(), name
        np.testing.assert_array_equal(gm, wm, err_msg=name)
        np.testing.assert_array_equal(gm, jm, err_msg=name)
        got, want, jgot = gd, wd, jd
    if kind == "exact":
        _exact(name, got, want)
    elif kind == "sum":
        _near(name, got, want, 1e-6)
    else:
        order, axis = kind
        scale = _term_scale(unsharded, order, axis)
        g, w, j = _np(got), _np(want), _np(jgot)
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        fin = ~np.isnan(w)
        assert (np.abs(g - w)[fin] <= 1e-6 * scale[fin]).all(), name
        assert (np.abs(g - j)[fin] <= 1e-5 * scale[fin]).all(), name
        return
    _near(name + " vs JAX", got, jgot, 1e-5, 1e-6)


def _run(cubes, tmesh, case, fn, kind, a2a):
    """``fn`` on every shape and mask: the gathers and all-to-alls it
    counts (``a2a`` True: some; False: none; None: not held), and its
    result held by :func:`_hold`."""
    for shape in SHAPES:
        for mask in MASKS:
            sc, uc, jsc = cubes(shape, mask)
            name = f"{case} {shape} {mask}"
            tmesh.reset_counters()
            got = fn(sc, T)
            counters = dict(tmesh.counters)
            assert counters["gathers"] == 0, (name, counters)
            if a2a is not None:
                assert (counters["all_to_alls"] > 0) == a2a, (name, counters)
            if _is_cube(got):
                assert isinstance(got, tpar.ShardedCube), name
            _hold(name, kind, got, fn(uc, T), fn(jsc, J), uc)


def _slab(c, pkg):
    sv = np.asarray(c.spectral_axis.value)
    return c.spectral_slab(pkg.Quantity(sv[2], c.spectral_unit),
                           pkg.Quantity(sv[-3], c.spectral_unit))


STEP_A = {
    "with_fill_value": lambda c, p: c.with_fill_value(0.0),
    "with_spectral_unit": lambda c, p: c.with_spectral_unit("m/s"),
    "to_K": lambda c, p: c.to("K"),
    "spectral_slab": _slab,
    "world_extrema": lambda c, p: c.world_extrema,
    "longitude_extrema": lambda c, p: c.longitude_extrema,
    "latitude_extrema": lambda c, p: c.latitude_extrema,
    "spectral_extrema": lambda c, p: c.spectral_extrema,
    "spatial_coordinate_map": lambda c, p: np.stack(
        [np.asarray(q.value) for q in c.spatial_coordinate_map]),
}


@pytest.mark.parametrize("case", sorted(STEP_A))
def test_step_a_metadata_and_elementwise(cubes, tmesh, case):
    """Metadata and element-wise steps: block by block, no exchange; the
    data of each result bit for bit the unsharded call's."""
    _run(cubes, tmesh, case, STEP_A[case], "exact", False)


def _reduction(name, axis, **kw):
    return lambda c, p: getattr(c, name)(axis=axis, **kw)


STEP_B = {}
for _name in ("sum", "mean", "std"):
    for _axis in (0, None, (1, 2)):
        STEP_B[f"{_name}_{_axis}"] = (_reduction(_name, _axis), "sum")
for _name in ("max", "min"):
    for _axis in (0, None, (1, 2)):
        STEP_B[f"{_name}_{_axis}"] = (_reduction(_name, _axis), "exact")
for _name in ("median", "mad_std"):
    for _axis in (0, None):
        STEP_B[f"{_name}_{_axis}"] = (_reduction(_name, _axis), "exact")
for _axis in (0, None):
    STEP_B[f"percentile_{_axis}"] = (
        lambda c, p, a=_axis: c.percentile(30, axis=a), "exact")
    STEP_B[f"argmax_{_axis}"] = (_reduction("argmax", _axis), "exact")
    STEP_B[f"argmin_{_axis}"] = (_reduction("argmin", _axis), "exact")
STEP_B.update({
    "moment0": (lambda c, p: c.moment0(), "sum"),
    "moment1": (lambda c, p: c.moment1(), "sum"),
    "moment2": (lambda c, p: c.moment2(), "sum"),
    "moment_order3": (lambda c, p: c.moment(order=3, axis=0), (3, 0)),
    "linewidth_sigma": (lambda c, p: c.linewidth_sigma(), "sum"),
    "linewidth_fwhm": (lambda c, p: c.linewidth_fwhm(), "sum"),
})


@pytest.mark.parametrize("case", sorted(STEP_B))
def test_step_b_spectral_and_global_reductions(cubes, tmesh, case):
    """Reductions along the spectral axis (each tile's whole spectra),
    over the cube (partials reduced over the mesh, order statistics by
    the bisection) and sums and extremes over the planes (partial
    spectra), the moments (kernel #1/#2 once a shard): no exchange."""
    fn, kind = STEP_B[case]
    _run(cubes, tmesh, case, fn, kind, False)


STEP_C = {
    "spectral_smooth": (lambda c, p: c.spectral_smooth(
        np.array([0.2, 0.5, 0.3])), "sum"),
    "spectral_smooth_median": (lambda c, p: c.spectral_smooth_median(
        3, raise_error_jybm=False), "exact"),
    "spectral_filter": (lambda c, p: c.spectral_filter(
        3, ndi.uniform_filter), "exact"),
    "downsample_axis_0_mean": (lambda c, p: c.downsample_axis(2, 0),
                               "exact"),
    "downsample_axis_0_median": (lambda c, p: c.downsample_axis(
        3, 0, estimator="median", truncate=True), "exact"),
}


@pytest.mark.parametrize("case", sorted(STEP_C))
def test_step_c_spectral_smoothing(cubes, tmesh, case):
    """The spectral smoothing family on each tile's filled data, no
    exchange: the banded matmul of ``spectral_smooth`` (a library product
    whose plan follows the block's shape) within rtol 1e-6, the rest bit
    for bit."""
    fn, kind = STEP_C[case]
    _run(cubes, tmesh, case, fn, kind, False)


STEP_D = {}
for _name in ("sum", "mean", "std"):
    for _axis in (1, 2, (0, 1), (0, 2)):
        STEP_D[f"{_name}_{_axis}"] = (_reduction(_name, _axis), "sum")
for _name in ("max", "min", "median", "mad_std", "argmax", "argmin"):
    for _axis in (1, 2):
        STEP_D[f"{_name}_{_axis}"] = (_reduction(_name, _axis), "exact")
for _name in ("max", "min", "median", "mad_std"):
    for _axis in ((0, 1), (0, 2)):
        STEP_D[f"{_name}_{_axis}"] = (_reduction(_name, _axis), "exact")
for _name in ("median", "mad_std"):
    STEP_D[f"{_name}_(1, 2)"] = (_reduction(_name, (1, 2)), "exact")
for _axis in (1, (0, 2), (1, 2)):
    STEP_D[f"percentile_{_axis}"] = (
        lambda c, p, a=_axis: c.percentile(70, axis=a), "exact")
for _order in (0, 1, 2):
    for _axis in (1, 2):
        STEP_D[f"moment{_order}_axis{_axis}"] = (
            lambda c, p, o=_order, a=_axis: c.moment(order=o, axis=a),
            "sum" if _order < 2 else (_order, _axis))
STEP_D.update({
    "spatial_smooth_median": (lambda c, p: c.spatial_smooth_median(
        3, raise_error_jybm=False), "exact"),
    "spatial_filter": (lambda c, p: c.spatial_filter(
        (3, 2), ndi.median_filter, raise_error_jybm=False), "exact"),
    "downsample_axis_1": (lambda c, p: c.downsample_axis(2, 1), "exact"),
    "downsample_axis_2_max": (lambda c, p: c.downsample_axis(
        3, 2, estimator="max"), "exact"),
})


@pytest.mark.parametrize("case", sorted(STEP_D))
def test_step_d_spatial_axes(cubes, tmesh, case):
    """Methods that need whole planes: each position's slab of the
    spectral layout (all-to-alls, never a gather), the unsharded method
    on it (order statistics over the planes too); with the spectral axis
    in a tuple, each slab's partials or its values' bisection over the
    mesh."""
    fn, kind = STEP_D[case]
    _run(cubes, tmesh, case, fn, kind, True)


@pytest.mark.parametrize("spatial_only", [False, True])
def test_step_d_minimal_subcube(cubes, tmesh, spatial_only):
    """The bounding box of the included voxels from each block's any()
    profiles, then the cut (spatially each block of the box assembled
    from the parts that overlap it, no all-to-all), bit for bit the
    unsharded subcube, its WCS and mask included; also a box smaller than
    the cube."""
    fn = (lambda c, p: c.minimal_subcube(spatial_only=spatial_only))
    _run(cubes, tmesh, "minimal_subcube", fn, "exact", None)
    sc, uc, jsc = cubes(SHAPES[1], "none")
    box = np.zeros(uc.shape, bool)
    box[2:7, 3:8, 1:6] = True
    tmesh.reset_counters()
    got = sc.with_mask(box).minimal_subcube(spatial_only=spatial_only)
    assert tmesh.counters == {"halo_exchanges": 0, "all_to_alls": 0,
                              "gathers": 0}
    want = uc.with_mask(box).minimal_subcube(spatial_only=spatial_only)
    _hold("minimal_subcube box", "exact", got, want,
          jsc.with_mask(box).minimal_subcube(spatial_only=spatial_only), uc)
    assert got.shape == (uc.shape[0] if spatial_only else 5, 5, 5)


def test_moments_kernel_once_a_shard(tmp_path, tmesh, monkeypatch):
    """moment0, moment1, moment2, linewidth_sigma, linewidth_fwhm and
    moment_maps of one ShardedCube run the moments kernel's wrapper once
    a shard in all (the maps kept, as the unsharded ``_moments012`` is
    cached); a new ShardedCube runs it again."""
    path, _ = make_cube_file(tmp_path, shape=(8, 8, 16))
    tc = T.SpectralCube.read(path, device="cpu")
    calls = []
    wrapper = tmom.moments_planes

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return wrapper(*args, **kwargs)
    monkeypatch.setattr(tmom, "moments_planes", counted)
    sc = tpar.ShardedCube(tc.with_mask(tc > T.Quantity(0.2, tc.unit)), tmesh)
    maps = [sc.moment0(), sc.moment1(), sc.moment2(), sc.linewidth_sigma(),
            sc.linewidth_fwhm(), *sc.moment_maps()]
    assert calls == [(8, 4, 4)] * tmesh.n_devices
    assert all(np.isfinite(np.asarray(m.value)).any() for m in maps)
    tpar.ShardedCube(tc, tmesh).moment1()
    assert len(calls) == 2 * tmesh.n_devices


def test_progress_hooks_and_refusals(cubes, tmesh, tmp_path):
    """The progress hooks run once a spaxel (spectral filters) or once a
    channel (spatial filter) of the whole cube, not once a shard; a
    Jy/beam cube refuses spatial smoothing and a varying-resolution cube
    spectral smoothing, as unsharded; no block leaves its device."""
    sc, uc, _ = cubes(SHAPES[2], "none")
    tmesh.reset_counters()
    nchan, ny, nx = uc.shape
    ticks = []
    sc.spectral_smooth_median(3, raise_error_jybm=False,
                              update_function=lambda: ticks.append(1))
    assert len(ticks) == ny * nx
    ticks.clear()
    sc.spectral_filter(3, ndi.uniform_filter,
                       update_function=lambda: ticks.append(1))
    assert len(ticks) == ny * nx
    ticks.clear()
    sc.spatial_filter(3, ndi.uniform_filter, raise_error_jybm=False,
                      update_function=lambda: ticks.append(1))
    assert len(ticks) == nchan
    with pytest.raises(T.beams.BeamUnitsError):
        sc.spatial_smooth_median(3)
    path, _ = make_vr_cube_file(tmp_path, shape=(6, 4, 8))
    vr = tpar.ShardedCube(T.SpectralCube.read(path, device="cpu"), tmesh)
    with pytest.raises(AttributeError, match="spectrally smoothed"):
        vr.spectral_smooth(np.array([0.25, 0.5, 0.25]))
    assert tmesh.counters["gathers"] == 0


def test_vrsc_spectral_reductions_carry_the_average_beam(tmp_path, tmesh):
    """Along the spectral axis a varying-resolution cube's result carries
    the average of the good beams of the channels that hold an included
    voxel, as the unsharded ``average_beams(mask='compute')`` gives it,
    with one channel masked out entirely."""
    path, _ = make_vr_cube_file(tmp_path, shape=(6, 4, 8),
                                major_arcsec=np.linspace(1.0, 1.005, 6))
    tc = T.SpectralCube.read(path, device="cpu")
    tmesh.reset_counters()
    keep = np.ones(tc.shape, bool)
    keep[0] = False
    uc = tc.with_mask(keep)
    sc = tpar.ShardedCube(tc, tmesh).with_mask(keep)
    for got, want in ((sc.median(axis=0), uc.median(axis=0)),
                      (sc.moment0(), uc.moment0())):
        assert got.beam == want.beam
        _near("vrsc", got, want, 1e-6)
    assert sc.median(axis=0).beam != tpar.ShardedCube(tc, tmesh).median(
        axis=0).beam
    assert tmesh.counters["gathers"] == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32])
def test_sharded_order_statistics_other_types(tmesh, dtype):
    """The bisection keys every type the unsharded reductions order: a
    16-bit float's bits, an integer's value; complex and bool cubes are
    refused, as the unsharded reductions refuse them."""
    from spectral_cube_tpu_torch.ops import reductions as rd
    rng = np.random.RandomState(4)
    t = torch.from_numpy(rng.randn(9, 10, 13) * 40).to(dtype)
    valid = rd.valid_mask(t)
    assert torch.equal(tpar.sharded_mad_std(t, tmesh),
                       rd.masked_mad_std(t, valid))
    for q in (0, 12.5, 50, 100):
        assert torch.equal(tpar.sharded.sharded_percentile(t, q, tmesh),
                           rd.masked_percentile(t, valid, q))
    with pytest.raises(NotImplementedError, match="refuse"):
        tpar.sharded_mad_std(torch.zeros((4, 4, 4), dtype=torch.bool),
                             tmesh)


def test_save_to_tmp_dir_round_trips_the_result(cubes, tmesh):
    """``save_to_tmp_dir=True`` writes a method's sharded result to a
    temporary store and reads it back (block by block, no gather), as the
    unsharded method's option does."""
    sc, uc, _ = cubes(SHAPES[1], "gt")
    kern = np.array([0.25, 0.5, 0.25])
    tmesh.reset_counters()
    got = sc.spectral_smooth(kern, save_to_tmp_dir=True)
    assert tmesh.counters["gathers"] == 0
    assert isinstance(got, tpar.ShardedCube)
    _hold("save_to_tmp_dir", "exact", got,
          uc.spectral_smooth(kern, save_to_tmp_dir=True),
          sc.spectral_smooth(kern), uc)
