"""Torch port: the cube's reductions and the spectral operations in tiles,
as they run on a cube past 2**31 voxels.

``ops/reductions.SORT_CHUNK`` bounds the voxels one call of a reduction
along an axis holds at once; past it the cube is cut into tiles of whole
lanes (``reductions.lane_tiles``) of ``SORT_PIECE`` voxels, and a
whole-cube sum, mean, std, max, min or arg-extremum fills and reduces
``SUM_CHUNK`` flat elements at a time.  ``convolve1d_nan`` forms the
filled data, numerator and denominator a block of rows (or a tile of
spectra) at a time; the spectral median filter and ``sigma_clip_plain``
run on tiles of whole spectra.  Here the constants are set small by
``monkeypatch`` so that cubes of a few hundred voxels take many tiles and
pieces, and each result is held

- bit for bit against the same call with the default constants (one
  tile, one piece): each lane is reduced on its own, and a float32
  whole-cube sum keeps its float64 accumulation's order;
- against the JAX package's function on the same numpy inputs at its own
  tests' tolerances (``tests/test_torch_moments.py``: rtol 1e-6, atol
  1e-7; ``tests/test_torch_smoothing.py`` for the spectral operations).

"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.ops import reductions as jred
from spectral_cube_tpu.ops import smoothing as jsm

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.kernels import sigma_clip as kclip
from spectral_cube_tpu_torch.ops import reductions as rd
from spectral_cube_tpu_torch.ops import smoothing as tsm

from test_torch_card_scale import Calls, _largest_allocation

SHAPE = (9, 10, 13)
AXES = [0, 1, 2, None, (0, 1), (0, 2), (1, 2)]
Q = 37.5

FUNCS = {
    "sum": rd.masked_sum,
    "mean": rd.masked_mean,
    "std": rd.masked_std,
    "max": rd.masked_max,
    "min": rd.masked_min,
    "median": rd.masked_median,
    "percentile": lambda d, v, axis: rd.masked_percentile(d, v, Q,
                                                          axis=axis),
    "mad_std": rd.masked_mad_std,
    "argmax": rd.masked_argmax,
    "argmin": rd.masked_argmin,
}
JAX_FUNCS = {
    "sum": jred.masked_sum,
    "mean": jred.masked_mean,
    "std": jred.masked_std,
    "max": jred.masked_max,
    "min": jred.masked_min,
    "median": jred.masked_median,
    "percentile": lambda d, v, axis: jred.masked_percentile(d, v, Q,
                                                            axis=axis),
    "mad_std": jred.masked_mad_std,
    "argmax": jred.masked_argmax,
    "argmin": jred.masked_argmin,
}


def make_case(dtype, case, seed=7):
    """(data, include) numpy arrays of SHAPE: normal values with NaN and
    infinite voxels and an all-NaN spectrum, row and plane; ``include``
    None (``nan``), a random mask of the cube's shape (``include``), or a
    (1, ny, nx) mask that broadcasts along the spectral axis
    (``broadcast``)."""
    rng = np.random.RandomState(seed)
    data = (rng.standard_normal(SHAPE) * 3 + 1).astype(dtype)
    data[:, 2, 3] = np.nan
    data[4, 5, :] = np.nan
    data[6] = np.nan
    data[1, 0, :4] = np.nan
    data[3, 2, 5] = np.inf
    data[5, :, 7] = -np.inf
    include = None
    if case == "include":
        include = rng.rand(*SHAPE) > 0.3
    elif case == "broadcast":
        include = rng.rand(1, *SHAPE[1:]) > 0.3
    return data, include


def tensors(data, include):
    t = torch.from_numpy(data)
    inc = None if include is None else torch.from_numpy(include)
    return t, inc


def same_bits(a, b):
    """Two tensors of one shape and dtype hold the same bits."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    bits = rd._BITS[a.element_size()]
    return bool(torch.equal(a.contiguous().view(bits),
                            b.contiguous().view(bits)))


def small_pieces(monkeypatch, chunk=40, piece=24, sums=37):
    monkeypatch.setattr(rd, "SORT_CHUNK", chunk)
    monkeypatch.setattr(rd, "SORT_PIECE", piece)
    monkeypatch.setattr(rd, "SUM_CHUNK", sums)


def _jax(name, data, include, axis):
    jd = jnp.asarray(data)
    jv = jred.valid_mask(jd, None if include is None else jnp.asarray(
        np.broadcast_to(include, data.shape)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if name in ("argmax", "argmin") and axis is None:
            return np.asarray(JAX_FUNCS[name](jd.reshape(-1),
                                              jv.reshape(-1), axis=0))
        return np.asarray(JAX_FUNCS[name](jd, jv, axis=axis))


#: every reduction with every axis it takes (an arg-extremum one axis, or
#: the whole cube, as ``jnp.argmax`` does)
REDUCTIONS = [(name, axis) for name in FUNCS for axis in AXES
              if not (name.startswith("arg") and isinstance(axis, tuple))]


@pytest.mark.parametrize("case", ["nan", "include", "broadcast"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,axis", REDUCTIONS, ids=str)
def test_reductions_in_tiles_are_the_one_call(monkeypatch, name, axis,
                                              dtype, case):
    """Every reduction along every axis and tuple of axes, and over the
    whole cube, with the cube cut into tiles of whole lanes and pieces of
    a few elements (rows cut, a lane to a tile, a broadcast include), is
    the one call's bit for bit, but for two: torch sums a lane in an
    order that follows the number of lanes, so a sum, mean or std along
    an axis is held within rtol 1e-6 (float32) or 1e-12 (float64), and a
    float64 whole-cube sum, rounded once a piece, within 1e-12; and the
    JAX package's within its tolerance (argmax/argmin exactly)."""
    data, include = make_case(dtype, case)
    t, inc = tensors(data, include)
    valid = rd.valid_mask(t, inc)
    fn = FUNCS[name]
    want = fn(t, valid, axis=axis)
    small_pieces(monkeypatch)
    if axis is not None:
        axes = axis if isinstance(axis, tuple) else (axis,)
        assert len(list(rd.lane_tiles(t.shape, axes))) > 1
    got = fn(t, valid, axis=axis)
    # the include as it broadcasts, not expanded
    got_b = None if inc is None or inc.shape == t.shape else fn(
        t, rd.finite(t) & inc, axis=axis)
    summed = name in ("sum", "mean", "std") and (
        axis is not None or dtype == np.float64)
    for g in (got, got_b):
        if g is None:
            continue
        if summed:
            assert g.dtype == want.dtype
            tol = 1e-6 if dtype == np.float32 else 1e-12
            np.testing.assert_allclose(g.numpy(), want.numpy(),
                                       equal_nan=True, rtol=tol, atol=tol)
        else:
            assert same_bits(g, want), (name, g, want)
    ref = _jax(name, data, include, axis)
    if name in ("argmax", "argmin"):
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        # tests/test_torch_smoothing.py's 1e-6 / 1e-6: a sum of mixed
        # signs lands near zero
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)


@pytest.mark.parametrize("view", ["cut", "strided", "transposed"])
def test_whole_cube_pieces_of_a_strided_view(monkeypatch, view):
    """A strided view's whole-cube sum and std are read in flat pieces of
    SUM_CHUNK elements (each a copy of those elements alone, never of the
    cube) in the view's order, its max and argmax on the pieces of the
    order statistics (views): the one call's bit for bit."""
    data, include = make_case(np.float32, "include")
    t, inc = tensors(data, include)
    pick = {"cut": lambda x: x[:, 2:8, 3:11],
            "strided": lambda x: x[::2, :, ::3],
            "transposed": lambda x: x.permute(2, 1, 0)}[view]
    d, v = pick(t), pick(rd.valid_mask(t, inc))
    names = ("sum", "std", "max", "argmax")
    want = {n: FUNCS[n](d, v, axis=None) for n in names}
    small_pieces(monkeypatch, chunk=13, piece=9, sums=11)
    assert len(list(rd._pieces(d))) > 1
    flat = torch.cat([p for _, p, _ in rd._whole_pieces(d, v)])
    assert torch.equal(torch.isnan(flat), torch.isnan(d.reshape(-1)))
    for n in names:
        assert same_bits(FUNCS[n](d, v, axis=None), want[n]), n


def test_lane_tiles_cover_the_cube_in_order():
    """Tiles keep the reduced axes whole, hold at most SORT_PIECE voxels
    (one lane where a lane is larger), and cover the array once; below
    SORT_CHUNK the array is one tile.  A cube past 2**31 voxels (an
    expanded tensor here) is cut into tiles a device sort takes."""
    x = torch.arange(float(np.prod(SHAPE))).reshape(SHAPE)
    for axes in ((0,), (1,), (2,), (0, 1), (0, 2), (1, 2)):
        for piece in (1, 9, 30, 200):
            seen = torch.zeros(SHAPE, dtype=torch.int64)
            tiles = list(rd.lane_tiles(SHAPE, axes, size=piece))
            lane = int(np.prod([SHAPE[a] for a in axes]))
            for idx in tiles:
                assert all(idx[a] == slice(None) for a in axes)
                assert x[idx].numel() <= max(piece, lane)
                seen[idx] += 1
            assert torch.equal(seen, torch.ones_like(seen))
    assert list(rd.lane_tiles(SHAPE, (0,))) == [(slice(None),) * 3]
    for shape in ((2304, 1024, 1024), (1280, 2048, 2048)):
        for axes in ((0,), (1, 2), (0, 1)):
            tiles = list(rd.lane_tiles(shape, axes))
            size = max(np.prod([shape[a] for a in axes]), rd.SORT_PIECE)
            z = torch.zeros(()).expand(shape)
            assert max(z[i].numel() for i in tiles) <= size < 2 ** 31
            assert sum(z[i].numel() for i in tiles) == z.numel()


def test_tuple_axis_is_merged_a_tile_at_a_time(monkeypatch):
    """A tuple axis whose merge is no view of the data, (0, 2) of a C-
    ordered cube, copies at most SORT_PIECE voxels at once: the sort of
    each tile is no larger, and the result is the one call's.  (0, 1) and
    (1, 2) merge as views: one call below SORT_CHUNK."""
    data, include = make_case(np.float32, "include")
    t, inc = tensors(data, include)
    valid = rd.valid_mask(t, inc)
    want = rd.masked_median(t, valid, axis=(0, 2))
    monkeypatch.setattr(rd, "SORT_PIECE", 2 * SHAPE[0] * SHAPE[2])
    sorts = Calls(monkeypatch, "sort")
    got = rd.masked_median(t, valid, axis=(0, 2))
    assert same_bits(got, want)
    assert len(sorts.sizes) == -(-SHAPE[1] // 2)
    assert max(sorts.sizes) <= 2 * SHAPE[0] * SHAPE[2]
    for axes in ((0, 1), (1, 2)):
        sorts.sizes.clear()
        rd.masked_median(t, valid, axis=axes)
        assert sorts.sizes == [t.numel()]


@pytest.mark.parametrize("name", ["median", "percentile", "mad_std"])
def test_order_statistics_along_an_axis_sort_tiles(monkeypatch, name):
    """Past SORT_CHUNK an order statistic along an axis sorts each tile of
    whole lanes, never the cube, and forms mad_std's deviations a tile at
    a time."""
    data, include = make_case(np.float32, "include")
    t, inc = tensors(data, include)
    valid = rd.valid_mask(t, inc)
    want = FUNCS[name](t, valid, axis=0)
    small_pieces(monkeypatch, chunk=500, piece=2 * SHAPE[0] * SHAPE[2])
    sorts = Calls(monkeypatch, "sort")
    absolutes = Calls(monkeypatch, "abs")
    got = FUNCS[name](t, valid, axis=0)
    assert same_bits(got, want)
    passes = 2 if name == "mad_std" else 1
    assert len(sorts.sizes) == passes * -(-SHAPE[1] // 2)
    assert max(sorts.sizes) <= 2 * SHAPE[0] * SHAPE[2]
    assert max(absolutes.sizes, default=0) <= 2 * SHAPE[0] * SHAPE[2]


def test_cube_reductions_reach_the_tiles(monkeypatch, tmp_path):
    """The cube methods reach the tiles and pieces: ``sum``, ``std``,
    ``median``, ``mad_std`` and ``argmax`` along an axis, over a tuple of
    axes and over the cube give the one call's results with the constants
    small (the sums along an axis within 1e-6, as above)."""
    from conftest import make_cube_file
    path, _ = make_cube_file(tmp_path, shape=SHAPE, seed=9)
    cube = T.SpectralCube.read(path, device="cpu")
    cube = cube.with_mask(cube > T.Quantity(-0.5, cube.unit))
    calls = {"sum0": lambda c: c.sum(axis=0).value,
             "mean12": lambda c: c.mean(axis=(1, 2)).value,
             "std": lambda c: c.std().value,
             "median0": lambda c: c.median(axis=0).value,
             "mad_std2": lambda c: c.mad_std(axis=2).value,
             "percentile01": lambda c: c.percentile(10, axis=(0, 1)).value,
             "max": lambda c: c.max().value,
             "argmax": lambda c: c.argmax(),
             "argmin0": lambda c: c.argmin(axis=0)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = {k: np.asarray(fn(cube)) for k, fn in calls.items()}
        small_pieces(monkeypatch)
        for key, fn in calls.items():
            got = np.asarray(fn(cube))
            assert got.dtype == want[key].dtype, key
            if key in ("sum0", "mean12", "std"):
                tol = 1e-6 if got.dtype == np.float32 else 1e-12
                np.testing.assert_allclose(got, want[key], rtol=tol,
                                           atol=tol, equal_nan=True)
            else:
                assert got.tobytes() == want[key].tobytes(), key


# ---------------------------------------------------------------------------
# the spectral operations
# ---------------------------------------------------------------------------
def _holes(shape, seed=3):
    """A float32 cube with NaN holes, an all-NaN spectrum and infinities."""
    rng = np.random.RandomState(seed)
    data = rng.standard_normal(shape).astype(np.float32)
    data[rng.rand(*shape) < 0.05] = np.nan
    data[:, 1, 2] = np.nan
    data[2, 0, 0] = np.inf
    return data


def _close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _untiled_convolve1d_nan(x, kernel):
    """``convolve1d_nan`` along axis 0 as one whole-cube formula: the
    filled data, numerator, denominator and quotient each a cube."""
    kernel = np.asarray(kernel, dtype=float)
    kernel = kernel / kernel.sum()
    v = torch.isfinite(x)
    num = tsm._conv1d_along_axis0(torch.where(v, x, 0).contiguous(), kernel)
    den = 1.0 - tsm._conv1d_along_axis0((~v).to(x.dtype).contiguous(),
                                        kernel)
    ok = den > tsm.DEN_EPS
    o = torch.where(ok, num / torch.where(ok, den, 1.0), float("nan"))
    return torch.where(v.any(0, keepdim=True), o, float("nan"))


@pytest.mark.parametrize("nchan", [40, 600])
def test_convolve1d_nan_is_the_whole_cube_formula(nchan):
    """The banded blocks of a long axis (600 channels), each quotient
    written into the output, are the whole-cube formula's blocks: its
    values bit for bit (float32 and float64).  A short axis (40) is one
    dense product below SORT_CHUNK voxels, the formula's bit for bit; in
    tiles of whole spectra past it, each tile's product may sum in
    another order (a library matmul's plan follows its width), within
    1e-6 / 1e-6.  Both within the JAX package's test's tolerance."""
    data = _holes((nchan, 3, 5))
    kern = tsm.gaussian_kernel1d(2.0)
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(data).to(dtype)
        want = _untiled_convolve1d_nan(x, kern)
        assert same_bits(tsm.convolve1d_nan(x, kern), want)
        if nchan < 100:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(rd, "SORT_CHUNK", 100)
                mp.setattr(rd, "SORT_PIECE", 2 * nchan)
                assert len(list(rd.lane_tiles((nchan, 15), (0,)))) > 1
                _close(tsm.convolve1d_nan(x, kern).numpy(), want.numpy(),
                       1e-6, 1e-6)
    want = np.asarray(jsm.convolve1d_nan(jnp.asarray(data), kern))
    _close(tsm.convolve1d_nan(torch.as_tensor(data), kern).numpy(), want,
           1e-6, 1e-6)


def test_convolve1d_nan_makes_no_cube_sized_float_temporary():
    """The NaN-interpolating spectral convolution allocates one float
    array the size of the cube, its output, on a long axis (the banded
    blocks) and on a short one (tiles of spectra): everything else it
    allocates is a block's, or a bool array (the validity); the
    whole-cube formula allocates several."""
    for nchan, tile in ((600, None), (64, 16 * 64)):
        x = torch.as_tensor(_holes((nchan, 16, 64)))
        nbytes = x.numel() * 4
        kern = tsm.gaussian_kernel1d(2.0)
        with pytest.MonkeyPatch.context() as mp:
            if tile is not None:
                mp.setattr(rd, "SORT_CHUNK", tile)
                mp.setattr(rd, "SORT_PIECE", tile)
            from torch.profiler import profile, ProfilerActivity
            with profile(activities=[ProfilerActivity.CPU],
                         profile_memory=True) as prof:
                tsm.convolve1d_nan(x, kern)
        big = [e.self_cpu_memory_usage for e in prof.events()
               if e.self_cpu_memory_usage > nbytes // 3]
        assert big == [nbytes], (nchan, big)
        assert _largest_allocation(
            lambda: _untiled_convolve1d_nan(x, kern)) >= nbytes


@pytest.mark.parametrize("size", [3, 4, 5])
def test_median_filter_in_tiles_is_the_whole_stack(monkeypatch, size):
    """The spectral median filter stacks and sorts a tile of whole spectra
    at a time: no sort holds more than SORT_PIECE values, the result is
    the whole stack's bit for bit and the JAX package's exactly."""
    data = _holes((11, 6, 7))
    t = torch.as_tensor(data)
    want = tsm.spectral_median_filter_cube(t, size)
    monkeypatch.setattr(rd, "SORT_CHUNK", 60)
    monkeypatch.setattr(rd, "SORT_PIECE", 3 * size * 11)
    sorts = Calls(monkeypatch, "sort")
    got = tsm.spectral_median_filter_cube(t, size)
    assert same_bits(got, want)
    assert len(sorts.sizes) > 1 and max(sorts.sizes) <= 3 * size * 11
    ref = np.asarray(jsm.spectral_median_filter_cube(jnp.asarray(data),
                                                     size))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("stdfunc", ["std", "mad_std"])
@pytest.mark.parametrize("cenfunc", ["median", "mean"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sigma_clip_plain_in_tiles_is_the_one_call(monkeypatch, stdfunc,
                                                   cenfunc, dtype):
    """``sigma_clip_plain`` over tiles of whole spectra (the mad_std and
    float64 routes of ``sigma_clip_spectrally`` on every device) is the
    one call's bit for bit; each sort holds one tile.  The JAX package's float32 result exactly, and its
    float64 one within 1e-6."""
    rng = np.random.RandomState(9)
    data = rng.randn(23, 7, 9).astype(dtype)
    data[4, 2, 3] = np.nan
    data[:, 6, 8] = np.nan
    data[7, 1, 1] = 40.0
    t = torch.as_tensor(data)
    mean, mad = cenfunc == "mean", stdfunc == "mad_std"
    want = kclip.sigma_clip_plain(t, 1.5, 5, mean, mad)
    monkeypatch.setattr(rd, "SORT_CHUNK", 200)
    monkeypatch.setattr(rd, "SORT_PIECE", 2 * 23 * 9)
    sorts = Calls(monkeypatch, "sort")
    got = kclip.sigma_clip_plain(t, 1.5, 5, mean, mad)
    assert same_bits(got, want)
    assert len(sorts.sizes) > 1 and max(sorts.sizes) <= 2 * 23 * 9
    if dtype == np.float64 or mad:
        # the route sigma_clip_spectrally takes for these
        got = tsm.sigma_clip_spectrally(t, 1.5, 5, cenfunc, stdfunc)
        assert same_bits(got, want)
    ref = np.asarray(jsm.sigma_clip_spectrally(jnp.asarray(data), 1.5, 5,
                                               cenfunc, stdfunc))
    if dtype == np.float32:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        # JAX computes the float64 cube in float32 here (x64 off)
        _close(got.numpy(), ref, 1e-6, 1e-6)


def test_cube_spectral_methods_reach_the_tiles(monkeypatch, tmp_path):
    """``spectral_smooth``, ``spectral_smooth_median`` and the mad_std
    ``sigma_clip_spectrally`` of a cube read from FITS give the same
    results with the tiles small, and the JAX package's cube methods'
    within the smoothing tests' tolerances."""
    import spectral_cube_tpu as J
    from conftest import make_cube_file
    path, _ = make_cube_file(tmp_path, shape=(12, 6, 7), seed=4)
    cube = T.SpectralCube.read(path, device="cpu")
    jcube = J.SpectralCube.read(path)
    kern = tsm.gaussian_kernel1d(1.5)
    calls = {
        "smooth": lambda c: c.spectral_smooth(kern),
        "median": lambda c: c.spectral_smooth_median(
            3, raise_error_jybm=False),
        "clip": lambda c: c.sigma_clip_spectrally(1.2, stdfunc="mad_std")}
    want = {k: fn(cube)._data for k, fn in calls.items()}
    monkeypatch.setattr(rd, "SORT_CHUNK", 50)
    monkeypatch.setattr(rd, "SORT_PIECE", 3 * 12 * 7)
    for key, fn in calls.items():
        got = fn(cube)
        assert same_bits(got._data, want[key]), key
        ref = np.asarray(fn(jcube).unmasked_data[:].value)
        _close(np.asarray(got.unmasked_data[:].value), ref, 1e-6, 1e-6)


def _big_allocations(fn, nbytes):
    """The allocations (bytes) of more than a third of ``nbytes`` made by
    any operation inside ``fn()`` on the CPU, from the profiler's memory
    accounting."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    return [e.self_cpu_memory_usage for e in prof.events()
            if e.self_cpu_memory_usage > nbytes // 3]


def test_std_forms_one_deviation_array(monkeypatch):
    """``std`` along an axis rose 2.5 cube bytes: its filled copy, ``data -
    mean``, that squared and its filled copy, two at once.  It now holds
    one float array the size of the cube at a time (the filled copy for
    the mean, then the deviations squared and zeroed in place); over the
    whole cube it fills a SUM_CHUNK piece at a time and allocates none."""
    data, include = make_case(np.float32, "include")
    data = np.tile(data, (2, 4, 4))
    t = torch.from_numpy(data)
    valid = rd.valid_mask(t, torch.from_numpy(np.tile(include, (2, 4, 4))))
    nbytes = t.numel() * 4
    assert sorted(_big_allocations(lambda: rd.masked_std(t, valid, axis=0),
                                   nbytes)) == [nbytes, nbytes, 2 * nbytes]
    monkeypatch.setattr(rd, "SUM_CHUNK", t.numel() // 8)
    assert _big_allocations(lambda: rd.masked_std(t, valid), nbytes) == []


@pytest.mark.parametrize("name", ["argmax", "argmin", "max", "sum"])
def test_whole_cube_pieces_are_freed_as_they_go(monkeypatch, name):
    """Each whole-cube piece's filled copy is freed before the next is
    made: no result keeps a view of a piece (an arg-extremum once kept
    each piece alive through its extreme value, the whole cube's worth
    by the end, a rise of one cube byte on the card)."""
    import weakref
    data, include = make_case(np.float32, "include")
    t, inc = tensors(data, include)
    valid = rd.valid_mask(t, inc)
    want = FUNCS[name](t, valid, axis=None)
    small_pieces(monkeypatch, chunk=40, piece=24, sums=37)
    refs, alive = [], []
    fill = rd._fill

    def tracked(*args):
        alive.append(sum(r() is not None for r in refs))
        out = fill(*args)
        refs.append(weakref.ref(out))
        return out
    monkeypatch.setattr(rd, "_fill", tracked)
    got = FUNCS[name](t, valid, axis=None)
    assert same_bits(got, want)
    assert len(refs) > 2 and max(alive) <= 1
