"""Torch port, masks against the JAX package: view masks and the slicing
of each mask kind, FunctionMask, pickling, ``with_spectral_unit``, and
the port's indexing helper ``index_view`` against numpy.

Mirrors ``tests/test_masks.py`` by name.  Include arrays, filled values
and WCS cards are bitwise equal to the JAX package's.
"""

import pickle
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu import masks as jm

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import masks as tm

from conftest import make_cube_file

SHAPE = (5, 4, 3)


@pytest.fixture
def data():
    rng = np.random.RandomState(11)
    d = rng.rand(*SHAPE).astype(np.float32)
    d[1, 1, 1] = np.nan
    d[3, :, 2] = np.nan
    return d


@pytest.fixture
def cube_pair(tmp_path):
    path, data = make_cube_file(tmp_path, shape=(4, 3, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return T.SpectralCube.read(path, device="cpu"), \
            J.SpectralCube.read(path), data


def _spectral(d):
    return np.array([True, False, True, True, False])


def _spatial(d):
    return np.array([[True, False, True], [False, False, True],
                     [True, True, False], [False, True, True]])


def _fn(d, wcs, view):
    sub = d if view == () else d[view]
    return sub > 0.4


def mask_pair(kind, d):
    """The same mask in both packages: (port mask, JAX mask)."""
    t = torch.as_tensor(d)
    thr = np.linspace(0.2, 0.6, SHAPE[0])[:, None, None]
    if kind == "lazy":
        return (tm.LazyMask(torch.isfinite, data=t),
                jm.LazyMask(jnp.isfinite, data=d))
    if kind == "compare":
        return (tm.LazyComparisonMask(torch.gt, 0.3, data=t),
                jm.LazyComparisonMask(jnp.greater, 0.3, data=d))
    if kind == "compare_array":
        return (tm.LazyComparisonMask(torch.gt, thr, data=t),
                jm.LazyComparisonMask(jnp.greater, thr, data=d))
    if kind == "bool_full":
        arr = d > 0.5
        return (tm.BooleanArrayMask(arr, shape=SHAPE),
                jm.BooleanArrayMask(arr, shape=SHAPE))
    if kind == "bool_spectral":
        return (tm.BooleanArrayMask(_spectral(d), shape=SHAPE),
                jm.BooleanArrayMask(_spectral(d), shape=SHAPE))
    if kind == "bool_spatial":
        return (tm.BooleanArrayMask(_spatial(d), shape=SHAPE),
                jm.BooleanArrayMask(_spatial(d), shape=SHAPE))
    if kind == "inverted":
        a, b = mask_pair("compare", d)
        return ~a, ~b
    if kind == "composite":
        a1, b1 = mask_pair("lazy", d)
        a2, b2 = mask_pair("bool_spatial", d)
        a3, b3 = mask_pair("compare_array", d)
        return (a1 & a2) ^ a3, (b1 & b2) ^ b3
    if kind == "function":
        def tfn(x, wcs, view):
            return tm.index_view(x, view) > 0.4
        return (tm.FunctionMask(tfn, shape=SHAPE),
                jm.FunctionMask(lambda x, wcs, view: np.asarray(
                    x if view == () else x[view]) > 0.4, shape=SHAPE))
    raise ValueError(kind)


KINDS = ["lazy", "compare", "compare_array", "bool_full", "bool_spectral",
         "bool_spatial", "inverted", "composite", "function"]
VIEWS = [np.s_[1:4], np.s_[::-1], np.s_[:, 2], np.s_[2], np.s_[:, 1:3, ::-1],
         np.s_[4:0:-1, :, 1], np.s_[-2:]]
VIEW_IDS = [f"v{i}" for i in range(len(VIEWS))]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("view", VIEWS, ids=VIEW_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_mask_views(data, kind, view):
    """``mask[view]`` evaluates as the JAX package's on the cut data, and
    ``include(view=...)`` on the full data; a sliced data-local mask stays
    data-local (the rule of masks.py:40-61)."""
    t, j = mask_pair(kind, data)
    sub = view if isinstance(view, tuple) else (view,)
    cut = np.ascontiguousarray(data[sub])
    np.testing.assert_array_equal(
        _np(t.include(data=torch.as_tensor(data), view=sub)),
        _np(j.include(data=data, view=sub)))
    ts, js = t[sub], j[sub]
    assert tm.is_data_local(ts) == jm.is_data_local(js)
    assert tm.is_data_local(ts) == tm.is_data_local(t)
    np.testing.assert_array_equal(
        np.broadcast_to(_np(ts.include(data=torch.as_tensor(cut))),
                        cut.shape),
        np.broadcast_to(_np(js.include(data=cut)), cut.shape))
    assert ts.shape == js.shape
    if kind != "function":
        np.testing.assert_array_equal(
            np.broadcast_to(_np(ts.include()), cut.shape),
            np.broadcast_to(_np(js.include()), cut.shape))


def test_sliced_masks_keep_compact_and_bound_storage(data):
    """Slicing a spectral mask cuts its stored (5, 1, 1) array, never the
    cube it broadcasts to; a sliced data mask keeps its parent's bound
    tensor and cuts it only when evaluated without data."""
    t, _ = mask_pair("bool_spectral", data)
    sub = t[1:4, ::-1, 2]
    assert tuple(sub._mask.shape) == (3, 1)
    assert sub.shape == (3, 4)
    lazy, _ = mask_pair("compare", data)
    s = lazy[::-1, 1:3]
    assert s._data is lazy._data
    np.testing.assert_array_equal(s.include().numpy(),
                                  np.flip(data, 0)[:, 1:3] > 0.3)
    assert lazy[::-1][1:3].include().shape == (2, 4, 3)


@pytest.mark.parametrize("kind", KINDS)
def test_mask_members(data, kind):
    t, j = mask_pair(kind, data)
    d = torch.as_tensor(data)
    assert (t.ndim, t.size, t.dtype) == (j.ndim, j.size, j.dtype)
    np.testing.assert_array_equal(_np(t.exclude(data=d)),
                                  _np(j.exclude(data=data)))
    assert t.any(data=d) == j.any(data=data)
    filled_t = t._filled(d, fill=-1.0)
    assert filled_t.dtype == torch.float32
    np.testing.assert_array_equal(
        _np(filled_t), _np(j._filled(jnp.asarray(data), fill=-1.0)))
    np.testing.assert_array_equal(_np(t._flattened(d)),
                                  _np(j._flattened(data)))
    np.testing.assert_array_equal(
        _np(t._filled(d, view=np.s_[::-1, 1], fill=0.0)),
        _np(j._filled(jnp.asarray(data), view=np.s_[::-1, 1], fill=0.0)))
    if kind != "function":
        np.testing.assert_array_equal(_np(t.view()), _np(j.view()))


def test_boolean_mask_subdim_integer_views():
    good = np.array([True, False, True, True])
    m = tm.BooleanArrayMask(good, shape=(4, 3, 2))
    inc = m.include(view=(slice(None), 2, slice(None)))
    assert tuple(inc.shape) == (4, 2) and (inc.numpy() == good[:, None]).all()
    assert not m.include(view=(1, slice(None), slice(None))).any()
    spat = np.zeros((3, 2), dtype=bool)
    spat[1, 1] = True
    m2 = tm.BooleanArrayMask(spat, shape=(4, 3, 2))
    inc3 = m2.include(view=(3,))
    assert tuple(inc3.shape) == (3, 2) and inc3[1, 1] and inc3.sum() == 1
    assert tuple(m2[(3, slice(None), slice(None))].include().shape) == (3, 2)


@pytest.mark.parametrize("view", [
    np.s_[::-1], np.s_[::-2], np.s_[5:1:-1], np.s_[1:5:-1], np.s_[-1:-5:-2],
    np.s_[..., ::-1], np.s_[None, ::-1, 2], np.s_[2, ::-1, None, 1:3],
    np.s_[::-3, ..., 0], np.s_[:, ::-1, ::-1], np.s_[np.int64(1), ::-1],
    np.s_[1:4], np.s_[np.array([0, 2])]],
    ids=[f"v{i}" for i in range(13)])
def test_index_view_matches_numpy(view):
    arr = np.arange(6 * 5 * 4, dtype=np.float32).reshape(6, 5, 4)
    got = tm.index_view(torch.as_tensor(arr), view)
    np.testing.assert_array_equal(got.numpy(), arr[view])
    assert tm.index_view(arr, view).shape == arr[view].shape


def test_index_view_refuses_advanced_with_negative_step():
    with pytest.raises(IndexError, match="negative slice step"):
        tm.index_view(torch.zeros(4, 3), (np.array([0, 1]), slice(None, None,
                                                                  -1)))


def test_view_helpers():
    for s1, s2 in [((3,), (4, 2, 3)), ((4, 1, 3), (4, 2, 3)),
                   ((1, 2, 1), (4, 2, 3))]:
        assert tm.dims_to_skip(s1, s2) == jm.dims_to_skip(s1, s2)
        for view in [np.s_[1:3], np.s_[::-1, 0], ()]:
            assert tm.view_of_subset(view, s2, s1) \
                == jm.view_of_subset(view, s2, s1)
    for view in [np.s_[1:3], np.s_[::-1, 0], np.s_[..., 1], ()]:
        assert tm.view_shape((4, 2, 3), view) \
            == jm.view_shape((4, 2, 3), view)
    with pytest.raises(ValueError):
        tm.dims_to_skip((5,), (4, 2, 3))


def test_masks_and_cubes_pickle(cube_pair):
    """Masks with torch functions and bound tensors pickle (the function
    by name, the tensors as host arrays) and evaluate identically."""
    tc, jc, data = cube_pair
    masked = tc.with_mask(tc > T.Quantity(0.4, "Jy/beam"))
    back = pickle.loads(pickle.dumps(masked.mask))
    np.testing.assert_array_equal(back.include(data=masked._data).numpy(),
                                  masked.mask.include(data=masked._data)
                                  .numpy())
    assert back._mask1._function is torch.isfinite
    b = tm.BooleanArrayMask(np.array([True, False, True, True]),
                            shape=(4, 3, 2))
    b2 = pickle.loads(pickle.dumps(b[::-1, 1]))
    np.testing.assert_array_equal(b2.include().numpy(),
                                  b[::-1, 1].include().numpy())
    f = pickle.loads(pickle.dumps(masked.mask[1:3, ::-1]))
    np.testing.assert_array_equal(f.include().numpy(),
                                  masked.mask[1:3, ::-1].include().numpy())
    jmasked = jc.with_mask(jc > J.Quantity(0.4, "Jy/beam"))
    c2 = pickle.loads(pickle.dumps(masked))
    np.testing.assert_array_equal(c2.filled_data[:].value,
                                  np.asarray(jmasked.filled_data[:].value))


def test_mask_spectral_unit_functions(cube_pair):
    """with_spectral_unit converts a mask's stored WCS, recursively
    through composites; a FunctionMask without a WCS is copied."""
    tc, jc, _ = cube_pair
    tlazy = tm.LazyMask(torch.isfinite, cube=tc)
    jlazy = jm.LazyMask(jnp.isfinite, cube=jc)
    for unit, conv in (("Hz", None), ("GHz", "radio"), ("m/s", "optical")):
        a = tlazy.with_spectral_unit(unit, velocity_convention=conv)
        b = jlazy.with_spectral_unit(unit, velocity_convention=conv)
        assert a._wcs.to_header() == b._wcs.to_header()
        assert a._data is tlazy._data
    fmask = tm.FunctionMask(lambda x, w, v: x > 0)
    comp = (fmask & tlazy).with_spectral_unit("Hz")
    assert comp._mask1._wcs is None
    assert comp._mask2._wcs.to_header() \
        == jlazy.with_spectral_unit("Hz")._wcs.to_header()
    bam = tm.BooleanArrayMask(np.ones((4, 3, 2), bool), wcs=tc.wcs)
    assert (~bam).with_spectral_unit("Hz")._mask._wcs.ctype[2] == "FREQ"


def test_mask_survives_spectral_unit_change(cube_pair):
    tc, jc, _ = cube_pair
    t = tc.with_mask(tc > T.Quantity(0.5, "Jy/beam"))
    conv = t.with_spectral_unit("m / s")
    np.testing.assert_array_equal(conv.get_mask_array(), t.get_mask_array())
    assert str(conv.spectral_axis.unit) == "m / s"


def test_function_mask_shape_check(data):
    m = tm.FunctionMask(lambda d, wcs, view: torch.ones(2, 2, dtype=bool))
    with pytest.raises(ValueError, match="correct shape"):
        m.include(data=torch.as_tensor(data))
    m2 = tm.FunctionMask(lambda d, wcs, view: np.ones(SHAPE, bool))
    assert m2.include(data=torch.as_tensor(data)).dtype == torch.bool


def test_function_mask_receives_call_time_wcs(cube_pair):
    tc, _, _ = cube_pair
    seen = {}

    def fn(d, wcs, view):
        seen["wcs"] = wcs
        return tm.index_view(d, view) > 0

    masked = tc.with_mask(T.FunctionMask(fn))
    masked.filled_data[:]
    assert seen["wcs"] is tc.wcs
    inc = masked.mask.include(data=tc._data, wcs=tc.wcs)
    exc = masked.mask.exclude(data=tc._data, wcs=tc.wcs)
    np.testing.assert_array_equal(exc.numpy(), ~inc.numpy())


def test_function_mask_survives_cube_slicing(cube_pair):
    tc, jc, data = cube_pair
    t = tc.with_mask(T.FunctionMask(lambda d, wcs, view: d > 0.5))[2:4, ::-1]
    j = jc.with_mask(J.FunctionMask(lambda d, wcs=None, view=():
                                    np.asarray(d) > 0.5))[2:4, ::-1]
    np.testing.assert_array_equal(t.filled_data[:].value,
                                  np.asarray(j.filled_data[:].value))


def test_array_threshold_mask_slices_with_view(cube_pair):
    tc, jc, _ = cube_pair
    thr = np.array([0.1, 0.3, 0.5, 0.7])[:, None, None]
    t = tc.with_mask(tc > T.Quantity(thr, tc.unit))
    j = jc.with_mask(jc > J.Quantity(thr, jc.unit))
    for view in (np.s_[1:3], np.s_[::-1], np.s_[2:4, :, :]):
        np.testing.assert_array_equal(t[view].filled_data[:].value,
                                      np.asarray(j[view].filled_data[:]
                                                 .value))
        np.testing.assert_array_equal(t.filled_data[view].value,
                                      np.asarray(j.filled_data[view].value))


def test_2dcomparison_mask_1d_index(cube_pair):
    tc, jc, _ = cube_pair
    mask = tc > tc.median(axis=0)
    jmask = jc > jc.median(axis=0)
    np.testing.assert_array_equal(mask[:, 1, 1].include().numpy(),
                                  np.asarray(jmask[:, 1, 1].include()))
    spec = tc.with_mask(mask)[:, 1, 1]
    jspec = jc.with_mask(jmask)[:, 1, 1]
    np.testing.assert_array_equal(spec.value, np.asarray(jspec.value))
    assert tuple(spec[:-1].mask.include().shape) == (3,)
    np.testing.assert_array_equal(spec[:-1].mask.include().numpy(),
                                  np.asarray(jspec[:-1].mask.include()))
    assert hasattr(spec[0], "unit")


def test_1dcomparison_mask_1d_index(cube_pair):
    tc, jc, _ = cube_pair
    mask = tc > tc.median()
    spec = tc.with_mask(mask)[:-1, 1, 1]
    jspec = jc.with_mask(jc > jc.median())[:-1, 1, 1]
    np.testing.assert_array_equal(spec.value, np.asarray(jspec.value))
    assert tuple(spec[:-1].mask.include().shape) == (2,)


def test_1dmask_indexing(cube_pair):
    tc, _, _ = cube_pair
    spec = tc.with_mask(tc > tc.median())[:, 1, 1]
    inc = spec.mask.include().numpy()
    assert np.all(np.isnan(np.asarray(spec[~inc].value)))
    assert not np.any(np.isnan(np.asarray(spec[inc].value)))


def test_1d_mask(cube_pair):
    tc, jc, data = cube_pair
    mask = np.array([True, False, True, False])
    t = tc.with_mask(mask[:, None, None])
    j = jc.with_mask(mask[:, None, None])
    np.testing.assert_array_equal(t.sum(axis=0).value,
                                  np.asarray(j.sum(axis=0).value))
    M = tm.BooleanArrayMask(mask[:, None, None], wcs=tc.wcs, shape=tc.shape)
    inc = (tc.mask & M).include()
    assert tuple(inc.shape) == tc.shape
    assert not inc[1].any() and not inc[3].any()
