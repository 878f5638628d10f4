"""Torch port, reductions over a tuple of axes and the transform engine
against the JAX package: ``sum``/``mean``/``median``/``mad_std`` (and the
other reductions) over ``(1, 2)``, a spatial + spectral pair and all
three axes; ``apply_function_parallel_spectral`` and ``_spatial`` (vmapped,
whole block, ``block_info``, ``return_new_cube=False``, the dask layout
options, the host fallback for functions that cannot be vmapped),
``apply_function`` (per ray, ``weights``, ``keep_shape``, the integer
probe, ``projection``), ``apply_numpy_function``, the varying-resolution
cube's beam check, and ``save_to_tmp_dir=`` / ``checkpoint``.

Both packages read the same FITS files; the port runs on CPU tensors.
Tolerances: reductions within 1e-6 rtol after equal types and NaN
patterns (float32 sums in another order); host-loop results bitwise equal;
vmapped float32 arithmetic within 1e-6 rtol.
"""

import gc
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu.utils import SliceWarning as JSliceWarning

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.utils import SliceWarning

from conftest import make_vr_cube_file
from test_torch_slicing import read_both, write_cube, assert_cube_equal


@pytest.fixture
def masked(tmp_path):
    path, data = write_cube(tmp_path)
    tc, jc = read_both(path)
    return (tc.with_mask(tc > T.Quantity(0.3, "Jy/beam")),
            jc.with_mask(jc > J.Quantity(0.3, "Jy/beam")), data)


def assert_close_result(t, j, rtol=1e-6):
    assert type(t).__name__ == type(j).__name__
    a, b = np.asarray(t.value, float), np.asarray(j.value, float)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol,
                               atol=rtol * np.abs(b[fin]).max(initial=0))
    assert t.unit.to_string() == j.unit.to_string()
    if getattr(j, "wcs", None) is not None:
        assert t.wcs.to_header() == j.wcs.to_header()


@pytest.mark.parametrize("axis", [(1, 2), (0, 1), (0, 2), (2, 0), (0, 1, 2),
                                  (-1, -2)])
@pytest.mark.parametrize("how", ["sum", "mean", "median", "mad_std"])
def test_tuple_axis_reductions_match_jax(masked, axis, how):
    """A sky collapse is a OneDSpectrum, a spatial + spectral pair a 1-D
    LowerDimensionalObject with a SliceWarning, all three axes a scalar,
    as in the JAX package (cube.py:851-905)."""
    tc, jc, _ = masked
    mixed = sorted(a % 3 for a in axis) in ([0, 1], [0, 2])
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = getattr(tc, how)(axis=axis)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = getattr(jc, how)(axis=axis)
    assert any(issubclass(w.category, SliceWarning) for w in tw) == mixed
    assert any(issubclass(w.category, JSliceWarning) for w in jw) == mixed
    assert_close_result(t, j)
    if len(set(a % 3 for a in axis)) < 3:
        assert t.meta["collapse_axis"] == j.meta["collapse_axis"]


@pytest.mark.parametrize("how", ["std", "max", "min"])
@pytest.mark.parametrize("axis", [(1, 2), (0, 2)])
def test_other_reductions_take_tuple_axes(masked, how, axis):
    tc, jc, _ = masked
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_close_result(getattr(tc, how)(axis=axis),
                            getattr(jc, how)(axis=axis))


def test_percentile_takes_tuple_axes(masked):
    tc, jc, _ = masked
    assert_close_result(tc.percentile(30, axis=(1, 2)),
                        jc.percentile(30, axis=(1, 2)))


def test_sky_collapse_of_a_vrsc_keeps_its_beams_and_checks_them(tmp_path):
    """A varying-resolution cube's sky collapse keeps the per-channel
    beams; a tuple holding the spectral axis checks them (JAX
    cube.py:2378-2391)."""
    path, _ = make_vr_cube_file(tmp_path, shape=(4, 5, 6))
    tc, jc = read_both(path)
    t, j = tc.mean(axis=(1, 2)), jc.mean(axis=(1, 2))
    assert_close_result(t, j)
    assert [b.major_rad for b in t.unmasked_beams] == \
        [b.major_rad for b in j.unmasked_beams]
    bad, _ = make_vr_cube_file(tmp_path, name="bad.fits", shape=(4, 5, 6),
                               major_arcsec=[1.0, 1.0, 4.0, 1.0])
    tb, jb = read_both(bad)
    for c in (tb, jb):
        with pytest.raises(ValueError):
            c.sum(axis=(0, 1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert c.sum(axis=(1, 2)).shape == (4,)


# -- apply_function_parallel_spectral / _spatial -----------------------------

def _baseline(lib):
    def fn(spec):
        return spec - lib.nanmean(spec[:2]) * 0.5 + 1.0
    return fn


def test_parallel_spectral_vmaps_a_traceable_function(masked):
    tc, jc, _ = masked
    t = tc.apply_function_parallel_spectral(_baseline(torch))
    j = jc.apply_function_parallel_spectral(_baseline(jnp))
    assert type(t).__name__ == type(j).__name__
    a, b = t._data.numpy(), np.asarray(j._data)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(b)], b[~np.isnan(b)], rtol=1e-6)
    np.testing.assert_array_equal(t.get_mask_array(),
                                  np.asarray(j.get_mask_array()))


def test_parallel_spectral_block_info_and_raw_output(masked):
    tc, jc, data = masked
    seen = []

    def with_info(block, block_info=None):
        seen.append(block_info)
        return block * 2

    t = tc.apply_function_parallel_spectral(with_info, accepts_chunks=True,
                                            drop_axis=[0], chunks=(1, 2))
    j = jc.apply_function_parallel_spectral(with_info, accepts_chunks=True,
                                            drop_axis=[0], chunks=(1, 2))
    assert seen[0] == seen[1]
    assert seen[0][0]["array-location"] == [(0, n) for n in tc.shape]
    np.testing.assert_array_equal(t._data.numpy(), np.asarray(j._data))
    raw_t = tc.apply_function_parallel_spectral(
        lambda block: block.nansum(0), accepts_chunks=True,
        return_new_cube=False)
    raw_j = jc.apply_function_parallel_spectral(
        lambda block: jnp.nansum(block, 0), accepts_chunks=True,
        return_new_cube=False)
    assert isinstance(raw_t, torch.Tensor) and raw_t.shape == tc.shape[1:]
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), rtol=1e-6)


def _data_dependent(spec):
    """A boolean-mask selection: neither vmap nor JAX tracing takes it."""
    spec = np.asarray(spec)
    return spec - spec[spec > 0.5].sum() * 0.25


def test_parallel_spectral_falls_back_on_the_host(masked):
    tc, jc, _ = masked
    t = tc.apply_function_parallel_spectral(_data_dependent)
    j = jc.apply_function_parallel_spectral(_data_dependent)
    assert t._data.device == tc.device and t._data.dtype == torch.float32
    np.testing.assert_array_equal(t._data.numpy(), np.asarray(j._data))


def test_parallel_spectral_kwargs_reach_the_function(masked):
    tc, jc, _ = masked

    def add(x, add=None):
        return x + add

    for chunks in (True, False):
        t = tc.apply_function_parallel_spectral(add, add=1,
                                                accepts_chunks=chunks)
        j = jc.apply_function_parallel_spectral(add, add=1,
                                                accepts_chunks=chunks)
        np.testing.assert_array_equal(t._data.numpy(), np.asarray(j._data))


def test_parallel_spatial_vmapped_and_fallback(masked):
    tc, jc, _ = masked
    t = tc.apply_function_parallel_spatial(
        lambda img: torch.nan_to_num(img) * 2 + img.shape[0])
    j = jc.apply_function_parallel_spatial(
        lambda img: jnp.nan_to_num(img) * 2 + img.shape[0])
    np.testing.assert_array_equal(t._data.numpy(), np.asarray(j._data))
    t = tc.apply_function_parallel_spatial(_data_dependent)
    j = jc.apply_function_parallel_spatial(_data_dependent)
    np.testing.assert_array_equal(t._data.numpy(), np.asarray(j._data))
    raw = tc.apply_function_parallel_spatial(lambda img: img.nansum(),
                                             return_new_cube=False)
    np.testing.assert_allclose(raw.numpy(), np.asarray(
        jc.apply_function_parallel_spatial(lambda img: jnp.nansum(img),
                                           return_new_cube=False)),
        rtol=1e-6)


def test_parallel_options_are_checked(masked):
    tc, _, _ = masked
    with pytest.raises(ValueError):
        tc.apply_function_parallel_spectral(lambda s: s, parallel=False,
                                            num_cores=2)


# -- apply_function / apply_numpy_function ----------------------------------

@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_apply_function_per_ray(masked, axis):
    tc, jc, _ = masked
    np.testing.assert_array_equal(
        tc.apply_function(np.max, axis=axis),
        jc.apply_function(np.max, axis=axis))


def test_apply_function_options(masked):
    tc, jc, data = masked
    w = np.random.RandomState(0).rand(*tc.shape)
    for kw in ({"weights": w}, {"keep_shape": True}, {"projection": True},
               {"projection": True, "unit": T.Quantity(1, "K").unit}):
        jkw = dict(kw)
        if "unit" in jkw:
            jkw["unit"] = J.Quantity(1, "K").unit
        t = tc.apply_function(np.sum, axis=0, **kw)
        j = jc.apply_function(np.sum, axis=0, **jkw)
        if kw.get("projection"):
            assert type(t).__name__ == type(j).__name__ == "Projection"
            assert t.unit.to_string() == j.unit.to_string()
            t, j = t.value, j.value
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    # the integer probe: argmax starts from 0, not NaN
    t = tc.apply_function(np.argmax, axis=0)
    j = jc.apply_function(np.argmax, axis=0)
    assert t.dtype == j.dtype and t.dtype.kind == "i"
    np.testing.assert_array_equal(t, j)
    # axis=None applies to all included values and ignores weights
    t = tc.apply_function(np.sum, weights=w)
    j = jc.apply_function(np.sum, weights=w)
    assert t.unit.to_string() == j.unit.to_string()
    np.testing.assert_allclose(t.value, j.value, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tc.apply_function(np.sum, axis=(0, 1))


def test_apply_function_progress_callback(masked):
    tc, _, _ = masked
    calls = []
    tc.apply_function(np.sum, axis=0, update_function=lambda: calls.append(1))
    assert len(calls) == tc.shape[1] * tc.shape[2]


def test_apply_numpy_function(masked):
    tc, jc, _ = masked
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = tc.apply_numpy_function(np.nanmax, axis=0, projection=True)
        j = jc.apply_numpy_function(np.nanmax, axis=0, projection=True)
        assert type(t).__name__ == type(j).__name__ == "Projection"
        np.testing.assert_array_equal(t.value, j.value)
        t = tc.apply_numpy_function(np.nanmedian, fill=0.0)
        j = jc.apply_numpy_function(np.nanmedian, fill=0.0)
        assert t == j
        t = tc.apply_numpy_function(np.nansum, unit=T.Quantity(1, "K").unit)
        j = jc.apply_numpy_function(np.nansum, unit=J.Quantity(1, "K").unit)
        assert t.unit.to_string() == j.unit.to_string()
        np.testing.assert_allclose(t.value, j.value, rtol=1e-6)


@pytest.mark.parametrize("method", ["apply_function", "apply_numpy_function"])
def test_vrsc_checks_its_beams_over_the_spectral_axis(tmp_path, method):
    path, _ = make_vr_cube_file(tmp_path, shape=(4, 3, 2),
                                major_arcsec=[1.0, 1.0, 4.0, 1.0])
    tc, jc = read_both(path)
    fn = np.sum if method == "apply_function" else np.nansum
    for c in (tc, jc):
        with pytest.raises(ValueError):
            getattr(c, method)(fn, axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(
            np.asarray(getattr(tc, method)(fn, axis=1)),
            np.asarray(getattr(jc, method)(fn, axis=1)))
        # positional axis, as the reference's signature allows
        if method == "apply_function":
            with pytest.raises(ValueError):
                tc.apply_function(fn, 0)


# -- save_to_tmp_dir / checkpoint --------------------------------------------

def test_save_to_tmp_dir_is_bitwise_the_same_cube(masked, tmp_path):
    tc, jc, _ = masked
    kern = np.array([0.25, 0.5, 0.25])
    plain = tc.spectral_smooth(kern)
    saved = tc.spectral_smooth(kern, save_to_tmp_dir=True)
    jsaved = jc.spectral_smooth(kern, save_to_tmp_dir=True)
    assert type(saved).__name__ == "SpectralCube"
    np.testing.assert_array_equal(
        saved._data.numpy(), plain._get_filled_data(fill=np.nan).numpy())
    np.testing.assert_array_equal(saved.get_mask_array(),
                                  plain.get_mask_array())
    np.testing.assert_array_equal(saved.get_mask_array(),
                                  np.asarray(jsaved.get_mask_array()))
    assert saved.wcs.to_header() == plain.wcs.to_header()
    assert saved.beam.major_rad == plain.beam.major_rad
    for name, kwargs in (("spectral_smooth_median",
                          {"ksize": 3, "raise_error_jybm": False}),
                         ("downsample_axis", {"factor": 2, "axis": 0})):
        a = getattr(tc, name)(**kwargs)
        b = getattr(tc, name)(save_to_tmp_dir=True, **kwargs)
        np.testing.assert_array_equal(
            b._data.numpy(), a._get_filled_data(fill=np.nan).numpy())


def test_checkpoint_store_lives_with_the_cube(masked, tmp_path):
    tc, _, _ = masked
    store_root = tmp_path / "stores"
    store_root.mkdir()
    ck = tc.checkpoint(tmp_dir=str(store_root))
    (store,) = list(store_root.iterdir())
    assert sorted(os.listdir(store)) == ["data.npy", "meta.json"]
    assert ck.device == tc.device
    assert_cube_equal(ck, ck)
    np.testing.assert_array_equal(ck.get_mask_array(), tc.get_mask_array())
    del ck
    gc.collect()
    assert not store.exists()
