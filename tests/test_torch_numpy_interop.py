"""Numpy interop of the port: faults F7-F10 and their repairs.

On the card, numpy cannot read a torch tensor (``np.asarray`` raises
``TypeError``), where the JAX package's arrays copy to the host.  Each
case runs on the CPU under :func:`numpy_guard`, which raises that error
whenever a port module hands numpy a tensor, and on the card (``cuda``).
Expected values are numpy's on the same float32 data; the tests named
``*_matches_jax`` hold the same calls against the JAX package on the CPU.

- F7: ``np.asarray(cube.filled_data[...])``, ``np.nanmax`` of it and
  ``cube.apply_everywhere(np.abs)`` handed numpy a tensor
  (``Quantity.__array__`` and ``__array_ufunc__``).
- F8: ``LazyMask(np.isfinite, cube=cube)`` evaluated numpy on a tensor;
  masks refused numpy data.
- F9: ``ops.convolve.convolve2d_nan_fft`` refused a numpy image.
- F10: the cube's ``repr`` lacked the per-axis rows.
- F11: a caller's function written for numpy (a ``FunctionMask``'s, one
  given to ``apply_function_parallel_spectral/_spatial`` with
  ``accepts_chunks=True`` or to ``apply_everywhere`` with
  ``check_units=False``) was handed a tensor numpy cannot read on the
  card.  It is called again on a host copy only when numpy refuses the
  tensor; a function written with torch keeps the tensor, and an error of
  its own comes through from its one call.
- F12: ``apply_everywhere`` on its default ``check_units=True`` path
  handed the caller's function a ``Quantity`` of a tensor numpy cannot
  read on the card.
- F13: ``MaskBase._filled`` and ``_flattened`` refused numpy data.
- F16: ``ops.interpolate.interp_cube_spectral`` refused numpy data.
- F17: ``ops.smoothing.sigma_clip_spectrally`` refused numpy data.
- F18: ``kernels/resample2._host_flags`` read the filled entry's channel
  flags with ``np.asarray(tensor.cpu())``, an implicit conversion, on the
  card's ``reproject`` onto a new spectral axis.
- F19: a whole-cube float32 sum on the card (a tree of float32 partial
  sums) landed an ulp off the rounded sum, outside the JAX test's rel
  1e-7 (``tests/test_cube.py``'s ``test_nonnative_endian_ctor``).
"""

import operator

import numpy as np
import pytest
import torch

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.masks import (BooleanArrayMask, FunctionMask,
                                           LazyComparisonMask, LazyMask,
                                           fused_predicate,
                                           is_finiteness_mask)
from spectral_cube_tpu_torch.ops.convolve import convolve2d_nan_fft
from spectral_cube_tpu_torch.ops.interpolate import interp_cube_spectral
from spectral_cube_tpu_torch.ops.smoothing import sigma_clip_spectrally
from spectral_cube_tpu_torch.kernels import resample2 as _resample2
from spectral_cube_tpu_torch.units import Quantity

from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits

from test_torch_fixtures_ref import (DEVICES, base_header, cube_and_raw,
                                     numpy_guard, use_device)

SHAPE = (6, 5, 7)
VIEWS = [(), (slice(None),), (1,), (slice(1, 4), 2), (Ellipsis, 3),
         (slice(None, None, -1), slice(0, 4, 2)), (0, 1, 2)]


@pytest.fixture(scope="module", autouse=True)
def _port_converts_explicitly():
    with numpy_guard():
        yield


@pytest.fixture(params=DEVICES)
def device(request, monkeypatch):
    return use_device(request.param, monkeypatch)


def _cube_file(tmp_path, border=False):
    """A float32 cube with NaNs (an all-NaN first column if ``border``)
    written to FITS; returns the path and the data."""
    rng = np.random.RandomState(5)
    data = rng.randn(*SHAPE).astype(np.float32)
    data[2, 0, :3] = np.nan
    data[1, 1, 1] = np.nan
    if border:
        data[:, :, 0] = np.nan
    h = base_header(nx=SHAPE[2], ny=SHAPE[1], nchan=SHAPE[0])
    h["BITPIX"] = -32
    path = str(tmp_path / "interop.fits")
    write_fits(path, [HDU(data=data, header=h)])
    return path, data


def _port_cube(tmp_path, border=False):
    path, data = _cube_file(tmp_path, border)
    return T.SpectralCube.read(path), data


def _jax():
    pytest.importorskip("jax")
    import spectral_cube_tpu as J
    return J


def _ufunc_results(cube):
    """The numpy calls of F7 on a cube's filled data."""
    q = cube.filled_data[:]
    k = type(q)(1.0, cube.unit)
    return {
        "asarray": np.asarray(q),
        "nanmax": np.nanmax(q),
        "nansum": np.nansum(q),
        "max": np.asarray(np.max(q)),
        "add.reduce": np.asarray(np.add.reduce(q, axis=0)),
        "cumsum": np.asarray(np.add.accumulate(q, axis=0)),
        "abs": np.asarray(np.abs(q)),
        "fabs": np.asarray(np.fabs(q)),
        "sqrt": np.asarray(np.sqrt(np.abs(q / k))),
        "add": np.asarray(np.add(q, q)),
        "maximum": np.asarray(np.maximum(q, k * 0.5)),
        "greater": np.asarray(np.greater(q, k * 0.5)),
        "equal": np.asarray(np.equal(q, q)),
        "isfinite": np.asarray(np.isfinite(q)),
        "exp": np.asarray(np.exp(q / k)),
        "power": np.asarray(np.power(q, 2)),
        "multiply": np.asarray(np.multiply(q, 2.0)),
    }


def _numpy_results(data):
    with np.errstate(invalid="ignore"):
        return {
            "asarray": data,
            "nanmax": np.nanmax(data),
            "nansum": np.nansum(data),
            "max": np.max(data),
            "add.reduce": np.add.reduce(data, axis=0),
            "cumsum": np.add.accumulate(data, axis=0),
            "abs": np.abs(data),
            "fabs": np.fabs(data),
            "sqrt": np.sqrt(np.abs(data)),
            "add": data + data,
            "maximum": np.maximum(data, np.float32(0.5)),
            "greater": data > 0.5,
            "equal": data == data,
            "isfinite": np.isfinite(data),
            "exp": np.exp(data),
            "power": data ** 2,
            "multiply": data * 2.0,
        }


def _assert_same(got, want):
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_f7_filled_data_and_ufuncs(tmp_path, device):
    cube, data = _port_cube(tmp_path)
    assert cube.device.type == device.type
    _assert_same(_ufunc_results(cube), _numpy_results(data))
    for view in VIEWS:
        np.testing.assert_array_equal(np.asarray(cube.filled_data[view]),
                                      data[view])
        np.testing.assert_array_equal(np.asarray(cube.unmasked_data[view]),
                                      data[view])
        assert np.asarray(cube.filled_data[view]).dtype == np.float32


def test_f7_ufuncs_with_a_torch_namesake_stay_on_the_device(tmp_path,
                                                           device):
    cube, _ = _port_cube(tmp_path)
    q = cube.filled_data[:]
    for out in (np.abs(q), np.add(q, q), np.greater(q, q * 0.5),
                np.sqrt(np.abs(q / q)), np.power(q, 2)):
        value = out.value if isinstance(out, Quantity) else out
        assert isinstance(value, torch.Tensor)
        assert value.device.type == device.type
    assert np.abs(q).unit == cube.unit
    assert np.power(q, 2).unit == cube.unit ** 2
    # np.fabs has no torch namesake: numpy computes it on a host copy
    assert isinstance(np.fabs(q).value, np.ndarray)


def test_f7_apply_everywhere_with_numpy_ufuncs(tmp_path, device):
    cube, data = _port_cube(tmp_path)
    for fn, want in ((np.abs, np.abs(data)), (np.negative, -data),
                     (np.fabs, np.abs(data)), (np.square, data ** 2)):
        out = cube.apply_everywhere(fn)
        assert out.device.type == device.type
        np.testing.assert_allclose(np.asarray(out.unmasked_data[:]), want,
                                   rtol=1e-6)
    assert cube.apply_everywhere(np.abs).unit == cube.unit
    assert cube.apply_everywhere(np.square).unit == cube.unit ** 2


def test_f7_matches_jax(tmp_path):
    J = _jax()
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        cube, data = _port_cube(tmp_path)
        jcube = J.SpectralCube.read(str(tmp_path / "interop.fits"))
        _assert_same(_ufunc_results(cube), _ufunc_results(jcube))
        for view in VIEWS:
            np.testing.assert_array_equal(
                np.asarray(cube.filled_data[view]),
                np.asarray(jcube.filled_data[view]))
        for fn in (np.abs, np.fabs, np.square):
            np.testing.assert_allclose(
                np.asarray(cube.apply_everywhere(fn).unmasked_data[:]),
                np.asarray(jcube.apply_everywhere(fn).unmasked_data[:]),
                rtol=1e-6)


def _mask_calls(cube, mask):
    masked = cube.with_mask(mask)
    return {
        "get_mask_array": np.asarray(masked.get_mask_array()),
        "minimal_subcube": np.asarray(masked.minimal_subcube()
                                      .filled_data[:]),
        "sum": np.asarray(masked.sum()),
        "sum0": np.asarray(masked.sum(axis=0)),
    }


def _numpy_data():
    d = np.arange(24.0).reshape(4, 3, 2)
    d[1, 1, 1] = np.nan
    return d


def test_f8_numpy_function_on_a_cube(tmp_path, device):
    cube, data = _port_cube(tmp_path, border=True)
    mask = LazyMask(np.isfinite, cube=cube)
    assert mask._function is torch.isfinite
    assert is_finiteness_mask(mask) and fused_predicate(mask) == (0, 0.0)
    got = _mask_calls(cube, mask)
    fin = np.isfinite(data)
    np.testing.assert_array_equal(got["get_mask_array"], fin)
    np.testing.assert_array_equal(got["minimal_subcube"], data[:, :, 1:])
    np.testing.assert_allclose(got["sum"], np.nansum(data), rtol=1e-5)
    # a spaxel with no included value sums to NaN, as in the JAX package
    np.testing.assert_allclose(got["sum0"],
                               np.where(fin.any(axis=0),
                                        np.nansum(data, axis=0), np.nan),
                               rtol=1e-5, atol=1e-6)
    # a callable torch has no namesake for sees a host copy of the data;
    # its boolean result lands on the data's device
    mask = LazyMask(lambda x: np.isfinite(x) & (np.abs(x) > 0.3),
                    cube=cube)
    inc = mask.include()
    assert inc.dtype == torch.bool and inc.device.type == device.type
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(np.asarray(inc),
                                      fin & (np.abs(data) > 0.3))


def test_f8_numpy_function_on_a_cube_matches_jax(tmp_path):
    J = _jax()
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        cube, _ = _port_cube(tmp_path, border=True)
        jcube = J.SpectralCube.read(str(tmp_path / "interop.fits"))
        got = _mask_calls(cube, LazyMask(np.isfinite, cube=cube))
        want = _mask_calls(jcube, J.LazyMask(np.isfinite, cube=jcube))
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       err_msg=key)


def test_f8_numpy_data(device):
    d = _numpy_data()
    cases = [
        (LazyMask(torch.isfinite, data=d), np.isfinite(d)),
        (LazyMask(np.isfinite, data=d), np.isfinite(d)),
        (LazyComparisonMask(torch.greater, 10.0, data=d), d > 10),
        (LazyComparisonMask(np.greater, 10.0, data=d), d > 10),
        (LazyComparisonMask(np.less_equal, np.full(d.shape, 7.0), data=d),
         d <= 7),
        (LazyMask(lambda x: np.nan_to_num(x) % 2 == 0, data=d),
         np.nan_to_num(d) % 2 == 0),
    ]
    for mask, want in cases:
        for inc in (mask.include(), mask.include(data=d),
                    mask[1:3].include(), mask.exclude()):
            assert inc.device.type == device.type
        np.testing.assert_array_equal(np.asarray(mask.include()), want)
        np.testing.assert_array_equal(np.asarray(mask.include(data=d)), want)
        np.testing.assert_array_equal(np.asarray(mask[1:3].include()),
                                      want[1:3])
        np.testing.assert_array_equal(np.asarray(mask.exclude()), ~want)
    assert fused_predicate(LazyComparisonMask(np.greater, 10.0, data=d)) \
        == (1, 10.0)
    # a scalar threshold rounds in the data's torch dtype (float32 here)
    m = LazyComparisonMask(torch.greater, 0.1 + 2 ** -30, data=d * 0 + 0.1)
    assert not np.asarray(m.include()).any()


def test_f8_mask_functions_written_with_torch(tmp_path, device):
    """A mask function written with torch (or with tensor operators) runs
    on the tensor, on its device: it gets no host copy."""
    cube, data = _port_cube(tmp_path)
    seen = []

    def positive(d):
        seen.append(type(d))
        return torch.isfinite(d) & (d > 0)

    with np.errstate(invalid="ignore"):
        cases = [
            (LazyMask(positive, cube=cube), np.isfinite(data) & (data > 0)),
            (LazyMask(lambda d: d.isnan(), cube=cube), np.isnan(data)),
            (LazyMask(lambda d: d > 0, data=data), data > 0),
            (LazyComparisonMask(operator.gt, 0.5, cube=cube), data > 0.5),
        ]
    for mask, want in cases:
        inc = mask.include()
        assert inc.dtype == torch.bool and inc.device.type == device.type
        np.testing.assert_array_equal(np.asarray(inc), want)
        np.testing.assert_array_equal(np.asarray(mask[1:3].include()),
                                      want[1:3])
    got = np.asarray(cube.with_mask(LazyMask(positive, cube=cube)).sum())
    np.testing.assert_allclose(got, data[np.isfinite(data) & (data > 0)]
                               .sum(), rtol=1e-5)
    assert seen and set(seen) == {torch.Tensor}


def test_f8_matches_jax():
    _jax()
    import jax.numpy as jnp
    from spectral_cube_tpu import masks as jm
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        d = _numpy_data()
        for port, jax in (
                (LazyMask(torch.isfinite, data=d),
                 jm.LazyMask(jnp.isfinite, data=d)),
                (LazyMask(np.isfinite, data=d),
                 jm.LazyMask(np.isfinite, data=d)),
                (LazyComparisonMask(torch.greater, 10.0, data=d),
                 jm.LazyComparisonMask(jnp.greater, 10.0, data=d)),
                (LazyComparisonMask(np.greater, 10.0, data=d),
                 jm.LazyComparisonMask(np.greater, 10.0, data=d))):
            np.testing.assert_array_equal(np.asarray(port.include(data=d)),
                                          np.asarray(jax.include(data=d)))
            np.testing.assert_array_equal(np.asarray(port.exclude(data=d)),
                                          np.asarray(jax.exclude(data=d)))


def _point_source():
    img = np.zeros((11, 11))
    img[5, 5] = 1.0
    yy, xx = np.mgrid[-3:4, -3:4]
    kernel = np.exp(-0.5 * (yy ** 2 + (xx / 1.5) ** 2))
    return img, kernel


def test_f9_convolve2d_nan_fft_takes_numpy(device):
    img, kernel = _point_source()
    out = convolve2d_nan_fft(img, kernel)
    assert isinstance(out, np.ndarray) and out.shape == img.shape
    want = np.zeros_like(img)
    want[2:9, 2:9] = kernel / kernel.sum()
    np.testing.assert_allclose(out, want, atol=1e-6)
    # a NaN is interpolated over, a stack of planes keeps its shape
    img3 = np.stack([img, img])
    img3[1, 0, 0] = np.nan
    out3 = convolve2d_nan_fft(img3, kernel)
    assert out3.shape == img3.shape and np.isfinite(out3).all()
    np.testing.assert_allclose(out3[0], want, atol=1e-6)
    # a tensor gives a tensor on its device
    t = convolve2d_nan_fft(torch.as_tensor(img, dtype=torch.float32,
                                           device=device), kernel)
    assert isinstance(t, torch.Tensor) and t.device.type == device.type
    np.testing.assert_allclose(t.cpu().numpy(), want, atol=1e-6)


def test_f9_matches_jax():
    _jax()
    from spectral_cube_tpu.ops.convolve import convolve2d_nan_fft as jconv
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        img, kernel = _point_source()
        img3 = np.stack([img, img])
        img3[1, 0, 0] = np.nan
        for x in (img, img3):
            np.testing.assert_allclose(convolve2d_nan_fft(x, kernel),
                                       np.asarray(jconv(x, kernel)),
                                       atol=1e-6)


def test_f10_repr(tmp_path, device):
    cube, _ = cube_and_raw(tmp_path)
    r = repr(cube)
    assert "SpectralCube" in r and "VOPT" in r
    assert "unit=K" in r
    assert "unit_x: deg" in r and "unit_s: km / s" in r
    assert "24.062698" in r and "29.934094" in r
    assert "-321.215" in r and "-317.350" in r
    assert r.splitlines()[-1] == f" on {cube.device}"


def test_f10_repr_matches_jax(tmp_path):
    _jax()
    import ref_fixtures
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        cube, _ = cube_and_raw(tmp_path, "port.fits")
        jcube, _ = ref_fixtures.cube_and_raw(tmp_path, "jax.fits")
        mine = repr(cube).splitlines()
        assert mine[:-1] == repr(jcube).splitlines()
        assert mine[-1] == " on cpu"


def _rising(data, wcs=None, view=()):
    """docs/developing.md's FunctionMask function, written for numpy."""
    return np.gradient(np.asarray(data), axis=0)[view] > 0


def _peaks(block, block_info=None):
    return np.nanmax(np.asarray(block), axis=0)


def _numpy_callbacks(cube):
    masked = cube.with_mask(FunctionMask(_rising))
    return {
        "function_mask": np.asarray(masked.get_mask_array()),
        "function_mask_view": np.asarray(masked[1:4, ::-1].filled_data[:]),
        "spectral": np.asarray(cube.apply_function_parallel_spectral(
            _peaks, accepts_chunks=True, return_new_cube=False)),
        "spatial": np.asarray(cube.apply_function_parallel_spatial(
            lambda b: np.nan_to_num(np.asarray(b)) * 2, accepts_chunks=True)
            .unmasked_data[:]),
        "apply_everywhere": np.asarray(cube.apply_everywhere(
            np.fabs, check_units=False).unmasked_data[:]),
    }


def test_f11_numpy_functions_of_the_caller(tmp_path, device):
    cube, data = _port_cube(tmp_path)
    got = _numpy_callbacks(cube)
    # the cube's finiteness mask stays (with_mask inherits it)
    rising = (np.gradient(data, axis=0) > 0) & np.isfinite(data)
    np.testing.assert_array_equal(got["function_mask"], rising)
    # a cut cube's function sees the cut data, as in the JAX package
    sub = data[1:4, ::-1]
    np.testing.assert_array_equal(
        got["function_mask_view"],
        np.where((np.gradient(sub, axis=0) > 0) & np.isfinite(sub), sub,
                 np.nan))
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(got["spectral"],
                                      np.nanmax(data, axis=0))
    np.testing.assert_array_equal(got["spatial"], np.nan_to_num(data) * 2)
    np.testing.assert_array_equal(got["apply_everywhere"], np.fabs(data))
    # a function of tensors still gets the tensor, on its device
    seen = []
    cube.with_mask(FunctionMask(
        lambda d, wcs=None, view=(): seen.append(d.device) or d[view] > 0)
    ).get_mask_array()
    assert seen and seen[0].type == device.type


def test_f11_errors_of_the_callers_function_come_through_once(tmp_path,
                                                             device):
    """A ``TypeError`` of the caller's function's own (not numpy refusing a
    tensor) comes through unchanged, from the function's one call."""
    cube, _ = _port_cube(tmp_path)
    calls = []

    def faulty(d, *args, **kwargs):
        calls.append(type(d))
        raise TypeError("a fault of the function's own")

    runs = {
        "LazyMask": lambda: LazyMask(faulty, cube=cube).include(),
        "LazyComparisonMask":
            lambda: LazyComparisonMask(faulty, 0.5, cube=cube).include(),
        "FunctionMask":
            lambda: cube.with_mask(FunctionMask(faulty)).get_mask_array(),
        "apply_everywhere":
            lambda: cube.apply_everywhere(faulty, check_units=False),
        "spectral": lambda: cube.apply_function_parallel_spectral(
            faulty, accepts_chunks=True),
        "spatial": lambda: cube.apply_function_parallel_spatial(
            faulty, accepts_chunks=True),
    }
    for name, run in runs.items():
        calls.clear()
        with pytest.raises(TypeError, match="a fault of the function's own"):
            run()
        assert calls == [torch.Tensor], name


def test_f11_matches_jax(tmp_path):
    J = _jax()
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        cube, _ = _port_cube(tmp_path)
        jcube = J.SpectralCube.read(str(tmp_path / "interop.fits"))
        got = _numpy_callbacks(cube)
        masked = jcube.with_mask(J.FunctionMask(_rising))
        want = {
            "function_mask": np.asarray(masked.get_mask_array()),
            "function_mask_view": np.asarray(
                masked[1:4, ::-1].filled_data[:]),
            "spectral": np.asarray(jcube.apply_function_parallel_spectral(
                _peaks, accepts_chunks=True, return_new_cube=False)),
            "apply_everywhere": np.asarray(jcube.apply_everywhere(
                np.fabs, check_units=False).unmasked_data[:]),
        }
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _doubled_value(q):
    """``tests/test_cube.py``'s function: it strips the unit with numpy."""
    return np.asarray(q.value) * 2.0


def test_f12_apply_everywhere_with_a_numpy_function(tmp_path, device):
    cube, data = _port_cube(tmp_path)
    out = cube.apply_everywhere(_doubled_value)
    # the function strips the unit: the result is dimensionless
    assert out.device.type == device.type and out.unit.to_string() == ""
    np.testing.assert_array_equal(np.asarray(out.unmasked_data[:].value),
                                  data * 2)
    # a function of Quantities keeps its tensor and its unit
    seen = []
    sq = cube.apply_everywhere(lambda q: seen.append(q.value) or q * q)
    assert isinstance(seen[-1], torch.Tensor)
    assert seen[-1].device.type == device.type
    assert sq.unit == cube.unit ** 2


def test_f12_matches_jax(tmp_path):
    J = _jax()
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        cube, _ = _port_cube(tmp_path)
        jcube = J.SpectralCube.read(str(tmp_path / "interop.fits"))
        got = cube.apply_everywhere(_doubled_value)
        want = jcube.apply_everywhere(_doubled_value)
        assert got.unit.to_string() == want.unit.to_string()
        np.testing.assert_array_equal(
            np.asarray(got.unmasked_data[:].value),
            np.asarray(want.unmasked_data[:].value))


def _filled_calls(masks):
    """``tests/test_masks.py``'s ``_filled`` / ``_flattened`` calls on numpy
    data, trivial and integer-index views."""
    d = np.arange(5.0).reshape((1, 1, 5))
    view = (0, 0, slice(1, 4))
    bam = masks.BooleanArrayMask(
        np.array([[[False, True, True, False, True]]]), None)
    cmp = masks.LazyComparisonMask(operator.gt, 2, data=d)
    return {
        "filled": np.asarray(bam._filled(d, None)),
        "flattened": np.asarray(bam._flattened(d, None)),
        "filled_view": np.asarray(bam._filled(d, None, view=view)),
        "flattened_view": np.asarray(bam._flattened(d, None, view=view)),
        "cmp_filled_view": np.asarray(cmp._filled(d, None, view=view)),
        "cmp_flattened": np.asarray(cmp._flattened(d, None)),
    }


def test_f13_filled_and_flattened_take_numpy(device):
    import spectral_cube_tpu_torch.masks as masks
    got = _filled_calls(masks)
    nan = np.nan
    np.testing.assert_array_equal(got["filled"], [[[nan, 1, 2, nan, 4]]])
    np.testing.assert_array_equal(got["flattened"], [1, 2, 4])
    np.testing.assert_array_equal(got["filled_view"], [1, 2, nan])
    np.testing.assert_array_equal(got["flattened_view"], [1, 2])
    np.testing.assert_array_equal(got["cmp_filled_view"], [nan, nan, 3])
    np.testing.assert_array_equal(got["cmp_flattened"], [3, 4])
    # the result lies where a cube's data would, in the data's dtype
    out = BooleanArrayMask(np.ones((2, 3), bool), None)._filled(
        np.ones((2, 3), np.float32))
    assert out.device.type == device.type and out.dtype == torch.float32


def test_f13_matches_jax():
    _jax()
    import spectral_cube_tpu.masks as jmasks
    import spectral_cube_tpu_torch.masks as masks
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        got, want = _filled_calls(masks), _filled_calls(jmasks)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _interp_inputs():
    """``tests/test_regrid.py``'s 2-D include case, and a 3-D include with
    a NaN in the data."""
    rng = np.random.RandomState(1)
    data = rng.rand(8, 3, 4).astype(np.float32)
    data[3, 0, 1] = np.nan
    inax = np.arange(8, dtype=np.float64)
    outax = np.linspace(0.5, 6.5, 5)
    inc2d = np.zeros((3, 4), dtype=bool)
    inc2d[1, 2] = True
    inc3d = rng.rand(8, 3, 4) > 0.2
    return data, inax, outax, inc2d, inc3d


def test_f16_interp_cube_spectral_takes_numpy(device):
    data, inax, outax, inc2d, inc3d = _interp_inputs()
    for inc in (None, inc2d, inc3d):
        out, new_inc = interp_cube_spectral(data, inax, outax, include=inc)
        assert isinstance(out, np.ndarray) and out.shape == (5, 3, 4)
        want = np.apply_along_axis(lambda s: np.interp(outax, inax, s), 0,
                                   data)
        np.testing.assert_allclose(out, want, rtol=1e-6)
        if inc is None:
            assert new_inc is None
            continue
        assert isinstance(new_inc, np.ndarray)
        assert new_inc.shape == (5, 3, 4) and new_inc.dtype == bool
        if inc is inc2d:
            assert new_inc[:, 1, 2].all() and new_inc.sum() == 5
    # a tensor gives tensors on its device
    t, t_inc = interp_cube_spectral(torch.as_tensor(data, device=device),
                                    inax, outax, include=inc2d)
    assert t.device.type == device.type and t_inc.device.type == device.type
    np.testing.assert_array_equal(t.cpu().numpy(), interp_cube_spectral(
        data, inax, outax)[0])


def test_f16_matches_jax():
    _jax()
    from spectral_cube_tpu.ops.interpolate import \
        interp_cube_spectral as jinterp
    data, inax, outax, inc2d, inc3d = _interp_inputs()
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        for inc in (None, inc2d, inc3d):
            out, new_inc = interp_cube_spectral(data, inax, outax,
                                                include=inc)
            jout, jinc = jinterp(data, inax, outax, include=inc)
            np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-6)
            if inc is not None:
                np.testing.assert_array_equal(new_inc, np.asarray(jinc))


def _clip_input():
    """``tests/test_smoothing.py``'s spectra with a -inf and a +inf."""
    rng = np.random.RandomState(0)
    spec = rng.normal(0.0, 1.0, 33).astype(np.float32)
    x = np.stack([spec, spec, spec], axis=1)[:, :, None]
    x[5, 1, 0] = -np.inf
    x[9, 2, 0] = np.inf
    return x


def test_f17_sigma_clip_spectrally_takes_numpy(device):
    x = _clip_input()
    for stdfunc in ("std", "mad_std"):
        out = sigma_clip_spectrally(x, sigma=6.0, maxiters=5,
                                    stdfunc=stdfunc)
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
        assert np.isnan(out[5, 1, 0]) and np.isnan(out[9, 2, 0])
        keep = np.isfinite(x)
        np.testing.assert_array_equal(out[keep], x[keep])
        t = sigma_clip_spectrally(torch.as_tensor(x, device=device),
                                  sigma=6.0, maxiters=5, stdfunc=stdfunc)
        assert isinstance(t, torch.Tensor) and t.device.type == device.type
        np.testing.assert_array_equal(t.cpu().numpy(), out)


def test_f17_matches_jax():
    _jax()
    from spectral_cube_tpu.ops.smoothing import \
        sigma_clip_spectrally as jclip
    x = _clip_input()
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        for stdfunc in ("std", "mad_std"):
            np.testing.assert_array_equal(
                sigma_clip_spectrally(x, sigma=6.0, maxiters=5,
                                      stdfunc=stdfunc),
                np.asarray(jclip(x, sigma=6.0, maxiters=5,
                                 stdfunc=stdfunc)))


def _cross_type_reprojection(cube):
    """``tests/test_regrid.py``'s VRAD cube onto its own FREQ template: the
    spectral axis moves (the filled resample, with its channel flags)."""
    return cube.reproject(cube.with_spectral_unit("Hz").header)


def test_f18_channel_flags_convert_explicitly(tmp_path, device):
    flags = torch.tensor([True, False, True], device=device)
    got = _resample2._host_flags(flags)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, [True, False, True])
    cube, data = _port_cube(tmp_path)
    out = _cross_type_reprojection(cube)
    np.testing.assert_allclose(np.asarray(out.unmasked_data[:].value), data,
                               rtol=1e-5)


def test_f18_matches_jax(tmp_path):
    J = _jax()
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        cube, _ = _port_cube(tmp_path)
        jcube = J.SpectralCube.read(str(tmp_path / "interop.fits"))
        np.testing.assert_allclose(
            np.asarray(_cross_type_reprojection(cube).unmasked_data[:].value),
            np.asarray(_cross_type_reprojection(jcube).unmasked_data[:]
                       .value), rtol=1e-6)


def _sum_cubes(tmp_path):
    """(name, FITS path, float32 data): ``tests/test_cube.py``'s 4x3x2 cube
    with a NaN, and wider cubes of positive and signed values."""
    out = []
    for seed, shape, signed in ((42, (4, 3, 2), False), (5, (16, 24, 32),
                                False), (6, (31, 17, 9), True)):
        rng = np.random.RandomState(seed)
        data = rng.rand(*shape) - (0.5 if signed else 0.0)
        data[min(1, shape[0] - 1), min(1, shape[1] - 1), 1] = np.nan
        path = str(tmp_path / f"sum{seed}.fits")
        write_fits(path, [HDU(data=data, header=base_header(
            nx=shape[2], ny=shape[1], nchan=shape[0]))])
        out.append((f"seed {seed}", path, data.astype(np.float32)))
    return out


def test_f19_whole_cube_sums_round_once(tmp_path, device):
    for name, path, data in _sum_cubes(tmp_path):
        cube = T.SpectralCube.read(path)
        exact = np.nansum(data.astype(np.float64))
        assert float(cube.sum().value) == float(np.float32(exact)), name
        n = np.float32(np.isfinite(data).sum())
        assert float(cube.mean().value) == float(np.float32(exact) / n), \
            name
    # tests/test_cube.py's own check, on a big-endian float64 payload
    be = data.astype(">f8")
    c = T.SpectralCube(be, cube.wcs, unit="K")
    assert float(c.sum().value) == pytest.approx(np.nansum(data), rel=1e-7)


def test_f19_matches_jax(tmp_path):
    """The port's whole-cube sum, mean and std lie as close to the float64
    value as the JAX package's float32 ones, or closer (half an ulp of
    rounding); on the JAX test's own cube they are the JAX package's."""
    J = _jax()
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        for name, path, data in _sum_cubes(tmp_path):
            cube, jcube = T.SpectralCube.read(path), J.SpectralCube.read(path)
            d64 = data.astype(np.float64)
            exact = {"sum": np.nansum(d64), "mean": np.nanmean(d64),
                     "std": np.nanstd(d64)}
            for how, value in exact.items():
                got = float(getattr(cube, how)().value)
                want = float(np.asarray(getattr(jcube, how)().value))
                half_ulp = float(np.spacing(np.float32(value))) / 2
                assert abs(got - value) <= abs(want - value) + half_ulp, \
                    (name, how, got, want, value)
                if name == "seed 42":
                    assert got == want, (how, got, want)
