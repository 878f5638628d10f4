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
"""

import operator

import numpy as np
import pytest
import torch

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.masks import (FunctionMask, LazyComparisonMask,
                                           LazyMask, fused_predicate,
                                           is_finiteness_mask)
from spectral_cube_tpu_torch.ops.convolve import convolve2d_nan_fft
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
