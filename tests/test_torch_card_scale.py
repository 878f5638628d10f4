"""Torch port: the whole-cube order statistics in pieces, as they run on
a cube past 2**31 voxels.

``ops/reductions.SORT_CHUNK`` bounds the values a whole-cube order
statistic sorts, or picks by a boolean index, at once; past it the cube
is cut into pieces of ``SORT_PIECE`` values (or of the limit, where that
is smaller), each piece is sorted on its own and each order statistic
is found by bisecting the pieces' ordered bit patterns (the code
``parallel.sharded`` uses over shards).  Here the constant is set small by ``monkeypatch`` so that cubes
of a few thousand voxels take many pieces: rows cut, whole planes, slabs.
For float32 and float64 cubes with NaNs and infinities, an include mask,
ties and an all-masked cube, ``masked_percentile``, ``masked_median``,
``masked_mad_std`` and ``sharded_percentile`` are held

- bit for bit against the one-sort form (the default constant, where the
  cube is one piece);
- against the JAX package's ``masked_percentile`` / ``masked_mad_std``
  at ``tests/test_torch_moments.py``'s tolerance (rtol 1e-6, atol 1e-7);

and a wrapper around ``torch.sort`` (and ``torch.abs``, which forms
``mad_std``'s deviations) counts the calls and holds every one to the
constant.
"""

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.ops import reductions as jred

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch.parallel import sharded as tsh
from spectral_cube_tpu_torch.ops import reductions as rd

from conftest import make_cube_file

SHAPE = (9, 10, 13)
#: piece sizes: inside one row, several rows, several planes
CHUNKS = [7, 64, 500]
CASES = ["nan", "include", "ties", "all_masked"]
Q = 37.5

FUNCS = {
    "percentile": lambda d, v: rd.masked_percentile(d, v, Q),
    "median": rd.masked_median,
    "mad_std": rd.masked_mad_std,
}
JAX_FUNCS = {
    "percentile": lambda d, v: jred.masked_percentile(d, v, Q),
    "median": jred.masked_median,
    "mad_std": jred.masked_mad_std,
}


def make_case(dtype, case, seed=5):
    """(data, include) numpy arrays of SHAPE: normal values with NaN and
    infinite voxels; ``include`` a random mask, ``ties`` values on a grid
    of quarters (many equal values, none zero), ``all_masked`` nothing
    included."""
    rng = np.random.RandomState(seed)
    data = (rng.standard_normal(SHAPE) * 3 - 1).astype(dtype)
    if case == "ties":
        data = (np.round(data * 4) / 4 + 0.125).astype(dtype)
    data[0, 0, :4] = np.nan
    data[3, 2, 5] = np.inf
    data[4, :, 7] = -np.inf
    include = None
    if case == "include":
        include = rng.rand(*SHAPE) > 0.35
    elif case == "all_masked":
        include = np.zeros(SHAPE, bool)
    return data, include


def tensors(data, include):
    t = torch.from_numpy(data)
    return t, rd.valid_mask(t, None if include is None
                            else torch.from_numpy(include))


def bits(x):
    """The bit pattern of a 0-d float tensor (NaN compares equal)."""
    return int(x.reshape(1).view(rd._BITS[x.element_size()])[0])


class Calls:
    """Wraps ``torch.<name>``, recording the element count of each
    call's first argument."""

    def __init__(self, monkeypatch, name):
        self.sizes = []
        fn = getattr(torch, name)

        def wrapped(x, *args, **kwargs):
            self.sizes.append(x.numel())
            return fn(x, *args, **kwargs)
        monkeypatch.setattr(torch, name, wrapped)


def jax_value(name, data, include):
    jd = jnp.asarray(data)
    jv = jred.valid_mask(jd, None if include is None
                         else jnp.asarray(include))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.asarray(JAX_FUNCS[name](jd, jv))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_whole_cube_order_statistics_in_pieces(monkeypatch, dtype, case,
                                               chunk):
    data, include = make_case(dtype, case)
    t, valid = tensors(data, include)
    want = {name: fn(t, valid) for name, fn in FUNCS.items()}
    monkeypatch.setattr(rd, "SORT_CHUNK", chunk)
    pieces = len(list(rd._pieces(t)))
    assert pieces > 1
    for name, fn in FUNCS.items():
        sorts = Calls(monkeypatch, "sort")
        got = fn(t, valid)
        monkeypatch.undo()
        monkeypatch.setattr(rd, "SORT_CHUNK", chunk)
        assert got.dtype == want[name].dtype == t.dtype
        assert bits(got) == bits(want[name]), name
        # one sort a piece (two passes for mad_std), none above the limit
        assert len(sorts.sizes) == pieces * (2 if name == "mad_std" else 1)
        assert max(sorts.sizes) <= chunk
        np.testing.assert_allclose(float(got), jax_value(name, data,
                                                         include),
                                   rtol=1e-6, atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sharded_percentile_in_pieces(monkeypatch, dtype, case):
    """sharded_percentile over a 2 x 2 CPU mesh, each shard's values
    sorted in pieces, is the one-sort value of the unsharded reduction bit
    for bit, and the JAX package's within its tolerance."""
    data, include = make_case(dtype, case)
    t, valid = tensors(data, include)
    want = rd.masked_percentile(t, valid, Q)
    cmesh = tpar.CubeMesh(devices=["cpu"] * 4, shape=(2, 2))
    monkeypatch.setattr(rd, "SORT_CHUNK", 16)
    sorts = Calls(monkeypatch, "sort")
    got = tsh.sharded_percentile(t, Q, cmesh, include=include)
    assert len(sorts.sizes) > 4 and max(sorts.sizes) <= 16
    assert got.dtype == want.dtype
    assert bits(got) == bits(want)
    np.testing.assert_allclose(float(got), jax_value("percentile", data,
                                                     include),
                               rtol=1e-6, atol=1e-7, equal_nan=True)
    assert cmesh.counters["gathers"] == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sharded_mad_std_on_a_one_device_mesh_in_pieces(monkeypatch,
                                                        dtype):
    """A shard of more than SORT_CHUNK values (a mesh of one device holds
    the whole cube) is sorted in pieces: sharded_mad_std is the one-sort
    unsharded value bit for bit, with no sort and no deviation above the
    limit."""
    data, include = make_case(dtype, "include")
    t, valid = tensors(data, include)
    want = rd.masked_mad_std(t, valid)
    cmesh = tpar.CubeMesh(devices=["cpu"], shape=(1, 1))
    monkeypatch.setattr(rd, "SORT_CHUNK", 100)
    pieces = len(list(rd._pieces(t)))
    sorts = Calls(monkeypatch, "sort")
    absolutes = Calls(monkeypatch, "abs")
    got = tpar.sharded_mad_std(t, cmesh, include=include)
    assert bits(got) == bits(want)
    assert len(sorts.sizes) == 2 * pieces > 2
    assert max(sorts.sizes) <= 100 and max(absolutes.sizes) <= 100


def test_pieces_stay_below_a_device_sorts_limit():
    """F20: a device sort refuses a dimension of more than INT_MAX
    elements (torch 2.11 on an H100), and the one-sort ``mad_std`` of a
    2304 x 1024 x 1024 cube ran out of the card's memory.  The default
    pieces of a cube past 2**31 voxels (an expanded tensor here, no
    memory behind it) are views of at most SORT_PIECE elements, far below
    that limit, and they cover the cube in order; a 623 x 768 x 768 cube
    is sorted whole, as before the pieces."""
    assert rd.SORT_PIECE <= rd.SORT_CHUNK < 2 ** 31 - 1
    for shape in ((2304, 1024, 1024), (1280, 2048, 2048), (3, 2 ** 30)):
        x = torch.zeros(()).expand(shape)
        parts = list(rd._pieces(x))
        assert max(p.numel() for p in parts) <= rd.SORT_PIECE
        assert sum(p.numel() for p in parts) == x.numel() > 2 ** 31
    x = torch.zeros(()).expand(623, 768, 768)
    assert [p.shape for p in rd._pieces(x)] == [x.shape]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pieces_past_the_limit_hold_sort_piece_values(monkeypatch, dtype):
    """Past SORT_CHUNK an array is cut into pieces of SORT_PIECE values,
    smaller than the limit: each sort holds at most SORT_PIECE values, and
    the results are the one sort's bit for bit."""
    data, include = make_case(dtype, "include")
    t, valid = tensors(data, include)
    want = {name: fn(t, valid) for name, fn in FUNCS.items()}
    monkeypatch.setattr(rd, "SORT_CHUNK", 500)
    monkeypatch.setattr(rd, "SORT_PIECE", 64)
    pieces = len(list(rd._pieces(t)))
    assert pieces > t.numel() // 500
    for name, fn in FUNCS.items():
        sorts = Calls(monkeypatch, "sort")
        got = fn(t, valid)
        monkeypatch.undo()
        monkeypatch.setattr(rd, "SORT_CHUNK", 500)
        monkeypatch.setattr(rd, "SORT_PIECE", 64)
        assert bits(got) == bits(want[name]), name
        assert len(sorts.sizes) == pieces * (2 if name == "mad_std" else 1)
        assert max(sorts.sizes) <= 64


@pytest.mark.parametrize("chunk", [None, 7, 64])
@pytest.mark.parametrize("shape", [(10, 13), (1, 10, 13), (9, 1, 13)])
def test_a_broadcast_include_in_pieces(monkeypatch, shape, chunk):
    """An include that broadcasts against the data, as the JAX reductions
    take it, selects the same values in one sort and in pieces: each
    result is the full-shape include's bit for bit, and the JAX
    package's within its tolerance."""
    rng = np.random.RandomState(11)
    data = (rng.standard_normal(SHAPE) * 3 - 1).astype(np.float32)
    include = rng.rand(*shape) > 0.4
    t, inc = torch.from_numpy(data), torch.from_numpy(include)
    full = inc.expand(SHAPE).clone()
    want = {name: fn(t, full) for name, fn in FUNCS.items()}
    if chunk is not None:
        monkeypatch.setattr(rd, "SORT_CHUNK", chunk)
    for name, fn in FUNCS.items():
        got = fn(t, inc)
        assert bits(got) == bits(want[name]), name
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = np.asarray(JAX_FUNCS[name](jnp.asarray(data),
                                             jnp.asarray(include)))
        np.testing.assert_allclose(float(got), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, torch.int32])
def test_finite_is_isfinite(dtype):
    """``reductions.finite`` gives ``torch.isfinite``'s answer for NaNs of
    both signs, infinities, signed zeros, subnormals and the largest
    values, and integers."""
    info = torch.finfo(dtype) if dtype.is_floating_point else None
    vals = [0.0, -0.0, 1.0, -3.5] if info is None else [
        0.0, -0.0, 1.0, -3.5, float("nan"), -float("nan"), float("inf"),
        -float("inf"), info.tiny / 4, info.max, -info.max]
    x = torch.tensor(vals).to(dtype).reshape(-1, 1).expand(-1, 3)
    assert torch.equal(rd.finite(x), torch.isfinite(x))
    inc = torch.tensor([True, False, True]).expand(len(vals), 3)
    assert torch.equal(rd.valid_mask(x, inc), torch.isfinite(x) & inc)


def _largest_allocation(fn):
    """The largest allocation (bytes) of any operation inside ``fn()``
    on the CPU, from the profiler's memory accounting."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    return max(e.self_cpu_memory_usage for e in prof.events())


def test_f21_finiteness_makes_no_float_copy(tmp_path):
    """F21: ``torch.isfinite`` forms ``|x|``, a float copy of the cube,
    which took ``mad_std``'s rise to 2.000 cube bytes at P and H and
    ``reproject``'s to 3.75 on the card.  ``valid_mask``, the read's
    finiteness mask and ``reproject``'s footprint now allocate bool arrays
    only: no operation allocates more than a quarter of the float32 cube
    (torch.isfinite's own largest allocation is the cube's size)."""
    path, _ = make_cube_file(tmp_path, shape=(16, 32, 64), seed=3)
    cube = T.SpectralCube.read(path, device="cpu")
    x = cube._data
    nbytes = x.numel() * 4
    assert _largest_allocation(lambda: torch.isfinite(x)) >= nbytes
    for fn in (lambda: rd.valid_mask(x, x > 0.5),
               lambda: cube.mask.include(data=x)):
        assert _largest_allocation(fn) <= nbytes // 4
    header = cube.header
    header["CRPIX1"] = float(header["CRPIX1"]) + 0.37
    rep = cube._reproject(header)
    assert torch.equal(rep.mask.include(data=rep._data),
                       torch.isfinite(rep._data))


def test_mad_std_forms_no_whole_cube_deviations(monkeypatch):
    """The unsharded mad_std forms its deviations from each piece's
    picked values: no torch.abs call sees more than SORT_CHUNK values,
    and below the limit it sees only the included values, never the
    whole cube."""
    data, include = make_case(np.float32, "include")
    t, valid = tensors(data, include)
    absolutes = Calls(monkeypatch, "abs")
    rd.masked_mad_std(t, valid)
    assert absolutes.sizes == [int(valid.sum())]
    monkeypatch.setattr(rd, "SORT_CHUNK", 40)
    absolutes.sizes.clear()
    rd.masked_mad_std(t, valid)
    assert len(absolutes.sizes) > 1 and max(absolutes.sizes) <= 40


@pytest.mark.parametrize("view", ["cut", "strided", "transposed"])
def test_pieces_of_a_strided_view(monkeypatch, view):
    """A strided view (a spatial cut, a stepped cut, a transposed cube)
    is cut into pieces without a copy of the whole: the pieces are views
    of its storage, cover it in order, and give the one-sort values bit
    for bit."""
    data, include = make_case(np.float32, "include")
    t, valid = tensors(data, include)
    pick = {"cut": lambda x: x[:, 2:8, 3:11],
            "strided": lambda x: x[::2, :, ::3],
            "transposed": lambda x: x.permute(2, 1, 0)}[view]
    d, v = pick(t), pick(valid)
    want = {name: fn(d, v) for name, fn in FUNCS.items()}
    monkeypatch.setattr(rd, "SORT_CHUNK", 9)
    parts = list(rd._pieces(d))
    assert len(parts) > 1 and all(p.numel() <= 9 for p in parts)
    assert all(p.untyped_storage().data_ptr()
               == d.untyped_storage().data_ptr() for p in parts)
    torch.testing.assert_close(torch.cat([p.reshape(-1) for p in parts]),
                               d.reshape(-1), rtol=0, atol=0,
                               equal_nan=True)
    for name, fn in FUNCS.items():
        assert bits(fn(d, v)) == bits(want[name]), name


def test_cube_and_pipeline_reach_the_pieces(monkeypatch, tmp_path):
    """``SpectralCube.mad_std``, ``median`` and ``percentile`` of a cube
    read from FITS, and ``run_pipeline``'s SNR mask from its noise, reach
    the pieces with SORT_CHUNK small and give the one-sort results bit for
    bit."""
    path, _ = make_cube_file(tmp_path, shape=SHAPE, seed=9)
    cube = T.SpectralCube.read(path, device="cpu")
    calls = {"mad_std": lambda c: c.mad_std().value,
             "median": lambda c: c.median().value,
             "percentile": lambda c: c.percentile(Q).value,
             "run_pipeline": lambda c: T.run_pipeline(
                 c, snr_threshold=1.0)["moments"][0].value}
    want = {k: fn(cube) for k, fn in calls.items()}
    monkeypatch.setattr(rd, "SORT_CHUNK", 50)
    sorts = Calls(monkeypatch, "sort")
    for key, fn in calls.items():
        sorts.sizes.clear()
        got = fn(cube)
        assert np.asarray(got).tobytes() == np.asarray(want[key]).tobytes()
        assert len(sorts.sizes) > 2 and max(sorts.sizes) <= 50, key


@pytest.mark.parametrize("dtype", ["float32", "float64", "int16", "bool"])
def test_fits_payload_is_written_in_chunks(monkeypatch, tmp_path, dtype):
    """``write_fits`` converts an image payload to big-endian
    ``WRITE_CHUNK`` bytes at a time, never as a whole-payload copy: the
    file is the JAX package's writer's byte for byte (C- and F-ordered
    data), and no payload write is longer than the chunk."""
    from spectral_cube_tpu.io import fits_low as jfl
    from spectral_cube_tpu_torch.io import fits_low as tfl
    rng = np.random.RandomState(4)
    data = rng.standard_normal((5, 7, 9)) * 100
    data = data > 0 if dtype == "bool" else data.astype(dtype)
    monkeypatch.setattr(tfl, "WRITE_CHUNK", 64)
    for i, arr in enumerate((data, np.asfortranarray(data))):
        ours, theirs = tmp_path / f"t{i}.fits", tmp_path / f"j{i}.fits"
        tfl.write_fits(str(ours), [tfl.HDU(data=arr, header=tfl.Header())])
        jfl.write_fits(str(theirs), [jfl.HDU(data=arr,
                                             header=jfl.Header())])
        assert ours.read_bytes() == theirs.read_bytes()
        assert tfl.read_fits(str(ours))[0].data.tobytes() == \
            np.asarray(data, np.uint8 if dtype == "bool" else dtype) \
            .tobytes()

    class Recorder:
        sizes = []

        def write(self, b):
            self.sizes.append(memoryview(b).nbytes)
    _, flat, be = tfl._image_payload(data)
    n = tfl._write_payload(Recorder(), flat, be)
    assert sum(Recorder.sizes) == n == data.size * be.itemsize
    assert len(Recorder.sizes) > 1 and max(Recorder.sizes) <= 64


def test_f22_a_first_pipeline_call_imports_no_sympy():
    """F22: ``valid_mask`` asked ``torch.broadcast_shapes`` whether an
    include fits the data in place; that call imports torch's symbolic
    shapes and SymPy, 2.5-3 s of host time in a process's first
    ``run_pipeline`` on the H100 machine.  A fresh process reads a cube
    from FITS and runs ``run_pipeline`` (chip_smoke.py's pipeline phase at
    24 x 32 x 32, on the CPU) without importing SymPy."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import os, sys, tempfile
        import chip_smoke as cs
        import spectral_cube_tpu_torch as T
        from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
        path = os.path.join(tempfile.mkdtemp(), "cube.fits")
        write_fits(path, [HDU(data=cs.synth_cube(24, 32, 32, cs.SEED),
                              header=cs.synth_header(24, 32, 32))])
        assert "sympy" not in sys.modules
        cube = T.SpectralCube.read(path, device="cpu")
        res = T.run_pipeline(cube, snr_threshold=cs.SNR,
                             target_beam=cs.beams()[1],
                             target_header=cs.shifted_header(cube.header,
                                                             *cs.SHIFT))
        assert res["statistics"]["npts"] > 0
        print(sorted(m for m in sys.modules if m.split(".")[0] == "sympy"))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
