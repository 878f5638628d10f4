"""Torch port: the varying-resolution path, the reprojection onto a new
spectral axis and a float64 cube's statistics, as they run on a cube past
2**31 voxels.

The FFT route of ``convolve_to`` builds each channel batch's transfers for
the beam groups that batch uses (``ops/convolve._convolve_groups_fft``)
and writes the flagged planes and the Jy/beam factors in place on its own
output; the four-corner gather, the staged spectral lerp
(``ops/regrid._zlerp_filled``) and the spline path's spatial step run a
slab of output channels at a time (``ops/regrid.SLAB_VOXELS``), the spline
path writing the filled data and then the NaN mask into one buffer; and
``reductions.masked_statistics`` sums and takes extrema a piece at a time.
Here the constants are set small by ``monkeypatch`` so that cubes of a few
thousand voxels take many batches, slabs and pieces, and each result is
held

- bit for bit against the same call with the default constants (one
  batch, one slab, one piece), and against the whole-cube form where
  the arithmetic is the same (the FFT route's transfers built all at
  once);
- against the JAX package's function on the same numpy inputs at its own
  tests' tolerances (``tests/test_torch_convolve.py``'s FFT tolerance,
  ``tests/test_torch_regrid.py``'s atol 5e-6, the moments tests' rtol
  1e-6);
- by the allocations the profiler sees: no operation makes a cube-sized
  array but those the repaired form keeps (F27, F28 and the memory the
  FFT route and the gather held on the card; ROADMAP.md Queue 3).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.ops import reductions as jred

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import cube as tcube
from spectral_cube_tpu_torch.ops import convolve as tconv
from spectral_cube_tpu_torch.ops import reductions as rd
from spectral_cube_tpu_torch.ops import regrid as tregrid

from test_torch_card_scale_reductions import make_case, same_bits
from test_torch_convolve import _den64, assert_fft_close
from test_torch_regrid import _rotated_header, _spectral_cube_file, _target
from test_torch_vrsc import _read_both, write_vr


def _allocations(fn):
    """The bytes each operation inside ``fn()`` allocated for itself on the
    CPU (the profiler's memory accounting), largest first."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    return sorted((e.self_cpu_memory_usage for e in prof.events()
                   if e.self_cpu_memory_usage > 0), reverse=True)


def _cube_sized(fn, nbytes):
    """How many allocations inside ``fn()`` are at least ``nbytes``."""
    return sum(1 for a in _allocations(fn) if a >= nbytes)


# -- masked_statistics ------------------------------------------------------

def _whole_cube_statistics(data, valid):
    """``masked_statistics`` as the port had it before its pieces: each sum
    and extremum one call over a filled copy of the cube, the count a
    bool sum (through an int64 copy)."""
    nan = float("nan")
    cnt = valid.sum()
    s = torch.where(valid, data, 0).sum()
    ss = torch.where(valid, data * data, 0).sum()
    mn = torch.where(valid, data, float("inf")).min()
    mx = torch.where(valid, data, -float("inf")).max()
    npts = cnt.to(data.dtype)
    mean = torch.where(cnt > 0, s / torch.clamp(npts, min=1), nan)
    dev = torch.where(valid, data - torch.where(cnt > 0, mean, 0.0), 0)
    s2c = (dev * dev).sum()
    return {"npts": cnt, "min": mn, "max": mx, "sum": s, "sumsq": ss,
            "mean": mean,
            "sigma": torch.sqrt(s2c / torch.clamp(npts - 1, min=1)),
            "rms": torch.sqrt(ss / torch.clamp(npts, min=1))}


STAT_KEYS = ("sum", "sumsq", "mean", "sigma", "rms")


@pytest.mark.parametrize("sums", [None, 37, 400])
@pytest.mark.parametrize("case", ["nan", "include", "broadcast"])
def test_masked_statistics_in_pieces_is_the_one_call(monkeypatch, case,
                                                     sums):
    """float64 (the cubes that reach it; float32 takes kernel 1): npts and
    the extrema exactly the whole-cube form's and the default pieces'
    (one piece at this size), the sums within 1e-15 relative of the
    whole-cube form's (a float64 sum is rounded once a piece)."""
    data, include = make_case(np.float64, case)
    t = torch.from_numpy(data)
    valid = rd.valid_mask(t, None if include is None
                          else torch.from_numpy(include))
    one = rd.masked_statistics(t, valid)
    if sums is not None:
        monkeypatch.setattr(rd, "SUM_CHUNK", sums)
        monkeypatch.setattr(rd, "SORT_CHUNK", 2 * sums)
        monkeypatch.setattr(rd, "SORT_PIECE", sums)
    got = rd.masked_statistics(t, valid)
    old = _whole_cube_statistics(t, valid.expand(t.shape))
    assert int(got["npts"]) == int(old["npts"]) == int(one["npts"])
    for k in ("min", "max"):
        assert same_bits(got[k], old[k]) and same_bits(got[k], one[k])
    for k in STAT_KEYS:
        assert abs(float(got[k]) - float(old[k])) <= 1e-15 * abs(
            float(old[k])), k


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["nan", "include"])
def test_masked_statistics_in_pieces_matches_jax(monkeypatch, dtype, case):
    """Against the JAX package's ``masked_statistics`` on the same inputs
    (float32 in JAX's default precision), the pieces set small: npts
    exact, the extrema exact on float32 data, the sums (and a float64
    cube's extrema) within the moments tests' rtol 1e-6."""
    data, include = make_case(dtype, case)
    monkeypatch.setattr(rd, "SUM_CHUNK", 41)
    monkeypatch.setattr(rd, "SORT_CHUNK", 60)
    monkeypatch.setattr(rd, "SORT_PIECE", 30)
    t = torch.from_numpy(data)
    got = rd.masked_statistics(t, rd.valid_mask(
        t, None if include is None else torch.from_numpy(include)))
    jd = jnp.asarray(data)
    ref = jred.masked_statistics(jd, jred.valid_mask(
        jd, None if include is None else jnp.asarray(include)))
    assert int(got["npts"]) == int(ref["npts"])
    for k in ("min", "max") if dtype == np.float32 else ():
        assert float(got[k]) == float(np.asarray(ref[k]))
    for k in STAT_KEYS + (("min", "max") if dtype == np.float64 else ()):
        np.testing.assert_allclose(float(got[k]), float(np.asarray(ref[k])),
                                   rtol=1e-6, err_msg=k)


def test_f27_float64_statistics_count_no_whole_cube(monkeypatch, tmp_path):
    """F27: ``statistics()`` of a float64 cube summed its bool validity
    whole (torch's int64 copy, the float64 cube's bytes) and made four
    filled copies and the squares of the whole cube; on the card a float64
    P (18 GiB) rose past 2 cube bytes.  Now no operation allocates more
    than the bool validity (an eighth of the cube), and npts equals the
    float32 kernel's, mean and sigma within 1e-6 of it.  (On the card:
    a rise of 2.250 cube bytes, over the limit of 2.)"""
    path, _ = _vr_free_cube(tmp_path)
    cube = T.SpectralCube.read(path, device="cpu")
    data = cube._data.double()
    c64 = T.SpectralCube(data, cube.wcs, header=cube.header,
                         mask=T.LazyMask(torch.isfinite, data=data,
                                         wcs=cube.wcs))
    monkeypatch.setattr(rd, "SUM_CHUNK", 1 << 10)
    monkeypatch.setattr(rd, "SORT_CHUNK", 1 << 12)
    monkeypatch.setattr(rd, "SORT_PIECE", 1 << 10)
    nbytes = data.numel() * 8
    assert max(_allocations(c64.statistics)) <= nbytes // 8
    valid = rd.valid_mask(data)
    assert _cube_sized(lambda: _whole_cube_statistics(data, valid),
                       nbytes) >= 3
    got, want = c64.statistics(), cube.statistics()
    assert got["npts"] == want["npts"]
    for k in ("mean", "sigma"):
        assert abs(got[k].value - want[k].value) <= 1e-6 * abs(
            want[k].value), k


def _vr_free_cube(tmp_path, shape=(16, 32, 48)):
    """A single-beam cube file with a NaN border and NaN holes."""
    from conftest import make_cube_file
    return make_cube_file(tmp_path, shape=shape, seed=11)


# -- the FFT route ------------------------------------------------------------

def _vr_cube(tmp_path, nchan=8, groups=1, nan_beams=(3,)):
    path = tmp_path / "vr.fits"
    write_vr(path, shape=(nchan, 30, 34), groups=groups, nan_beams=nan_beams)
    return _read_both(str(path))


def _fft_batches(monkeypatch, channels):
    """``_FFT_CHUNK_BYTES`` set so that a batch holds ``channels`` padded
    planes of the cube's FFT route."""
    real = tconv._fft_channels

    def fewer(fy, fx):
        return min(real(fy, fx), channels)
    monkeypatch.setattr(tconv, "_fft_channels", fewer)


def _fft_parts(tc, cb):
    """The FFT route's filled data, beams (the target standing in for a
    flagged plane's), groups, kernels and padded plane, as
    ``convolve_to`` forms them."""
    filled = tc._get_filled_data(fill=np.nan)
    pix = np.radians(2.0 / 3600.0)
    beams = [b if good else cb
             for b, good in zip(tc.unmasked_beams, tc.goodbeams_mask)]
    groups, gidx = tconv.beam_groups(beams)
    kernels = [None if cb.deconvolve(b).major_rad <= 0
               else cb.deconvolve(b).as_kernel(pix) for b in groups]
    fy, fx = tconv._padded_shape(filled.shape[1:], tuple(np.max(
        [k.shape for k in kernels if k is not None], axis=0)))
    return filled, beams, groups, gidx, kernels, fy, fx


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("batch", [None, 1, 3, 5])
def test_fft_route_in_batches_is_the_one_call(monkeypatch, tmp_path, groups,
                                              batch):
    """``convolve_to`` on the FFT route (PA 30-34 beams, a flagged plane,
    Jy/beam factors), each batch of channels building the transfers of
    the groups it uses (groups shared across batches where a beam holds
    over ``groups`` channels).  In the default batches it is bit for bit
    the whole-stack form, every group's transfer built at once, its flagged
    plane written on a clone and the factors multiplied into a new cube;
    in batches of ``batch`` channels (a batched FFT's values follow its
    batch) within the FFT tolerance of ``tests/test_torch_convolve.py``
    (1e-6 of the largest |value|, weighted by the denominator where it is
    below 0.1) of the float64 form; in one batch also of the JAX
    package."""
    tc, jc = _vr_cube(tmp_path, groups=groups)
    cb = tc.common_beam()
    filled, beams, groups_, gidx, kernels, fy, fx = _fft_parts(tc, cb)
    factors = np.array([tconv.beam_unit_factor(tc.unit, b, cb)
                        for b in beams])
    assert not np.allclose(factors, 1.0)
    f = torch.as_tensor(factors)[:, None, None]
    if batch is not None:
        _fft_batches(monkeypatch, batch)
    got = tc.convolve_to(cb)
    assert tconv.convolve_cube_to_beam.last["route"] == "fft"
    assert tconv.convolve_cube_to_beam.last["groups"] == len(groups_)
    assert torch.isnan(got._data[3]).all()
    monkeypatch.undo()
    if batch is None:
        stack = tconv._convolve_planes(filled, tconv._transfers(
            kernels, fy, fx, filled.device), gidx).clone()
        stack[3] = float("nan")
        assert same_bits(got._data, stack * f.to(torch.float32))
    f64 = tconv._convolve_planes(filled.double(), tconv._transfers(
        kernels, fy, fx, filled.device, torch.complex128), gidx)
    f64[3] = float("nan")
    f64 = (f64 * f).numpy()
    data = filled.numpy()
    den = _den64(data, kernels, gidx)
    scale = float(np.nanmax(np.abs(f64)))
    assert_fft_close(got._data.numpy(), f64, den, scale)
    if batch is None:
        # two float32 FFTs may land a denominator near its 1e-6 floor on
        # either side: the JAX package's batch is the whole cube
        ref = np.asarray(jc.convolve_to(jc.common_beam())._data)
        assert_fft_close(got._data.numpy(), ref, den, scale)


def test_fft_route_builds_no_whole_transfer_stack(monkeypatch, tmp_path):
    """The FFT route built every beam group's transfer at once, (groups,
    fy, fx // 2 + 1) complex64: at P's 2302 groups on 1152² planes 11.4
    GiB, past the 9 GiB cube (``convolve_to`` rose 3.508 cube bytes on the
    card), cloned its output to write the flagged planes and multiplied
    it into a new cube by the Jy/beam factors.  Now, in batches of two
    channels, no operation of ``convolve_to`` allocates more than the
    cube's bytes, and only the filled copy and the output reach them."""
    tc, _ = _vr_cube(tmp_path, nchan=24)
    cb = tc.common_beam()
    nbytes = tc._data.numel() * 4
    _, _, groups, _, _, fy, fx = _fft_parts(tc, cb)
    assert len(groups) * fy * (fx // 2 + 1) * 8 > nbytes
    _fft_batches(monkeypatch, 2)
    allocs = _allocations(lambda: tc.convolve_to(cb))
    assert tconv.convolve_cube_to_beam.last["route"] == "fft"
    assert max(allocs) <= nbytes
    assert sum(1 for a in allocs if a >= nbytes) == 2


def test_identity_route_leaves_the_callers_data(tmp_path):
    """The identity route hands back the caller's tensor: its flagged
    planes are written on a copy, and a Jy/beam factor multiplies a copy
    (``cube._rescaled``), the input untouched; an output the route made
    is rescaled in place."""
    data = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    keep = data.clone()
    beam = T.Beam(T.Quantity(6.0, "arcsec"), T.Quantity(6.0, "arcsec"),
                  T.Quantity(0, "deg"))
    out, factors = tconv.convolve_cube_to_beam(
        data, beam, beam, np.radians(2.0 / 3600.0),
        goodchannels=np.array([True, False]))
    assert tconv.convolve_cube_to_beam.last["route"] == "identity"
    assert out is not data and torch.equal(data, keep)
    assert torch.isnan(out[1]).all() and torch.equal(out[0], keep[0])
    same, _ = tconv.convolve_cube_to_beam(data, beam, beam,
                                          np.radians(2.0 / 3600.0))
    assert same is data
    twice = tcube._rescaled(same, np.array([2.0, 2.0]), data)
    assert twice is not data and torch.equal(data, keep)
    assert torch.equal(twice, 2 * keep)
    made = keep.clone()
    assert tcube._rescaled(made, np.array([2.0, 3.0]), data) is made
    assert torch.equal(made[1], 3 * keep[1])
    assert tcube._rescaled(made, np.ones(2), data) is made


# -- the four-corner gather ---------------------------------------------------

def _gather_case(tmp_path):
    path = tmp_path / "g.fits"
    h = _spectral_cube_file(path, nchan=12, ny=30, nx=32)
    tcube_, jcube = _read_both(str(path))
    return h, tcube_, jcube


@pytest.mark.parametrize("order", ["bilinear", "nearest-neighbor"])
@pytest.mark.parametrize("spectral", ["same", "new"])
@pytest.mark.parametrize("slab", [1, 3])
def test_gather_in_slabs_is_the_one_call(monkeypatch, tmp_path, order,
                                         spectral, slab):
    """``reproject`` onto a rotated grid (the four-corner gather) with the
    input's spectral axis or a new one, NaN holes and a NaN border, a slab
    of ``slab`` output channels at a time: bit for bit the one slab, and
    against the JAX package at atol 5e-6."""
    h, tc, jc = _gather_case(tmp_path)
    target = _rotated_header(h, 3.0)
    if spectral == "new":
        target = _rotated_header(_target(h, 5, 2.0, 0.25, 0.0, 0.0), 3.0)
    one = tc.reproject(target, order=order)
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", slab * 30 * 32)
    got = tc.reproject(target, order=order)
    assert same_bits(got._data, one._data)
    ref = np.asarray(jc.reproject(target, order=order)._data)
    g = got._data.numpy()
    assert np.array_equal(np.isnan(g), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert fin.mean() > 0.3
    np.testing.assert_allclose(g[fin], ref[fin], atol=5e-6)


def test_gather_makes_one_cube(monkeypatch, tmp_path):
    """The four-corner gather held the NaN-filled cube, its
    channels-minor copy, the accumulator, a gathered corner and the
    transposed output at once (about five cubes; 63 GiB in the rotated
    ``reproject`` of V (a) at P, a rise of 5.005 cube bytes).  In slabs
    the output is the only cube-sized allocation."""
    h, tc, _ = _gather_case(tmp_path)
    data = tc._get_filled_data(fill=np.nan)
    nbytes = data.numel() * 4
    zs, ys, xs, _ = tregrid.reproject_mappings(
        tc.wcs, _rotated_header(h, 3.0), 12,
        spectral_values_in=np.asarray(tc.spectral_axis.value))
    maps = tregrid.bilinear_host_maps(zs, ys, xs, *data.shape, 1)
    assert _cube_sized(lambda: tregrid._gather_resample(data, maps, 1),
                       nbytes) >= 5
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", 2 * 30 * 32)
    assert _cube_sized(lambda: tregrid._gather_resample(data, maps, 1),
                       nbytes) == 1


# -- the staged spectral lerp (kernel #7's inputs) ----------------------------

@pytest.mark.parametrize("step,start,nz", [(1.0, 0.25, 23), (2.0, 0.0, 11),
                                           (0.5, 1.5, 30)])
@pytest.mark.parametrize("slab", [1, 4])
def test_zlerp_filled_in_slabs_is_the_one_call(monkeypatch, tmp_path, step,
                                               start, nz, slab):
    """``_zlerp_filled`` a slab of output channels at a time: fz, wz and
    the channel flags bit for bit the one slab's; the reprojection onto
    the new spectral axis and the shifted grid (kernel #7's path) bit for
    bit too, and against the JAX package at atol 5e-6."""
    p = tmp_path / "z.fits"
    h = _spectral_cube_file(p)
    target = _target(h, nz, step, start)
    tc, jc = _read_both(str(p))
    data = tc._get_filled_data(fill=np.nan)
    zs = tregrid.reproject_mappings(tc.wcs, target, data.shape[0])[0]
    maps = tregrid.bilinear_host_maps(zs, zs[:1, None], zs[:1, None],
                                      *data.shape, 1)
    one = tregrid._zlerp_filled(data, maps[1], maps[2])
    whole = tc.reproject(target)
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", slab * data[0].numel())
    got = tregrid._zlerp_filled(data, maps[1], maps[2])
    for a, b in zip(got, one):
        assert same_bits(a, b)
    rep = tc.reproject(target)
    assert same_bits(rep._data, whole._data)
    ref = np.asarray(jc.reproject(target)._data)
    g = rep._data.numpy()
    assert np.array_equal(np.isnan(g), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(g[fin], ref[fin], atol=5e-6)


def test_f28_zlerp_filled_makes_fz_and_wz_alone(monkeypatch, tmp_path):
    """F28: the staged lerp held the filled cube, its float NaN mask and
    each lerp's three cube-sized terms at once: S bilinear at P peaked at
    71.98 GiB, 90.9% of the card, past the 90% limit.  In slabs fz and
    wz are its only cube-sized allocations."""
    p = tmp_path / "z.fits"
    h = _spectral_cube_file(p)
    tc, _ = _read_both(str(p))
    data = tc._get_filled_data(fill=np.nan)
    nz = data.shape[0] - 1
    z0 = np.arange(nz, dtype=np.int32)
    zf = np.full(nz, 0.25, np.float32)
    nbytes = nz * data[0].numel() * 4
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", 2 * data[0].numel())
    assert _cube_sized(lambda: tregrid._zlerp_filled(data, z0, zf),
                       nbytes) == 2


# -- the spline path ----------------------------------------------------------

@pytest.mark.parametrize("order", ["biquadratic", "bicubic"])
@pytest.mark.parametrize("grid", ["shifted", "rotated"])
@pytest.mark.parametrize("slab", [1, 2])
def test_spline_path_in_slabs_is_the_one_call(monkeypatch, tmp_path, order,
                                              grid, slab):
    """The spline path onto a new spectral axis (the filled data and the
    NaN mask a slab at a time into one buffer, kernel #14's operator on
    each) and a shifted (separable products) or rotated (prefilter and tap
    gathers) grid, a slab of output channels at a time: bit for bit the
    one slab, and against the JAX package at atol 5e-6."""
    path = tmp_path / "s.fits"
    h = _spectral_cube_file(path, nchan=12, ny=30, nx=32)
    tc, jc = _read_both(str(path))
    target = _target(h, 5, 2.0, 0.25)
    if grid == "rotated":
        target = _rotated_header(_target(h, 5, 2.0, 0.25, 0.0, 0.0), 3.0)
    one = tc.reproject(target, order=order)
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", slab * 30 * 32)
    got = tc.reproject(target, order=order)
    assert same_bits(got._data, one._data)
    ref = np.asarray(jc.reproject(target, order=order)._data)
    g = got._data.numpy()
    assert np.array_equal(np.isnan(g), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert fin.mean() > 0.3
    np.testing.assert_allclose(g[fin], ref[fin], atol=5e-6)


def test_spline_path_holds_four_cubes_at_most(monkeypatch, tmp_path):
    """The spline path's cube-sized allocations in slabs: the buffer of
    the filled data and then the NaN mask, fz, wz and the output (the
    whole-cube form held the float NaN mask, the filled copy, fz, wz and
    then two of the spatial products' cubes beside them)."""
    path = tmp_path / "s.fits"
    h = _spectral_cube_file(path, nchan=12, ny=30, nx=32)
    tc, _ = _read_both(str(path))
    data = tc._get_filled_data(fill=np.nan)
    target = _target(h, 11, 1.0, 0.25)
    zs, ys, xs, _ = tregrid.reproject_mappings(
        tc.wcs, target, 12,
        spectral_values_in=np.asarray(tc.spectral_axis.value))
    nbytes = 11 * 30 * 32 * 4
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", 2 * 30 * 32)
    monkeypatch.setattr(tregrid._bm, "banded_matmul", _one_output_product)
    assert _cube_sized(lambda: tregrid._spline_spatial_then_z(
        data, zs, ys, xs, 3), nbytes) == 4


def _one_output_product(flat, bands):
    """Kernel #14's product allocating its output alone, as the kernel
    does (its plain version's row gathers are the CPU's, not the path's):
    the dense operator of ``bands`` times ``flat``."""
    start, length, taps = bands[:3]
    M = np.zeros((len(start), flat.shape[0]), np.float32)
    for r, (a, n) in enumerate(zip(start, length)):
        M[r, a:a + n] = taps[r, :n]
    return torch.matmul(torch.as_tensor(M), flat)
