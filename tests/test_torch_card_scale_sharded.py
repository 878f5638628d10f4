"""Torch port: the sharded path as it runs past 2**31 voxels on the meshes
of one card (``chip_smoke.py``'s card-scale part M).

On one card the default mesh has one position, whose one shard is the
whole cube, so every sharded function meets the cube's own size there;
four positions of the card make shards of a quarter.  The multi-device
layer now runs on the unsharded helpers' pieces:

- the whole-cube sums and extremes over the mesh on each shard's
  ``reductions._whole_total`` / ``_whole_extremum`` pieces, the
  reductions over the planes and along a tuple with the spectral axis a
  tile of whole lanes at a time (``reductions.lane_tiles``), order
  statistics too (F29, F30);
- a cube given to ``to_sharded`` no longer keeps its unsharded data alive
  through its mask (F31);
- the FFT reshard builds each channel batch's transfers alone
  (``ops/convolve._convolve_batches``), writes the Jy/beam factors and the
  flagged planes in place (``cube._rescaled``) and finds its empty
  channels with ``reductions.finite``; the reshard reprojection gathers a
  slab of channels at a time (``ops/regrid._gather_slabs``); an
  all-to-all over a mesh axis of one position hands its tiles through,
  and one over a longer axis frees its sources a row at a time (F32).

Here ``SUM_CHUNK``, ``SORT_CHUNK``, ``SORT_PIECE``, ``SLAB_VOXELS`` and the
FFT route's batch are set small by ``monkeypatch`` so that cubes of a few
thousand voxels take many pieces, tiles, slabs and batches, on a mesh of
one position (``CubeMesh(devices=['cpu'])``), a 2 x 2 mesh and the 2 x 4
mesh of eight.  Each result is held bit for bit against the unsharded
port's one call (sums, within 1e-6 of float64: a sum over an axis the mesh
splits runs in another order), and against the JAX package's
``ShardedCube`` on its 8-device CPU mesh at the JAX tests' tolerances; the
faults by the allocations the CPU profiler sees.
"""

import gc
import weakref

import numpy as np
import jax
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu import parallel as jpar

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch.parallel import sharded as tsh
from spectral_cube_tpu_torch.ops import convolve as tconv
from spectral_cube_tpu_torch.ops import reductions as rd
from spectral_cube_tpu_torch.ops import regrid as tregrid

from conftest import make_cube_file
from test_torch_card_scale import Calls
from test_torch_card_scale_reductions import same_bits
from test_torch_card_scale_vrsc import (_allocations, _cube_sized,
                                        _fft_batches, _fft_parts, _vr_cube)
from test_torch_convolve import _den64, assert_fft_close
from test_torch_regrid import _rotated_header

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

#: the cube's shape: the 2 x 2 and 2 x 4 meshes divide its plane
SHAPE = (24, 16, 20)
THRESHOLD = 0.3
MESHES = {"one": dict(devices=["cpu"]),
          "grid": dict(devices=["cpu"] * 4, shape=(2, 2)),
          "eight": dict(devices=["cpu"] * 8)}


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) != 8:
        pytest.skip("multi-device tests need the 8-device virtual mesh")
    return jpar.CubeMesh()


@pytest.fixture(scope="module")
def cube_file(tmp_path_factory):
    path, _ = make_cube_file(tmp_path_factory.mktemp("sharded_card"),
                             name="c.fits", shape=SHAPE, seed=13)
    return path


def mesh(name):
    return tpar.CubeMesh(**MESHES[name])


def small_pieces(monkeypatch):
    """Pieces, tiles and slabs of a few hundred voxels."""
    monkeypatch.setattr(rd, "SUM_CHUNK", 1 << 8)
    monkeypatch.setattr(rd, "SORT_CHUNK", 1 << 11)
    monkeypatch.setattr(rd, "SORT_PIECE", 1 << 9)
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", 1 << 9)


def masked(cube, pkg):
    return cube.with_mask(cube > pkg.Quantity(THRESHOLD, cube.unit))


def _np(x):
    x = getattr(x, "value", x)
    if isinstance(x, tuple):
        return np.array(x)
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


# -- the reductions over the mesh -------------------------------------------

SUMS = ("sum", "mean", "std")
EXTREMES = ("max", "min")
ORDERS = ("median", "mad_std", "percentile")
CASES = [(n, a) for n in SUMS + EXTREMES
         for a in (None, (1, 2), (0, 1), (0, 2))] \
    + [(n, a) for n in ORDERS for a in (None, (1, 2), (0, 1), (0, 2))]


def reduce(cube, name, axis):
    if name == "percentile":
        return cube.percentile(30, axis=axis)
    return getattr(cube, name)(axis=axis)


def float64_reduction(cube, name, axis):
    """The float64 value of a sum, mean or std (n) of the included finite
    voxels, NaN where none is."""
    data = cube._data.double().numpy()
    ok = np.isfinite(data) & np.broadcast_to(
        cube.mask.include(data=cube._data).numpy(), data.shape)
    x = np.where(ok, data, 0.0)
    n = ok.sum(axis=axis)
    s = x.sum(axis=axis)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = s / n
        if name == "sum":
            out = s
        elif name == "mean":
            out = mean
        else:
            m = mean if axis is None else np.expand_dims(
                mean, tuple(sorted(axis)))
            out = np.sqrt(np.where(ok, (data - m) ** 2, 0.0).sum(axis) / n)
    return np.where(n > 0, out, np.nan)


@pytest.mark.parametrize("name,axis", CASES,
                         ids=[f"{n}-{a}" for n, a in CASES])
@pytest.mark.parametrize("where", sorted(MESHES))
def test_reductions_over_the_mesh_are_the_one_call(monkeypatch, cube_file,
                                                   where, name, axis):
    """Every whole-cube reduction and every reduction over a tuple with or
    without the spectral axis, the pieces, tiles and lanes small: the
    extremes and order statistics bit for bit the unsharded call's, the
    sums within 1e-6 of float64 (and of the unsharded call); gathers 0."""
    small_pieces(monkeypatch)
    tc = masked(T.SpectralCube.read(cube_file, device="cpu"), T)
    cmesh = mesh(where)
    sc = masked(tpar.ShardedCube(T.SpectralCube.read(cube_file,
                                                     device="cpu"), cmesh),
                T)
    cmesh.reset_counters()
    got = _np(reduce(sc, name, axis))
    assert cmesh.counters["gathers"] == 0
    want = _np(reduce(tc, name, axis))
    assert got.shape == want.shape and got.dtype == want.dtype
    if name in SUMS:
        f64 = float64_reduction(tc, name, axis)
        assert np.array_equal(np.isnan(got), np.isnan(f64))
        fin = ~np.isnan(f64)
        np.testing.assert_allclose(got[fin], f64[fin], rtol=1e-6)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
    else:
        assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("name,axis", [
    (n, a) for n, a in CASES if a in (None, (1, 2), (0, 1))],
    ids=[f"{n}-{a}" for n, a in CASES if a in (None, (1, 2), (0, 1))])
def test_reductions_over_the_mesh_match_jax(monkeypatch, cube_file, jmesh,
                                            name, axis):
    """The same reductions on the one-position mesh against the JAX
    package's ShardedCube on its 8-device mesh, at the JAX tests'
    tolerances (rtol 1e-5, atol 1e-6), NaN patterns equal."""
    small_pieces(monkeypatch)
    sc = masked(tpar.ShardedCube(T.SpectralCube.read(cube_file,
                                                     device="cpu"),
                                 mesh("one")), T)
    jsc = jpar.ShardedCube(masked(J.SpectralCube.read(cube_file), J), jmesh)
    got, want = _np(reduce(sc, name, axis)), _np(reduce(jsc, name, axis))
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", SUMS + EXTREMES)
@pytest.mark.parametrize("axis", [None, (1, 2)], ids=["cube", "planes"])
def test_f29_sums_over_the_mesh_count_in_pieces(monkeypatch, cube_file, name,
                                                axis):
    """F29: the whole-cube sums and extremes over the mesh, and the sums
    over the planes, counted each shard's validity whole (torch's int64
    copy, two float32 cubes' bytes) beside a filled copy and, for std,
    whole float64 deviations; on the card's one-position mesh P rose
    2.500-4.500 cube bytes (limit 2).  On a one-position mesh no operation
    now allocates more than the bool validity (a quarter of the cube)."""
    small_pieces(monkeypatch)
    sc = tpar.ShardedCube(T.SpectralCube.read(cube_file, device="cpu"),
                          mesh("one"))
    nbytes = sc._data.blocks[0].numel() * 4
    assert max(_allocations(lambda: reduce(sc, name, axis))) <= nbytes // 4


@pytest.mark.parametrize("name", ORDERS)
@pytest.mark.parametrize("axis", [(0, 1), (0, 2)])
def test_f30_order_statistics_along_a_tuple_sort_lane_tiles(
        monkeypatch, cube_file, name, axis):
    """F30: an order statistic along the spectral axis and a spatial one
    filled, permuted and sorted each slab's whole part at once: on the
    card's one-position mesh one sort of P's 2.4e9 values (out of memory
    asking for 9 GiB), on four positions a rise of 6.250 cube bytes.  Now
    each tile of whole lanes is sorted on its own, no sort sees more than
    SORT_PIECE values and no operation allocates more than the bool
    validity; the values are the one call's bit for bit."""
    small_pieces(monkeypatch)
    sc = tpar.ShardedCube(T.SpectralCube.read(cube_file, device="cpu"),
                          mesh("one"))
    nbytes = sc._data.blocks[0].numel() * 4
    sorts = Calls(monkeypatch, "sort")
    got = _np(reduce(sc, name, axis))
    assert sorts.sizes and max(sorts.sizes) <= rd.SORT_PIECE
    assert max(_allocations(lambda: reduce(sc, name, axis))) <= nbytes // 4
    want = _np(reduce(T.SpectralCube.read(cube_file, device="cpu"), name,
                      axis))
    assert np.array_equal(got, want, equal_nan=True)


def test_lane_tiles_cover_every_lane_once(monkeypatch):
    """``_by_lane_tiles`` hands each lane to one reduction, in order, in
    tiles whose parts on all positions hold at most SORT_PIECE values
    together (a lane at least), and all the lanes at once up to
    SORT_CHUNK."""
    monkeypatch.setattr(rd, "SORT_CHUNK", 64)
    monkeypatch.setattr(rd, "SORT_PIECE", 24)
    seen = []

    def reduce_(pieces):
        sl = pieces[0]
        seen.append(sl)
        return torch.arange(sl.start, sl.stop, dtype=torch.float64)
    parts = [(5, lambda sl: sl), (3, lambda sl: sl)]
    cmesh = tpar.CubeMesh(devices=["cpu"] * 2)
    out = tsh._by_lane_tiles(cmesh, reduce_, 11, parts)
    assert torch.equal(out, torch.arange(11, dtype=torch.float64))
    assert all(s.stop - s.start == 3 for s in seen[:-1])
    assert [s.start for s in seen] == list(range(0, 11, 3))
    seen.clear()
    tsh._by_lane_tiles(cmesh, reduce_, 11,
                       [(2, lambda sl: sl), (3, lambda sl: sl)])
    assert seen == [slice(0, 11, 1)]


# -- to_sharded --------------------------------------------------------------

@pytest.mark.parametrize("where", sorted(MESHES))
def test_f31_to_sharded_frees_the_unsharded_data(cube_file, where):
    """F31: a read cube's finiteness mask is bound to its data, and the
    ShardedCube ``to_sharded`` made kept that mask, so the unsharded
    tensor stayed alive beside the shards (on the card 18.00 GiB in use
    before V (a) on four positions, where the shards are 9.00, and out of
    memory on one).  The mask now goes to the shards unbound, each shard
    evaluating it on its own data: the unsharded tensor is freed with its
    cube, and the moments and the include are the unsharded cube's."""
    tc = T.SpectralCube.read(cube_file, device="cpu")
    want = [np.asarray(m.value) for m in (masked(tc, T).moment0(),
                                          masked(tc, T).moment1())]
    inc = tc.mask.include(data=tc._data).numpy()
    alive = weakref.ref(tc._data)
    cmesh = mesh(where)
    sc = tc.to_sharded(cmesh)
    del tc
    gc.collect()
    assert alive() is None
    cmesh.reset_counters()
    got = masked(sc, T).moment_maps()
    assert cmesh.counters["gathers"] == 0
    for g, w in zip(got, want):
        g = np.asarray(g.value)
        if where == "one":
            assert g.tobytes() == w.tobytes()
        else:
            # the moments kernel's plain version sums a tile's spaxels in
            # an order that follows the tile's shape
            assert np.array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-6)
    assert np.array_equal(np.asarray(sc.mask.include()), inc)


# -- the FFT reshard ---------------------------------------------------------

@pytest.mark.parametrize("where", sorted(MESHES))
def test_f32_fft_reshard_builds_each_batch_s_transfers(monkeypatch,
                                                       tmp_path, where):
    """F32 (the FFT route over a mesh): each position built the transfers
    of every beam group its channel block uses at once (on one position
    at P all 2302 groups, 11.4 GiB).  Now each batch of channels builds
    its own groups' alone, the transfer calls holding at most a batch's
    groups; on one position the result is the unsharded FFT route's bit
    for bit (the same batches), elsewhere within the FFT tolerance of
    ``tests/test_torch_convolve.py`` (a block's last batch may hold fewer
    channels, and a batched FFT's bits follow its batch), the flagged
    plane NaN."""
    tc, _ = _vr_cube(tmp_path, nchan=24)
    cb = tc.common_beam()
    filled, _, _, gidx, kernels, _, _ = _fft_parts(tc, cb)
    den = _den64(filled.numpy(), kernels, gidx)
    _fft_batches(monkeypatch, 2)
    built = []
    real = tconv._transfers

    def transfers(kernels, *args, **kwargs):
        built.append(len(kernels))
        return real(kernels, *args, **kwargs)
    monkeypatch.setattr(tconv, "_transfers", transfers)
    want = tc.convolve_to(cb)._data.numpy()
    assert tconv.convolve_cube_to_beam.last["route"] == "fft"
    built.clear()
    cmesh = mesh(where)
    sc = tc.to_sharded(cmesh)
    cmesh.reset_counters()
    got = sc.convolve_to(cb)
    assert cmesh.counters["gathers"] == 0
    assert cmesh.counters["all_to_alls"] == 4
    assert built and max(built) <= 2
    got = np.asarray(got.unmasked_data[:].value)
    assert np.isnan(got[3]).all()
    if where == "one":
        assert got.tobytes() == want.tobytes()
    else:
        assert_fft_close(got, want, den, np.nanmax(np.abs(want)))


def test_f32_fft_reshard_makes_no_cube_but_its_own(monkeypatch, tmp_path):
    """F32 (memory): on one position the FFT route's reshard copied the
    cube twice each way, formed ``torch.isfinite``'s float copy and a
    NaN-ed copy of its output, and the Jy/beam factors and the flagged
    planes made a new cube each.  Now, in batches of two channels, no
    operation of ``convolve_to`` allocates more than the cube's bytes and
    only the filled copy and the output reach them."""
    tc, _ = _vr_cube(tmp_path, nchan=24)
    cb = tc.common_beam()
    nbytes = tc._data.numel() * 4
    sc = tc.to_sharded(mesh("one"))
    _fft_batches(monkeypatch, 2)
    allocs = _allocations(lambda: sc.convolve_to(cb))
    assert max(allocs) <= nbytes
    assert sum(1 for a in allocs if a >= nbytes) == 2


def test_f32_fft_reshard_matches_jax(tmp_path):
    """The FFT reshard on the one-position mesh (its default batch, the
    whole cube) against the JAX package's ``convolve_to`` (the JAX
    sharded route convolves each device's few channels as one batch, and
    two float32 FFTs of other batches may land a denominator near its
    1e-6 floor on either side), within the FFT tolerance of
    ``tests/test_torch_convolve.py``, the flagged plane NaN."""
    tc, jc = _vr_cube(tmp_path)
    cb = tc.common_beam()
    filled, _, _, gidx, kernels, _, _ = _fft_parts(tc, cb)
    got = np.asarray(tc.to_sharded(mesh("one")).convolve_to(
        cb).unmasked_data[:].value)
    want = np.asarray(jc.convolve_to(jc.common_beam())._data)
    assert np.isnan(got[3]).all()
    assert_fft_close(got, want, _den64(filled.numpy(), kernels, gidx),
                     np.nanmax(np.abs(want)))


def test_f32_empty_channels_found_without_a_float_copy(cube_file):
    """F32 (finiteness): the halo and FFT routes found the channels with
    no finite value through ``torch.isfinite``, a float copy of the tile
    (row d): now ``reductions.finite``, bool arrays only."""
    cmesh = mesh("one")
    sc = tpar.ShardedCube(T.SpectralCube.read(cube_file, device="cpu"),
                          cmesh)
    tiles, _, shape = tsh._pad_spatial(sc._data, cmesh, 0.0)
    nbytes = tiles[0].numel() * 4
    tiles[0][5] = float("nan")
    outs = [t.clone() for t in tiles]
    assert max(_allocations(lambda: tsh._nan_empty_channels(
        cmesh, outs, tiles, shape))) <= nbytes // 4
    got = tsh._nan_empty_channels(cmesh, outs, tiles, shape)
    assert torch.isnan(got[0][5]).all() and not torch.isnan(got[0][4]).any()


# -- the reshard reprojection -------------------------------------------------

def _reprojections(tc):
    """(label, header, order) of the reshard strategy's cases: the grid
    rotated by 3 deg on the cube's own spectral axis (bilinear and
    nearest), and rotated onto a spectral axis of one channel fewer a
    quarter channel in (the spectral lerp)."""
    h = _rotated_header(tc.header, 3.0)
    z = h.__class__(h)
    z["NAXIS3"] = tc.shape[0] - 1
    z["CRPIX3"] = float(h["CRPIX3"]) - 0.25
    return [("rotated", h, "bilinear"), ("nearest", h, "nearest-neighbor"),
            ("lerped", z, "bilinear")]


@pytest.mark.parametrize("case", ["rotated", "nearest", "lerped"])
@pytest.mark.parametrize("where", sorted(MESHES))
def test_f32_reshard_reprojection_is_the_gather_in_slabs(
        monkeypatch, cube_file, where, case):
    """The reshard strategy (a rotated target, order 0 and a spectral
    lerp) gathers each channel block a slab of channels at a time with the
    unsharded gather's taps: bit for bit the unsharded reprojection, its
    footprint included; all-to-alls, no gather."""
    small_pieces(monkeypatch)
    tc = T.SpectralCube.read(cube_file, device="cpu")
    label, header, order = {c[0]: c for c in _reprojections(tc)}[case]
    want = tc.reproject(header, order=order)
    cmesh = mesh(where)
    sc = tc.to_sharded(cmesh)
    cmesh.reset_counters()
    got = sc.reproject(header, order=order)
    assert cmesh.counters["gathers"] == 0
    assert cmesh.counters["all_to_alls"] > 0
    assert np.asarray(got.unmasked_data[:].value).tobytes() \
        == want._data.numpy().tobytes()
    assert np.array_equal(np.asarray(got.filled_data[:].value),
                          np.asarray(want.filled_data[:].value),
                          equal_nan=True)


@pytest.mark.parametrize("case", ["rotated", "lerped"])
def test_f32_reshard_reprojection_matches_jax(monkeypatch, cube_file, jmesh,
                                              case):
    """The same on the one-position mesh against the JAX package's
    ShardedCube on its 8-device mesh (the reprojection tests' rtol 1e-5,
    atol 5e-6), NaN patterns equal."""
    small_pieces(monkeypatch)
    tc = T.SpectralCube.read(cube_file, device="cpu")
    _, header, order = {c[0]: c for c in _reprojections(tc)}[case]
    got = np.asarray(tc.to_sharded(mesh("one")).reproject(
        header, order=order).filled_data[:].value)
    jsc = jpar.ShardedCube(J.SpectralCube.read(cube_file), jmesh)
    want = np.asarray(jsc.reproject(header, order=order)
                      .filled_data[:].value)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=5e-6)


def test_f32_reshard_reprojection_makes_one_cube(monkeypatch, cube_file):
    """F32 (the reshard reprojection): on one position the rotated
    reprojection held the NaN-filled cube, its float NaN mask, each
    all-to-all's copy and the gather's channels-minor copy, accumulator
    and gathered rows of the whole block, and ``reproject``'s footprint a
    float copy (on the card V (a) went out of memory on one position and
    past 90% of the card on four).  Now the output is its only cube-sized
    allocation, and ``reproject`` adds the filled copy of the masked
    data."""
    small_pieces(monkeypatch)
    tc = T.SpectralCube.read(cube_file, device="cpu")
    _, header, order = _reprojections(tc)[0]
    cmesh = mesh("one")
    sc = tc.to_sharded(cmesh)
    nbytes = tc._data.numel() * 4
    zs, ys, xs, _ = tregrid.reproject_mappings(
        tc.wcs, header, tc.shape[0],
        spectral_values_in=np.asarray(tc.spectral_axis.value))
    data = sc._data
    assert _cube_sized(lambda: tsh.sharded_reproject(
        data, zs, ys, xs, cmesh), nbytes) == 1
    assert _cube_sized(lambda: masked(sc, T).reproject(header), nbytes) == 2


# -- the all-to-alls ----------------------------------------------------------

def test_f32_one_position_all_to_alls_hand_the_tiles_through(cube_file):
    """F32 (row g): on one position each all-to-all of a reshard copied
    the whole cube, two identity copies each way.  Now a mesh axis of one
    position hands its tile through: the spectral layout's block is the
    spatial block itself, and back; each all-to-all still counted."""
    cmesh = mesh("one")
    sc = tpar.ShardedCube(T.SpectralCube.read(cube_file, device="cpu"),
                          cmesh)
    block = sc._data.blocks[0]
    cmesh.reset_counters()
    spectral = cmesh.reshard(sc._data, "spectral")
    back = cmesh.reshard(spectral, "spatial")
    assert cmesh.counters["all_to_alls"] == 4
    for arr in (spectral, back):
        assert arr.blocks[0].data_ptr() == block.data_ptr()
        assert same_bits(arr.blocks[0], block)


@pytest.mark.parametrize("where", ["grid", "eight"])
def test_all_to_alls_free_their_sources_a_row_at_a_time(cube_file, where):
    """On a longer mesh axis an all-to-all takes each row's or column's
    tiles out of its input list once their results are made (so that the
    sources and the results of the whole mesh are never alive at once);
    the reshard is the array's own data moved, bit for bit, both ways."""
    cmesh = mesh(where)
    sc = tpar.ShardedCube(T.SpectralCube.read(cube_file, device="cpu"),
                          cmesh)
    tiles = cmesh._tile(sc._data, "spatial", 0.0, cmesh.n_devices)
    out = cmesh._a2a(tiles, 0, 1, "y")
    assert all(t is None for t in tiles) and all(o is not None for o in out)
    spectral = cmesh.reshard(sc._data, "spectral")
    whole = sc._data.gather()
    assert same_bits(spectral.gather(), whole)
    assert same_bits(cmesh.reshard(spectral, "spatial").gather(), whole)
