"""Torch port: the sharded spectral path and the sharded spline
reprojections as they run past 2**31 voxels on the meshes of one card
(``chip_smoke.py``'s card-scale part MS).

On one card the default mesh has one position, whose one shard is the
whole cube, so every sharded function meets the cube's own size there.
The sharded spline reprojection (``parallel.sharded.
sharded_spline_reproject``) now runs the unsharded path's two steps,
``ops/regrid._spline_spectral`` on each tile (the filled data and then the
NaN mask written into one buffer, each product's input in turn) and
``ops/regrid._spline_spatial`` on each channel block (a slab of output
channels at a time into the block's one output; on an untouched spectral
axis the data itself goes to the spectral layout and each slab fills its
own channels).  It held each block's whole NaN-filled copy, float NaN
mask, fz and wz, and ran the prefilters, the reflect pad and the tap
gathers on the whole block: on the card's one position the rotated spline
orders stopped at torch's 32-bit index limit of the reflect pad (F33) and
the bicubic onto a new spectral axis rose 6.0 cube bytes.

Here ``SLAB_VOXELS``, ``SORT_CHUNK``, ``SORT_PIECE`` and ``SUM_CHUNK`` are
set small by ``monkeypatch`` so that cubes of a few thousand voxels take
many slabs and pieces, on a mesh of one position
(``CubeMesh(devices=['cpu'])``), a 2 x 2 mesh and the 2 x 4 mesh of eight.
Each result is held bit for bit against the unsharded port's call, and
against the JAX package (its ``ShardedCube`` on its 8-device CPU mesh,
whose spline orders gather and call the unsharded reproject, and its
unsharded function) at the JAX tests' tolerances; F33 by the pads' inputs
and by the allocations the CPU profiler sees.
"""

import numpy as np
import jax
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu import parallel as jpar

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch.io import streaming
from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
from spectral_cube_tpu_torch.parallel import sharded as tsh
from spectral_cube_tpu_torch.ops import reductions as rd
from spectral_cube_tpu_torch.ops import regrid as tregrid

from test_torch_card_scale_reductions import same_bits
from test_torch_regrid import _rotated_header, _spectral_cube_file, _target

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

MESHES = {"one": dict(devices=["cpu"]),
          "grid": dict(devices=["cpu"] * 4, shape=(2, 2)),
          "eight": dict(devices=["cpu"] * 8)}
ORDERS = ("biquadratic", "bicubic")
#: the spline cube's shape, and the targets: the grid shifted by (0.37,
#: -0.61) px (the separable route) or rotated by 3 deg (the prefilter and
#: tap gathers), each on the cube's own spectral axis or on a new one
SPLINE = (12, 30, 32)
TARGETS = ("shifted", "rotated", "spectral", "spectral rotated")
#: a cube of P's kind (``chip_smoke.card_cube``: the NaN primary-beam
#: cutoff) wide enough that the spline orders leave values inside it
P_KIND = (40, 48, 64)


def mesh(name):
    return tpar.CubeMesh(**MESHES[name])


def small_pieces(monkeypatch, plane=SPLINE[1] * SPLINE[2]):
    """Slabs of two planes, pieces and tiles of a few hundred voxels."""
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", 2 * plane)
    monkeypatch.setattr(rd, "SUM_CHUNK", 1 << 8)
    monkeypatch.setattr(rd, "SORT_CHUNK", 1 << 11)
    monkeypatch.setattr(rd, "SORT_PIECE", 1 << 9)


@pytest.fixture(scope="module")
def spline_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_spline") / "s.fits"
    h = _spectral_cube_file(path, nchan=SPLINE[0], ny=SPLINE[1],
                            nx=SPLINE[2])
    return str(path), h


def target_header(h, name):
    nchan = SPLINE[0]
    return {"shifted": _target(h, nchan, 1.0, 0.0),
            "rotated": _rotated_header(h, 3.0),
            "spectral": _target(h, 5, 2.0, 0.25),
            "spectral rotated": _rotated_header(
                _target(h, nchan - 1, 1.0, 0.25), 3.0)}[name]


def spline_maps(tc, header):
    zs, ys, xs, _ = tregrid.reproject_mappings(
        tc.wcs, header, tc.shape[0],
        spectral_values_in=np.asarray(tc.spectral_axis.value))
    return zs, ys, xs, tregrid.spline_host_maps(zs, ys, xs, *tc.shape)


def _peak_bytes(fn):
    """The peak of the bytes the operations inside ``fn()`` allocated and
    held at once (the CPU profiler's allocations and frees, in time
    order)."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    live = peak = 0
    for _, n in sorted((e.time_range.start, e.self_cpu_memory_usage)
                       for e in prof.events() if e.self_cpu_memory_usage):
        live += n
        peak = max(peak, live)
    return peak


# -- the sharded spline reprojection ------------------------------------------

@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("where", sorted(MESHES))
def test_sharded_spline_reproject_is_the_unsharded_call(
        monkeypatch, spline_file, where, target, order):
    """Both routes, both orders, on the cube's own spectral axis and on a
    new one, in slabs of two output channels: bit for bit the unsharded
    reprojection, its mask too; gathers 0, six all-to-alls (four on an
    untouched axis: the data itself goes to the spectral layout)."""
    small_pieces(monkeypatch)
    path, h = spline_file
    tc = T.SpectralCube.read(path, device="cpu")
    header = target_header(h, target)
    m = spline_maps(tc, header)[3]
    assert m.separable == ("rotated" not in target)
    assert m.z_identity == ("spectral" not in target)
    want = tc.reproject(header, order=order)
    cmesh = mesh(where)
    sc = tc.to_sharded(cmesh)
    cmesh.reset_counters()
    got = sc.reproject(header, order=order)
    assert cmesh.counters == {"halo_exchanges": 0, "all_to_alls": 4
                              if m.z_identity else 6, "gathers": 0}
    assert same_bits(torch.as_tensor(np.asarray(got.unmasked_data[:].value)),
                     want._data)
    np.testing.assert_array_equal(got.get_mask_array(),
                                  want.get_mask_array())
    assert np.isfinite(want._data.numpy()).mean() > 0.3


@pytest.fixture(scope="module")
def jax_spline(spline_file):
    """The JAX package's results on the spline cube, by (target, order):
    its ShardedCube's on the 8-device CPU mesh and its unsharded call's."""
    if len(jax.devices()) != 8:
        pytest.skip("multi-device tests need the 8-device virtual mesh")
    path, h = spline_file
    jc = J.SpectralCube.read(path)
    jsc = jpar.ShardedCube(jc, jpar.CubeMesh())
    cache = {}

    def results(target, order):
        key = (target, order)
        if key not in cache:
            header = target_header(h, target)
            cache[key] = (
                np.asarray(jsc.reproject(header, order=order)
                           .filled_data[:].value),
                np.asarray(jc.reproject(header, order=order)
                           .filled_data[:].value))
        return cache[key]
    return results


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("target", TARGETS)
def test_sharded_spline_reproject_matches_jax(monkeypatch, spline_file,
                                              jax_spline, target, order):
    """On the card's one-position mesh, in slabs: against the JAX
    package's ShardedCube (8 devices) and its unsharded reproject at the
    spline reprojection tests' atol 5e-6 on unit-variance data
    (``tests/test_torch_regrid.py``), NaN patterns equal."""
    small_pieces(monkeypatch)
    path, h = spline_file
    sc = T.SpectralCube.read(path, device="cpu").to_sharded(mesh("one"))
    got = np.asarray(sc.reproject(target_header(h, target), order=order)
                     .filled_data[:].value)
    for want in jax_spline(target, order):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        assert fin.mean() > 0.3
        np.testing.assert_allclose(got[fin], want[fin], atol=5e-6)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("target", ["rotated", "spectral rotated"])
@pytest.mark.parametrize("where", sorted(MESHES))
def test_f33_spline_prefilters_and_pads_a_slab_at_a_time(
        monkeypatch, spline_file, where, target, order):
    """F33: the sharded rotated spline orders prefiltered and reflect-padded
    each channel block whole (on the card's one position the block is the
    cube, 2304 x 1030 x 1030 padded, past the 2**31 elements torch's
    reflect pad takes).  Now every pad takes one slab of output channels
    of the spatial step (SLAB_VOXELS), as the unsharded path does."""
    small_pieces(monkeypatch)
    path, h = spline_file
    sc = T.SpectralCube.read(path, device="cpu").to_sharded(mesh(where))
    header = target_header(h, target)
    pads = []
    real = tregrid.F.pad

    def recording(x, pad, mode="constant", value=None):
        pads.append(x.shape[1] if x.dim() == 4 else x.shape[0])
        return real(x, pad, mode=mode, value=value)
    monkeypatch.setattr(tregrid.F, "pad", recording)
    sc.reproject(header, order=order)
    ny, nx = SPLINE[1:]
    slab = max(1, tregrid.SLAB_VOXELS // (ny * nx))
    assert pads and max(pads) <= slab


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("target", TARGETS)
def test_f33_one_position_holds_what_the_unsharded_path_holds(
        monkeypatch, spline_file, target, order):
    """F33 (the memory): on one position the sharded spline reprojection
    held the block's NaN-filled copy and float NaN mask beside fz and wz
    (on an untouched axis, whole filled copies as fz and wz), then the
    whole block's prefilters, pad, channels-minor copy and gathers, twice
    (at P the bicubic onto 2303 channels rose 6.0 cube bytes, the unsharded
    call 4.2).  Now its peak is the unsharded path's: the same two steps
    on the same array."""
    small_pieces(monkeypatch)
    path, h = spline_file
    tc = T.SpectralCube.read(path, device="cpu")
    data = tc._get_filled_data(fill=np.nan)
    zs, ys, xs, _ = spline_maps(tc, target_header(h, target))
    n = tregrid._order_int(order)
    cmesh = mesh("one")
    whole = _peak_bytes(lambda: tregrid._spline_spatial_then_z(
        data, zs, ys, xs, n))
    sharded = _peak_bytes(lambda: tsh.sharded_spline_reproject(
        data, zs, ys, xs, cmesh, order=n))
    assert sharded <= whole + data.numel() * 4 // 20


def _one_function_spline(data, zs, ys, xs, order):
    """The unsharded spline path as one function, its validity applied to
    the whole output at the end: the form before its two steps were split
    out for the sharded path."""
    tr = tregrid
    m = tr.spline_host_maps(zs, ys, xs, *data.shape)
    dev = data.device
    nchan, ny_in, nx_in = data.shape
    fz = wz = None
    if not m.z_identity:
        tz = tr._spline_1d_matrix(nchan, m.zc, order)
        buf = torch.empty(data.shape, dtype=torch.float32, device=dev)
        slabs = tr._slabs(nchan, ny_in * nx_in)
        for k0, k1 in slabs:
            buf[k0:k1] = torch.nan_to_num(data[k0:k1])
        fz = tr._spectral_product(tz, buf)
        for k0, k1 in slabs:
            buf[k0:k1] = torch.isnan(data[k0:k1])
        wz = tr._spectral_product(np.abs(tz), buf)
    nz = len(m.zvalid)
    ny, nx = m.ycl.shape
    plan = None if m.separable else tr.spline_taps(m.ycl, m.xcl, order,
                                                   ny_in, nx_in, dev)
    out = None
    for k0, k1 in tr._slabs(nz, max(ny * nx, ny_in * nx_in)):
        if fz is None:
            f = torch.nan_to_num(data[k0:k1])
            w = torch.isnan(data[k0:k1]).to(torch.float32)
        else:
            f, w = fz[k0:k1], wz[k0:k1]
        if m.separable:
            o, wn = tr._spline_separable_resample(f, w, m.ycl, m.xcl, order)
        else:
            o, wn = tr._spline_nonseparable_resample(f, w, m.ycl, m.xcl,
                                                     order, plan)
        if wn is not None:
            o.masked_fill_(wn > 1e-6, float("nan"))
        out = tr._into(out, k0, k1, nz, o)
    valid = torch.as_tensor((m.yvalid & m.xvalid)[None], device=dev) \
        & torch.as_tensor(m.zvalid, device=dev)[:, None, None]
    return out.masked_fill_(~valid, float("nan")).to(data.dtype)


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("slab", [1, 5])
def test_unsharded_spline_steps_keep_the_one_function_bits(
        monkeypatch, spline_file, target, order, slab):
    """The unsharded path, now ``_spline_spectral`` then
    ``_spline_spatial`` (which the sharded form calls too, the validity
    applied a slab at a time): bit for bit its one-function form, in slabs
    of one and of five output channels."""
    path, h = spline_file
    tc = T.SpectralCube.read(path, device="cpu")
    data = tc._get_filled_data(fill=np.nan)
    zs, ys, xs, _ = spline_maps(tc, target_header(h, target))
    monkeypatch.setattr(tregrid, "SLAB_VOXELS", slab * SPLINE[1] * SPLINE[2])
    got = tregrid._spline_spatial_then_z(data, zs, ys, xs, order)
    assert same_bits(got, _one_function_spline(data, zs, ys, xs, order))
    assert torch.isfinite(got).float().mean() > 0.3


# -- MS: the stages on the shards of P's kind ---------------------------------

@pytest.fixture(scope="module")
def p_kind_file(tmp_path_factory):
    import chip_smoke as cs
    path = str(tmp_path_factory.mktemp("ms") / "p.fits")
    data = cs.card_cube(*P_KIND, cs.SEED, torch.device("cpu")).numpy()
    write_fits(path, [HDU(data=data, header=cs.synth_header(*P_KIND))])
    return path


@pytest.mark.parametrize("stage", range(10))
@pytest.mark.parametrize("where", sorted(MESHES))
def test_ms_stages_on_the_shards_are_the_unsharded_stages(
        monkeypatch, p_kind_file, where, stage):
    """Each MS stage (``chip_smoke.card_ms_stages``: the spectral path's
    six, S's two reprojections onto a new spectral axis and R's two onto
    the rotated grid) on the shards ``read_sharded_cube`` gives, with the
    pieces and slabs small: bit for bit the same stage on the unsharded
    read, finite values in it, gathers 0."""
    import chip_smoke as cs
    small_pieces(monkeypatch, P_KIND[1] * P_KIND[2])
    tc = T.SpectralCube.read(p_kind_file, device="cpu")
    name, ucall, kernel = cs.card_ms_stages(tc)[stage]
    want = ucall(tc)._get_filled_data().numpy()
    cmesh = mesh(where)
    sc = streaming.read_sharded_cube(p_kind_file, cmesh)
    sname, call, skernel = cs.card_ms_stages(sc)[stage]
    assert (sname, skernel) == (name, kernel)
    cmesh.reset_counters()
    got = np.asarray(call(sc).filled_data[:].value)
    assert cmesh.counters["gathers"] == 0
    assert np.isfinite(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert same_bits(torch.from_numpy(np.nan_to_num(got)),
                     torch.from_numpy(np.nan_to_num(want)))


def test_ms_stage_table_names_its_kernels(p_kind_file):
    """MS's ten stages are the spectral path's, S's and R's stages under
    names of their own, and the kernels they launch are CARD_KERNELS['MS']
    (each of the four by at least one stage)."""
    import chip_smoke as cs
    cube = T.SpectralCube.read(p_kind_file, device="cpu")
    stages = cs.card_ms_stages(cube)
    names = [n for n, _, _ in stages]
    assert len(stages) == 10 and len(set(names)) == 10
    assert all(n.startswith("MS ") for n in names)
    assert names[:6] == [f"MS {n}" for n, _, _ in
                         cs.card_spectral_stages(cube)]
    assert {k for _, _, k in stages if k} == set(cs.CARD_KERNELS["MS"])


def test_ms_runs_on_the_shards_of_m_s_read(monkeypatch, p_kind_file):
    """``card_m_run(parts=('MS',))`` reads P onto the mesh once and runs
    MS's stages on those shards, in order, and none of M's (the 4-D file
    of M's V (a) is not needed)."""
    import chip_smoke as cs
    small_pieces(monkeypatch, P_KIND[1] * P_KIND[2])
    ran = []

    def run(name, fn, scale):
        ran.append(name)
        return fn()
    cs.card_m_run(mesh("one"), p_kind_file, None, run, parts=("MS",))
    cube = T.SpectralCube.read(p_kind_file, device="cpu")
    assert ran == ["read"] + [n for n, _, _ in cs.card_ms_stages(cube)]
