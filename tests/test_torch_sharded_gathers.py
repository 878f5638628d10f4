"""Torch port: the ShardedCube methods that gathered the cube until the
port ran them shard by shard, and the calls that still gather.

On the port's 8-position CPU mesh (``CubeMesh(devices=['cpu'] * 8)``,
2 x 4) over the shapes and the four masks of
``test_torch_sharded_methods.py`` (none but the read's finiteness,
``sc > q``, a boolean array, a stored include): (1) the mask, beam and
metadata edits and ``sigma_clip``; (2) the cuts (``subcube`` by pixel and
world bounds, ``subcube_from_mask``, the DS9, CRTF and region-list cuts);
(3) the ``filled_data[...]`` / ``unmasked_data[...]`` indexers, every
kind of view ``masks.index_view`` takes; (4) ``flattened``,
``apply_function(axis=None)`` and the world arg-extrema; (5) the
parallel apply functions and ``apply_everywhere``; (6)
``spectral_interpolate(smooth_kernel=)`` under every mask; (7) the spline
orders of ``reproject`` (kernel #14 twice a tile).  Each call must leave
the mesh's ``gathers`` counter at 0, and its result is held against the
port's unsharded call (bit for bit, or within 1e-6 where a sum or a
batched product runs in another order) and against the JAX package's
ShardedCube on its 8-device virtual CPU mesh at the JAX tests'
tolerances (rtol 1e-5, atol 1e-6).  Then the guard: every public name of
the port's cubes is defined on ShardedCube, read from its metadata cube,
or one of ``GATHERED``'s, and each of those still gathers when called.
"""

import inspect
import warnings

import numpy as np
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu import parallel as jpar
from spectral_cube_tpu import region as jr

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch import region as tr
from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
from spectral_cube_tpu_torch.ops import regrid as tregrid
from spectral_cube_tpu_torch.ops import smoothing as tsm
from spectral_cube_tpu_torch.parallel import sharded as tsh

from conftest import make_cube_file, make_vr_cube_file
from test_torch_regrid import _rotated_header, _spectral_cube_file, _target
from test_torch_sharded_methods import (MASKS, SHAPES, _exact, _hold, _make,
                                        _near)

pytestmark = pytest.mark.filterwarnings("ignore::Warning")


@pytest.fixture(scope="module")
def jmesh():
    import jax
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
    tmp = tmp_path_factory.mktemp("sharded_gathers")

    def get(shape, mask):
        if (shape, mask) not in made:
            made[shape, mask] = _make(tmp, shape, mask, tmesh, jmesh)
        return made[shape, mask]
    return get


def _run(cubes, tmesh, case, fn, kind):
    """``fn`` on every shape and mask: no gather, and the result held
    against the unsharded call and the JAX ShardedCube's."""
    for shape in SHAPES:
        for mask in MASKS:
            sc, uc, jsc = cubes(shape, mask)
            name = f"{case} {shape} {mask}"
            tmesh.reset_counters()
            got = fn(sc, T)
            assert tmesh.counters["gathers"] == 0, (name, tmesh.counters)
            if isinstance(got, (T.BaseSpectralCube, J.BaseSpectralCube)):
                raise AssertionError(f"{name}: an unsharded cube")
            _hold(name, kind, got, fn(uc, T), fn(jsc, J), uc)


def _beam(p):
    return p.Beam.make(p.Quantity(3.0, "arcsec"), p.Quantity(2.0, "arcsec"),
                       p.Quantity(20.0, "deg"))


def _box(c, p):
    box = np.zeros(c.shape, bool)
    box[1:-2, 1:4, 2:-1] = True
    return p.BooleanArrayMask(box, shape=c.shape)


def _world_bounds(c, p):
    """Longitude, latitude and spectral bounds a few pixels in from the
    edges, read from the cube's own WCS."""
    nchan, ny, nx = c.shape
    sv = np.asarray(c.spectral_axis.value)
    _, lat, lon = c.world[0, :, :]
    lon, lat = np.asarray(lon.value), np.asarray(lat.value)
    q = p.Quantity
    return dict(xlo=q(lon[ny // 2, 1], "deg"), xhi=q(lon[ny // 2, nx - 3],
                                                     "deg"),
                ylo=q(lat[1, nx // 2], "deg"), yhi=q(lat[ny - 2, nx // 2],
                                                     "deg"),
                zlo=q(sv[1], c.spectral_unit), zhi=q(sv[-2], c.spectral_unit))


DS9 = "image; circle(5, 3, 2.5); -circle(5, 3, 1)"
CRTF = "#CRTFv0\nbox[[2pix, 1pix], [6pix, 4pix]]"

STEP_1_2 = {
    "mask_channels": lambda c, p: c.mask_channels(
        np.arange(c.shape[0]) % 3 != 1),
    "unmasked_copy": lambda c, p: c.unmasked_copy(),
    "with_beam": lambda c, p: c.with_beam(_beam(p)),
    "unitless": lambda c, p: c.unitless,
    "sigma_clip": lambda c, p: c.sigma_clip(1.5),
    "subcube_pixels": lambda c, p: c.subcube(xlo=1, xhi=-2, ylo=2, zlo=1,
                                             zhi=-1),
    "subcube_world": lambda c, p: c.subcube(**_world_bounds(c, p)),
    "subcube_from_mask": lambda c, p: c.subcube_from_mask(_box(c, p)),
    "subcube_from_ds9region": lambda c, p: c.subcube_from_ds9region(DS9),
    "subcube_from_crtfregion": lambda c, p: c.subcube_from_crtfregion(CRTF),
    "subcube_from_regions": lambda c, p: c.subcube_from_regions(
        (tr if p is T else jr).parse_ds9_region(DS9), minimize=False),
}


@pytest.mark.parametrize("case", sorted(STEP_1_2))
def test_edits_and_cuts(cubes, tmesh, case):
    """(1) the mask, beam and metadata edits (no data moves) and
    ``sigma_clip`` (the sharded ``mad_std`` and ``median``, a comparison
    mask each shard evaluates); (2) the cuts: the unsharded call's slices
    from the template's WCS, then the sharded cut.  Bit for bit, the
    WCS, unit and mask included."""
    _run(cubes, tmesh, case, STEP_1_2[case], "exact")


def test_edits_keep_the_beam_and_the_slices(cubes, tmesh):
    """``with_beam``'s beam, ``unitless``'s unit and
    ``subcube_slices_from_mask``'s slices are the unsharded call's."""
    for shape in SHAPES:
        sc, uc, jsc = cubes(shape, "gt")
        tmesh.reset_counters()
        got = sc.with_beam(_beam(T))
        assert got.beam == uc.with_beam(_beam(T)).beam
        assert str(sc.unitless.unit) == str(uc.unitless.unit) == ""
        slices = sc.subcube_slices_from_mask(_box(sc, T))
        assert tmesh.counters["gathers"] == 0
        assert slices == uc.subcube_slices_from_mask(_box(uc, T))
        assert slices == tuple(slice(*(None if v is None else int(v)
                                       for v in (s.start, s.stop, s.step)))
                               for s in jsc.subcube_slices_from_mask(
                                   _box(jsc, J)))


VIEWS = {
    "plane": (0,),
    "spectrum": (slice(None), 3, 4),
    "last_plane": (-1,),
    "box": (slice(2, 7), slice(1, 4), slice(2, 8)),
    "negative_steps": (slice(None, None, -1), slice(None, None, 2),
                       slice(None, None, -3)),
    "ellipsis": (Ellipsis, 2),
    "ellipsis_none": (1, Ellipsis, None),
    "none_first": (None, 3),
    "mixed": (slice(None), -2, slice(1, -1, 2)),
    "empty": (slice(5, 2),),
    "reversed_rows": (slice(None), slice(1, None, 3), slice(None, None, -1)),
    "point": (2, 1, -1),
}


@pytest.mark.parametrize("indexer", ["filled_data", "unmasked_data",
                                     "unitless_filled_data"])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_data_indexers(cubes, tmesh, indexer, view):
    """(3) ``filled_data[view]`` and friends: a tensor on the mesh's first
    device from the parts of the blocks the view meets (each part's
    include evaluated on it), bit for bit the unsharded view."""
    v = VIEWS[view]
    _run(cubes, tmesh, f"{indexer}[{view}]",
         lambda c, p: getattr(c, indexer)[v], "exact")


def test_indexers_move_only_the_blocks_they_meet(cubes, tmesh):
    """A spectrum reads one block: each other block's data is never read
    (a block replaced by NaN changes nothing), and the result is a host
    array, as the unsharded cube's (F23)."""
    sc, uc, _ = cubes(SHAPES[0], "gt")
    want = uc.filled_data[:, 3, 4].value
    touched = [p for p, *_ in sc._view_parts(tsh._view_axes(
        (slice(None), 3, 4), sc.shape)[0])]
    assert len(touched) == 1
    poisoned = tpar.ShardedCube._from_parts(
        tmesh, sc._data.map(lambda d: d.clone()), sc._template, sc._mask)
    for p, b in enumerate(poisoned._data.blocks):
        if p != touched[0]:
            b.fill_(float("nan"))
    got = poisoned.filled_data[:, 3, 4].value
    assert isinstance(got, np.ndarray)
    _exact("spectrum of the one block", got, want)
    with pytest.raises(TypeError, match="indexers take"):
        sc.filled_data[[0, 1]]
    with pytest.raises(IndexError):
        sc.unmasked_data[0, 99]


def _weights(c):
    return np.random.RandomState(1).rand(*c.shape)


@pytest.mark.parametrize("mask", MASKS)
def test_pieces_of_a_few_channels_give_the_same_results(cubes, tmesh,
                                                        monkeypatch, mask):
    """A block's include and flat positions are taken a few channels at a
    time, so that what a bounding box, a region cut or ``flattened``
    evaluates stays bounded on a large cube: with pieces of one channel
    the results are bit for bit the unsharded calls'."""
    monkeypatch.setattr(tsh, "_CHUNK_VOXELS", 7)
    sc, uc, _ = cubes(SHAPES[1], mask)
    for name, fn in (
            ("minimal_subcube", lambda c: c.minimal_subcube()),
            ("ds9", lambda c: c.subcube_from_ds9region(DS9)),
            ("flattened", lambda c: c.flattened(
                (slice(None, None, -2), slice(1, 4)), weights=_weights(c)))):
        tmesh.reset_counters()
        got = fn(sc)
        assert tmesh.counters["gathers"] == 0
        want = fn(uc)
        _hold(f"{name} {mask}", "exact", got, want, want, uc)


STEP_4 = {
    "flattened": (lambda c, p: c.flattened(), "exact"),
    "flattened_view": (lambda c, p: c.flattened(
        (slice(None, None, -1), slice(1, 4), 2)), "exact"),
    "flattened_weights": (lambda c, p: c.flattened(weights=_weights(c)),
                          "exact"),
    "flattened_view_weights": (lambda c, p: c.flattened(
        (slice(1, None), slice(None, None, -2)), weights=_weights(c)),
        "exact"),
    "apply_function_none": (lambda c, p: c.apply_function(
        lambda v: float(np.nanmax(np.asarray(v.value)))), "exact"),
    "argmax_world": (lambda c, p: c.argmax_world(), "exact"),
    "argmin_world": (lambda c, p: c.argmin_world(axis=0), "exact"),
}


@pytest.mark.parametrize("case", sorted(STEP_4))
def test_host_results_from_the_shards(cubes, tmesh, case):
    """(4) ``flattened`` (each block's included values with their flat
    positions in the view, merged in C order; weights cut by the same
    view), ``apply_function(axis=None)`` of it, and the world
    arg-extrema (the sharded arg-extremum and any-valid plane)."""
    fn, kind = STEP_4[case]
    _run(cubes, tmesh, case, fn, kind)


def test_world_arg_extrema_refuse_coupled_axes(cubes):
    """A spatial axis that couples to both celestial world axes raises,
    as unsharded."""
    from spectral_cube_tpu_torch.utils import WCSCelestialError
    sc, uc, _ = cubes(SHAPES[0], "none")
    for c in (sc, uc):
        with pytest.raises(WCSCelestialError):
            c.argmax_world(axis=1)


def _host_only(s):
    """A per-spectrum function that cannot be vmapped (a numpy copy
    written in place): both packages run it on the host."""
    a = np.array(s, dtype=np.float32)
    a[0] = 0.0
    return a


STEP_5 = {
    "spectral_elementwise": (lambda c, p: c.apply_function_parallel_spectral(
        lambda s: s * 2.0 + 1.0), "exact"),
    "spectral_reduction": (lambda c, p: c.apply_function_parallel_spectral(
        lambda s: s - s[:3].mean()), "sum"),
    "spectral_new_length": (lambda c, p: c.apply_function_parallel_spectral(
        lambda s: s[1::2], return_new_cube=False), "exact"),
    "spectral_host": (lambda c, p: c.apply_function_parallel_spectral(
        _host_only), "exact"),
    "spatial_elementwise": (lambda c, p: c.apply_function_parallel_spatial(
        lambda im: im * 2.0 - 1.0), "exact"),
    "spatial_reduction": (lambda c, p: c.apply_function_parallel_spatial(
        lambda im: im - im[1:3].mean()), "sum"),
    "spatial_transpose": (lambda c, p: c.apply_function_parallel_spatial(
        lambda im: im.T, return_new_cube=False), "exact"),
    "apply_everywhere": (lambda c, p: c.apply_everywhere(lambda x: x * 3),
                         "exact"),
}


@pytest.mark.parametrize("case", sorted(STEP_5))
def test_parallel_apply_functions(cubes, tmesh, case):
    """(5) the per-spectrum function tile by tile (vmapped over a tile's
    spaxels, or per spectrum on the host), the per-plane one slab by slab
    of whole planes, the output's shape the function's; a batched
    reduction within 1e-6."""
    fn, kind = STEP_5[case]
    _run(cubes, tmesh, case, fn, kind)


def test_parallel_apply_functions_see_the_whole_cube(cubes, tmesh):
    """A function that takes ``block_info`` sees the whole cube's, as in
    the unsharded call; ``return_new_cube=False`` gives a ShardedArray
    (the unsharded call a tensor), and the spatial function's blocks go
    through all-to-alls while the spectral one's stay."""
    sc, uc, _ = cubes(SHAPES[1], "gt")
    seen = []

    def spec(s, block_info=None):
        seen.append(block_info[0]["shape"])
        return s + 1
    tmesh.reset_counters()
    out = sc.apply_function_parallel_spectral(spec, return_new_cube=False)
    assert isinstance(out, tpar.ShardedArray) and out.layout == "spatial"
    assert tmesh.counters == {"halo_exchanges": 0, "all_to_alls": 0,
                              "gathers": 0}
    uc.apply_function_parallel_spectral(spec)
    assert set(seen) == {uc.shape}
    sc.apply_function_parallel_spatial(lambda im: im + 1)
    assert tmesh.counters["all_to_alls"] > 0
    assert tmesh.counters["gathers"] == 0


def _grid(c, p):
    sv = np.asarray(c.spectral_axis.value)
    return p.Quantity((sv[:-1] + sv[1:]) / 2.0, c.spectral_unit)


def test_smoothed_spectral_interpolate(cubes, tmesh):
    """(6) ``spectral_interpolate(smooth_kernel=)`` under every mask, a
    data-local threshold mask too (each tile smooths its whole spectra,
    evaluates the mask on them and interpolates data and include, as the
    unsharded call does): within 1e-6, the mask bit for bit."""
    kern = tsm.gaussian_kernel1d(1.0)
    _run(cubes, tmesh, "spectral_interpolate smoothed",
         lambda c, p: c.spectral_interpolate(_grid(c, p), smooth_kernel=kern),
         "sum")


@pytest.fixture(scope="module")
def spline_cubes(tmp_path_factory, tmesh, jmesh):
    path = tmp_path_factory.mktemp("spline") / "s.fits"
    h = _spectral_cube_file(path, nchan=12, ny=30, nx=32)
    tc = T.SpectralCube.read(str(path), device="cpu")
    jc = J.SpectralCube.read(str(path))
    return h, tpar.ShardedCube(tc, tmesh), tc, jpar.ShardedCube(jc, jmesh)


@pytest.mark.parametrize("order", ["biquadratic", "bicubic"])
@pytest.mark.parametrize("target", ["spectral", "rotated", "same_axis"])
def test_spline_reproject(spline_cubes, tmesh, monkeypatch, order, target):
    """(7) the spline orders shard by shard: the spectral operator on each
    tile's whole spectra through kernel #14's wrapper (its plain version
    on the CPU), twice a tile (the filled data and the NaN mask, one
    launch each on the card) with the route the unsharded call takes;
    then the spatial step on slabs of whole planes (six all-to-alls in
    all; four on an untouched spectral axis, where the data itself goes
    to the spectral layout and each slab fills itself) within 1e-6 of the
    unsharded call, NaN pattern and mask equal, and the JAX
    ShardedCube's within the JAX tests' tolerance."""
    h, sc, uc, jsc = spline_cubes
    header = {"spectral": _target(h, 5, 2.0, 0.25),
              "rotated": _rotated_header(h, 3.0),
              "same_axis": _target(h, 12, 1.0, 0.0)}[target]
    calls = []
    real = kbm.banded_matmul

    def counting(flat, bands):
        calls.append(tuple(flat.shape))
        return real(flat, bands)
    monkeypatch.setattr(kbm, "banded_matmul", counting)
    declined = tregrid._spectral_product.declined
    tmesh.reset_counters()
    got = sc.reproject(header, order=order)
    assert tmesh.counters == {"halo_exchanges": 0, "all_to_alls": 6
                              if target == "spectral" else 4, "gathers": 0}
    sharded_calls, calls[:] = list(calls), []
    want = uc.reproject(header, order=order)
    if target == "spectral":
        assert sharded_calls == [(12, 15 * 8)] * 2 * tmesh.n_devices
        assert calls == [(12, 30 * 32)] * 2
        assert tregrid._spectral_product.last == "banded_matmul"
    else:
        assert sharded_calls == calls == []
    assert tregrid._spectral_product.declined == declined
    g, w = got.cube, want
    assert g.wcs.to_header() == w.wcs.to_header()
    np.testing.assert_array_equal(g.get_mask_array(), w.get_mask_array())
    _near("spline vs unsharded", g._data, w._data, 1e-6, 1e-6)
    j = jsc.reproject(header, order=order).cube
    np.testing.assert_array_equal(g.get_mask_array(),
                                  np.asarray(j.get_mask_array()))
    _near("spline vs JAX", g._data, np.asarray(j._data), 1e-5, 1e-6)


def test_banded_matmul_columns_are_independent():
    """Kernel #14's plain version computes each output column from its
    own input column in one order whatever the column count, so the
    spectral step a tile at a time is bit for bit the whole cube's."""
    rng = np.random.RandomState(5)
    tz = tregrid._spline_1d_matrix(40, np.linspace(0.25, 38.5, 19), 3)
    bands = kbm.row_bands(tz)
    flat = torch.from_numpy(rng.randn(40, 300).astype(np.float32))
    whole = kbm.banded_matmul_plain(flat, bands)
    for cols in (slice(0, 1), slice(7, 120), slice(120, 300)):
        assert torch.equal(kbm.banded_matmul_plain(
            flat[:, cols].contiguous(), bands), whole[:, cols])


def test_sharded_spline_reproject_refuses_bilinear(tmesh):
    with pytest.raises(ValueError, match="orders 2/3"):
        tpar.sharded_spline_reproject(np.zeros((4, 8, 8), np.float32),
                                      np.arange(4.0), *np.mgrid[0:8, 0:8]
                                      .astype(float), tmesh, order=1)


@pytest.fixture(scope="module")
def vr_cubes(tmp_path_factory, tmesh, jmesh):
    path, _ = make_vr_cube_file(tmp_path_factory.mktemp("vr"),
                                shape=(6, 5, 9),
                                major_arcsec=[1.0, 1.0, 1.5, 1.0, 1.0, 1.0])
    tc = T.SpectralCube.read(path, device="cpu")
    jc = J.SpectralCube.read(path)
    return tpar.ShardedCube(tc, tmesh), tc, jpar.ShardedCube(jc, jmesh)


VR_EDITS = {
    "mask_channels": lambda c, p: c.mask_channels(np.arange(6) != 2),
    "mask_out_bad_beams": lambda c, p: c.mask_out_bad_beams(0.1),
    "with_beams": lambda c, p: c.with_beams(
        c.unmasked_beams, goodbeams_mask=np.arange(6) != 2,
        raise_error_jybm=False),
}


@pytest.mark.parametrize("case", sorted(VR_EDITS))
def test_varying_resolution_edits(vr_cubes, tmesh, case):
    """A varying-resolution cube's beam edits: the new beams and good
    beams on the template, a channel mask where the unsharded call adds
    one; then a spectral reduction that reads them (the average beam of
    the good channels)."""
    sc, uc, jsc = vr_cubes
    fn = VR_EDITS[case]
    tmesh.reset_counters()
    got = fn(sc, T)
    assert tmesh.counters["gathers"] == 0
    want = fn(uc, T)
    _hold(case, "exact", got, want, fn(jsc, J), uc)
    tmesh.reset_counters()
    assert np.array_equal(got.goodbeams_mask, want.goodbeams_mask)
    assert got.average_beams() == want.average_beams()
    assert got.moment0().beam == want.moment0().beam
    assert tmesh.counters["gathers"] == 0


def test_f6_device_and_lookups_gather_nothing(cubes, tmesh):
    """F6: ``sc.device`` is the mesh's first device and a method lookup
    (``chunked``, ``find_lines``, any gathered method) moves nothing; the
    gather comes with the call, once."""
    sc, _, _ = cubes(SHAPES[0], "gt")
    tmesh.reset_counters()
    assert sc.device == tmesh.devices[0]
    chunked = sc.chunked
    assert callable(sc.find_lines) and callable(sc.write)
    assert callable(sc.apply_numpy_function)
    assert not hasattr(sc, "no_such_method")
    assert tmesh.counters["gathers"] == 0
    with pytest.raises(NotImplementedError):
        chunked()
    assert tmesh.counters["gathers"] == 0
    fresh = tpar.ShardedCube(sc.cube, tmesh)
    tmesh.reset_counters()
    fn = fresh.apply_numpy_function
    assert tmesh.counters["gathers"] == 0
    fn(np.nanmax)
    fn(np.nanmin)
    assert tmesh.counters["gathers"] == 1


def _gathered_calls(tmp_path):
    """Per ``GATHERED`` name, a call of it (each gathers the cube)."""
    def plot(c):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        c.plot_channel_maps(1, 1, [0])
        plt.close("all")
    return {
        "write": lambda c: c.write(str(tmp_path / "w.fits"), overwrite=True),
        "hdu": lambda c: c.hdu,
        "hdulist": lambda c: c.hdulist,
        "to_yt": lambda c: c.to_yt(),
        "to_glue": lambda c: c.to_glue(start_gui=False),
        "to_ds9": lambda c: c.to_ds9(),
        "to_pvextractor": lambda c: c.to_pvextractor(),
        "plot_channel_maps": plot,
        "filled": lambda c: c.filled(),
        "get_mask_array": lambda c: c.get_mask_array(),
        "apply_numpy_function": lambda c: c.apply_numpy_function(np.nanmax),
        "apply_function": lambda c: c.apply_function(np.nanmax, axis=0),
        "apply_function_parallel_spectral": lambda c:
            c.apply_function_parallel_spectral(lambda d: d,
                                               accepts_chunks=True),
        "apply_function_parallel_spatial": lambda c:
            c.apply_function_parallel_spatial(lambda d: d,
                                              accepts_chunks=True),
        "mask": lambda c: c.mask,
    }


@pytest.mark.parametrize("name", sorted(tsh.GATHERED))
def test_gathered_calls_still_gather(tmp_path, tmesh, name):
    """Each ``GATHERED`` name gathers the cube when called (an exporter
    whose package is absent raises after its gather); ``mask`` on a cube
    with a stored include (its data and its include)."""
    path, _ = make_cube_file(tmp_path, shape=(5, 6, 8))
    tc = T.SpectralCube.read(path, device="cpu")
    sc = tpar.ShardedCube(tc, tmesh)
    if name == "mask":
        sc = tpar.ShardedCube._from_parts(
            tmesh, sc._data, sc._template,
            include=sc._data.map(torch.isfinite))
    call = _gathered_calls(tmp_path)[name]
    tmesh.reset_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            call(sc)
        except ImportError:
            pass
    assert tmesh.counters["gathers"] >= 1, tmesh.counters
    assert tsh.GATHERED[name]


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_every_cube_name_is_sharded_metadata_or_gathered():
    """Every public name of the port's cubes is defined on ShardedCube,
    read from its metadata cube, or a ``GATHERED`` name with its reason;
    no name is listed twice, and every listed name is a cube's."""
    names = _public(T.SpectralCube) | _public(T.VaryingResolutionSpectralCube)
    own = {n for n in names if inspect.getattr_static(
        tpar.ShardedCube, n, None) is not None}
    gathered = set(tsh.GATHERED)
    metadata = {n for n in tsh._METADATA if not n.startswith("_")}
    missing = names - own - metadata - gathered
    assert not missing, sorted(missing)
    assert not (metadata & own), sorted(metadata & own)
    assert not (metadata & gathered), sorted(metadata & gathered)
    assert gathered <= names | _public(tpar.ShardedCube), \
        sorted(gathered - names)
    defined_here = gathered & own
    assert defined_here == {"apply_function",
                            "apply_function_parallel_spectral",
                            "apply_function_parallel_spatial",
                            "mask"}, sorted(defined_here)
