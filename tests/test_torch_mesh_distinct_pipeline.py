"""Torch port, the sharded pipeline on meshes of distinct devices
(``tests/torch_distinct.py``: 1x1, 1x2, 2x2, 2x4 of distinct virtual
devices and a 2x2 mesh with the host at two positions): a streamed read
(``io.streaming.read_sharded_cube``), ``to_sharded``, and
``run_pipeline(cmesh=)`` on a single-beam cube (halo routes onto a
shifted grid, the reshard reprojection onto a rotated one); the filled
resample onto a new spectral axis and the varying-resolution cube's
routes in ``tests/test_torch_mesh_distinct_routes.py``.

Each call is held four ways: against the JAX package on a mesh of its
virtual devices in the same grid, at the tolerances of
``tests/test_torch_streaming.py``'s sharded pipeline test; bit for bit
against the same call on the repeated-device mesh of the same grid;
every block on its position's device; the mesh's counters the repeated
mesh's, no gather.
"""

import numpy as np
import jax
import pytest

import spectral_cube_tpu as J
from spectral_cube_tpu import parallel as jpar
from spectral_cube_tpu.io import streaming as jstream

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.io import streaming as tstream

import chip_smoke as cs
import torch_distinct as td
from conftest import HDU, base_header, make_beams_table, write_fits
from torch_vdev import virtual_devices

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

MESHES = list(td.MESHES)
#: the pipeline cube (tests/test_torch_streaming.py's) and the
#: varying-resolution cube
SHAPE = (20, 32, 40)
VR_SHAPE = (12, 24, 32)
#: moments (mom0, mom1, linewidth), statistics and cube tolerances
#: (rtol, atol): tests/test_torch_streaming.py's; the FFT route's cube
#: tests/test_torch_parallel.py's
MOMENTS = [(3e-5, 1e-6), (3e-5, 1e-4), (1e-4, 1e-4)]
STATISTICS = (2e-5, 1e-7)
CUBE = {"fft": (2e-4, 2e-6)}


def jmesh_of(mesh):
    if len(jax.devices()) != 8:
        pytest.skip("the JAX side needs the 8-device virtual mesh")
    grid = td.MESHES[mesh][0]
    return jpar.CubeMesh(devices=jax.devices()[:grid[0] * grid[1]],
                         shape=grid)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The single-beam pipeline cube and the varying-resolution cube."""
    d = tmp_path_factory.mktemp("distinct_pipeline")
    rng = np.random.RandomState(7)
    data = rng.randn(*SHAPE) * 0.1 + 1.5 * np.exp(-0.5 * ((np.arange(
        SHAPE[0]) - 10) / 2.0) ** 2)[:, None, None]
    data[:, :2, :] = np.nan
    h = base_header(nx=SHAPE[2], ny=SHAPE[1], nchan=SHAPE[0])
    h["BMAJ"], h["BMIN"], h["BPA"] = 6.0 / 3600, 4.5 / 3600, 30.0
    h["CDELT1"], h["CDELT2"] = -2.0 / 3600, 2.0 / 3600
    single = str(d / "pipe.fits")
    write_fits(single, [HDU(data=data, header=h)])
    nchan, ny, nx = VR_SHAPE
    vdata = rng.randn(*VR_SHAPE) * 0.1 + 1.5 * np.exp(-0.5 * ((np.arange(
        nchan) - 6) / 2.0) ** 2)[:, None, None]
    vdata[:, :, :1] = np.nan
    vh = base_header(nx=nx, ny=ny, nchan=nchan, beam=False)
    vh["CASAMBM"] = True
    vr = str(d / "vr.fits")
    write_fits(vr, [HDU(data=vdata, header=vh), make_beams_table(
        nchan, np.linspace(3.0, 4.0, nchan))])
    return {"single": single, "vr": vr}


def _shifted(h):
    t = h.__class__(h)
    t["CRPIX1"] = float(t["CRPIX1"]) + 0.37
    t["CRPIX2"] = float(t["CRPIX2"]) - 0.61
    return t


def _rotated(h):
    return cs.rotated_header(h, 3.0)


def _spectral(h):
    t = _shifted(h)
    t["NAXIS3"] = 9
    t["CDELT3"] = h["CDELT3"] * 2.0
    t["CRVAL3"] = h["CRVAL3"] + 0.25 * h["CDELT3"]
    return t


#: case -> (file, target, target beam (arcsec, None: the common beam),
#: whether the route takes all-to-alls on a mesh of more than one
#: position: the halo routes none, the reshard reprojection and the FFT
#: route some)
CASES = {
    "halo": ("single", _shifted, 12.0, False),
    "rotated": ("single", _rotated, 12.0, True),
    "spectral axis": ("single", _spectral, 12.0, False),
    "vr separable": ("vr", _shifted, None, False),
    "vr fft": ("vr", _rotated, 30.0, True),
}
#: the cases of this file; tests/test_torch_mesh_distinct_routes.py holds
#: the others
SINGLE = ["halo", "rotated"]


def _beam(P, arcsec):
    return None if arcsec is None else P.Beam(
        P.Quantity(arcsec, "arcsec"), P.Quantity(arcsec, "arcsec"), 0.0)


def _port_pipeline(path, case, cmesh):
    _, target, arcsec, _ = CASES[case]
    if case.startswith("vr"):
        sc = T.SpectralCube.read(path, device="cpu").to_sharded(cmesh)
    else:
        sc = tstream.read_sharded_cube(path, cmesh)
    cmesh.reset_counters()
    return T.run_pipeline(sc, cmesh, snr_threshold=3.0,
                          target_beam=_beam(T, arcsec),
                          target_header=target(sc.header))


_JAX = {}


def _jax_pipeline(path, case, mesh):
    grid = td.MESHES[mesh][0]
    if (case, grid) not in _JAX:
        _, target, arcsec, _ = CASES[case]
        jm = jmesh_of(mesh)
        jc = J.SpectralCube.read(path) if case.startswith("vr") else \
            jstream.read_sharded_cube(path, jm, dtype=np.float32)
        res = J.run_pipeline(jc, jm, snr_threshold=3.0,
                             target_beam=_beam(J, arcsec),
                             target_header=target(jc.header))
        _JAX[case, grid] = (
            [np.asarray(m.value) for m in res["moments"]],
            {k: float(getattr(v, "value", v))
             for k, v in res["statistics"].items()},
            np.asarray(res["cube"].unmasked_data[:].value))
    return _JAX[case, grid]


def _near(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def hold_pipeline(files, mesh, case):
    """``run_pipeline(cmesh=)`` of the case on the distinct mesh: against
    the JAX package's sharded pipeline, bit for bit the repeated mesh's,
    each block of the reprojected cube on its position's device, the
    repeated mesh's exchanges (the case's route) and no gather."""
    path = files[CASES[case][0]]
    both = td.run_both(mesh, lambda m: _port_pipeline(path, case, m))
    td.hold_both(f"{mesh} {case}", both)
    distinct, _ = td.meshes(mesh)
    if distinct.n_devices > 1:
        assert (both.counters["all_to_alls"] > 0) == CASES[case][3], \
            both.counters
    moments, stats, cube = _jax_pipeline(path, case, mesh)
    for (_, got), want, tol in zip(both.got["moments"], moments, MOMENTS):
        _near(got, want, *tol)
    for key in ("npts", "mean", "sigma", "sum", "max", "min"):
        got = both.got["statistics"][key]
        got = got[1] if isinstance(got, tuple) else got
        np.testing.assert_allclose(float(got), stats[key], rtol=STATISTICS[
            0], atol=STATISTICS[1])
    with virtual_devices():
        got = both.value["cube"].unmasked_data[:].value
    _near(got, cube, *CUBE.get(case.split()[-1], (1e-5, 1e-6)))


@pytest.mark.parametrize("case", SINGLE)
@pytest.mark.parametrize("mesh", MESHES)
def test_run_pipeline_on_distinct_devices(files, mesh, case):
    hold_pipeline(files, mesh, case)


@pytest.mark.parametrize("how", ["read_sharded_cube", "to_sharded"])
@pytest.mark.parametrize("mesh", MESHES)
def test_reads_land_on_each_position(files, mesh, how):
    """A streamed read and ``to_sharded``: each position's block on its
    own device, the values the JAX streamed read's and the repeated
    mesh's bit for bit, no exchange and no gather."""
    path = files["single"]

    def read(m):
        if how == "to_sharded":
            return T.SpectralCube.read(path, device="cpu").to_sharded(m)
        return tstream.read_sharded_cube(path, m)
    both = td.run_both(mesh, read)
    td.hold_both(f"{mesh} {how}", both)
    assert both.counters == {"halo_exchanges": 0, "all_to_alls": 0,
                             "gathers": 0}
    distinct, _ = td.meshes(mesh)
    with virtual_devices():
        assert [str(b.device) for b in both.value._data.blocks] == [
            str(d) for d in distinct.devices]
    jc = jstream.read_sharded_cube(path, jmesh_of(mesh), dtype=np.float32)
    np.testing.assert_array_equal(both.got[1], np.asarray(
        jc.filled_data[:].value))
