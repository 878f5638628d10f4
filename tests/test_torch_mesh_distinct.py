"""Torch port, the sharded path on meshes of distinct devices: the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py``), its six steps and
its product pipeline at 48 x 80 x 96, and the mesh's primitives
(``reshard`` both ways, ``halo_pad``), on the meshes of
``tests/torch_distinct.py`` (1x1, 1x2, 2x2, 2x4 of distinct virtual
devices and a 2x2 mesh with the host at two positions).

Each call is held four ways: against the JAX package on its 8-device
mesh at the existing tests' tolerances; bit for bit against the same
call on the repeated-device mesh of the same grid; every block on its
position's device; the mesh's counters the repeated mesh's, no gather of
a cube.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
import torch_distinct as td
from torch_vdev import virtual_devices
from spectral_cube_tpu_torch import parallel as tpar

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

SHAPE = (48, 80, 96)
MESHES = list(td.MESHES)
#: each step's (rtol, atol) against the JAX package: the moments' as
#: tests/test_torch_parallel.py holds sharded_moments, the convolutions'
#: as its halo convolution, the pipeline's as _dryrun_product_pipeline
STEP_TOLERANCES = {"moments": [(1e-6, 0.0), (1e-6, 0.0), (1e-5, 1e-7)],
                   "mean": (1e-5, 0.0), "halo smooth": (1e-5, 1e-6),
                   "fft": (1e-5, 1e-6), "separable": (1e-5, 1e-6),
                   "smooth_interpolate": (1e-5, 1e-6)}
STEPS = list(STEP_TOLERANCES)


def _near(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def jmesh():
    from spectral_cube_tpu import parallel as jpar
    if len(jax.devices()) != 8:
        pytest.skip("the JAX side needs the 8-device virtual mesh")
    return jpar.CubeMesh()


@pytest.fixture(scope="module")
def jax_steps(jmesh):
    """dryrun_multichip's six steps in the JAX package at SHAPE, as
    ``__graft_entry__.py`` runs them (steps 1-4 in one shard_map program),
    host arrays."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from spectral_cube_tpu.ops.moments import moments_012
    from spectral_cube_tpu.ops import reductions as jred
    from spectral_cube_tpu.ops.convolve import device_complex
    from spectral_cube_tpu.parallel.sharded import (
        halo_pad, sharded_convolve_per_channel_separable,
        sharded_smooth_interpolate)
    nchan, ny, nx = SHAPE
    coords = np.arange(nchan, dtype=np.float64) * 0.5
    kernel = cs.DRYRUN_KERNEL
    data, data2, data3 = cs.dryrun_inputs(SHAPE)

    def local_step(d):
        include = d > 0.3
        m0, m1, m2 = moments_012(d, coords, 0.5, include=include)
        valid = jred.valid_mask(d, include)
        cnt = jax.lax.psum(jnp.sum(valid), ("y", "x"))
        total = jax.lax.psum(jnp.sum(jnp.where(valid, d, 0)), ("y", "x"))
        padded = halo_pad(jnp.where(valid, d, 0), 1, 1)
        kj = jnp.asarray(kernel[::-1, ::-1], dtype=d.dtype)[None, None]
        sm = jax.lax.conv_general_dilated(
            padded[:, None], kj, (1, 1), padding="VALID",
            precision=jax.lax.Precision.HIGHEST,
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[:, 0]
        return m0, m1, m2, sm, total / jnp.maximum(cnt, 1)

    step = shard_map(local_step, mesh=jmesh.mesh,
                     in_specs=(P(None, "y", "x"),),
                     out_specs=(P("y", "x"), P("y", "x"), P("y", "x"),
                                P(None, "y", "x"), P()))
    transfer = device_complex(np.ones((nchan, ny + 2, (nx + 2) // 2 + 1),
                                      np.complex64))

    @jax.jit
    def full_step(d):
        m0, m1, m2, sm, mean = step(d)
        d2 = jmesh.reshard(sm, "spectral", source="spatial")
        f = jnp.fft.rfft2(d2, s=(ny + 2, nx + 2))
        conv = jnp.fft.irfft2(f * transfer, s=(ny + 2, nx + 2))[:, :ny, :nx]
        return m0, m1, m2, sm, mean, jmesh.reshard(conv, "spatial",
                                                   source="spectral")

    m0, m1, m2, sm, mean, conv = full_step(
        jmesh.shard(jnp.asarray(data), "spatial"))
    sep = sharded_convolve_per_channel_separable(
        data2, [kernel / kernel.sum(), None],
        (np.arange(nchan) % 2).astype(np.int32), jmesh)
    si, _ = sharded_smooth_interpolate(
        data3, np.array([0.25, 0.5, 0.25]), coords, coords[::2], jmesh)
    return {"moments": tuple(np.asarray(m) for m in (m0, m1, m2)),
            "mean": float(mean), "halo smooth": np.asarray(sm),
            "fft": np.asarray(conv), "separable": np.asarray(sep),
            "smooth_interpolate": np.asarray(si)}


@pytest.fixture(scope="module")
def jax_pipeline(jmesh):
    """_dryrun_product_pipeline's run_pipeline in the JAX package: the
    moments, statistics and reprojected cube as host values."""
    import spectral_cube_tpu as J
    from spectral_cube_tpu.io.fits_low import HDU
    cube, th = cs.dryrun_pipeline_cube(SHAPE, "cpu")
    jcube = J.SpectralCube.read(HDU(data=cube.unmasked_data[:].value,
                                    header=cube.header)) \
        .with_fill_value(np.nan)
    res = J.run_pipeline(J.parallel.ShardedCube(jcube, jmesh).cube, jmesh,
                         snr_threshold=1.0,
                         target_beam=J.Beam(J.Quantity(40.0, "arcsec"),
                                            J.Quantity(40.0, "arcsec"),
                                            J.Quantity(0.0, "deg")),
                         noise_estimate=J.Quantity(0.28, "K"),
                         target_header=th)
    return {"moments": [np.asarray(m.value) for m in res["moments"]],
            "statistics": {k: float(getattr(v, "value", v))
                           for k, v in res["statistics"].items()},
            "cube": np.asarray(res["cube"].unmasked_data[:].value)}


_RUNS = {}


def _steps(mesh):
    """dryrun_steps on the mesh ``mesh`` and its repeated mesh, once a
    process."""
    if mesh not in _RUNS:
        _RUNS[mesh] = td.run_both(mesh, lambda m: cs.dryrun_steps(m, SHAPE))
    return _RUNS[mesh]


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("mesh", MESHES)
def test_dryrun_step(mesh, step, jax_steps):
    """Each of dryrun_multichip's steps on the distinct mesh: against the
    JAX package, bit for bit the repeated mesh's, its blocks placed."""
    both = _steps(mesh)
    got, want = both.got[step], jax_steps[step]
    cs.hold_values(f"{mesh} {step}", got, both.want[step], (0.0, 0.0))
    tol = STEP_TOLERANCES[step]
    if step == "moments":
        for g, w, t in zip(got, want, tol):
            _near(g, w, *t)
    else:
        _near(got, want, *tol)
    assert not both.misplaced, both.misplaced


@pytest.mark.parametrize("mesh", MESHES)
def test_dryrun_steps_exchange_as_the_repeated_mesh(mesh):
    """The six steps' halo exchanges and all-to-alls on the distinct mesh
    are the repeated mesh's; no gather; the shards of the moments lie on
    their positions' devices."""
    both = _steps(mesh)
    td.hold_both(mesh, both)
    distinct, _ = td.meshes(mesh)
    if distinct.n_devices > 1:
        assert both.counters["halo_exchanges"] > 0
        assert both.counters["all_to_alls"] > 0
    devs = [str(d) for d in distinct.devices]
    with virtual_devices():
        for arr in both.value["moments"]:
            assert [str(b.device) for b in arr.blocks] == devs


@pytest.mark.parametrize("mesh", MESHES)
def test_dryrun_pipeline(mesh, jax_pipeline):
    """_dryrun_product_pipeline on the distinct mesh: the ShardedCube's
    tiles on distinct devices, run_pipeline (the FFT reshard of a 40"
    beam, the SNR mask, the halo reprojection) against the JAX package at
    the dryrun's tolerances, bit for bit the repeated mesh's, no gather."""
    sharded = {}

    def run(m):
        sc, res = cs.dryrun_pipeline(m, SHAPE, "cpu")
        sharded[m] = sc
        return res
    both = td.run_both(mesh, run)
    td.hold_both(mesh, both)
    distinct, _ = td.meshes(mesh)
    sc = next(v for k, v in sharded.items() if k.devices
              == [torch.device(d) for d in td.MESHES[mesh][1]])
    with virtual_devices():
        devs = [b.device for b in sc._data.blocks]
        assert [str(d) for d in devs] == [str(d) for d in
                                          td.MESHES[mesh][1]]
        assert not cs.placement_errors(sc, sc.cmesh)
    m0, m1, _ = (g[1] for g in both.got["moments"])
    _near(m0, jax_pipeline["moments"][0], 3e-5, 1e-6)
    _near(m1, jax_pipeline["moments"][1], 3e-5, 1e-4)
    st = both.got["statistics"]
    for key in ("npts", "mean", "sigma", "sum", "max", "min"):
        val = st[key][1] if isinstance(st[key], tuple) else st[key]
        np.testing.assert_allclose(float(val), jax_pipeline["statistics"][
            key], rtol=2e-5, atol=1e-7)
    _near(both.got["cube"][1], jax_pipeline["cube"], 3e-5, 1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_reshard_both_ways_and_halo_pad(mesh, jmesh):
    """``reshard`` spatial -> spectral -> spatial of an unaligned cube and
    ``halo_pad`` of its tiles on the distinct mesh: each spectral block
    the JAX reshard's channels, the round trip the data, the padded tiles
    the repeated mesh's, every block on its position's device, two
    all-to-alls each way (one an axis, counted on an axis of one
    position too) and two halo exchanges."""
    data = np.random.RandomState(7).rand(10, 13, 18).astype(np.float32)
    data[3, 4, 5] = np.nan
    jspec = np.asarray(jmesh.reshard(jmesh.shard(jnp.asarray(data),
                                                 "spatial"), "spectral"))

    def run(m):
        src = m.shard(data, "spatial")
        spec = m.reshard(src, "spectral")
        back = m.reshard(spec, "spatial")
        pads = tpar.halo_pad(m._tile(back, "spatial", 0.0), m, 2, 3)
        return {"spectral": spec, "back": back,
                "pads": tuple(pads)}
    both = td.run_both(mesh, run)
    distinct, _ = td.meshes(mesh)
    td.hold_both(mesh, both)
    assert both.counters["all_to_alls"] == 4
    assert both.counters["halo_exchanges"] == 2
    np.testing.assert_array_equal(both.got["spectral"], jspec)
    np.testing.assert_array_equal(both.got["back"], data)
    with virtual_devices():
        for arr in (both.value["spectral"], both.value["back"]):
            assert [str(b.device) for b in arr.blocks] == [
                str(d) for d in distinct.devices]
        assert [str(t.device) for t in both.value["pads"]] == [
            str(d) for d in distinct.devices]


def test_chip_smoke_distinct_mesh_phase_on_virtual_devices(monkeypatch,
                                                           tmp_path):
    """``chip_smoke.phase_distinct_mesh`` at a small size with a virtual
    device standing in for the card (``cpu:1``, the CUDA calls stubbed):
    every stage of D4 and D2 runs, and each holds against the card-alone
    mesh's by its kind (here both meshes run the plain versions: bit for
    bit), with counters equal and no gather."""
    from spectral_cube_tpu_torch import cube as tcube
    dev = torch.device("cpu", 1)
    for name, val in (("NY", 32), ("NX", 32), ("DM_NCHAN", 8),
                      ("DM_DRYRUN_SHAPE", (8, 16, 16))):
        monkeypatch.setattr(cs, name, val)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(tcube, "default_device", lambda: dev)
    with virtual_devices():
        line = cs.phase_distinct_mesh(dev, str(tmp_path))
    assert "D4 2x2 [cpu:1, cpu, cpu, cpu:1]" in line
    assert "largest error 0.000e+00" in line and "gathers 0" in line
    assert "D4 V (a) run_pipeline" in line \
        and "D2 run_pipeline of the convolved cube" in line
