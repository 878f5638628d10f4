"""Torch port, every call of ``tests/test_torch_public_sharded.py``'s table
(``ShardedCube``, its members, the cube members it answers for and the
module's sharded functions) on meshes of distinct devices
(``tests/torch_distinct.py``): here the 2x4 mesh of distinct virtual
devices and the 2x2 mesh with the host at two positions; the 1x1, 1x2
and 2x2 meshes in ``tests/test_torch_mesh_distinct_cube_grids.py``.

Each call is held four ways: against the JAX package on a mesh of its
virtual devices in the same grid at the table's tolerance (``tests/torch_public.hold``); bit for bit
against the same call on the repeated-device mesh of the same grid;
every block of a sharded result on its position's device; the mesh's
counters the repeated mesh's, no gather of a cube outside
``parallel.sharded.GATHERED``.  The call and the holds run under the
virtual devices, so that numpy reads each public result as it reads the
JAX package's: a result on a device numpy cannot read raises.
"""

import contextlib

import pytest
import torch

import chip_smoke as cs
import torch_distinct as td
import torch_public as tp
import test_torch_public_sharded as ps
from torch_vdev import virtual_devices
from spectral_cube_tpu_torch.parallel.sharded import GATHERED

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

#: the meshes of this file; tests/test_torch_mesh_distinct_cube_grids.py
#: holds the table on the others
MESHES = ["2x4", "2x2 host"]
KEYS = list(ps.CALLS)


class MeshCtx(tp.Ctx):
    """The port's context of the table's calls on the CPU with the mesh
    ``cmesh`` in place of the table's 2x4 mesh of one device."""

    def __init__(self, cmesh):
        import spectral_cube_tpu_torch as T
        super().__init__(T, torch.device("cpu"))
        self.cmesh = cmesh

    def mesh(self):
        return self.cmesh


class JaxGridCtx(tp.Ctx):
    """The JAX package's context of the table's calls on a mesh of its
    first ``ny * nx`` virtual devices in the grid (ny, nx): a call whose
    result follows the grid (the separable route declines a kernel wider
    than a tile) is held against the same grid."""

    def __init__(self, grid):
        import spectral_cube_tpu as J
        super().__init__(J, None)
        self.grid = grid

    def mesh(self):
        import jax
        from spectral_cube_tpu import parallel as jpar
        n = self.grid[0] * self.grid[1]
        return jpar.CubeMesh(devices=jax.devices()[:n], shape=self.grid)


_CTX = {}
_JAX = {}


def _contexts(mesh):
    if mesh not in _CTX:
        distinct, repeated = td.meshes(mesh)
        _CTX[mesh] = (MeshCtx(distinct), MeshCtx(repeated))
    return _CTX[mesh]


def _jax(key, grid):
    if (key, grid) not in _JAX:
        if grid not in _CTX:
            _CTX[grid] = JaxGridCtx(grid)
        _JAX[key, grid] = tp._outcome(ps.CALLS[key], _CTX[grid])
    return _JAX[key, grid]


def _call(call, k):
    """The call on ``k``'s mesh, its input made first: (result, the
    mesh's counters over the call alone)."""
    with tp.on_device(k.dev):
        obj = k.inp(call.inp) if call.inp else None
        k.cmesh.reset_counters()
        out = call.fn(obj, k)
    return out, dict(k.cmesh.counters)


def hold_call(mesh, key):
    """The table's call ``key`` on the mesh ``mesh``: a member the JAX
    package refuses raises the same class on both meshes; any other call
    holds four ways."""
    call = ps.CALLS[key]
    kd, kr = _contexts(mesh)
    jwant, jerr = _jax(key, td.MESHES[mesh][0])
    if jerr is not None:
        for k in (kr, kd):
            with virtual_devices() if k is kd else contextlib.nullcontext():
                with pytest.raises(type(jerr)):
                    _call(call, k)
        return
    want, want_counters = _call(call, kr)
    with virtual_devices():
        got, counters = _call(call, kd)
        assert not cs.placement_errors(got, kd.cmesh), \
            cs.placement_errors(got, kd.cmesh)
        assert counters == want_counters, (counters, want_counters)
        member = key[1].split(".")[-1]
        if member not in GATHERED:
            assert counters["gathers"] == 0, counters
        tp.hold(got, jwant, call.tol)
        tp.hold(got, want, 0.0)


@pytest.mark.parametrize("key", KEYS, ids=tp.ids(KEYS))
@pytest.mark.parametrize("mesh", MESHES)
def test_call_on_distinct_devices(mesh, key):
    hold_call(mesh, key)
