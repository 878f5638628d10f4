"""What the distinct-mesh tests (``tests/test_torch_mesh_distinct*.py``)
share: the meshes of distinct virtual devices (``tests/torch_vdev.py``)
and the four holds of a call on one of them.

Each mesh of :data:`MESHES` places its positions on distinct devices
(``cpu:k``; "2x2 host" puts the host ``cpu`` on the diagonal, the mesh's
first position included, as ``chip_smoke.py``'s distinct-mesh phase puts
the host beside the card), beside the repeated-device mesh of the same grid (``["cpu"] * n``, the
mesh every other CPU test runs).  :func:`run_both` runs a call on the
two, the distinct mesh's under :class:`~torch_vdev.VirtualDevices`, and
holds it four ways (the JAX package is the caller's): bit for bit the
repeated mesh's result (:func:`chip_smoke.hold_values` at zero
tolerance), every block of a result on its position's device
(:func:`chip_smoke.placement_errors`), and the mesh's counters (halo
exchanges, all-to-alls, gathers) equal to the repeated mesh's.
"""

from __future__ import annotations

from collections import namedtuple

import chip_smoke as cs
from torch_vdev import virtual_devices, vdev
from spectral_cube_tpu_torch import parallel as tpar

#: mesh name -> (grid, the positions' devices, row-major)
MESHES = {
    "1x1": ((1, 1), [vdev(1)]),
    "1x2": ((1, 2), [vdev(1), vdev(2)]),
    "2x2": ((2, 2), [vdev(k) for k in range(1, 5)]),
    "2x4": ((2, 4), [vdev(k) for k in range(1, 9)]),
    "2x2 host": ((2, 2), [vdev(0), vdev(1), vdev(2), vdev(0)]),
}

#: one call on the two meshes: each result's host values, the distinct
#: mesh's result itself (its tensors on virtual devices), each mesh's
#: counters, and the blocks off their positions
Both = namedtuple("Both", "got want value counters want_counters misplaced")


def meshes(name):
    """(the distinct mesh, the repeated mesh) of ``name``."""
    grid, devs = MESHES[name]
    return (tpar.CubeMesh(devices=devs, shape=grid),
            tpar.CubeMesh(devices=["cpu"] * len(devs), shape=grid))


def run_both(name, fn):
    """``fn(cmesh)`` on the repeated mesh and, under virtual devices, on
    the distinct mesh of ``name``, each mesh's counters reset just before
    and read just after.  Returns :class:`Both`."""
    distinct, repeated = meshes(name)
    want = fn(repeated)
    want_counters = dict(repeated.counters)
    want_host = cs.host_values(want)
    with virtual_devices():
        value = fn(distinct)
        counters = dict(distinct.counters)
        misplaced = cs.placement_errors(value, distinct)
        got = cs.host_values(value)
    return Both(got, want_host, value, counters, want_counters, misplaced)


def hold_both(tag, both, gathers=0):
    """A call's distinct-mesh result bit for bit the repeated mesh's,
    each block on its position's device, the counters the repeated
    mesh's, ``gathers`` gathers of a cube."""
    assert not both.misplaced, (tag, both.misplaced)
    assert both.counters == both.want_counters, (tag, both.counters,
                                                 both.want_counters)
    assert both.counters["gathers"] == gathers, (tag, both.counters)
    cs.hold_values(tag, both.got, both.want, (0.0, 0.0))

