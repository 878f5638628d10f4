"""Torch port, ``tests/test_torch_public_sharded.py``'s table on the 1x1,
1x2 and 2x2 meshes of distinct virtual devices, each call held four ways
as ``tests/test_torch_mesh_distinct_cube.py`` holds it on the 2x4 mesh
(against the JAX package on a mesh of the same grid)."""

import pytest

import torch_public as tp
from test_torch_mesh_distinct_cube import KEYS, hold_call

pytestmark = pytest.mark.filterwarnings("ignore::Warning")


@pytest.mark.parametrize("key", KEYS, ids=tp.ids(KEYS))
@pytest.mark.parametrize("mesh", ["1x1", "1x2", "2x2"])
def test_call_on_distinct_devices(mesh, key):
    hold_call(mesh, key)
