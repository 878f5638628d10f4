"""Torch port, the spline orders of ``ShardedCube.reproject`` on meshes of
distinct devices (``tests/torch_distinct.py``): biquadratic and bicubic
onto the shifted grid (the separable products), the rotated grid (the
prefilters and tap gathers), a new spectral axis (the spline operator
along z, then two all-to-alls) and both at once.

Each call is held four ways: against the JAX package's ShardedCube and
unsharded reproject at the spline tests' atol 5e-6
(``tests/test_torch_card_scale_sharded_spectral.py``'s ``jax_spline``);
bit for bit against the same call on the repeated-device mesh of the
same grid; every block on its position's device; the mesh's counters the
repeated mesh's, no gather.
"""

import numpy as np
import pytest

import spectral_cube_tpu_torch as T

import torch_distinct as td
from test_torch_card_scale_sharded_spectral import (ORDERS, TARGETS,
                                                    jax_spline, spline_file,
                                                    target_header)

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

__all__ = ["jax_spline", "spline_file"]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("mesh", list(td.MESHES))
def test_spline_reproject_on_distinct_devices(spline_file, jax_spline,
                                              mesh, target, order):
    path, h = spline_file
    header = target_header(h, target)

    def run(m):
        sc = T.SpectralCube.read(path, device="cpu").to_sharded(m)
        m.reset_counters()
        return sc.reproject(header, order=order)
    both = td.run_both(mesh, run)
    td.hold_both(f"{mesh} {target} {order}", both)
    got = both.got[1]
    for want in jax_spline(target, order):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        assert fin.mean() > 0.3
        np.testing.assert_allclose(got[fin], want[fin], atol=5e-6)
