"""Torch port, the FFT route's NaN decisions against the JAX package's
route on a slab of the card-scale varying-resolution cube's kind.

The slab (``chip_smoke.vr_flip_slab``): four of P's 1024 x 1024 planes
with the NaN primary-beam border, each convolved from its drifting beam
to the common beam (the FFT route of ``convolve_to``), the same complex64
transfers for both packages.  The port's ``ops/convolve._convolve_planes``
and the JAX package's ``_convolve_planes`` (its rfft2 branch, as it runs
on the CPU) are each held against the float64 route: a voxel is NaN where
the float32 den = 1 - K*~finite is at most 1e-6, so either route may flip
a NaN decision only where the float64 den lies within float32 rounding of
that floor (den <= 1e-5, ``chip_smoke.compare_conv``'s rule).  Outside
that band the two routes and float64 agree on every voxel, and the two
routes' values agree within 1e-6 of the largest, each weighted by its den.
``chip_smoke.py`` counts the card's flips on the same slab.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from spectral_cube_tpu_torch.ops import convolve as oc

#: the float32 rounding band of the 1e-6 floor (compare_conv's rule)
FREE_DEN = 1e-5


@pytest.fixture(scope="module")
def slab():
    return chip_smoke.vr_flip_slab()


def _routes(slab):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from spectral_cube_tpu.ops import convolve as jc
    data, tr, gidx = slab
    port = oc._convolve_planes(torch.as_tensor(data), torch.as_tensor(tr),
                               gidx).numpy()
    jax_route = np.asarray(jc._convolve_planes(
        jnp.asarray(data), jnp.asarray(tr), jnp.asarray(gidx)))
    return port, jax_route


def test_fft_route_flips_only_within_the_floor_rounding(slab):
    """Each route flips a NaN decision against float64 only where the
    float64 den lies within float32 rounding of the 1e-6 floor, and the
    two routes' NaN patterns differ only there."""
    data, tr, gidx = slab
    port, jax_route = _routes(slab)
    counts = {}
    for name, got in (("port", port), ("jax", jax_route)):
        flips, dens, free = chip_smoke.fft_flips(got, data, tr, gidx)
        assert free > 0
        assert (dens <= FREE_DEN).all(), (name, flips, dens.max())
        assert (dens > 0).all(), (name, dens.min())
        counts[name] = flips
    x = torch.as_tensor(data, dtype=torch.float64)
    den = 1.0 - oc._convolve_planes(
        (~torch.isfinite(x)).double(),
        torch.as_tensor(tr).to(torch.complex128), gidx).numpy()
    differ = np.isnan(port) != np.isnan(jax_route)
    assert (den[differ] <= FREE_DEN).all()
    # the values, each weighted by its den as compare_conv weights them
    # (num / den amplifies the float32 error of num by 1 / den)
    both = ~np.isnan(port) & ~np.isnan(jax_route)
    scale = float(np.abs(jax_route[both]).max())
    diff = np.abs(port[both].astype(np.float64) - jax_route[both])
    assert float((diff * np.minimum(den[both], 1.0)).max()) <= 1e-6 * scale
    assert counts["port"] > 0 and counts["jax"] > 0
