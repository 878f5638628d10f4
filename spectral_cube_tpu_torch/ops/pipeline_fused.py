"""Whole-pipeline fusion: masked moments + statistics + convolve +
reproject in one pass over the cube.

Port of ``spectral_cube_tpu/ops/pipeline_fused.py``.  The moments and
statistics of the masked cube and its common-beam convolution onto an
axis-aligned target are otherwise two kernels (kernel 1, then kernel 6),
so the cube is read twice; here kernel 6's pipeline mode
(``kernels/pipeline_fused.py``) takes kernel 1's sufficient planes from the
same read, with kernel 1's per-spaxel arithmetic, and
:func:`~.moments.finalize_planes` finishes them.  The moments therefore
equal ``moments_012_kernel(..., with_stats=True)``'s and the cube
``convolve_reproject_separable``'s.

Reference math: ``spectral_cube/_moments.py:170-193`` (moments) and the
statistics dict of ``dask_spectral_cube.statistics``.
"""

from __future__ import annotations

from ..kernels.pipeline_fused import pipeline_fused
from ..masks import is_data_local
from .moments import _center, _kernel_inputs, finalize_planes
from .regrid import _conv_reproject_operators, fused_plan_fits

__all__ = ["moments_conv_reproject_fused"]


def moments_conv_reproject_fused(data, kernel, ys, xs, coords, dx,
                                 mask_expr=None):
    """Fused masked moments 0/1/2 + statistics + convolve + reproject.

    Parameters match ``ops.moments.moments_012_kernel`` (``coords``,
    ``dx``, a data-local ``mask_expr``) plus
    ``ops.regrid.convolve_reproject_separable`` (2-D ``kernel``, the
    axis-aligned output mapping ``ys``/``xs``).

    Returns ``(reprojected, mom0, mom1, mom2, stats)``, or None where the
    JAX function does (a mask that is not data-local, a kernel that does
    not separate, a mapping that is not axis-aligned, a plan that does not
    fit the kernel: :func:`~.regrid.fused_plan_fits` in mode 2, as the
    JAX kernel's VMEM planner declines; its TPU backend gate is dropped),
    so callers take the two-kernel chain."""
    if data.ndim != 3:
        return None
    if mask_expr is not None and not is_data_local(mask_expr):
        return None
    ops = _conv_reproject_operators(data.shape, kernel, ys, xs)
    if ops is None or not fused_plan_fits(data.shape, ops, mode=2):
        return None
    coords_c, xbar = _center(coords)
    op, thr, include = _kernel_inputs(data, mask_expr, None)
    out, planes, cnt = pipeline_fused(
        data, ops.gy, ops.gx, ops.my, ops.mx, ops.ry, ops.rx, ops.valid,
        coords_c, op, thr, include)
    mom0, mom1, mom2, stats = finalize_planes(planes, cnt, xbar, dx, True)
    odt = data.dtype
    return out.to(odt), mom0.to(odt), mom1.to(odt), mom2.to(odt), stats
