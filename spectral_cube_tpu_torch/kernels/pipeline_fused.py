"""Kernel 6 in its pipeline mode: fused convolve + reproject with the
masked moment and statistics planes taken while the cube streams through.

:func:`pipeline_fused` launches ``csrc/conv_reproject.cu`` (mode 2) for a
CUDA tensor and runs :func:`pipeline_fused_plain` for a CPU tensor.  It
returns the fused operator's cube (as ``conv_reproject``) and kernel 1's
planes (as ``moments_planes(..., with_stats=True)``: ten (ny_in, nx_in)
float32 planes and the int32 count), so ``ops/moments.finalize_planes``
applies unchanged.  The mask is kernel 1's: the op code and threshold of
``masks.fused_predicate``, and an optional include array.
"""

from __future__ import annotations

import numpy as np

from ..profiling import spanned
from ._build import on_tensor_device, count_launch
from .conv_reproject import _check, _launch, conv_reproject_plain
from .moments import CMP_OPS, moments_planes_plain

__all__ = ["pipeline_fused", "pipeline_fused_plain"]


def _check_mask(raw, xc, cmp_op, include):
    if np.asarray(xc).shape != (raw.shape[0],):
        raise ValueError("xc must hold one coordinate per channel")
    if cmp_op and cmp_op not in CMP_OPS:
        raise ValueError(f"unknown comparison op code {cmp_op}")
    if include is not None and include.shape != raw.shape:
        raise ValueError(f"include shape {tuple(include.shape)} != data "
                         f"shape {tuple(raw.shape)}")


@spanned("sct.kernels.pipeline_fused")
@on_tensor_device
def pipeline_fused(raw, gy, gx, my, mx, ry, rx, valid_plane, xc, cmp_op=0,
                   threshold=0.0, include=None):
    """``(out, planes, count)``: :func:`~.conv_reproject.conv_reproject`'s
    cube and :func:`~.moments.moments_planes`' with-stats planes of ``raw``
    at centered coordinates ``xc``, from one pass over the cube.  A CPU
    tensor takes the plain version; a CUDA tensor the kernel: one call
    launches two kernels on the device, ``chan_flags_kernel`` (after a
    memset of the flags) and ``conv_reproject_kernel`` in mode 2."""
    _check(raw, gy, gx, my, mx, ry, rx, valid_plane)
    _check_mask(raw, xc, cmp_op, include)
    if raw.device.type == "cpu":
        return pipeline_fused_plain(raw, gy, gx, my, mx, ry, rx,
                                    valid_plane, xc, cmp_op, threshold,
                                    include)
    res = _launch(2, raw, gy, gx, (my, mx, ry, rx), valid_plane,
                  moments=(xc, cmp_op, threshold, include))
    count_launch(pipeline_fused)
    return res


pipeline_fused.launches = 0


def pipeline_fused_plain(raw, gy, gx, my, mx, ry, rx, valid_plane, xc,
                         cmp_op=0, threshold=0.0, include=None):
    """:func:`pipeline_fused` in plain PyTorch: kernel 1's plain planes
    beside the plain fused operator."""
    _check_mask(raw, xc, cmp_op, include)
    planes, count = moments_planes_plain(raw, xc, cmp_op, threshold, include,
                                         True)
    out = conv_reproject_plain(raw, gy, gx, my, mx, ry, rx, valid_plane)
    return out, planes, count
