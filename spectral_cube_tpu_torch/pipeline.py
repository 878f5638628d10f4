"""End-to-end analysis pipeline on one device (BASELINE config #5).

``read -> convolve_to -> SNR mask -> moments + statistics -> reproject``,
the chain the JAX package's ``run_pipeline`` runs over a device mesh, here
through the cube methods on the cube's own device: on a CUDA device every
heavy step runs in the port's kernels (moments and statistics in kernel 1,
a separable convolution in kernel 2, an axis-aligned reprojection in
kernel 3).  A varying-resolution cube first converges to its common beam;
kernels that do not separate take the FFT route (cuFFT), rotated targets
the four-corner gather (torch).
"""

from __future__ import annotations

import warnings

import numpy as np

from .cube_utils import _has_beams
from .units import Quantity
from .utils import VarianceWarning

__all__ = ["run_pipeline"]


def run_pipeline(cube, cmesh=None, snr_threshold=None, target_beam=None,
                 target_header=None, noise_estimate=None):
    """Run the masked-analysis pipeline on one cube.

    Parameters
    ----------
    cube : SpectralCube or VaryingResolutionSpectralCube
    cmesh : must be None; a multi-device mesh is not ported to torch yet
        (ROADMAP.md Queue 1 item 12).
    snr_threshold : float, optional -- mask voxels at or below
        ``snr_threshold * noise`` before the moments, the noise from
        ``cube.mad_std()`` unless ``noise_estimate`` is given.
    target_beam : Beam, optional -- convolve to this beam first (default:
        the common beam of a varying-resolution cube, else no convolution).
    target_header : optional -- reproject the convolved, masked cube onto
        this WCS last.

    Returns a dict with 'moments' (mom0, mom1, linewidth Projections),
    'statistics' and 'cube' (the convolved/reprojected cube), the keys of
    the JAX package's ``run_pipeline``.
    """
    if cmesh is not None:
        raise NotImplementedError(
            "multi-device execution is not ported to torch yet "
            "(ROADMAP.md Queue 1 item 12)")
    # a varying-resolution cube reaches a common beam before any spectral
    # reduction (the reference's beam-sameness guard)
    if target_beam is None and _has_beams(cube):
        target_beam = cube.common_beam()
    if target_beam is not None:
        cube = cube.convolve_to(target_beam)

    if snr_threshold is not None:
        if noise_estimate is None:
            noise = float(cube.mad_std().value)
        else:
            noise = float(noise_estimate.to_value(cube.unit)
                          if isinstance(noise_estimate, Quantity)
                          else noise_estimate)
        cube = cube.with_mask(cube > Quantity(snr_threshold * noise,
                                              cube.unit))

    # moment0/1/2 share one pass (SpectralCube._moments012 is cached)
    m0 = cube.moment0()
    m1 = cube.moment1()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", VarianceWarning)
        linewidth = cube.linewidth_sigma()
    stats = cube.statistics()

    out_cube = cube
    if target_header is not None:
        out_cube = cube._reproject(target_header)
    return {"moments": (m0, m1, linewidth), "statistics": stats,
            "cube": out_cube}
