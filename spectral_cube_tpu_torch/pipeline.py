"""End-to-end analysis pipeline (BASELINE config #5), on one device or
over a device mesh.

``read -> convolve_to -> SNR mask -> moments + statistics -> reproject``.
Without a mesh the chain runs through the cube methods on the cube's own
device: on a CUDA device every heavy step runs in the port's kernels
(moments and statistics in kernel 1, a separable convolution in kernel 2,
an axis-aligned reprojection in kernel 3); a varying-resolution cube first
converges to its common beam, kernels that do not separate take the FFT
route (cuFFT), rotated targets the four-corner gather (torch).  With
``cmesh`` it runs through :class:`~.parallel.ShardedCube`, as the JAX
package's ``run_pipeline`` does: each shard runs the same kernels, with no
all-to-all when the beams separate (the halo-exchange convolution) and
the target grid is axis-aligned within one tile's reach (the halo
reprojection), and two per non-conforming stage otherwise.
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
    cmesh : CubeMesh, optional -- run sharded over this mesh (the cube may
        already be a ShardedCube, e.g. from ``io.streaming``); None runs
        on the cube's own device.
    snr_threshold : float, optional -- mask voxels at or below
        ``snr_threshold * noise`` before the moments, the noise from
        ``cube.mad_std()`` unless ``noise_estimate`` is given.
    target_beam : Beam, optional -- convolve to this beam first (default:
        the common beam of a varying-resolution cube, else no convolution).
    target_header : optional -- reproject the convolved, masked cube onto
        this WCS last.

    Returns a dict with 'moments' (mom0, mom1, linewidth Projections),
    'statistics' and 'cube' (the convolved/reprojected cube), the keys of
    the JAX package's ``run_pipeline``.  With ``cmesh``, 'cube' is a
    :class:`~.parallel.ShardedCube`, its data left on the mesh; its
    ``.cube`` gathers the SpectralCube onto the mesh's first device.  The
    JAX package returns that SpectralCube, its array still sharded, which
    one torch tensor cannot be.  A ``cmesh`` that is not a CubeMesh
    raises TypeError.
    """
    if cmesh is not None:
        return _run_sharded(cube, cmesh, snr_threshold, target_beam,
                            target_header, noise_estimate)
    # a varying-resolution cube reaches a common beam before any spectral
    # reduction (the reference's beam-sameness guard)
    if target_beam is None and _has_beams(cube):
        target_beam = cube.common_beam()
    if target_beam is not None:
        cube = cube.convolve_to(target_beam)

    if snr_threshold is not None:
        noise = _noise(cube, noise_estimate)
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


def _noise(cube, noise_estimate):
    if noise_estimate is None:
        return float(cube.mad_std().value)
    return float(noise_estimate.to_value(cube.unit)
                 if isinstance(noise_estimate, Quantity) else noise_estimate)


def _run_sharded(cube, cmesh, snr_threshold, target_beam, target_header,
                 noise_estimate):
    """The pipeline over ``cmesh`` (the JAX package's pipeline.py:24-77):
    the spatial layout throughout, the statistics and mad_std reduced over
    the mesh, the moment maps the only values gathered."""
    from .parallel import ShardedCube
    from .lower_dimensional_structures import Projection
    sc = ShardedCube(cube, cmesh)
    if target_beam is None and _has_beams(sc):
        target_beam = sc.common_beam()
    if target_beam is not None:
        sc = sc.convolve_to(target_beam)
    if snr_threshold is not None:
        noise = _noise(sc, noise_estimate)
        sc = sc.with_mask(sc > Quantity(snr_threshold * noise, sc.unit))
    m0, m1, m2 = sc.moment_maps()
    with np.errstate(invalid="ignore"):
        linewidth = Projection(np.sqrt(np.asarray(m2.value)),
                               unit=sc.spectral_unit, wcs=m2.wcs)
    stats = sc.statistics()
    out = sc.reproject(target_header) if target_header is not None else sc
    return {"moments": (m0, m1, linewidth), "statistics": stats,
            "cube": out}
