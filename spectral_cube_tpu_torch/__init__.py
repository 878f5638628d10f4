"""spectral_cube_tpu_torch: the spectral-cube engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``spectral_cube_tpu`` (JAX and Pallas on a TPU), module for
module.  This package imports neither JAX nor the JAX package.  It covers
everything the JAX package does on one device: FITS, CASA image and CLASS
.lmv read (FITS and CASA write; 3-D and 4-D Stokes files, BEAMS tables,
per-plane beams, CASA masks), masks, moments, statistics, common-beam
convolution of single-beam and varying-resolution cubes, reprojection,
the spectral-axis path, ``run_pipeline``, the cube's everyday API
(indexing and subcubes, spectral-unit and brightness-unit conversion,
arithmetic, 1-D and 2-D results, Stokes cubes), DS9 and CRTF region
subcubes, and the exporters and viewers.  A CPU tensor runs
each kernel's plain PyTorch version; a CUDA tensor runs the kernel, built
from ``csrc/`` at first use.
"""

from .units import Quantity, Unit
from .masks import (MaskBase, InvertedMask, CompositeMask, BooleanArrayMask,
                    LazyMask, LazyComparisonMask, FunctionMask)
from .beams import Beam, Beams
from .cube import (BaseSpectralCube, SpectralCube,
                   VaryingResolutionSpectralCube)
from .lower_dimensional_structures import (Projection, Slice, OneDSpectrum,
                                           VaryingResolutionOneDSpectrum,
                                           LowerDimensionalObject)
from .stokes import StokesSpectralCube

# The reference library exports dask-backed twins (its __init__.py:4); as
# in the JAX package, the names are aliases of the device-backed classes.
DaskSpectralCube = SpectralCube
DaskVaryingResolutionSpectralCube = VaryingResolutionSpectralCube
from .wcs import WCS
from .convolution import (CustomKernel, Gaussian1DKernel, Gaussian2DKernel,
                          Box1DKernel, Box2DKernel, Tophat2DKernel)
from .pipeline import run_pipeline
from .interop import cube_from_arrays

__version__ = "0.1.0"

__all__ = ["BaseSpectralCube", "SpectralCube",
           "VaryingResolutionSpectralCube", "DaskSpectralCube",
           "DaskVaryingResolutionSpectralCube", "StokesSpectralCube",
           "Projection", "Slice", "OneDSpectrum",
           "VaryingResolutionOneDSpectrum", "LowerDimensionalObject",
           "MaskBase", "InvertedMask", "CompositeMask", "BooleanArrayMask",
           "LazyMask", "LazyComparisonMask", "FunctionMask", "Beam", "Beams",
           "WCS", "Quantity", "Unit", "run_pipeline", "cube_from_arrays",
           "CustomKernel", "Gaussian1DKernel", "Gaussian2DKernel",
           "Box1DKernel", "Box2DKernel", "Tophat2DKernel"]
