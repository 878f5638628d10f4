"""spectral_cube_tpu_torch: the spectral-cube engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``spectral_cube_tpu`` (JAX and Pallas on a TPU), module for
module.  This package imports neither JAX nor the JAX package.  It covers
the single-device analysis path so far: FITS read/write (3-D and
degenerate-Stokes 4-D files, BEAMS tables), masks, moments, statistics,
common-beam convolution of single-beam and varying-resolution cubes,
reprojection, the spectral-axis path, and ``run_pipeline``.  A CPU tensor runs each kernel's plain PyTorch version;
a CUDA tensor runs the kernel, built from ``csrc/`` at first use.
"""

from .units import Quantity, Unit
from .masks import (MaskBase, InvertedMask, CompositeMask, BooleanArrayMask,
                    LazyMask, LazyComparisonMask)
from .beams import Beam, Beams
from .cube import (BaseSpectralCube, SpectralCube,
                   VaryingResolutionSpectralCube)
from .lower_dimensional_structures import Projection, LowerDimensionalObject
from .wcs import WCS
from .pipeline import run_pipeline
from .interop import cube_from_arrays

__version__ = "0.1.0"

__all__ = ["BaseSpectralCube", "SpectralCube",
           "VaryingResolutionSpectralCube", "Projection", "LowerDimensionalObject",
           "MaskBase", "InvertedMask", "CompositeMask", "BooleanArrayMask",
           "LazyMask", "LazyComparisonMask", "Beam", "Beams", "WCS",
           "Quantity", "Unit", "run_pipeline", "cube_from_arrays"]
