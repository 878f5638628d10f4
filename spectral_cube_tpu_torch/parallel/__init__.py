"""Multiple devices: a device mesh, sharded arrays and the sharded cube
(the port of ``spectral_cube_tpu/parallel``)."""

from .mesh import (CubeMesh, make_mesh, use_mesh, default_mesh, Mesh,
                   Sharding, ShardedArray)
from .sharded import (ShardedCube, sharded_moments, sharded_statistics,
                      sharded_mad_std, sharded_spatial_convolve,
                      sharded_convolve_per_channel_separable,
                      sharded_spectral_convolve_fft, sharded_sigma_clip,
                      sharded_spectral_interpolate,
                      sharded_smooth_interpolate, sharded_reproject,
                      sharded_spline_reproject, halo_pad)

__all__ = ["CubeMesh", "make_mesh", "use_mesh", "default_mesh", "Mesh",
           "Sharding", "ShardedArray", "ShardedCube", "sharded_moments",
           "sharded_statistics", "sharded_mad_std",
           "sharded_spatial_convolve",
           "sharded_convolve_per_channel_separable",
           "sharded_spectral_convolve_fft", "sharded_sigma_clip",
           "sharded_spectral_interpolate", "sharded_smooth_interpolate",
           "sharded_reproject", "sharded_spline_reproject", "halo_pad"]
