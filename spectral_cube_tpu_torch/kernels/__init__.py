"""The port's hand-written CUDA kernels, one wrapper module each.

Every wrapper dispatches on the device of its input: a CPU tensor runs the
plain PyTorch version beside it, a CUDA tensor launches the kernel (built
from ``csrc/`` at first use) or raises.  Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from . import (moments, conv_sep, resample2, sigma_clip, smooth_interp,
               conv_reproject, pipeline_fused, banded_matmul)

__all__ = ["moments", "conv_sep", "resample2", "sigma_clip", "smooth_interp",
           "conv_reproject", "pipeline_fused", "banded_matmul", "WRAPPERS",
           "launch_counts", "reset_launch_counts"]

#: wrapper name -> wrapper
WRAPPERS = {"moments": moments.moments_planes, "conv_sep": conv_sep.conv_sep,
            "resample2": resample2.resample2,
            "resample2_filled": resample2.resample2_filled,
            "sigma_clip": sigma_clip.sigma_clip,
            "smooth_interp": smooth_interp.smooth_interp,
            "conv_reproject": conv_reproject.conv_reproject,
            "plain_strips": conv_reproject.plain_strips,
            "pipeline_fused": pipeline_fused.pipeline_fused,
            "banded_matmul": banded_matmul.banded_matmul}


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
