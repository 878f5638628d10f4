"""The port's hand-written CUDA kernels, one wrapper module each.

Every wrapper dispatches on the device of its input: a CPU tensor runs the
plain PyTorch version beside it, a CUDA tensor launches the kernel (built
from ``csrc/`` at first use) or raises.  Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from . import moments, conv_sep, resample2, sigma_clip, smooth_interp

__all__ = ["moments", "conv_sep", "resample2", "sigma_clip", "smooth_interp",
           "WRAPPERS", "launch_counts", "reset_launch_counts"]

#: kernel name -> wrapper
WRAPPERS = {"moments": moments.moments_planes, "conv_sep": conv_sep.conv_sep,
            "resample2": resample2.resample2,
            "sigma_clip": sigma_clip.sigma_clip,
            "smooth_interp": smooth_interp.smooth_interp}


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
