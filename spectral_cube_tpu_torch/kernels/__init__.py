"""The port's hand-written CUDA kernels, one wrapper module each.

Every wrapper dispatches on the device of its input: a CPU tensor runs the
plain PyTorch version beside it, a CUDA tensor launches the kernel (built
from ``csrc/`` at first use) or raises.  Each wrapper counts its launches in
``<wrapper>.launches``; :data:`DEVICE_KERNELS` names the ``__global__``
kernels one such call puts on the device, so that a profiler trace can be
held against the counters (``profiling.trace_mismatches``).
"""

from . import (moments, conv_sep, resample2, sigma_clip, smooth_interp,
               conv_reproject, pipeline_fused, banded_matmul)

__all__ = ["moments", "conv_sep", "resample2", "sigma_clip", "smooth_interp",
           "conv_reproject", "pipeline_fused", "banded_matmul", "WRAPPERS",
           "DEVICE_KERNELS", "launch_counts", "reset_launch_counts"]

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


#: wrapper name -> the ``__global__`` kernels of ``csrc/`` that one call on
#: a non-empty CUDA tensor launches, once each, as patterns of their
#: demangled names in a profiler trace (``re.search``); each wrapper's
#: docstring says the same.  conv_reproject's and pipeline_fused's flag
#: pass is one kernel, ``chan_flags_kernel``.  The one exception: spectra
#: whose rows outgrow shared memory (past ~25,000 channels) launch the
#: sigma clip once per workspace chunk.
DEVICE_KERNELS = {
    "moments": (r"\bmoments_kernel<",),
    "conv_sep": (r"\bchannel_flags_kernel\b", r"\bconv_sep_kernel<"),
    "resample2": (r"\bresample2_kernel<[^>]*\bfalse>",),
    "resample2_filled": (r"\bresample2_kernel<[^>]*\btrue>",),
    "sigma_clip": (r"\bsigma_clip(_reg)?_kernel<",),
    "smooth_interp": (r"\bsmooth_interp_kernel<",),
    "conv_reproject": (r"\bchan_flags_kernel\b",
                       r"\bconv_reproject_kernel<0\b"),
    "plain_strips": (r"\bconv_reproject_kernel<1\b",),
    "pipeline_fused": (r"\bchan_flags_kernel\b",
                       r"\bconv_reproject_kernel<2\b"),
    "banded_matmul": (r"\bbanded_matmul_kernel<",),
}

