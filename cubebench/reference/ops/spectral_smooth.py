"""The reference of ``spectral_smooth``: every spectrum convolved with
the Gaussian taps (``conv.normalized_conv_axis0``), which a later
``spectral_interpolate`` with ``smooth_kernel`` ``"same"`` takes again."""

from cubebench.cubegen import gaussian_taps
from cubebench.reference.conv import normalized_conv_axis0

KIND = "spectra"


def prepare(op, ctx):
    ctx["kernel"] = gaussian_taps(op["gaussian_stddev_ch"])
    return ctx["kernel"]


def nchan(n, taps):
    return n


def apply(block, taps, arith):
    return normalized_conv_axis0(block, taps, arith)
