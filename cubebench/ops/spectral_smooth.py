"""``SpectralCube.spectral_smooth`` with a Gaussian of
``gaussian_stddev_ch`` channels; the kernel is kept for a later
``spectral_interpolate`` whose ``smooth_kernel`` is ``"same"``."""

from cubebench.cubegen import gaussian_taps


def run(chain, state, op, draw, held):
    state["kernel"] = gaussian_taps(op["gaussian_stddev_ch"])
    state["cube"] = state["cube"].spectral_smooth(state["kernel"])
