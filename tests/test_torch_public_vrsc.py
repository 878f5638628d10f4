"""Torch port, the public surface of ``VaryingResolutionSpectralCube`` and
``beams.py`` against the JAX package.

The cube is a masked float32 cube with NaNs and a BEAMS table of six
beams (6 x 8 x 12, 2.5" to 3.5"), read from the same FITS file by both
packages; each member is held as ``tests/torch_public.py`` says, on the
CPU against the JAX package and on the card outside any guard.
"""

import numpy as np

import torch_public as tp
from torch_public import C

MODULES = ("cube.py::VaryingResolutionSpectralCube", "beams.py")

V = "VaryingResolutionSpectralCube."


def _beam(k, major, minor=None, pa=None):
    arcsec = k.u("arcsec")
    return k.m("beams").Beam(
        major * arcsec, None if minor is None else minor * arcsec,
        None if pa is None else pa * k.u("deg"))


CALLS = {
    ("cube.py", V + "beams"): C("vrsc", lambda c, k: c.beams),
    ("cube.py", V + "unmasked_beams"): C(
        "vrsc", lambda c, k: c.unmasked_beams),
    ("cube.py", V + "goodbeams_mask"): C(
        "vrsc", lambda c, k: c.goodbeams_mask),
    ("cube.py", V + "identify_bad_beams"): C(
        "vrsc", lambda c, k: (c.identify_bad_beams(0.1),
                              c.identify_bad_beams(0.5))),
    ("cube.py", V + "mask_out_bad_beams"): C(
        "vrsc", lambda c, k: c.mask_out_bad_beams(0.1)),
    ("cube.py", V + "with_beams"): C(
        "vrsc", lambda c, k: c.with_beams(
            c.beams, raise_error_jybm=False).beams),
    ("cube.py", V + "pixels_per_beam"): C(
        "vrsc", lambda c, k: c.pixels_per_beam),
    ("cube.py", V + "average_beams"): C(
        "vrsc", lambda c, k: (c.average_beams(threshold=0.5),
                              c.average_beams(threshold=0.5, mask=None))),
    ("cube.py", V + "moment"): C(
        "vrsc", lambda c, k: (c.moment(order=0),
                              c.moment(order=1, axis=1))),
    ("cube.py", V + "apply_numpy_function"): C(
        "vrsc", lambda c, k: c.apply_numpy_function(np.nanmax, axis=0)),
    ("cube.py", V + "apply_function"): C(
        "vrsc", lambda c, k: c.apply_function(np.nanmax, axis=0)),
    ("cube.py", V + "header"): C("vrsc", lambda c, k: c.header),
    ("cube.py", V + "hdulist"): C(
        "vrsc", lambda c, k: [h.header for h in c.hdulist]),
    ("cube.py", V + "common_beam"): C("vrsc", lambda c, k: c.common_beam()),
    ("cube.py", V + "convolve_to"): C(
        "vrsc", lambda c, k: c.convolve_to(_beam(k, 6.0)), tol=1e-4),
    ("cube.py", V + "mask_channels"): C(
        "vrsc", lambda c, k: c.mask_channels([True, False] * 3).beams),
    ("cube.py", V + "spectral_interpolate"): C(
        "vrsc", lambda c, k: c.spectral_interpolate(
            c.spectral_axis[::2] + k.q(0.3, "km/s"),
            suppress_smooth_warning=True)),
    ("cube.py", V + "spectral_smooth"): C(
        "vrsc", lambda c, k: c.spectral_smooth(
            k.m("convolution").Gaussian1DKernel(1.0))),
    ("cube.py", V + "jtok_factors"): C("vrsc", lambda c, k: c.jtok_factors()),
    # -- beams.py ----------------------------------------------------------
    ("beams.py", "FWHM_TO_AREA"): C(
        None, lambda _, k: k.m("beams").FWHM_TO_AREA),
    ("beams.py", "SIGMA_TO_FWHM"): C(
        None, lambda _, k: k.m("beams").SIGMA_TO_FWHM),
    ("beams.py", "NoBeamError"): C(
        None, lambda _, k: str(k.m("beams").NoBeamError("none"))),
    ("beams.py", "BeamError"): C(
        None, lambda _, k: issubclass(k.m("beams").BeamError, ValueError)),
    ("beams.py", "BeamUnitsError"): C(
        None, lambda _, k: issubclass(k.m("beams").BeamUnitsError,
                                      k.m("beams").BeamError)),
    ("beams.py", "Beam"): C(
        None, lambda _, k: (_beam(k, 3.0), _beam(k, 4.0, 2.0, 30.0))),
    ("beams.py", "Beams"): C(
        None, lambda _, k: k.m("beams").Beams(
            major=np.array([1.0, 2.0, 3.0]) * k.u("arcsec"),
            minor=np.array([1.0, 1.5, 2.0]) * k.u("arcsec"),
            pa=np.array([0.0, 10.0, 20.0]) * k.u("deg"))),
    ("beams.py", "beams_to_bintable"): C(
        "beams", lambda b, k: k.m("beams").beams_to_bintable(b)),
    ("beams.py", "commonbeam"): C(
        "beams", lambda b, k: k.m("beams").commonbeam(b)),
    ("beams.py", "Beam.make"): C(
        None, lambda _, k: k.m("beams").Beam.make(3 * k.u("arcsec"))),
    ("beams.py", "Beam.from_header"): C(
        "header", lambda h, k: k.m("beams").Beam.from_header(h)),
    ("beams.py", "Beam.from_fits_keywords"): C(
        None, lambda _, k: k.m("beams").Beam.from_fits_keywords(
            BMAJ=1e-3, BMIN=5e-4, BPA=20.0)),
    ("beams.py", "Beam.from_fits_header"): C(
        "header", lambda h, k: k.m("beams").Beam.from_fits_header(h)),
    ("beams.py", "Beam.major"): C("beam", lambda b, k: b.major),
    ("beams.py", "Beam.minor"): C("beam", lambda b, k: b.minor),
    ("beams.py", "Beam.pa"): C("beam", lambda b, k: b.pa),
    ("beams.py", "Beam.sr"): C("beam", lambda b, k: b.sr),
    ("beams.py", "Beam.isfinite"): C("beam", lambda b, k: b.isfinite),
    ("beams.py", "Beam.convolve"): C(
        "beam", lambda b, k: b.convolve(_beam(k, 4.0, 2.0, 30.0))),
    ("beams.py", "Beam.deconvolve"): C(
        "beam", lambda b, k: _beam(k, 6.0, 5.0, 10.0).deconvolve(b)),
    ("beams.py", "Beam.jtok"): C(
        "beam", lambda b, k: b.jtok(k.q(1.42, "GHz"))),
    ("beams.py", "Beam.jtok_equiv"): C(
        "beam", lambda b, k: k.q(2.0, "Jy/beam").to(
            k.u("K"), equivalencies=b.jtok_equiv(k.q(1.42, "GHz")))),
    ("beams.py", "Beam.as_kernel"): C(
        "beam", lambda b, k: np.asarray(b.as_kernel(
            1.0 * k.u("arcsec")))),
    ("beams.py", "Beam.as_tophat_kernel"): C(
        "beam", lambda b, k: np.asarray(b.as_tophat_kernel(
            1.0 * k.u("arcsec")))),
    ("beams.py", "Beam.gaussian_transfer"): C(
        "beam", lambda b, k: b.gaussian_transfer(
            np.fft.fftfreq(8)[:, None], np.fft.rfftfreq(12)[None, :])),
    ("beams.py", "Beam.to_header_keywords"): C(
        "beam", lambda b, k: b.to_header_keywords()),
    ("beams.py", "Beams.major"): C("beams", lambda b, k: b.major),
    ("beams.py", "Beams.minor"): C("beams", lambda b, k: b.minor),
    ("beams.py", "Beams.pa"): C("beams", lambda b, k: b.pa),
    ("beams.py", "Beams.sr"): C("beams", lambda b, k: b.sr),
    ("beams.py", "Beams.isfinite"): C("beams", lambda b, k: b.isfinite),
    ("beams.py", "Beams.common_beam"): C(
        "beams", lambda b, k: b.common_beam()),
    ("beams.py", "Beams.largest_beam"): C(
        "beams", lambda b, k: b.largest_beam()),
    ("beams.py", "Beams.smallest_beam"): C(
        "beams", lambda b, k: b.smallest_beam()),
    ("beams.py", "Beams.extrema_beams"): C(
        "beams", lambda b, k: b.extrema_beams()),
    ("beams.py", "Beams.average_beam"): C(
        "beams", lambda b, k: b.average_beam()),
    ("beams.py", "Beams.to_table_columns"): C(
        "beams", lambda b, k: b.to_table_columns()),
}

NOT_CALLED = {}

DEVICE_RESULTS = {}

#: members that answer by design where the JAX package raises, with the
#: reason
PORT_ANSWERS = {}

tp.define_tests(globals())
