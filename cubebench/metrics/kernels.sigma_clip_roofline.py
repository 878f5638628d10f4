"""Roofline share of ``SpectralCube.sigma_clip_spectrally`` (%): the
stage's least time (``roofline/sigma_clip_spectrally.py`` over
``roofline/peaks.json``) over the device time of its span."""

SPANS = ["cube.sigma_clip_spectrally"]


def read(r):
    return r.roofline_pct("cube.sigma_clip_spectrally",
                          "sigma_clip_spectrally")
