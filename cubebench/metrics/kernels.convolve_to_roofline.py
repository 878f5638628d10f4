"""Roofline share of ``SpectralCube.convolve_to`` (%): the stage's least
time (``roofline/convolve_to.py`` over ``roofline/peaks.json``) over the
device time of its span."""

SPANS = ["cube.convolve_to"]


def read(r):
    return r.roofline_pct("cube.convolve_to", "convolve_to")
