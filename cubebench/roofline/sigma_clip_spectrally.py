"""``SpectralCube.sigma_clip_spectrally`` on the chain's regridded cube:
each voxel read once and written once (float32); the operations of a
sorted-band clip over the spectra inside the primary beam (the
configuration's cube holds values in a disc of radius 0.47 of the plane):
a sort of each spectrum (n log2 n comparisons) and one pass of the band's
mean, deviation, square, sum and two comparisons over every value, the
least the first iteration needs."""

import math


def counts(config, mix, shape):
    nchan, ny, nx = shape
    every = next(int(op["every"]) for op in mix["chain"]
                 if op["op"] == "spectral_interpolate")
    n = len(range(0, nchan, every))
    live = math.pi * 0.47 ** 2 * ny * nx
    return 2 * 4 * n * ny * nx, live * (n * math.log2(n) + 6 * n)
