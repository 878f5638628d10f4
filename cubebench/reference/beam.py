"""The beam arithmetic the convolution needs, worked out again from the
configuration's numbers: the Gaussian that takes the cube's beam to the
target beam (Wild 1970), its kernel on the pixel grid (radio_beam's
``Beam.as_kernel``: astropy's ``Gaussian2DKernel`` sampled at pixel centres
over 8 sigma of the major axis, rotated by the position angle plus 90
degrees, unit sum), the Jy/beam rescaling by the ratio of beam areas, and
the kernel as a sum of separable tap pairs."""

from __future__ import annotations

import math

import numpy as np

SIGMA_TO_FWHM = math.sqrt(8.0 * math.log(2.0))
ARCSEC = math.pi / 180.0 / 3600.0


def _abc(maj, mnr, pa):
    c, s = math.cos(pa), math.sin(pa)
    return (maj * maj * s * s + mnr * mnr * c * c,
            maj * maj * c * c + mnr * mnr * s * s,
            (maj * maj - mnr * mnr) * 2.0 * s * c)


def deconvolve(target, cube):
    """(major, minor, pa) in radians of the Gaussian that convolves the
    ``cube`` beam into the ``target`` beam, each given as (major arcsec,
    minor arcsec, pa deg)."""
    t = _abc(target[0] * ARCSEC, target[1] * ARCSEC, math.radians(target[2]))
    c = _abc(cube[0] * ARCSEC, cube[1] * ARCSEC, math.radians(cube[2]))
    a, b, g = (x - y for x, y in zip(t, c))
    s, d = a + b, math.sqrt((a - b) ** 2 + g ** 2)
    if s - d <= 0.0:
        raise ValueError("the cube's beam does not deconvolve from the "
                         "target beam")
    pa = 0.0 if abs(g) + abs(a - b) == 0 else 0.5 * math.atan2(g, b - a)
    return math.sqrt(0.5 * (s + d)), math.sqrt(0.5 * (s - d)), pa


def kernel(beam_rad, pix_rad):
    """The normalised kernel of a Gaussian beam (major, minor, pa radians)
    on pixels of ``pix_rad``."""
    maj, mnr, pa = beam_rad
    smaj = maj / pix_rad / SIGMA_TO_FWHM
    smin = mnr / pix_rad / SIGMA_TO_FWHM
    size = int(8 * smaj + 1) | 1
    y, x = np.mgrid[0:size, 0:size].astype(np.float64) - (size - 1) / 2.0
    th = pa + math.pi / 2
    xr = x * math.cos(th) + y * math.sin(th)
    yr = -x * math.sin(th) + y * math.cos(th)
    g = np.exp(-0.5 * ((xr / smaj) ** 2 + (yr / smin) ** 2))
    return g / g.sum()


def area_ratio(target, cube):
    """The Jy/beam factor of a change of beam: target area / cube area."""
    return (target[0] * target[1]) / (cube[0] * cube[1])


def separable(kern, rel=1e-12):
    """The kernel as tap pairs: (ytaps (r, ky), xtaps (r, kx)) float64 with
    kern = sum_i outer(ytaps[i], xtaps[i]), from its singular value
    decomposition, keeping every singular value above ``rel`` of the
    largest (the dropped ones lie far below float32's resolution)."""
    u, s, vt = np.linalg.svd(np.asarray(kern, np.float64))
    r = max(1, int(np.sum(s > s[0] * rel)))
    return (u[:, :r] * s[:r]).T.copy(), vt[:r].copy()


def convolution_kernel(config, pix_rad=None):
    """The configuration's convolution kernel, from its beams and pixel
    size."""
    pix = pix_rad if pix_rad is not None \
        else float(config["header"]["pix_arcsec"]) * ARCSEC
    return kernel(deconvolve(config["target_beam"], config["beam"]), pix)
