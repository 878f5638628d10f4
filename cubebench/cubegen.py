"""The benchmark's inputs, made from the seed: the cube on the device, its
FITS header, the beams and the per-cube draws of a mix.

Frozen copies of the generators of ``chip_smoke.py`` at commit 9f9bf87,
each naming its origin.  They are copies, not imports: the yardstick stays
as it is when the program's smoke script changes.  Its constants live in
the data: the beams and the pixel size (``chip_smoke.py:262-264``) in
``configs/*.json``, the SNR threshold, the spectral Gaussian and the clip
(``chip_smoke.py:265, 413-415``) in ``mixes/*.json``.  Host draws use
``numpy.random.default_rng``, which takes any whole seed (the originals'
``RandomState`` stops at 2**32); the device draws use one
``torch.Generator`` on the card, as the original does.
"""

from __future__ import annotations

import numpy as np

#: add_holes' draws (chip_smoke.py:1302-1312, 9f9bf87)
HOLES = 40
HOLE_LEN = (3, 13)


def host_rng(seed, stream):
    """A numpy generator for one named use of ``seed`` (``stream`` a small
    whole number): the same seed gives the same draws, and the streams
    are independent of one another."""
    return np.random.default_rng([int(stream), int(seed) % 2 ** 64])


def card_cube(nchan, ny, nx, seed, dev):
    """chip_smoke.py:750-773 ``card_cube`` (9f9bf87): a float32 cube made
    on ``dev`` from ``torch.Generator(device=dev)`` seeded with ``seed``,
    a slab of channels at a time: a Gaussian line whose centre drifts
    across the field, on unit noise, NaN outside a circular primary-beam
    cutoff (31% of each plane)."""
    import torch
    f32 = torch.float32
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % 2 ** 63)
    ry = (torch.arange(ny, dtype=f32, device=dev)[:, None] - ny / 2) / ny
    rx = (torch.arange(nx, dtype=f32, device=dev)[None, :] - nx / 2) / nx
    amp = 6.0 * torch.exp(-0.5 * ((ry / 0.2) ** 2 + (rx / 0.25) ** 2))
    centre = nchan / 2 + 0.15 * nchan * rx
    cut = (ry / 0.47) ** 2 + (rx / 0.47) ** 2 > 1.0
    data = torch.empty((nchan, ny, nx), dtype=f32, device=dev)
    step = max(1, 2 ** 26 // (ny * nx))
    for c0 in range(0, nchan, step):
        blk = data[c0:c0 + step]
        torch.randn(blk.shape, generator=g, dtype=f32, device=dev, out=blk)
        c = torch.arange(c0, c0 + blk.shape[0], dtype=f32,
                         device=dev)[:, None, None]
        blk += amp * torch.exp(-0.5 * ((c - centre) / (0.02 * nchan)) ** 2)
        blk.masked_fill_(cut, float("nan"))
    return data


def add_holes(data, seed):
    """chip_smoke.py:1302-1312 ``add_holes`` (9f9bf87), on the device
    tensor in place: NaN holes inside spectra, :data:`HOLES` spaxels
    losing 3-12 consecutive channels each, inside the primary-beam
    cutoff."""
    rng = host_rng(seed, 1)
    nchan, ny, nx = data.shape
    for _ in range(HOLES):
        y = int(rng.integers(ny // 3, 2 * ny // 3))
        x = int(rng.integers(nx // 3, 2 * nx // 3))
        c = int(rng.integers(0, nchan - HOLE_LEN[1] + 1))
        data[c:c + int(rng.integers(*HOLE_LEN)), y, x] = float("nan")
    return data


def make_cube(shape, seed, dev):
    """The configuration's cube: :func:`card_cube` with :func:`add_holes`."""
    return add_holes(card_cube(*shape, seed, dev), seed)


def header_cards(config):
    """chip_smoke.py:708-724 ``synth_header`` (9f9bf87) as (key, value)
    cards, its shape, pixel size, spectral axis and beam taken from the
    configuration's file."""
    nchan, ny, nx = config["shape"]
    h = config["header"]
    pix = float(h["pix_arcsec"])
    maj, mnr, pa = config["beam"]
    return [("SIMPLE", True), ("BITPIX", -32), ("NAXIS", 3),
            ("NAXIS1", nx), ("NAXIS2", ny), ("NAXIS3", nchan),
            ("CTYPE1", "RA---SIN"), ("CRVAL1", float(h["crval1_deg"])),
            ("CUNIT1", "deg"), ("CDELT1", -pix / 3600.0),
            ("CRPIX1", nx / 2 + 0.5),
            ("CTYPE2", "DEC--SIN"), ("CRVAL2", float(h["crval2_deg"])),
            ("CUNIT2", "deg"), ("CDELT2", pix / 3600.0),
            ("CRPIX2", ny / 2 + 0.5),
            ("CTYPE3", "VRAD"), ("CRVAL3", float(h["crval3_m_s"])),
            ("CUNIT3", "m/s"), ("CDELT3", float(h["cdelt3_m_s"])),
            ("CRPIX3", 1.0), ("RESTFRQ", float(h["restfrq_hz"])),
            ("SPECSYS", "LSRK"), ("BUNIT", "Jy/beam"),
            ("BMAJ", maj / 3600.0), ("BMIN", mnr / 3600.0), ("BPA", pa)]


def shifted_cards(cards, dx, dy):
    """chip_smoke.py:819-823 ``shifted_header`` (9f9bf87) on cards: CRPIX1
    and CRPIX2 moved by (dx, dy) pixels, the target of a translation."""
    out = []
    for key, val in cards:
        if key == "CRPIX1":
            val = float(val) + dx
        elif key == "CRPIX2":
            val = float(val) + dy
        out.append((key, val))
    return out


def gaussian_taps(stddev):
    """A 1-D Gaussian of ``stddev`` samples at integer offsets, support
    8 * stddev rounded up to odd, unit sum (astropy Gaussian1DKernel,
    mode 'center'), the kernel a user hands the spectral methods."""
    size = int(8 * float(stddev) + 1) | 1
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / float(stddev)) ** 2)
    return k / k.sum()
