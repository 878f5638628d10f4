"""The reference of ``sigma_clip_spectrally``: each spectrum clipped as
astropy's ``sigma_clip`` does (``spectral.clip_spectra``)."""

from cubebench.reference.spectral import clip_spectra

KIND = "spectra"


def prepare(op, ctx):
    return float(op["sigma"]), int(op["maxiters"])


def nchan(n, params):
    return n


def apply(block, params, arith):
    n = block.shape[0]
    clipped = clip_spectra(block.reshape(n, -1).t(), *params)
    return clipped.t().reshape(block.shape)
