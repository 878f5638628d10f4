"""The reference of ``spectral_interpolate`` onto every ``every``-th
channel: every spectrum convolved once more where ``smooth_kernel`` is
``"same"`` (the last ``spectral_smooth``'s taps), then sampled where the
new grid falls exactly on the old."""

from cubebench.reference.conv import normalized_conv_axis0

KIND = "spectra"


def prepare(op, ctx):
    taps = None
    if op.get("smooth_kernel") == "same":
        taps = ctx["kernel"]
    elif op.get("smooth_kernel") is not None:
        raise ValueError("the reference smooths before the regrid with the "
                         "last spectral_smooth's kernel alone")
    return taps, int(op["every"])


def nchan(n, params):
    return len(range(0, n, params[1]))


def apply(block, params, arith):
    taps, every = params
    if taps is not None:
        block = normalized_conv_axis0(block, taps, arith)
    return arith(block[::every])
