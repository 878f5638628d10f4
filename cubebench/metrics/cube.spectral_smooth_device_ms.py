"""Device time of ``SpectralCube.spectral_smooth`` a cube (ms): the union
of the device work launched inside its span, its banded products and its
NaN bookkeeping."""

SPANS = ["cube.spectral_smooth"]


def read(r):
    span = r.span("cube.spectral_smooth")
    return None if span is None else span.device_ms
