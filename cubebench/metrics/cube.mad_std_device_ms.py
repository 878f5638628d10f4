"""Device time of ``SpectralCube.mad_std`` a cube (ms): the union of the
device work launched inside its span, the sorts, ``nonzero`` and
``index`` of its order statistics."""

SPANS = ["cube.mad_std"]


def read(r):
    span = r.span("cube.mad_std")
    return None if span is None else span.device_ms
