"""Host time of ``ops.regrid.spatial_pixel_mapping`` a cube (ms): the WCS
maps of the reprojection, worked out on the host for every output
pixel."""

SPANS = ["ops.spatial_pixel_mapping"]


def read(r):
    span = r.span("ops.spatial_pixel_mapping")
    return None if span is None else span.host_ms
