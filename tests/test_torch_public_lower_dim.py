"""Torch port, the public surface of ``lower_dimensional_structures.py``
and ``masks.py`` against the JAX package.

The inputs come from the masked cube of ``tests/torch_public.py`` in each
package: its moment-0 map (a ``Projection`` with a beam), a channel (a
``Slice``), a spectrum (a ``OneDSpectrum``), a spectrum of the
varying-resolution cube, its mask and a ``BooleanArrayMask``; each member
is held on the CPU against the JAX package and on the card outside any
guard.
"""

import numpy as np

import torch_public as tp
from torch_public import C

MODULES = ("lower_dimensional_structures.py", "masks.py")

L = "LowerDimensionalObject."
P = "Projection."
S = "BaseOneDSpectrum."
LDS = "lower_dimensional_structures.py"



def _round_trip(x, k, name):
    path = k.out(name)
    x.write(path, overwrite=True)
    return type(x).read(path)


def _lds(name):
    return lambda _, k: getattr(k.m("lower_dimensional_structures"), name)


CALLS = {
    (LDS, "LowerDimensionalObject"): C(
        None, lambda _, k: issubclass(
            _lds("Projection")(_, k),
            _lds("LowerDimensionalObject")(_, k))),
    (LDS, "Projection"): C(
        "proj", lambda p, k: _lds("Projection")(p, k)(
            p.value * 2, unit=p.unit, wcs=p.wcs, beam=p.beam)),
    (LDS, "Slice"): C(
        "slice", lambda p, k: _lds("Slice")(p, k)(
            p.value, unit=p.unit, wcs=p.wcs)),
    (LDS, "BaseOneDSpectrum"): C(
        None, lambda _, k: issubclass(_lds("OneDSpectrum")(_, k),
                                      _lds("BaseOneDSpectrum")(_, k))),
    (LDS, "OneDSpectrum"): C(
        "spectrum", lambda s, k: _lds("OneDSpectrum")(s, k)(
            s.value, unit=s.unit, wcs=s.wcs)),
    (LDS, "VaryingResolutionOneDSpectrum"): C(
        "vrspectrum", lambda s, k: _lds("VaryingResolutionOneDSpectrum")(
            s, k)(s.value, unit=s.unit, wcs=s.wcs, beams=s.beams)),
    # -- LowerDimensionalObject -------------------------------------------
    (LDS, L + "wcs"): C("proj", lambda p, k: p.wcs),
    (LDS, L + "meta"): C("proj", lambda p, k: p.meta),
    (LDS, L + "mask"): C("spectrum", lambda s, k: s.mask),
    (LDS, L + "header"): C("proj", lambda p, k: p.header),
    (LDS, L + "hdu"): C("proj", lambda p, k: p.hdu),
    (LDS, L + "hdulist"): C("spectrum", lambda s, k: list(s.hdulist)),
    (LDS, L + "write"): C(
        "proj", lambda p, k: _round_trip(p, k, "proj.fits")),
    (LDS, L + "read"): C(
        "spectrum", lambda s, k: _round_trip(s, k, "spec.fits")),
    (LDS, L + "from_hdu"): C(
        "proj", lambda p, k: type(p).from_hdu(p.hdu)),
    (LDS, L + "to"): C(
        "proj", lambda p, k: (p.to(k.u("Jy/beam km/s")),
                              p.to(k.u("mJy/beam km/s")))),
    (LDS, L + "quantity"): C("spectrum", lambda s, k: s.quantity),
    (LDS, L + "array"): C("spectrum", lambda s, k: s.array),
    (LDS, L + "round"): C("proj", lambda p, k: p.round(2)),
    (LDS, L + "with_fill_value"): C(
        "spectrum", lambda s, k: s.with_fill_value(0.0).filled_data),
    (LDS, L + "shrink_mask"): C(
        "spectrum", lambda s, k: s.shrink_mask().mask),
    # -- Projection ---------------------------------------------------------
    (LDS, P + "beam"): C("proj", lambda p, k: p.beam),
    (LDS, P + "with_beam"): C(
        "proj", lambda p, k: p.with_beam(k.inp("beam")).beam),
    (LDS, P + "convolve_to"): C(
        "proj", lambda p, k: p.convolve_to(
            k.m("beams").Beam(6 * k.u("arcsec")))),
    (LDS, P + "reproject"): C(
        "proj", lambda p, k: p.reproject(tp.shifted_header(p))),
    (LDS, P + "subimage"): C(
        "proj", lambda p, k: p.subimage(xlo=2, xhi=9, ylo=1, yhi=6)),
    (LDS, P + "quicklook"): C(
        "proj", lambda p, k: p.quicklook(filename=k.out("proj.png")),
        cpu_only="draws with matplotlib, absent on the card's machine"),
    (LDS, P + "world"): C("proj", lambda p, k: p.world[1:3, 2:5]),
    (LDS, P + "flattened_world"): C("proj", lambda p, k: p.flattened_world()),
    (LDS, P + "world_extrema"): C("proj", lambda p, k: p.world_extrema),
    (LDS, P + "longitude_extrema"): C(
        "proj", lambda p, k: p.longitude_extrema),
    (LDS, P + "latitude_extrema"): C("proj", lambda p, k: p.latitude_extrema),
    # -- spectra -----------------------------------------------------------
    (LDS, S + "filled_data"): C("spectrum", lambda s, k: s.filled_data),
    (LDS, S + "unitless_filled_data"): C(
        "spectrum", lambda s, k: s.unitless_filled_data),
    (LDS, S + "spectral_axis"): C("spectrum", lambda s, k: s.spectral_axis),
    (LDS, S + "with_spectral_unit"): C(
        "spectrum", lambda s, k: s.with_spectral_unit(
            k.u("GHz")).spectral_axis),
    (LDS, S + "spectral_interpolate"): C(
        "spectrum", lambda s, k: s.spectral_interpolate(
            s.spectral_axis[::2] + k.q(0.3, "km/s"),
            suppress_smooth_warning=True)),
    (LDS, S + "spectral_smooth"): C(
        "spectrum", lambda s, k: s.spectral_smooth(
            k.m("convolution").Gaussian1DKernel(1.0))),
    (LDS, S + "quicklook"): C(
        "spectrum", lambda s, k: s.quicklook(filename=k.out("spec.png")),
        cpu_only="draws with matplotlib, absent on the card's machine"),
    (LDS, "OneDSpectrum.beam"): C("spectrum", lambda s, k: s.beam),
    (LDS, "OneDSpectrum.with_beam"): C(
        "spectrum", lambda s, k: s.with_beam(k.inp("beam")).beam),
    (LDS, "VaryingResolutionOneDSpectrum.beams"): C(
        "vrspectrum", lambda s, k: s.beams),
    (LDS, "VaryingResolutionOneDSpectrum.unmasked_beams"): C(
        "vrspectrum", lambda s, k: s.unmasked_beams),
    (LDS, "VaryingResolutionOneDSpectrum.goodbeams_mask"): C(
        "vrspectrum", lambda s, k: s.goodbeams_mask),
    (LDS, "VaryingResolutionOneDSpectrum.with_beams"): C(
        "vrspectrum", lambda s, k: s.with_beams(
            s.beams, raise_error_jybm=False).beams),
    (LDS, "VaryingResolutionOneDSpectrum.hdulist"): C(
        "vrspectrum", lambda s, k: [h.header for h in s.hdulist]),
    # -- masks.py ----------------------------------------------------------
    ("masks.py", "trivial_view"): C(
        None, lambda _, k: [k.m("masks").trivial_view(v) for v in
                            ((), (slice(None),), (1,), Ellipsis)]),
    ("masks.py", "is_data_local"): C(
        "mask", lambda m, k: (k.m("masks").is_data_local(m),
                              k.m("masks").is_data_local(
                                  k.inp("boolmask")))),
    ("masks.py", "expr_key"): C(
        "boolmask", lambda m, k: k.m("masks").expr_key(m) is None),
    ("masks.py", "is_broadcastable_and_smaller"): C(
        None, lambda _, k: [k.m("masks").is_broadcastable_and_smaller(a, b)
                            for a, b in (((1, 8, 12), (6, 8, 12)),
                                         ((6, 8, 12), (1, 8, 12)),
                                         ((7,), (6, 8, 12)))]),
    ("masks.py", "dims_to_skip"): C(
        None, lambda _, k: k.m("masks").dims_to_skip((8, 12), (6, 8, 12))),
    ("masks.py", "view_shape"): C(
        None, lambda _, k: [k.m("masks").view_shape(tp.SHAPE, v) for v in
                            ((), (1,), (slice(1, 4), Ellipsis, 2),
                             (slice(None, None, -2),))]),
    ("masks.py", "view_of_subset"): C(
        None, lambda _, k: k.m("masks").view_of_subset(
            (slice(1, 3), 2, slice(None)), tp.SHAPE, (8, 12))),
    ("masks.py", "MaskBase"): C(
        "boolmask", lambda m, k: isinstance(m, k.m("masks").MaskBase)),
    ("masks.py", "InvertedMask"): C(
        "boolmask", lambda m, k: k.m("masks").InvertedMask(m)),
    ("masks.py", "CompositeMask"): C(
        "mask", lambda m, k: (m & k.inp("boolmask")).include(
            data=k.inp("plain").unmasked_data[:].value)),
    ("masks.py", "BooleanArrayMask"): C(
        "boolmask", lambda m, k: (m, m[1:4, ::-1, 2])),
    ("masks.py", "LazyMask"): C(
        "plain", lambda c, k: k.m("masks").LazyMask(
            np.isfinite, cube=c).include()),
    ("masks.py", "LazyComparisonMask"): C(
        "plain", lambda c, k: k.m("masks").LazyComparisonMask(
            np.greater, 0.3, data=c.unmasked_data[:].value,
            wcs=c.wcs).include()),
    ("masks.py", "FunctionMask"): C(
        "plain", lambda c, k: k.m("masks").FunctionMask(
            lambda data, wcs=None, view=(): data > 0.3).include(
                data=c.unmasked_data[:].value)),
    # -- MaskBase: the cube's lazy mask (bound to its data) and a boolean
    # array mask ----------------------------------------------------------
    ("masks.py", "MaskBase.include"): C(
        "mask", lambda m, k: (m.include(), m.include(view=(1, slice(2, 5))),
                              k.inp("boolmask").include())),
    ("masks.py", "MaskBase.exclude"): C(
        "mask", lambda m, k: (m.exclude(), m.exclude(view=(slice(None), 3)),
                              k.inp("boolmask").exclude())),
    ("masks.py", "MaskBase.view"): C(
        "mask", lambda m, k: (m.view(), m.view((2,)),
                              k.inp("boolmask").view())),
    ("masks.py", "MaskBase.any"): C(
        "mask", lambda m, k: (m.any(), k.inp("boolmask").any())),
    ("masks.py", "MaskBase.shape"): C("boolmask", lambda m, k: m.shape),
    ("masks.py", "MaskBase.ndim"): C("boolmask", lambda m, k: m.ndim),
    ("masks.py", "MaskBase.size"): C("boolmask", lambda m, k: m.size),
    ("masks.py", "MaskBase.dtype"): C("boolmask", lambda m, k: m.dtype),
    ("masks.py", "MaskBase.quicklook"): C(
        "boolmask", lambda m, k: m.quicklook(
            (2,), filename=k.out("mask.png")),
        cpu_only="draws with matplotlib, absent on the card's machine"),
    ("masks.py", "MaskBase.with_spectral_unit"): C(
        "mask", lambda m, k: m.with_spectral_unit(k.u("GHz")).include()),
}

NOT_CALLED = {}

DEVICE_RESULTS = {}

#: members that answer by design where the JAX package raises, with the
#: reason
PORT_ANSWERS = {}

tp.define_tests(globals())
