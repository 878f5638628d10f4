"""Torch port, the public surface of ``stokes.py``, ``region.py``,
``cube_utils.py`` and ``analysis_utilities.py`` against the JAX package.

The inputs are ``tests/torch_public.py``'s: a four-component Stokes cube
(4 x 6 x 8 x 12 with NaNs) and the masked cube, read from the same files
by both packages; each member is held on the CPU against the JAX package
and on the card outside any guard.
"""

import numpy as np

import torch_public as tp
from torch_public import C

MODULES = ("stokes.py", "region.py", "cube_utils.py",
           "analysis_utilities.py")

K = "StokesSpectralCube."
DS9_BOX = 'fk5; box(23.1837, 30.5765, 12", 8", 0)'


def _written(s, k):
    path = k.out("stokes_w.fits")
    s.write(path, overwrite=True)
    return k.m("stokes").StokesSpectralCube.read(path, **k.devkw)


def _region(k, text=tp.DS9):
    return k.m("region").parse_ds9_region(text)


def _velocity_surface(c, k):
    spec = c.spectral_axis
    plane = np.full(c.shape[1:], float(spec[3].value))
    plane[::2, ::3] = float(spec[2].value)
    return k.q(plane, spec.unit)


def _reg(name):
    return lambda _, k: getattr(k.m("region"), name)


CALLS = {
    ("stokes.py", "STOKES_SYMBOLS"): C(
        None, lambda _, k: k.m("stokes").STOKES_SYMBOLS),
    ("stokes.py", "STOKES_TYPE"): C(
        None, lambda _, k: k.m("stokes").STOKES_TYPE),
    ("stokes.py", "VALID_STOKES"): C(
        None, lambda _, k: k.m("stokes").VALID_STOKES),
    ("stokes.py", "StokesSpectralCube"): C(
        "stokes", lambda s, k: k.m("stokes").StokesSpectralCube(
            {c: s._stokes_data[c] for c in s.components})),
    ("stokes.py", K + "shape"): C("stokes", lambda s, k: s.shape),
    ("stokes.py", K + "ndim"): C("stokes", lambda s, k: s.ndim),
    ("stokes.py", K + "wcs"): C("stokes", lambda s, k: s.wcs),
    ("stokes.py", K + "mask"): C("stokes", lambda s, k: s.mask),
    ("stokes.py", K + "stokes_data"): C("stokes", lambda s, k: s.stokes_data),
    ("stokes.py", K + "components"): C("stokes", lambda s, k: s.components),
    ("stokes.py", K + "stokes_type"): C("stokes", lambda s, k: s.stokes_type),
    ("stokes.py", K + "with_mask"): C(
        "stokes", lambda s, k: s.with_mask(k.inp("boolmask"))),
    ("stokes.py", K + "transform_basis"): C(
        "stokes", lambda s, k: (s.transform_basis("Linear"),
                                s.transform_basis("Circular"))),
    ("stokes.py", K + "spectral_slab"): C(
        "stokes", lambda s, k: s.spectral_slab(k.q(-320.0, "km/s"),
                                               k.q(-316.0, "km/s"))),
    ("stokes.py", K + "subcube"): C(
        "stokes", lambda s, k: s.subcube(xlo=2, xhi=9, ylo=1, yhi=6)),
    ("stokes.py", K + "minimal_subcube"): C(
        "stokes", lambda s, k: s.minimal_subcube()),
    ("stokes.py", K + "subcube_from_ds9region"): C(
        "stokes", lambda s, k: s.subcube_from_ds9region(tp.DS9)),
    ("stokes.py", K + "subcube_from_crtfregion"): C(
        "stokes", lambda s, k: s.subcube_from_crtfregion(tp.CRTF)),
    ("stokes.py", K + "subcube_from_regions"): C(
        "stokes", lambda s, k: s.subcube_from_regions(_region(k))),
    ("stokes.py", K + "subcube_slices_from_mask"): C(
        "stokes", lambda s, k: s.subcube_slices_from_mask(
            k.inp("boolmask"))),
    ("stokes.py", K + "subcube_from_mask"): C(
        "stokes", lambda s, k: s.subcube_from_mask(k.inp("boolmask"))),
    ("stokes.py", K + "with_spectral_unit"): C(
        "stokes", lambda s, k: s.with_spectral_unit(k.u("GHz"))),
    ("stokes.py", K + "read"): C(
        None, lambda _, k: k.m("stokes").StokesSpectralCube.read(
            k.path("stokes"), **k.devkw)),
    ("stokes.py", K + "write"): C("stokes", lambda s, k: _written(s, k)),
    # -- region.py ---------------------------------------------------------
    ("region.py", "Region"): C(
        None, lambda _, k: type(_region(k)[0]).__name__),
    ("region.py", "CompositeRegion"): C(
        None, lambda _, k: type(k.m("region").parse_crtf_region(
            "box[[23.18deg, 30.57deg], [23.19deg, 30.58deg]]\n"
            "-circle[[23.1837deg, 30.5765deg], 3arcsec]")[0]).__name__),
    ("region.py", "CompositeRegion.exclude"): C(
        "cube", lambda c, k: c.subcube_from_crtfregion(
            "box[[23.18deg, 30.57deg], [23.19deg, 30.58deg]]\n"
            "-circle[[23.1837deg, 30.5765deg], 3arcsec]")),
    ("region.py", "galactic_to_fk5"): C(
        None, lambda _, k: _reg("galactic_to_fk5")(_, k)(120.0, 30.0)),
    ("region.py", "fk5_to_galactic"): C(
        None, lambda _, k: _reg("fk5_to_galactic")(_, k)(23.18, 30.57)),
    ("region.py", "ecliptic_to_fk5"): C(
        None, lambda _, k: _reg("ecliptic_to_fk5")(_, k)(40.0, 10.0)),
    ("region.py", "fk5_to_ecliptic"): C(
        None, lambda _, k: _reg("fk5_to_ecliptic")(_, k)(23.18, 30.57)),
    ("region.py", "fk4_to_fk5"): C(
        None, lambda _, k: _reg("fk4_to_fk5")(_, k)(23.18, 30.57)),
    ("region.py", "fk5_to_fk4"): C(
        None, lambda _, k: _reg("fk5_to_fk4")(_, k)(23.18, 30.57)),
    ("region.py", "supergalactic_to_galactic"): C(
        None, lambda _, k: _reg("supergalactic_to_galactic")(_, k)(
            60.0, 20.0)),
    ("region.py", "galactic_to_supergalactic"): C(
        None, lambda _, k: _reg("galactic_to_supergalactic")(_, k)(
            120.0, 30.0)),
    ("region.py", "parse_ds9_region"): C(
        None, lambda _, k: [type(r).__name__ for r in _region(k, DS9_BOX)]),
    ("region.py", "parse_crtf_region"): C(
        None, lambda _, k: [type(r).__name__ for r in
                            k.m("region").parse_crtf_region(tp.CRTF)]),
    ("region.py", "region_to_mask"): C(
        "cube", lambda c, k: k.m("region").region_to_mask(
            _region(k)[0], c.wcs, c.shape)),
    ("region.py", "subcube_from_ds9region"): C(
        "cube", lambda c, k: k.m("region").subcube_from_ds9region(
            c, DS9_BOX)),
    ("region.py", "subcube_from_crtfregion"): C(
        "cube", lambda c, k: k.m("region").subcube_from_crtfregion(
            c, tp.CRTF)),
    ("region.py", "subcube_from_regions"): C(
        "cube", lambda c, k: k.m("region").subcube_from_regions(
            c, _region(k), minimize=False)),
    # -- cube_utils.py -----------------------------------------------------
    ("cube_utils.py", "MEMORY_THRESHOLD"): C(
        None, lambda _, k: k.m("cube_utils").MEMORY_THRESHOLD),
    ("cube_utils.py", "canon_view"): C(
        None, lambda _, k: [k.m("cube_utils").canon_view(v, tp.SHAPE)
                            for v in ((), (1,), (Ellipsis, 2),
                                      (slice(1, 3), slice(None), 4))]),
    ("cube_utils.py", "orient"): C(
        "plain", lambda c, k: k.m("cube_utils").orient(
            np.asarray(c.unmasked_data[:].value), c.wcs)[0]),
    ("cube_utils.py", "split_stokes"): C(
        None, lambda _, k: k.m("cube_utils").split_stokes(
            *_stokes_array(k))),
    ("cube_utils.py", "bunit_converters"): C(
        "proj", lambda p, k: k.m("cube_utils").bunit_converters(
            p, k.u("mJy/beam km/s"))),
    ("cube_utils.py", "world_take_along_axis"): C(
        "cube", lambda c, k: k.m("cube_utils").world_take_along_axis(
            c, np.asarray(c.argmax(axis=0)), 0)),
    ("cube_utils.py", "mosaic_cubes"): C(
        "plain", lambda c, k: k.m("cube_utils").mosaic_cubes(
            [c[:, :, :7], c[:, :, 5:]])),
    ("cube_utils.py", "combine_headers"): C(
        "plain", lambda c, k: k.m("cube_utils").combine_headers(
            c[:, :, :7].header, c[:, :, 5:].header)),
    ("cube_utils.py", "largest_beam"): C(
        "beams", lambda b, k: k.m("cube_utils").largest_beam(b)),
    ("cube_utils.py", "smallest_beam"): C(
        "beams", lambda b, k: k.m("cube_utils").smallest_beam(b)),
    ("cube_utils.py", "is_huge"): C(
        "cube", lambda c, k: k.m("cube_utils").is_huge(c)),
    ("cube_utils.py", "iterator_strategy"): C(
        "cube", lambda c, k: (k.m("cube_utils").iterator_strategy(c),
                              k.m("cube_utils").iterator_strategy(c, 0))),
    ("cube_utils.py", "try_load_beam"): C(
        "header", lambda h, k: k.m("cube_utils").try_load_beam(h)),
    ("cube_utils.py", "try_load_beams"): C(
        None, lambda _, k: k.m("cube_utils").try_load_beams(
            k.m("io.fits_low").read_fits(k.path("vrsc")))),
    ("cube_utils.py", "beams_to_bintable"): C(
        "beams", lambda b, k: k.m("cube_utils").beams_to_bintable(b)),
    ("cube_utils.py", "beam_props"): C(
        "beams", lambda b, k: k.m("cube_utils").beam_props(b)),
    ("cube_utils.py", "convert_bunit"): C(
        None, lambda _, k: [str(k.m("cube_utils").convert_bunit(b))
                            for b in ("JY/BEAM", "K", "Jy/beam km/s")]),
    # -- analysis_utilities.py ----------------------------------------------
    ("analysis_utilities.py", "get_chunks"): C(
        None, lambda _, k: list(k.m("analysis_utilities").get_chunks(
            10, 3))),
    ("analysis_utilities.py", "fourier_shift"): C(
        "spectrum", lambda s, k: k.m("analysis_utilities").fourier_shift(
            np.nan_to_num(np.asarray(s.value)), 1.5)),
    ("analysis_utilities.py", "stack_spectra"): C(
        "cube", lambda c, k: k.m("analysis_utilities").stack_spectra(
            c, _velocity_surface(c, k), v0=c.spectral_axis[3],
            pad_edges=False), tol=1e-4),
    ("analysis_utilities.py", "stack_cube"): C(
        "plain", lambda c, k: k.m("analysis_utilities").stack_cube(
            c.with_spectral_unit(k.u("GHz")), linelist=[
                c.with_spectral_unit(k.u("GHz")).spectral_axis[2]],
            vmin=k.q(-2.0, "km/s"), vmax=k.q(2.0, "km/s")), tol=1e-4),
}


def _stokes_array(k):
    s = k.inp("stokes")
    data = np.stack([np.asarray(s._stokes_data[c].unmasked_data[:].value)
                     for c in s.components])
    wcs4 = k.m("io.fits_low").read_fits(k.path("stokes"))[0].header
    return data, k.m("wcs").WCS(header=wcs4)


NOT_CALLED = {}

DEVICE_RESULTS = {}

#: members that answer by design where the JAX package raises, with the
#: reason
PORT_ANSWERS = {
    ("cube_utils.py", "try_load_beams"):
        "reads the BEAMS table of its own package's read_fits, which has no "
        "astropy-style data attribute; the JAX function raises "
        "AttributeError on its own package's table (held against the JAX "
        "package on an astropy-style table by tests/test_torch_cube_utils.py"
        "::test_try_load_beams_reads_headers_hdus_and_beam_tables)",
}

tp.define_tests(globals())
