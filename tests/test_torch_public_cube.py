"""Torch port, the public surface of ``cube.py`` (``BaseSpectralCube``,
``SpectralCube`` and the module's names) against the JAX package.

Each member is called on a masked float32 cube with NaNs (6 x 8 x 12, one
beam, read from the same FITS file by both packages): on the CPU against
the JAX package's call (class, unit, shape, NaN pattern, values within
the entry's tolerance, or the same exception class), and on the card
outside any guard against the port's CPU call, numpy reading every array
leaf (``tests/torch_public.py``).  ``chip_smoke.py``'s batteries phase
runs the ``cuda`` cases (``-m cuda``).
"""

import numpy as np
from scipy import ndimage

import torch_public as tp
from torch_public import C, Needs

MODULES = ("cube.py",)

B = "BaseSpectralCube."


def _reductions(name, **kw):
    return C("cube", lambda c, k: tuple(
        getattr(c, name)(axis=axis, **kw) for axis in (None, 0, 1, (1, 2))))


def _kernel(k, name, *args):
    return getattr(k.m("convolution"), name)(*args)



def _written(c, k, name, **kw):
    path = k.out(name)
    c.write(path, **kw)
    return k.P.SpectralCube.read(path, **k.devkw)


def _array_cube(k):
    data = np.arange(np.prod(tp.SHAPE), dtype=np.float32).reshape(tp.SHAPE)
    return k.P.SpectralCube(data=data, wcs=k.inp("plain").wcs, **k.devkw)


CALLS = {
    ("cube.py", "BaseSpectralCube"): C(
        None, lambda _, k: issubclass(k.P.SpectralCube,
                                      k.m("cube").BaseSpectralCube)),
    ("cube.py", "SpectralCube"): C(None, lambda _, k: _array_cube(k)),
    ("cube.py", "VaryingResolutionSpectralCube"): C(
        None, lambda _, k: k.m("cube").VaryingResolutionSpectralCube(
            data=np.ones(tp.SHAPE, np.float32), wcs=k.inp("plain").wcs,
            beams=k.inp("beams"), **k.devkw)),
    ("cube.py", "SIGMA2FWHM"): C(None, lambda _, k: k.m("cube").SIGMA2FWHM),
    ("cube.py", "slice_syntax"): C(
        "cube", lambda c, k: k.m("cube").slice_syntax(
            lambda self, view: self.unmasked_data[view]).fget(c)[1:3, 2]),
    # -- metadata ---------------------------------------------------------
    ("cube.py", B + "shape"): C("cube", lambda c, k: c.shape),
    ("cube.py", B + "ndim"): C("cube", lambda c, k: c.ndim),
    ("cube.py", B + "size"): C("cube", lambda c, k: c.size),
    ("cube.py", B + "dtype"): C("cube", lambda c, k: str(c.dtype)),
    ("cube.py", B + "unit"): C("cube", lambda c, k: str(c.unit)),
    ("cube.py", B + "wcs"): C("cube", lambda c, k: c.wcs),
    ("cube.py", B + "mask"): C("cube", lambda c, k: c.mask),
    ("cube.py", B + "meta"): C("cube", lambda c, k: c.meta),
    ("cube.py", B + "fill_value"): C("cube", lambda c, k: c.fill_value),
    ("cube.py", B + "velocity_convention"): C(
        "cube", lambda c, k: str(c.velocity_convention)),
    ("cube.py", B + "base"): C("cube", lambda c, k: c.base),
    ("cube.py", B + "header"): C("cube", lambda c, k: c.header),
    ("cube.py", B + "hdu"): C("cube", lambda c, k: c.hdu),
    ("cube.py", B + "hdulist"): C("cube", lambda c, k: list(c.hdulist)),
    ("cube.py", B + "spectral_unit"): C(
        "cube", lambda c, k: str(c.spectral_unit)),
    ("cube.py", B + "spectral_axis"): C("cube", lambda c, k: c.spectral_axis),
    ("cube.py", B + "spectral_extrema"): C(
        "cube", lambda c, k: c.spectral_extrema),
    ("cube.py", B + "spatial_coordinate_map"): C(
        "cube", lambda c, k: c.spatial_coordinate_map),
    ("cube.py", B + "world_extrema"): C("cube", lambda c, k: c.world_extrema),
    ("cube.py", B + "longitude_extrema"): C(
        "cube", lambda c, k: c.longitude_extrema),
    ("cube.py", B + "latitude_extrema"): C(
        "cube", lambda c, k: c.latitude_extrema),
    ("cube.py", B + "velocity"): C("cube", lambda c, k: c.velocity),
    ("cube.py", B + "unitless"): C("cube", lambda c, k: c.unitless),
    # -- data access ------------------------------------------------------
    ("cube.py", B + "filled_data"): C(
        "cube", lambda c, k: (c.filled_data[:], c.filled_data[2, 1:4],
                              c.filled_data[::-1, 3])),
    ("cube.py", B + "unitless_filled_data"): C(
        "cube", lambda c, k: (c.unitless_filled_data[:],
                              c.unitless_filled_data[1, :, 2])),
    ("cube.py", B + "unmasked_data"): C(
        "cube", lambda c, k: (c.unmasked_data[:], c.unmasked_data[:, 2, 3])),
    ("cube.py", B + "filled"): C(
        "cube", lambda c, k: (c.filled(), c.filled(fill_value=0.0))),
    ("cube.py", B + "flattened"): C(
        "cube", lambda c, k: (c.flattened(), c.flattened(slice=(2,)))),
    ("cube.py", B + "flattened_world"): C(
        "cube", lambda c, k: c.flattened_world()),
    ("cube.py", B + "get_mask_array"): C(
        "cube", lambda c, k: c.get_mask_array()),
    ("cube.py", B + "world"): C(
        "cube", lambda c, k: (c.world[:], c.world[2, 1:3, 4])),
    ("cube.py", B + "world_spines"): C("cube", lambda c, k: c.world_spines()),
    ("cube.py", B + "chunked"): C(
        "cube", lambda c, k: list(c.chunked(chunksize=100))),
    ("cube.py", B + "closest_spectral_channel"): C(
        "cube", lambda c, k: c.closest_spectral_channel(
            k.q(-316.0, "km/s"))),
    # -- I/O --------------------------------------------------------------
    ("cube.py", B + "write"): C(
        "cube", lambda c, k: _written(c, k, "w.fits", overwrite=True)),
    ("cube.py", B + "read"): C(
        None, lambda _, k: k.P.SpectralCube.read(k.path("cube"),
                                                 **k.devkw)),
    ("cube.py", B + "checkpoint"): C("cube", lambda c, k: c.checkpoint()),
    # -- edits ------------------------------------------------------------
    ("cube.py", B + "with_mask"): C(
        "cube", lambda c, k: (c.with_mask(k.inp("boolmask")),
                              c.with_mask(k.inp("boolmask"),
                                          inherit_mask=False))),
    ("cube.py", B + "with_fill_value"): C(
        "cube", lambda c, k: c.with_fill_value(0.0).filled_data[:]),
    ("cube.py", B + "mask_channels"): C(
        "cube", lambda c, k: c.mask_channels([True, False] * 3)),
    ("cube.py", B + "sigma_clip"): C("cube", lambda c, k: c.sigma_clip(1.5)),
    ("cube.py", B + "with_spectral_unit"): C(
        "cube", lambda c, k: (
            c.with_spectral_unit(k.u("GHz")).spectral_axis,
            c.with_spectral_unit(k.u("m/s"), velocity_convention="optical")
            .spectral_axis)),
    ("cube.py", B + "unmasked_copy"): C(
        "cube", lambda c, k: c.unmasked_copy()),
    ("cube.py", B + "to"): C(
        "cube", lambda c, k: (c.to(k.u("K")), c.to(k.u("mJy/beam")))),
    ("cube.py", B + "apply_everywhere"): C(
        "cube", lambda c, k: c.apply_everywhere(np.abs)),
    # -- cuts -------------------------------------------------------------
    ("cube.py", B + "spectral_slab"): C(
        "cube", lambda c, k: c.spectral_slab(k.q(-320.0, "km/s"),
                                             k.q(-316.0, "km/s"))),
    ("cube.py", B + "subcube"): C(
        "cube", lambda c, k: c.subcube(xlo=2, xhi=9, ylo=1, yhi=6, zlo=1,
                                       zhi=5)),
    ("cube.py", B + "subcube_slices_from_mask"): C(
        "cube", lambda c, k: c.subcube_slices_from_mask(k.inp("boolmask"))),
    ("cube.py", B + "minimal_subcube"): C(
        "cube", lambda c, k: (c.minimal_subcube(),
                              c.minimal_subcube(spatial_only=True))),
    ("cube.py", B + "subcube_from_mask"): C(
        "cube", lambda c, k: c.subcube_from_mask(k.inp("boolmask"))),
    ("cube.py", B + "subcube_from_ds9region"): C(
        "cube", lambda c, k: c.subcube_from_ds9region(tp.DS9)),
    ("cube.py", B + "subcube_from_crtfregion"): C(
        "cube", lambda c, k: c.subcube_from_crtfregion(tp.CRTF)),
    ("cube.py", B + "subcube_from_regions"): C(
        "cube", lambda c, k: c.subcube_from_regions(
            [k.m("region").parse_ds9_region(tp.DS9)[0]])),
    # -- reductions and moments -------------------------------------------
    ("cube.py", B + "sum"): _reductions("sum"),
    ("cube.py", B + "mean"): _reductions("mean"),
    ("cube.py", B + "std"): _reductions("std"),
    ("cube.py", B + "mad_std"): _reductions("mad_std"),
    ("cube.py", B + "max"): _reductions("max"),
    ("cube.py", B + "min"): _reductions("min"),
    ("cube.py", B + "median"): _reductions("median"),
    ("cube.py", B + "percentile"): C(
        "cube", lambda c, k: tuple(c.percentile(25, axis=axis)
                                   for axis in (None, 0, (1, 2)))),
    ("cube.py", B + "argmax"): _reductions("argmax"),
    ("cube.py", B + "argmin"): _reductions("argmin"),
    ("cube.py", B + "argmax_world"): C(
        "cube", lambda c, k: (c.argmax_world(axis=0),)),
    ("cube.py", B + "argmin_world"): C(
        "cube", lambda c, k: (c.argmin_world(axis=0),)),
    ("cube.py", B + "statistics"): C("cube", lambda c, k: c.statistics()),
    ("cube.py", B + "moment"): C(
        "cube", lambda c, k: (c.moment(order=1), c.moment(order=2, axis=1),
                              c.moment(order=0, axis=2))),
    ("cube.py", B + "moment0"): C(
        "cube", lambda c, k: (c.moment0(), c.moment0(axis=1))),
    ("cube.py", B + "moment1"): C("cube", lambda c, k: c.moment1()),
    ("cube.py", B + "moment2"): C("cube", lambda c, k: c.moment2()),
    ("cube.py", B + "linewidth_sigma"): C(
        "cube", lambda c, k: c.linewidth_sigma()),
    ("cube.py", B + "linewidth_fwhm"): C(
        "cube", lambda c, k: c.linewidth_fwhm()),
    # -- apply functions ---------------------------------------------------
    ("cube.py", B + "apply_function_parallel_spectral"): C(
        "cube", lambda c, k: c.apply_function_parallel_spectral(np.abs)),
    ("cube.py", B + "apply_function_parallel_spatial"): C(
        "cube", lambda c, k: c.apply_function_parallel_spatial(np.abs)),
    ("cube.py", B + "apply_function"): C(
        "cube", lambda c, k: (c.apply_function(np.nanmax, axis=0),
                              c.apply_function(np.nanmax, axis=0,
                                               projection=True))),
    ("cube.py", B + "apply_numpy_function"): C(
        "cube", lambda c, k: (c.apply_numpy_function(np.nanmax),
                              c.apply_numpy_function(np.nanmax, axis=0))),
    # -- smoothing, filters, resampling ------------------------------------
    ("cube.py", B + "spectral_smooth"): C(
        "cube", lambda c, k: c.spectral_smooth(
            _kernel(k, "Gaussian1DKernel", 1.0))),
    ("cube.py", B + "spectral_smooth_median"): C(
        "cube", lambda c, k: c.spectral_smooth_median(3)),
    ("cube.py", B + "spectral_filter"): C(
        "cube", lambda c, k: c.spectral_filter(
            3, filter=ndimage.maximum_filter)),
    ("cube.py", B + "spatial_smooth"): C(
        "cube", lambda c, k: c.spatial_smooth(
            _kernel(k, "Gaussian2DKernel", 1.0), raise_error_jybm=False)),
    ("cube.py", B + "spatial_smooth_median"): C(
        "cube", lambda c, k: c.spatial_smooth_median(
            3, raise_error_jybm=False)),
    ("cube.py", B + "spatial_filter"): C(
        "cube", lambda c, k: c.spatial_filter(
            [3, 3], filter=ndimage.maximum_filter, raise_error_jybm=False)),
    ("cube.py", B + "sigma_clip_spectrally"): C(
        "cube", lambda c, k: c.sigma_clip_spectrally(1.5)),
    ("cube.py", B + "check_jybeam_smoothing"): C(
        "cube", lambda c, k: c.check_jybeam_smoothing()),
    ("cube.py", B + "spectral_interpolate"): C(
        "cube", lambda c, k: c.spectral_interpolate(
            c.spectral_axis[::2] + k.q(0.3, "km/s"))),
    ("cube.py", B + "downsample_axis"): C(
        "cube", lambda c, k: (c.downsample_axis(2, axis=0),
                              c.downsample_axis(3, axis=2))),
    ("cube.py", B + "reproject"): C(
        "cube", lambda c, k: c.reproject(tp.shifted_header(c))),
    # -- chunks, schedulers, meshes ----------------------------------------
    ("cube.py", B + "rechunk"): C("cube", lambda c, k: c.rechunk()),
    ("cube.py", B + "use_dask_scheduler"): C(
        "cube", lambda c, k: c.use_dask_scheduler("threads")),
    ("cube.py", B + "display_dask_array"): C(
        "cube", lambda c, k: c.display_dask_array()),
    ("cube.py", B + "to_sharded"): C(
        "cube", lambda c, k: c.to_sharded(k.mesh())),
    ("cube.py", B + "plot_channel_maps"): C(
        "cube", lambda c, k: len(c.plot_channel_maps(
            2, 2, [0, 1, 2, 3], output_file=k.out("maps.png"))),
        cpu_only="draws with matplotlib, absent on the card's machine"),
    ("cube.py", B + "find_lines"): C(
        "cube", lambda c, k: c.find_lines(chemical_name="CO")),
    # -- SpectralCube ------------------------------------------------------
    ("cube.py", "SpectralCube.beam"): C("cube", lambda c, k: c.beam),
    ("cube.py", "SpectralCube.with_beam"): C(
        "cube", lambda c, k: c.with_beam(k.inp("beam")).beam),
    ("cube.py", "SpectralCube.pixels_per_beam"): C(
        "cube", lambda c, k: c.pixels_per_beam),
    ("cube.py", "SpectralCube.header"): C("cube", lambda c, k: c.header),
    ("cube.py", "SpectralCube.convolve_to"): C(
        "cube", lambda c, k: c.convolve_to(
            k.m("beams").Beam(6 * k.u("arcsec")))),
}

NOT_CALLED = {
    ("cube.py", B + "to_yt"): Needs("yt", "the yt bridge"),
    ("cube.py", B + "to_glue"): Needs("glue", "opens a glue session"),
    ("cube.py", B + "to_pvextractor"): Needs(
        "pvextractor", "opens the PV extractor's viewer"),
    ("cube.py", B + "to_ds9"): Needs("pyds9", "sends the cube to a ds9 "
                                              "viewer"),
}

#: members that hand out a device tensor by design, with the reason
DEVICE_RESULTS = {
    ("cube.py", B + "base"):
        "the cube's stored data itself, not a copy: a host copy would cost "
        "a whole cube on every read (9 GiB at 2304x1024x1024); its host "
        "form is unmasked_data[:]",
}

#: members that answer by design where the JAX package raises, with the
#: reason
PORT_ANSWERS = {}

tp.define_tests(globals())
