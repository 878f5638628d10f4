"""Lower-dimensional results: 2-D projections and channel slices, and
1-D spectra.

Port of ``spectral_cube_tpu/lower_dimensional_structures.py``.  ``.value``
stays a host numpy array, as in the JAX package, so results of the two
compare like with like; a mask taken from a cube is evaluated on the
host copy of the values.  A projection's ``convolve_to`` and
``reproject`` run on a device (the CUDA device unless the caller asks for
another), and so does a spectrum's ``spectral_smooth``; a spectrum's
``spectral_interpolate`` runs on the host, as the JAX package's does.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import units as u
from .units import Quantity, Unit
from .beams import Beam, Beams
from .utils import SliceWarning, BeamWarning, cached
from .wcs import WCS, convert_spectral_axis, determine_ctype_from_vconv

__all__ = ["LowerDimensionalObject", "Projection", "Slice", "OneDSpectrum",
           "VaryingResolutionOneDSpectrum"]


def _host_include(mask, value, view=()):
    """A mask's include array for ``value[view]`` (host values) as a numpy
    array: the mask is evaluated on a host tensor of the values, wherever
    the cube it came from lives."""
    inc = mask.include(data=torch.as_tensor(np.asarray(value)), view=view)
    return np.asarray(inc.cpu())


class LowerDimensionalObject(Quantity):
    """A Quantity with wcs/meta/mask/header attached."""

    def __init__(self, value, unit=None, wcs=None, meta=None, mask=None,
                 header=None, beam=None, copy=True):
        if isinstance(value, Quantity) and unit is None:
            unit = value.unit
            value = value.value
        value = np.array(value, copy=True) if copy else np.asarray(value)
        super().__init__(value, unit if unit is not None else "")
        self._wcs = wcs
        self._meta = dict(meta) if meta else {}
        if isinstance(mask, np.ndarray):
            # a raw boolean array is accepted like the reference
            # (lower_dimensional_structures.py:767-778 wraps it)
            from .masks import BooleanArrayMask
            mask = BooleanArrayMask(mask.astype(bool), wcs,
                                    shape=value.shape)
        self._mask = mask
        self._header = header
        self._beam = beam

    @property
    def wcs(self):
        return self._wcs

    @property
    def meta(self):
        return self._meta

    @property
    def mask(self):
        # LDOs always expose a mask: an unmasked object synthesizes the
        # all-True array mask the reference attaches at construction
        # (lower_dimensional_structures.py:222-228 _initial_set_mask)
        if self._mask is None:
            from .masks import BooleanArrayMask
            return BooleanArrayMask(np.ones(self.shape, dtype=bool),
                                    self._wcs, shape=self.shape)
        return self._mask

    @property
    def header(self):
        from .io.fits_low import Header, fold_meta_into_header
        h = Header(self._header) if self._header is not None else Header()
        wcsheader = self._wcs.to_header() if self._wcs is not None else {}
        # meta folds in before the WCS copy so WCS cards win on collision
        # (reference base_class.py:75-96 — LDOs share the cube's mixin)
        fold_meta_into_header(h, self._meta, wcsheader)
        if self._wcs is not None:
            h.update(wcsheader)
        h["NAXIS"] = self.ndim
        for i, n in enumerate(self.shape[::-1]):
            h[f"NAXIS{i + 1}"] = int(n)
        if self.unit is not None:
            h["BUNIT"] = self.unit.to_string()
        if self._beam is not None:
            h.update(self._beam.to_header_keywords())
        return h

    @property
    def hdu(self):
        from .io.fits_low import HDU
        if self.wcs is None:
            raise ValueError("Cannot make an HDU without a WCS")
        return HDU(data=np.asarray(self.value), header=self.header)

    def write(self, filename, overwrite=False):
        import os
        if os.path.exists(filename) and not overwrite:
            raise OSError(f"{filename} exists; use overwrite=True")
        from .io.fits_low import write_fits
        write_fits(filename, getattr(self, "hdulist", [self.hdu]))

    @classmethod
    def from_hdu(cls, hdu):
        """Build from an HDU or a list of HDUs (the JAX package's
        lower_dimensional_structures.py:102-128): a list's first image
        with a shape is used, and a 1-D image beside a BEAMS table makes
        a :class:`VaryingResolutionOneDSpectrum`."""
        if isinstance(hdu, (list, tuple)):
            from .io.fits import _find_beam_table
            beam_table = _find_beam_table(hdu)
            image = next((h for h in hdu
                          if getattr(h, "is_image", False) and h.shape),
                         None)
            if image is None:
                raise IOError("no image HDU found in the HDU list")
            if beam_table is not None and len(image.shape) == 1:
                from .cube import _beams_from_bintable
                return VaryingResolutionOneDSpectrum(
                    image.data, unit=u.parse_bunit(
                        image.header.get("BUNIT", "")),
                    wcs=WCS(header=image.header),
                    meta={"header": image.header},
                    beams=_beams_from_bintable(beam_table))
            hdu = image
        return cls(hdu.data, unit=u.parse_bunit(hdu.header.get("BUNIT", "")),
                   wcs=WCS(header=hdu.header), meta={"header": hdu.header},
                   beam=Beam.from_header(hdu.header))

    @classmethod
    def read(cls, filename, **kwargs):
        """Read a FITS file through :meth:`from_hdu` (the whole HDU list, so
        that a BEAMS table upgrades the class)."""
        from .io.fits_low import read_fits
        hdus = read_fits(str(filename))
        if not any(getattr(h, "is_image", False) and h.shape for h in hdus):
            raise IOError(f"no image HDU found in {filename}")
        return cls.from_hdu(hdus)

    def to(self, unit, equivalencies=(), freq=None):
        """Brightness-unit-aware conversion (reference LDO.to at
        lower_dimensional_structures.py:157-192)."""
        from .cube_utils import bunit_converters
        unit = Unit.parse(unit) if isinstance(unit, str) else unit
        if freq is None and not hasattr(self, "with_spectral_unit"):
            # 2-D plane: fall back to the rest frequency recorded in the
            # header (reference lower_dimensional_structures.py:174-176)
            hdr = self.header
            for key in ("RESTFRQ", "RESTFREQ"):
                if hdr is not None and key in hdr:
                    freq = Quantity(float(hdr[key]), "Hz")
                    break
        factors = bunit_converters(self, unit, equivalencies=equivalencies,
                                   freq=freq)
        factor = factors if factors.size > 1 else float(factors[0])
        return self._new_with(self.value * factor, unit=unit)

    def _new_with(self, value, unit=None, wcs=None, mask=None, beam=None):
        return type(self)(value,
                          unit=unit if unit is not None else self.unit,
                          wcs=wcs if wcs is not None else self._wcs,
                          meta=self._meta,
                          mask=mask if mask is not None else self._mask,
                          header=self._header,
                          beam=beam if beam is not None else self._beam)

    def _wrap_arith(self, result):
        """Arithmetic preserves the WCS/meta/mask/beam (reference
        regression #265, test_projection.py:93-185): same-shaped Quantity
        results re-wrap as the same LDO type."""
        if isinstance(result, Quantity) \
                and not isinstance(result, LowerDimensionalObject) \
                and np.shape(result.value) == np.shape(self.value):
            return self._new_with(result.value, unit=result.unit)
        return result

    def __add__(self, other):
        return self._wrap_arith(super().__add__(other))

    def __radd__(self, other):
        # Quantity aliases __radd__ = __add__ BEFORE this class's
        # override exists, so reflected ops bypassed _wrap_arith and
        # returned bare Quantities (regression #265 shape)
        return self._wrap_arith(Quantity.__add__(self, other))

    def __rmul__(self, other):
        return self._wrap_arith(Quantity.__mul__(self, other))

    def __rtruediv__(self, other):
        return self._wrap_arith(Quantity.__rtruediv__(self, other))

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        # numpy-dispatched arithmetic (np.float64 * proj, np.add(p, q))
        # otherwise returns bare Quantities, dropping wcs/beam/meta
        out = Quantity.__array_ufunc__(self, ufunc, method, *inputs,
                                       **kwargs)
        if isinstance(out, Quantity):
            return self._wrap_arith(out)
        return out

    def __sub__(self, other):
        return self._wrap_arith(super().__sub__(other))

    def __rsub__(self, other):
        return self._wrap_arith(super().__rsub__(other))

    def __mul__(self, other):
        return self._wrap_arith(super().__mul__(other))

    def __truediv__(self, other):
        return self._wrap_arith(super().__truediv__(other))

    def __pow__(self, p):
        return self._wrap_arith(super().__pow__(p))

    def __neg__(self):
        return self._wrap_arith(super().__neg__())

    def __abs__(self):
        return self._wrap_arith(super().__abs__())

    def __getitem__(self, view):
        if (isinstance(view, tuple) and len(view) > self.ndim
                and any(isinstance(v, slice) for v in view)):
            # dimension-raising tricks like spec[:, None, None] have no
            # WCS meaning (reference lower_dimensional_structures.py:81-93)
            warnings.warn(
                f"Slice {view} cannot be used on this {self.ndim}-"
                f"dimensional array's WCS.  If this is intentional, use "
                f"the ``array`` or ``quantity`` attribute.", SliceWarning)
            return self.quantity[view]
        new_val = self.value[view]
        if np.isscalar(new_val) or new_val.ndim == 0:
            return Quantity(new_val, self.unit)
        new_wcs = None
        from .cube_utils import canon_view
        if self._wcs is not None:
            try:
                if isinstance(view, tuple) and \
                        all(isinstance(v, slice) for v in view):
                    new_wcs = self._wcs.slice(canon_view(view, self.shape),
                                              shape=self.shape)
                elif isinstance(view, slice):
                    new_wcs = self._wcs.slice(canon_view((view,),
                                                         self.shape),
                                              shape=self.shape)
            except Exception:
                new_wcs = None
        new_mask = self._mask[view] if self._mask is not None else None
        if new_wcs is None:
            return Quantity(new_val, self.unit)
        return self._new_with(new_val, wcs=new_wcs, mask=new_mask)

    @property
    def quantity(self):
        return Quantity(self.value, self.unit)

    @property
    def array(self):
        """Bare ndarray view (reference
        lower_dimensional_structures.py:137-142)."""
        return np.asarray(self.value)

    @property
    def hdulist(self):
        return [self.hdu]

    def round(self, decimals=0):
        """Round, preserving type/WCS/mask/fill (reference
        test_projection.test_1d_slice_round)."""
        return self._new_with(np.round(np.asarray(self.value), decimals))

    @property
    def _fill_value(self):
        return getattr(self, "fill_value", np.nan)

    def with_fill_value(self, fill_value):
        new = self._new_with(self.value)
        new.fill_value = fill_value
        return new

    def shrink_mask(self):
        """Drop the mask when it excludes nothing (matplotlib display hack;
        reference lower_dimensional_structures.py:207-215)."""
        m = self._mask
        if m is not None and _host_include(m, self.value).all():
            self._mask = None
        return self

    def __repr__(self):
        return (f"<{type(self).__name__} {self.value.shape} "
                f"unit={self.unit}>")


class Projection(LowerDimensionalObject):
    """A 2-D celestial image with optional beam (reference
    lower_dimensional_structures.py:247-577)."""

    def __init__(self, value, unit=None, wcs=None, meta=None, mask=None,
                 header=None, beam=None, copy=True):
        super().__init__(value, unit=unit, wcs=wcs, meta=meta, mask=mask,
                         header=header, beam=beam, copy=copy)
        if self.ndim != 2:
            raise ValueError("Projection must be 2-dimensional")
        if beam is None and meta and "beam" in self.meta:
            self._beam = self.meta["beam"]

    @property
    def beam(self):
        if self._beam is None:
            raise ValueError("No beam is defined for this Projection.")
        return self._beam

    def with_beam(self, beam):
        return self._new_with(self.value, beam=beam)

    def convolve_to(self, beam, convolve=None, device=None, **kwargs):
        """Convolve to a new beam on ``device`` (the FFT route, the JAX
        package's lower_dimensional_structures.py:318-328); Jy/beam values
        scale by the beam-area ratio (reference
        lower_dimensional_structures.py:450-494)."""
        from .ops.convolve import convolve_image_to_beam
        out, factor = convolve_image_to_beam(
            np.asarray(self.value, dtype=float), self.beam, beam, self._wcs,
            self.unit, device=device)
        return self._new_with(out * factor, beam=beam)

    def reproject(self, header, order="bilinear", device=None):
        """Reproject onto the celestial WCS of ``header`` on ``device``
        (``ops/regrid.reproject_image``)."""
        from .ops.regrid import reproject_image
        out, new_wcs = reproject_image(np.asarray(self.value, dtype=float),
                                       self._wcs, header, order=order,
                                       device=device)
        return Projection(out.cpu().numpy(), unit=self.unit, wcs=new_wcs,
                          meta=self._meta, beam=self._beam)

    def subimage(self, xlo="min", xhi="max", ylo="min", yhi="max"):
        """Extract a sub-image by pixel or world bounds (reference
        Projection.subimage at lower_dimensional_structures.py:540-565)."""
        from .cube import _world_to_pixel_range
        from .wcs import WCSCelestialError
        if self._wcs is None or not self._wcs.has_celestial:
            raise WCSCelestialError(
                "WCS does not contain two spatial axes.")
        ny, nx = self.shape
        xlo, xhi = _world_to_pixel_range(self._wcs, 0, xlo, xhi, nx,
                                         n_other=ny)
        ylo, yhi = _world_to_pixel_range(self._wcs, 1, ylo, yhi, ny,
                                         n_other=nx)
        view = (slice(ylo, yhi), slice(xlo, xhi))
        return self[view]

    def quicklook(self, filename=None, use_aplpy=None, aplpy_kwargs=None,
                  **kwargs):
        """Plot the image with matplotlib (reference
        lower_dimensional_structures.py:397-440; the aplpy flags are
        accepted for API compatibility, and matplotlib draws)."""
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        im = ax.imshow(np.asarray(self.value), origin="lower", **kwargs)
        fig.colorbar(im, ax=ax, label=str(self.unit))
        if filename:
            fig.savefig(filename)
        return ax

    def _world_planes(self, view=()):
        """(lat, lon) planes for a view — pix2world runs only over the
        viewed pixels, not the whole plane."""
        ny, nx = self.shape
        yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
        from .masks import trivial_view
        if not trivial_view(view):
            yy, xx = yy[view], xx[view]
        cel = self._wcs.celestial
        lon, lat = cel.pix2world(xx.ravel(), yy.ravel())
        return (np.asarray(lat).reshape(yy.shape),
                np.asarray(lon).reshape(xx.shape), cel)

    @property
    def world(self):
        """``plane.world[view]`` -> (lat, lon) Quantity planes, matching
        the cube mixin's slice syntax (reference SpatialCoordMixinClass
        on 2-D LDOs, base_class.py:179-241)."""
        def get(view):
            lat, lon, cel = self._world_planes(view)
            return (Quantity(lat, cel.cunit[1]),
                    Quantity(lon, cel.cunit[0]))

        class _Indexer:
            def __getitem__(_self, view):
                return get(view)
        return _Indexer()

    def flattened_world(self, view=()):
        lat, lon, cel = self._world_planes(view)
        return [Quantity(lat.ravel(), cel.cunit[1]),
                Quantity(lon.ravel(), cel.cunit[0])]

    @property
    @cached
    def world_extrema(self):
        """[[lon_min, lon_max], [lat_min, lat_max]] in the longitude
        CUNIT (cached: the full-plane transform runs once); a
        different-unit latitude axis converts to it."""
        lat, lon, cel = self._world_planes()
        lon_u = cel.cunit[0]
        if cel.cunit[1] != lon_u:
            lat = Quantity(lat, cel.cunit[1]).to_value(lon_u)
        return Quantity(np.array(
            [[float(lon.min()), float(lon.max())],
             [float(lat.min()), float(lat.max())]]), lon_u)

    @property
    def longitude_extrema(self):
        return self.world_extrema[0]

    @property
    def latitude_extrema(self):
        return self.world_extrema[1]


class Slice(Projection):
    """A single channel map (reference class at
    lower_dimensional_structures.py:578)."""


class BaseOneDSpectrum(LowerDimensionalObject):
    """A 1-D spectrum with a spectral WCS.

    Like the reference (BaseOneDSpectrum mixes in
    MaskableArrayMixinClass, lower_dimensional_structures.py:582) this
    exposes the mask-filled access path: ``filled_data[:]``,
    ``unitless_filled_data[:]``."""

    def __init__(self, value, unit=None, wcs=None, meta=None, mask=None,
                 header=None, beam=None, spectral_unit=None, copy=True):
        super().__init__(value, unit=unit, wcs=wcs, meta=meta, mask=mask,
                         header=header, beam=beam, copy=copy)
        if self.ndim != 1:
            raise ValueError("OneDSpectrum must be 1-dimensional")
        self._spectral_unit = spectral_unit

    def _new_with(self, value, unit=None, wcs=None, mask=None, beam=None):
        out = type(self)(value,
                         unit=unit if unit is not None else self.unit,
                         wcs=wcs if wcs is not None else self._wcs,
                         meta=self._meta,
                         mask=mask if mask is not None else self._mask,
                         header=self._header,
                         beam=beam if beam is not None
                         else getattr(self, "_beam", None),
                         spectral_unit=self._spectral_unit)
        # the display spectral unit survives to()/smooth/arithmetic (the
        # base _new_with dropped it, reverting spectral_axis to the
        # WCS-native unit), and so does the beam
        return out

    def _get_filled_data(self, view=(), fill=None):
        data = np.asarray(self.value)
        if fill is None:
            fill = getattr(self, "fill_value", np.nan)
        from .masks import trivial_view
        trivial = trivial_view(view)
        if self._mask is None:
            return data if trivial else data[view]
        inc = _host_include(self._mask, data, view)
        sub = data if trivial else data[view]
        return np.where(inc, sub, fill)

    @property
    def filled_data(self):
        """``spec.filled_data[:]`` — mask applied, fill elsewhere
        (reference base_class.py:419-450 slice syntax)."""
        outer = self

        class _Indexer:
            def __getitem__(_self, view):
                return Quantity(outer._get_filled_data(view=view),
                                outer.unit)
        return _Indexer()

    @property
    def unitless_filled_data(self):
        outer = self

        class _Indexer:
            def __getitem__(_self, view):
                return outer._get_filled_data(view=view)
        return _Indexer()

    @property
    def spectral_axis(self) -> Quantity:
        """World coordinates of each channel."""
        vals = self._wcs.spectral_axis_values(len(self.value))
        unit = self._wcs.spectral_unit
        if self._spectral_unit is not None and \
                self._spectral_unit != unit:
            return Quantity(vals, unit).to(self._spectral_unit)
        return Quantity(vals, unit)

    def with_spectral_unit(self, unit, velocity_convention=None,
                           rest_value=None):
        unit = Unit.parse(unit) if isinstance(unit, str) else unit
        out_ctype = determine_ctype_from_vconv(
            self._wcs.ctype[self._wcs.spec], unit,
            velocity_convention=velocity_convention)
        new_wcs = convert_spectral_axis(self._wcs, unit, out_ctype,
                                        rest_value=rest_value)
        new = self._new_with(self.value, wcs=new_wcs)
        new._spectral_unit = unit
        return new

    def spectral_interpolate(self, spectral_grid,
                             suppress_smooth_warning=False,
                             fill_value=None):
        """Linear interpolation onto ``spectral_grid`` on the host (the JAX
        package's lower_dimensional_structures.py:514-551); the mask
        follows as the cube path's does.  Per-channel beams survive only
        a grid of the same length, and are dropped with a BeamWarning
        otherwise."""
        from .ops.interpolate import interp_spectrum
        from .masks import BooleanArrayMask
        grid = spectral_grid.to_value(self.spectral_axis.unit) \
            if isinstance(spectral_grid, Quantity) \
            else np.asarray(spectral_grid)
        inaxis = np.asarray(self.spectral_axis.value, dtype=float)
        include = _host_include(self._mask, self.value) \
            if self._mask is not None else None
        newval, new_wcs, new_include = interp_spectrum(
            np.asarray(self.value, dtype=float), inaxis, grid, self._wcs,
            suppress_smooth_warning=suppress_smooth_warning,
            fill_value=fill_value, include=include)
        new_mask = BooleanArrayMask(new_include, wcs=new_wcs,
                                    shape=newval.shape) \
            if new_include is not None else None
        kw = {}
        beams = getattr(self, "_beams", None)
        if beams is not None:
            if len(beams) == len(newval):
                kw["beams"] = beams
                gbm = getattr(self, "_goodbeams_mask", None)
                if gbm is not None and len(gbm) == len(newval):
                    kw["goodbeams_mask"] = gbm
            else:
                warnings.warn("spectral_interpolate onto a different-"
                              "length grid drops the per-channel beams",
                              BeamWarning)
        out = type(self)(newval, unit=self.unit, wcs=new_wcs,
                         meta=self._meta, mask=new_mask,
                         header=self._header, beam=self._beam, **kw)
        out._spectral_unit = self._spectral_unit
        return out

    def quicklook(self, filename=None, drawstyle="steps-mid", **kwargs):
        """Plot the spectrum into the current matplotlib figure
        (reference lower_dimensional_structures.py:719-738); kwargs pass
        to ``pyplot.plot``."""
        from matplotlib import pyplot
        ax = pyplot.gca()
        ax.plot(np.asarray(self.spectral_axis.value),
                np.asarray(self._get_filled_data()),
                drawstyle=drawstyle, **kwargs)
        ax.set_xlabel(str(self.spectral_axis.unit))
        ax.set_ylabel(str(self.unit))
        if filename is not None:
            pyplot.gcf().savefig(filename)
        return ax

    def spectral_smooth(self, kernel, device=None, **kwargs):
        """Convolve with a 1-D kernel, NaNs interpolated over
        (``ops/smoothing.convolve1d_nan``), on ``device``: the CUDA device
        unless the caller asks for another."""
        from .ops.smoothing import convolve1d_nan
        from .cube import _as_tensor, _kernel_array
        x = _as_tensor(np.asarray(self.value, dtype=np.float32), device)
        out = convolve1d_nan(x, _kernel_array(kernel))
        return self._new_with(out.cpu().numpy())

    def __getitem__(self, view):
        out = super().__getitem__(view)
        if isinstance(out, BaseOneDSpectrum):
            out._spectral_unit = self._spectral_unit
        return out


class OneDSpectrum(BaseOneDSpectrum):
    """1-D spectrum with a single beam (reference
    lower_dimensional_structures.py:1004-1052)."""

    @property
    def beam(self):
        if self._beam is None:
            raise ValueError("No beam is defined for this OneDSpectrum.")
        return self._beam

    def with_beam(self, beam):
        return self._new_with(self.value, beam=beam)


class VaryingResolutionOneDSpectrum(BaseOneDSpectrum):
    """1-D spectrum with per-channel beams (reference
    lower_dimensional_structures.py:1055-1141)."""

    def __init__(self, value, unit=None, wcs=None, meta=None, mask=None,
                 header=None, beams=None, spectral_unit=None, beam=None,
                 copy=True, goodbeams_mask=None):
        super().__init__(value, unit=unit, wcs=wcs, meta=meta, mask=mask,
                         header=header, spectral_unit=spectral_unit,
                         copy=copy)
        if beams is not None and len(beams) != len(np.atleast_1d(self.value)):
            raise ValueError(
                "The Beams object must have the same size as the data. "
                f"Found a size of {len(beams)} and the data have a size "
                f"of {len(np.atleast_1d(self.value))} (reference "
                "base_class.py:509-512)")
        self._beams = beams
        self._goodbeams_mask = goodbeams_mask

    @property
    def goodbeams_mask(self):
        """Per-channel good-beam flags (reference
        lower_dimensional_structures.py:1089-1098); all-True when unset."""
        if self._goodbeams_mask is None:
            return np.ones(len(np.atleast_1d(self.value)), dtype=bool)
        return self._goodbeams_mask

    def with_beams(self, beams, goodbeams_mask=None,
                   raise_error_jybm=True):
        """Replace the per-channel beams (reference
        lower_dimensional_structures.py:1146-1161).  An explicit
        goodbeams_mask replaces the current one; otherwise the existing
        mask is kept when its length still matches."""
        gbm = goodbeams_mask
        if gbm is None and self._goodbeams_mask is not None \
                and len(self._goodbeams_mask) == len(beams):
            gbm = self._goodbeams_mask
        return type(self)(self.value, unit=self.unit, wcs=self._wcs,
                          meta=self._meta, mask=self._mask,
                          header=self._header, beams=beams,
                          goodbeams_mask=gbm,
                          spectral_unit=self._spectral_unit)

    @property
    def beams(self) -> Beams:
        if self._beams is None:
            raise ValueError("No beams are defined")
        if self._goodbeams_mask is not None:
            return self._beams[self._goodbeams_mask]
        return self._beams

    @property
    def unmasked_beams(self) -> Beams:
        return self._beams

    @property
    def hdulist(self):
        """Data HDU + BEAMS bintable, like the reference's VR 1-D
        hdulist (lower_dimensional_structures.py:1100-1141); write() and
        from_hdu round-trip the beams through it."""
        from .io.fits_low import BinTableHDU
        bt = BinTableHDU(columns=self._beams.to_table_columns(),
                         name="BEAMS",
                         units={"BMAJ": "arcsec", "BMIN": "arcsec",
                                "BPA": "deg"})
        bt.header["NCHAN"] = len(np.atleast_1d(self.value))
        bt.header["NPOL"] = 1
        return [self.hdu, bt]

    def _new_with(self, value, unit=None, wcs=None, mask=None, beam=None):
        beams = self._beams
        gbm = self._goodbeams_mask
        view = getattr(self, "_beams_view", None)
        if view is not None:
            if beams is not None:
                beams = beams[view]
            if gbm is not None:
                gbm = gbm[view]
        out = type(self)(value,
                         unit=unit if unit is not None else self.unit,
                         wcs=wcs if wcs is not None else self._wcs,
                         meta=self._meta,
                         mask=mask if mask is not None else self._mask,
                         header=self._header,
                         beams=beams,
                         goodbeams_mask=gbm,
                         spectral_unit=self._spectral_unit)
        return out

    def __getitem__(self, view):
        # slice the beams in lockstep with the data (the base __getitem__
        # constructs through _new_with, which picks up _beams_view; the
        # reference pre-slices via kwargs the same way,
        # lower_dimensional_structures.py:765-772)
        self._beams_view = view
        try:
            out = super().__getitem__(view)
        finally:
            self._beams_view = None
        return out
