"""Lower-dimensional results: 2-D projections such as moment maps.

Port of the parts of ``spectral_cube_tpu/lower_dimensional_structures.py``
the analysis path returns.  ``.value`` stays a host numpy array, as in the
JAX package, so results of the two compare like with like; a projection's
``convolve_to`` and ``reproject`` run on a device (the CUDA device unless
the caller asks for another).  Spectra and slices follow in ROADMAP.md
Queue 1 item 10.
"""

from __future__ import annotations

import warnings

import numpy as np

from .units import Quantity
from .utils import SliceWarning

__all__ = ["LowerDimensionalObject", "Projection"]


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
