"""StokesSpectralCube: a dict of component cubes sharing WCS and shape.

Port of ``spectral_cube_tpu/stokes.py`` (reference
``stokes_spectral_cube.py``): the CASA Stokes symbols (:21-42), attribute
access to components (:153-163), a common mask layered on the components'
(:165-207), the linear/circular feed <-> IQUV basis transforms (:225-313)
as cube arithmetic on the components' device, and the cutting methods,
which each component's cube carries out.
"""

from __future__ import annotations

import numpy as np
import torch

from .cube_utils import STOKES_SYMBOLS
from .masks import BooleanArrayMask, CompositeMask, MaskBase

__all__ = ["StokesSpectralCube", "STOKES_SYMBOLS", "STOKES_TYPE"]

VALID_STOKES = list(STOKES_SYMBOLS.values())

STOKES_TYPE = {}
for sym in ("I", "Q", "U", "V"):
    STOKES_TYPE[sym] = "SKY_STOKES"
for sym in ("XX", "XY", "YX", "YY"):
    STOKES_TYPE[sym] = "FEED_LINEAR"
for sym in ("RR", "RL", "LR", "LL"):
    STOKES_TYPE[sym] = "FEED_CIRCULAR"


class StokesSpectralCube:
    """A collection of component cubes (I/Q/U/V or feed bases) with a
    common WCS and an optional common mask."""

    def __init__(self, stokes_data, mask=None, meta=None, fill_value=None):
        self._stokes_data = dict(stokes_data)
        self._meta = dict(meta) if meta else {}
        self._fill_value = fill_value

        reference = tuple(self._stokes_data.keys())[0]
        for component in self._stokes_data:
            if component not in VALID_STOKES:
                raise ValueError(
                    f"Invalid Stokes component: {component} - should be one "
                    f"of I, Q, U, V, RR, LL, RL, LR, XX, XY, YX, YY")
            if not hasattr(self._stokes_data[component], "wcs"):
                raise TypeError("stokes_data should be a dictionary of "
                                "SpectralCube objects")
            if self._stokes_data[component].shape != \
                    self._stokes_data[reference].shape:
                raise ValueError("All spectral cubes should have the same "
                                 "shape")
            w1 = self._stokes_data[reference].wcs
            w2 = self._stokes_data[component].wcs
            if not w1.check_equality(w2):
                raise ValueError("All spectral cubes in stokes_data "
                                 "should have the same WCS")
        self._wcs = self._stokes_data[reference].wcs
        self._shape = self._stokes_data[reference].shape
        if isinstance(mask, MaskBase):
            ms = getattr(mask, "shape", None)
            if ms is not None and tuple(ms) != tuple(self._shape):
                from .masks import is_broadcastable_and_smaller
                if not is_broadcastable_and_smaller(tuple(ms),
                                                    tuple(self._shape)):
                    raise ValueError(
                        "Mask shape is not broadcastable to data shape: "
                        f"{tuple(ms)} vs {tuple(self._shape)}")
            self._mask = mask
        elif mask is None:
            self._mask = None
        else:
            raise TypeError("mask should be a MaskBase instance")

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return 3

    @property
    def wcs(self):
        return self._wcs

    @property
    def mask(self):
        """The common mask, layered on top of component masks."""
        return self._mask

    @property
    def stokes_data(self):
        """The underlying component dict (reference :118-122)."""
        return self._stokes_data

    @property
    def components(self):
        return list(self._stokes_data.keys())

    @property
    def stokes_type(self):
        """SKY_STOKES / FEED_LINEAR / FEED_CIRCULAR classification
        (reference :80-90)."""
        types = {STOKES_TYPE.get(c, "OTHER") for c in self.components}
        if len(types) == 1:
            return types.pop()
        return "MIXED"

    def __getitem__(self, key):
        if isinstance(key, str):
            if key in self._stokes_data:
                cube = self._stokes_data[key]
                if self._mask is not None:
                    cube = cube.with_mask(self._mask)
                return cube
            raise KeyError(f"No Stokes component {key!r}")
        # numpy-style view: slice every component consistently (reference
        # test_stokes_spectral_cube.py:335-347)
        data = {k: self[k][key] for k in self.components}
        return StokesSpectralCube(data, meta=self._meta)

    def __getattr__(self, attribute):
        if not attribute.startswith("_") and \
                attribute in self.__dict__.get("_stokes_data", {}):
            return self[attribute]
        raise AttributeError(f"{attribute!r}")

    def __dir__(self):
        return sorted(set(super().__dir__()) | set(self._stokes_data))

    def with_mask(self, mask, inherit_mask=True):
        if isinstance(mask, (np.ndarray, torch.Tensor)):
            mask = BooleanArrayMask(mask, wcs=self._wcs, shape=self._shape)
        if self._mask is not None and inherit_mask:
            new_mask = CompositeMask(self._mask, mask, "and")
        else:
            new_mask = mask
        return self._new_with(mask=new_mask)

    def _new_with(self, stokes_data=None, mask=None):
        return StokesSpectralCube(
            stokes_data if stokes_data is not None else self._stokes_data,
            mask=mask if mask is not None else self._mask, meta=self._meta,
            fill_value=self._fill_value)

    # -- basis transforms (reference :225-313) -----------------------------
    def transform_basis(self, stokes_basis="Sky"):
        """Transform between feed bases and IQUV.

        Linear feeds:  I=(XX+YY)/2, Q=(XX-YY)/2, U=(XY+YX)/2, V=i(XY-YX)/2
        Circular feeds: I=(RR+LL)/2, Q=(RL+LR)/2, U=i(LR-RL)/2... following
        the standard conventions; complex cross-hands are kept as the
        real/imag parts when inputs are real cubes.

        Matches the reference's normalization exactly
        (stokes_spectral_cube.py:240-313, /2 in BOTH directions — note
        the upstream feed->sky->feed round-trip therefore scales by 1/2).
        As in the JAX package, the cross-hand cubes stay real where the
        reference forms complex ones (XY = (U+iV)/2, V = -1j(XY-YX)/2):
        purely-imaginary results (V from real feeds) store their
        imaginary part, and complex pairs store the recoverable
        (Re+Im, Re-Im) combination.
        """
        if stokes_basis in ("Sky", "SKY_STOKES"):
            if self.stokes_type == "FEED_LINEAR":
                XX = self._stokes_data["XX"]
                YY = self._stokes_data["YY"]
                data = {
                    "I": 0.5 * (XX + YY),
                    "Q": 0.5 * (XX - YY),
                }
                if "XY" in self._stokes_data and "YX" in self._stokes_data:
                    XY = self._stokes_data["XY"]
                    YX = self._stokes_data["YX"]
                    data["U"] = 0.5 * (XY + YX)
                    # reference: V = -1j (XY - YX)/2; real encoding keeps
                    # its imaginary part (stokes_spectral_cube.py:249)
                    data["V"] = 0.5 * (YX - XY)
                return self._new_with(stokes_data=data)
            if self.stokes_type == "FEED_CIRCULAR":
                RR = self._stokes_data["RR"]
                LL = self._stokes_data["LL"]
                data = {
                    "I": 0.5 * (RR + LL),
                    "V": 0.5 * (RR - LL),
                }
                if "RL" in self._stokes_data and "LR" in self._stokes_data:
                    RL = self._stokes_data["RL"]
                    LR = self._stokes_data["LR"]
                    data["Q"] = 0.5 * (RL + LR)
                    data["U"] = 0.5 * (LR - RL)
                return self._new_with(stokes_data=data)
            if self.stokes_type == "SKY_STOKES":
                return self
            raise ValueError(
                f"cannot transform stokes type {self.stokes_type} to Sky")
        if stokes_basis == "Linear":
            if self.stokes_type != "SKY_STOKES":
                raise ValueError("transform to Linear requires IQUV input")
            I = self._stokes_data["I"]
            Q = self._stokes_data["Q"]
            data = {"XX": 0.5 * (I + Q), "YY": 0.5 * (I - Q)}
            if "U" in self._stokes_data and "V" in self._stokes_data:
                U = self._stokes_data["U"]
                V = self._stokes_data["V"]
                # reference: XY = (U + iV)/2, YX = (U - iV)/2; the real
                # (Re-Im, Re+Im) encoding keeps the feed->sky->feed
                # round-trip at the reference's uniform x1/2 scale
                data["XY"] = 0.5 * (U - V)
                data["YX"] = 0.5 * (U + V)
            return self._new_with(stokes_data=data)
        if stokes_basis == "Circular":
            if self.stokes_type != "SKY_STOKES":
                raise ValueError("transform to Circular requires IQUV input")
            I = self._stokes_data["I"]
            V = self._stokes_data["V"]
            data = {"RR": 0.5 * (I + V), "LL": 0.5 * (I - V)}
            if "Q" in self._stokes_data and "U" in self._stokes_data:
                Q = self._stokes_data["Q"]
                U = self._stokes_data["U"]
                # reference: RL = (Q + iU)/2, LR = (Q - iU)/2; the real
                # encoding keeps Re +/- Im as the recoverable pair
                data["RL"] = 0.5 * (Q - U)
                data["LR"] = 0.5 * (Q + U)
            return self._new_with(stokes_data=data)
        raise ValueError(f"unknown basis {stokes_basis!r}")

    # -- delegated geometry (reference :314-453) ----------------------------
    def _delegate(self, method, *args, **kwargs):
        data = {k: getattr(self[k], method)(*args, **kwargs)
                for k in self.components}
        return StokesSpectralCube(data, meta=self._meta)

    def spectral_slab(self, lo, hi):
        return self._delegate("spectral_slab", lo, hi)

    def subcube(self, **kwargs):
        return self._delegate("subcube", **kwargs)

    def minimal_subcube(self):
        return self._delegate("minimal_subcube")

    def subcube_from_ds9region(self, ds9_region, allow_empty=False):
        return self._delegate("subcube_from_ds9region", ds9_region,
                              allow_empty=allow_empty)

    def subcube_from_crtfregion(self, crtf_region, allow_empty=False):
        return self._delegate("subcube_from_crtfregion", crtf_region,
                              allow_empty=allow_empty)

    def subcube_from_regions(self, region_list, allow_empty=False,
                             minimize=True):
        return self._delegate("subcube_from_regions", region_list,
                              allow_empty=allow_empty, minimize=minimize)

    def subcube_slices_from_mask(self, region_mask, spatial_only=False):
        first = self._stokes_data[self.components[0]]
        return first.subcube_slices_from_mask(region_mask,
                                              spatial_only=spatial_only)

    def subcube_from_mask(self, region_mask):
        return self._delegate("subcube_from_mask", region_mask)

    def with_spectral_unit(self, unit, **kwargs):
        return self._delegate("with_spectral_unit", unit, **kwargs)

    def __repr__(self):
        return (f"StokesSpectralCube with components "
                f"{self.components} and shape={self.shape}")

    @classmethod
    def read(cls, filename, format=None, hdu=0, **kwargs):
        from .io import read_stokes_cube
        return read_stokes_cube(filename, format=format, hdu=hdu, **kwargs)

    def write(self, filename, overwrite=False, format=None):
        from .io import write_stokes_cube
        write_stokes_cube(self, filename, overwrite=overwrite, format=format)
