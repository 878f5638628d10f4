"""Lazy mask algebra over torch tensors.

Port of ``spectral_cube_tpu/masks.py`` for the single-device analysis
path: masks are expression trees whose ``include(data)`` evaluates to a
bool tensor on the data's device, so each consumer combines the predicate
with its own pass.  The moments kernel (``csrc/moments.cu``) fuses one
predicate, "finite, and at most one scalar comparison ``> >= < <=``
against a threshold" (:func:`fused_predicate`); every other mask reaches
it as an include array.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

__all__ = ["MaskBase", "InvertedMask", "CompositeMask", "BooleanArrayMask",
           "LazyMask", "LazyComparisonMask", "is_data_local", "expr_key",
           "fused_predicate", "is_broadcastable_and_smaller", "trivial_view"]


def trivial_view(view) -> bool:
    """True when ``view`` selects everything."""
    return view is None or (isinstance(view, tuple) and len(view) == 0)


def is_data_local(mask) -> bool:
    """True if the mask depends only on the data value at each voxel (no
    stored arrays, no positional thresholds)."""
    if mask is None:
        return True
    if isinstance(mask, LazyComparisonMask):
        return np.ndim(mask._comparison_value) == 0
    if isinstance(mask, LazyMask):
        return True
    if isinstance(mask, InvertedMask):
        return is_data_local(mask._mask)
    if isinstance(mask, CompositeMask):
        return is_data_local(mask._mask1) and is_data_local(mask._mask2)
    return False


def _fn_key(fn, fallback):
    try:
        hash(fn)
        return fn
    except TypeError:
        return fallback


def expr_key(mask):
    """A hashable structural key for a data-local mask expression (same
    structure and parameters => same key)."""
    if mask is None:
        return None
    if isinstance(mask, LazyComparisonMask):
        cv = mask._comparison_value
        try:
            cv_key = float(cv)
        except (TypeError, ValueError):
            cva = np.asarray(cv)
            cv_key = (cva.shape, str(cva.dtype), cva.tobytes())
        return ("cmp", _fn_key(mask._function, mask), cv_key)
    if isinstance(mask, LazyMask):
        return ("fn", _fn_key(mask._function, mask))
    if isinstance(mask, InvertedMask):
        return ("not", expr_key(mask._mask))
    if isinstance(mask, CompositeMask):
        return (mask._operation, expr_key(mask._mask1),
                expr_key(mask._mask2))
    return ("obj", mask)


#: comparison functions the moments kernel fuses, by op code
_FUSED_CMP = {torch.gt: 1, torch.greater: 1, torch.ge: 2,
              torch.greater_equal: 2, torch.lt: 3, torch.less: 3,
              torch.le: 4, torch.less_equal: 4}


def fused_predicate(mask):
    """``(op_code, threshold)`` when the kernel can evaluate ``mask`` itself
    (finiteness is always applied; op 0 means no comparison), else None.

    Fusable: no mask, ``LazyMask(torch.isfinite)``, a scalar
    ``LazyComparisonMask`` with ``> >= < <=``, and an "and" of these that
    holds at most one comparison."""
    if mask is None:
        return 0, 0.0
    if isinstance(mask, LazyMask) and mask._function is torch.isfinite:
        return 0, 0.0
    if isinstance(mask, LazyComparisonMask) \
            and np.ndim(mask._comparison_value) == 0 \
            and _FUSED_CMP.get(mask._function):
        return _FUSED_CMP[mask._function], float(mask._comparison_value)
    if isinstance(mask, CompositeMask) and mask._operation == "and":
        a, b = fused_predicate(mask._mask1), fused_predicate(mask._mask2)
        if a is not None and b is not None and (a[0] == 0 or b[0] == 0):
            return a if a[0] else b
    return None


def is_broadcastable_and_smaller(shape1, shape2):
    """True if an array of ``shape1`` can broadcast to ``shape2`` without
    expanding shape2 (reference masks.py:38-49)."""
    if len(shape1) > len(shape2):
        return False
    for a, b in zip(shape1[::-1], shape2[::-1]):
        if a not in (1, b):
            return False
    return True


def _as_bool_tensor(arr):
    if isinstance(arr, torch.Tensor):
        return arr if arr.dtype == torch.bool else arr.bool()
    return torch.from_numpy(np.array(arr, dtype=bool, copy=True))


class MaskBase(ABC):
    """Boolean include/exclude semantics over cube-shaped data."""

    @abstractmethod
    def _include(self, data=None, view=()):
        """Return the boolean *include* tensor for ``data[view]``."""

    def include(self, data=None, wcs=None, view=()):
        return self._include(data=data, view=view)

    @property
    def shape(self):
        return getattr(self, "_shape", None)

    # make `bool_array & mask` dispatch to __rand__
    __array_ufunc__ = None

    @staticmethod
    def _as_mask(other):
        if isinstance(other, MaskBase):
            return other
        if isinstance(other, torch.Tensor) and other.dtype == torch.bool:
            return BooleanArrayMask(other)
        arr = np.asarray(other)
        if arr.dtype == np.bool_:
            return BooleanArrayMask(arr)
        return NotImplemented

    def _compose(self, other, operation):
        other = self._as_mask(other)
        if other is NotImplemented:
            return NotImplemented
        return CompositeMask(self, other, operation=operation)

    def __and__(self, other):
        return self._compose(other, "and")

    def __or__(self, other):
        return self._compose(other, "or")

    def __xor__(self, other):
        return self._compose(other, "xor")

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def __invert__(self):
        return InvertedMask(self)


class InvertedMask(MaskBase):
    def __init__(self, mask):
        self._mask = mask
        self._shape = mask.shape

    def _include(self, data=None, view=()):
        return torch.logical_not(self._mask._include(data=data, view=view))


class CompositeMask(MaskBase):
    """Lazy binary and/or/xor of two masks (reference masks.py:364-455)."""

    _OPS = {"and": torch.logical_and, "or": torch.logical_or,
            "xor": torch.logical_xor}

    def __init__(self, mask1, mask2, operation="and"):
        s1, s2 = mask1.shape, mask2.shape
        if s1 is not None and s2 is not None \
                and not (is_broadcastable_and_smaller(s1, s2)
                         or is_broadcastable_and_smaller(s2, s1)):
            raise ValueError(
                f"mask shapes {s1} and {s2} are not broadcastable")
        if operation not in self._OPS:
            raise ValueError(f"unknown operation {operation!r}")
        self._mask1 = mask1
        self._mask2 = mask2
        self._operation = operation
        shapes = [m.shape for m in (mask1, mask2) if m.shape is not None]
        self._shape = tuple(np.broadcast_shapes(*shapes)) if shapes \
            else None

    def _include(self, data=None, view=()):
        i1 = self._mask1._include(data=data, view=view)
        i2 = self._mask2._include(data=data, view=view)
        if i1.device != i2.device:
            i2 = i2.to(i1.device)
        return self._OPS[self._operation](i1, i2)


class BooleanArrayMask(MaskBase):
    """A concrete boolean array, broadcastable up to cube shape.

    1-D spectral masks are treated as shape (n, 1, 1) and 2-D spatial masks
    as (1, ny, nx) (reference masks.py:457-584).  The array is kept as a
    bool tensor and moves to the data's device when evaluated against
    data."""

    def __init__(self, mask, wcs=None, shape=None, include=True):
        mask = _as_bool_tensor(mask)
        if not include:
            mask = ~mask
        self._wcs = wcs
        full_shape = shape
        if shape is None and mask.ndim == 3:
            full_shape = tuple(mask.shape)
        if full_shape is not None and tuple(mask.shape) != tuple(full_shape):
            if mask.ndim == 1:
                mask = mask.reshape(tuple(mask.shape) + (1, 1))
            elif mask.ndim == 2:
                mask = mask.reshape((1,) + tuple(mask.shape))
            if not is_broadcastable_and_smaller(tuple(mask.shape),
                                                tuple(full_shape)):
                raise ValueError(f"mask shape {tuple(mask.shape)} not "
                                 f"broadcastable to {tuple(full_shape)}")
        self._mask = mask
        self._shape = tuple(full_shape) if full_shape is not None \
            else tuple(mask.shape)

    def _include(self, data=None, view=()):
        m = self._mask
        if data is not None and m.device != data.device:
            # move the compact array, then broadcast on the data's device:
            # a broadcast view copied across would materialize the cube
            m = m.to(data.device)
        m = m.expand(self._shape)
        return m if trivial_view(view) else m[view]


class LazyMask(MaskBase):
    """mask = ``function(data)`` evaluated on demand (reference
    masks.py:586); the data flows in at evaluation time."""

    def __init__(self, function, cube=None, data=None, wcs=None, shape=None):
        self._function = function
        if cube is not None:
            data = cube._data
            wcs = getattr(cube, "_wcs", None)
        self._data = data
        self._wcs = wcs
        self._shape = shape if shape is not None else (
            tuple(data.shape) if data is not None else None)

    def _include(self, data=None, view=()):
        d = data if data is not None else self._data
        if d is None:
            raise ValueError("LazyMask has no bound data and none was given")
        return self._function(d if trivial_view(view) else d[view])


class LazyComparisonMask(MaskBase):
    """mask = ``function(data, comparison_value)``: what ``cube > 0.5*u.K``
    builds (reference spectral_cube.py:2263-2296).  A scalar threshold is
    compared in the data's dtype, as JAX's weakly typed scalars are."""

    def __init__(self, function, comparison_value, cube=None, data=None,
                 wcs=None, shape=None):
        self._function = function
        self._comparison_value = comparison_value
        if cube is not None:
            data = cube._data
            wcs = getattr(cube, "_wcs", None)
        self._data = data
        self._wcs = wcs
        self._shape = shape if shape is not None else (
            tuple(data.shape) if data is not None else None)

    def _include(self, data=None, view=()):
        d = data if data is not None else self._data
        if d is None:
            raise ValueError("mask has no bound data and none was given")
        sub = d if trivial_view(view) else d[view]
        cv = self._comparison_value
        if np.ndim(cv) > 0:
            cv = np.broadcast_to(np.asarray(cv), tuple(d.shape))
            if not trivial_view(view):
                cv = cv[view]
            cv = np.ascontiguousarray(cv)
        cv = torch.as_tensor(cv, dtype=sub.dtype, device=sub.device)
        return self._function(sub, cv)
