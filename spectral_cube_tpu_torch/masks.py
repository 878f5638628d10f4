"""Lazy mask algebra over torch tensors.

Port of ``spectral_cube_tpu/masks.py`` for the single-device analysis
path: masks are expression trees whose ``include(data)`` evaluates to a
bool tensor on the data's device, so each consumer combines the predicate
with its own pass.  The moments kernel (``csrc/moments.cu``) fuses one
predicate, "finite, and at most one scalar comparison ``> >= < <=``
against a threshold" (:func:`fused_predicate`); every other mask reaches
it as an include array.

A mask slices with its cube (``mask[view]``): data-local masks stay
data-local, so a subcube's moments still fuse the predicate; a boolean
array is cut without broadcasting it to the cube; any other mask becomes
a view of its parent.  :func:`index_view` is the one indexing helper of
the port: torch refuses negative slice steps, which the JAX package's
arrays take.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod

import numpy as np
import torch

from .units import Quantity, torch_namesake
from .ops.reductions import finite

__all__ = ["MaskBase", "InvertedMask", "CompositeMask", "BooleanArrayMask",
           "LazyMask", "LazyComparisonMask", "FunctionMask", "is_data_local",
           "expr_key", "fused_predicate", "is_finiteness_mask",
           "is_broadcastable_and_smaller",
           "dims_to_skip", "view_of_subset", "view_shape", "index_view",
           "trivial_view"]


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


def is_finiteness_mask(mask):
    """True for the mask a read gives, ``LazyMask(isfinite)``: it includes
    exactly the finite values of whatever data it is evaluated on."""
    return isinstance(mask, LazyMask) \
        and mask._function in (torch.isfinite, np.isfinite)


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


def dims_to_skip(shape1, shape2):
    """Axes of shape2 not covered by shape1 (reference masks.py:51-77)."""
    if not is_broadcastable_and_smaller(shape1, shape2):
        raise ValueError(f"cannot broadcast {shape1} to {shape2}")
    ndiff = len(shape2) - len(shape1)
    skip = list(range(ndiff))
    for i, (a, b) in enumerate(zip(shape1, shape2[ndiff:])):
        if a == 1 and b != 1:
            skip.append(i + ndiff)
    return skip


def view_shape(shape, view):
    """Shape of ``full_array[view]``, computed without allocating it."""
    if trivial_view(view):
        return tuple(shape)
    probe = np.broadcast_to(np.empty((), dtype=bool), tuple(shape))
    return np.asarray(probe[view]).shape


def view_of_subset(view, shape_full, shape_sub):
    """Restrict a cube view to the axes present in a smaller mask array
    (reference masks.py:79-99)."""
    if trivial_view(view):
        return ()
    skip = dims_to_skip(shape_sub, shape_full)
    view = _normalize_view(view, len(shape_full))
    return tuple(v for i, v in enumerate(view) if i not in skip)


def _normalize_view(view, ndim):
    if view is None:
        view = ()
    if not isinstance(view, tuple):
        view = (view,)
    return view + (slice(None),) * (ndim - len(view))


def _is_index(v):
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def index_view(x, view):
    """``x[view]``, with numpy's meaning of negative slice steps.

    torch indexing refuses a negative step, so each such slice becomes the
    positive-step slice over the same elements and that axis is flipped
    afterwards (a copy, as JAX's slicing makes).  Negative steps combine
    with integers, slices, ``None`` and ``...``; other indices pass to
    torch unchanged."""
    if trivial_view(view):
        return x
    if not isinstance(view, tuple):
        view = (view,)
    if not isinstance(x, torch.Tensor) or not any(
            isinstance(v, slice) and v.step is not None and v.step < 0
            for v in view):
        return x[view]
    if any(v is Ellipsis for v in view):
        i = next(i for i, v in enumerate(view) if v is Ellipsis)
        used = sum(1 for v in view if v is not None and v is not Ellipsis)
        view = view[:i] + (slice(None),) * (x.ndim - used) + view[i + 1:]
    pos, flip, axis, out_axis = [], [], 0, 0
    for v in view:
        if v is None:
            pos.append(v)
            out_axis += 1
        elif isinstance(v, slice):
            start, stop, step = v.indices(x.shape[axis])
            if step < 0:
                count = len(range(start, stop, step))
                if count:
                    v = slice(start + (count - 1) * step, start + 1, -step)
                    flip.append(out_axis)
                else:
                    v = slice(0, 0)
            pos.append(v)
            axis += 1
            out_axis += 1
        elif _is_index(v):
            pos.append(v)
            axis += 1
        else:
            raise IndexError("a negative slice step combines only with "
                             f"integers, slices, None and ...; got {v!r}")
    out = x[tuple(pos)]
    return out.flip(flip) if flip else out


def _compact_view(mask, view):
    """``view`` for a mask array stored with size-1 broadcast axes: on such
    an axis an integer becomes 0 and a slice the whole (length-1) axis.
    None when the view holds anything but integers and slices."""
    view = _normalize_view(view, mask.ndim)
    if len(view) != mask.ndim or not all(
            isinstance(v, slice) or _is_index(v) for v in view):
        return None
    return tuple(v if n != 1 else (0 if _is_index(v) else slice(None))
                 for v, n in zip(view, mask.shape))


def _convert_wcs_spectral(wcs, unit, velocity_convention, rest_value):
    """A mask's stored WCS with its spectral axis converted (the cube's
    with_spectral_unit math, reference masks.py:313-334)."""
    from .units import Unit
    from .wcs.spectral import (determine_ctype_from_vconv,
                               convert_spectral_axis)
    unit = Unit.parse(unit) if isinstance(unit, str) else unit
    out_ctype = determine_ctype_from_vconv(
        wcs.ctype[2], unit, velocity_convention=velocity_convention)
    return convert_spectral_axis(wcs, unit, out_ctype, rest_value=rest_value)


def _as_bool_tensor(arr):
    if isinstance(arr, torch.Tensor):
        return arr if arr.dtype == torch.bool else arr.bool()
    return torch.from_numpy(np.array(arr, dtype=bool, copy=True))


def _include_of(mask, data, view, wcs):
    """``mask._include``, handing ``wcs`` only to masks that take one."""
    if wcs is not None and mask._wants_wcs():
        return mask._include(data=data, view=view, wcs=wcs)
    return mask._include(data=data, view=view)


def _on_host_unless_tensor(inc, data):
    """``inc``, an include tensor for ``data``: kept on its device where
    ``data`` is a tensor, else copied to the host (``utils.takes_numpy``'s
    rule), so a public result numpy reads on any device."""
    return inc if isinstance(data, torch.Tensor) else inc.cpu()


def _data_tensor(data):
    """Mask data as a tensor: numpy lands where a cube's data would
    (``cube._as_tensor``: the card unless the CPU is asked for)."""
    if data is None or isinstance(data, torch.Tensor):
        return data
    from .cube import _as_tensor
    return _as_tensor(data, None)


#: what numpy raises when it is handed a tensor it cannot read (one on the
#: card)
_NUMPY_REFUSED = re.compile(r"can't convert \S+ device type tensor to numpy")


def _holds_tensor(a):
    return isinstance(a, torch.Tensor) or (
        isinstance(a, Quantity) and isinstance(a.value, torch.Tensor))


def _host_arg(a):
    """A tensor, or a ``Quantity`` of one, copied to the host."""
    if not _holds_tensor(a):
        return a
    if isinstance(a, Quantity):
        return Quantity(a.value.cpu().numpy(), a.unit)
    return a.cpu().numpy()


def _call_user_function(function, data, *args, **kwargs):
    """``function(data, ...)`` for a caller's function handed a tensor.  A
    function written for numpy cannot read a tensor (or a ``Quantity`` of
    one) on the card: when numpy refuses it, the function is called again on
    host copies, as the JAX package's functions get arrays numpy reads, and
    its result is returned as it is.  Any other error comes through
    unchanged."""
    try:
        return function(data, *args, **kwargs)
    except TypeError as exc:
        if not (_holds_tensor(data) and _NUMPY_REFUSED.search(str(exc))):
            raise
    return function(_host_arg(data), *map(_host_arg, args), **kwargs)


def bind_data(mask, data):
    """``mask`` with each data mask in it that has no bound data (a
    streamed reader's finiteness mask, a sharded cube's comparison) bound
    to ``data``, the whole array the mask covers; the mask itself where
    none lacks data."""
    if isinstance(mask, _DataMask):
        if mask._data is not None:
            return mask
        new = type(mask).__new__(type(mask))
        new.__dict__.update(mask.__dict__, _data=_data_tensor(data))
        return new
    if isinstance(mask, InvertedMask):
        inner = bind_data(mask._mask, data)
        return mask if inner is mask._mask else InvertedMask(inner)
    if isinstance(mask, CompositeMask):
        m1, m2 = bind_data(mask._mask1, data), bind_data(mask._mask2, data)
        if m1 is mask._mask1 and m2 is mask._mask2:
            return mask
        return CompositeMask(m1, m2, mask._operation)
    return mask


def unbind_data(mask, data):
    """``mask`` with each data mask in it that is bound to the tensor
    ``data`` itself, unsliced, bound to no data (it then answers
    ``include()`` when given data, as :func:`bind_data` undoes); the mask
    itself where none is.  A sharded cube made from a cube evaluates the
    mask on each shard, and a binding would keep the whole unsharded
    tensor alive beside the shards."""
    if isinstance(mask, _DataMask):
        if mask._data is not data or not trivial_view(mask._data_view):
            return mask
        new = type(mask).__new__(type(mask))
        new.__dict__.update(mask.__dict__, _data=None)
        return new
    if isinstance(mask, InvertedMask):
        inner = unbind_data(mask._mask, data)
        return mask if inner is mask._mask else InvertedMask(inner)
    if isinstance(mask, CompositeMask):
        m1 = unbind_data(mask._mask1, data)
        m2 = unbind_data(mask._mask2, data)
        if m1 is mask._mask1 and m2 is mask._mask2:
            return mask
        return CompositeMask(m1, m2, mask._operation)
    return mask


def has_unbound_data(mask) -> bool:
    """True if ``mask`` holds a data mask with no bound data, which
    answers ``include()`` only when given data."""
    if isinstance(mask, _DataMask):
        return mask._data is None
    if isinstance(mask, InvertedMask):
        return has_unbound_data(mask._mask)
    if isinstance(mask, CompositeMask):
        return has_unbound_data(mask._mask1) or \
            has_unbound_data(mask._mask2)
    return False


class MaskBase(ABC):
    """Boolean include/exclude semantics over cube-shaped data."""

    @abstractmethod
    def _include(self, data=None, view=()):
        """Return the boolean *include* tensor for ``data[view]``."""

    def include(self, data=None, wcs=None, view=()):
        """Boolean include tensor; ``wcs`` reaches the masks whose function
        takes one (FunctionMask, reference masks.py:788-792).  As
        ``utils.takes_numpy`` has it, a tensor ``data`` gives a tensor on
        its device; otherwise the result is a host tensor, which numpy
        reads wherever the mask's own data lies."""
        return _on_host_unless_tensor(_include_of(self, data, view, wcs),
                                      data)

    def exclude(self, data=None, wcs=None, view=()):
        """The include tensor negated, on the device ``include`` gives."""
        return _on_host_unless_tensor(
            torch.logical_not(_include_of(self, data, view, wcs)), data)

    def _wants_wcs(self):
        """True if this mask, or one inside it, takes a call-time wcs."""
        return False

    @property
    def shape(self):
        return getattr(self, "_shape", None)

    @property
    def ndim(self):
        """Number of dimensions (reference masks.py:257)."""
        return None if self.shape is None else len(self.shape)

    @property
    def size(self):
        """Number of elements (reference masks.py:261)."""
        return None if self.shape is None else int(np.prod(self.shape))

    @property
    def dtype(self):
        """Masks are boolean (reference masks.py:265)."""
        return np.dtype("bool")

    # -- data access -------------------------------------------------------
    def _filled(self, data, wcs=None, fill=np.nan, view=()):
        """Data where included, ``fill`` elsewhere (reference
        masks.py:197-237), in the data's dtype on its device; numpy data
        lands where a cube's data would."""
        data = _data_tensor(data)
        sub = index_view(data, view)
        inc = _include_of(self, data, view, wcs)
        return torch.where(inc.to(sub.device), sub,
                           torch.as_tensor(fill, dtype=sub.dtype,
                                           device=sub.device))

    def _flattened(self, data, wcs=None, view=()):
        """1-D tensor of the included values (reference masks.py:165-195);
        numpy data lands where a cube's data would."""
        data = _data_tensor(data)
        sub = index_view(data, view)
        inc = _include_of(self, data, view, wcs).to(sub.device)
        return sub[inc.expand(sub.shape)]

    def view(self, view=()):
        """numpy.ma compatibility: a numpy array, True where excluded
        (reference masks.py:120-132)."""
        return self.exclude(view=view).numpy()

    def quicklook(self, view, wcs=None, filename=None, use_aplpy=None,
                  aplpy_kwargs=None):
        """Plot a 2-D slice of the mask with matplotlib (reference
        masks.py:272-335); the slice is copied to the host."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        img = self.include(view=view).cpu().numpy()
        if img.ndim != 2:
            raise ValueError("view must return a 2D slice")
        fig, ax = plt.subplots()
        ax.imshow(img, origin="lower", interpolation="nearest")
        if filename:
            fig.savefig(filename)
        return ax

    def any(self, data=None, view=()):
        return bool(_include_of(self, data, view, None).any())

    # -- composition -------------------------------------------------------
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

    # -- pickling ----------------------------------------------------------
    # a torch function is stored by its name and tensors as host arrays,
    # as the JAX package stores jnp functions and device arrays
    def __getstate__(self):
        state = dict(self.__dict__)
        fn = state.get("_function")
        if fn is not None and torch_namesake(fn) is fn:
            state["_function"] = ("__torch__", fn.__name__)
        for key in ("_data", "_mask"):
            if isinstance(state.get(key), torch.Tensor):
                state[key] = ("__tensor__", state[key].cpu().numpy())
        return state

    def __setstate__(self, state):
        fn = state.get("_function")
        if isinstance(fn, tuple) and len(fn) == 2 and fn[0] == "__torch__":
            state["_function"] = getattr(torch, fn[1])
        for key in ("_data", "_mask"):
            val = state.get(key)
            if isinstance(val, tuple) and len(val) == 2 \
                    and isinstance(val[0], str) and val[0] == "__tensor__":
                state[key] = torch.from_numpy(val[1])
        self.__dict__.update(state)

    # -- structure ---------------------------------------------------------
    def __getitem__(self, view):
        return _ViewMask(self, view)

    def with_spectral_unit(self, unit, velocity_convention=None,
                           rest_value=None):
        """Copy with its stored WCS (if any) converted to the new spectral
        unit (reference masks.py:574-584, :797-803); composite, inverted
        and view masks convert the masks inside them."""
        new = type(self).__new__(type(self))   # shares data, unlike pickling
        new.__dict__.update(self.__dict__)
        wcs = getattr(new, "_wcs", None)
        if wcs is not None and wcs.naxis >= 3:
            new._wcs = _convert_wcs_spectral(wcs, unit, velocity_convention,
                                             rest_value)
        for attr in ("_mask1", "_mask2", "_mask", "_parent"):
            child = getattr(new, attr, None)
            if isinstance(child, MaskBase):
                setattr(new, attr, child.with_spectral_unit(
                    unit, velocity_convention=velocity_convention,
                    rest_value=rest_value))
        return new


class _ViewMask(MaskBase):
    """A mask restricted to a fixed view of its parent."""

    def __init__(self, parent, view):
        self._parent = parent
        self._view = view
        if parent.shape is not None:
            self._shape = view_shape(parent.shape, view)

    def _wants_wcs(self):
        return self._parent._wants_wcs()

    def _include(self, data=None, view=(), wcs=None):
        if data is not None:
            # the cube cuts its data and mask together, so ``data`` is
            # already this view of the parent's data
            return _include_of(self._parent, data, view, wcs)
        return index_view(_include_of(self._parent, None, self._view, wcs),
                          view)


class InvertedMask(MaskBase):
    def __init__(self, mask):
        self._mask = mask
        self._shape = mask.shape

    def _include(self, data=None, view=(), wcs=None):
        return torch.logical_not(_include_of(self._mask, data, view, wcs))

    def _wants_wcs(self):
        return self._mask._wants_wcs()

    def __getitem__(self, view):
        return InvertedMask(self._mask[view])


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

    def _include(self, data=None, view=(), wcs=None):
        i1 = _include_of(self._mask1, data, view, wcs)
        i2 = _include_of(self._mask2, data, view, wcs)
        if i1.device != i2.device:
            i2 = i2.to(i1.device)
        return self._OPS[self._operation](i1, i2)

    def _wants_wcs(self):
        return self._mask1._wants_wcs() or self._mask2._wants_wcs()

    def __getitem__(self, view):
        return CompositeMask(self._mask1[view], self._mask2[view],
                             operation=self._operation)


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
        return index_view(m.expand(self._shape), view)

    def __getitem__(self, view):
        """The same cut of the stored array: its size-1 broadcast axes stay
        size 1, so a spectral or spatial mask is never broadcast to the
        cube by slicing (the reference's zero-stride arrays, masks.py
        :494-505)."""
        new_shape = view_shape(self._shape, view)
        m = self._mask
        if m.ndim == len(self._shape):
            compact = _compact_view(m, view)
            if compact is not None:
                out = BooleanArrayMask.__new__(BooleanArrayMask)
                out._mask, out._shape, out._wcs = \
                    index_view(m, compact), new_shape, None
                return out
        new = index_view(m.expand(self._shape), view)
        return BooleanArrayMask(new, wcs=None, shape=tuple(new.shape))


class _DataMask(MaskBase):
    """A mask computed from data: bound data (or a cube's) is the default
    when none is given.  A sliced mask keeps its parent's bound data and
    the view, and cuts the data only when evaluated without data (the
    reference's masks.py:534-542 cut it at once)."""

    def _bind(self, function, cube, data, wcs, shape):
        # a numpy function whose name torch also has (np.isfinite,
        # np.greater, ...) becomes torch's, which the kernels fuse
        self._function = torch_namesake(function) or function
        if cube is not None:
            data = cube._data
            wcs = getattr(cube, "_wcs", None)
        self._data = _data_tensor(data)
        self._data_view = ()
        self._wcs = wcs
        self._shape = shape if shape is not None else (
            tuple(data.shape) if data is not None else None)

    def _bound(self):
        if self._data is None:
            raise ValueError(f"{type(self).__name__} has no bound data and "
                             "none was given")
        return index_view(self._data, self._data_view)

    def _sliced(self, view, **changes):
        new = type(self).__new__(type(self))
        new.__dict__.update(self.__dict__, **changes)
        if trivial_view(self._data_view):
            new._data_view = view
        elif self._data is not None:
            new._data, new._data_view = self._bound(), view
        new._shape = view_shape(self._shape, view) \
            if self._shape is not None else None
        return new


class LazyMask(_DataMask):
    """mask = ``function(data)`` evaluated on demand (reference
    masks.py:586); the data flows in at evaluation time."""

    def __init__(self, function, cube=None, data=None, wcs=None, shape=None):
        self._bind(function, cube, data, wcs, shape)

    def _include(self, data=None, view=()):
        d = _data_tensor(data) if data is not None else self._bound()
        # a finiteness mask without torch.isfinite's cube-sized temporary
        fn = finite if is_finiteness_mask(self) else self._function
        return _as_bool_tensor(_call_user_function(
            fn, index_view(d, view))).to(d.device)

    def __getitem__(self, view):
        return self._sliced(view)


class LazyComparisonMask(_DataMask):
    """mask = ``function(data, comparison_value)``: what ``cube > 0.5*u.K``
    builds (reference spectral_cube.py:2263-2296).  A scalar threshold is
    compared in the data's dtype, as JAX's weakly typed scalars are; an
    array threshold is positional and is cut with the mask (reference
    masks.py:573-584)."""

    def __init__(self, function, comparison_value, cube=None, data=None,
                 wcs=None, shape=None):
        self._bind(function, cube, data, wcs, shape)
        self._comparison_value = comparison_value

    def _include(self, data=None, view=()):
        d = _data_tensor(data) if data is not None else self._bound()
        sub = index_view(d, view)
        cv = self._comparison_value
        if np.ndim(cv) > 0:
            cv = np.broadcast_to(np.asarray(cv), tuple(d.shape))
            if not trivial_view(view):
                cv = cv[view]
            cv = torch.as_tensor(np.ascontiguousarray(cv), dtype=sub.dtype,
                                 device=sub.device)
        else:
            # rounded to the data's dtype on the host: a Python number
            # needs no copy to the device, which would wait for its queue
            cv = torch.as_tensor(cv, dtype=sub.dtype).item()
        return _as_bool_tensor(_call_user_function(
            self._function, sub, cv)).to(sub.device)

    def __getitem__(self, view):
        cv = self._comparison_value
        if np.ndim(cv) > 0 and self._shape is not None \
                and not trivial_view(view):
            cv = np.ascontiguousarray(
                np.broadcast_to(np.asarray(cv), self._shape)[view])
        return self._sliced(view, _comparison_value=cv)


class FunctionMask(MaskBase):
    """mask = ``function(data, wcs, view)`` computed at call time
    (reference masks.py:760-801).  The function may return a bool tensor
    or array; it is checked against the shape of ``data[view]``."""

    def __init__(self, function, shape=None, wcs=None):
        self._function = function
        self._shape = shape
        self._wcs = wcs

    def _include(self, data=None, view=(), wcs=None):
        result = _call_user_function(
            self._function, data, wcs if wcs is not None else self._wcs,
            view)
        if data is not None and tuple(np.shape(result)) != \
                tuple(view_shape(data.shape, view)):
            raise ValueError("Function did not return mask with correct "
                             "shape")
        result = _as_bool_tensor(result)
        return result.to(data.device) if data is not None else result

    def _wants_wcs(self):
        return True
