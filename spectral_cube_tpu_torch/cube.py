"""The cube classes of the torch port: BaseSpectralCube, the single-beam
SpectralCube and the VaryingResolutionSpectralCube.

Port of the core of ``spectral_cube_tpu/cube.py`` for the analysis path
(read -> convolve_to -> mask -> moments + statistics -> reproject) and the
spectral-axis path (spectral/spatial smoothing and median filters,
sigma clipping, spectral interpolation, downsampling).  The data is a
torch tensor on the cube's device: the tensor's own device, else
``device=``, else the CUDA device (a host array never lands on the CPU
unless asked).  Masks are lazy expression trees evaluated on that device;
WCS, beam and unit metadata stay on the host.  On a CUDA device the
moments, statistics, convolution, reprojection, sigma clip and fused
smooth + interpolation run in the port's kernels (``kernels/``); on the
CPU in their plain PyTorch versions.

The everyday API is ported too: indexing and subcubes (a spatial cut is
copied once into a contiguous tensor, since every kernel takes contiguous
data; a channel range shares its parent's storage), ``with_spectral_unit``,
brightness-unit conversion and arithmetic (array operands are cast to the
data's dtype, as JAX keeps float32 with 64-bit mode off), argmax/argmin
and world coordinates (host float64, as in the JAX package).

The transform engine runs a user's function over every spectrum or
channel map with ``torch.func.vmap`` on the cube's device
(``apply_function_parallel_spectral`` / ``_spatial``), or on the host per
ray (``apply_function``) or on the whole filled array
(``apply_numpy_function``).  Cube-returning operations take
``save_to_tmp_dir=True``, which writes the result to a temporary store
and loads it back (``persistence.py``).

Region subcubes (``subcube_from_ds9region``, ``_crtfregion``,
``_regions``) rasterise the regions on the host in float64 (``region.py``)
and apply the result as one compact ``(1, ny, nx)`` mask on the cube's
device.  The exporters and viewers (``to_yt``, ``to_glue``, ``to_ds9``,
``to_pvextractor``, ``plot_channel_maps``, ``find_lines``) copy what they
hand over to the host; their optional packages are imported only when
called.  ``SpectralCube.read`` reads FITS files, CASA images and CLASS
.lmv cubes (``io/__init__.py``).
"""

from __future__ import annotations

import functools
import inspect
import re
import sys
import warnings

import numpy as np
import torch

from . import units as u
from .units import Quantity, Unit, UnitConversionError
from .masks import (BooleanArrayMask, LazyComparisonMask, CompositeMask,
                    LazyMask, MaskBase, is_data_local,
                    is_finiteness_mask, index_view,
                    view_shape, is_broadcastable_and_smaller,
                    _call_user_function, _is_index as _is_int)
from .beams import Beam, Beams, BeamError, NoBeamError
from .lower_dimensional_structures import (Projection, Slice, OneDSpectrum,
                                           VaryingResolutionOneDSpectrum,
                                           LowerDimensionalObject)
from .utils import (cached, warn_slow, VarianceWarning, BeamAverageWarning,
                    NonFiniteBeamsWarning, WCSMismatchWarning, SliceWarning,
                    ProgressBar)
from .wcs import convert_spectral_axis, determine_ctype_from_vconv
from .ops import reductions as _red
from .ops import moments as _mom
from .ops import convolve as _conv
from .ops import regrid as _regrid
from .ops import smoothing as _smooth
from .ops import interpolate as _interp

__all__ = ["BaseSpectralCube", "SpectralCube",
           "VaryingResolutionSpectralCube"]

SIGMA2FWHM = _mom.SIGMA2FWHM

#: Sentinel for :meth:`BaseSpectralCube._new_cube_with`: keep the current
#: mask
_INHERIT = object()


def _beams_from_columns(columns, units):
    """Beams from BEAMS-table columns (a mapping with BMAJ/BMIN/BPA),
    honoring the table's TUNITn units: AIPS writes degrees (reference
    regression #737, tests/test_io.py:139-149); unitless tables default to
    the CASA convention arcsec/arcsec/deg."""
    units = units or {}
    return Beams(
        major=Quantity(np.asarray(columns["BMAJ"], dtype=float),
                       units.get("BMAJ", "arcsec")),
        minor=Quantity(np.asarray(columns["BMIN"], dtype=float),
                       units.get("BMIN", "arcsec")),
        pa=Quantity(np.asarray(columns["BPA"], dtype=float),
                    units.get("BPA", "deg")))


def _beams_from_bintable(beam_table):
    """Beams from a FITS BEAMS bintable (the JAX package's cube.py:63-75)."""
    return _beams_from_columns(beam_table.columns,
                               getattr(beam_table, "units", None))


def default_device():
    """The device a cube lands on when no device is given: the card.
    Raises where CUDA is absent; the CPU is only ever asked for."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the CUDA device unless asked otherwise, and "
            "CUDA is not available here: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def _as_tensor(data, device):
    """Cube data as a tensor on ``device`` (default: the tensor's own
    device, else :func:`default_device`).  A numpy float64 payload becomes
    float32, as ``jnp.asarray`` stores it in the JAX package (64-bit mode
    off); a numpy array is copied, never aliased."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    arr = np.asarray(data)
    if arr.dtype.byteorder not in ("=", "|") and arr.dtype.byteorder != (
            "<" if sys.byteorder == "little" else ">"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    device = torch.device(device) if device is not None else default_device()
    if device.type == "cpu":
        return torch.from_numpy(np.array(arr, order="C", copy=True))
    with warnings.catch_warnings():
        # a read-only FITS payload is only read here, to copy it over
        warnings.filterwarnings("ignore", message="The given NumPy array "
                                "is not writable")
        return torch.as_tensor(np.ascontiguousarray(arr)).to(device)


def _kernel_array(kernel):
    """Plain float array of a convolution kernel (ndarray or object with
    ``.array``), rejecting unit-carrying kernels like the reference
    (tests/test_regrid.py:174-183)."""
    arr = getattr(kernel, "array", kernel)
    if getattr(arr, "unit", None) is not None \
            or getattr(kernel, "unit", None) is not None:
        from .units import UnitsError
        raise UnitsError("The convolution kernel should be defined "
                         "without a unit.")
    return np.asarray(arr, dtype=float)


def _check_parallel_options(parallel, num_cores):
    """Reference guard (spectral_cube.py:2965-2973): num_cores > 1 with an
    explicit ``parallel=False`` is contradictory; num_cores == 1 with
    ``parallel=True`` only warns.  ``parallel=None`` means unspecified."""
    if num_cores is None:
        return
    if parallel is False and num_cores > 1:
        raise ValueError(
            "parallel execution was not requested, but multiple cores "
            "were: these are incompatible options.  Either specify "
            "num_cores=1 or parallel=True")
    if parallel and num_cores == 1:
        warnings.warn("parallel=True was specified but num_cores=1. "
                      "The task runs as one fused kernel either way.")


def _world_to_pixel_range(wcs, axis, lo, hi, n, n_other=None):
    """Resolve mixed pixel/world bounds to a pixel slice along a celestial
    axis (reference find_spatial_pixel_index, wcs_utils.py:517-700).

    World bounds are solved by nearest-pixel search along a spine through
    the center of the *cube* (``n_other``), not through crpix: reference
    headers routinely describe a cutout of a much larger map, leaving
    crpix hundreds of pixels outside the data where projection curvature
    shifts world coordinates by whole pixels.  The resolved range is
    inclusive of both bounding pixels and insensitive to the axis
    direction (RA typically *decreases* with pixel index)."""
    if isinstance(lo, str) and lo == "min":
        lo_p = 0
    elif isinstance(lo, Quantity):
        lo_p = None
    else:
        lo_p = int(lo)
    if isinstance(hi, str) and hi == "max":
        hi_p = n
    elif isinstance(hi, Quantity):
        hi_p = None
    else:
        hi_p = int(hi)
    if lo_p is not None and hi_p is not None:
        return lo_p, hi_p
    cel = wcs.celestial
    other = 1 - axis
    probe = np.arange(n, dtype=float)
    coords = [None, None]
    coords[axis] = probe
    coords[other] = np.full(n, (n_other - 1) / 2.0 if n_other is not None
                            else cel.crpix[other] - 1.0)
    world = np.asarray(cel.pix2world(coords[0], coords[1])[axis])
    unit = cel.cunit[axis]

    def solve(q):
        val = q.to_value(unit.to_string() or "deg")
        return int(np.argmin(np.abs(world - val)))

    if lo_p is None and hi_p is None:
        pa, pb = solve(lo), solve(hi)
        return min(pa, pb), max(pa, pb) + 1
    if lo_p is None:
        lo_p = solve(lo)
    if hi_p is None:
        hi_p = solve(hi) + 1
    if lo_p > hi_p - 1:
        lo_p, hi_p = hi_p - 1, lo_p + 1
    return lo_p, hi_p


def _subcube_view(cube, xlo, xhi, ylo, yhi, zlo, zhi):
    """The slices ``cube.subcube`` cuts for pixel or world bounds, from
    the cube's WCS and shape alone."""
    nchan, ny, nx = cube.shape
    xlo, xhi = _world_to_pixel_range(cube._wcs, 0, xlo, xhi, nx, n_other=ny)
    ylo, yhi = _world_to_pixel_range(cube._wcs, 1, ylo, yhi, ny, n_other=nx)
    if isinstance(zlo, Quantity) or isinstance(zhi, Quantity):
        zl = cube.closest_spectral_channel(zlo) \
            if isinstance(zlo, Quantity) else (
                0 if zlo == "min" else int(zlo))
        zh = cube.closest_spectral_channel(zhi) + 1 \
            if isinstance(zhi, Quantity) else (
                nchan if zhi == "max" else int(zhi))
        if zl > zh:
            zl, zh = zh - 1, zl + 1
    else:
        zl = 0 if zlo == "min" else int(zlo)
        zh = nchan if zhi == "max" else int(zhi)
    return slice(zl, zh), slice(ylo, yhi), slice(xlo, xhi)


class _SliceSyntax:
    """Makes ``cube.filled_data[0:3, :, :]`` style access work (reference
    ``slice_syntax`` decorator, cube_utils.py:203-240)."""

    def __init__(self, fn):
        self.fn = fn

    def __getitem__(self, view):
        if not isinstance(view, tuple):
            view = (view,)
        return self.fn(view)

    def __iter__(self):
        raise TypeError("use slice syntax: obj.attr[...] ")


def _dask_block_info(shape):
    """A dask-style block_info dict of one block spanning ``shape`` (the
    reference's map_blocks passthrough, dask_spectral_cube.py:596-610)."""
    return {0: {
        "shape": tuple(shape),
        "num-chunks": (1,) * len(shape),
        "chunk-location": (0,) * len(shape),
        "array-location": [(0, n) for n in shape],
        "chunk-shape": tuple(shape),
    }}


def _tmp_dir_option(function):
    """The reference's ``save_to_tmp_dir=`` option of cube-returning
    operations (dask_spectral_cube.py:85-116): with True, the resulting
    cube is written to a temporary store and loaded back
    (:meth:`BaseSpectralCube.checkpoint`)."""
    @functools.wraps(function)
    def wrapper(self, *args, **kwargs):
        save = kwargs.pop("save_to_tmp_dir", False)
        out = function(self, *args, **kwargs)
        if save and isinstance(out, BaseSpectralCube):
            out = out.checkpoint()
        return out
    return wrapper


#: dask.map_blocks options that describe the output's chunk layout; the
#: transform engine has one block, so it consumes them
_DASK_LAYOUT_OPTIONS = ("drop_axis", "new_axis", "chunks", "dtype", "meta")


def _engine_kwargs(function, shape, kwargs):
    """The user's kwargs for the transform engine: the dask layout options
    dropped, and ``block_info`` added where ``function`` takes it."""
    for name in _DASK_LAYOUT_OPTIONS:
        kwargs.pop(name, None)
    try:
        params = inspect.signature(function).parameters
    except (TypeError, ValueError):
        params = {}
    if "block_info" in params:
        kwargs["block_info"] = _dask_block_info(shape)
    return kwargs


def _vmapped(function, data, in_dims, out_dims):
    """``torch.func.vmap(function)`` over ``data``, or None where the
    user's function cannot be vmapped (in-place updates, data-dependent
    shapes, numpy calls): the caller then loops on the host, as the JAX
    package does for functions JAX cannot trace (cube.py:1530-1535).  Only
    the call of the user's function is inside the ``try``; what it raises
    is arbitrary user code, so any Exception means "not vmappable", and a
    genuine fault raises again from the host loop."""
    try:
        return torch.func.vmap(function, in_dims=in_dims,
                               out_dims=out_dims)(data)
    except Exception:
        return None


def slice_syntax(f):
    @property
    def wrapper(self):
        return _SliceSyntax(lambda view: f(self, view))
    wrapper.__doc__ = f.__doc__
    return wrapper


def _broadcastable(shape1, shape2):
    return is_broadcastable_and_smaller(tuple(shape1), tuple(shape2))


def _operand(value, like):
    """A non-Python-scalar operand as a tensor of ``like``'s dtype on its
    device: with 64-bit mode off JAX computes float32 data with a float64
    array in float32, where torch would promote to float64.  Python
    scalars pass as they are (torch, like JAX, keeps the data's dtype)."""
    if isinstance(value, (int, float)):
        return value
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


_ARITH = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
          "truediv": torch.div}


class BaseSpectralCube:
    """A masked, unit- and WCS-aware [spec, lat, lon] cube on a torch
    device (the JAX package's cube.py:212)."""

    def __init__(self, data, wcs, mask=None, meta=None, fill_value=np.nan,
                 header=None, allow_huge_operations=False, wcs_tolerance=0.0,
                 unit=None, device=None):
        if isinstance(data, Quantity):
            if unit is None:
                unit = data.unit
            data = data.value
        self._data = _as_tensor(data, device)
        self._wcs = wcs
        self._wcs_tolerance = wcs_tolerance
        self._meta = dict(meta) if meta else {}
        if mask is not None and not isinstance(mask, MaskBase):
            raise TypeError(
                f"mask must be a MaskBase subclass or None, got "
                f"{type(mask).__name__!r} (wrap boolean arrays in "
                f"BooleanArrayMask)")
        self._mask = mask
        self._fill_value = fill_value
        self._header = header
        self.allow_huge_operations = allow_huge_operations
        if unit is not None:
            self._unit = Unit.parse(unit)
        else:
            bunit = self._meta.get("BUNIT")
            if bunit is None and header is not None and "BUNIT" in header:
                bunit = header["BUNIT"]
            self._unit = None
            if bunit is not None:
                try:
                    self._unit = Unit.parse(str(bunit).strip())
                except UnitConversionError:
                    warnings.warn(f"Could not parse unit {bunit!r}")
        if wcs is not None and wcs.spec != 2:
            raise ValueError("WCS must be oriented [lon, lat, spec] "
                             "(use spectral_cube_tpu_torch.cube_utils.orient)")

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return 3

    @property
    def size(self):
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def device(self):
        return self._data.device

    @property
    def _is_huge(self):
        from . import cube_utils
        return cube_utils.is_huge(self)

    @property
    def unit(self):
        return self._unit if self._unit is not None else Unit.parse("")

    @property
    def wcs(self):
        return self._wcs

    @property
    def mask(self):
        return self._mask

    @property
    def meta(self):
        return self._meta

    @property
    def fill_value(self):
        return Quantity(self._fill_value, self.unit)

    @property
    def velocity_convention(self):
        from .wcs.spectral import determine_vconv_from_ctype
        return determine_vconv_from_ctype(self._wcs.ctype[2])

    def __len__(self):
        return self.shape[0]

    # -- pickling ----------------------------------------------------------
    def __getstate__(self):
        """A cube pickles with host data and the name of its device; the
        per-instance caches are dropped (the JAX package's cube.py:
        325-335)."""
        state = {k: v for k, v in self.__dict__.items()
                 if not k.startswith("_cache_")}
        state["_data"] = self._data.cpu().numpy()
        state["_device"] = str(self._data.device)
        return state

    def __setstate__(self, state):
        device = state.pop("_device")
        state["_data"] = _as_tensor(state["_data"], device)
        self.__dict__.update(state)

    @property
    def base(self):
        return self._data

    def _new_cube_with(self, data=None, wcs=None, mask=_INHERIT, meta=None,
                       fill_value=None, unit=None, wcs_tolerance=None,
                       **kwargs):
        """Copy with overrides (reference spectral_cube.py:244-289);
        ``kwargs`` go to the subclass's constructor."""
        meta = dict(meta) if meta is not None else dict(self._meta)
        unit = unit if unit is not None else self._unit
        if unit is not None:
            meta["BUNIT"] = unit.to_string()
        cube = self.__class__(
            data=data if data is not None else self._data,
            wcs=wcs if wcs is not None else self._wcs,
            mask=self._mask if mask is _INHERIT else mask, meta=meta,
            fill_value=(fill_value if fill_value is not None
                        else self._fill_value),
            header=self._header, unit=unit,
            allow_huge_operations=self.allow_huge_operations,
            wcs_tolerance=(wcs_tolerance if wcs_tolerance is not None
                           else self._wcs_tolerance),
            # a host array joins the cube's device; a tensor keeps its own
            device=None if isinstance(data, torch.Tensor) else self.device,
            **kwargs)
        return cube

    # ------------------------------------------------------------------
    # masked data access
    # ------------------------------------------------------------------
    def _include_view(self, view=()):
        """Bool include tensor for a view, on the cube's device."""
        if self._mask is None:
            return torch.ones(view_shape(self.shape, view), dtype=torch.bool,
                              device=self.device)
        return self._mask.include(data=self._data, wcs=self._wcs,
                                  view=view).to(self.device)

    def _valid_view(self, view=()):
        """Included and finite, for a view."""
        d = index_view(self._data, view)
        return _red.valid_mask(d, None if self._mask is None
                               else self._include_view(view))

    def _get_filled_data(self, view=(), fill=None):
        fill = self._fill_value if fill is None else fill
        d = index_view(self._data, view)
        if self._mask is None:
            return d
        return torch.where(self._include_view(view), d,
                           torch.as_tensor(fill, dtype=d.dtype,
                                           device=d.device))

    @slice_syntax
    def filled_data(self, view):
        """Quantity of the mask-filled data: ``cube.filled_data[:]``."""
        return Quantity(self._get_filled_data(view), self.unit)

    @slice_syntax
    def unitless_filled_data(self, view):
        """Host array of the mask-filled data, as the JAX package's."""
        return self._get_filled_data(view).cpu().numpy()

    @slice_syntax
    def unmasked_data(self, view):
        return Quantity(index_view(self._data, view), self.unit)

    @warn_slow
    def filled(self, fill_value=None):
        return Quantity(self._get_filled_data(fill=fill_value).cpu().numpy(),
                        self.unit)

    @warn_slow
    def flattened(self, slice=(), weights=None):
        """1-D host Quantity of the included values, as they are (NaN
        included values stay; reference masks.py:165-195), optionally
        times ``weights`` cut by the same view and mask."""
        data = index_view(self._data, slice)
        inc = self._include_view(slice).expand(data.shape)
        flat = data[inc]
        if weights is not None:
            w = index_view(torch.as_tensor(np.asarray(weights)), slice)
            flat = flat * w.to(flat.device).expand(data.shape)[inc]
        return Quantity(flat.cpu().numpy(), self.unit)

    def get_mask_array(self):
        return np.array(self._include_view().expand(self.shape).cpu().numpy())

    @property
    def _nowcs_header(self):
        from .io.fits_low import Header
        h = Header(self._header) if self._header is not None else Header()
        strip = {f"{key}{i}" for i in range(1, 6)
                 for key in ("CTYPE", "CRVAL", "CRPIX", "CDELT", "CUNIT",
                             "NAXIS", "CROTA")}
        for k in list(h.keys()):
            if k in strip or re.fullmatch(r"PC\d_\d|CD\d_\d", k):
                del h[k]
        return h

    @property
    def header(self):
        from .io.fits_low import fold_meta_into_header
        h = self._nowcs_header
        h["NAXIS"] = 3
        for i, n in enumerate(self.shape[::-1]):
            h[f"NAXIS{i + 1}"] = int(n)
        wcsheader = self._wcs.to_header()
        fold_meta_into_header(h, self._meta, wcsheader)
        h.update(wcsheader)
        if self._unit is not None:
            h["BUNIT"] = self._unit.to_string()
        h.add_history("Written by spectral_cube_tpu_torch")
        return h

    @property
    def hdu(self):
        from .io.fits_low import HDU
        return HDU(data=self._get_filled_data().cpu().numpy(),
                   header=self.header)

    @property
    def hdulist(self):
        return [self.hdu]

    def write(self, filename, overwrite=False, format=None):
        from .io import write_cube
        write_cube(self, filename, overwrite=overwrite, format=format)

    @classmethod
    def read(cls, filename, format=None, hdu=0, use_dask=None, device=None,
             **kwargs):
        """Read a cube (FITS, CASA image or CLASS .lmv; the format is
        detected when not given) onto ``device`` (default: the CUDA
        device; raises where CUDA is absent unless ``device='cpu'`` is
        given).  A BEAMS table or per-plane beams give a
        :class:`VaryingResolutionSpectralCube`.  A Stokes file gives its I
        component with a :class:`StokesWarning` (reference
        io/core.py:175-192); a file without one raises ``ValueError``.
        ``use_dask=True`` returns the cube sharded over the default mesh
        (:class:`~.parallel.ShardedCube`, the reference's
        read-into-``DaskSpectralCube``, dask_spectral_cube.py:1390-1394)."""
        from .io import read_cube
        cube = read_cube(filename, format=format, hdu=hdu, device=device,
                         stokes_to_i=True, **kwargs)
        if use_dask:
            from .parallel import ShardedCube
            return ShardedCube(cube)
        return cube

    # ------------------------------------------------------------------
    # masking API (reference spectral_cube.py:1259-1306, :2263-2296)
    # ------------------------------------------------------------------
    def with_mask(self, mask, inherit_mask=True, wcs_tolerance=None):
        if isinstance(mask, (np.ndarray, torch.Tensor)):
            if tuple(mask.shape) != self.shape and not \
                    _broadcastable(mask.shape, self.shape):
                raise ValueError("Mask shape is not broadcastable to data "
                                 f"shape: {tuple(mask.shape)} vs "
                                 f"{self.shape}")
            mask = BooleanArrayMask(mask, wcs=self._wcs, shape=self.shape)
        self._validate_mask_wcs(mask, wcs_tolerance)
        if self._mask is not None and inherit_mask:
            new_mask = CompositeMask(self._mask, mask, operation="and")
        else:
            new_mask = mask
        return self._new_cube_with(mask=new_mask,
                                   wcs_tolerance=wcs_tolerance)

    def _validate_mask_wcs(self, mask, wcs_tolerance=None):
        """Reject a mask whose WCS differs from the cube's (reference
        masks.py:425-435)."""
        mwcs = getattr(mask, "_wcs", None)
        if mwcs is None or self._wcs is None or mwcs is self._wcs:
            return
        tol = wcs_tolerance if wcs_tolerance is not None \
            else self._wcs_tolerance
        if not self._wcs.check_equality(mwcs, wcs_tolerance=tol):
            raise ValueError("WCS does not match mask WCS")

    def with_fill_value(self, fill_value):
        return self._new_cube_with(fill_value=fill_value)

    def _comparison_mask(self, op, value):
        if not isinstance(value, Quantity):
            if self.unit.dimensionless:
                value = Quantity(value, "")
            else:
                raise ValueError(
                    "Can only compare with Quantity values with units "
                    "matching the cube's")
        return LazyComparisonMask(op, value.to_value(self.unit),
                                  data=self._data, wcs=self._wcs,
                                  shape=self.shape)

    def __gt__(self, value):
        return self._comparison_mask(torch.gt, value)

    def __ge__(self, value):
        return self._comparison_mask(torch.ge, value)

    def __lt__(self, value):
        return self._comparison_mask(torch.lt, value)

    def __le__(self, value):
        return self._comparison_mask(torch.le, value)

    def __eq__(self, value):
        if isinstance(value, BaseSpectralCube):
            return NotImplemented
        return self._comparison_mask(torch.eq, value)

    def __ne__(self, value):
        if isinstance(value, BaseSpectralCube):
            return NotImplemented
        return self._comparison_mask(torch.ne, value)

    def __hash__(self):
        return id(self)

    def sigma_clip(self, threshold):
        """Mask out |data - median| > threshold * mad_std, both tails (the
        JAX package's cube.py:606)."""
        s = float(self.mad_std().value)
        med = float(self.median().value)
        lo = Quantity(med - threshold * s, self.unit)
        hi = Quantity(med + threshold * s, self.unit)
        return self.with_mask((self > lo) & (self < hi))

    def mask_channels(self, goodchannels):
        """Mask out channels where goodchannels is False (reference
        spectral_cube.py:3394-3419)."""
        goodchannels = np.asarray(goodchannels, dtype=bool)
        if goodchannels.ndim != 1:
            raise ValueError("goodchannels must be one-dimensional")
        if goodchannels.size != self.shape[0]:
            raise ValueError("goodchannels must have a length equal to the "
                             "cube's spectral dimension.")
        return self.with_mask(BooleanArrayMask(goodchannels,
                                               shape=self.shape))

    # ------------------------------------------------------------------
    # spectral axis
    # ------------------------------------------------------------------
    @property
    def spectral_unit(self):
        return self._wcs.spectral_unit

    @property
    @cached
    def spectral_axis(self) -> Quantity:
        return Quantity(self._wcs.spectral_axis_values(self.shape[0]),
                        self._wcs.spectral_unit)

    def with_spectral_unit(self, unit, velocity_convention=None,
                           rest_value=None):
        """Convert the spectral axis (reference spectral_cube.py:1390-1430;
        the conversion is the WCS's, ``wcs/spectral.py``)."""
        unit = Unit.parse(unit) if isinstance(unit, str) else unit
        out_ctype = determine_ctype_from_vconv(
            self._wcs.ctype[2], unit,
            velocity_convention=velocity_convention)
        new_wcs = convert_spectral_axis(self._wcs, unit, out_ctype,
                                        rest_value=rest_value)
        return self._new_cube_with(wcs=new_wcs)

    @property
    def spectral_extrema(self):
        sv = np.asarray(self.spectral_axis.value)
        return Quantity(np.array([sv.min(), sv.max()]), self.spectral_unit)

    def unmasked_copy(self):
        """Copy with no mask: all data included (reference
        spectral_cube.py:1447-1453)."""
        return self._new_cube_with(mask=None)

    def chunked(self, chunksize=1000):
        """Not implemented, as in the reference (spectral_cube.py:891-897)."""
        raise NotImplementedError()

    def closest_spectral_channel(self, value: Quantity) -> int:
        sv = self.spectral_axis
        try:
            val = value.to_value(sv.unit)
        except UnitConversionError:
            eqv = list(u.spectral())
            rest, _ = self._wcs._rest_value_si()
            if rest is not None:
                eqv += u.doppler_radio(rest) + u.doppler_optical(rest) \
                    + u.doppler_relativistic(rest)
            val = value.to_value(sv.unit, equivalencies=eqv)
        return int(np.argmin(np.abs(np.asarray(sv.value) - val)))

    def spectral_slab(self, lo: Quantity, hi: Quantity):
        """The channel range covering [lo, hi] (reference
        spectral_cube.py:1823-1879): a view sharing the cube's storage."""
        ilo = self.closest_spectral_channel(lo)
        ihi = self.closest_spectral_channel(hi)
        if ilo > ihi:
            ilo, ihi = ihi, ilo
        return self[ilo:ihi + 1, :, :]

    @slice_syntax
    def world(self, view):
        """World coordinate arrays (spectral, lat, lon) broadcast over a
        view, host float64 (reference base_class.py:179-241)."""
        nchan, ny, nx = self.shape
        yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
        cel = self._wcs.celestial
        lon, lat = cel.pix2world(xx.ravel(), yy.ravel())
        lon = np.asarray(lon).reshape(ny, nx)
        lat = np.asarray(lat).reshape(ny, nx)
        spec = np.asarray(self.spectral_axis.value)
        spec_b, lat_b, lon_b = np.broadcast_arrays(
            spec[:, None, None], lat[None, :, :], lon[None, :, :])
        return (Quantity(spec_b[view], self.spectral_unit),
                Quantity(lat_b[view], cel.cunit[1]),
                Quantity(lon_b[view], cel.cunit[0]))

    @property
    def spatial_coordinate_map(self):
        return self.world[0, :, :][1:]

    def world_spines(self):
        """1-D world coordinates along each pixel axis (spec, lat, lon),
        through the first pixel of the other axes; raises
        WCSCelestialError where a pixel axis maps to several world axes
        (the JAX package's cube.py:737-759)."""
        from .utils import WCSCelestialError
        for ax in range(3):
            if self._wcs.is_pixel_axis_correlated(2 - ax):
                raise WCSCelestialError(
                    "world_spines is ill-posed for correlated pixel/world "
                    "axes (rotated or projected celestial coordinates); "
                    "use `world` instead.")
        spines = []
        for ax in range(3):
            view = [0, 0, 0]
            view[ax] = slice(None)
            q = self.world[tuple(view)][ax]
            spines.append(Quantity(np.asarray(q.value), q.unit))
        return spines

    @warn_slow
    def flattened_world(self, view=()):
        """1-D world coordinates of every voxel of a view (reference
        base_class.py:243-270)."""
        spec, lat, lon = self.world[view if view else (slice(None),) * 3]
        return [Quantity(np.asarray(q.value).ravel(), q.unit)
                for q in (spec, lat, lon)]

    @property
    @cached
    def world_extrema(self):
        _, lat, lon = self.world[0, :, :]
        latv = lat.to(lon.unit) if lat.unit != lon.unit else lat
        return Quantity(np.array(
            [[float(lon.value.min()), float(lon.value.max())],
             [float(latv.value.min()), float(latv.value.max())]]),
            lon.unit)

    @property
    def longitude_extrema(self):
        return self.world_extrema[0]

    @property
    def latitude_extrema(self):
        return self.world_extrema[1]

    @property
    def velocity(self):
        return self.with_spectral_unit(u.km_s, velocity_convention="radio")

    def _spectral_offsets(self):
        sv = np.asarray(self.spectral_axis.value, dtype=np.float64)
        return sv - sv[0]

    def _spectral_pix_size(self):
        return abs(float(self._wcs.pixel_scale_matrix[2, 2]))

    def _pix_size_slice(self, axis):
        """Positive pixel size along cube axis 0/1/2 (reference
        spectral_cube.py:1511-1535: spectral size from the scale matrix,
        spatial sizes as the projected row norm, always > 0 regardless of
        cdelt/pc sign)."""
        psm = np.asarray(self._wcs.pixel_scale_matrix)
        if axis == 0:
            return abs(float(psm[2, 2]))
        if axis in (1, 2):
            return float(np.sum(psm[2 - axis, :] ** 2) ** 0.5)
        raise ValueError("Cubes have 3 axes.")

    def _pix_cen(self):
        """World coordinates of every pixel center: (spectral 1-D, lat 2-D,
        lon 2-D) like the reference's cached _pix_cen
        (spectral_cube.py:1547-1580)."""
        lat, lon = (np.asarray(q.value) for q in self.spatial_coordinate_map)
        return np.asarray(self.spectral_axis.value), lat, lon

    def _pix_size(self):
        """Per-pixel world sizes (dv 1-D, dy 2-D, dx 2-D), computed from
        pixel-edge world coordinates like the reference's _pix_size
        (spectral_cube.py:1537-1607): spatial sizes are on-sky angular
        separations between facing pixel edges."""
        nchan, ny, nx = self.shape
        # spectral: |diff| of edge world values
        i = self._wcs.spec
        edges = np.arange(nchan + 1, dtype=float) - 0.5
        pix = [np.zeros(nchan + 1)] * 3
        pix[i] = edges
        sv = np.asarray(self._wcs.pix2world(*pix)[i])
        dv = np.abs(np.diff(sv))

        cel = self._wcs.celestial
        yy, xx = np.mgrid[0:ny, 0:nx].astype(float)

        def sky(px, py):
            lon, lat = cel.pix2world(px.ravel(), py.ravel())
            return (np.radians(np.asarray(lon)).reshape(px.shape),
                    np.radians(np.asarray(lat)).reshape(px.shape))

        def ang_sep(l1, b1, l2, b2):
            # wrap the longitude difference into (-pi, pi] so a pixel
            # straddling lon=0 doesn't measure ~360 deg wide
            dl = (l2 - l1 + np.pi) % (2 * np.pi) - np.pi
            return np.sqrt((dl * np.cos(0.5 * (b1 + b2))) ** 2
                           + (b2 - b1) ** 2)

        lon_l, lat_l = sky(xx - 0.5, yy)
        lon_r, lat_r = sky(xx + 0.5, yy)
        dx = np.degrees(ang_sep(lon_l, lat_l, lon_r, lat_r))
        lon_b, lat_b = sky(xx, yy - 0.5)
        lon_t, lat_t = sky(xx, yy + 0.5)
        dy = np.degrees(ang_sep(lon_b, lat_b, lon_t, lat_t))
        return dv, dy, dx

    # ------------------------------------------------------------------
    # reductions (reference spectral_cube.py:361-819)
    # ------------------------------------------------------------------
    def _reduce(self, fn, axis=None, unit=None, **kwargs):
        if isinstance(axis, (tuple, list)):
            axis = tuple(sorted(int(a) % 3 for a in axis))
            if axis == (0, 1, 2):
                axis = None
        elif axis is not None:
            axis = int(axis) % 3
        data = self._data
        include = self._mask.include(data=data) if self._mask is not None \
            else None
        out = fn(data, _red.valid_mask(data, include), axis=axis, **kwargs)
        unit = unit if unit is not None else self.unit
        if axis is None:
            return Quantity(out.item(), unit)
        return self._wrap_projection(out.cpu().numpy(), axis, unit)

    def _result_beam(self):
        """Beam attached to spectral-reduction results (the reference's
        _handle_beam_areas_wrapper, base_class.py:673-719): a single-beam
        cube's beam; see VaryingResolutionSpectralCube._result_beam."""
        return getattr(self, "_beam", None)

    def _wrap_projection(self, out, axis, unit):
        if isinstance(axis, (tuple, list)):
            # the JAX package's cube.py:879-905: a sky collapse is a
            # spectrum, a spatial + spectral pair a bare 1-D result
            axes = tuple(sorted(int(a) % 3 for a in axis))
            meta = {"collapse_axis": axes}
            meta.update(self._meta)
            if axes == (1, 2):
                return self._1d_spectrum(out, self._wcs.spectral, meta,
                                         None)
            kept = [i for i in range(3) if i not in axes][0]
            warnings.warn("Averaging over a spatial and a spectral "
                          "dimension cannot produce a Projection quantity "
                          "(reference spectral_cube.py:483); returning a "
                          "1-D LowerDimensionalObject.", SliceWarning)
            return LowerDimensionalObject(
                out, unit=unit, wcs=self._wcs.reindex([2 - kept]), meta=meta,
                header=self._nowcs_header)
        new_wcs = self._wcs.dropaxis(2 - axis)
        meta = {"collapse_axis": axis}
        meta.update(self._meta)
        if axis == 0:
            beam = self._result_beam()
            if beam is not None:
                meta["beam"] = beam
            return Projection(out, unit=unit, wcs=new_wcs, meta=meta,
                              header=self._nowcs_header, beam=beam)
        return LowerDimensionalObject(out, unit=unit, wcs=new_wcs, meta=meta,
                                      header=self._nowcs_header)

    def sum(self, axis=None, how=None, **kwargs):
        return self._reduce(_red.masked_sum, axis=axis)

    def mean(self, axis=None, how=None, **kwargs):
        return self._reduce(_red.masked_mean, axis=axis)

    def std(self, axis=None, ddof=0, how=None, **kwargs):
        return self._reduce(_red.masked_std, axis=axis, ddof=ddof)

    def max(self, axis=None, how=None, **kwargs):
        return self._reduce(_red.masked_max, axis=axis)

    def min(self, axis=None, how=None, **kwargs):
        return self._reduce(_red.masked_min, axis=axis)

    def mad_std(self, axis=None, how=None, **kwargs):
        return self._reduce(_red.masked_mad_std, axis=axis)

    def median(self, axis=None, how=None, **kwargs):
        return self._reduce(_red.masked_median, axis=axis)

    def percentile(self, q, axis=None, how=None, **kwargs):
        return self._reduce(lambda d, v, axis: _red.masked_percentile(
            d, v, q, axis=axis), axis=axis)

    def _arg_extremum(self, fn, axis, valid):
        """Indices from ``fn`` (masked_argmax / masked_argmin) along
        ``axis``, or the unravelled flat index where ``axis`` is None."""
        if axis is None:
            flat = fn(self._data.reshape(-1), valid.reshape(-1), axis=0)
            return np.unravel_index(int(flat), self.shape)
        return fn(self._data, valid, axis=axis).cpu().numpy()

    def argmax(self, axis=None, how=None, **kwargs):
        return self._arg_extremum(_red.masked_argmax, axis,
                                  self._valid_view())

    def argmin(self, axis=None, how=None, **kwargs):
        return self._arg_extremum(_red.masked_argmin, axis,
                                  self._valid_view())

    def _argmaxmin_world(self, axis, method, **kwargs):
        """World coordinate of the max/min along ``axis`` (reference
        _argmaxmin_world, spectral_cube.py:820-889); raises
        WCSCelestialError where the pixel axis couples to more than one
        world axis.  The validity cube is made once and reduced on the
        device: only the index and any-valid planes reach the host."""
        from .cube_utils import world_take_along_axis
        from .utils import WCSCelestialError
        if self._wcs.is_pixel_axis_correlated(2 - axis):
            raise WCSCelestialError(
                f"{method}_world requires the celestial axes to be "
                "aligned along image axes.")
        valid = self._valid_view()
        fn = _red.masked_argmax if method == "argmax" else _red.masked_argmin
        idx = self._arg_extremum(fn, axis, valid)
        any_valid = valid.any(dim=axis).cpu().numpy()
        out = world_take_along_axis(self, idx, axis)
        vals = np.asarray(out.value, dtype=float).copy()
        vals[~any_valid] = np.nan
        meta = {"collapse_axis": axis}
        meta.update(self._meta)
        new_wcs = self._wcs.dropaxis(2 - axis)
        if axis == 0:
            return Projection(vals, unit=out.unit, wcs=new_wcs, meta=meta,
                              header=self._nowcs_header)
        return LowerDimensionalObject(vals, unit=out.unit, wcs=new_wcs,
                                      meta=meta, header=self._nowcs_header)

    def argmax_world(self, axis=0, **kwargs):
        """World coordinate of the maximum along ``axis`` (reference
        spectral_cube.py:857-873)."""
        return self._argmaxmin_world(axis, "argmax", **kwargs)

    def argmin_world(self, axis=0, **kwargs):
        """World coordinate of the minimum along ``axis`` (reference
        spectral_cube.py:875-889)."""
        return self._argmaxmin_world(axis, "argmin", **kwargs)

    def statistics(self):
        """One-pass global statistics, CASA ia.statistics naming
        (reference dask_spectral_cube.py:769-814)."""
        data = self._data
        if data.dtype == torch.float32:
            # kernel 1's with_stats planes: one pass over the cube, the
            # mask fused where it can be (cube.py:1008-1021)
            raw = _mom.statistics_kernel(data, mask_expr=self._mask)
        else:
            include = self._mask.include(data=data) \
                if self._mask is not None else None
            raw = _red.masked_statistics(data,
                                         _red.valid_mask(data, include))
        order = ("min", "max", "sum", "mean", "sigma", "rms", "sumsq")
        vals = torch.stack([raw[k].to(torch.float32) for k in order]) \
            .cpu().numpy()
        stats = {"npts": int(raw["npts"])}
        for key, v in zip(order[:-1], vals[:-1]):
            stats[key] = Quantity(float(v), self.unit)
        stats["sumsq"] = Quantity(float(vals[-1]), self.unit ** 2)
        return stats

    # ------------------------------------------------------------------
    # moments (reference spectral_cube.py:1614-1779, _moments.py)
    # ------------------------------------------------------------------
    def moment(self, order=0, axis=0, how="auto", **kwargs):
        axis = int(axis) % 3
        if axis == 0 and order == 2:
            warnings.warn("Note that the second moment returned will be a "
                          "variance map. To get a linewidth map, use the "
                          "SpectralCube.linewidth_fwhm() or "
                          "SpectralCube.linewidth_sigma() methods instead.",
                          VarianceWarning)
        if axis == 0 and order in (0, 1, 2):
            out = self._moments012()[order]
        else:
            coords, dx = self._moment_coords(axis)
            include = self._mask.include(data=self._data) \
                if self._mask is not None else None
            out = _mom.moment_generic(self._data, coords, dx, order,
                                      axis=axis, include=include) \
                .cpu().numpy()
        axunit = self.spectral_unit if axis == 0 else Unit.parse("deg")
        unit = self.unit * axunit if order == 0 else axunit ** max(order, 1)
        meta = {"moment_order": order, "moment_axis": axis,
                "moment_method": how}
        meta.update(self._meta)
        beam = self._result_beam() if axis == 0 else None
        if beam is not None:
            meta["beam"] = beam
        return Projection(out, unit=unit, wcs=self._wcs.dropaxis(2 - axis),
                          meta=meta, header=self._nowcs_header, beam=beam)

    def _moment_coords(self, axis):
        if axis == 0:
            return self._spectral_offsets(), self._spectral_pix_size()
        y_off, x_off = self._spatial_pix_offsets()
        coords = (y_off if axis == 1 else x_off)[None, :, :]
        return coords, abs(self._wcs.proj_plane_pixel_scales()[2 - axis])

    @cached
    def _spatial_pix_offsets(self):
        """Per-pixel cumulative angular offsets (deg) from the cube face
        along y and x (reference _pix_cen, spectral_cube.py:1472-1493)."""
        _, ny, nx = self.shape
        yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
        cel = self._wcs.celestial
        lon, lat = cel.pix2world(xx.ravel(), yy.ravel())
        lon = np.radians(Quantity(np.asarray(lon).reshape(ny, nx),
                                  cel.cunit[0]).to_value("deg"))
        lat = np.radians(Quantity(np.asarray(lat).reshape(ny, nx),
                                  cel.cunit[1]).to_value("deg"))

        def angsep(lon1, lat1, lon2, lat2):
            # Vincenty formula (astropy.coordinates.angular_separation)
            sdlon, cdlon = np.sin(lon2 - lon1), np.cos(lon2 - lon1)
            num1 = np.cos(lat2) * sdlon
            num2 = np.cos(lat1) * np.sin(lat2) \
                - np.sin(lat1) * np.cos(lat2) * cdlon
            den = np.sin(lat1) * np.sin(lat2) \
                + np.cos(lat1) * np.cos(lat2) * cdlon
            return np.arctan2(np.hypot(num1, num2), den)

        dx = angsep(lon[:, :-1], lat[:, :-1], lon[:, 1:], lat[:, 1:])
        dy = angsep(lon[:-1, :], lat[:-1, :], lon[1:, :], lat[1:, :])
        x_off = np.zeros((ny, nx))
        y_off = np.zeros((ny, nx))
        x_off[:, 1:] = np.cumsum(np.degrees(dx), axis=1)
        y_off[1:, :] = np.cumsum(np.degrees(dy), axis=0)
        return y_off, x_off

    @cached
    def _moments012(self):
        """(mom0, mom1, mom2) host arrays along the spectral axis, from one
        pass over the cube."""
        data = self._data
        coords = self._spectral_offsets()
        dx = self._spectral_pix_size()
        if data.dtype == torch.float32:
            m0, m1, m2 = _mom.moments_012_kernel(data, coords, dx,
                                                 mask_expr=self._mask)
        else:
            # the kernel takes float32 only; the JAX package likewise
            # keeps other dtypes off its kernel (cube.py:1134-1136)
            include = self._mask.include(data=data) \
                if self._mask is not None else None
            m0, m1, m2 = _mom.moments_012(data, coords, dx, include=include)
        # mom1 is relative to channel 0; the reference adds the world
        # value at channel 0 (spectral_cube.py:1709-1710)
        sv0 = float(np.asarray(self.spectral_axis.value)[0])
        stacked = torch.stack([m0, m1, m2]).cpu().numpy()
        return stacked[0], stacked[1] + sv0, stacked[2]

    def moment0(self, axis=0, how="auto", **kwargs):
        return self.moment(order=0, axis=axis, how=how, **kwargs)

    def moment1(self, axis=0, how="auto", **kwargs):
        return self.moment(order=1, axis=axis, how=how, **kwargs)

    def moment2(self, axis=0, how="auto", **kwargs):
        return self.moment(order=2, axis=axis, how=how, **kwargs)

    def linewidth_sigma(self, how="auto"):
        """sqrt(moment2) (reference spectral_cube.py:1746-1755)."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", VarianceWarning)
            mom2 = self.moment(order=2, axis=0, how=how)
        with np.errstate(invalid="ignore"):
            vals = np.sqrt(np.asarray(mom2.value))
        return Projection(vals, unit=self.spectral_unit, wcs=mom2.wcs,
                          meta=mom2.meta, header=mom2._header,
                          beam=mom2._beam)

    def linewidth_fwhm(self, how="auto"):
        sig = self.linewidth_sigma(how=how)
        return Projection(np.asarray(sig.value) * SIGMA2FWHM, unit=sig.unit,
                          wcs=sig.wcs, meta=sig.meta, header=sig._header,
                          beam=sig._beam)

    # ------------------------------------------------------------------
    # slicing & subcubes (reference spectral_cube.py:1308-1381, 1881-2036)
    # ------------------------------------------------------------------
    def __getitem__(self, view):
        """Index like the data: slices give a cube, one integer a
        :class:`Slice` (spectral) or a 2-D object, two spatial integers a
        spectrum, three a scalar.  A cut cube's data is contiguous: a
        channel range shares this cube's storage, a spatial cut or a
        negative step is copied once (the kernels take contiguous data
        only).  The mask is cut with the data."""
        if not isinstance(view, tuple):
            view = (view,)
        view = view + (slice(None),) * (3 - len(view))
        if len(view) != 3:
            raise IndexError("too many indices for a 3-D cube")
        ints = [i for i, v in enumerate(view) if _is_int(v)]
        meta = dict(self._meta)
        meta["slice"] = [(v.start, v.stop, v.step) if isinstance(v, slice)
                         else int(v) for v in view]
        if not ints:
            from .cube_utils import canon_view
            view = canon_view(view, self.shape)
            new_wcs = self._wcs.slice(view, shape=self.shape)
            newmask = self._mask[view] if self._mask is not None else None
            return self._new_cube_with(
                data=index_view(self._data, view).contiguous(), wcs=new_wcs,
                mask=newmask, meta=meta)
        if len(ints) == 3:
            return Quantity(index_view(self._data, view).item(), self.unit)
        norm = [v if isinstance(v, slice) else int(v) for v in view]
        slview = tuple(v if isinstance(v, slice) else slice(v, v + 1)
                       for v in norm)
        wcs_full = self._wcs.slice(slview, shape=self.shape)
        keep = [i for i in range(3) if not isinstance(norm[i], int)]
        new_wcs = wcs_full.reindex(sorted(2 - i for i in keep))
        mask = self._mask[view] if self._mask is not None else None
        arr = self._get_filled_data(view).cpu().numpy()
        if len(ints) == 1 and ints[0] == 0:
            return Slice(arr, unit=self.unit, wcs=new_wcs, meta=meta,
                         mask=mask, header=self._nowcs_header,
                         beam=getattr(self, "_beam", None))
        if len(ints) == 2 and 0 not in ints:
            return self._1d_spectrum(arr, new_wcs, meta, mask,
                                     spec_view=norm[0])
        return LowerDimensionalObject(arr, unit=self.unit, wcs=new_wcs,
                                      meta=meta, mask=mask,
                                      header=self._nowcs_header)

    def _1d_spectrum(self, arr, wcs, meta, mask, spec_view=slice(None)):
        return OneDSpectrum(arr, unit=self.unit, wcs=wcs, meta=meta,
                            mask=mask, header=self._nowcs_header,
                            beam=getattr(self, "_beam", None))

    def subcube_slices_from_mask(self, region_mask, spatial_only=False):
        """Bounding-box slices of a mask's included region (reference
        spectral_cube.py:1908-1945).  The include cube is reduced on the
        device; only its three 1-D profiles reach the host."""
        include = region_mask.include(data=self._data).to(self.device) \
            .expand(self.shape)
        plane = include.any(dim=0)
        profiles = (include.any(dim=2).any(dim=1), plane.any(dim=1),
                    plane.any(dim=0))
        slices = []
        for ax, prof in enumerate(profiles):
            w = np.flatnonzero(prof.cpu().numpy())
            if not w.size:
                slices.append(slice(0, 0))
            elif spatial_only and ax == 0:
                slices.append(slice(None))
            else:
                slices.append(slice(int(w[0]), int(w[-1]) + 1))
        return tuple(slices)

    def minimal_subcube(self, spatial_only=False):
        if self._mask is None:
            return self[:]
        return self[self.subcube_slices_from_mask(self._mask,
                                                  spatial_only=spatial_only)]

    def subcube_from_mask(self, region_mask):
        return self.with_mask(region_mask).minimal_subcube()

    def subcube(self, xlo="min", xhi="max", ylo="min", yhi="max", zlo="min",
                zhi="max", rest_value=None):
        """Cut by pixel or world bounds (reference
        spectral_cube.py:1947-2036)."""
        return self[_subcube_view(self, xlo, xhi, ylo, yhi, zlo, zhi)]

    def subcube_from_ds9region(self, ds9_region, allow_empty=False):
        """Cut by a DS9 region string or file (``region.py``)."""
        from .region import subcube_from_ds9region
        return subcube_from_ds9region(self, ds9_region,
                                      allow_empty=allow_empty)

    def subcube_from_crtfregion(self, crtf_region, allow_empty=False):
        """Cut by a CASA CRTF region string or file (``region.py``)."""
        from .region import subcube_from_crtfregion
        return subcube_from_crtfregion(self, crtf_region,
                                       allow_empty=allow_empty)

    def subcube_from_regions(self, region_list, allow_empty=False,
                             minimize=True):
        """Cut by :class:`~.region.Region` objects (``region.py``)."""
        from .region import subcube_from_regions
        return subcube_from_regions(self, region_list,
                                    allow_empty=allow_empty,
                                    minimize=minimize)

    # ------------------------------------------------------------------
    # unit conversion & arithmetic
    # ------------------------------------------------------------------
    @warn_slow
    def to(self, unit, equivalencies=()):
        """Brightness-unit conversion, with per-channel factors where the
        conversion depends on frequency or the beams vary (reference
        spectral_cube.py:2576-2601 via cube_utils.bunit_converters)."""
        from .cube_utils import bunit_converters
        unit = Unit.parse(unit) if isinstance(unit, str) else unit
        factors = bunit_converters(self, unit, equivalencies=equivalencies)
        if factors.size == 1:
            new_data = self._data * float(factors[0])
        else:
            new_data = self._data * _operand(factors, self._data)[:, None,
                                                                   None]
        return self._new_cube_with(data=new_data, unit=unit)

    @property
    def unitless(self):
        return self._new_cube_with(unit=Unit.parse(""))

    def _cube_op_scalar(self, op, value, new_unit=None):
        if isinstance(value, Quantity):
            if op in ("add", "sub"):
                val = value.to_value(self.unit)
                unit = self.unit
            else:
                val = value.value
                unit = {"mul": self.unit * value.unit,
                        "truediv": self.unit / value.unit}[op]
        else:
            if op in ("add", "sub") and not self.unit.dimensionless:
                raise ValueError(
                    "Can only add/subtract Quantity values with units "
                    "matching the cube's (reference _val_to_own_unit, "
                    "spectral_cube.py:2240-2261)")
            val = value
            unit = self.unit
        data = self._get_filled_data(fill=np.nan)
        return self._new_cube_with(
            data=_ARITH[op](data, _operand(val, data)),
            unit=new_unit or unit, mask=self._mask)

    def _cube_on_cube(self, op, other):
        if self.shape != other.shape:
            raise ValueError("cube shapes do not match")
        if not self._wcs.check_equality(other._wcs,
                                        wcs_tolerance=self._wcs_tolerance):
            warnings.warn("WCS mismatch in cube arithmetic",
                          WCSMismatchWarning)
        if op in ("add", "sub"):
            factor = other.unit.to(self.unit)
            unit = self.unit
        else:
            factor = 1.0
            unit = {"mul": self.unit * other.unit,
                    "truediv": self.unit / other.unit}[op]
        mine = self._get_filled_data(fill=np.nan)
        theirs = _operand(other._get_filled_data(fill=np.nan), mine)
        data = _ARITH[op](mine, theirs * factor)
        if self._mask is not None and other._mask is not None:
            mask = CompositeMask(self._mask, other._mask, "and")
        else:
            mask = self._mask or other._mask
        return self._new_cube_with(data=data, unit=unit, mask=mask)

    def _check_huge_materialization(self, what):
        """Reference guard (spectral_cube.py:911-921): whole-cube
        elementwise operations on a huge cube raise unless
        allow_huge_operations is set."""
        if self._is_huge and not self.allow_huge_operations:
            raise ValueError(
                f"This {what} requires loading the entire cube into "
                "memory and may slow down or crash. Set "
                "`cube.allow_huge_operations=True` to override.")

    def _arith(self, op, other, reflected=False):
        self._check_huge_materialization("arithmetic operation")
        if isinstance(other, Unit) and op in ("mul", "truediv"):
            other = Quantity(1.0, other)
        if isinstance(other, BaseSpectralCube):
            if reflected:
                return NotImplemented
            return self._cube_on_cube(op, other)
        if isinstance(other, (int, float, Quantity, np.ndarray,
                              torch.Tensor)):
            if reflected and op in ("sub", "truediv"):
                if op == "sub":
                    return self._cube_op_scalar(op, other) \
                        ._cube_op_scalar("mul", -1.0)
                # value / cube: a true division (torch's reflected
                # operator multiplies by the reciprocal)
                data = self._get_filled_data(fill=np.nan)
                num = other.value if isinstance(other, Quantity) else other
                unit = (other.unit if isinstance(other, Quantity)
                        else Unit.parse("")) / self.unit
                return self._new_cube_with(
                    data=torch.div(_operand(num, data), data), unit=unit)
            return self._cube_op_scalar(op, other)
        return NotImplemented

    def __add__(self, other):
        return self._arith("add", other)

    def __radd__(self, other):
        return self._arith("add", other)

    def __sub__(self, other):
        return self._arith("sub", other)

    def __rsub__(self, other):
        return self._arith("sub", other, reflected=True)

    def __mul__(self, other):
        return self._arith("mul", other)

    def __rmul__(self, other):
        return self._arith("mul", other)

    def __truediv__(self, other):
        return self._arith("truediv", other)

    def __rtruediv__(self, other):
        return self._arith("truediv", other, reflected=True)

    def __pow__(self, p):
        data = self._get_filled_data(fill=np.nan) ** p
        return self._new_cube_with(data=data, unit=self.unit ** p)

    def __floordiv__(self, other):
        raise NotImplementedError(
            "Floor-division (rounding to integer) is not supported "
            "(reference spectral_cube.py:2334)")

    __rfloordiv__ = __floordiv__

    def __abs__(self):
        return self._new_cube_with(data=torch.abs(self._data))

    def _apply_everywhere(self, function, *args, check_units=True):
        """Reference-private spelling (spectral_cube.py:911-957): with
        check_units=False the raw values are operated on and the cube's
        unit is kept."""
        if not check_units:
            vals = [a.value if isinstance(a, Quantity) else a
                    for a in args]
            data = _call_user_function(
                function, self._get_filled_data(fill=np.nan), *vals)
            return self._new_cube_with(data=data, unit=self.unit)
        return self.apply_everywhere(function, *args, check_units=True)

    def apply_everywhere(self, function, *args, check_units=True):
        """Apply an elementwise function to the filled data (reference
        _apply_everywhere, spectral_cube.py:911-957); the function gets a
        Quantity whose value is the data tensor, or a host copy of it where
        numpy refuses the tensor (``masks._call_user_function``)."""
        self._check_huge_materialization("operation")
        if check_units:
            try:
                test = function(Quantity(np.ones((1, 1, 1)), self.unit),
                                *args)
                unit = test.unit if isinstance(test, Quantity) else \
                    Unit.parse("")
            except Exception as exc:
                raise ValueError(
                    f"function {function} does not accept Quantity "
                    f"input: {exc}")
            out = _call_user_function(
                function, Quantity(self._get_filled_data(fill=np.nan),
                                   self.unit), *args)
            if isinstance(out, Quantity):
                return self._new_cube_with(data=out.value, unit=out.unit)
            return self._new_cube_with(data=out, unit=unit)
        data = _call_user_function(
            function, self._get_filled_data(fill=np.nan), *args)
        return self._new_cube_with(data=data)

    # ------------------------------------------------------------------
    # the transform engine (reference spectral_cube.py:1005-1105, 2900-3222)
    # ------------------------------------------------------------------
    @_tmp_dir_option
    def apply_function_parallel_spectral(self, function, *args,
                                         accepts_chunks=False,
                                         return_new_cube=True,
                                         use_memmap=None, parallel=None,
                                         num_cores=None, verbose=0,
                                         progressbar=False,
                                         update_function=None, **kwargs):
        """Apply ``function`` to every spectrum of the NaN-filled data (the
        JAX package's cube.py:1486-1543): ``torch.func.vmap`` over the
        spaxels of the (nchan, ny * nx) view on the cube's device, or,
        with ``accepts_chunks=True``, one call on the whole (nchan, ny,
        nx) block.  A function that takes ``block_info`` gets a dask-style
        dict of one block; ``return_new_cube=False`` returns the output
        as it is.  A function that cannot be vmapped runs per spectrum on
        the host, and its result returns to the cube's device."""
        _check_parallel_options(parallel, num_cores)
        kwargs = _engine_kwargs(function, self.shape, kwargs)
        data = self._get_filled_data(fill=np.nan)
        if accepts_chunks:
            out = _call_user_function(function, data, *args, **kwargs)
        else:
            nchan, ny, nx = data.shape
            out = _vmapped(lambda spec: function(spec, *args, **kwargs),
                           data.reshape(nchan, ny * nx), 1, 1)
            if out is not None:
                out = out.reshape(out.shape[0], ny, nx)
            else:
                out = _as_tensor(np.apply_along_axis(
                    lambda spec: np.asarray(function(spec, *args, **kwargs)),
                    0, data.cpu().numpy()), self.device)
        if not return_new_cube:
            return out
        return self._new_cube_with(data=out)

    @_tmp_dir_option
    def apply_function_parallel_spatial(self, function, *args,
                                        accepts_chunks=False,
                                        return_new_cube=True,
                                        use_memmap=None, parallel=None,
                                        num_cores=None, verbose=0,
                                        progressbar=False,
                                        update_function=None, **kwargs):
        """Apply ``function`` to every channel map of the NaN-filled data,
        vmapped over the channels (the JAX package's cube.py:1545-1584),
        with the options of :meth:`apply_function_parallel_spectral`."""
        _check_parallel_options(parallel, num_cores)
        kwargs = _engine_kwargs(function, self.shape, kwargs)
        data = self._get_filled_data(fill=np.nan)
        if accepts_chunks:
            out = _call_user_function(function, data, *args, **kwargs)
        else:
            out = _vmapped(lambda img: function(img, *args, **kwargs), data,
                           0, 0)
            if out is None:
                arr = data.cpu().numpy()
                out = _as_tensor(np.stack([
                    np.asarray(function(arr[i], *args, **kwargs))
                    for i in range(arr.shape[0])]), self.device)
        if not return_new_cube:
            return out
        return self._new_cube_with(data=out)

    @_tmp_dir_option
    def apply_function(self, function, axis=None, weights=None, unit=None,
                       projection=False, progressbar=False,
                       update_function=None, keep_shape=False, **kwargs):
        """Apply ``function`` to each ray's included values along ``axis``
        on the host (the JAX package's cube.py:1586-1662, reference
        spectral_cube.py:1005-1105), the data and the mask copied to the
        host once: ``weights`` multiplies the values, an empty ray stays
        NaN (0 where a probe shows the function returns integers), a
        Quantity result gives its value.  ``axis=None`` applies the
        function to all included values, ignoring ``weights`` as the
        reference does, and returns its result."""
        if axis is None:
            out = function(self.flattened(), **kwargs)
            if unit is not None:
                return Quantity(out, unit)
            return out
        if hasattr(axis, "__len__"):
            raise NotImplementedError(
                "`apply_function` does not support function application "
                "across multiple axes.  Try `apply_numpy_function`.")
        axis = int(axis) % 3

        data = self._data.cpu().numpy()
        inc = np.broadcast_to(self._include_view(()).cpu().numpy(),
                              data.shape)
        w = (np.broadcast_to(np.asarray(weights), data.shape)
             if weights is not None else None)
        rem = [i for i in range(3) if i != axis]
        ny_, nx_ = self.shape[rem[0]], self.shape[rem[1]]
        nz = self.shape[axis] if keep_shape else 1

        # integer results (argmax-like) must not start as NaN (reference
        # spectral_cube.py:1066-1071)
        proberes = function(np.arange(3, dtype=data.dtype), **kwargs)
        if "int" in str(getattr(proberes, "dtype", "")):
            out = np.zeros([nz, ny_, nx_], dtype=proberes.dtype)
        else:
            out = np.full([nz, ny_, nx_], np.nan)

        if progressbar:
            pbu = ProgressBar(ny_ * nx_).update
        elif update_function is not None:
            pbu = update_function
        else:
            def pbu():
                return True

        for y in range(ny_):
            for x in range(nx_):
                slc = [y, x]
                slc.insert(axis, slice(None))
                slc = tuple(slc)
                vals = data[slc][inc[slc]]
                if w is not None:
                    vals = vals * w[slc][inc[slc]]
                if len(vals) != 0:
                    result = function(Quantity(vals, self.unit), **kwargs)
                    out[:, y, x] = getattr(result, "value", result)
                pbu()

        if not keep_shape:
            out = out[0, :, :]
        if projection and out.ndim == 2:
            return self._wrap_projection(out, axis,
                                         unit if unit is not None
                                         else self.unit)
        return out

    @warn_slow
    @_tmp_dir_option
    def apply_numpy_function(self, function, fill=np.nan, projection=False,
                             unit=None, check_endian=False, axis=None,
                             how="cube", **kwargs):
        """Apply a numpy function to the filled data on the host (the JAX
        package's cube.py:1664-1680, reference spectral_cube.py:361-497)."""
        data = self._get_filled_data(fill=fill).cpu().numpy()
        out = function(data, axis=axis, **kwargs) if axis is not None \
            else function(data, **kwargs)
        if projection and axis is not None and np.ndim(out) == 2:
            return self._wrap_projection(np.asarray(out), axis,
                                         unit if unit is not None
                                         else self.unit)
        if unit is not None:
            return Quantity(out, unit)
        return out

    def rechunk(self, chunks=None, save_to_tmp_dir=False, **kwargs):
        """Dask-API compat (reference DaskSpectralCube.rechunk,
        dask_spectral_cube.py:349-384).  An unsharded cube is one block on
        its device, so there is no chunk layout to change; with
        ``save_to_tmp_dir=True`` it is written to a temporary store and
        read back, as in the reference.  ``ShardedCube.rechunk`` moves
        between mesh layouts."""
        return self.checkpoint() if save_to_tmp_dir else self

    def use_dask_scheduler(self, scheduler=None, num_workers=None):
        """API-compat shim (reference dask_spectral_cube.py:278-312): the
        cube runs on its device; returns a null context."""
        import contextlib
        from .utils import NotImplementedWarning
        warnings.warn("use_dask_scheduler has no effect: the cube runs on "
                      "its device; pick a device set with use_mesh()",
                      NotImplementedWarning)
        return contextlib.nullcontext(self)

    def display_dask_array(self):
        """Print the data's layout (the dask-graph display analog,
        reference dask_spectral_cube.py:341): one block on one device."""
        print(f"shape={self.shape} dtype={self.dtype} device={self.device}")

    def to_sharded(self, cmesh=None):
        """The cube sharded over ``cmesh`` (default: the default mesh),
        the ``use_dask=True`` analog."""
        from .parallel import ShardedCube
        return ShardedCube(self, cmesh)

    def checkpoint(self, tmp_dir=None):
        """The cube's current (masked) state written to a temporary store
        and loaded back on its device; the store lives as long as the
        returned cube (the JAX package's cube.py:1978-1984, the
        reference's ``save_to_tmp_dir=True``)."""
        from .persistence import checkpoint_to_tmp_dir
        return checkpoint_to_tmp_dir(self, tmp_dir=tmp_dir)

    # ------------------------------------------------------------------
    # reprojection and convolution
    # ------------------------------------------------------------------
    def _reproject(self, header, order="bilinear", filled=True):
        data = self._get_filled_data(fill=np.nan) if filled else self._data
        out, footprint, new_wcs = _regrid.reproject_cube(
            data, self._wcs, header, order=order,
            spectral_values_in=np.asarray(self.spectral_axis.value))
        mask = BooleanArrayMask(footprint, wcs=new_wcs,
                                shape=tuple(out.shape))
        return self.__class__(data=out, wcs=new_wcs, mask=mask,
                              meta=dict(self._meta), unit=self._unit,
                              fill_value=self._fill_value,
                              allow_huge_operations=self.allow_huge_operations)

    @warn_slow
    def reproject(self, header, order="bilinear", use_memmap=False,
                  filled=True, **kwargs):
        """Reproject onto the WCS of ``header`` (reference
        spectral_cube.py:2649-2746): bilinear, onto an axis-aligned
        spatial grid (a translation or rescaling of the input's), with the
        input's spectral axis or a new one (channels lerped, then
        resampled; ops/regrid.py).  Rotated targets and nearest-neighbour
        resampling take the four-corner gather; biquadratic and bicubic take
        the spline path."""
        return self._reproject(header, order=order, filled=filled)

    # ------------------------------------------------------------------
    # smoothing / filtering family (reference spectral_cube.py:2749-3222)
    # ------------------------------------------------------------------
    @_tmp_dir_option
    def spectral_smooth(self, kernel, convolve=None, verbose=0,
                        parallel=None, num_cores=None, **kwargs):
        """Smooth along the spectral axis with a 1-D kernel (array or object
        with ``.array``); reference spectral_cube.py:3146-3184.
        ``parallel``/``num_cores`` are validated for reference
        compatibility but do not change the evaluation."""
        _check_parallel_options(parallel, num_cores)
        karr = _kernel_array(kernel)
        data = self._get_filled_data(fill=np.nan)
        return self._new_cube_with(
            data=_smooth.spectral_smooth_cube(data, karr))

    @_tmp_dir_option
    def spectral_smooth_median(self, ksize, raise_error_jybm=True,
                               parallel=None, num_cores=None,
                               update_function=None, **kwargs):
        """Median filter of width ``ksize`` along the spectral axis."""
        self._check_jybeam_smoothing(raise_error_jybm)
        _check_parallel_options(parallel, num_cores)
        data = self._get_filled_data(fill=np.nan)
        out = self._new_cube_with(
            data=_smooth.spectral_median_filter_cube(data, ksize))
        self._call_per_spaxel(update_function)
        return out

    @_tmp_dir_option
    def spectral_filter(self, ksize, filter, parallel=None, num_cores=None,
                        use_memmap=None, update_function=None, **kwargs):
        """Apply an arbitrary scipy-style spectral filter on the host."""
        _check_parallel_options(parallel, num_cores)
        data = self._get_filled_data(fill=np.nan).cpu().numpy()
        out = filter(data, size=(ksize, 1, 1), **kwargs)
        self._call_per_spaxel(update_function)
        return self._new_cube_with(data=out)

    @_tmp_dir_option
    def spatial_smooth(self, kernel, convolve=None, raise_error_jybm=True,
                       **kwargs):
        """Convolve every channel with a 2-D kernel (the separable
        convolution kernel for a low-rank kernel)."""
        self._check_jybeam_smoothing(raise_error_jybm)
        karr = _kernel_array(kernel)
        data = self._get_filled_data(fill=np.nan)
        return self._new_cube_with(
            data=_smooth.spatial_smooth_cube(data, karr))

    def spatial_smooth_median(self, ksize, raise_error_jybm=True, **kwargs):
        """Median filter of each channel map, ``ksize`` an int or (ky, kx)."""
        self._check_jybeam_smoothing(raise_error_jybm)
        data = self._get_filled_data(fill=np.nan)
        return self._new_cube_with(
            data=_smooth.spatial_median_filter_cube(data, ksize))

    @_tmp_dir_option
    def spatial_filter(self, ksize, filter, raise_error_jybm=True,
                       parallel=None, num_cores=None, use_memmap=None,
                       update_function=None, **kwargs):
        """Arbitrary scipy.ndimage filter over each spatial plane on the
        host (reference spectral_cube.py:2776-2806)."""
        self._check_jybeam_smoothing(raise_error_jybm)
        _check_parallel_options(parallel, num_cores)
        data = self._get_filled_data(fill=np.nan).cpu().numpy()
        ky, kx = (ksize, ksize) if np.isscalar(ksize) else tuple(ksize)
        out = filter(data, size=(1, ky, kx), **kwargs)
        if update_function is not None:
            for _ in range(int(self.shape[0])):
                update_function()
        return self._new_cube_with(data=out)

    @_tmp_dir_option
    def sigma_clip_spectrally(self, threshold, verbose=0, maxiters=5,
                              cenfunc="median", stdfunc="std",
                              parallel=None, num_cores=None,
                              use_memmap=None, update_function=None,
                              **kwargs):
        """Iterative per-spaxel sigma clip (reference
        spectral_cube.py:3161-3184; the dask docs benchmark workload),
        through the sigma_clip kernel for float32 data with
        stdfunc='std'.  ``cenfunc``/``stdfunc`` follow
        astropy.stats.sigma_clip; unknown kwargs are rejected, never
        silently dropped."""
        if kwargs:
            raise TypeError(
                f"unsupported sigma_clip keyword(s) {sorted(kwargs)}; "
                "supported: cenfunc ('median'|'mean'), "
                "stdfunc ('std'|'mad_std')")
        _check_parallel_options(parallel, num_cores)
        data = self._get_filled_data(fill=np.nan)
        out = _smooth.sigma_clip_spectrally(data, sigma=threshold,
                                            maxiters=maxiters,
                                            cenfunc=cenfunc, stdfunc=stdfunc)
        self._call_per_spaxel(update_function)
        return self._new_cube_with(data=out)

    def _call_per_spaxel(self, update_function):
        """Reference parity: a progress hook called once per spaxel (the
        joblib applicator's, spectral_cube.py:3014-3019)."""
        if update_function is not None:
            for _ in range(int(self.shape[1] * self.shape[2])):
                update_function()

    def check_jybeam_smoothing(self, raise_error_jybm=True):
        """Public alias (reference base_class.py:116-140)."""
        return self._check_jybeam_smoothing(raise_error_jybm=raise_error_jybm)

    def _check_jybeam_smoothing(self, raise_error_jybm=True):
        """Jy/beam data cannot be spatially smoothed without changing the
        beam (reference base_class.py:116-140)."""
        from . import units as u
        if self._unit is not None and raise_error_jybm \
                and self._unit.dims == (u.Jy / u.beam).dims:
            from .beams import BeamUnitsError
            raise BeamUnitsError(
                "Attempting to smooth a cube in Jy/beam units changes the "
                "beam; convert to K first (`cube.to('K')`) or pass "
                "raise_error_jybm=False to override.")

    # ------------------------------------------------------------------
    # spectral interpolation & downsampling
    # ------------------------------------------------------------------
    @_tmp_dir_option
    def spectral_interpolate(self, spectral_grid,
                             suppress_smooth_warning=False,
                             fill_value=None, update_function=None,
                             smooth_kernel=None, **kwargs):
        """Regrid onto a new (linear) spectral grid (reference
        spectral_cube.py:3224-3332): weights computed once from the shared
        axis, applied as one gather + lerp.

        ``smooth_kernel`` (1-D, optional): smooth spectrally before
        regridding, the anti-aliasing workflow the reference documents as
        separate ``spectral_smooth`` + ``spectral_interpolate`` calls.
        Under the finiteness mask of a read cube both run as one pass of
        the smooth_interp kernel; under another data-local mask the
        smooth runs first and the mask is evaluated on its result, as the
        chained calls would; any other mask rides along the fused pass.
        Suppresses the Nyquist warning."""
        if isinstance(spectral_grid, Quantity):
            grid = spectral_grid.to_value(self.spectral_unit)
        else:
            grid = np.asarray(spectral_grid, dtype=float)
        if grid.ndim != 1:
            raise ValueError("spectral_grid must be 1-dimensional")
        diffs = np.diff(grid)
        if grid.size > 2 and not np.allclose(diffs, diffs[0],
                                             rtol=1e-6, atol=0):
            raise ValueError("spectral_grid must be linear")
        inaxis = np.asarray(self.spectral_axis.value, dtype=float)
        if not suppress_smooth_warning and smooth_kernel is None:
            _interp.check_nyquist(inaxis, grid)
        include = self._mask.include(data=self._data, wcs=self._wcs) \
            if self._mask is not None else None
        lo, hi = min(inaxis[0], inaxis[-1]), max(inaxis[0], inaxis[-1])
        oob = torch.as_tensor(np.where((grid < lo) | (grid > hi))[0],
                              device=self.device)
        new_wcs = _interp.linear_spectral_wcs(self._wcs, grid)
        if smooth_kernel is not None:
            karr = _kernel_array(smooth_kernel)
            filled = self._get_filled_data(fill=np.nan)
            if include is not None and is_finiteness_mask(self._mask):
                # the read mask: finiteness tracks the data, so the
                # inherited mask evaluated on the fused result gives
                # exactly the chained calls' filled values
                out, _ = _interp.smooth_interp_cube(filled, karr, inaxis,
                                                    grid)
                if fill_value is not None and oob.numel():
                    # only finite clamped edges take the fill, so the
                    # re-bound finiteness mask keeps excluding dead edges
                    edge = out[oob]
                    out[oob] = torch.where(torch.isfinite(edge),
                                           float(fill_value), float("nan")
                                           ).to(out.dtype)
                new_mask = LazyMask(self._mask._function, data=out,
                                    wcs=new_wcs, shape=tuple(out.shape))
                return self._new_cube_with(data=out, wcs=new_wcs,
                                           mask=new_mask)
            if include is not None and is_data_local(self._mask):
                # chained-call parity: spectral_smooth re-evaluates a
                # data-local mask on the SMOOTHED data, so the interp step
                # sees its includes, not the original ones
                sm = _smooth.spectral_smooth_cube(filled, karr)
                include = self._mask.include(data=sm, wcs=self._wcs)
                out, new_include = _interp.interp_cube_spectral(
                    sm, inaxis, grid, include=include)
            else:
                out, new_include = _interp.smooth_interp_cube(
                    filled, karr, inaxis, grid, include=include)
        else:
            out, new_include = _interp.interp_cube_spectral(
                self._data, inaxis, grid, include=include)
        if fill_value is not None and oob.numel():
            out[oob] = float(fill_value)
        mask = BooleanArrayMask(new_include, wcs=new_wcs,
                                shape=tuple(out.shape)) \
            if new_include is not None else None
        return self._new_cube_with(data=out, wcs=new_wcs, mask=mask)

    @_tmp_dir_option
    def downsample_axis(self, factor, axis, estimator="mean", truncate=False,
                        use_memmap=None, progressbar=None):
        """Block-downsample (reference spectral_cube.py:3421-3557)."""
        data = self._get_filled_data(fill=np.nan)
        out = _interp.downsample_axis(data, factor, axis,
                                      estimator=estimator, truncate=truncate)
        view = [slice(None)] * 3
        view[axis] = slice(None, None, int(factor))
        new_wcs = self._wcs.slice(tuple(view), shape=self.shape)
        new_mask = None
        if self._mask is not None:
            # block-any of the include mask, matching the reference
            # (spectral_cube.py:3503-3548: np.any over each factor-block)
            include = self._mask.include(data=self._data, wcs=self._wcs)
            inc_ds = _interp.downsample_include(include, factor, axis,
                                                truncate=truncate)
            new_mask = BooleanArrayMask(inc_ds, wcs=new_wcs,
                                        shape=tuple(out.shape))
        return self._new_cube_with(data=out, wcs=new_wcs, mask=new_mask)

    # ------------------------------------------------------------------
    # line search, exporters and viewers (reference
    # spectral_cube.py:2363-2648, :3559-3687).  Their packages are
    # imported only when called; what they receive is copied to the host.
    # ------------------------------------------------------------------
    def find_lines(self, velocity_offset=None, velocity_convention=None,
                   rest_value=None, **kwargs):
        """Line search through astroquery's Splatalogue interface
        (reference spectral_cube.py:2604-2648); needs astroquery and a
        network."""
        try:
            from astroquery.splatalogue import Splatalogue
        except ImportError as exc:
            raise ImportError(
                "find_lines requires astroquery, which is not "
                "installed") from exc
        value = self.with_spectral_unit(
            u.GHz, velocity_convention=velocity_convention,
            rest_value=rest_value).spectral_axis
        if velocity_offset is not None:
            vsu = self.with_spectral_unit(
                u.km_s, velocity_convention=velocity_convention,
                rest_value=rest_value).spectral_axis
            vsu = vsu + velocity_offset
            value = Quantity(np.asarray(vsu.value), vsu.unit)
        return Splatalogue.query_lines(
            float(np.asarray(value.value).min()),
            float(np.asarray(value.value).max()), **kwargs)

    def to_yt(self, **kwargs):
        """A :class:`~.ytcube.ytCube` over a yt uniform grid of the filled
        data (``ytcube.py``)."""
        from .ytcube import to_yt
        return to_yt(self, **kwargs)

    def to_glue(self, name=None, glue_app=None, dataset=None,
                start_gui=True):
        """Send the cube to a new or existing Glue application (reference
        spectral_cube.py:2441-2504); raises ImportError without glue."""
        from glue.app.qt import GlueApplication
        from glue.core import DataCollection, Data
        from glue.core.coordinates import coordinates_from_header
        if name is None:
            name = "SpectralCube"
        data = Data(label=name)
        data.coords = coordinates_from_header(self.header)
        data["intensity"] = self._get_filled_data(fill=np.nan).cpu().numpy()
        if dataset is not None:
            dataset.add_component(data["intensity"], name)
            return
        glue_app = glue_app or getattr(self, "_glue_app", None)
        if glue_app is None:
            glue_app = GlueApplication(DataCollection([data]))
            self._glue_app = glue_app
        else:
            glue_app.add_datasets([data])
        if start_gui:
            glue_app.start()
        return glue_app

    def to_pvextractor(self):
        """Open the cube in pvextractor's PV-slice GUI (reference
        spectral_cube.py:2506-2513)."""
        from pvextractor.gui import PVSlicer
        return PVSlicer(self)

    def to_ds9(self, ds9id=None, newframe=False):
        """Send the cube to a running ds9 through XPA (reference
        spectral_cube.py:2515-2545): it is written to a temporary FITS
        file, loaded by path, and the file is removed."""
        try:
            import ds9
        except ImportError:
            import pyds9 as ds9
        import os
        import tempfile
        if ds9id is None:
            dd = ds9.DS9(start=True)
        else:
            dd = ds9.DS9(target=ds9id, start=False)
        if newframe:
            dd.set("frame new")
        tmp = tempfile.NamedTemporaryFile(suffix=".fits", delete=False)
        tmp.close()
        try:
            self.write(tmp.name, overwrite=True)
            dd.set(f"file {tmp.name}")  # XPA set returns after the load
        finally:
            try:
                os.unlink(tmp.name)
            except OSError:
                pass
        return dd

    def plot_channel_maps(self, nx, ny, channels, contourkwargs={},
                          output_file=None, fig=None,
                          fig_smallest_dim_inches=8, decimals=3, zoom=1,
                          textcolor=None, cmap="gray_r", tighten=False,
                          textxloc=0.5, textyloc=0.9, savefig_kwargs={},
                          **kwargs):
        """Channel-map grid plot with matplotlib (reference
        spectral_cube.py:3559-3687)."""
        import matplotlib.pyplot as plt
        if len(channels) != nx * ny:
            raise ValueError("to plot image channels, you need "
                             "len(channels) == nx * ny")
        if fig is None:
            shape = self.shape[1:]
            aspect = shape[0] / shape[1]
            size = fig_smallest_dim_inches
            figsize = (size * nx, size * ny * aspect) if aspect < 1 else \
                (size * nx / aspect, size * ny)
            fig = plt.figure(figsize=figsize)
        axes = []
        sv = np.asarray(self.spectral_axis.value)
        for ii, chan in enumerate(channels):
            ax = fig.add_subplot(ny, nx, ii + 1)
            img = self._get_filled_data(
                view=(chan, slice(None), slice(None))).cpu().numpy()
            ax.imshow(img, origin="lower", cmap=cmap, **kwargs)
            ax.text(textxloc, textyloc,
                    f"{np.round(sv[chan], decimals)} {self.spectral_unit}",
                    transform=ax.transAxes, ha="center",
                    color=textcolor or "k")
            ax.set_xticks([])
            ax.set_yticks([])
            axes.append(ax)
        if tighten:
            fig.tight_layout()
        if output_file is not None:
            fig.savefig(output_file, **savefig_kwargs)
        return axes

    def __repr__(self):
        """Shape + per-axis type/unit/world-range summary (the JAX
        package's cube.py:2097-2123, reference base_class.py:325-348),
        then the device."""
        nchan, ny, nx = self.shape
        unit = str(self.unit)
        head = f"{type(self).__name__} with shape={self.shape}"
        head += f" and unit={unit}:\n" if unit else ":\n"
        try:
            lon = np.asarray(self.longitude_extrema.value, dtype=float)
            lat = np.asarray(self.latitude_extrema.value, dtype=float)
            spec = np.asarray(self.spectral_extrema.value, dtype=float)
            cu = [c.to_string() for c in self._wcs.cunit]
            su = str(self.spectral_axis.unit)
            rows = [
                f" n_x: {nx:6d}  type_x: {self._wcs.ctype[0]:8s}  "
                f"unit_x: {cu[0]:5s}  range: {lon[0]:12.6f}:{lon[1]:12.6f}",
                f" n_y: {ny:6d}  type_y: {self._wcs.ctype[1]:8s}  "
                f"unit_y: {cu[1]:5s}  range: {lat[0]:12.6f}:{lat[1]:12.6f}",
                f" n_s: {nchan:6d}  type_s: {self._wcs.ctype[2]:8s}  "
                f"unit_s: {su:5s}  range: {spec[0]:12.3f}:{spec[1]:12.3f}",
            ]
        except Exception:
            rows = [f" n_x: {nx:6d}  type_x: {self._wcs.ctype[0]}",
                    f" n_y: {ny:6d}  type_y: {self._wcs.ctype[1]}",
                    f" n_s: {nchan:6d}  type_s: {self._wcs.ctype[2]}"]
        return head + "\n".join(rows) + f"\n on {self.device}"


class SpectralCube(BaseSpectralCube):
    """A cube with one beam (reference spectral_cube.py:3689-3781)."""

    def __init__(self, data, wcs, mask=None, meta=None, fill_value=np.nan,
                 header=None, allow_huge_operations=False, beam=None,
                 wcs_tolerance=0.0, unit=None, device=None):
        super().__init__(data=data, wcs=wcs, mask=mask, meta=meta,
                         fill_value=fill_value, header=header,
                         allow_huge_operations=allow_huge_operations,
                         wcs_tolerance=wcs_tolerance, unit=unit,
                         device=device)
        if beam is None:
            if header is not None:
                beam = Beam.from_header(header)
            if beam is None and "beam" in self._meta:
                beam = self._meta["beam"]
        self._beam = beam
        if beam is not None:
            self._meta["beam"] = beam

    def _new_cube_with(self, beam=None, **kwargs):
        cube = super()._new_cube_with(**kwargs)
        cube._beam = beam if beam is not None else self._beam
        if cube._beam is not None:
            cube._meta["beam"] = cube._beam
        return cube

    @property
    def header(self):
        h = super().header
        if self._beam is not None:
            h.update(self._beam.to_header_keywords())
        return h

    @property
    def beam(self):
        if self._beam is None:
            raise NoBeamError(
                "No beam is defined for this SpectralCube; use with_beam "
                "to attach one (reference base_class.py:486-497)")
        return self._beam

    def with_beam(self, beam, raise_error_jybm=True):
        return self._new_cube_with(beam=beam)

    @property
    def pixels_per_beam(self):
        return float(self.beam.sr.value /
                     (self._wcs.proj_plane_pixel_area()
                      * (np.pi / 180.0) ** 2))

    @_tmp_dir_option
    def convolve_to(self, beam, convolve=None, update_function=None,
                    **kwargs):
        """Convolve every channel to a common target beam (reference
        spectral_cube.py:3334-3392)."""
        if self._beam is None:
            raise NoBeamError("The cube has no beam; use with_beam first")
        pixscale = float(np.mean(np.abs(
            self._wcs.celestial.proj_plane_pixel_scales()))) * np.pi / 180.0
        out, factors = _conv.convolve_cube_to_beam(
            self._get_filled_data(fill=np.nan), self._beam, beam, pixscale,
            unit=self.unit)
        if not np.allclose(factors, 1.0):
            out = out * torch.as_tensor(factors, dtype=out.dtype,
                                        device=out.device)[:, None, None]
        return self._new_cube_with(data=out, beam=beam)



class VaryingResolutionSpectralCube(BaseSpectralCube):
    """A cube with one beam per channel (reference
    spectral_cube.py:3784-4315; the JAX package's cube.py:2199-2560).
    Cutting the spectral axis cuts the beams with it."""

    def __init__(self, data, wcs, mask=None, meta=None, fill_value=np.nan,
                 header=None, allow_huge_operations=False, beams=None,
                 beam_table=None, goodbeams_mask=None, wcs_tolerance=0.0,
                 beam_threshold=0.01, unit=None, device=None):
        super().__init__(data=data, wcs=wcs, mask=mask, meta=meta,
                         fill_value=fill_value, header=header,
                         allow_huge_operations=allow_huge_operations,
                         wcs_tolerance=wcs_tolerance, unit=unit,
                         device=device)
        if beams is None and beam_table is not None:
            beams = _beams_from_bintable(beam_table)
        if beams is None:
            raise ValueError("VaryingResolutionSpectralCube requires beams")
        if len(beams) != self.shape[0]:
            raise ValueError(
                f"beam list length ({len(beams)}) does not match cube "
                f"spectral dimension ({self.shape[0]})")
        self._beams = beams
        self.beam_threshold = beam_threshold
        finite = beams.isfinite
        if goodbeams_mask is not None:
            self._goodbeams_mask = np.asarray(goodbeams_mask) & finite
        else:
            self._goodbeams_mask = finite
        # mask the channels and warn only for NEWLY bad beams: channels the
        # given goodbeams_mask still marks good whose beams are not finite.
        # Derived cubes pass a goodbeams_mask that already reflects the
        # exclusions and carry the channel mask.
        newly_bad = ~finite if goodbeams_mask is None \
            else (~finite) & np.asarray(goodbeams_mask)
        if newly_bad.any():
            warnings.warn("Non-finite beams were automatically masked out",
                          NonFiniteBeamsWarning)
            chan_mask = BooleanArrayMask(self._goodbeams_mask,
                                         shape=self.shape)
            self._mask = CompositeMask(self._mask, chan_mask, "and") \
                if self._mask is not None else chan_mask

    # -- beams -----------------------------------------------------------
    @property
    def beams(self) -> Beams:
        return self._beams[self._goodbeams_mask]

    @property
    def unmasked_beams(self) -> Beams:
        return self._beams

    @property
    def goodbeams_mask(self):
        return self._goodbeams_mask

    def identify_bad_beams(self, threshold, reference_beam=None,
                           criteria=("sr", "major", "minor")):
        """Flag channels whose beam deviates from the median by more than
        ``threshold`` fractionally (reference base_class.py:544-597)."""
        if reference_beam is None:
            ref = Beam.make(Quantity(np.median(self._beams.major.value),
                                     "deg"),
                            Quantity(np.median(self._beams.minor.value),
                                     "deg"),
                            Quantity(0, "deg"))
        else:
            ref = reference_beam
        good = np.ones(len(self._beams), dtype=bool)
        for i, b in enumerate(self._beams):
            if not b.isfinite:
                good[i] = False
                continue
            checks = {"sr": abs(b.sr.value - ref.sr.value) / ref.sr.value,
                      "major": abs(b.major_rad - ref.major_rad)
                      / ref.major_rad,
                      "minor": abs(b.minor_rad - ref.minor_rad)
                      / ref.minor_rad}
            if any(checks[c] > threshold for c in criteria):
                good[i] = False
        return good

    def mask_out_bad_beams(self, threshold, reference_beam=None,
                           criteria=("sr", "major", "minor")):
        good = self.identify_bad_beams(threshold, reference_beam, criteria)
        chan = BooleanArrayMask(good, shape=self.shape)
        new = self._new_cube_with(
            mask=CompositeMask(self._mask, chan, "and")
            if self._mask is not None else chan)
        new._goodbeams_mask = self._goodbeams_mask & good
        return new

    def with_beams(self, beams, goodbeams_mask=None, raise_error_jybm=True):
        """Replace the per-channel beams.  Changing beams under Jy/beam
        units silently rescales the data's meaning, so it raises unless
        raise_error_jybm=False (reference spectral_cube.py:4096-4124)."""
        if raise_error_jybm:
            self._check_jybeam_smoothing(raise_error_jybm=True)
        if len(beams) != self.shape[0]:
            raise ValueError(
                f"The Beams object must have the same size as the "
                f"spectral axis ({len(beams)} vs {self.shape[0]})")
        return self._new_cube_with(beams=beams,
                                   goodbeams_mask=goodbeams_mask)

    @property
    def pixels_per_beam(self):
        """Per-channel beam areas in pixels, over the good beams only
        (reference base_class.py:552-560)."""
        pix_area = (self._wcs.proj_plane_pixel_area()
                    * (np.pi / 180.0) ** 2)
        return np.array([float(b.sr.value) / pix_area for b in self.beams])

    def average_beams(self, threshold=None, mask="compute", warn=False):
        """Average beam of the good channels that hold an included value
        (``mask='compute'``), checking homogeneity when ``threshold`` is
        given (reference base_class.py:599-670)."""
        if mask == "compute" and self._mask is not None:
            include = self._mask.include(data=self._data, wcs=self._wcs) \
                .expand(self.shape).flatten(1).any(1).cpu().numpy()
            beam_mask = include & self._goodbeams_mask
        else:
            beam_mask = self._goodbeams_mask
        if threshold is not None:
            self._check_beam_areas(threshold, mask=beam_mask)
        if warn:
            warnings.warn("Arithmetic beam averaging is being performed.",
                          BeamAverageWarning)
        return self._beams.average_beam(include_mask=beam_mask)

    def _check_beam_areas(self, threshold=None, mask=None):
        """Raise if the beams' areas differ from their mean by more than
        the threshold (reference base_class.py:721-759)."""
        threshold = threshold if threshold is not None else \
            self.beam_threshold
        mask = mask if mask is not None else self._goodbeams_mask
        srs = np.array([b.sr.value for b in self._beams])[mask]
        if srs.size == 0:
            return
        mean_sr = srs.mean()
        if np.any(np.abs(srs - mean_sr) / mean_sr > threshold):
            raise ValueError(
                "Beams do not match within the threshold; convolve to a "
                "common beam first (convolve_to) or raise beam_threshold.")

    def _new_cube_with(self, beams=None, goodbeams_mask=None, **kwargs):
        return super()._new_cube_with(
            beams=beams if beams is not None else self._beams,
            goodbeams_mask=(goodbeams_mask if goodbeams_mask is not None
                            else self._goodbeams_mask),
            beam_threshold=self.beam_threshold, **kwargs)

    # -- beam-coupled overrides ----------------------------------------------
    def _result_beam(self):
        """Spectral reductions of a varying-resolution cube carry the
        arithmetic-average beam, with the reference's warning
        (base_class.py:599-670 via _handle_beam_areas_wrapper)."""
        try:
            return self.average_beams(warn=True)
        except (ValueError, NoBeamError):
            return None

    def _reduce(self, fn, axis=None, **kwargs):
        """Spectral reductions require matched beams (reference
        __getattribute__ hook, spectral_cube.py:4077-4095); tuple axes
        that include the spectral axis count."""
        if axis is None or 0 in [int(a) % 3 for a in np.atleast_1d(axis)]:
            self._check_beam_areas()
        return super()._reduce(fn, axis=axis, **kwargs)

    def moment(self, order=0, axis=0, **kwargs):
        if int(axis) % 3 == 0:
            self._check_beam_areas()
        return super().moment(order=order, axis=axis, **kwargs)

    def _check_beams_for_axis(self, axis):
        """Operating over the spectral axis requires matching beams (the
        reference wraps apply_numpy_function and apply_function in
        _handle_beam_areas_wrapper, spectral_cube.py:4077-4095)."""
        if axis is not None \
                and 0 in [int(a) % 3 for a in np.atleast_1d(axis)]:
            self._check_beam_areas()

    def apply_numpy_function(self, function, *args, **kwargs):
        # axis is the 6th positional parameter of the base signature
        axis = kwargs.get("axis", args[4] if len(args) > 4 else None)
        self._check_beams_for_axis(axis)
        return super().apply_numpy_function(function, *args, **kwargs)

    def apply_function(self, function, *args, **kwargs):
        # axis is the 2nd positional parameter of the base signature
        axis = kwargs.get("axis", args[0] if args else None)
        self._check_beams_for_axis(axis)
        return super().apply_function(function, *args, **kwargs)

    @property
    def header(self):
        h = super().header
        h["CASAMBM"] = True  # multi-beam marker (reference :4097-4104)
        return h

    @property
    def hdulist(self):
        from .io.fits_low import BinTableHDU
        bt = BinTableHDU(columns=self._beams.to_table_columns(),
                         name="BEAMS",
                         units={"BMAJ": "arcsec", "BMIN": "arcsec",
                                "BPA": "deg"})
        bt.header["NCHAN"] = self.shape[0]
        bt.header["NPOL"] = 1
        return super().hdulist + [bt]

    def common_beam(self, **kwargs):
        return self.beams.common_beam(**kwargs)

    @_tmp_dir_option
    def convolve_to(self, beam, allow_smaller=False, convolve=None,
                    update_function=None, **kwargs):
        """Per-channel convolution to one common beam (reference
        spectral_cube.py:4126-4240), channels grouped by equal beams.
        Channels whose beam is bad give NaN; with ``allow_smaller``,
        channels whose beam cannot be deconvolved from ``beam`` pass
        through unconvolved.  Returns a :class:`SpectralCube`."""
        pixscale = float(np.mean(np.abs(
            self._wcs.celestial.proj_plane_pixel_scales()))) * np.pi / 180.0
        # a bad channel's output is NaN (goodchannels): the target beam
        # stands in for its beam so that no convolution kernel is made
        # from a NaN or oversized beam (reference spectral_cube.py:4216-4231)
        beams = [b if good else beam
                 for b, good in zip(self._beams, self._goodbeams_mask)]
        if not allow_smaller:
            for b, good in zip(beams, self._goodbeams_mask):
                if good:
                    beam.deconvolve(b)  # raises BeamError if impossible
        else:
            # reference spectral_cube.py:4195-4204: a channel whose beam
            # cannot be deconvolved from the target passes through with
            # factor 1, which the target beam standing in gives exactly
            def _deconvolvable(b):
                try:
                    beam.deconvolve(b)
                    return True
                except BeamError:
                    return False
            beams = [b if not good or _deconvolvable(b) else beam
                     for b, good in zip(beams, self._goodbeams_mask)]
        out, factors = _conv.convolve_cube_to_beam(
            self._get_filled_data(fill=np.nan), beams, beam, pixscale,
            unit=self.unit, goodchannels=self._goodbeams_mask)
        if not np.allclose(factors, 1.0):
            out = out * torch.as_tensor(factors, dtype=out.dtype,
                                        device=out.device)[:, None, None]
        meta = dict(self._meta)
        meta["beam"] = beam
        return SpectralCube(data=out, wcs=self._wcs, mask=self._mask,
                            meta=meta, fill_value=self._fill_value,
                            unit=self._unit, beam=beam,
                            allow_huge_operations=self.allow_huge_operations)

    def mask_channels(self, goodchannels):
        """Mask channels and exempt their beams from the beam checks
        (reference spectral_cube.py:4270-4300)."""
        goodchannels = np.asarray(goodchannels, dtype=bool)
        out = super().mask_channels(goodchannels)
        out._goodbeams_mask = self._goodbeams_mask & goodchannels
        return out

    def spectral_interpolate(self, *args, **kwargs):
        raise AttributeError(
            "VaryingResolutionSpectralCubes can't be spectrally "
            "interpolated.  Convolve to a common resolution with "
            "`convolve_to` before spectral interpolation. "
            "(reference spectral_cube.py:4302-4307)")

    def spectral_smooth(self, *args, **kwargs):
        raise AttributeError(
            "VaryingResolutionSpectralCubes can't be spectrally smoothed. "
            "Convolve to a common resolution with `convolve_to` before "
            "spectral smoothing. (reference spectral_cube.py:4308-4312)")

    def __getitem__(self, view):
        if not isinstance(view, tuple):
            view = (view,)
        view = view + (slice(None),) * (3 - len(view))
        spec_idx = view[0]
        if _is_int(spec_idx):
            # one channel: the single-beam objects, with that channel's beam
            out = super().__getitem__(view)
            if isinstance(out, (Slice, Projection)):
                out._beam = self._beams[int(spec_idx)]
            return out
        if sum(_is_int(v) for v in view[1:]) == 1:
            raise NotImplementedError(
                "Slicing a VaryingResolutionSpectralCube to a 2D plane "
                "along the spectral axis is not supported "
                "(reference spectral_cube.py:3937-3943)")
        if all(isinstance(v, slice) for v in view):
            # data, WCS, mask and beams are cut together, so the
            # constructor's length check sees consistent inputs
            from .cube_utils import canon_view
            view = canon_view(view, self.shape)
            meta = dict(self._meta)
            meta["slice"] = [(v.start, v.stop, v.step) for v in view]
            return self._new_cube_with(
                data=index_view(self._data, view).contiguous(),
                wcs=self._wcs.slice(view, shape=self.shape),
                mask=self._mask[view] if self._mask is not None else None,
                meta=meta, beams=self._beams[view[0]],
                goodbeams_mask=self._goodbeams_mask[view[0]])
        out = super().__getitem__(view)
        if isinstance(out, VaryingResolutionOneDSpectrum):
            out._beams = self._beams[spec_idx]
        return out

    def _1d_spectrum(self, arr, wcs, meta, mask, spec_view=slice(None)):
        # the beams are cut with the spectral view (reference
        # lower_dimensional_structures.py:765-772)
        return VaryingResolutionOneDSpectrum(
            arr, unit=self.unit, wcs=wcs, meta=meta, mask=mask,
            header=self._nowcs_header, beams=self._beams[spec_view],
            goodbeams_mask=self._goodbeams_mask[spec_view])

    def jtok_factors(self, equivalencies=()):
        """Per-channel K/(Jy/beam) factors (reference base_class.py:481)."""
        freqs = self.with_spectral_unit(u.Hz).spectral_axis
        return np.array([b.jtok(Quantity(f, "Hz")).value
                         for b, f in zip(self._beams,
                                         np.asarray(freqs.value))])
