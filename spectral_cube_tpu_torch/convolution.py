"""Convolution kernel objects (astropy.convolution stand-ins).

The reference's smoothing API takes ``astropy.convolution`` kernel
objects (reference ``spectral_cube.py:2810-2840``, ``:3188-3220``); since
astropy is not a dependency of this build, these classes reproduce the
same discretization so ``cube.spatial_smooth(Gaussian2DKernel(3))`` gives
numbers identical to the reference's.  Discretization follows
``astropy.convolution.utils.discretize_model``: Gaussian/Tophat kernels
sample the model at pixel centers (mode ``'center'``), Box kernels use
the linear-interpolation mode (fractional edge weights); every kernel is
normalized to unit sum.  Validated against the reference test suite's
hard-coded expected arrays in ``tests/test_ref_values.py``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["Kernel", "Kernel1D", "Kernel2D", "CustomKernel",
           "Gaussian1DKernel", "Gaussian2DKernel", "Box1DKernel",
           "Box2DKernel", "Tophat2DKernel"]


def _round_up_to_odd_integer(value):
    i = math.ceil(value)
    return i + 1 if i % 2 == 0 else i


def _unitless_width(value):
    """Kernel widths are in pixels: reject unit-ful Quantities like the
    reference ("The convolution kernel should be defined without a
    unit.", dask_spectral_cube.py kernel checks / astropy kernels)."""
    from .units import Quantity, UnitsError
    if isinstance(value, Quantity):
        if not value.unit.dimensionless:
            raise UnitsError("The convolution kernel should be defined "
                             "without a unit.")
        return float(value.value)
    return float(value)


class Kernel:
    """Base kernel: holds the discretized, normalized array."""

    def __init__(self, array):
        self._array = np.asarray(array, dtype=float)

    @property
    def array(self):
        return self._array

    @property
    def shape(self):
        return self._array.shape

    def normalize(self):
        s = self._array.sum()
        if s == 0:
            raise ValueError("The kernel cannot be normalized because it "
                             "sums to zero.")
        self._array = self._array / s

    def __array__(self, dtype=None, copy=None):
        a = self._array
        return a.astype(dtype) if dtype is not None else a


class Kernel1D(Kernel):
    pass


class Kernel2D(Kernel):
    pass


class CustomKernel(Kernel):
    """Kernel from a user-supplied array (astropy CustomKernel):
    accepts 1-D or 2-D odd-shaped arrays, not normalized automatically."""

    def __init__(self, array):
        array = np.asarray(array, dtype=float)
        if array.ndim not in (1, 2):
            raise ValueError("array must be 1- or 2-dimensional")
        if any(s % 2 == 0 for s in array.shape):
            raise ValueError("kernel must have odd dimensions")
        super().__init__(array)


def _centers(size):
    return np.arange(size, dtype=float) - (size - 1) / 2.0


class Gaussian1DKernel(Kernel1D):
    """1-D Gaussian sampled at pixel centers, support 8*stddev rounded up
    to odd (astropy Gaussian1DKernel, mode='center'), unit sum."""

    def __init__(self, stddev, x_size=None):
        stddev = _unitless_width(stddev)
        if x_size is None:
            x_size = _round_up_to_odd_integer(8 * stddev)
        x = _centers(x_size)
        arr = np.exp(-0.5 * (x / stddev) ** 2)
        super().__init__(arr)
        self.normalize()


class Gaussian2DKernel(Kernel2D):
    """2-D Gaussian sampled at pixel centers (astropy Gaussian2DKernel
    with x_stddev [= y_stddev], optional rotation theta in radians)."""

    def __init__(self, x_stddev, y_stddev=None, theta=0.0,
                 x_size=None, y_size=None):
        x_stddev = _unitless_width(x_stddev)
        y_stddev = x_stddev if y_stddev is None else _unitless_width(y_stddev)
        if x_size is None:
            x_size = _round_up_to_odd_integer(8 * max(x_stddev, y_stddev))
        if y_size is None:
            y_size = x_size
        x = _centers(x_size)
        y = _centers(y_size)
        xx, yy = np.meshgrid(x, y)
        ct, st = np.cos(theta), np.sin(theta)
        xr = xx * ct + yy * st
        yr = -xx * st + yy * ct
        arr = np.exp(-0.5 * ((xr / x_stddev) ** 2 + (yr / y_stddev) ** 2))
        super().__init__(arr)
        self.normalize()


class Tophat2DKernel(Kernel2D):
    """Circular top-hat of the given pixel radius, sampled at pixel
    centers: 1 where hypot(x, y) <= radius (astropy Disk2D + 'center'),
    support 2*radius rounded up to odd, unit sum."""

    def __init__(self, radius):
        radius = _unitless_width(radius)
        size = _round_up_to_odd_integer(2 * radius)
        x = _centers(size)
        xx, yy = np.meshgrid(x, x)
        arr = (np.hypot(xx, yy) <= radius).astype(float)
        super().__init__(arr)
        self.normalize()


def _box_profile_1d(width, size):
    """astropy Box1D discretized with mode='linear_interp': evaluate the
    closed box [x0 - w/2, x0 + w/2] on the half-pixel grid and average
    adjacent samples, giving fractional weights at the edges (so
    Box1DKernel(3) is exactly [1/3, 1/3, 1/3] and Box1DKernel(2) is
    [1/4, 1/2, 1/4])."""
    width = float(width)
    edges = np.arange(size + 1, dtype=float) - size / 2.0
    vals = ((edges >= -width / 2.0) & (edges <= width / 2.0)).astype(float)
    return 0.5 * (vals[1:] + vals[:-1])


class Box1DKernel(Kernel1D):
    """1-D boxcar with linear-interpolated (fractional) edges (astropy
    Box1DKernel, mode='linear_interp'), unit sum."""

    def __init__(self, width):
        width = _unitless_width(width)
        size = _round_up_to_odd_integer(width)
        super().__init__(_box_profile_1d(width, size))
        self.normalize()


class Box2DKernel(Kernel2D):
    """2-D boxcar, separable product of two linear-interp 1-D boxes
    (astropy Box2DKernel), unit sum."""

    def __init__(self, width):
        width = _unitless_width(width)
        size = _round_up_to_odd_integer(width)
        p = _box_profile_1d(width, size)
        super().__init__(np.outer(p, p))
        self.normalize()
