"""Spectral stacking and Fourier shifting.

Port of ``spectral_cube_tpu/analysis_utilities.py`` (reference
analysis_utilities.py: ``fourier_shift`` :14-94, ``stack_spectra``
:134-318, ``stack_cube`` :321-432).  Every spaxel's spectrum shifts in one
batched ``torch.fft`` transform with a phase ramp of its own, in complex64
on the cube's device, and the NaN mask shifts beside the data as the
reference does.  ``stack_cube``'s convolution of a varying-resolution slab
and its spectral interpolation run through the cube's own methods.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from . import units as u
from .units import Quantity
from .utils import BadVelocitiesWarning
from .beams import NoBeamError
from .lower_dimensional_structures import (OneDSpectrum,
                                           VaryingResolutionOneDSpectrum)

__all__ = ["fourier_shift", "stack_spectra", "stack_cube", "get_chunks"]


def get_chunks(num_items, chunk):
    """``range(num_items)`` in arrays of ``chunk`` items and a remainder
    (reference analysis_utilities.py:97-126, the same split points); kept
    for API compatibility, since stacking here is one batched transform."""
    items = np.arange(int(num_items))
    if num_items == chunk:
        return [items]
    chunks = np.array_split(items, [chunk * i for i in
                                    range(int(num_items / chunk))])
    if chunks and chunks[-1].size == 0:
        chunks = chunks[:-1]
    if chunks and chunks[0].size == 0:
        chunks = chunks[1:]
    return chunks


def _fourier_shift_batch(specs, shifts):
    """Shift each row of the (nspec, nchan) float32 tensor ``specs`` by its
    own fractional pixel count ``shifts`` (nspec,) with an FFT phase ramp
    in complex64.  NaNs shift with the data: an output whose shifted NaN
    mask exceeds 0.5 is NaN, and a row that was all NaN stays all NaN."""
    nanmask = ~torch.isfinite(specs)
    filled = torch.where(nanmask, 0.0, specs)
    m = torch.fft.fftfreq(specs.shape[1], device=specs.device)
    phase = torch.exp(-2j * np.pi * m[None, :]
                      * shifts.to(torch.float32)[:, None])

    def shift(x):
        return torch.fft.ifft(torch.fft.fft(x, dim=1) * phase, dim=1).real

    shifted = shift(filled)
    mask_shift = shift(nanmask.to(filled.dtype))
    out = torch.where(mask_shift > 0.5, float("nan"), shifted)
    return torch.where(nanmask.all(1, keepdim=True), float("nan"), out)


def fourier_shift(x, shift, axis=0, add_pad=False, pad_size=None,
                  device=None):
    """Shift an array along ``axis`` by ``shift`` pixels in the Fourier
    plane (reference analysis_utilities.py:14-94), on ``device`` (the CUDA
    device unless the caller asks for another), as float32.  With
    ``add_pad`` the axis is first padded with zeros on the side the data
    moves to (``pad_size`` overrides).  Returns a host array."""
    from .cube import _as_tensor
    x = np.asarray(x, dtype=float)
    nanmask = ~np.isfinite(x)
    if nanmask.all() and not add_pad:
        return x
    if add_pad:
        if pad_size is None:
            pad = int(np.ceil(abs(shift)))
            pad_size = (pad, 0) if shift > 0 else (0, pad)
        pads = [(0, 0)] * x.ndim
        pads[axis] = pad_size
        # valid zeros, not NaN, so the padding does not shift into the data
        x = np.pad(x, pads, mode="constant", constant_values=0.0)
        nanmask = ~np.isfinite(x)
    if nanmask.all():
        return np.full(x.shape, np.nan)
    moved = np.moveaxis(x, axis, -1)
    flat = _as_tensor(moved.reshape(-1, moved.shape[-1]), device)
    shifts = torch.full((flat.shape[0],), float(shift), dtype=torch.float32,
                        device=flat.device)
    out = _fourier_shift_batch(flat, shifts).cpu().numpy()
    return np.moveaxis(out.reshape(moved.shape), -1, axis)


def stack_spectra(cube, velocity_surface, v0=None, stack_function=None,
                  xy_posns=None, num_cores=None, chunk_size=-1,
                  progressbar=False, pad_edges=True, vdiff_tol=0.01,
                  weights=None):
    """Shift every spaxel's spectrum by a velocity surface and stack them
    (the JAX package's analysis_utilities.py:102-216, reference
    analysis_utilities.py:134-318): fractional pixel shifts
    ``(velocity_surface - v0) / dv`` with the sign of the spectral axis,
    zero padding on both ends so that no spectrum wraps (``pad_edges``),
    the NaN mask shifted along, then ``stack_function`` over the spectra
    (default nanmean; ``weights`` gives a weighted mean).  The shifts run
    on the cube's device; the stack on the host."""
    if isinstance(velocity_surface, Quantity):
        vel = velocity_surface
    else:
        vel = Quantity(np.asarray(velocity_surface),
                       cube.spectral_axis.unit)
    velv = np.asarray(vel.to_value(cube.spectral_axis.unit), dtype=float)
    if not np.isfinite(velv).any():
        raise ValueError("velocity_surface contains no finite values.")
    if velv.shape != cube.shape[1:]:
        raise ValueError("Velocity surface map does not match cube spatial "
                         "dimensions.")
    if xy_posns is None:
        xy_posns = np.where(np.isfinite(velv))

    sv = np.asarray(cube.spectral_axis.value, dtype=float)
    if v0 is None:
        v0v = sv.mean()
    else:
        if not isinstance(v0, Quantity):
            raise ValueError("v0 must be a quantity.")
        v0v = float(v0.to_value(cube.spectral_axis.unit))
        if v0v < sv.min() or v0v > sv.max():
            raise ValueError("v0 must be within the range of the spectral "
                             "axis of the cube.")

    dv = sv[1] - sv[0]
    dv2 = sv[-1] - sv[-2]
    if not np.isclose(abs(dv2), abs(dv), rtol=vdiff_tol):
        raise ValueError("Cannot shift spectra on a non-linear axis")
    vdiff_sign = -1.0 if dv > 0 else 1.0
    vdiff = abs(dv)

    vmax, vmin = sv.max(), sv.min()
    fin = np.isfinite(velv)
    if np.any(velv[fin] > vmax) or np.any(velv[fin] < vmin):
        warnings.warn("Some velocities are outside the allowed range and "
                      "will be masked out.", BadVelocitiesWarning)
        velv = np.where((velv < vmax) & (velv > vmin), velv, np.nan)
        xy_posns = np.where(np.isfinite(velv))
        if xy_posns[0].size == 0:
            raise ValueError(
                "All velocities in velocity_surface are outside the "
                f"cube's spectral range [{vmin:g}, {vmax:g}] "
                f"{cube.spectral_axis.unit}; nothing to stack.")

    shifts = (vdiff_sign * (velv - v0v) / vdiff)[xy_posns]
    if pad_edges:
        pad_lo = -min(int(np.ceil(np.nanmin(shifts))), 0)
        pad_hi = max(int(np.ceil(np.nanmax(shifts))), 0)
    else:
        pad_lo = pad_hi = 0

    data = cube._get_filled_data(fill=np.nan)
    dev = data.device
    specs = data.permute(1, 2, 0)[
        torch.as_tensor(np.asarray(xy_posns[0]), device=dev),
        torch.as_tensor(np.asarray(xy_posns[1]), device=dev)]
    del data
    if pad_lo or pad_hi:
        specs = F.pad(specs, (pad_lo, pad_hi), value=0.0)
    arr = _fourier_shift_batch(
        specs, torch.as_tensor(shifts, dtype=torch.float32, device=dev))
    arr = arr.cpu().numpy()
    del specs

    if weights is not None:
        if stack_function is not None:
            # a bare stack_function(arr * w) counts zero-weight rows as
            # valid zeros and scales with the mean weight
            raise ValueError(
                "weights are only supported with the default "
                "weighted-mean stacking; fold your weighting into "
                "stack_function instead")
        wv = np.asarray(weights, dtype=float)[xy_posns][:, None]
        num = np.nansum(arr * wv, axis=0)
        den = np.where(np.isfinite(arr), wv, 0.0).sum(axis=0)
        stacked = np.where(den > 0, num / np.where(den > 0, den, 1), np.nan)
    elif stack_function is None:
        stacked = np.nanmean(arr, axis=0)
    else:
        stacked = stack_function(arr, axis=0)

    # the same spectral sampling, crpix moved by the left padding
    new_wcs = cube._wcs.spectral.deepcopy()
    new_wcs.crpix[0] += pad_lo
    if hasattr(cube, "beams"):
        return VaryingResolutionOneDSpectrum(
            stacked, unit=cube.unit, wcs=new_wcs, meta=dict(cube.meta),
            beams=cube.unmasked_beams)
    return OneDSpectrum(stacked, unit=cube.unit, wcs=new_wcs,
                        meta=dict(cube.meta),
                        beam=getattr(cube, "_beam", None))


def stack_cube(cube, linelist, vmin, vmax, average=None, convolve_beam=None,
               return_hdu=False, return_cutouts=False):
    """Stack several spectral lines onto a common velocity grid (the JAX
    package's analysis_utilities.py:219-299, reference
    analysis_utilities.py:321-432): for each line and cube a velocity slab
    (lines whose slab holds at most one channel are skipped), a
    varying-resolution slab convolved to ``convolve_beam``, every slab
    interpolated onto the first one's grid, then their NaN mean on the
    device (or ``average`` on the host).  ``cube`` may be a list of cubes
    on one spatial grid; the result has no rest frequency and records
    ``meta['stacked_lines']``."""
    from .cube import VaryingResolutionSpectralCube

    if isinstance(cube, (list, tuple)):
        cubes = list(cube)
        cube = cubes[0]
        for cb in cubes[1:]:
            if cb.shape[1:] != cube.shape[1:]:
                raise ValueError("If you pass multiple cubes, they must "
                                 "have the same spatial shape.")
        if convolve_beam is None:
            try:
                beams_differ = not all(cb.beam == cube.beam
                                       for cb in cubes[1:])
            except (ValueError, AttributeError, NoBeamError):
                beams_differ = False  # beam-less cubes stack as they are
            if any(hasattr(cb, "beams") for cb in cubes) or beams_differ:
                raise ValueError("If the cubes have different resolution, "
                                 "`convolve_beam` must be specified.")
    else:
        cubes = [cube]
    if not hasattr(linelist, "__len__"):
        linelist = [linelist]

    slabs = []
    included_lines = []
    for restval in linelist:
        for cb in cubes:
            line_cube = cb.with_spectral_unit(u.km_s,
                                              velocity_convention="radio",
                                              rest_value=restval)
            line_cutout = line_cube.spectral_slab(vmin, vmax)
            if line_cutout.shape[0] <= 1:
                continue
            included_lines.append(restval)
            if isinstance(line_cutout, VaryingResolutionSpectralCube):
                if convolve_beam is None:
                    raise ValueError(
                        "If any of the input cubes have varying resolution,"
                        " a target `convolve_beam` must be specified.")
                line_cutout = line_cutout.convolve_to(convolve_beam)
            slabs.append(line_cutout)
    if not slabs:
        raise ValueError("No line in linelist falls inside any cube's "
                         "spectral range.")

    reference_cube = slabs[0]
    reference_grid = Quantity(
        np.asarray(reference_cube.spectral_axis.value),
        reference_cube.spectral_axis.unit)
    cutouts = [reference_cube]
    for slab in slabs[1:]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cutouts.append(slab.spectral_interpolate(reference_grid))

    stacked = torch.stack([c._get_filled_data(fill=np.nan) for c in cutouts])
    if average is None:
        out = torch.nanmean(stacked, dim=0)
    else:
        out = torch.as_tensor(average(stacked.cpu().numpy(), axis=0),
                              device=stacked.device)
    new_wcs = reference_cube._wcs.copy()
    new_wcs.restfrq = 0.0  # the rest frequency is no longer defined
    meta = dict(reference_cube.meta)
    meta["stacked_lines"] = included_lines
    result = reference_cube._new_cube_with(data=out, mask=None, wcs=new_wcs,
                                           meta=meta)
    retval = result.hdu if return_hdu else result
    if return_cutouts:
        return retval, [c._get_filled_data(fill=np.nan).cpu().numpy()
                        for c in cutouts]
    return retval
