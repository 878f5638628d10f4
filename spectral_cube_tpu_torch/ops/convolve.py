"""Beam convolution of cubes through SVD-separable taps.

Port of ``spectral_cube_tpu/ops/convolve.py`` for separable kernels.
Semantics matched: astropy ``convolve`` with boundary zero-fill,
``nan_treatment='interpolate'`` (normalized convolution),
``normalize_kernel=True``; Jy/beam data are rescaled by the beam-area
ratio (reference spectral_cube.py:3374-3378).  A Gaussian kernel, even a
rotated elliptical one, has small numerical rank, so it splits into r
pairs of 1-D taps that kernel 2 (``kernels/conv_sep.py``) applies per
channel.  Kernels that do not separate take the FFT path of the JAX
package, which this port does not have yet: they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..beams import Beam
from ..units import Unit
from ..kernels.conv_sep import conv_sep
from .smoothing import _banded_conv_matrix, banded_tap_offset

__all__ = ["separable_factors", "convolve2d_separable",
           "convolve_per_channel_separable", "convolve_cube_to_beam",
           "beam_unit_factor"]

_FFT_PATH = ("non-separable kernels take the FFT path, which the torch "
             "port does not have yet (ROADMAP.md Queue 1 item 5)")


def _conv_matrix_1d(n, taps):
    """(n, n) banded true-convolution matrix for 1-D taps."""
    return _banded_conv_matrix(n, taps)


def separable_factors(kernel, tol=1e-7, max_rank=8):
    """SVD-separate a 2-D kernel into rank-r 1-D tap pairs.

    Returns (ytaps (ky, r), xtaps (kx, r)) or None if rank > max_rank."""
    k = np.asarray(kernel, dtype=np.float64)
    U, s, Vt = np.linalg.svd(k)
    r = int(np.sum(s > s[0] * tol))
    if r == 0:
        r = 1
    if r > max_rank:
        return None
    return U[:, :r] * s[:r], Vt[:r, :].T


def _tap_stack(taps_per_group):
    """Flipped float32 taps of every group and rank in one (G, r, L) array
    with one centre offset h, as ``_banded_conv_matrix`` places them: each
    group's taps sit where its own offset puts them, zero elsewhere (a
    shorter or lower-rank group pads with zeros)."""
    heads = [banded_tap_offset(t.shape[0]) for t in taps_per_group]
    tails = [t.shape[0] - 1 - h for t, h in zip(taps_per_group, heads)]
    h, tail = max(heads), max(tails)
    r = max(t.shape[1] for t in taps_per_group)
    out = np.zeros((len(taps_per_group), r, h + tail + 1), np.float32)
    for g, (t, hg) in enumerate(zip(taps_per_group, heads)):
        flipped = np.asarray(t, dtype=np.float32)[::-1].T    # (r_g, L_g)
        out[g, :flipped.shape[0], h - hg:h - hg + flipped.shape[1]] = flipped
    return out, h


def _convolve_groups(data, ytaps_g, xtaps_g, group_idx):
    ys, hy = _tap_stack(ytaps_g)
    xs, hx = _tap_stack(xtaps_g)
    gi = torch.as_tensor(np.asarray(group_idx, dtype=np.int32),
                         device=data.device)
    return conv_sep(data, torch.as_tensor(ys), torch.as_tensor(xs), hy, hx,
                    gi)


def convolve2d_separable(data, kernel):
    """NaN-interpolating convolution of (nchan, ny, nx) data with one 2-D
    kernel via its SVD-separable taps; None when the kernel's rank exceeds
    8 (the JAX path then takes the FFT)."""
    factors = separable_factors(kernel)
    if factors is None:
        return None
    return _convolve_groups(data, [factors[0]], [factors[1]],
                            np.zeros(data.shape[0], np.int32))


def convolve_per_channel_separable(data, kernels, group_idx, max_rank=4):
    """NaN-interpolating per-channel convolution: channel c takes kernel
    ``kernels[group_idx[c]]`` (None = identity).  Returns None when a
    kernel is larger than twice the plane or has rank above ``max_rank``
    (the JAX path then takes the FFT)."""
    _, ny, nx = data.shape
    ytaps_g, xtaps_g = [], []
    for k in kernels:
        if k is None:
            ytaps_g.append(np.ones((1, 1)))
            xtaps_g.append(np.ones((1, 1)))
            continue
        if k.shape[0] > 2 * ny or k.shape[1] > 2 * nx:
            return None
        fac = separable_factors(k, max_rank=max_rank)
        if fac is None:
            return None
        ytaps_g.append(fac[0])
        xtaps_g.append(fac[1])
    return _convolve_groups(data, ytaps_g, xtaps_g, group_idx)


def beam_unit_factor(unit: Unit, current: Beam, target: Beam) -> float:
    """Jy/beam rescaling under a beam change (reference
    spectral_cube.py:3374-3378)."""
    from .. import units as u
    if unit.dims == (u.Jy / u.beam).dims:
        return float(target.sr.value / current.sr.value)
    return 1.0


def convolve_cube_to_beam(data, beams, target: Beam, pixscale_rad,
                          unit: Unit = None, goodchannels=None):
    """Convolve every channel of (nchan, ny, nx) ``data`` to ``target``.

    ``beams``: one Beam or a per-channel sequence; channels sharing a beam
    share one kernel.  Returns (out, factors), ``factors`` the per-channel
    Jy/beam rescale (ones if not applicable)."""
    nchan, ny, nx = data.shape
    beam_list = [beams] * nchan if isinstance(beams, Beam) else list(beams)
    groups = []
    group_idx = np.zeros(nchan, dtype=np.int32)
    for i, b in enumerate(beam_list):
        for gi, gb in enumerate(groups):
            if b == gb:
                group_idx[i] = gi
                break
        else:
            groups.append(b)
            group_idx[i] = len(groups) - 1

    kernels = []
    for b in groups:
        conv_beam = target.deconvolve(b)
        kernels.append(None if conv_beam.major_rad <= 0
                       else conv_beam.as_kernel(pixscale_rad))

    out = None
    if len(groups) == 1:
        k = kernels[0]
        if k is None:
            out = data
        elif k.shape[0] <= 2 * ny:
            out = convolve2d_separable(data, k)
    if out is None and all(k is None or k.shape[0] <= 2 * ny
                           for k in kernels):
        out = convolve_per_channel_separable(data, kernels, group_idx)
    if out is None:
        raise NotImplementedError(_FFT_PATH)

    factors = np.ones(nchan)
    if unit is not None:
        for i, b in enumerate(beam_list):
            factors[i] = beam_unit_factor(unit, b, target)
    if goodchannels is not None:
        bad = ~np.asarray(goodchannels)
        if bad.any():
            out = out.clone()
            out[torch.as_tensor(np.where(bad)[0], device=out.device)] = \
                float("nan")
    return out, factors
