"""Beam convolution of cubes: SVD-separable taps, or batched FFTs.

Port of ``spectral_cube_tpu/ops/convolve.py``.  Semantics matched:
astropy ``convolve`` with boundary zero-fill, ``nan_treatment=
'interpolate'`` (normalized convolution), ``normalize_kernel=True``;
Jy/beam data are rescaled by the beam-area ratio (reference
spectral_cube.py:3374-3378).  A Gaussian kernel, even a rotated elliptical
one, has small numerical rank, so it splits into r pairs of 1-D taps that
kernel 2 (``kernels/conv_sep.py``) applies per channel.  The JAX package's
route rules hold: one beam group takes the separable route at rank <= 8,
several groups the per-channel separable route at rank <= 4, and anything
else the FFT route, batched ``torch.fft.rfft2``/``irfft2`` with one
transfer function per beam group (cuFFT on the card, as ``jnp.fft`` is
XLA's FFT in the JAX package).

Not ported: the DFT-as-matmul branch of the FFT route
(``_use_dft_matmul``, ``_spectral_apply_rdft``), which the JAX package
takes on a TPU backend only, and its ``max_plane=1024`` gate on the
per-channel separable route, which bounds TPU memory for a matrix gather
that kernel 2 does not make (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..beams import Beam
from ..units import Unit
from ..kernels.conv_sep import conv_sep
from ..utils import takes_numpy
from .reductions import finite
from .smoothing import _banded_conv_matrix, banded_tap_offset

__all__ = ["separable_factors", "convolve2d_separable",
           "convolve_per_channel_separable", "convolve_cube_to_beam",
           "convolve2d_nan_fft", "convolve_image_to_beam",
           "beam_unit_factor", "beam_groups", "fft_shape"]

# normalized-convolution denominator floor shared with every route
# (the JAX package's ops/convolve.py:303)
_DEN_EPS = 1e-6

# float32 bytes of one padded plane batch of the FFT route; larger cubes
# run in channel chunks
_FFT_CHUNK_BYTES = 2 ** 28


def fft_shape(n):
    """Next fast EVEN FFT size >= n (2 * products of 2/3/5).  Must be
    even: the rfft2-format transfers carry fx//2+1 columns, from which
    :func:`_convolve_planes` reconstructs fx = 2*(half-1)."""
    best = 1 << max((int(n) - 1).bit_length(), 1)
    m = 2
    while m < n * 2:
        for f in (1, 3, 5, 9, 15):
            c = m * f
            if c >= n and c < best:
                best = c
        m *= 2
    return best


def _padded_shape(img_shape, kernel_shape):
    ny, nx = img_shape
    ky, kx = kernel_shape
    return fft_shape(ny + ky - 1), fft_shape(nx + kx - 1)


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _transfers(kernels, fy, fx, device, dtype=torch.complex64):
    """(ngroup, fy, fx//2+1) transfers of ``kernels`` (None is the
    identity) in ``dtype``: the rfft2 of each kernel zero-padded to
    (fy, fx) with its (k-1)//2 entry at (0, 0), so that the convolution
    does not translate the image (the JAX package's ``_kernel_transfer``,
    ops/convolve.py:67-77), computed on ``device``.  The host stacks the kernels, each placed so that its
    (k-1)//2 entry sits at a shared centre, in a box as small as the
    largest kernel; the device zero-pads the box to (fy, fx), rolls the
    centre to (0, 0), transforms in float64 and casts, in group chunks (the JAX package builds complex128 transfers on the host
    and casts them in ``_convolve_planes``)."""
    ks = [np.ones((1, 1)) if k is None else np.asarray(k, np.float64)
          for k in kernels]
    cy = max((k.shape[0] - 1) // 2 for k in ks)
    cx = max((k.shape[1] - 1) // 2 for k in ks)
    by = max(cy - (k.shape[0] - 1) // 2 + k.shape[0] for k in ks)
    bx = max(cx - (k.shape[1] - 1) // 2 + k.shape[1] for k in ks)
    box = np.zeros((len(ks), by, bx), np.float64)
    for g, k in enumerate(ks):
        oy, ox = cy - (k.shape[0] - 1) // 2, cx - (k.shape[1] - 1) // 2
        box[g, oy:oy + k.shape[0], ox:ox + k.shape[1]] = k
    box = torch.as_tensor(box, device=device)
    out = torch.empty((len(ks), fy, fx // 2 + 1), dtype=dtype,
                      device=device)
    step = max(1, _FFT_CHUNK_BYTES // (fy * fx * 8))
    for g0 in range(0, len(ks), step):
        pad = torch.zeros((min(step, len(ks) - g0), fy, fx),
                          dtype=torch.float64, device=device)
        pad[:, :by, :bx] = box[g0:g0 + step]
        pad = torch.roll(pad, (-cy, -cx), dims=(1, 2))
        out[g0:g0 + step] = torch.fft.rfft2(pad).to(dtype)
    return out


def _fft_channels(fy, fx):
    """Channels of one batch of the FFT route: :data:`_FFT_CHUNK_BYTES` of
    padded float32 planes."""
    return max(1, _FFT_CHUNK_BYTES // (fy * fx * 4))


def _convolve_planes(data, transfers, group_idx):
    """Convolve each channel of (nchan, ny, nx) ``data`` with its group's
    transfer (the JAX package's ops/convolve.py:244-310, rfft2 branch):
    ``transfers`` (ngroup, fy, fx//2+1) complex, ``group_idx`` (nchan,).

    NaN-interpolating normalized convolution: num = conv(where(finite, x,
    0)), den = 1 - conv(~finite), NaN where den <= 1e-6, all-NaN planes
    NaN.  A channel with no non-finite value returns num: its den is 1
    exactly, so the JAX package's all-or-nothing shortcut and this
    per-channel one give the same values.  Channels run in chunks of
    :data:`_FFT_CHUNK_BYTES`."""
    nchan, ny, nx = data.shape
    fy = transfers.shape[1]
    fx = 2 * (transfers.shape[2] - 1)
    real = torch.float64 if data.dtype == torch.float64 else torch.float32
    tr = transfers.to(_complex_of(real))
    gidx = torch.as_tensor(np.asarray(group_idx, np.int64),
                           device=data.device)
    out = torch.empty((nchan, ny, nx), dtype=real, device=data.device)
    step = _fft_channels(fy, fx)
    for c0 in range(0, nchan, step):
        x = data[c0:c0 + step]
        t = tr.index_select(0, gidx[c0:c0 + step])

        def conv2(a):
            return torch.fft.irfft2(torch.fft.rfft2(a, s=(fy, fx)) * t,
                                    s=(fy, fx))[:, :ny, :nx]

        valid = finite(x)
        num = conv2(torch.where(valid, x, 0).to(real))
        dirty = ~valid.flatten(1).all(1)
        if bool(dirty.any()):
            den = 1.0 - conv2((~valid).to(real))
            ok = den > _DEN_EPS
            o = torch.where(ok, num / torch.where(ok, den, 1.0),
                            float("nan"))
            any_valid = valid.flatten(1).any(1)[:, None, None]
            o = torch.where(any_valid, o, float("nan"))
            num = torch.where(dirty[:, None, None], o, num)
        out[c0:c0 + step] = num
    return out.to(data.dtype)


def _convolve_groups_fft(data, kernels, group_idx, fy, fx):
    """:func:`_convolve_planes` of (nchan, ny, nx) ``data`` with channel c
    convolved by ``kernels[group_idx[c]]`` (None is the identity) on
    (fy, fx) planes, one :func:`_fft_channels` batch at a time, each batch
    with the transfers of the groups it uses alone (the JAX package builds
    every group's transfer at once for ops/convolve.py:244-310: at 2302
    beam groups on 1152² planes, 11.4 GiB beside a 9 GiB cube).  A
    transfer's values do not depend on which groups are built beside it
    (:func:`_transfers`), and the batches are :func:`_convolve_planes`'
    own, so the values are those of one call with every transfer."""
    return _convolve_batches(data, group_idx, fy, fx,
                             lambda used: _transfers(
                                 [kernels[g] for g in used], fy, fx,
                                 data.device, _complex_of(data.dtype)))


def _convolve_batches(data, group_idx, fy, fx, transfers_of):
    """:func:`_convolve_planes` of (nchan, ny, nx) ``data`` on (fy, fx)
    planes, one :func:`_fft_channels` batch at a time, each batch with
    ``transfers_of(groups)``, the transfers of the beam groups it uses
    (ascending) alone: the FFT route's one cube-sized allocation is its
    output."""
    nchan = data.shape[0]
    gidx = np.asarray(group_idx, np.int64)
    out = torch.empty(data.shape, dtype=data.dtype, device=data.device)
    step = _fft_channels(fy, fx)
    for c0 in range(0, nchan, step):
        used, local = np.unique(gidx[c0:c0 + step], return_inverse=True)
        tr = transfers_of(used)
        out[c0:c0 + step] = _convolve_planes(data[c0:c0 + step], tr, local)
        del tr
    return out


@takes_numpy
def convolve2d_nan_fft(data, kernel):
    """NaN-interpolating normalized FFT convolution of (ny, nx) or
    (nchan, ny, nx) ``data`` with one 2-D kernel, normalized to sum 1.
    A tensor gives a tensor on its device, numpy data a numpy result
    (:func:`~..utils.takes_numpy`)."""
    k = np.asarray(kernel, dtype=float)
    single = data.ndim == 2
    if single:
        data = data[None]
    fy, fx = _padded_shape(data.shape[1:], k.shape)
    out = _convolve_planes(data, _transfers([k / k.sum()], fy, fx,
                                            data.device,
                                            _complex_of(data.dtype)),
                           np.zeros(data.shape[0], np.int64))
    return out[0] if single else out


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


def beam_groups(beam_list):
    """``(groups, group_idx)``: channel i joins the first group whose
    beam equals its own (``Beam.__eq__``), else opens a new one, as the
    JAX package's pairwise scan groups them (ops/convolve.py:572-582).
    ``Beam.__eq__`` is evaluated here with numpy against all groups at
    once, in the same float64 arithmetic, so the groups are the scan's
    without its O(groups^2) Python comparisons (0.8 s for 623 distinct
    beams, PERF.md)."""
    maj = np.array([b.major_rad for b in beam_list], np.float64)
    mnr = np.array([b.minor_rad for b in beam_list], np.float64)
    pa = np.array([b.pa_rad for b in beam_list], np.float64)
    fin = np.array([b.isfinite for b in beam_list], bool)
    reps = np.zeros(len(beam_list), np.int64)
    group_idx = np.zeros(len(beam_list), dtype=np.int32)
    ngroups = 0
    with np.errstate(invalid="ignore"):
        for i in range(len(beam_list)):
            r = reps[:ngroups]
            if fin[i]:
                circ = maj[i] - mnr[i] < 1e-12 * maj[i]
                pa_match = circ | (np.abs(np.mod(
                    pa[i] - pa[r] + np.pi / 2, np.pi) - np.pi / 2) < 1e-8)
                eq = fin[r] & pa_match & _isclose(maj[i], maj[r]) \
                    & _isclose(mnr[i], mnr[r])
            else:
                eq = ~fin[r]
            hit = np.flatnonzero(eq)
            if hit.size:
                group_idx[i] = hit[0]
            else:
                reps[ngroups] = i
                group_idx[i] = ngroups
                ngroups += 1
    return [beam_list[k] for k in reps[:ngroups]], group_idx


def _isclose(a, b, rel_tol=1e-10):
    """``math.isclose(a, b, rel_tol=rel_tol)`` for finite values."""
    return np.abs(a - b) <= rel_tol * np.maximum(np.abs(a), np.abs(b))


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
    Jy/beam rescale (ones if not applicable).

    ``convolve_cube_to_beam.last`` describes the latest call: its
    ``route`` ('identity', 'separable', 'per_channel_separable' or
    'fft'), the number of beam ``groups``, and the host seconds of the
    pairwise grouping (``grouping_s``) and of the kernels and the route
    choice (``kernels_s``)."""
    nchan, ny, nx = data.shape
    t0 = time.perf_counter()
    beam_list = [beams] * nchan if isinstance(beams, Beam) else list(beams)
    groups, group_idx = beam_groups(beam_list)
    t1 = time.perf_counter()

    kernels = []
    max_k = (1, 1)
    for b in groups:
        conv_beam = target.deconvolve(b)
        if conv_beam.major_rad <= 0:
            kernels.append(None)
            continue
        k = conv_beam.as_kernel(pixscale_rad)
        kernels.append(k)
        max_k = (max(max_k[0], k.shape[0]), max(max_k[1], k.shape[1]))

    out, route = None, None
    if len(groups) == 1:
        k = kernels[0]
        if k is None:
            out, route = data, "identity"
        elif k.shape[0] <= 2 * ny:
            out, route = convolve2d_separable(data, k), "separable"
    if out is None and all(k is None or k.shape[0] <= 2 * ny
                           for k in kernels):
        out = convolve_per_channel_separable(data, kernels, group_idx)
        route = "per_channel_separable"
    t2 = time.perf_counter()
    if out is None:
        fy, fx = _padded_shape((ny, nx), max_k)
        out = _convolve_groups_fft(data, kernels, group_idx, fy, fx)
        route = "fft"
    convolve_cube_to_beam.last = {"route": route, "groups": len(groups),
                                  "grouping_s": t1 - t0,
                                  "kernels_s": t2 - t1}

    factors = np.ones(nchan)
    if unit is not None:
        for i, b in enumerate(beam_list):
            factors[i] = beam_unit_factor(unit, b, target)
    if goodchannels is not None:
        bad = ~np.asarray(goodchannels)
        if bad.any():
            # every route but the identity made ``out`` here: its bad
            # planes are written in place, the caller's data left alone
            if route == "identity":
                out = out.clone()
            out[torch.as_tensor(np.where(bad)[0], device=out.device)] = \
                float("nan")
    return out, factors


convolve_cube_to_beam.last = {}


def convolve_image_to_beam(img, current: Beam, target: Beam, wcs,
                           unit: Unit = None, device=None):
    """2-D Projection convolution (reference
    lower_dimensional_structures.py:450-494) on the FFT route, as the JAX
    package's ops/convolve.py:640-654.  ``img`` lands on ``device`` as the
    cube entry points place an array (the CUDA device by default).
    Returns (host float32 image, Jy/beam factor)."""
    from ..cube import _as_tensor
    pixscale = float(np.mean(np.abs(
        wcs.celestial.proj_plane_pixel_scales()))) * np.pi / 180.0
    data = _as_tensor(img, device)
    conv_beam = target.deconvolve(current)
    if conv_beam.major_rad <= 0:
        out = data
    else:
        out = convolve2d_nan_fft(data, conv_beam.as_kernel(pixscale))
    factor = beam_unit_factor(unit, current, target) if unit is not None \
        else 1.0
    return out.cpu().numpy(), factor
