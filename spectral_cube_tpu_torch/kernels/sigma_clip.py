"""Kernel 4: iterative per-spaxel sigma clip along the spectral axis.

:func:`sigma_clip` launches ``csrc/sigma_clip.cu`` for a CUDA tensor and
runs :func:`sigma_clip_plain`, the same function in plain PyTorch, for a
CPU tensor.  Both run the sorted-band algorithm of
``spectral_cube_tpu/ops/smoothing.py::sigma_clip_spectrally``: sort each
spectrum once (non-finite values missing), then ``maxiters`` times narrow
the band ``[i_lo, i_hi)`` of surviving sorted values to those inside
``centre +- sigma * std`` of the band (centre: the band's median or mean;
std: the band's population standard deviation, or its MAD standard
deviation in the plain version only), and keep a sample where it is finite
and inside the final band's value range.

Every float32 band sum runs in one fixed order, the kernel's: lane ``l``
of a warp adds the band's values at sorted positions ``l, l + 32, ...`` in
turn, then the 32 partial sums meet in an xor butterfly.  The plain
version adds in that same order, so on the same input the two agree
bitwise, thresholds included.

:func:`plan` decides the kernel's launch from the spectrum length: up to
1024 channels each warp sorts a spectrum in registers (``R`` values a
lane), longer spectra take the shared-memory network (``R = 0``).
"""

from __future__ import annotations

from collections import namedtuple

import torch

from ..ops.reductions import lane_tiles
from ._build import (load_library, check, ptr, stream_ptr, on_tensor_device,
                     count_launch)

__all__ = ["sigma_clip", "sigma_clip_plain", "LANES", "band_sum", "plan"]

#: global workspace of the kernel for spectra too long for shared memory
WORK_BYTES = 256 * 2 ** 20

#: lanes of the summation order (a warp)
LANES = 32

#: astropy.stats.mad_std's scale, 1 / Phi^-1(3/4)
MAD_TO_STD = 1.482602218505602

#: the register path's longest padded spectrum (32 values a lane)
REG_CHANNELS = 1024
#: warps of a register-path block, and the spaxels a block may stage
REG_WARPS = 8
REG_SPAXELS = (32, 16, 8)
#: H100: shared memory of an SM, and what the runtime keeps per block
SMEM_SM = 233472
SMEM_RESERVED = 1024
#: resident warps an SM the plan aims for: enough to hide the sort's
#: shuffle and shared-memory latency
WARPS_TARGET = 24

#: the launch of ``csrc/sigma_clip.cu``: ``R`` values a lane (0: the
#: shared-memory network for spectra past REG_CHANNELS, whose other
#: fields are 0), warps and spaxels a block, the block's shared bytes
Plan = namedtuple("Plan", "R warps spaxels smem")


def _reg_smem(nchan, R, warps, spaxels):
    """Shared bytes of a register-path block: the staged tile (spaxels
    rows of odd pitch), one sorted row of 33 R floats a warp, and lo, hi
    and keep_any per spaxel (``reg_shared_bytes`` in the source)."""
    return 4 * (spaxels * (nchan | 1) + warps * 33 * R + 3 * spaxels)


def plan(nchan):
    """The kernel's launch for spectra of ``nchan`` channels: the register
    class ``R = max(1, npad / 32)`` (npad the power of two at or above
    nchan) up to 1024 channels, else ``R = 0``; and the most spaxels a
    block (of 32, 16, 8) that leave WARPS_TARGET warps resident on an SM,
    or failing that the choice with the most."""
    nchan = int(nchan)
    if nchan < 1:
        raise ValueError(f"nchan must be >= 1, got {nchan}")
    npad = 1 << (nchan - 1).bit_length()
    if npad > REG_CHANNELS:
        return Plan(0, 0, 0, 0)
    R = max(1, npad // LANES)
    best = None
    for spaxels in REG_SPAXELS:
        smem = _reg_smem(nchan, R, REG_WARPS, spaxels)
        resident = REG_WARPS * (SMEM_SM // (smem + SMEM_RESERVED))
        choice = Plan(R, REG_WARPS, spaxels, smem)
        if resident >= WARPS_TARGET:
            return choice
        if best is None or resident > best[0]:
            best = (resident, choice)
    return best[1]


def _check_inputs(data, maxiters):
    if data.ndim < 1:
        raise ValueError("data must have a spectral axis")
    if int(maxiters) < 0:
        raise ValueError(f"maxiters must be >= 0, got {maxiters}")


@on_tensor_device
def sigma_clip(data, sigma, maxiters, use_mean_center):
    """Clipped copy of ``data`` (nchan, ...), spectral axis first: samples
    outside the final clip band, and non-finite samples, become NaN.
    stdfunc='std'.  A CPU tensor takes the plain version; a CUDA tensor
    the kernel, at any spectrum length: one call launches one kernel on
    the device, ``sigma_clip_reg_kernel`` up to 1024 channels, else
    ``sigma_clip_kernel``, except where a spaxel's rows outgrow shared
    memory (beyond ~25,000 channels), which launch ``sigma_clip_kernel``
    once per workspace chunk of spaxels."""
    _check_inputs(data, maxiters)
    if data.device.type == "cpu":
        return sigma_clip_plain(data, sigma, maxiters, use_mean_center)
    if data.device.type != "cuda":
        raise ValueError(f"no sigma_clip kernel for device {data.device}")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("the sigma_clip kernel takes contiguous float32 "
                         "data")
    lib = load_library()
    out = torch.empty_like(data)
    if data.numel() == 0:
        return out
    nchan = data.shape[0]
    nspax = data.numel() // nchan
    p = plan(nchan)
    if p.R and lib.sct_sigma_clip_smem(nchan, p.R, p.warps,
                                       p.spaxels) != p.smem:
        raise RuntimeError("csrc/sigma_clip.cu and kernels/sigma_clip.py "
                           "disagree on the register path's plan")
    per = lib.sct_sigma_clip_work(nchan)
    work, chunk = None, 0
    if per:
        chunk = min(nspax, max(1, WORK_BYTES // (4 * per)))
        work = torch.empty(chunk * per, dtype=torch.float32,
                           device=data.device)
    err = lib.sct_sigma_clip(ptr(data), nchan, nspax, float(sigma),
                             int(maxiters), int(bool(use_mean_center)),
                             p.R, p.warps, p.spaxels, ptr(work), chunk,
                             ptr(out), stream_ptr(data.device))
    check(err, "sct_sigma_clip")
    count_launch(sigma_clip)
    return out


sigma_clip.launches = 0


def band_sum(vals, in_band):
    """Sum along axis 0 of ``vals`` where ``in_band``, in the kernel's
    order: per lane l the values at rows l, l + 32, ... in turn, then an
    xor butterfly over the 32 lane sums."""
    n = vals.shape[0]
    rows = -(-n // LANES)
    masked = torch.where(in_band, vals, torch.zeros((), dtype=vals.dtype,
                                                    device=vals.device))
    if rows * LANES != n:
        pad = torch.zeros((rows * LANES - n,) + tuple(vals.shape[1:]),
                          dtype=vals.dtype, device=vals.device)
        masked = torch.cat([masked, pad])
    masked = masked.reshape((rows, LANES) + tuple(vals.shape[1:]))
    acc = torch.zeros_like(masked[0])
    for r in range(rows):
        acc = acc + masked[r]
    lanes = torch.arange(LANES, device=vals.device)
    off = LANES // 2
    while off:
        acc = acc + acc[lanes ^ off]
        off //= 2
    return acc[0]


def _at(s, idx, ok):
    """s[idx] along axis 0 where ``ok``, else 0 (the indicator-mask read
    of the jnp path)."""
    n = s.shape[0]
    g = torch.gather(s, 0, idx.clamp(0, max(n - 1, 0))[None].long())[0]
    return torch.where(ok, g, torch.zeros((), dtype=s.dtype, device=s.device))


def sigma_clip_plain(data, sigma, maxiters, use_mean_center,
                     use_mad_std=False):
    """The kernel's function in plain PyTorch, for any shape (spectral axis
    first) and float dtype, plus the MAD-std variant.  float32 data is
    computed in float32, anything else in float64, as the JAX package
    does.  Each spectrum is clipped on its own, so a cube past
    ``reductions.SORT_CHUNK`` voxels is clipped a tile of whole spectra
    at a time (``reductions.lane_tiles``), bit for bit the one call."""
    _check_inputs(data, maxiters)
    tiles = list(lane_tiles(data.shape, (0,)))
    if len(tiles) == 1:
        return _clip_plain(data, sigma, maxiters, use_mean_center,
                           use_mad_std)
    out = torch.empty(data.shape, dtype=data.dtype, device=data.device)
    for idx in tiles:
        out[idx] = _clip_plain(data[idx], sigma, maxiters, use_mean_center,
                               use_mad_std)
    return out


def _clip_plain(data, sigma, maxiters, use_mean_center, use_mad_std):
    """:func:`sigma_clip_plain` of one piece."""
    comp = torch.float32 if data.dtype == torch.float32 else torch.float64
    x = data.to(comp)
    n = x.shape[0]
    finite = torch.isfinite(x)
    # non-finite values are missing: NaN sorts last, as in jnp.sort
    s = torch.sort(torch.where(finite, x, float("nan")), dim=0).values
    tail = (1,) * (x.ndim - 1)
    iota = torch.arange(n, dtype=torch.int32,
                        device=x.device).reshape((n,) + tail)
    i_hi = finite.sum(0, dtype=torch.int32)
    i_lo = torch.zeros_like(i_hi)
    sigma = float(sigma)
    for _ in range(int(maxiters)):
        cnt = i_hi - i_lo
        some = cnt > 0
        safe = torch.clamp(cnt, min=1).to(comp)
        in_band = (iota >= i_lo[None]) & (iota < i_hi[None])
        mean = band_sum(s, in_band) / safe
        if not use_mean_center or use_mad_std:
            m_lo = i_lo + torch.div(cnt - 1, 2, rounding_mode="floor")
            m_hi = i_lo + torch.div(cnt, 2, rounding_mode="floor")
            med = (_at(s, m_lo, some) + _at(s, m_hi, some)) / 2
        center = mean if use_mean_center else med
        if use_mad_std:
            # astropy.stats.mad_std: 1.4826 * median(|x - median(x)|), the
            # MAD about the band MEDIAN whatever the centre
            dev = torch.where(in_band, (s - med[None]).abs(), float("inf"))
            dsort = torch.sort(dev, dim=0).values
            d_lo = torch.div(cnt - 1, 2, rounding_mode="floor")
            d_hi = torch.div(cnt, 2, rounding_mode="floor")
            mad = (_at(dsort, d_lo, some) + _at(dsort, d_hi, some)) / 2
            std = mad * MAD_TO_STD
        else:
            d = s - mean[None]
            var = band_sum(d * d, in_band) / safe
            # torch's CPU float32 sqrt is not correctly rounded; the float64
            # root rounded to float32 is, as numpy's, JAX's and the card's
            std = torch.sqrt(var.double()).to(comp) \
                if comp == torch.float32 else torch.sqrt(var)
        lo_v = center - sigma * std
        hi_v = center + sigma * std
        # NaN compares False, so the missing tail never counts
        n_lt = (s < lo_v[None]).sum(0, dtype=torch.int32)
        n_le = (s <= hi_v[None]).sum(0, dtype=torch.int32)
        i_lo = torch.where(some, torch.maximum(i_lo, n_lt), i_lo)
        i_hi = torch.where(some, torch.minimum(i_hi, n_le), i_hi)
    cnt = i_hi - i_lo
    lo_val = _at(s, i_lo, i_lo < n)
    hi_val = _at(s, i_hi - 1, i_hi >= 1)
    keep = finite & (cnt > 0)[None] & (x >= lo_val[None]) \
        & (x <= hi_val[None])
    return torch.where(keep, x, float("nan")).to(data.dtype)
