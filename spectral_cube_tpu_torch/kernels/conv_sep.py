"""Kernel 2: per-channel separable normalized convolution.

:func:`conv_sep` launches ``csrc/conv_sep.cu`` for a CUDA tensor and runs
:func:`conv_sep_plain`, the same function in plain PyTorch, for a CPU
tensor.  The operator is given as flipped 1-D taps per group and rank,
``ytaps`` (G, r, ly) and ``xtaps`` (G, r, lx), with centre offsets
``hy``/``hx``: output index i reads input index i + o - h through tap o,
zero outside the plane (ops/smoothing._banded_conv_matrix).  Any tap
lengths run: the kernel streams the taps and the halo through shared
memory in fixed chunks.
"""

from __future__ import annotations

import torch

from ..profiling import spanned
from ._build import (load_library, check, ptr, stream_ptr, on_tensor_device,
                     count_launch)

__all__ = ["conv_sep", "conv_sep_plain", "DEN_EPS"]

#: normalized-convolution denominator floor (banded_pallas.py:45)
DEN_EPS = 1e-6
#: the largest rank the kernel takes: ``ops/convolve.separable_factors``'
#: cap for one beam group
MAX_RANK = 8


def _check_inputs(data, ytaps, xtaps, hy, hx, group_idx):
    if data.ndim != 3:
        raise ValueError(f"data must be (nchan, ny, nx), got {tuple(data.shape)}")
    if ytaps.ndim != 3 or xtaps.ndim != 3 \
            or ytaps.shape[:2] != xtaps.shape[:2]:
        raise ValueError("ytaps/xtaps must be (G, r, ly)/(G, r, lx)")
    if not (0 <= hy < ytaps.shape[2] and 0 <= hx < xtaps.shape[2]):
        raise ValueError("tap centre offsets out of range")
    if group_idx.shape != (data.shape[0],):
        raise ValueError("group_idx must hold one group per channel")


@spanned("sct.kernels.conv_sep")
@on_tensor_device
def conv_sep(data, ytaps, xtaps, hy, hx, group_idx):
    """out[c] = sum_i My[g,i] @ X[c] @ Mx[g,i]^T, g = group_idx[c], with
    normalized-convolution NaN handling.  A CPU tensor takes the plain
    version; a CUDA tensor the kernel: one call launches two kernels on
    the device, ``channel_flags_kernel`` (the channels holding NaN, after a
    memset of their flags) and ``conv_sep_kernel``."""
    _check_inputs(data, ytaps, xtaps, hy, hx, group_idx)
    if data.device.type == "cpu":
        return conv_sep_plain(data, ytaps, xtaps, hy, hx, group_idx)
    if data.device.type != "cuda":
        raise ValueError(f"no convolution kernel for device {data.device}")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("the convolution kernel takes contiguous float32 "
                         "data")
    nchan, ny, nx = data.shape
    G, r, ly = ytaps.shape
    lx = xtaps.shape[2]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"the convolution kernel takes rank 1 to {MAX_RANK}, "
                         f"got {r}")
    lib = load_library()
    dev = data.device
    yt = ytaps.to(device=dev, dtype=torch.float32).contiguous()
    xt = xtaps.to(device=dev, dtype=torch.float32).contiguous()
    gi = group_idx.to(device=dev, dtype=torch.int32).contiguous()
    if nchan and not bool(((gi >= 0) & (gi < G)).all()):
        raise ValueError("group_idx out of range")
    flags = torch.empty(nchan, dtype=torch.int32, device=dev)
    out = torch.empty_like(data)
    err = lib.sct_conv_sep(ptr(data), ptr(yt), ptr(xt), ptr(gi), ptr(flags),
                           nchan, ny, nx, r, ly, lx, int(hy), int(hx),
                           ptr(out), stream_ptr(dev))
    check(err, "sct_conv_sep")
    count_launch(conv_sep)
    return out


conv_sep.launches = 0


def _apply(x, fy, fx, hy, hx):
    """sum_i My_i @ x @ Mx_i^T for (c, ny, nx) x, by shifted slices: the
    y taps first, then the x taps, in the kernel's order."""
    _, ny, nx = x.shape
    ly, lx = fy.shape[1], fx.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, hy, ly - 1 - hy))
    acc = None
    for i in range(fy.shape[0]):
        t = torch.zeros_like(x)
        for o in range(ly):
            t = t + fy[i, o] * xp[:, o:o + ny, :]
        tp = torch.nn.functional.pad(t, (hx, lx - 1 - hx))
        term = torch.zeros_like(x)
        for o in range(lx):
            term = term + fx[i, o] * tp[:, :, o:o + nx]
        acc = term if acc is None else acc + term
    return acc


def conv_sep_plain(data, ytaps, xtaps, hy, hx, group_idx):
    """The kernel's function in plain PyTorch (no matmul, so no TF32)."""
    _check_inputs(data, ytaps, xtaps, hy, hx, group_idx)
    dev = data.device
    fy_all = ytaps.to(device=dev, dtype=data.dtype)
    fx_all = xtaps.to(device=dev, dtype=data.dtype)
    gi = group_idx.to(device=dev, dtype=torch.int64)
    valid = torch.isfinite(data)
    zero = torch.zeros((), dtype=data.dtype, device=dev)
    out = torch.empty_like(data)
    for g in range(ytaps.shape[0]):
        chans = torch.nonzero(gi == g).flatten()
        if chans.numel() == 0:
            continue
        v = valid[chans]
        num = _apply(torch.where(v, data[chans], zero), fy_all[g], fx_all[g],
                     hy, hx)
        # channels holding a non-finite value take the normalized form;
        # in a clean channel den == 1 exactly
        dirty = ~v.flatten(1).all(1)
        if bool(dirty.any()):
            den = 1.0 - _apply((~v[dirty]).to(data.dtype), fy_all[g],
                               fx_all[g], hy, hx)
            ok = den > DEN_EPS
            num[dirty] = torch.where(
                ok, num[dirty] / torch.where(ok, den, 1.0),
                float("nan"))
        any_valid = v.flatten(1).any(1)[:, None, None]
        out[chans] = torch.where(any_valid, num, float("nan"))
    return out
