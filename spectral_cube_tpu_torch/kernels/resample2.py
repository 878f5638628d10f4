"""Kernel 3: axis-aligned 2-tap bilinear resample from raw data.

:func:`resample2` launches ``csrc/resample2.cu`` for a CUDA tensor and
runs :func:`resample2_plain`, the same function in plain PyTorch, for a CPU
tensor.  Output row i reads input rows ``y0[i]`` and ``y0[i] + 1`` (clipped
to the plane) with weights ``1 - wy[i]`` and ``wy[i]``; columns likewise.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import load_library, check, ptr, stream_ptr

__all__ = ["resample2", "resample2_plain", "POISON"]

#: NaN-weight threshold of the poisoning rule (banded_pallas.py:45)
POISON = 1e-6


def _host_taps(raw, y0, wy, x0, wx, valid_plane, zvalid):
    nchan, ny_in, nx_in = raw.shape
    y0 = np.asarray(y0, dtype=np.int64)
    x0 = np.asarray(x0, dtype=np.int64)
    wy = np.asarray(wy, dtype=np.float32)
    wx = np.asarray(wx, dtype=np.float32)
    if y0.ndim != 1 or x0.ndim != 1 or wy.shape != y0.shape \
            or wx.shape != x0.shape:
        raise ValueError("y0/wy and x0/wx must be matching 1-D arrays")
    if y0.size and (y0.min() < 0 or y0.max() >= ny_in) \
            or x0.size and (x0.min() < 0 or x0.max() >= nx_in):
        raise ValueError("tap indices outside the input plane")
    valid_plane = np.asarray(valid_plane, dtype=bool)
    if valid_plane.shape != (y0.size, x0.size):
        raise ValueError("valid_plane must be (ny_out, nx_out)")
    zvalid = np.ones(nchan, bool) if zvalid is None \
        else np.asarray(zvalid, dtype=bool)
    if zvalid.shape != (nchan,):
        raise ValueError("zvalid must hold one flag per channel")
    return y0, wy, x0, wx, valid_plane, zvalid


def resample2(raw, y0, wy, x0, wx, valid_plane, zvalid=None):
    """(nchan, ny_out, nx_out) resample of ``raw``: out = sum w *
    nan_to_num(Z), NaN where the NaN weight exceeds :data:`POISON`, where
    ``valid_plane`` is False and where ``zvalid`` is False.  A CPU tensor
    takes the plain version; a CUDA tensor the kernel."""
    if raw.ndim != 3:
        raise ValueError(f"raw must be (nchan, ny, nx), got {tuple(raw.shape)}")
    taps = _host_taps(raw, y0, wy, x0, wx, valid_plane, zvalid)
    if raw.device.type == "cpu":
        return resample2_plain(raw, *taps)
    if raw.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {raw.device}")
    if raw.dtype != torch.float32 or not raw.is_contiguous():
        raise ValueError("the resample kernel takes contiguous float32 data")
    y0, wy, x0, wx, valid_plane, zvalid = taps
    lib = load_library()
    dev = raw.device
    nchan, ny_in, nx_in = raw.shape
    ny_out, nx_out = valid_plane.shape

    def dev_t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    y0_t, x0_t = dev_t(y0, torch.int32), dev_t(x0, torch.int32)
    wy_t, wx_t = dev_t(wy, torch.float32), dev_t(wx, torch.float32)
    vp_t = dev_t(valid_plane, torch.uint8)
    zv_t = dev_t(zvalid, torch.uint8)
    out = torch.empty((nchan, ny_out, nx_out), dtype=torch.float32,
                      device=dev)
    err = lib.sct_resample2(ptr(raw), ptr(y0_t), ptr(wy_t), ptr(x0_t),
                            ptr(wx_t), ptr(vp_t), ptr(zv_t), nchan, ny_in,
                            nx_in, ny_out, nx_out, ptr(out), stream_ptr(dev))
    check(err, "sct_resample2")
    resample2.launches += 1
    return out


resample2.launches = 0


def resample2_plain(raw, y0, wy, x0, wx, valid_plane, zvalid=None):
    """The kernel's function in plain PyTorch: y taps first, then x taps,
    for the values and the NaN weights alike."""
    if raw.ndim != 3:
        raise ValueError(f"raw must be (nchan, ny, nx), got {tuple(raw.shape)}")
    y0, wy, x0, wx, valid_plane, zvalid = _host_taps(
        raw, y0, wy, x0, wx, valid_plane, zvalid)
    dev = raw.device
    _, ny_in, nx_in = raw.shape
    ya = torch.as_tensor(y0, device=dev)
    yb = torch.clamp(ya + 1, max=ny_in - 1)
    xa = torch.as_tensor(x0, device=dev)
    xb = torch.clamp(xa + 1, max=nx_in - 1)
    fy = torch.as_tensor(wy, device=dev)[None, :, None]
    fx = torch.as_tensor(wx, device=dev)
    gy, gx = 1.0 - fy, 1.0 - fx

    def lerp(a):
        t = gy * a[:, ya, :] + fy * a[:, yb, :]
        return gx * t[:, :, xa] + fx * t[:, :, xb]

    z = raw.to(torch.float32)
    val = lerp(torch.nan_to_num(z))
    wn = lerp(torch.isnan(z).to(torch.float32))
    out = torch.where(wn > POISON, float("nan"), val)
    ok = torch.as_tensor(valid_plane, device=dev)[None] \
        & torch.as_tensor(zvalid, device=dev)[:, None, None]
    return torch.where(ok, out, float("nan"))
