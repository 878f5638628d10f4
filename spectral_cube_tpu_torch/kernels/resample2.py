"""Kernel 3: axis-aligned 2-tap bilinear resample.

:func:`resample2` (from raw, NaN-carrying data) and :func:`resample2_filled`
(from NaN-filled data with a separate NaN-weight plane) launch
``csrc/resample2.cu`` for a CUDA tensor and run :func:`resample2_plain` /
:func:`resample2_filled_plain`, the same functions in plain PyTorch, for a
CPU tensor.  Output row i reads input rows ``y0[i]`` and ``y0[i] + 1``
(clipped to the plane) with weights ``1 - wy[i]`` and ``wy[i]``; columns
likewise.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import load_library, check, ptr, stream_ptr

__all__ = ["resample2", "resample2_plain", "resample2_filled",
           "resample2_filled_plain", "lerp2", "POISON"]

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


def lerp2(a, ry, rx):
    """The 2-tap resample of (c, ny_in, nx_in) planes ``a``: y taps, then x
    taps, each a sum of two rounded products, in the kernels' order.
    ``ry``/``rx``: ``(i0, w0, w1)``, weight ``w0`` at ``i0`` and ``w1`` at
    ``i0 + 1`` (clipped to the plane)."""
    dev = a.device
    _, ny_in, nx_in = a.shape

    def taps(rows, n_in, shape):
        i0 = torch.as_tensor(np.asarray(rows[0], np.int64), device=dev)
        w0, w1 = (torch.as_tensor(np.asarray(w, np.float32),
                                  device=dev).reshape(shape)
                  for w in rows[1:])
        return i0, torch.clamp(i0 + 1, max=n_in - 1), w0, w1

    ya, yb, gy, fy = taps(ry, ny_in, (-1, 1))
    xa, xb, gx, fx = taps(rx, nx_in, (-1,))
    t = gy * a[:, ya, :] + fy * a[:, yb, :]
    return gx * t[:, :, xa] + fx * t[:, :, xb]


def _rows(i0, w):
    """``(i0, 1 - w, w)`` in float32, as the kernels form the weights."""
    w = np.asarray(w, np.float32)
    return i0, np.float32(1.0) - w, w


def _validity(out, valid_plane, zvalid):
    ok = torch.as_tensor(valid_plane, device=out.device)[None] \
        & torch.as_tensor(zvalid, device=out.device)[:, None, None]
    return torch.where(ok, out, float("nan"))


def resample2_plain(raw, y0, wy, x0, wx, valid_plane, zvalid=None):
    """The kernel's function in plain PyTorch: y taps first, then x taps,
    for the values and the NaN weights alike."""
    if raw.ndim != 3:
        raise ValueError(f"raw must be (nchan, ny, nx), got {tuple(raw.shape)}")
    y0, wy, x0, wx, valid_plane, zvalid = _host_taps(
        raw, y0, wy, x0, wx, valid_plane, zvalid)
    ry, rx = _rows(y0, wy), _rows(x0, wx)
    z = raw.to(torch.float32)
    val = lerp2(torch.nan_to_num(z), ry, rx)
    wn = lerp2(torch.isnan(z).to(torch.float32), ry, rx)
    out = torch.where(wn > POISON, float("nan"), val)
    return _validity(out, valid_plane, zvalid)


def _check_filled(fz, wz, wz_any):
    if fz.ndim != 3 or wz.shape != fz.shape:
        raise ValueError("fz and wz must be (nchan, ny, nx) of one shape, got "
                         f"{tuple(fz.shape)} and {tuple(wz.shape)}")
    if tuple(np.shape(wz_any)) != (fz.shape[0],):
        raise ValueError("wz_any must hold one flag per channel")


def resample2_filled(fz, wz, wz_any, y0, wy, x0, wx, valid_plane,
                     zvalid=None):
    """(nchan, ny_out, nx_out) resample of NaN-filled ``fz`` with its
    NaN-weight plane ``wz``: out = sum w * fz, NaN where sum w * wz exceeds
    :data:`POISON` in a channel flagged by ``wz_any``, where
    ``valid_plane`` is False and where ``zvalid`` is False.  ``wz_any``:
    (nchan,) bool; an unflagged channel's ``wz`` is never read, so the
    flags must be True wherever ``wz`` is not all zero, as
    ``ops/regrid.py::_zlerp_filled`` derives them from the input channels'
    NaNs.  The TPU kernel tests its weight block for a nonzero instead
    (banded_pallas.py:876); taking the flags saves reading ``wz`` here.
    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    _check_filled(fz, wz, wz_any)
    taps = _host_taps(fz, y0, wy, x0, wx, valid_plane, zvalid)
    if fz.device.type == "cpu":
        return resample2_filled_plain(fz, wz, wz_any, *taps)
    if fz.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {fz.device}")
    if fz.dtype != torch.float32 or wz.dtype != torch.float32 \
            or not fz.is_contiguous() or not wz.is_contiguous() \
            or wz.device != fz.device:
        raise ValueError("the resample kernel takes contiguous float32 fz "
                         "and wz on one device")
    y0, wy, x0, wx, valid_plane, zvalid = taps
    lib = load_library()
    dev = fz.device
    nchan, ny_in, nx_in = fz.shape
    ny_out, nx_out = valid_plane.shape

    def dev_t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    flags = torch.as_tensor(wz_any, device=dev).to(torch.int32).contiguous()
    y0_t, x0_t = dev_t(y0, torch.int32), dev_t(x0, torch.int32)
    wy_t, wx_t = dev_t(wy, torch.float32), dev_t(wx, torch.float32)
    vp_t = dev_t(valid_plane, torch.uint8)
    zv_t = dev_t(zvalid, torch.uint8)
    out = torch.empty((nchan, ny_out, nx_out), dtype=torch.float32,
                      device=dev)
    err = lib.sct_resample2_filled(
        ptr(fz), ptr(wz), ptr(flags), ptr(y0_t), ptr(wy_t), ptr(x0_t),
        ptr(wx_t), ptr(vp_t), ptr(zv_t), nchan, ny_in, nx_in, ny_out, nx_out,
        ptr(out), stream_ptr(dev))
    check(err, "sct_resample2_filled")
    resample2_filled.launches += 1
    return out


resample2_filled.launches = 0


def resample2_filled_plain(fz, wz, wz_any, y0, wy, x0, wx, valid_plane,
                           zvalid=None):
    """:func:`resample2_filled` in plain PyTorch, in the kernel's order of
    roundings: the poison test only in the channels ``wz_any`` flags."""
    _check_filled(fz, wz, wz_any)
    y0, wy, x0, wx, valid_plane, zvalid = _host_taps(
        fz, y0, wy, x0, wx, valid_plane, zvalid)
    ry, rx = _rows(y0, wy), _rows(x0, wx)
    val = lerp2(fz.to(torch.float32), ry, rx)
    wn = lerp2(wz.to(torch.float32), ry, rx)
    flagged = torch.as_tensor(wz_any, device=fz.device).to(torch.bool)
    out = torch.where((wn > POISON) & flagged[:, None, None], float("nan"),
                      val)
    return _validity(out, valid_plane, zvalid)
