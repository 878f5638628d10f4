"""Kernel 1: masked moment and statistics planes in one pass.

:func:`moments_planes` launches ``csrc/moments.cu`` for a CUDA tensor and
runs :func:`moments_planes_plain`, the same function in plain PyTorch, for
a CPU tensor.  Both return the compensated-pair sufficient planes that
``ops/moments._finalize_pairs`` turns into moments and statistics:

    planes[0:6]  = s0h, s0l, s1h, s1l, s2h, s2l
    planes[6:10] = qh, ql, min, max             (with_stats only)
    count        = included finite voxels per spaxel (int32)
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.df32 import two_sum, two_prod, df_div
from ._build import load_library, check, ptr, stream_ptr

__all__ = ["moments_planes", "moments_planes_plain", "CHUNK", "CMP_OPS"]

#: channels per chunk; kChunk in csrc/moments.cu
CHUNK = 32

#: fused comparison op codes (csrc/moments.cu) -> torch comparison
CMP_OPS = {1: torch.gt, 2: torch.ge, 3: torch.lt, 4: torch.le}


def _acc2(h, l, vh, vl):
    """(h, l) += (vh, vl) in pair arithmetic (ops/moments.py acc2)."""
    s, e = two_sum(h, vh)
    return s, l + (e + vl)


def _check_inputs(data, include):
    if data.ndim != 3:
        raise ValueError(f"data must be (nchan, ny, nx), got {tuple(data.shape)}")
    if include is not None and include.shape != data.shape:
        raise ValueError(f"include shape {tuple(include.shape)} != data "
                         f"shape {tuple(data.shape)}")


def moments_planes(data, xc, cmp_op=0, threshold=0.0, include=None,
                   with_stats=False):
    """Sufficient planes of the masked moments along axis 0.

    ``xc``: (nchan,) centered spectral coordinates; ``cmp_op``/``threshold``:
    the fused comparison (0 = none, else a key of :data:`CMP_OPS`);
    ``include``: optional bool/uint8 array of the data's shape.
    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    _check_inputs(data, include)
    if data.device.type == "cpu":
        return moments_planes_plain(data, xc, cmp_op, threshold, include,
                                    with_stats)
    if data.device.type != "cuda":
        raise ValueError(f"no moments kernel for device {data.device}")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("the moments kernel takes contiguous float32 data")
    lib = load_library()
    if lib.sct_moments_chunk() != CHUNK:
        raise RuntimeError("csrc/moments.cu and kernels/moments.py disagree "
                           "on the chunk length")
    nchan, ny, nx = data.shape
    dev = data.device
    xc_t = torch.as_tensor(np.asarray(xc, dtype=np.float32), device=dev)
    inc = None
    if include is not None:
        inc = include.to(device=dev, dtype=torch.uint8).contiguous()
    planes = torch.empty((10 if with_stats else 6, ny, nx),
                         dtype=torch.float32, device=dev)
    count = torch.empty((ny, nx), dtype=torch.int32, device=dev)
    err = lib.sct_moments(ptr(data), ptr(xc_t), ptr(inc), nchan, ny * nx,
                          int(cmp_op), float(threshold), int(with_stats),
                          ptr(planes), ptr(count), stream_ptr(dev))
    check(err, "sct_moments")
    moments_planes.launches += 1
    return planes, count


moments_planes.launches = 0


def moments_planes_plain(data, xc, cmp_op=0, threshold=0.0, include=None,
                         with_stats=False):
    """The kernel's function in plain PyTorch: the same chunks of
    :data:`CHUNK` channels, the same two-pass numerics per chunk and the
    same pair accumulation across chunks."""
    _check_inputs(data, include)
    nchan, ny, nx = data.shape
    dev = data.device
    f32 = torch.float32
    xc_t = torch.as_tensor(np.asarray(xc, dtype=np.float32), device=dev)
    thr = torch.tensor(threshold, dtype=f32, device=dev)
    zero = torch.zeros((ny, nx), dtype=f32, device=dev)
    s0h = s0l = s1h = s1l = s2h = s2l = qh = ql = zero
    mn = torch.full((ny, nx), float("inf"), dtype=f32, device=dev)
    mx = torch.full((ny, nx), float("-inf"), dtype=f32, device=dev)
    cnt = torch.zeros((ny, nx), dtype=torch.int32, device=dev)
    for c0 in range(0, nchan, CHUNK):
        blk = data[c0:c0 + CHUNK].to(f32)
        valid = torch.isfinite(blk)
        if cmp_op:
            valid &= CMP_OPS[cmp_op](blk, thr)
        if include is not None:
            valid &= include[c0:c0 + CHUNK].to(dev).bool()
        w = torch.where(valid, blk, zero)
        x = xc_t[c0:c0 + CHUNK, None, None]
        s0 = w.sum(0)
        s1 = (w * x).sum(0)
        n = valid.sum(0, dtype=torch.int32)
        m1 = s1 / torch.where(s0 == 0, 1.0, s0)
        d = x - m1
        r1 = (w * d).sum(0)
        s2c = (w * (d * d)).sum(0)
        cnt = cnt + n
        p1h, p1l = two_prod(s0, m1)
        t2h, t2l = two_prod(p1h, m1)
        s0h, s0l = _acc2(s0h, s0l, s0, zero)
        s1h, s1l = _acc2(s1h, s1l, p1h, p1l + r1)
        s2h, s2l = _acc2(s2h, s2l, t2h, t2l + p1l * m1 + 2.0 * m1 * r1)
        s2h, s2l = _acc2(s2h, s2l, s2c, zero)
        if with_stats:
            mn = torch.minimum(mn, torch.where(valid, blk, float("inf"))
                               .amin(0))
            mx = torch.maximum(mx, torch.where(valid, blk, float("-inf"))
                               .amax(0))
            nf = torch.clamp(n, min=1).to(f32)
            dev_ = torch.where(valid, blk - s0 / nf, zero)
            d2 = (dev_ * dev_).sum(0)
            dh, dl = df_div(two_prod(s0, s0), (nf, zero))
            qh, ql = _acc2(qh, ql, d2, zero)
            qh, ql = _acc2(qh, ql, dh, dl)
    planes = [s0h, s0l, s1h, s1l, s2h, s2l]
    if with_stats:
        planes += [qh, ql, mn, mx]
    return torch.stack(planes), cnt
