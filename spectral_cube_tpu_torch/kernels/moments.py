"""Kernel 1: masked moment and statistics planes in one pass.

:func:`moments_planes` launches ``csrc/moments.cu`` for a CUDA tensor and
runs :func:`moments_planes_plain`, the same function in plain PyTorch, for
a CPU tensor.  Both return the compensated-pair sufficient planes that
``ops/moments._finalize_pairs`` turns into moments and statistics:

    planes[0:6]  = s0h, s0l, s1h, s1l, s2h, s2l
    planes[6:10] = qh, ql, min, max             (with_stats only)
    count        = included finite voxels per spaxel (int32)

:func:`plan` decides the kernel's launch from the shapes and alignments:
the depth of its ring of chunk tiles and the copies that stage the data
and the include mask.
"""

from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np
import torch

from ..ops.df32 import two_sum, two_prod, df_div
from ..profiling import spanned
from ._build import (load_library, check, ptr, stream_ptr, on_tensor_device,
                     count_launch, stream_cached)

__all__ = ["moments_planes", "moments_planes_plain", "plan", "CHUNK",
           "CMP_OPS"]

#: channels per chunk; kChunk in csrc/moments.cu
CHUNK = 32
#: spaxels a block (one a thread); kThreads in csrc/moments.cu
THREADS = 128
#: chunk tiles in a block's ring: chunk k + 1 loads while chunk k computes
#: (two stages of 16 KB keep six blocks on an SM; more stages, fewer
#: blocks, measured slower on an H100)
STAGES = 2

#: fused comparison op codes (csrc/moments.cu) -> torch comparison
CMP_OPS = {1: torch.gt, 2: torch.ge, 3: torch.lt, 4: torch.le}

#: include-mask forms, their codes in csrc/moments.cu: none; its bytes
#: staged with the data in 16-byte or 4-byte copies; read directly in
#: pass 1 (rows not 4-byte aligned)
MASK_FORMS = {"none": 0, "cp.async16": 1, "cp.async4": 2, "direct": 3}

#: the launch of ``csrc/moments.cu``: blocks of THREADS spaxels (the last
#: a tail where THREADS does not divide npix), the ring's stages, the
#: data's copies ("cp.async16" or "cp.async4"), the mask's form (a key of
#: MASK_FORMS), the block's shared bytes
Plan = namedtuple("Plan", "blocks stages staging mask smem")


def plan(npix, data_aligned=True, mask=False, mask_aligned=True):
    """The kernel's launch for ``npix`` spaxels a plane: a ring of
    :data:`STAGES` tiles of CHUNK channels x THREADS spaxels; the data in
    16-byte copies where a plane's rows of spaxels are 16-byte aligned
    (``npix % 4 == 0`` and the base ``data_aligned``), else 4-byte copies;
    an include ``mask`` (uint8) staged beside it in 16-byte copies where
    ``npix % 16 == 0`` and its base is ``mask_aligned`` to 16 bytes,
    4-byte copies where ``npix % 4 == 0`` (and 4-byte aligned), else read
    directly."""
    npix = int(npix)
    if npix < 1:
        raise ValueError(f"npix must be >= 1, got {npix}")
    vec = data_aligned and npix % 4 == 0
    if not mask:
        form = "none"
    elif mask_aligned and npix % 16 == 0:
        form = "cp.async16"
    elif npix % 4 == 0:
        form = "cp.async4"
    else:
        form = "direct"
    staged = form in ("cp.async16", "cp.async4")
    smem = STAGES * CHUNK * THREADS * (4 + (1 if staged else 0))
    return Plan(-(-npix // THREADS), STAGES,
                "cp.async16" if vec else "cp.async4", form, smem)


#: device copies of centred coordinates, keyed by stream, device and bytes
_XC_CACHE = OrderedDict()
_XC_CACHE_SIZE = 16


def _device_coords(xc, dev):
    """``xc`` as float32 on ``dev``, uploaded once per device, stream and
    value: a later call with the same coordinates on the same stream
    queues no host copy."""
    a = np.ascontiguousarray(np.asarray(xc, dtype=np.float32))
    return stream_cached(
        _XC_CACHE, _XC_CACHE_SIZE, (str(dev), a.shape, a.tobytes()), dev,
        lambda: torch.from_numpy(a).pin_memory().to(dev, non_blocking=True))


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


@spanned("sct.kernels.moments")
@on_tensor_device
def moments_planes(data, xc, cmp_op=0, threshold=0.0, include=None,
                   with_stats=False):
    """Sufficient planes of the masked moments along axis 0.

    ``xc``: (nchan,) centered spectral coordinates; ``cmp_op``/``threshold``:
    the fused comparison (0 = none, else a key of :data:`CMP_OPS`);
    ``include``: optional bool/uint8 array of the data's shape.
    A CPU tensor takes the plain version; a CUDA tensor the kernel: one
    call launches ``moments_kernel`` once on the device."""
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
    xc_t = _device_coords(xc, dev)
    inc = None
    if include is not None:
        # a bool mask is read as its own bytes (0/1): no copy of the cube
        inc = include.view(torch.uint8) if include.dtype == torch.bool \
            else include.to(torch.uint8)
        inc = inc.to(dev).contiguous()
    planes = torch.empty((10 if with_stats else 6, ny, nx),
                         dtype=torch.float32, device=dev)
    count = torch.empty((ny, nx), dtype=torch.int32, device=dev)
    if planes.numel() == 0:
        return planes, count
    p = plan(ny * nx, data.data_ptr() % 16 == 0, inc is not None,
             inc is not None and inc.data_ptr() % 16 == 0)
    vec = int(p.staging == "cp.async16")
    mask = MASK_FORMS[p.mask]
    if lib.sct_moments_smem(ny * nx, p.stages, vec, mask) != p.smem:
        raise RuntimeError("csrc/moments.cu and kernels/moments.py disagree "
                           "on the plan")
    err = lib.sct_moments(ptr(data), ptr(xc_t), ptr(inc), nchan, ny * nx,
                          int(cmp_op), float(threshold), int(with_stats),
                          p.stages, vec, mask, ptr(planes), ptr(count),
                          stream_ptr(dev))
    check(err, "sct_moments")
    count_launch(moments_planes)
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
