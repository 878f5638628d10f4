"""Kernel 5: fused spectral smooth + interpolation along axis 0.

:func:`smooth_interp` launches ``csrc/smooth_interp.cu`` for a CUDA tensor
and runs :func:`smooth_interp_plain`, the same function in plain PyTorch,
for a CPU tensor.  Both take the host operators of
``spectral_cube_tpu/ops/banded_pallas.py::smooth_interp_strips``: the
smoothing band S (nin, nin), the 2-tap interpolation I (nout, nin) and
their product M = I @ S (nout, nin), all float32.  Per spectrum, from its
own finiteness:

- all finite: ``out = M @ x``;
- no finite sample: NaN throughout;
- otherwise the exact chain: ``sm = (S @ where(finite, x, 0)) / den`` with
  ``den = 1 - S @ (1 - finite)`` and NaN where ``den <= 1e-6``, then
  ``out = I @ where(isnan(sm), 0, sm)``, NaN wherever a nonzero tap of I
  meets a NaN of ``sm``.

Dirtiness comes from the input's finiteness, never from M's nonzero
pattern: a negative-tap kernel can cancel entries of M that the chain
still reads (tests/test_banded_pallas.py:180-213).

:func:`plan` decides the kernel's launch from the shapes: how many
spectra a tile holds, whether its slab arrives in 16-byte or 4-byte
asynchronous copies, and whether a block rings two slabs.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from ..utils import ieee_fp32
from ._build import (load_library, check, ptr, stream_ptr, on_tensor_device,
                     count_launch)
from .conv_sep import DEN_EPS

__all__ = ["smooth_interp", "smooth_interp_plain", "band_rows", "plan"]

#: widest tile of spectra
MAX_TILE = 32
#: shared bytes a block may take on an H100, less the kernel's static ones
SMEM_MAX = 232448 - 1024

#: the launch of ``csrc/smooth_interp.cu``: spectra a tile, the copies
#: that stage its slab ("cp.async16" or "cp.async4"), the slabs in a
#: block's ring (2: the next tile loads while this one computes; 1 where
#: two do not fit), the block's shared bytes
Plan = namedtuple("Plan", "tile staging stages smem")


def plan(nin, ncol, aligned=True):
    """The kernel's launch for a (nin, ncol) view: the widest power-of-two
    tile up to MAX_TILE spectra whose ring of two nin x tile slabs fits a
    block's shared memory, else one slab of the widest tile that fits;
    staged in 16-byte copies where the rows are 16-byte aligned (``ncol``
    a multiple of 4, the tile a multiple of 4 and the base ``aligned``),
    else in 4-byte copies.  None where one spectrum does not fit."""
    nin, ncol = int(nin), int(ncol)
    for stages in (2, 1):
        tile = MAX_TILE
        while tile > 1 and stages * nin * tile * 4 > SMEM_MAX:
            tile //= 2
        smem = stages * nin * tile * 4
        if smem <= SMEM_MAX:
            vec = aligned and tile % 4 == 0 and ncol % 4 == 0
            return Plan(tile, "cp.async16" if vec else "cp.async4", stages,
                        smem)
    return None


def band_rows(A):
    """Per-row band of ``A`` (rows, cols): ``(start, taps)`` with row r's
    nonzero entries inside columns ``start[r] .. start[r] + W - 1`` and
    ``taps[r] = A[r, start[r]:start[r] + W]``, W the widest row's span."""
    A = np.asarray(A, dtype=np.float32)
    rows, cols = A.shape
    nz_r, nz_c = np.nonzero(A)
    lo = np.full(rows, cols, np.int64)
    hi = np.full(rows, -1, np.int64)
    np.minimum.at(lo, nz_r, nz_c)
    np.maximum.at(hi, nz_r, nz_c)
    empty = hi < 0
    lo[empty], hi[empty] = 0, 0
    W = int((hi - lo + 1).max()) if rows else 1
    start = np.clip(lo, 0, cols - W)
    taps = A[np.arange(rows)[:, None], start[:, None] + np.arange(W)]
    return start.astype(np.int32), np.ascontiguousarray(taps)


def _check_ops(data, M, S, I):
    nin = data.shape[0]
    if M.ndim != 2 or S.shape != (nin, nin) or I.shape != M.shape \
            or M.shape[1] != nin:
        raise ValueError(f"operators must be M (nout, {nin}), S ({nin}, "
                         f"{nin}), I (nout, {nin}); got {M.shape}, "
                         f"{S.shape}, {I.shape}")


@on_tensor_device
def smooth_interp(data, M, S, I, bands=None):
    """(nout, ...) smooth + interpolation of ``data`` (nin, ...) along axis
    0 with the host float32 operators ``M = I @ S``, ``S`` and ``I``.  A
    CPU tensor takes the plain version; a CUDA tensor the kernel, which
    reads ``bands``, the :func:`band_rows` of (M, S, I) (computed here
    when not given): one call launches ``smooth_interp_kernel`` once on
    the device (persistent blocks)."""
    M, S, I = (np.asarray(a, dtype=np.float32) for a in (M, S, I))
    _check_ops(data, M, S, I)
    if data.device.type == "cpu":
        return smooth_interp_plain(data, M, S, I)
    if data.device.type != "cuda":
        raise ValueError(f"no smooth_interp kernel for device {data.device}")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("the smooth_interp kernel takes contiguous float32 "
                         "data")
    nin, nout = data.shape[0], M.shape[0]
    ncol = data.numel() // max(nin, 1)
    out = torch.empty((nout,) + tuple(data.shape[1:]), dtype=torch.float32,
                      device=data.device)
    if out.numel() == 0:
        return out
    if bands is None:
        bands = [band_rows(A) for A in (M, S, I)]
    wm, ws, wi = (taps.shape[1] for _, taps in bands)
    # the kernel reads M's taps 4 at a time: rows padded to 4 taps
    m_start, m_taps = bands[0]
    bands = [(m_start, np.pad(m_taps, ((0, 0), (0, -wm % 4))))] + bands[1:]
    (ms, mt), (ss, st), (is_, it) = (
        (torch.as_tensor(start, device=data.device),
         torch.as_tensor(taps, device=data.device)) for start, taps in bands)
    p = plan(nin, ncol, data.data_ptr() % 16 == 0)
    if p is None:
        raise ValueError(f"the smooth_interp kernel stages whole spectra in "
                         f"shared memory: {nin} channels do not fit")
    vec = int(p.staging == "cp.async16")
    lib = load_library()
    if lib.sct_smooth_interp_smem(nin, ncol, p.tile, vec,
                                  p.stages) != p.smem:
        raise RuntimeError("csrc/smooth_interp.cu and "
                           "kernels/smooth_interp.py disagree on the plan")
    err = lib.sct_smooth_interp(ptr(data), nin, nout, ncol, p.tile, vec,
                                p.stages, ptr(ms), ptr(mt), wm, ptr(ss),
                                ptr(st), ws, ptr(is_), ptr(it), wi,
                                ptr(out), stream_ptr(data.device))
    check(err, "sct_smooth_interp")
    count_launch(smooth_interp)
    return out


smooth_interp.launches = 0


def smooth_interp_plain(data, M, S, I):
    """The kernel's function in plain PyTorch: dense float32 products in
    IEEE float32, the chain on the spectra that hold NaN."""
    M, S, I = (np.asarray(a, dtype=np.float32) for a in (M, S, I))
    _check_ops(data, M, S, I)
    dev = data.device
    nin, nout = data.shape[0], M.shape[0]
    flat = data.reshape(nin, -1).to(torch.float32)
    finite = torch.isfinite(flat)
    some = finite.any(0)
    dirty = some & ~finite.all(0)
    Mt, St, It = (torch.as_tensor(a, device=dev) for a in (M, S, I))
    with ieee_fp32():
        out = Mt @ torch.where(finite, flat, 0.0)
        cols = torch.nonzero(dirty)[:, 0]
        if cols.numel():
            x, v = flat[:, cols], finite[:, cols]
            num = St @ torch.where(v, x, 0.0)
            den = 1.0 - St @ (~v).to(torch.float32)
            ok = den > DEN_EPS
            sm = torch.where(ok, num / torch.where(ok, den, 1.0),
                             float("nan"))
            gap = torch.isnan(sm)
            val = It @ torch.where(gap, 0.0, sm)
            poisoned = (It @ gap.to(torch.float32)) > 0
            out[:, cols] = torch.where(poisoned, float("nan"), val)
    out[:, ~some] = float("nan")
    return out.reshape((nout,) + tuple(data.shape[1:]))
