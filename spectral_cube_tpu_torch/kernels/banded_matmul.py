"""Kernel 7: banded matrix product ``M @ flat`` along axis 0.

:func:`banded_matmul_strips` is the port of
``spectral_cube_tpu/ops/banded_pallas.py::banded_matmul_strips``: it
returns None exactly where that function does on the operator (``nout`` or
``nin`` not a multiple of 8, or an operator that :func:`plan_strips` /
:func:`strip_blocks` cannot cut into strips), and otherwise the (nout, S)
float32 product.  The JAX function's VMEM budget check (``_pick_xb``) is a
TPU limit and is dropped: any S runs.

:func:`banded_matmul` launches ``csrc/banded_matmul.cu`` for a CUDA tensor
and runs :func:`banded_matmul_plain`, the same function in plain PyTorch,
for a CPU tensor.  Both take the operator as per-row bands
(:func:`row_bands`) and compute

    out[i, s] = sum over t < length[i] of taps[i, t] * flat[start[i] + t, s]

with row i's band the span of its nonzero entries (an all-zero row gives
0).  For finite ``flat`` this is ``M @ flat`` in IEEE float32.  A NaN or
infinity in ``flat[j, s]`` reaches ``out[i, s]`` exactly when j lies in
row i's span, whatever the tap there (the TPU kernel instead reads one
K = 128 column window per strip of m rows, so there it reaches every row
of a strip whose window covers j).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ._build import load_library, check, ptr, stream_ptr

__all__ = ["plan_strips", "strip_blocks", "row_bands", "RowBands",
           "banded_matmul", "banded_matmul_plain", "banded_matmul_strips"]

#: output rows a block handles at once (halved until a chunk's input rows
#: fit the shared-memory budget)
_ROWS = 32
_SMEM_BUDGET = 96 * 1024


def plan_strips(profile, max_m=256):
    """Choose (m, K) so every m-row strip of the banded operator touches
    at most K input columns (the JAX package's banded_pallas.py:112-172,
    a host planner): K in (128, 256, 512) smallest first, then the m that
    pads the fewest rows, ties to the largest m.  ``profile``: bool
    (nout, nin) nonzero map.  Returns (m, K) or None."""
    nout, nin = profile.shape
    if np.count_nonzero(profile) <= 4_000_000:
        nz = np.flatnonzero(profile.ravel())
        rows = np.zeros(nout, bool)
        lo = np.zeros(nout, np.int64)
        hi = np.ones(nout, np.int64)
        if nz.size:
            r = nz // nin
            c = nz % nin
            rows[r] = True
            lo_f = np.full(nout, nin, np.int64)
            np.minimum.at(lo_f, r, c)
            hi_f = np.zeros(nout, np.int64)
            np.maximum.at(hi_f, r, c)
            lo = np.where(rows, lo_f, 0)
            hi = np.where(rows, hi_f + 1, 1)
    else:
        rows = np.any(profile, axis=1)
        lo = np.where(rows, profile.argmax(axis=1), 0)
        hi = np.where(rows,
                      nin - np.ascontiguousarray(
                          profile[:, ::-1]).argmax(axis=1), 1)
    for K in (128, 256, 512):
        if K > nin:
            break
        m_start = min(max_m, -(-nout // 8) * 8)
        best = None
        for m in range(m_start, 7, -8):
            ok = True
            for s in range(0, nout, m):
                e = min(s + m, nout)
                if hi[s:e].max() - lo[s:e].min() > K:
                    ok = False
                    break
            if ok:
                padded = -(-nout // m) * m
                if best is None or padded < best[0]:
                    best = (padded, m)
                if padded == nout:
                    break   # no smaller m can beat an exact cover
        if best is not None:
            return best[1], K
    return None


def strip_blocks(mats, m, K):
    """Cut banded operators into strip blocks (the JAX package's
    banded_pallas.py:175-208, a host planner).  ``mats``: (..., nout,
    nin) sharing one band structure.  Returns (blocks (..., nb, m, K)
    float32, starts list[int]) or None if some strip's band exceeds K."""
    mats = np.asarray(mats, dtype=np.float32)
    lead, (nout, nin) = mats.shape[:-2], mats.shape[-2:]
    if nin < K:
        return None
    flat = mats.reshape((-1, nout, nin))
    nb = -(-nout // m)
    blocks = np.zeros((flat.shape[0], nb, m, K), np.float32)
    starts = []
    for i in range(nb):
        s0, e0 = i * m, min(i * m + m, nout)
        nz = np.nonzero(np.any(flat[:, s0:e0, :] != 0.0, axis=(0, 1)))[0]
        if nz.size == 0:
            starts.append(0)
            continue
        if nz[-1] + 1 - nz[0] > K:
            return None
        s = int(np.clip(nz[0], 0, nin - K))
        s_al = (s // 8) * 8
        if nz[-1] + 1 - s_al <= K:
            s = s_al
        starts.append(s)
        blocks[:, i, :e0 - s0, :] = flat[:, s0:e0, s:s + K]
    return blocks.reshape(lead + (nb, m, K)), starts


class RowBands(NamedTuple):
    """Per-row bands of a (nout, nin) operator: row i's nonzero span
    starts at column ``start[i]`` and holds ``length[i]`` columns, whose
    values are ``taps[i, :length[i]]`` (zero-padded to the widest span);
    ``nin`` is the operator's column count."""
    start: np.ndarray
    length: np.ndarray
    taps: np.ndarray
    nin: int


def row_bands(M):
    """:class:`RowBands` of the float32 operator ``M`` (nout, nin)."""
    M = np.asarray(M, dtype=np.float32)
    nout, nin = M.shape
    nz_r, nz_c = np.nonzero(M)
    lo = np.full(nout, nin, np.int64)
    hi = np.full(nout, -1, np.int64)
    np.minimum.at(lo, nz_r, nz_c)
    np.maximum.at(hi, nz_r, nz_c)
    empty = hi < 0
    lo[empty], hi[empty] = 0, -1
    length = hi - lo + 1
    W = max(int(length.max()) if nout else 0, 1)
    cols = np.clip(lo[:, None] + np.arange(W), 0, nin - 1)
    taps = np.where(np.arange(W) < length[:, None],
                    M[np.arange(nout)[:, None], cols], 0.0)
    return RowBands(lo.astype(np.int32), length.astype(np.int32),
                    np.ascontiguousarray(taps, dtype=np.float32), nin)


def _chunks(bands, rows):
    """(lo, hi) int32 arrays: the input rows each chunk of ``rows`` output
    rows spans, and the widest such span."""
    nout = bands.start.shape[0]
    nch = -(-nout // rows)
    lo = np.zeros(nch, np.int32)
    hi = np.zeros(nch, np.int32)
    for k in range(nch):
        s = slice(k * rows, min((k + 1) * rows, nout))
        live = bands.length[s] > 0
        if live.any():
            lo[k] = bands.start[s][live].min()
            hi[k] = (bands.start[s] + bands.length[s])[live].max()
    return lo, hi, int((hi - lo).max()) if nch else 0


def _check(flat, bands):
    if flat.ndim != 2 or flat.shape[0] != bands.nin:
        raise ValueError(f"flat must be ({bands.nin}, S), got "
                         f"{tuple(flat.shape)}")


def banded_matmul(flat, bands):
    """(nout, S) float32 banded product of ``bands`` (:func:`row_bands`)
    with ``flat`` (nin, S).  A CPU tensor takes the plain version; a CUDA
    tensor the kernel."""
    _check(flat, bands)
    if flat.device.type == "cpu":
        return banded_matmul_plain(flat, bands)
    if flat.device.type != "cuda":
        raise ValueError(f"no banded_matmul kernel for device {flat.device}")
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("the banded_matmul kernel takes contiguous float32 "
                         "data")
    nout, W = bands.taps.shape
    S = flat.shape[1]
    out = torch.empty((nout, S), dtype=torch.float32, device=flat.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    rows = _ROWS
    while True:
        lo, hi, kmax = _chunks(bands, rows)
        if rows == 1 or lib.sct_banded_matmul_smem(rows, kmax, W) \
                <= _SMEM_BUDGET:
            break
        rows //= 2
    dev = flat.device
    st, ln, tp, clo, chi = (torch.as_tensor(a, device=dev) for a in (
        bands.start, bands.length, bands.taps, lo, hi))
    err = lib.sct_banded_matmul(ptr(flat), nout, S, ptr(st), ptr(ln),
                                ptr(tp), W, ptr(clo), ptr(chi), rows,
                                max(kmax, 1), ptr(out), stream_ptr(dev))
    check(err, "sct_banded_matmul")
    banded_matmul.launches += 1
    return out


banded_matmul.launches = 0


def banded_matmul_plain(flat, bands):
    """The kernel's function in plain PyTorch: for each tap position t,
    the rows whose span reaches t gain taps[:, t] * flat[start + t] in
    float32, in t order."""
    _check(flat, bands)
    dev = flat.device
    flat = flat.to(torch.float32)
    start, length, taps = (torch.as_tensor(a, device=dev)
                           for a in bands[:3])
    out = torch.zeros((taps.shape[0], flat.shape[1]), dtype=torch.float32,
                      device=dev)
    for t in range(taps.shape[1]):
        rows = torch.nonzero(length > t)[:, 0]
        if rows.numel() == 0:
            break
        src = flat.index_select(0, (start[rows] + t).long())
        out[rows] = torch.addcmul(out[rows], taps[rows, t, None], src)
    return out


def banded_matmul_strips(M_host, flat):
    """``M_host @ flat`` (the JAX package's banded_pallas.py:222-263):
    ``M_host`` a host (nout, nin) banded array, ``flat`` a (nin, S)
    tensor.  Returns (nout, S) float32 on flat's device, or None where the
    JAX function declines the operator (see the module docstring)."""
    M = np.asarray(M_host, dtype=np.float32)
    nout, nin = M.shape
    if nout % 8 or nin % 8:
        return None
    plan = plan_strips(M != 0.0)
    if plan is None or strip_blocks(M, *plan) is None:
        return None
    return banded_matmul(flat.to(torch.float32).contiguous(), row_bands(M))
