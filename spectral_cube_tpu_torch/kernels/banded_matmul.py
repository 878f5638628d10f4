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
for a CPU tensor.  The kernel's launch is laid out on the host:
:func:`plan` picks the rows a warp computes, the columns a lane holds and
the ring of staged input rows; :func:`pack` writes each step's loads and
its groups' records (ring slot, row mask, taps) into one int32 buffer,
which :func:`prepare` uploads with one non-blocking copy from pinned
memory (kept by the operator's bytes and the data's shape); :func:`launch`
runs the kernel on it.  Both take the operator as per-row bands
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

import ctypes
import hashlib
from collections import OrderedDict, namedtuple
from typing import NamedTuple

import numpy as np
import torch

from . import resample2 as _rs
from ._build import (load_library, check, stream_ptr, on_tensor_device,
                     count_launch, stream_cached)

__all__ = ["plan_strips", "strip_blocks", "row_bands", "RowBands",
           "banded_matmul", "banded_matmul_plain", "banded_matmul_strips",
           "plan", "fits", "pack", "prepare", "launch"]

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


#: warps of a block: output-row groups a step (csrc/banded_matmul.cu)
WARPS = 4
#: (output rows a warp's group, columns a lane) the plan tries in turn:
#: 8 rows by 4 adjacent floats (128-column strips), then groups of one
#: row, then 32-column strips, for spans too wide for the ring
SHAPES = ((8, 4), (1, 4), (1, 1))
#: steps whose copies are in flight while a step computes, most first
DEPTHS = (2, 1)
#: shared bytes a block may take on an H100, less static ones; and the
#: most that keeps two blocks an SM, which the plan tries first
SMEM_MAX = 232448 - 1024
SMEM_TWO = 232448 // 2 - 2 * 1024

#: the kernel's launch: ``rows`` a warp's group, ``cols`` a lane, ring
#: ``depth`` (steps in flight), ``slots`` of staged input rows, ``steps``
#: of WARPS groups, the most loads a step lists, words of a group's and of
#: a step's table, shared bytes
Plan = namedtuple("Plan", "rows cols depth slots steps max_loads "
                  "group_words table_words smem")

#: what :func:`pack` returns: the plan, and the step tables as int32 words
Packed = namedtuple("Packed", "plan words")


def _rec_words(rows):
    """int32 words of one record (csrc/banded_matmul.cu kRec)."""
    return 2 if rows == 1 else 4 + rows


def _groups(bands, rows):
    """Per group of ``rows`` consecutive output rows: the first input row
    of its span (the union of its rows' spans) and the span's mask and
    taps, (U, rows) arrays, where bit r of the mask says that row r's span
    holds the input row; the groups padded to whole steps of WARPS."""
    start = np.asarray(bands.start, np.int64)
    end = start + np.asarray(bands.length, np.int64)
    nout = start.size
    ng = -(-nout // (rows * WARPS)) * WARPS
    out = []
    for g in range(ng):
        r = np.arange(g * rows, min((g + 1) * rows, nout))
        r = r[end[r] > start[r]]
        if r.size == 0:
            out.append((0, np.zeros((0, rows), np.int64),
                        np.zeros((0, rows), np.float32)))
            continue
        lo, hi = int(start[r].min()), int(end[r].max())
        j = np.arange(lo, hi)[:, None]
        inside = (start[r] <= j) & (j < end[r])
        mask = np.zeros((hi - lo, rows), np.int64)
        taps = np.zeros((hi - lo, rows), np.float32)
        k = r - g * rows
        mask[:, k] = inside
        t = np.clip(j - start[r], 0, bands.taps.shape[1] - 1)
        taps[:, k] = np.where(inside, bands.taps[r, t], 0.0)
        out.append((lo, mask, taps))
    return out


def _needed(groups):
    """Per step: the sorted input rows its groups' spans hold."""
    steps = []
    for s in range(0, len(groups), WARPS):
        rows = [lo + np.flatnonzero(m.any(1)) for lo, m, _ in
                groups[s:s + WARPS]]
        steps.append(np.unique(np.concatenate(rows)).astype(np.int64))
    return steps


def _table_words(rows, max_loads, umax):
    """(group words, step table words): a group's header of 4 words and
    ``umax`` records; a step's header of 4 words, its loads padded to 16
    bytes, its WARPS groups."""
    gw = -(-(4 + umax * _rec_words(rows)) // 4) * 4
    return gw, 4 + -(-2 * max_loads // 4) * 4 + WARPS * gw


def plan(bands):
    """The kernel's launch for :class:`RowBands` ``bands``: the first shape of SHAPES and depth of DEPTHS whose rings fit
    two blocks an SM (SMEM_TWO), else one block (SMEM_MAX).  Raises
    ValueError where no plan fits (spans too wide for shared memory)."""
    p = _plan_or_none(bands)
    if p is None:
        raise ValueError("the operator's row spans are too wide for the "
                         "banded_matmul kernel's shared memory")
    return p


def fits(bands):
    """Whether :func:`plan` finds a launch for ``bands``: a predicate on
    the operator alone, the same on either device, for callers that
    decide their route before any launch."""
    return _plan_or_none(bands) is not None


def _plan_or_none(bands):
    cache = {}
    for budget in (SMEM_TWO, SMEM_MAX):
        for rows, cols in SHAPES:
            if rows not in cache:
                groups = _groups(bands, rows)
                cache[rows] = (_needed(groups),
                               max(m.shape[0] for _, m, _ in groups))
            needed, umax = cache[rows]
            for depth in DEPTHS:
                slots, _ = _rs._ring_slots([needed], depth)
                max_loads = max(n.size for n in needed)
                gw, tw = _table_words(rows, max_loads, umax)
                smem = (slots * 32 * cols + (2 * depth + 1) * tw) * 4
                if smem <= budget:
                    return Plan(rows, cols, depth, slots, len(needed),
                                max_loads, gw, tw, smem)
    return None


def pack(bands):
    """The plan and its step tables for :class:`RowBands` ``bands``, as
    int32 words: per step a header (its load count),
    its loads (input row, ring slot; copies of rows the step before did
    not stage), then per group a header (its record count) and per input
    row of its span a record: the row's ring slot, and for groups of one
    row its tap, else the mask of the rows whose span holds it and the
    group's taps there (0 outside a span)."""
    p = plan(bands)
    groups = _groups(bands, p.rows)
    needed = _needed(groups)
    loads, step_off, where = _rs._schedule([needed], p.slots, p.depth)
    words = np.zeros((p.steps, p.table_words), np.int32)
    goff = 4 + -(-2 * p.max_loads // 4) * 4
    f32 = lambda a: np.asarray(a, np.float32).view(np.int32)  # noqa: E731
    for s in range(p.steps):
        ld = loads[step_off[s]:step_off[s + 1]]
        words[s, 0] = ld.shape[0]
        words[s, 4:4 + ld.size] = ld.ravel()
        for w in range(WARPS):
            lo, mask, taps = groups[s * WARPS + w]
            n = mask.shape[0]
            at = goff + w * p.group_words
            words[s, at] = n
            if n == 0:
                continue
            slot = np.array([where[s].get(lo + u, 0) for u in range(n)],
                            np.int32)
            if p.rows == 1:
                rec = np.stack([slot, f32(taps[:, 0])], 1)
            else:
                bits = (mask << np.arange(p.rows)).sum(1).astype(np.int32)
                pad = np.zeros(n, np.int32)
                rec = np.concatenate([np.stack([slot, bits, pad, pad], 1),
                                      f32(taps)], 1)
            words[s, at + 4:at + 4 + rec.size] = rec.ravel()
    return Packed(p, words.ravel())


class _Args(ctypes.Structure):
    """struct SctBandedMatmul of csrc/banded_matmul.cu."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("tables", ctypes.c_void_p), ("S", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "nout", "rows", "cols", "depth", "slots", "steps",
            "table_words", "max_loads", "group_words", "copy16",
            "store16")]


#: an operator prepared on a device: its output rows, the (nin, S) data
#: shape it was planned for, the Packed, its device copy
Prepared = namedtuple("Prepared", "nout shape packed words")

_PREPARED = OrderedDict()
_PREPARED_SIZE = 8


def prepare(flat, bands):
    """The kernel's step tables for ``bands`` on ``flat`` (a CUDA (nin, S)
    tensor) on its device: planned and packed on the host, then one
    non-blocking copy from pinned memory.  Kept by the operator's bytes,
    S and the current stream, so a later call with the same operator on
    the same stream queues no copy."""
    h = hashlib.sha256()
    for a in bands[:3]:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    key = (str(flat.device), tuple(flat.shape), bands.nin, h.hexdigest())

    def make():
        packed = pack(bands)
        words = torch.from_numpy(packed.words).pin_memory().to(
            flat.device, non_blocking=True)
        return Prepared(int(bands.start.shape[0]), tuple(flat.shape), packed,
                        words)
    return stream_cached(_PREPARED, _PREPARED_SIZE, key, flat.device, make)


@on_tensor_device
def launch(flat, prep):
    """The kernel on ``flat`` with the tables from :func:`prepare`."""
    if tuple(flat.shape) != prep.shape or flat.device != prep.words.device:
        raise ValueError("the prepared operator is for another shape or "
                         "device")
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("the banded_matmul kernel takes contiguous float32 "
                         "data")
    lib = load_library()
    if lib.sct_banded_matmul_warps() != WARPS:
        raise RuntimeError("csrc/banded_matmul.cu and "
                           "kernels/banded_matmul.py disagree on the warps")
    p = prep.packed.plan
    S = flat.shape[1]
    out = torch.empty((prep.nout, S), dtype=torch.float32,
                      device=flat.device)
    vec = p.cols == 4 and S % 4 == 0
    args = _Args(x=flat.data_ptr(), out=out.data_ptr(),
                 tables=prep.words.data_ptr(), S=S, nout=prep.nout,
                 rows=p.rows, cols=p.cols, depth=p.depth, slots=p.slots,
                 steps=p.steps, table_words=p.table_words,
                 max_loads=p.max_loads, group_words=p.group_words,
                 copy16=int(vec and flat.data_ptr() % 16 == 0),
                 store16=int(vec))
    if lib.sct_banded_matmul_smem(ctypes.byref(args)) != p.smem:
        raise RuntimeError("csrc/banded_matmul.cu and "
                           "kernels/banded_matmul.py disagree on the plan")
    check(lib.sct_banded_matmul(ctypes.byref(args), stream_ptr(flat.device)),
          "sct_banded_matmul")
    count_launch(banded_matmul)
    return out


def _check(flat, bands):
    if flat.ndim != 2 or flat.shape[0] != bands.nin:
        raise ValueError(f"flat must be ({bands.nin}, S), got "
                         f"{tuple(flat.shape)}")


@on_tensor_device
def banded_matmul(flat, bands):
    """(nout, S) float32 banded product of ``bands`` (:func:`row_bands`)
    with ``flat`` (nin, S).  A CPU tensor takes the plain version; a CUDA
    tensor the kernel, whose plan :func:`prepare` packs and uploads once
    per operator (ValueError where its spans are too wide for the
    kernel's shared memory): one call launches ``banded_matmul_kernel``
    once on the device, after the plan's upload where it is new."""
    _check(flat, bands)
    if flat.device.type == "cpu":
        return banded_matmul_plain(flat, bands)
    if flat.device.type != "cuda":
        raise ValueError(f"no banded_matmul kernel for device {flat.device}")
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("the banded_matmul kernel takes contiguous float32 "
                         "data")
    nout, S = bands.start.shape[0], flat.shape[1]
    if nout == 0 or S == 0:
        return torch.empty((nout, S), dtype=torch.float32,
                           device=flat.device)
    return launch(flat, prepare(flat, bands))


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
