"""Kernel 6: fused convolve + axis-aligned reproject, and its clean branch.

:func:`conv_reproject` (the fused operator, with the exact chain on
channels that hold NaN) and :func:`plain_strips` (the per-channel banded
apply with no NaN handling) launch ``csrc/conv_reproject.cu`` for a CUDA
tensor and run :func:`conv_reproject_plain` / :func:`plain_strips_plain`,
the same functions in plain PyTorch, for a CPU tensor.
``kernels/pipeline_fused.py`` launches the same source with the moment
planes taken on the way.

The operators come as host arrays:

- :class:`Bands` ``(start, taps)``: the rank-r operator of group g maps
  input to output row o through ``taps[g, i, o, k]`` at input index
  ``start[g, o] + k`` (``start`` is -1 for a row without taps);
  :func:`bands_of` cuts them from dense (G, r, n_out, n_in) matrices, so
  the kernel applies exactly the float32 values the host composed;
- :class:`ConvTaps` ``(taps, half)``: the flipped (r, L) convolution taps
  of ``ops/convolve._tap_stack``; tap k reads input index ``i + k - half``,
  zero outside the plane;
- :class:`Rows2` ``(i0, w0, w1)``: the 2-tap resample, weight ``w0[o]`` at
  ``i0[o]`` and ``w1[o]`` at ``i0[o] + 1`` (clipped to the plane): the rows
  of ``ops/interpolate._interp_matrix``.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..utils import ieee_fp32
from ..profiling import spanned
from ._build import (load_library, check, ptr, stream_ptr, on_tensor_device,
                     count_launch)
from .conv_sep import DEN_EPS, _apply
from .resample2 import POISON, lerp2

__all__ = ["Bands", "ConvTaps", "Rows2", "bands_of", "conv_reproject",
           "conv_reproject_plain", "plain_strips", "plain_strips_plain",
           "plan", "MOMENT_TILE"]

#: input tile (rows, columns) whose spaxels one block of the fused pipeline
#: kernel accumulates, three per thread (csrc/conv_reproject.cu kMomTY,
#: kMomTX)
MOMENT_TILE = (32, 24)

#: output tiles (rows, columns) tried in turn: the first whose block fits
#: twice in an SM's shared memory, else the first that fits once.  128 and
#: 64 columns come first: the x pass gives each of the 8 warps 8 columns,
#: so they keep every warp busy
_OUTPUT_TILES = ((32, 128),) + tuple((32, tx) for tx in range(64, 0, -8)) \
    + ((16, 8), (8, 8), (1, 8))

#: channels per block of the conv + reproject launch
_CHANNELS_PER_BLOCK = 8

#: the kernel's threads per block and shared memory one block may use
#: (csrc/conv_reproject.cu kThreads, kSmemLimit; _launch checks the library
#: agrees), the most a block may take for two blocks to share an SM (228
#: KB less 1 KB reserved per block), a block's output columns at most
#: (kMaxCols), the ranks the kernel is built for, the outputs and ints of
#: one tap descriptor (kBlk, kDesc) and the words of one spaxel's moment
#: state (sizeof(sct::MomentAcc) / 4)
_THREADS = 256
_SMEM_LIMIT = 232448
_TWO_BLOCKS = 233472 // 2 - 1024
_MAX_COLS = 128
_MAX_RANK = 8
_BLK = 8
_DESC = 12
_MOMENT_WORDS = 14


class Bands(NamedTuple):
    start: np.ndarray   # (G, n_out) int32
    taps: np.ndarray    # (G, r, n_out, W) float32

    def dense(self, n_in):
        """The (G, r, n_out, n_in) float32 matrices."""
        G, r, n_out, W = self.taps.shape
        out = np.zeros((G, r, n_out, n_in + W), np.float32)
        cols = np.maximum(self.start, 0)[:, :, None] + np.arange(W)
        np.put_along_axis(out, np.broadcast_to(cols[:, None],
                                               self.taps.shape),
                          self.taps, axis=3)
        return out[..., :n_in]


class ConvTaps(NamedTuple):
    taps: np.ndarray    # (r, L) float32, flipped
    half: int


class Rows2(NamedTuple):
    i0: np.ndarray      # (n_out,) int
    w0: np.ndarray      # (n_out,) float32
    w1: np.ndarray      # (n_out,) float32


def bands_of(mats):
    """:class:`Bands` of dense (G, r, n_out, n_in) operators: each row's
    band spans its first to its last nonzero column over the ranks."""
    A = np.asarray(mats, dtype=np.float32)
    G, r, n_out, n_in = A.shape
    nz = np.any(A != 0.0, axis=1)
    has = nz.any(-1)
    lo = np.where(has, nz.argmax(-1), 0)
    hi = np.where(has, n_in - 1 - nz[..., ::-1].argmax(-1), 0)
    W = int((hi - lo + 1)[has].max()) if has.any() else 1
    cols = lo[..., None] + np.arange(W)
    taps = np.take_along_axis(
        A, np.broadcast_to(np.minimum(cols, n_in - 1)[:, None],
                           (G, r, n_out, W)), axis=3)
    taps = np.where((cols < n_in)[:, None], taps, 0.0).astype(np.float32)
    return Bands(np.where(has, lo, -1).astype(np.int32),
                 np.ascontiguousarray(taps))


def _check(raw, gy, gx, my, mx, ry, rx, valid_plane):
    if raw.ndim != 3:
        raise ValueError(f"raw must be (nchan, ny, nx), got {tuple(raw.shape)}")
    _, ny_in, nx_in = raw.shape
    if gy.taps.shape[0] != 1 or gx.taps.shape[0] != 1 \
            or gy.taps.shape[1] != gx.taps.shape[1] \
            or my.taps.shape[0] != gy.taps.shape[1] \
            or mx.taps.shape[0] != gy.taps.shape[1]:
        raise ValueError("G bands must be one group of rank r and the "
                         "convolution taps (r, L)")
    for rows, n_in, n_out in ((ry, ny_in, gy.start.shape[1]),
                              (rx, nx_in, gx.start.shape[1])):
        i0 = np.asarray(rows.i0)
        if i0.shape != (n_out,) or np.asarray(rows.w0).shape != (n_out,) \
                or np.asarray(rows.w1).shape != (n_out,):
            raise ValueError("resample rows must hold one tap pair per "
                             "output row of G")
        if n_out and (i0.min() < 0 or i0.max() > n_in - 2):
            raise ValueError("resample taps outside the input plane")
    if np.asarray(valid_plane).shape != (gy.start.shape[1],
                                         gx.start.shape[1]):
        raise ValueError("valid_plane must be (ny_out, nx_out)")


@spanned("sct.kernels.conv_reproject")
@on_tensor_device
def conv_reproject(raw, gy, gx, my, mx, ry, rx, valid_plane):
    """(nchan, ny_out, nx_out) fused convolve + resample of ``raw``.

    Clean channels: ``sum_i Gy_i @ Z @ Gx_i^T`` (``gy``/``gx``: one-group
    :class:`Bands` of G = R @ M).  Channels holding NaN: the normalized
    convolution with ``my``/``mx`` (:class:`ConvTaps`), 0 where den <=
    1e-6, resampled by ``ry``/``rx`` (:class:`Rows2`), NaN where the
    resampled NaN flags exceed 1e-6.  All-NaN channels: NaN.  NaN where
    ``valid_plane`` is False.  A CPU tensor takes the plain version; a
    CUDA tensor the kernel: one call launches two kernels on the device,
    ``chan_flags_kernel`` (after a memset of the flags) and
    ``conv_reproject_kernel`` in mode 0."""
    _check(raw, gy, gx, my, mx, ry, rx, valid_plane)
    if raw.device.type == "cpu":
        return conv_reproject_plain(raw, gy, gx, my, mx, ry, rx,
                                    valid_plane)
    out = _launch(0, raw, gy, gx, (my, mx, ry, rx), valid_plane)[0]
    count_launch(conv_reproject)
    return out


conv_reproject.launches = 0


@spanned("sct.kernels.plain_strips")
@on_tensor_device
def plain_strips(x, ybands, xbands, group_idx):
    """(nchan, ny_out, nx_out): ``out[c] = sum_i My[g, i] @ X[c] @
    Mx[g, i]^T`` with g = ``group_idx[c]``, no NaN handling (finite input;
    a NaN spreads along its taps).  A CPU tensor takes the plain version;
    a CUDA tensor the kernel (the clean branch of :func:`conv_reproject`):
    one call launches ``conv_reproject_kernel`` in mode 1 once on the
    device, with no flag pass."""
    if x.ndim != 3:
        raise ValueError(f"x must be (nchan, ny, nx), got {tuple(x.shape)}")
    group_idx = np.asarray(group_idx, dtype=np.int32)
    G = ybands.taps.shape[0]
    if xbands.taps.shape[:2] != ybands.taps.shape[:2] \
            or group_idx.shape != (x.shape[0],):
        raise ValueError("bands must share (G, r); group_idx one per channel")
    if group_idx.size and (group_idx.min() < 0 or group_idx.max() >= G):
        raise ValueError("group_idx out of range")
    if x.device.type == "cpu":
        return plain_strips_plain(x, ybands, xbands, group_idx)
    out = _launch(1, x, ybands, xbands, None, None, group_idx=group_idx)[0]
    count_launch(plain_strips)
    return out


plain_strips.launches = 0


# --------------------------------------------------------------- launch


class _Axis(ctypes.Structure):
    _fields_ = [("perm", ctypes.c_void_p), ("off", ctypes.c_void_p),
                ("win0", ctypes.c_void_p), ("blob", ctypes.c_void_p),
                ("blob_off", ctypes.c_void_p), ("ktaps", ctypes.c_void_p),
                ("i0", ctypes.c_void_p), ("w0", ctypes.c_void_p),
                ("w1", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in
        ("n_in", "n_out", "tiles", "span", "width", "klen", "khalf",
         "max_count", "blob_max", "reach")]


class _Args(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("raw", "group_idx", "flags", "valid", "xc", "include",
                 "out", "planes", "count")] + [
        ("y", _Axis), ("x", _Axis)] + [
        (name, ctypes.c_int) for name in
        ("nchan", "rank", "groups", "mode", "chan_per_block", "cmp_op")] + [
        ("thr", ctypes.c_float), ("mom_ty", ctypes.c_int),
        ("mom_tx", ctypes.c_int)]


def _r4(n):
    return (n + 3) & ~3


def _r8(n):
    return (n + 7) & ~7


def _axis_plan(n_in, bands, tile, conv=None, i0=None, by_input=False):
    """Tiles of one axis: outputs grouped by output tile (or, with
    ``by_input``, by the input tile holding ``i0``), and each tile's input
    window per group, covering its outputs' G bands, the chain's reads
    ``i0 - half .. i0 + L - half`` when ``conv = (L, half)``, and with
    ``by_input`` the input tile itself.  Returns a dict of the launch's
    host arrays and sizes."""
    start = np.asarray(bands.start, np.int64)
    G, n_out = start.shape
    W = bands.taps.shape[3]
    if by_input:
        tiles = max(-(-n_in // tile), 1)
        key = np.asarray(i0, np.int64) // tile
    else:
        tiles = max(-(-n_out // tile), 1)
        key = np.arange(n_out) // tile
    perm = np.argsort(key, kind="stable")
    off = np.searchsorted(key[perm], np.arange(tiles + 1))
    big = np.iinfo(np.int64).max // 4
    empty = start < 0
    lo = np.where(empty, big, start)
    hi = np.where(empty, -big, start + W)
    if conv is not None:
        L, h = conv
        i0 = np.asarray(i0, np.int64)
        lo = np.minimum(lo, i0 - h)
        hi = np.maximum(hi, i0 + L + 1 - h)
    win0 = np.full((G, tiles), big)
    win1 = np.full((G, tiles), -big)
    full = np.nonzero(off[1:] > off[:-1])[0]
    if full.size:
        win0[:, full] = np.minimum.reduceat(lo[:, perm], off[full], axis=1)
        win1[:, full] = np.maximum.reduceat(hi[:, perm], off[full], axis=1)
    t0 = np.arange(tiles) * tile
    if by_input:
        win0 = np.minimum(win0, t0)
        win1 = np.maximum(win1, np.minimum(t0 + tile, n_in))
    unset = win0 == big
    win0 = np.where(unset, t0 if by_input else 0, win0)
    win1 = np.where(win1 < win0 + 1, win0 + 1, win1)
    span = max(int((win1 - win0).max()), W)
    # a row without taps reads zeros from its tile's window
    tile_of = np.empty(n_out, np.int64)
    tile_of[perm] = np.repeat(np.arange(tiles), np.diff(off))
    start = np.where(empty, win0[:, tile_of] if n_out else start, start)
    return dict(perm=perm.astype(np.int32), off=off.astype(np.int32),
                win0=win0.astype(np.int32), start=start, tiles=tiles,
                span=span, max_count=int(np.diff(off).max()) if n_out else 0)


def _blobs(ap, bands, y_axis):
    """The G taps of one axis as the kernel stages them: per (group, tile)
    a blob of int32 words, one descriptor of ``_DESC`` ints per 8
    consecutive outputs of the tile (first input index ``s0``, uniform flag,
    word offset of its taps in the blob, count, each output's start minus
    ``s0``), then the taps, zero-padded to ``W4`` (a multiple of 4) and to
    a rank multiple of 4 along y.  A descriptor is uniform where its bands
    are one band shifted by one index per output, bit for bit; it keeps
    that band alone, as (W4, RP) taps along y and (r, W4) along x.  Any
    other keeps every output's: (8, W4, RP) along y, (8, r, W4) along x.
    Returns ``blob``, ``blob_off`` ((groups * tiles + 1,) word offsets),
    ``blob_max`` (the longest blob), ``reach`` (one past the furthest
    window index the clean branch reads, over every tile: rows along y,
    y-pass columns along x) and ``width`` (W4)."""
    start = ap["start"]
    taps = np.asarray(bands.taps, np.float32)
    G, r, _, W = taps.shape
    W4, RP = _r4(W), _r4(r)
    perm, off, win0 = ap["perm"], ap["off"], ap["win0"]
    parts, sizes, reach = [], [], 1
    for g in range(G):
        for t in range(ap["tiles"]):
            outs = perm[off[t]:off[t + 1]]
            n8 = -(-outs.size // _BLK)
            desc = np.zeros((n8, _DESC), np.int32)
            body, pos = [], _DESC * n8
            for b in range(n8):
                o = outs[_BLK * b:_BLK * (b + 1)]
                s = start[g, o]
                s0 = int(s.min())
                d = s - s0
                tp = taps[g][:, o, :]                      # (r, n, W)
                uniform = bool((d == np.arange(o.size)).all()
                               and (tp == tp[:, :1]).all())
                if uniform:
                    shape = (W4, RP) if y_axis else (r, W4)
                    blk = np.zeros(shape, np.float32)
                    if y_axis:
                        blk[:W, :r] = tp[:, 0, :].T
                    else:
                        blk[:, :W] = tp[:, 0, :]
                    far = s0 + W4 + _BLK - 1
                else:
                    shape = (_BLK, W4, RP) if y_axis else (_BLK, r, W4)
                    blk = np.zeros(shape, np.float32)
                    if y_axis:
                        blk[:o.size, :W, :r] = tp.transpose(1, 2, 0)
                    else:
                        blk[:o.size, :, :W] = tp.transpose(1, 0, 2)
                    far = s0 + int(d.max()) + W4
                reach = max(reach, far - int(win0[g, t]))
                desc[b, :4] = (s0, uniform, pos, o.size)
                desc[b, 4:4 + o.size] = d
                body.append(blk.ravel().view(np.int32))
                pos += blk.size
            parts += [desc.ravel()] + body
            sizes.append(pos)
    return dict(blob=np.concatenate(parts).astype(np.int32),
                blob_off=np.concatenate([[0], np.cumsum(sizes)]).astype(
                    np.int32),
                blob_max=max(sizes), reach=reach, width=W4)


def _axis_struct(ap, n_in, n_out, conv, rows, keep, dev):
    """The :class:`_Axis` of one axis plan ``ap``, its arrays copied to
    ``dev`` (and kept alive in ``keep``)."""
    def t(a, dtype):
        v = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
        keep.append(v)
        return ptr(v)

    s = _Axis()
    for name in ("perm", "off", "win0", "blob", "blob_off"):
        setattr(s, name, t(ap[name], torch.int32))
    s.n_in, s.n_out = n_in, n_out
    for name in ("tiles", "span", "width", "max_count", "blob_max", "reach"):
        setattr(s, name, ap[name])
    s.klen = s.khalf = 0
    if conv is not None:
        s.ktaps = t(conv.taps, torch.float32)
        s.klen, s.khalf = conv.taps.shape[1], int(conv.half)
        s.i0 = t(rows.i0, torch.int32)
        s.w0 = t(rows.w0, torch.float32)
        s.w1 = t(rows.w1, torch.float32)
    return s


def _smem_bytes(mode, rank, py, px, klen_y, klen_x):
    """Shared memory one block of the launch takes, or None where the
    tiling is not one the kernel takes: ``layout()`` of
    ``csrc/conv_reproject.cu`` in Python."""
    sy, sx = py["span"], px["span"]
    if not 1 <= rank <= _MAX_RANK or sy <= 0 or sx <= 0 \
            or px["max_count"] > _MAX_COLS:
        return None
    cy = pcx = qc = rows_c = 0
    if mode != 1:
        cy, cx = sy - klen_y + 1, sx - klen_x + 1
        if cy < 1 or cx < 1 or klen_y < 1 or klen_x < 1:
            return None
        pcx = cx | 1
        qc = _r8(cx) + _r4(klen_x) - 1
        rows_c = _r8(cy) + _r4(klen_y) - 1
    qy = px["reach"]
    pt = max(qy, qc) | 1
    pin = _r4(max(qy, qc) + 3)
    words = (_r4(py["max_count"]) + _r4(px["max_count"])
             + _r4(py["blob_max"]) + _r4(px["blob_max"])
             + (rank * (_r4(klen_y) + _r4(klen_x)) if mode != 1 else 0)
             + max(py["reach"], rows_c) * pin
             + _r4(32 * (_r8(px["max_count"]) | 1)))
    clean = rank * 32 * pt
    chain = _r4(_r8(cy) * pt) + 2 * _r4(cy * pcx) if mode != 1 else 0
    words += _r4(max(clean, chain))
    if mode == 2:
        words += _MOMENT_WORDS * MOMENT_TILE[0] * MOMENT_TILE[1]
    return 4 * words


#: plans by the digest of their operators, and the device copies of a
#: plan's axis arrays by (digest, device)
_PLANS = {}
_DEVICE = {}


def _plan_key(mode, shape, gy, gx, chain):
    h = hashlib.sha1(repr((mode, tuple(shape))).encode())
    for a in (gy.start, gy.taps, gx.start, gx.taps):
        h.update(np.ascontiguousarray(a).tobytes())
    for c in chain or ():
        for a in (c if isinstance(c, tuple) else (c,)):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def plan(mode, shape, gy, gx, chain=None):
    """The tiling of one launch of ``csrc/conv_reproject.cu`` in ``mode``
    (0: conv + reproject, 1: clean only, 2: with the moment planes) on a
    (nchan, ny_in, nx_in) ``shape``: ``(py, px)``, the axis plans (with
    their tap blobs) of the first output tile of ``_OUTPUT_TILES`` (mode
    2: ``MOMENT_TILE``) whose block fits twice in an SM's shared memory,
    else of the first that fits once, or None where none fits, as the TPU
    kernels' planners decline.  ``py["smem"]`` holds the block's bytes.
    ``chain``: ``(my, mx, ry, rx)`` for modes 0 and 2.  Decided from the
    operators alone, before any launch; kept for the operators' bytes."""
    key = _plan_key(mode, shape, gy, gx, chain)
    if key in _PLANS:
        return _PLANS[key]
    _, ny_in, nx_in = shape
    rank = gy.taps.shape[1]
    my = mx = ry = rx = None
    if chain is not None:
        my, mx, ry, rx = chain
    conv_y = None if my is None else (my.taps.shape[1], int(my.half))
    conv_x = None if mx is None else (mx.taps.shape[1], int(mx.half))
    ky = 0 if conv_y is None else conv_y[0]
    kx = 0 if conv_x is None else conv_x[0]
    found = None
    for ty, tx in [MOMENT_TILE] if mode == 2 else _OUTPUT_TILES:
        px = _axis_plan(nx_in, gx, tx, conv_x,
                        None if rx is None else rx.i0, mode == 2)
        if px["max_count"] > _MAX_COLS:
            continue
        py = _axis_plan(ny_in, gy, ty, conv_y,
                        None if ry is None else ry.i0, mode == 2)
        py.update(_blobs(py, gy, True))
        px.update(_blobs(px, gx, False))
        nbytes = _smem_bytes(mode, rank, py, px, ky, kx)
        if nbytes is None or nbytes > _SMEM_LIMIT:
            continue
        py["smem"], py["key"] = nbytes, key
        if nbytes <= _TWO_BLOCKS:
            found = (py, px)
            break
        if found is None:
            found = (py, px)
    if len(_PLANS) >= 32:
        _PLANS.clear()
    _PLANS[key] = found
    return found


def _launch(mode, raw, gy, gx, chain, valid_plane, group_idx=None,
            moments=None):
    """One launch of ``csrc/conv_reproject.cu`` in ``mode`` (0: conv +
    reproject, 1: clean only, 2: with the moment planes).  ``chain``:
    ``(my, mx, ry, rx)`` for modes 0 and 2; ``moments``: ``(xc, cmp_op,
    threshold, include)`` for mode 2.  Returns ``(out, planes, count)``."""
    if raw.device.type != "cuda":
        raise ValueError(f"no conv_reproject kernel for device {raw.device}")
    if raw.dtype != torch.float32 or not raw.is_contiguous():
        raise ValueError("the conv_reproject kernel takes contiguous float32 "
                         "data")
    tiling = plan(mode, raw.shape, gy, gx, chain)
    if tiling is None:
        raise ValueError("the conv_reproject kernel's input window does not "
                         "fit one block's shared memory at this rescaling "
                         "or rank (plan() is None)")
    py, px = tiling
    lib = load_library()
    if lib.sct_conv_reproject_threads() != _THREADS \
            or lib.sct_conv_reproject_smem_limit() != _SMEM_LIMIT:
        raise RuntimeError("csrc/conv_reproject.cu and "
                           "kernels/conv_reproject.py disagree on the "
                           "block's threads or shared memory")
    dev = raw.device
    nchan, ny_in, nx_in = raw.shape
    ny_out, nx_out = gy.start.shape[1], gx.start.shape[1]
    G, r = gy.taps.shape[:2]
    my = mx = ry = rx = None
    if chain is not None:
        my, mx, ry, rx = chain
    keep = []
    a = _Args()
    a.nchan, a.rank, a.groups, a.mode = nchan, r, G, mode
    a.chan_per_block = nchan if mode == 2 else _CHANNELS_PER_BLOCK
    a.mom_ty, a.mom_tx = MOMENT_TILE
    dkey = (py["key"], str(dev))
    if dkey not in _DEVICE:
        if len(_DEVICE) >= 32:
            _DEVICE.clear()
        held = []
        _DEVICE[dkey] = (_axis_struct(py, ny_in, ny_out, my, ry, held, dev),
                         _axis_struct(px, nx_in, nx_out, mx, rx, held, dev),
                         held)
    a.y, a.x, _ = _DEVICE[dkey]
    if lib.sct_conv_reproject_smem(ctypes.byref(a)) != py["smem"]:
        raise RuntimeError("csrc/conv_reproject.cu and "
                           "kernels/conv_reproject.py disagree on the "
                           "shared-memory layout")
    a.raw = ptr(raw)
    if group_idx is not None:
        gi = torch.as_tensor(group_idx, dtype=torch.int32, device=dev)
        keep.append(gi)
        a.group_idx = ptr(gi)
    flags = torch.empty(nchan, dtype=torch.int32, device=dev)
    a.flags = ptr(flags)
    if valid_plane is not None:
        vp = torch.as_tensor(np.ascontiguousarray(valid_plane),
                             dtype=torch.uint8, device=dev)
        keep.append(vp)
        a.valid = ptr(vp)
    out = torch.empty((nchan, ny_out, nx_out), dtype=torch.float32,
                      device=dev)
    a.out = ptr(out)
    planes = count = None
    if mode == 2:
        xc, cmp_op, thr, include = moments
        xc_t = torch.as_tensor(np.asarray(xc, dtype=np.float32), device=dev)
        keep.append(xc_t)
        a.xc = ptr(xc_t)
        a.cmp_op, a.thr = int(cmp_op), float(thr)
        if include is not None:
            inc = include.to(device=dev, dtype=torch.uint8).contiguous()
            keep.append(inc)
            a.include = ptr(inc)
        planes = torch.empty((10, ny_in, nx_in), dtype=torch.float32,
                             device=dev)
        count = torch.empty((ny_in, nx_in), dtype=torch.int32, device=dev)
        a.planes, a.count = ptr(planes), ptr(count)
    err = lib.sct_conv_reproject(ctypes.byref(a), stream_ptr(dev))
    check(err, "sct_conv_reproject")
    return out, planes, count


# ---------------------------------------------------------------- plain


def _dense_apply(x, ybands, xbands, groups):
    """sum_i Gy_i @ x @ Gx_i^T per channel, dense IEEE float32 products,
    ``groups``: the group of each channel of ``x``."""
    _, ny_in, nx_in = x.shape
    dev = x.device
    Gy = torch.as_tensor(ybands.dense(ny_in), device=dev)
    Gx = torch.as_tensor(xbands.dense(nx_in), device=dev)
    out = torch.empty((x.shape[0], Gy.shape[2], Gx.shape[2]),
                      dtype=torch.float32, device=dev)
    with ieee_fp32():
        for g in range(Gy.shape[0]):
            chans = torch.nonzero(torch.as_tensor(groups, device=dev) == g) \
                .flatten()
            for c0 in range(0, chans.numel(), 64):
                sel = chans[c0:c0 + 64]
                xs = x[sel]
                acc = None
                for i in range(Gy.shape[1]):
                    term = torch.matmul(torch.matmul(Gy[g, i], xs),
                                        Gx[g, i].T)
                    acc = term if acc is None else acc + term
                out[sel] = acc
    return out


def plain_strips_plain(x, ybands, xbands, group_idx):
    """:func:`plain_strips` in plain PyTorch: dense float32 products."""
    return _dense_apply(x.to(torch.float32), ybands, xbands,
                        np.asarray(group_idx, dtype=np.int64))


def _chain(x, my, mx, ry, rx):
    """The exact chain on channels that hold NaN: normalized convolution
    (conv_sep's ``_apply``, y taps, x taps, ranks in order), 0 where den
    <= 1e-6, then the 2-tap resample with NaN-flag poisoning."""
    dev = x.device
    fy = torch.as_tensor(my.taps, dtype=torch.float32, device=dev)
    fx = torch.as_tensor(mx.taps, dtype=torch.float32, device=dev)
    bad = torch.isnan(x)
    num = _apply(torch.where(bad, 0.0, x), fy, fx, int(my.half),
                 int(mx.half))
    den = 1.0 - _apply(bad.to(torch.float32), fy, fx, int(my.half),
                       int(mx.half))
    nanc = den <= DEN_EPS
    c = torch.where(nanc, 0.0, num / torch.where(nanc, 1.0, den))
    val = lerp2(c, ry, rx)
    wn = lerp2(nanc.to(torch.float32), ry, rx)
    return torch.where(wn > POISON, float("nan"), val)


def conv_reproject_plain(raw, gy, gx, my, mx, ry, rx, valid_plane):
    """:func:`conv_reproject` in plain PyTorch: dense float32 products of
    G on clean channels, the chain of :func:`_chain` on the others."""
    _check(raw, gy, gx, my, mx, ry, rx, valid_plane)
    x = raw.to(torch.float32)
    dev = x.device
    nchan = x.shape[0]
    ny_out, nx_out = gy.start.shape[1], gx.start.shape[1]
    isnan = torch.isnan(x).flatten(1)
    has_nan, has_value = isnan.any(1), (~isnan).any(1)
    out = torch.full((nchan, ny_out, nx_out), float("nan"),
                     dtype=torch.float32, device=dev)
    clean = torch.nonzero(~has_nan & has_value).flatten()
    if clean.numel():
        out[clean] = _dense_apply(x[clean], gy, gx,
                                  np.zeros(clean.numel(), np.int64))
    dirty = torch.nonzero(has_nan & has_value).flatten()
    for c0 in range(0, dirty.numel(), 32):
        sel = dirty[c0:c0 + 32]
        out[sel] = _chain(x[sel], my, mx, ry, rx)
    ok = torch.as_tensor(np.asarray(valid_plane, bool), device=dev)
    return torch.where(ok[None], out, float("nan"))
