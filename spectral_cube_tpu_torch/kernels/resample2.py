"""Kernel 3: axis-aligned 2-tap bilinear resample.

:func:`resample2` (from raw, NaN-carrying data) and :func:`resample2_filled`
(from NaN-filled data with a separate NaN-weight plane) launch
``csrc/resample2.cu`` for a CUDA tensor and run :func:`resample2_plain` /
:func:`resample2_filled_plain`, the same functions in plain PyTorch, for a
CPU tensor.  Output row i reads input rows ``y0[i]`` and ``y0[i] + 1``
(clipped to the plane) with weights ``1 - wy[i]`` and ``wy[i]``; columns
likewise.

Both entries launch one kernel, laid out on the host.  :func:`plan` picks
the strip width, the rows a block walks, the staging form and the ring of
input rows in shared memory from the shapes and the taps (two planes of
slots for the filled entry where a channel's NaN weights are staged
beside its values); :func:`pack_taps` writes the plan's tables, the taps,
the validity bits and the channel flags into one int32 buffer, which
:func:`prepare` uploads with one non-blocking copy from pinned memory (and
keeps, keyed by its bytes, so a later call with the same taps uploads
nothing); :func:`launch` runs the kernel on a prepared layout.
"""

from __future__ import annotations

import ctypes
import hashlib
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from ..profiling import spanned
from ._build import (load_library, check, stream_ptr, on_tensor_device,
                     count_launch, stream_cached)

__all__ = ["resample2", "resample2_plain", "resample2_filled",
           "resample2_filled_plain", "lerp2", "POISON", "plan", "pack_taps",
           "prepare", "launch"]

#: NaN-weight threshold of the poisoning rule (banded_pallas.py:45)
POISON = 1e-6

#: warps of a raw-kernel block; output rows a step (two a warp),
#: kStepRows in csrc/resample2.cu
WARPS = 8
STEP_ROWS = 2 * WARPS
#: steps whose copies are in flight while a step computes
DEPTH = 2
#: strip widths, widest first: 4, 2 or 1 outputs a lane
WIDTHS = (128, 64, 32)
#: shared bytes a span plan may take (two blocks an SM at least); past it
#: the plan narrows the strip, and past the narrowest it lists columns
SMEM_SPAN = 100 * 1024
#: shared bytes a block may take on an H100, less static ones
SMEM_MAX = 232448 - 1024
#: blocks that fill the card several times over (132 SMs)
TARGET_BLOCKS = 132 * 8
#: steps a row tile walks at least
MIN_TILE_STEPS = 4
#: staging forms of the raw kernel, their codes in csrc/resample2.cu: the
#: strip's contiguous input span in 16-byte or 4-byte copies, or its
#: listed input columns in 4-byte copies
FORMS = {"span16": 0, "span4": 1, "list": 2}

#: output rows a tile holds at most (its tables sit in shared memory)
MAX_TILE_ROWS = 1024

#: the kernel's launch: strip ``width`` (columns), 16-byte stores of 4
#: adjacent outputs, staging ``form`` (a key of FORMS), output rows a block
#: walks, row tiles, ring ``depth`` (steps in flight), ring ``slots``
#: (input rows) of ``pitch`` floats in each of ``planes`` (2: the filled
#: entry's NaN weights beside its values), the most row loads a tile
#: lists, shared bytes (ring, store buffers and the tile's tables)
Plan = namedtuple("Plan", "width store16 form tile_rows tiles depth slots "
                  "pitch max_loads smem planes")


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


def _needed(y0, ny_in, tile_rows, tiles):
    """Per row tile, per step of STEP_ROWS output rows: the sorted input
    rows the step reads (y0 and y0 + 1, clipped to the plane)."""
    ya = np.asarray(y0, np.int64)
    yb = np.minimum(ya + 1, ny_in - 1)
    out = []
    for t in range(tiles):
        steps = []
        for s in range(tile_rows // STEP_ROWS):
            i = t * tile_rows + s * STEP_ROWS
            r = slice(i, min(i + STEP_ROWS, ya.size))
            steps.append(np.unique(np.concatenate([ya[r], yb[r]]))
                         if i < ya.size else np.zeros(0, np.int64))
        out.append(steps)
    return out


def _ring_slots(needed, depth):
    """(slots, loads): the slots a ring needs, the most input rows that
    any step and the ``depth`` steps before it read together (the copies
    of a step go in while those steps may still read their rows); and a
    bound on the loads a tile lists, each step's rows that the step before
    did not read (a row two steps read stays in its slot)."""
    most, loads = 1, 0
    for steps in needed:
        n = 0
        for s in range(len(steps)):
            live = np.unique(np.concatenate(steps[max(0, s - depth):s + 1]))
            most = max(most, live.size)
            n += steps[s].size if s == 0 else np.setdiff1d(
                steps[s], steps[s - 1], assume_unique=True).size
        loads = max(loads, n)
    return most, loads


def _tiling(ny_out, nchan, nstrips):
    """(tile_rows, tiles): the whole plane a block where the channels and
    strips alone fill the card, else row tiles until they do, each of
    MIN_TILE_STEPS steps at least (the ring's copies run ahead within a
    tile)."""
    steps = -(-ny_out // STEP_ROWS)
    want = -(-TARGET_BLOCKS // max(1, nchan * nstrips))
    tiles = max(1, min(-(-steps // MIN_TILE_STEPS), want),
                -(-ny_out // MAX_TILE_ROWS))
    tile_rows = -(-steps // tiles) * STEP_ROWS
    return tile_rows, -(-ny_out // tile_rows)


def _strips(x0, nx_in, width, form):
    """Per strip of ``width`` output columns: (first staged column, staged
    count), the staged positions of each column's two taps, and for the
    list form the staged columns (ns, count) padded with the last."""
    xa = np.asarray(x0, np.int64)
    ns = -(-xa.size // width)
    xa = np.pad(xa, (0, ns * width - xa.size), mode="edge").reshape(ns,
                                                                     width)
    xb = np.minimum(xa + 1, nx_in - 1)
    if form == "list":
        lists = [np.unique(np.concatenate([a, b])) for a, b in zip(xa, xb)]
        pa = np.stack([np.searchsorted(l, a) for l, a in zip(lists, xa)])
        pb = np.stack([np.searchsorted(l, b) for l, b in zip(lists, xb)])
        count = np.array([l.size for l in lists], np.int64)
        cols = np.stack([np.pad(l, (0, width * 2 - l.size), mode="edge")
                         for l in lists])
        return np.stack([np.zeros(ns, np.int64), count], 1), pa, pb, cols
    lo, hi = xa.min(1), xb.max(1)
    if form == "span16":
        lo = lo & ~3
        count = ((hi + 4) & ~3) - lo
    else:
        count = hi - lo + 1
    return (np.stack([lo, count], 1), xa - lo[:, None], xb - lo[:, None],
            None)


def plan(y0, x0, ny_in, nx_in, nchan, aligned=True, planes=1):
    """The kernel's launch for taps ``y0`` (ny_out,) and ``x0`` (nx_out,)
    on (nchan, ny_in, nx_in) data: the widest strip (128, 64 or 32
    columns) whose ring of input-row spans, ``planes`` of them (2 where
    the filled entry stages NaN weights too), fits SMEM_SPAN, staged in
    16-byte copies where the input rows are 16-byte aligned (``nx_in % 4
    == 0`` and the base ``aligned``), else 4-byte copies; where no width's
    spans fit (columns far apart), 128 columns whose listed input columns
    are staged instead.  The ring holds the input rows of DEPTH + 1
    steps; row tiles split the plane only where the channels and strips
    give too few blocks."""
    y0 = np.asarray(y0, np.int64)
    x0 = np.asarray(x0, np.int64)
    ny_out, nx_out = y0.size, x0.size
    if ny_out < 1 or nx_out < 1:
        raise ValueError("the resample has no output")
    span = "span16" if aligned and nx_in % 4 == 0 else "span4"
    cache = {}

    def choice(width, form):
        tiling = _tiling(ny_out, nchan, -(-nx_out // width))
        if tiling not in cache:
            cache[tiling] = _ring_slots(_needed(y0, ny_in, *tiling), DEPTH)
        slots, loads = cache[tiling]
        count = _strips(x0, nx_in, width, form)[0][:, 1]
        pitch = max(4, int(-(-count.max() // 4) * 4))
        store16 = width == 128 and nx_out % 4 == 0
        tile_rows = tiling[0]
        tables = ((2 + width // 32) * tile_rows
                  + ((tile_rows // STEP_ROWS + 2) & ~1) + 2 * loads)
        smem = (planes * slots * pitch + (WARPS * 128 if store16 else 0)
                + tables) * 4
        return Plan(width, store16, form, *tiling, DEPTH, slots, pitch,
                    loads, smem, planes)

    for width in WIDTHS:
        p = choice(width, span)
        if p.smem <= SMEM_SPAN:
            return p
    return choice(WIDTHS[0], "list")


def _schedule(needed, slots, depth):
    """The ring's loads: per step (all tiles in turn) the (input row,
    slot) pairs to copy, and for each step the slot of every input row it
    reads.  A row stays in its slot while later steps read it; new rows
    take slots that no step from ``depth`` steps back up to this one
    reads, empty ones first, then the least recently read."""
    loads, step_off, where = [], [0], []
    for steps in needed:
        slot_row = np.full(slots, -1, np.int64)
        last = np.full(slots, -1, np.int64)
        row_slot = {}
        for s, rows in enumerate(steps):
            live = np.unique(np.concatenate(steps[max(0, s - depth):s + 1]))
            new = [r for r in rows.tolist() if r not in row_slot]
            if new:
                free = np.flatnonzero(~np.isin(slot_row, live))
                order = np.lexsort((free, last[free], slot_row[free] >= 0))
                for r, q in zip(new, free[order][:len(new)].tolist()):
                    if slot_row[q] >= 0:
                        del row_slot[int(slot_row[q])]
                    slot_row[q] = r
                    row_slot[r] = q
                    loads.append((r, q))
            for r in rows.tolist():
                last[row_slot[r]] = s
            where.append({r: row_slot[r] for r in rows.tolist()})
            step_off.append(len(loads))
    return (np.asarray(loads, np.int64).reshape(-1, 2),
            np.asarray(step_off, np.int64), where)


#: int32 words of the packed taps: each section starts on 16 bytes
_SECTIONS = ("rows", "cols", "strips", "list", "step_off", "loads", "valid",
             "zvalid", "wflags")

#: what :func:`pack_taps` returns: the plan, the int32 words and each
#: section's word offset
Packed = namedtuple("Packed", "plan words offsets")


def pack_taps(shape, y0, wy, x0, wx, valid_plane, zvalid, aligned=True,
              wflags=None):
    """The kernel's tables for (nchan, ny_in, nx_in) ``shape`` and checked
    taps (:func:`_host_taps`), in one int32 buffer: per output row its two
    ring slots (``a | b << 16``) and ``wy``; per strip column its two
    staged positions and ``wx``; per strip its first staged column and
    count; the list form's staged columns; the ring's loads per step;
    validity bits (bit j % 32 of word j // 32 of row i); one word per
    channel's ``zvalid``; for the filled entry one word per channel's
    ``wflags`` (None for the raw entry: no section), whose planes the plan
    doubles where any channel is flagged."""
    nchan, ny_in, nx_in = shape
    planes = 2 if wflags is not None and np.any(wflags) else 1
    p = plan(y0, x0, ny_in, nx_in, nchan, aligned, planes)
    needed = _needed(y0, ny_in, p.tile_rows, p.tiles)
    loads, step_off, where = _schedule(needed, p.slots, p.depth)
    steps = p.tile_rows // STEP_ROWS
    if np.diff(step_off[::steps]).max() > p.max_loads:
        raise RuntimeError("a tile lists more loads than its plan holds")
    ya = np.asarray(y0, np.int64)
    yb = np.minimum(ya + 1, ny_in - 1)
    slot_a = np.empty(ya.size, np.int64)
    slot_b = np.empty(ya.size, np.int64)
    for i in range(ya.size):
        w = where[i // STEP_ROWS]
        slot_a[i], slot_b[i] = w[int(ya[i])], w[int(yb[i])]
    f32 = lambda a: np.asarray(a, np.float32).view(np.int32)  # noqa: E731
    rows = np.stack([slot_a | slot_b << 16,
                     f32(wy).astype(np.int64)], 1)
    strips, pa, pb, lists = _strips(x0, nx_in, p.width, p.form)
    wxp = np.pad(np.asarray(wx, np.float32), (0, pa.size - len(wx)))
    cols = np.stack([(pa | pb << 16).ravel(), f32(wxp).astype(np.int64)], 1)
    if lists is None:
        lists = np.zeros(0, np.int64)
    else:
        lists = lists[:, :p.pitch]             # pitch <= 2 * width
    bits = np.packbits(np.asarray(valid_plane, bool), axis=1,
                       bitorder="little")
    bits = np.pad(bits, ((0, 0), (0, -bits.shape[1] % 4)))
    valid = np.ascontiguousarray(bits).view("<u4").view(np.int32)
    parts = dict(rows=rows, cols=cols, strips=strips, list=lists,
                 step_off=step_off, loads=loads, valid=valid,
                 zvalid=np.asarray(zvalid, np.int64),
                 wflags=np.zeros(0, np.int64) if wflags is None
                 else np.asarray(wflags, np.int64))
    offsets, n = {}, 0
    for name in _SECTIONS:
        offsets[name] = n
        n += -(-np.asarray(parts[name]).size // 4) * 4
    words = np.zeros(max(n, 4), np.int32)
    for name in _SECTIONS:
        a = np.asarray(parts[name]).ravel()
        words[offsets[name]:offsets[name] + a.size] = a
    return Packed(p, words, offsets)


class _Args(ctypes.Structure):
    """struct SctResample2 of csrc/resample2.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in ("raw", "wz", "out")
                + _SECTIONS] + [
        (name, ctypes.c_int) for name in (
            "nchan", "ny_in", "nx_in", "ny_out", "nx_out", "width",
            "tile_rows", "tiles", "steps", "depth", "slots", "pitch",
            "form", "store16", "vwords", "max_loads", "planes")]


#: taps prepared on a device: the data's shape and alignment they were
#: packed for, the output's (ny_out, nx_out), the Packed, its device copy,
#: and whether they are the filled entry's (channel flags packed)
Prepared = namedtuple("Prepared", "shape aligned out_shape packed words "
                      "filled")

_PREPARED = OrderedDict()
_PREPARED_SIZE = 8


def _host_flags(wz_any):
    """The filled entry's channel flags on the host (one small read where
    they lie on the card)."""
    if isinstance(wz_any, torch.Tensor):
        wz_any = wz_any.cpu().numpy()
    return np.asarray(wz_any, dtype=bool)


def prepare(raw, y0, wy, x0, wx, valid_plane, zvalid=None, wz=None,
            wz_any=None):
    """The kernel's packed taps for ``raw`` (a CUDA tensor; the filled
    entry's ``fz``, with its NaN weights ``wz`` and channel flags
    ``wz_any``) on its device: checked and packed on the host, then one
    non-blocking copy from pinned memory.  Kept by the taps' bytes and
    the current stream, so a later call with the same taps and shape on
    the same stream queues no copy."""
    y0, wy, x0, wx, valid_plane, zvalid = _host_taps(
        raw, y0, wy, x0, wx, valid_plane, zvalid)
    filled = wz is not None
    flags = _host_flags(wz_any) if filled else None
    aligned = raw.data_ptr() % 16 == 0 and (
        not filled or wz.data_ptr() % 16 == 0)
    h = hashlib.sha256()
    for a in (y0, wy, x0, wx, np.packbits(valid_plane, axis=None), zvalid) \
            + ((flags,) if filled else ()):
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    key = (str(raw.device), tuple(raw.shape), aligned, valid_plane.shape,
           filled, h.hexdigest())

    def make():
        packed = pack_taps(tuple(raw.shape), y0, wy, x0, wx, valid_plane,
                           zvalid, aligned, flags)
        words = torch.from_numpy(packed.words).pin_memory().to(
            raw.device, non_blocking=True)
        return Prepared(tuple(raw.shape), aligned, valid_plane.shape, packed,
                        words, filled)
    return stream_cached(_PREPARED, _PREPARED_SIZE, key, raw.device, make)


@on_tensor_device
def launch(raw, prep, wz=None):
    """The kernel on ``raw`` (the filled entry's ``fz``, with ``wz``) with
    taps from :func:`prepare`."""
    if tuple(raw.shape) != prep.shape or raw.device != prep.words.device:
        raise ValueError("the prepared taps are for another shape or device")
    if (wz is not None) != prep.filled:
        raise ValueError("the prepared taps are for the other entry")
    data = (raw,) if wz is None else (raw, wz)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.shape != raw.shape or t.device != raw.device for t in data):
        raise ValueError("the resample kernel takes contiguous float32 data "
                         "of one shape on one device")
    if prep.aligned and any(t.data_ptr() % 16 != 0 for t in data):
        raise ValueError("the prepared taps are for 16-byte aligned data")
    lib = load_library()
    if lib.sct_resample2_step_rows() != STEP_ROWS:
        raise RuntimeError("csrc/resample2.cu and kernels/resample2.py "
                           "disagree on the rows of a step")
    p, off = prep.packed.plan, prep.packed.offsets
    nchan, ny_in, nx_in = raw.shape
    ny_out, nx_out = prep.out_shape
    out = torch.empty((nchan, ny_out, nx_out), dtype=torch.float32,
                      device=raw.device)
    base = prep.words.data_ptr()
    args = _Args(raw=raw.data_ptr(),
                 wz=None if wz is None else wz.data_ptr(),
                 out=out.data_ptr(),
                 **{name: base + 4 * off[name] for name in _SECTIONS},
                 nchan=nchan, ny_in=ny_in, nx_in=nx_in, ny_out=ny_out,
                 nx_out=nx_out, width=p.width, tile_rows=p.tile_rows,
                 tiles=p.tiles, steps=p.tile_rows // STEP_ROWS,
                 depth=p.depth, slots=p.slots, pitch=p.pitch,
                 form=FORMS[p.form], store16=int(p.store16),
                 vwords=-(-nx_out // 32), max_loads=p.max_loads,
                 planes=p.planes)
    if lib.sct_resample2_smem(ctypes.byref(args)) != p.smem:
        raise RuntimeError("csrc/resample2.cu and kernels/resample2.py "
                           "disagree on the plan")
    check(lib.sct_resample2(ctypes.byref(args), stream_ptr(raw.device)),
          "sct_resample2")
    if wz is None:
        count_launch(resample2)
    else:
        count_launch(resample2_filled)
    return out


@spanned("sct.kernels.resample2")
@on_tensor_device
def resample2(raw, y0, wy, x0, wx, valid_plane, zvalid=None):
    """(nchan, ny_out, nx_out) resample of ``raw``: out = sum w *
    nan_to_num(Z), NaN where the NaN weight exceeds :data:`POISON`, where
    ``valid_plane`` is False and where ``zvalid`` is False.  A CPU tensor
    takes the plain version; a CUDA tensor the kernel: one call launches
    ``resample2_kernel`` (kFilled false) once on the device, after the
    taps' upload where they are new."""
    if raw.ndim != 3:
        raise ValueError(f"raw must be (nchan, ny, nx), got {tuple(raw.shape)}")
    if raw.device.type == "cpu":
        return resample2_plain(raw, y0, wy, x0, wx, valid_plane, zvalid)
    if raw.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {raw.device}")
    if raw.dtype != torch.float32 or not raw.is_contiguous():
        raise ValueError("the resample kernel takes contiguous float32 data")
    return launch(raw, prepare(raw, y0, wy, x0, wx, valid_plane, zvalid))


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


@spanned("sct.kernels.resample2_filled")
@on_tensor_device
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
    A CPU tensor takes the plain version; a CUDA tensor the kernel, whose
    taps, plan and flags :func:`prepare` packs into one upload: one call
    launches ``resample2_kernel`` (kFilled true) once on the device."""
    _check_filled(fz, wz, wz_any)
    taps = _host_taps(fz, y0, wy, x0, wx, valid_plane, zvalid)
    if fz.device.type == "cpu":
        return resample2_filled_plain(fz, wz, wz_any, *taps)
    if fz.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {fz.device}")
    return launch(fz, prepare(fz, *taps, wz=wz, wz_any=wz_any), wz)


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
