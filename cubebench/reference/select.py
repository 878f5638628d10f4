"""Exact order statistics of float32 values over a whole cube, without a
sort: a radix select on the values' bit patterns, 16 bits a pass over the
blocks, each pass a histogram (``torch.bincount``)."""

from __future__ import annotations

import torch

_BINS = 1 << 16


def _keys(x):
    """Order-preserving unsigned keys (int64 in [0, 2**32)) of float32
    ``x``: the bit pattern, its magnitude reversed for negative values."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    k = torch.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)
    return k + (1 << 31)


def _value(key):
    k = key - (1 << 31)
    i = -(k + 1) | (-(1 << 31)) if k < 0 else k
    return torch.tensor([i], dtype=torch.int32).view(torch.float32).item()


def order_statistics(blocks, ranks):
    """The float32 values of the 0-based ``ranks`` among the values that
    ``blocks()`` yields (a fresh iterator of 1-D float32 tensors on each
    call), smallest first."""
    ranks = sorted(set(int(r) for r in ranks))
    hist = None
    for v in blocks():
        h = torch.bincount(_keys(v) >> 16, minlength=_BINS)
        hist = h if hist is None else hist + h
    cum = torch.cumsum(hist, 0).cpu()
    tops = {r: int(torch.searchsorted(cum, r, right=True)) for r in ranks}
    below = {r: (int(cum[tops[r] - 1]) if tops[r] else 0) for r in ranks}
    low = {}
    for top in sorted(set(tops.values())):
        h = None
        for v in blocks():
            k = _keys(v)
            k = k[(k >> 16) == top] & (_BINS - 1)
            b = torch.bincount(k, minlength=_BINS)
            h = b if h is None else h + b
        low[top] = torch.cumsum(h, 0).cpu()
    out = {}
    for r in ranks:
        top = tops[r]
        lo = int(torch.searchsorted(low[top], r - below[r], right=True))
        out[r] = _value((top << 16) | lo)
    return out


def median(blocks, n):
    """numpy's median of the ``n`` values ``blocks()`` yields: the lerp of
    the two middle order statistics, in float64, rounded to float32."""
    if n == 0:
        return float("nan")
    pos = 0.5 * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    s = order_statistics(blocks, (lo, hi))
    frac = pos - lo
    return float(torch.tensor(s[lo] * (1.0 - frac) + s[hi] * frac,
                              dtype=torch.float32))
