"""The plain reference of ``sigma_clip_spectrally``: each spectrum
clipped as astropy's ``sigma_clip`` does (cenfunc median, stdfunc std,
population std): over the sorted finite values the band keeps those
within sigma * std of the band's median, its statistics in float64,
``maxiters`` times; the values outside the last band NaN."""

from __future__ import annotations

import torch


def clip_spectra(x, sigma, maxiters):
    """astropy ``sigma_clip`` along axis 1 of (spectra, n) float32 ``x``:
    clipped and non-finite values NaN."""
    s = torch.sort(x, dim=1).values
    fin = torch.isfinite(s)
    n = x.shape[1]
    lo = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    hi = fin.sum(1)
    pos = torch.arange(n, device=x.device)[None, :]
    s64 = torch.where(fin, s, 0.0).double()
    lo_v = hi_v = None
    for _ in range(maxiters):
        cnt = hi - lo
        live = cnt > 0
        c = torch.clamp(cnt, min=1)
        band = (pos >= lo[:, None]) & (pos < hi[:, None])
        mean = torch.where(band, s64, 0.0).sum(1) / c
        dev = torch.where(band, s64 - mean[:, None], 0.0)
        std = torch.sqrt((dev * dev).sum(1) / c)
        last = torch.clamp(hi - 1, min=0)
        a = torch.gather(s64, 1, torch.clamp(lo + (cnt - 1) // 2, min=0)
                         .minimum(last)[:, None])[:, 0]
        b = torch.gather(s64, 1, torch.clamp(lo + cnt // 2, min=0)
                         .minimum(last)[:, None])[:, 0]
        centre = 0.5 * (a + b)
        lo_v, hi_v = centre - sigma * std, centre + sigma * std
        below = (fin & (s64 < lo_v[:, None])).sum(1)
        upto = (fin & (s64 <= hi_v[:, None])).sum(1)
        lo = torch.where(live, torch.maximum(lo, below), lo)
        hi = torch.where(live, torch.minimum(hi, upto), hi)
    cnt = hi - lo
    last = torch.clamp(hi - 1, min=0)
    first = torch.clamp(lo, max=n - 1)
    kmin = torch.gather(s, 1, first[:, None])
    kmax = torch.gather(s, 1, last[:, None])
    keep = torch.isfinite(x) & (cnt > 0)[:, None] & (x >= kmin) & (x <= kmax)
    return torch.where(keep, x, float("nan"))
