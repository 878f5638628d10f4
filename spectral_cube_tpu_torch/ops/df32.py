"""Double-float32 (pair) arithmetic for cancellation-safe finalization.

The moments kernel (csrc/moments.cu) accumulates its sums across channel
chunks as *compensated pairs* (hi, lo), and the finalization below
evaluates the catastrophically cancelling forms

    mom2 = S2/S0 - (S1/S0)^2          (reference _moments.py mom2)
    d2   = Q - S0^2/n                 (per-spaxel centered second moment)

entirely in pair arithmetic (~1e-14 relative), so a narrow line far from
the coordinate center keeps the two-pass kernel's accuracy without a
second pass over the cube.  Reference math being matched:
``spectral_cube/_moments.py:170-193``.

Implementation notes (all standard error-free transforms):
- ``two_sum`` is Knuth's branch-free 6-op exact add.
- ``two_prod`` uses the Dekker/Veltkamp split (2^12+1 for the 24-bit f32
  significand); exact under round-to-nearest, which eager PyTorch keeps:
  every operation below is its own rounded op, never contracted.
- Pairs are kept normalized (|lo| <= ulp(hi)/2) by a final two_sum.
"""

from __future__ import annotations

import torch

__all__ = ["two_sum", "two_prod", "df_add", "df_sub", "df_mul",
           "df_div", "df_collapse", "neumaier_add"]

# 2**12 + 1 for float32's 24-bit mantissa
_SPLIT = 4097.0


def two_sum(a, b):
    """Error-free add: a + b = s + e exactly (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free multiply: a * b = p + e exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x, y):
    """(xh, xl) + (yh, yl) -> normalized pair."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return two_sum(s, e)


def df_sub(x, y):
    return df_add(x, (-y[0], -y[1]))


def df_mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return two_sum(p, e)


def df_div(x, y):
    """Pair division via one Newton correction of the quotient."""
    q1 = x[0] / y[0]
    # r = x - q1 * y, in pair arithmetic
    p = df_mul((q1, torch.zeros_like(q1)), y)
    r = df_sub(x, p)
    q2 = (r[0] + r[1]) / y[0]
    return two_sum(q1, q2)


def df_collapse(x):
    return x[0] + x[1]


def neumaier_add(hi, lo, v):
    """One compensated accumulation step: returns updated (hi, lo).

    The pair (hi, lo) tracks the running sum; errors collect in ``lo``
    (Neumaier's variant of Kahan, correct also when |v| > |hi|)."""
    s = hi + v
    big = torch.abs(hi) >= torch.abs(v)
    e = torch.where(big, (hi - s) + v, (v - s) + hi)
    return s, lo + e
