"""Arithmetic of the plain reference: IEEE float32 as the configurations
state it, or the control's lower precision.

The control is the reference computed in TF32, the precision below IEEE
float32 that a library matrix product takes when TF32 is switched on: the
operands of every product a matrix product would form (a convolution's
taps and data, a lerp's weights and values, a moment's data and
coordinates) are rounded to 10 mantissa bits, and the products are summed
in float32.  The rounding is done here, in plain tensor operations, so
the control does not depend on which library routine a device picks.
"""

from __future__ import annotations

import torch

#: mantissa bits of TF32 (float32 has 23)
TF32_BITS = 10


def round_mantissa(x, bits):
    """``x`` (float32) rounded to ``bits`` mantissa bits, to nearest, ties
    away from zero (the conversion ``cvt.rna.tf32.f32`` makes); non-finite
    values pass unchanged."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    r = ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


class Arith:
    """How the reference rounds the operands of its products: ``bits`` None
    for IEEE float32, :data:`TF32_BITS` for the control."""

    def __init__(self, bits=None):
        self.bits = bits

    def __call__(self, x):
        if self.bits is None:
            return x
        if not torch.is_tensor(x):
            x = torch.as_tensor(x, dtype=torch.float32)
        return round_mantissa(x.to(torch.float32), self.bits)


IEEE = Arith()
TF32 = Arith(TF32_BITS)
