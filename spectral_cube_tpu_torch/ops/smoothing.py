"""Spatial/spectral smoothing operators.

Only the banded convolution-matrix builder of
``spectral_cube_tpu/ops/smoothing.py`` is ported so far: the separable
convolution (ops/convolve.py) takes its tap flip and offset from it.  The
spectral smoothing, median filters and sigma clipping follow in ROADMAP.md
Queue 1 item 8.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_banded_conv_matrix", "banded_tap_offset"]


def banded_tap_offset(n_taps):
    """Centre offset of a kernel of ``n_taps`` taps: flipped tap ``o``
    lands on input index ``i + o - banded_tap_offset(n_taps)``."""
    return n_taps - 1 - (n_taps - 1) // 2


def _banded_conv_matrix(n, kernel):
    """(n, n) banded true-convolution matrix with zero-fill boundary.

    The kernel is flipped so asymmetric kernels match np.convolve
    'same' / astropy convolve semantics (convolution, not correlation)."""
    k = np.asarray(kernel, dtype=np.float32)[::-1]
    half = len(k) - 1 - (len(k) - 1) // 2
    mat = np.zeros((n, n), dtype=np.float32)
    for o, kv in enumerate(k):
        d = o - half
        idx = np.arange(max(0, -d), min(n, n - d))
        mat[idx, idx + d] = kv
    return mat
