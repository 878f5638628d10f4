"""Interpolation operators.

Only the 2-tap interpolation-matrix builder of
``spectral_cube_tpu/ops/interpolate.py`` is ported so far (the reproject
tests build reference operators with it).  Spectral interpolation and
smoothing follow in ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_interp_matrix"]


def _interp_matrix(idx, frac, nin):
    """(nout, nin) 2-tap linear-interpolation matrix.  Zero-weight taps are
    simply absent, preserving np.interp's exact-hit semantics (a NaN
    zero-weight neighbor must not poison the result)."""
    nout = idx.shape[0]
    mat = np.zeros((nout, nin), dtype=np.float32)
    rows = np.arange(nout)
    np.add.at(mat, (rows, idx), (1.0 - frac).astype(np.float32))
    np.add.at(mat, (rows, idx + 1), frac.astype(np.float32))
    return mat
