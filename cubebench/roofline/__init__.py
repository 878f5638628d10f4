"""Least device time of a stage: the larger of its bytes over the card's
HBM bandwidth and its float32 operations over the card's float32 rate
(``peaks.json``).  Each stage's counts are a module of its own here,
``<stage>.py`` with ``counts(config, mix, shape) -> (bytes, flops)``, from
the cell's shapes and the configuration's numbers alone: the same work
whatever implements the stage."""

from __future__ import annotations

import json
from pathlib import Path

from .. import found

HERE = Path(__file__).resolve().parent


def peaks():
    with open(HERE / "peaks.json") as f:
        return json.load(f)


def counts(stage, config, mix, shape):
    """(bytes, flops) of ``stage``, or None where no module counts it."""
    mod = found("roofline", stage)
    return None if mod is None else mod.counts(config, mix, shape)


def least_seconds(stage, config, mix, shape):
    """(seconds, "bytes" or "flops") of the stage's least time, or None."""
    c = counts(stage, config, mix, shape)
    if c is None:
        return None
    p = peaks()
    by_bytes = c[0] / p["hbm_bytes_per_s"]
    by_flops = c[1] / p["fp32_flops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops,
                                                             "flops")
