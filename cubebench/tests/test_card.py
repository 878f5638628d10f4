"""On the card: a short run of the smallest cell, untraced and traced,
prints the contract's last line with ``correct`` true.  Skips without a
card."""

import json
import subprocess
import sys

import pytest


def _run(root, trace):
    out = subprocess.run(
        [sys.executable, "cubebench/run.py", "--workload", "casa623.spectral",
         "--seed", str(2 ** 31 + 4242 + trace), "--seconds", "2",
         "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_a_short_run_on_the_card(root, cuda):
    r = _run(root, 0)
    assert r["correct"], r["compared"]
    assert {"cube_s", "peak_gib", "setup_s"} == set(r["metrics"])
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_a_traced_run_on_the_card(root, cuda):
    r = _run(root, 1)
    assert r["correct"], r["compared"]
    assert r["device"]["busy_s"] > 0
    assert r["device"]["busy_s"] <= r["device"]["window_s"]
    m = r["metrics"]
    assert 0 < m["kernels.sigma_clip_roofline"]["value"] < 100
    assert 0 <= m["device.idle_share"]["value"] < 1
    assert len(r["breakdown"]["device_ops"]) <= 10
