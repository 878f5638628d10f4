"""The run refuses a machine without a card, prints no result there, and
writes no device metric from the CPU; it loads nothing of JAX."""

import json
import shutil
import subprocess
import sys
import time

import torch

from cubebench import harness


def test_run_without_a_card_fails_and_prints_nothing(root):
    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "cubebench/run.py", "--workload", "casa623.spectral",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_in_a_bare_checkout_fails(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "cubebench", tmp_path / "cubebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "cubebench/run.py", "--workload", "casa623.spectral",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def _tiny(root, name, shape):
    cell = harness.load_cell(name, root)
    cell.config["shape"] = list(shape)
    return cell


def test_a_cpu_run_writes_no_device_metric(root):
    cell = _tiny(root, "casa623.spectral", (64, 24, 24))
    r = harness.run_cell(cell, 2 ** 31 + 9, 0.2, 0, torch.device("cpu"),
                         time.perf_counter())
    assert r["device"] == {}
    assert set(r["metrics"]) == {"cube_s", "setup_s"}
    assert r["attempted"] >= 1
    assert list(r)[-1] == "compared"
    json.dumps(r)


def test_a_run_loads_nothing_of_jax(root):
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "from pathlib import Path; from cubebench import harness; "
            "c = harness.load_cell('alma.pipeline', Path(%r)); "
            "c.config['shape'] = [16, 32, 32]; "
            "harness.run_cell(c, 3, 0.1, 0, torch.device('cpu'), "
            "time.perf_counter()); print(harness.forbidden_modules())"
            % (str(root), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_traced_cpu_run_writes_no_device_metric(root):
    cell = _tiny(root, "alma.pipeline", (16, 48, 48))
    r = harness.run_cell(cell, 2 ** 31 + 10, 0.2, 1, torch.device("cpu"),
                         time.perf_counter())
    assert r["metrics"] == {} and r["device"] == {}
    assert "breakdown" not in r
    assert r["attempted"] == harness.TRACED_CUBES
