"""A mix is data: a chain of operations, each found by its name as a
program step and a reference step.  Mixes that no cell runs yet, made of
the operations there are, run on the CPU at a tiny size and come out
correct, and the reference of each is composed by walking its chain."""

import time

import pytest
import torch

from cubebench import harness

LIMITS = {"sigma_rel": 3e-4, "mom0_gap": 3e-4, "mom1_gap": 3e-4,
          "linewidth_gap": 3e-4, "stats_rel": 1e-3, "cube_gap": 1e-4,
          "flip_share": 3e-5}
PIPELINE = {"op": "run_pipeline", "snr_threshold": 3.0, "noise": "mad_std",
            "target_beam": "config", "target_shift_px": [-1.0, 1.0]}
SMOOTH = {"op": "spectral_smooth", "gaussian_stddev_ch": 2.0}
CLIP = {"op": "sigma_clip_spectrally", "sigma": 1.0, "maxiters": 5}
MIXES = {
    "clip_alone": [CLIP],
    "smooth_then_clip": [SMOOTH, CLIP],
    "noise_given": [dict(PIPELINE, noise=0.05)],
    "pipeline_then_smooth": [PIPELINE, SMOOTH],
}


def _cell(root, chain):
    cell = harness.load_cell("casa623.spectral", root)
    cell.config["shape"] = [96, 40, 40]
    cell.mix = {"name": "trial", "chain": chain}
    cell.limits = LIMITS
    return cell


@pytest.mark.parametrize("name", sorted(MIXES))
def test_a_mix_of_existing_operations_runs_correct(root, name):
    cell = _cell(root, MIXES[name])
    r = harness.run_cell(cell, 2 ** 31 + 505, 0.05, 0, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"], r["compared"]
    assert ("sigma_rel" in r["compared"]) == (
        name in ("pipeline_then_smooth",))
    assert "cube_gap" in r["compared"] and "flip_share" in r["compared"]


def test_a_given_noise_sets_the_threshold(root):
    from cubebench.cubegen import make_cube
    from cubebench.reference import chains as ref
    cell = _cell(root, MIXES["noise_given"])
    inp = make_cube(cell.shape, 7, torch.device("cpu"))
    want = ref.products(cell.config, cell.mix, inp, [{"dx": 0.0,
                                                      "dy": 0.0}])
    (_, prods), = want["steps"]
    assert "sigma" not in prods
    assert prods["threshold"] == pytest.approx(3.0 * 0.05, rel=1e-7)
