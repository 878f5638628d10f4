"""A whole run on the CPU at a tiny size, the look for a card skipped,
with the timed path sound and then broken underneath: the check passes
the sound run and fails each fault a cell can have (an answer altered
where it is produced, a stage that hands back its input unchanged, half
of the cube left out)."""

import time

import pytest
import torch

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import cube as program_cube
from cubebench import harness

TINY = {"alma.pipeline": (16, 48, 48), "casa623.spectral": (96, 24, 24),
        "alma.spectral": (160, 24, 24)}


def _run(root, name, seed=2 ** 31 + 77):
    cell = harness.load_cell(name, root)
    cell.config["shape"] = list(TINY[name])
    return harness.run_cell(cell, seed, 0.05, 0, torch.device("cpu"),
                            time.perf_counter())


def _alter_one(t):
    """Add 1 to the first finite value of tensor ``t``, in place."""
    flat = t.view(-1)
    i = int(torch.nonzero(torch.isfinite(flat))[0])
    flat[i] += 1.0


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_sound_run_is_correct(root, name):
    r = _run(root, name)
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_an_answer_altered_where_it_is_produced(root, name, monkeypatch):
    if name == "alma.pipeline":
        original = T.run_pipeline

        def broken(*args, **kwargs):
            res = original(*args, **kwargs)
            _alter_one(res["cube"]._data)
            return res
        monkeypatch.setattr(T, "run_pipeline", broken)
    else:
        original = program_cube.BaseSpectralCube.sigma_clip_spectrally

        def broken(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            _alter_one(out._data)
            return out
        monkeypatch.setattr(program_cube.SpectralCube,
                            "sigma_clip_spectrally", broken)
    assert not _run(root, name)["correct"]


@pytest.mark.parametrize("name,method", [
    ("alma.pipeline", "convolve_to"),
    ("casa623.spectral", "sigma_clip_spectrally"),
    ("alma.spectral", "spectral_smooth")])
def test_a_stage_that_returns_its_input(root, name, method, monkeypatch):
    monkeypatch.setattr(program_cube.SpectralCube, method,
                        lambda self, *args, **kwargs: self)
    assert not _run(root, name)["correct"]


def test_half_of_the_cube_left_out_of_the_statistics(root, monkeypatch):
    original = program_cube.BaseSpectralCube.statistics

    def half(self):
        return original(self[: self.shape[0] // 2])
    monkeypatch.setattr(program_cube.SpectralCube, "statistics", half)
    assert not _run(root, "alma.pipeline")["correct"]


@pytest.mark.parametrize("name", ["casa623.spectral", "alma.spectral"])
def test_half_of_the_spectra_left_unclipped(root, name, monkeypatch):
    original = program_cube.BaseSpectralCube.sigma_clip_spectrally

    def half(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        ny = self.shape[1] // 2
        out._data[:, ny:] = self._data[:, ny:]
        return out
    monkeypatch.setattr(program_cube.SpectralCube, "sigma_clip_spectrally",
                        half)
    assert not _run(root, name)["correct"]
