"""Torch port, ``run_pipeline(cmesh=)`` on meshes of distinct devices
(``tests/torch_distinct.py``) along its other routes: the single-beam
cube onto a new spectral axis (the spectral lerp and the filled
resample, halo exchanges), and a varying-resolution cube, its common
beam through the per-channel separable route (halo exchanges) onto a
shifted grid and a 30" beam through the FFT route (two all-to-alls each
way) onto a rotated grid; each held four ways as
``tests/test_torch_mesh_distinct_pipeline.py`` holds its cases."""

import pytest

from test_torch_mesh_distinct_pipeline import MESHES, files, hold_pipeline

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

__all__ = ["files"]


@pytest.mark.parametrize("case", ["spectral axis", "vr separable",
                                  "vr fft"])
@pytest.mark.parametrize("mesh", MESHES)
def test_pipeline_route_on_distinct_devices(files, mesh, case):
    hold_pipeline(files, mesh, case)
