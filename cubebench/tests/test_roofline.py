"""The stages' counts at both configurations' shapes, worked out by hand
from the shapes and the beams."""

import json

import pytest

from cubebench import roofline

P = (3840, 1024, 1024)
CASA = (623, 768, 768)


@pytest.fixture
def configs(root):
    out = {}
    for name in ("alma-fdm-3840x1024x1024", "casa-623x768x768"):
        with open(root / "cubebench" / "configs" / f"{name}.json") as f:
            out[name] = json.load(f)
    return out


@pytest.fixture
def mixes(root):
    return {n: json.loads((root / "cubebench" / "mixes" / f"{n}.json")
                          .read_text()) for n in ("pipeline", "spectral")}


@pytest.mark.parametrize("name,shape", [("alma-fdm-3840x1024x1024", P),
                                        ("casa-623x768x768", CASA)])
def test_convolve_to_counts(configs, mixes, name, shape):
    nbytes, flops = roofline.counts("convolve_to", configs[name],
                                    mixes["pipeline"], shape)
    voxels = shape[0] * shape[1] * shape[2]
    # a target of 8 cells over a beam of 4 x 3 cells: a 27 x 27 kernel of
    # float32 rank 5; numerator and denominator, y and x taps, a multiply
    # and an add each
    assert nbytes == 8 * voxels
    assert flops == 2 * 2 * 5 * (27 + 27) * voxels
    seconds, by = roofline.least_seconds("convolve_to", configs[name],
                                         mixes["pipeline"], shape)
    assert by == "flops"
    assert seconds == pytest.approx(flops / 67e12)


def test_convolve_to_least_time_at_p(configs, mixes):
    seconds, _ = roofline.least_seconds(
        "convolve_to", configs["alma-fdm-3840x1024x1024"],
        mixes["pipeline"], P)
    assert seconds == pytest.approx(0.0649, rel=0.01)


@pytest.mark.parametrize("name,shape,n", [
    ("alma-fdm-3840x1024x1024", P, 1920), ("casa-623x768x768", CASA, 312)])
def test_sigma_clip_counts(configs, mixes, name, shape, n):
    nbytes, flops = roofline.counts("sigma_clip_spectrally", configs[name],
                                    mixes["spectral"], shape)
    plane = shape[1] * shape[2]
    assert nbytes == 8 * n * plane
    assert flops == pytest.approx(3.14159265 * 0.47 ** 2 * plane
                                  * n * (__import__("math").log2(n) + 6))
    seconds, by = roofline.least_seconds(
        "sigma_clip_spectrally", configs[name], mixes["spectral"], shape)
    assert by == "bytes"
    assert seconds == pytest.approx(nbytes / 3.35e12)


def test_a_stage_without_counts_has_no_least_time(configs, mixes):
    assert roofline.least_seconds("no_such_stage",
                                  configs["casa-623x768x768"],
                                  mixes["spectral"], CASA) is None
