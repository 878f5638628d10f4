"""The JAX package's WCS tests run through the port.

The scenarios, expected values and tolerances of ``tests/test_wcs.py``,
``tests/test_wcs_utils.py``, ``tests/test_wcs_golden.py`` (the golden
projection oracles) and ``tests/test_spectral_axis_ref.py`` (spectral-axis
conversions against 40-digit derivations; it imports two helpers from
``test_wcs_golden``, carried here first): the JAX files' text, read when
this module is imported and renamed for the port (``carry_over``).  Every
case runs on the CPU and, marked ``cuda``, on the card but those of
``CPU_ONLY``, with the default ``CubeMesh()`` on 8 positions of the case's
device (``use_mesh``); on both the port may hand numpy no tensor
(``numpy_guard``).  ``NOT_CARRIED`` names the rest, each with its reason and
the port test that holds the same behaviour against the JAX package.
"""

import pytest

from test_torch_fixtures_ref import (JNP, REF_FILE, carry_over,
                                     check_carried_over, cube_adv, cube_vr,
                                     left_out, numpy_guard,
                                     parametrize_devices, use_device, use_mesh)

JAX_FILES = ["tests/test_wcs.py",
             "tests/test_wcs_utils.py",
             "tests/test_wcs_golden.py",
             "tests/test_spectral_axis_ref.py"]

#: JAX tests not carried over, with the reason
NOT_CARRIED = {
    "test_projection_math_traces_in_jit":
        left_out(JNP, "tests/test_torch_wcs_golden.py"),
    "test_projection_convolve_and_world_with_manual_wcs":
        left_out(JNP, "tests/test_torch_lower_dim.py"),
    "test_new_projection_device_path": left_out(
        JNP, "tests/test_torch_wcs_golden.py::"
        "test_sphere_sample_roundtrip_matches_jax"),
    "test_hpx_even_k_seam": left_out(
        JNP, "tests/test_torch_wcs_golden.py::test_hpx_even_k_seam"),
    "test_xph_device_path_and_header": left_out(
        JNP, "tests/test_torch_wcs_golden.py::test_xph_header_roundtrip"),
    "test_change_rest_frequency":
        left_out(REF_FILE, "tests/test_torch_wcs_golden.py"),
    "test_cube_wcs_freqtovel":
        left_out(REF_FILE, "tests/test_torch_wcs_golden.py"),
    "test_cube_wcs_freqtovopt":
        left_out(REF_FILE, "tests/test_torch_wcs_golden.py"),
    "test_greisen2006_worked_examples": left_out(
        REF_FILE, "tests/test_torch_wcs_golden.py::"
        "test_greisen2006_worked_examples"),
}

#: tests that run on the CPU alone, with the reason
CPU_ONLY = {
    "test_conversion_matrix_mpmath": (
        "its identity cases skip, as the JAX test's do, and the card's run "
        "admits no skip; the conversion is host arithmetic on a WCS, which "
        "holds no tensor"),
}

carry_over(JAX_FILES, globals(), NOT_CARRIED)


@pytest.fixture(scope="module", autouse=True)
def _port_converts_explicitly():
    with numpy_guard():
        yield


def pytest_generate_tests(metafunc):
    parametrize_devices(metafunc, CPU_ONLY)


@pytest.fixture(autouse=True)
def device(request, monkeypatch):
    dev = use_device(request.param, monkeypatch)
    use_mesh(dev, monkeypatch)
    return dev


def test_every_jax_test_is_carried_over():
    """Each test of JAX_FILES is here or in NOT_CARRIED, and each
    NOT_CARRIED entry is still a JAX test absent from this file."""
    check_carried_over(JAX_FILES, globals(), NOT_CARRIED, CPU_ONLY)
