"""The JAX package's cube, mask, varying-resolution, Stokes and analysis
tests run through the port.

The scenarios, expected values and tolerances of ``tests/test_cube.py``,
``tests/test_masks.py`` (the reference library's mask battery among them),
``tests/test_vrsc.py``, ``tests/test_stokes.py`` and
``tests/test_analysis.py``: the JAX files' text, read when this module is
imported and renamed for the port (``carry_over``).  Every case runs on
the CPU and, marked ``cuda``, on the card, with the default ``CubeMesh()``
on 8 positions of the case's device (``use_mesh``); on both the port may
hand numpy no tensor (``numpy_guard``).  ``NOT_CARRIED`` names the rest,
each with its reason and the port test that holds the same behaviour
against the JAX package.
"""

import pytest

from test_torch_fixtures_ref import (JAX_PRIVATE, JNP, carry_over,
                                     check_carried_over, cube_adv, cube_vr,
                                     left_out, numpy_guard,
                                     parametrize_devices, use_device, use_mesh)

JAX_FILES = ["tests/test_cube.py",
             "tests/test_masks.py",
             "tests/test_vrsc.py",
             "tests/test_stokes.py",
             "tests/test_analysis.py"]

#: JAX tests not carried over, with the reason
NOT_CARRIED = {
    "test_expr_key_structure_and_collisions":
        left_out(JNP, "tests/test_torch_masks.py"),
    "test_parallel_spectral_escape_hatches": left_out(
        JNP, "tests/test_torch_transforms.py::"
        "test_parallel_spectral_block_info_and_raw_output"),
    "test_comparison_mask": left_out(JNP, "tests/test_torch_masks.py"),
    "test_composite_and_invert": left_out(JNP, "tests/test_torch_masks.py"),
    "test_exclude_is_complement": left_out(JNP, "tests/test_torch_masks.py"),
    "test_filled_and_flattened": left_out(
        JNP, "tests/test_torch_slicing.py::"
        "test_filled_and_flattened"),
    "test_is_data_local": left_out(JNP, "tests/test_torch_masks.py"),
    "test_lazy_mask": left_out(JNP, "tests/test_torch_masks.py"),
    "test_mask_fancy_views":
        left_out(JAX_PRIVATE, "tests/test_torch_masks.py"),
    "test_mask_logic_chains": left_out(JNP, "tests/test_torch_masks.py"),
    "test_masks_and_cubes_pickle": left_out(
        JAX_PRIVATE, "tests/test_torch_masks.py::"
        "test_masks_and_cubes_pickle"),
    "test_masks_work_inside_jit": left_out(JNP, "tests/test_torch_masks.py"),
}

#: tests that run on the CPU alone, with the reason
CPU_ONLY = {}

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
