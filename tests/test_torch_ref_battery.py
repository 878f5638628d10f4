"""The JAX package's reference batteries run through the port.

The scenarios, expected values and tolerances of
``tests/test_spectral_cube_ref.py`` (the reference library's
test_spectral_cube.py scenarios on byte-faithful fixtures),
``tests/test_ref_values.py`` (the reference's hard-coded expected values)
and ``tests/test_degenerate_shapes.py`` (1-channel and 1-spaxel cubes,
prime extents): the JAX files' text, read when this module is imported
and renamed for the port (``carry_over``: ``spectral_cube_tpu_torch`` in
place of ``spectral_cube_tpu``, the fixtures of
``test_torch_fixtures_ref.py``).  Every case runs on the CPU and, marked
``cuda``, on the card; on both the port may hand numpy no tensor
(``numpy_guard``).
"""

import pytest

from test_torch_fixtures_ref import (carry_over, check_carried_over,
                                     numpy_guard, parametrize_devices,
                                     use_device)

JAX_FILES = ["tests/test_spectral_cube_ref.py",
             "tests/test_ref_values.py",
             "tests/test_degenerate_shapes.py"]

#: JAX tests not carried over, with the reason
NOT_CARRIED = {}

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
    return use_device(request.param, monkeypatch)


def test_every_jax_test_is_carried_over():
    """Each test of JAX_FILES is here or in NOT_CARRIED, and each
    NOT_CARRIED entry is still a JAX test absent from this file."""
    check_carried_over(JAX_FILES, globals(), NOT_CARRIED, CPU_ONLY)
