"""The JAX package's beam, unit and auxiliary tests run through the port.

The scenarios, expected values and tolerances of ``tests/test_beams.py``,
``tests/test_units.py`` and the tests of ``tests/test_aux.py`` that need no
device mesh (persistence, checkpoints, the huge-operation guard, HDU reads,
the viewers' frames, the apply functions): the JAX files' text, read when
this module is imported and renamed for the port (``carry_over``:
``spectral_cube_tpu_torch`` in place of ``spectral_cube_tpu``, the fixtures
of ``test_torch_fixtures_ref.py``).  Every case runs on the CPU and, marked
``cuda``, on the card; on both the port may hand numpy no tensor
(``numpy_guard``).  ``NOT_CARRIED`` names the rest, each with its reason;
the tests of ``tests/test_aux.py`` that build the default mesh
(``ELSEWHERE``) are carried by ``test_torch_mesh_battery.py``.
"""

import pytest

from test_torch_fixtures_ref import (AUX_MESH_TESTS, JAX_PRIVATE, JNP,
                                     REF_FILE, carry_over,
                                     check_carried_over, cube_adv, cube_vr,
                                     left_out, numpy_guard,
                                     parametrize_devices, use_device)

JAX_FILES = ["tests/test_beams.py", "tests/test_units.py", "tests/test_aux.py"]

#: JAX tests not carried over, with the reason
NOT_CARRIED = {
    "test_moment0_unit_renders_named": left_out(
        REF_FILE, "tests/test_torch_io_formats.py"),
    "test_cube_times_unit": left_out(
        REF_FILE, "tests/test_torch_io_formats.py"),
    "test_enable_compilation_cache": left_out(
        JAX_PRIVATE, "tests/test_torch_api_parity.py"),
    "test_apply_function_parallel_shape": left_out(
        REF_FILE, "tests/test_torch_transforms.py"),
    "test_op_timer": left_out(JNP, "tests/test_torch_profiling.py"),
    "test_op_timer_loop_reps_and_rtt": left_out(
        JNP, "tests/test_torch_profiling.py"),
    "test_profiler_trace_context": left_out(
        JNP, "tests/test_torch_profiling.py"),
}

#: the tests of test_aux.py that build the default mesh: the mesh battery
#: carries them
ELSEWHERE = AUX_MESH_TESTS

MATPLOTLIB = ("draws with matplotlib, which the card's machine does not "
              "have; the drawing reads host values")

#: tests that run on the CPU alone, with the reason
CPU_ONLY = {
    "test_make_rgb_movie_frames": MATPLOTLIB,
    "test_plot_channel_maps_renders": MATPLOTLIB,
    "test_rgb_movie_frames": MATPLOTLIB,
    "test_quicklook_paths": MATPLOTLIB,
    "test_make_multispecies_rgb": MATPLOTLIB,
}

carry_over(JAX_FILES, globals(), [*NOT_CARRIED, *ELSEWHERE])


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
    check_carried_over(JAX_FILES, globals(), NOT_CARRIED, CPU_ONLY,
                       elsewhere=ELSEWHERE)
