"""The JAX package's beam, unit and auxiliary tests run through the port.

The scenarios, expected values and tolerances of ``tests/test_beams.py``,
``tests/test_units.py`` and the tests of ``tests/test_aux.py`` that need no
device mesh (persistence, checkpoints, the huge-operation guard, HDU reads,
the viewers' frames, the apply functions): the JAX files' text, read when
this module is imported and renamed for the port (``carry_over``:
``spectral_cube_tpu_torch`` in place of ``spectral_cube_tpu``, the fixtures
of ``test_torch_fixtures_ref.py``).  Every case runs on the CPU and, marked
``cuda``, on the card; on both the port may hand numpy no tensor
(``numpy_guard``).  ``NOT_CARRIED`` names the rest, each with its reason.
"""

import pytest

from test_torch_fixtures_ref import (carry_over, check_carried_over, cube_adv,
                                     cube_vr, numpy_guard, parametrize_devices,
                                     use_device)

JAX_FILES = ["tests/test_beams.py", "tests/test_units.py", "tests/test_aux.py"]

MESH = ("builds the default CubeMesh() and reads how JAX shards the "
        "cube; the port's mesh, streaming readers and sharded stores are "
        "held against the JAX package's in test_torch_parallel.py, "
        "test_torch_streaming.py and test_torch_cube_utils.py")

JNP = ("calls jnp in its body; the port's profiling module is held "
       "against the JAX package's in test_torch_profiling.py")

TPU = "TPU-only: enable_compilation_cache (XLA's compilation cache)"

LMV = ("reads the reference library's example_cube.lmv, which the "
       "repository does not hold (the JAX test skips without it); the "
       "port's .lmv reader is held against the JAX package's in "
       "test_torch_io_formats.py")

REF_FITS = ("reads the reference library's example_cube.fits, which the "
            "repository does not hold (the JAX test skips without it); "
            "the apply functions are held against the JAX package's in "
            "test_torch_transforms.py")

#: JAX tests not carried over, with the reason
NOT_CARRIED = {
    "test_moment0_unit_renders_named": LMV,
    "test_cube_times_unit": LMV,
    "test_streaming_sharded_loader": MESH,
    "test_streaming_matches_eager": MESH,
    "test_to_sharded_facade": MESH,
    "test_use_dask_shards_over_devices": MESH,
    "test_sharded_checkpoint_restore": MESH,
    "test_streaming_spectral_layout_native_decode": MESH,
    "test_sharded_display": MESH,
    "test_replicated_layout_saves_each_shard_once": MESH,
    "test_enable_compilation_cache": TPU,
    "test_apply_function_parallel_shape": REF_FITS,
    "test_op_timer": JNP,
    "test_op_timer_loop_reps_and_rtt": JNP,
    "test_profiler_trace_context": JNP,
}

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
