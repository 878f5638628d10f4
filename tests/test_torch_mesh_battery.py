"""The JAX package's multi-device tests run through the port.

The scenarios, expected values and tolerances of ``tests/test_parallel.py``
(the mesh, reshards, halo exchanges, the sharded operations,
``ShardedCube``), ``tests/test_performance.py`` (lazy masks, cached moments)
and the tests of ``tests/test_aux.py`` that build the default mesh
(``AUX_MESH_TESTS``: the streaming readers, sharded stores, ``to_sharded``,
``use_dask``): the JAX files' text, read when this module is imported and
renamed for the port (``carry_over``).  Every case runs on the CPU and,
marked ``cuda``, on the card, the default ``CubeMesh()`` on 8 positions of
the case's device (``use_mesh``: a 2x4 grid, the JAX tests' 8 virtual CPU
devices); ``cmesh`` is that mesh.  On both the port may hand numpy no
tensor (``numpy_guard``).  ``NOT_CARRIED`` names the rest, each with its
reason and the port test that holds the same behaviour against the JAX
package.
"""

import pytest

from spectral_cube_tpu_torch.parallel import CubeMesh

from test_torch_fixtures_ref import (AUX_MESH_TESTS, JAX_PRIVATE, JNP,
                                     carry_over, check_carried_over, cube_adv,
                                     cube_vr, left_out, numpy_guard,
                                     parametrize_devices, use_device, use_mesh)

JAX_FILES = ["tests/test_parallel.py",
             "tests/test_performance.py",
             "tests/test_aux.py"]

#: of test_aux.py, the tests that build the default mesh (the beam and unit
#: battery carries the rest)
ONLY = {"tests/test_aux.py": AUX_MESH_TESTS}

#: JAX tests not carried over, with the reason
NOT_CARRIED = {
    "test_replicated_layout_saves_each_shard_once": left_out(
        JAX_PRIVATE, "tests/test_torch_sharded_store.py::"
        "test_f14_replicated_layout_saves_each_block_once"),
    "test_sharded_checkpoint_restore": left_out(
        JAX_PRIVATE, "tests/test_torch_sharded_store.py::"
        "test_f14_sharded_save_writes_each_block"),
    "test_streaming_sharded_loader": left_out(
        JAX_PRIVATE, "tests/test_torch_streaming.py::"
        "test_streaming_reader_keeps_each_block_on_its_position"),
    "test_use_dask_shards_over_devices":
        left_out(JAX_PRIVATE, "tests/test_torch_parallel.py"),
    "test_compiled_collective_structure":
        left_out(JAX_PRIVATE, "tests/test_torch_parallel.py"),
    "test_fused_ops_on_sharded_arrays": left_out(
        JAX_PRIVATE, "tests/test_torch_parallel.py::"
        "test_fused_ops_on_sharded_arrays"),
    "test_halo_exchange_convolution": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_halo_exchange_convolution"),
    "test_read_use_dask_returns_sharded_cube": left_out(
        JAX_PRIVATE, "tests/test_torch_parallel.py::"
        "test_read_use_dask_returns_sharded_cube"),
    "test_reshard_generic_path_mesh_unaligned": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_reshard_generic_path_mesh_unaligned"),
    "test_reshard_is_identity_permutation": left_out(
        JAX_PRIVATE, "tests/test_torch_parallel.py::"
        "test_reshard_is_identity_permutation"),
    "test_reshard_roundtrip":
        left_out(JNP, "tests/test_torch_parallel.py::test_reshard_roundtrip"),
    "test_reshard_roundtrip_uneven": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_reshard_roundtrip_uneven"),
    "test_reshard_uneven_placement_not_just_roundtrip": left_out(
        JAX_PRIVATE, "tests/test_torch_parallel.py::"
        "test_reshard_uneven_placement_not_just_roundtrip"),
    "test_sharded_fft_fallback_uneven_shape": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_sharded_fft_fallback_uneven_shape"),
    "test_sharded_halo_convolve_even_kernel": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_sharded_halo_convolve_even_kernel"),
    "test_sharded_halo_convolve_matches_unsharded": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_sharded_halo_convolve_matches_unsharded"),
    "test_sharded_interp_no_mask_branch": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_sharded_interp_no_mask_branch"),
    "test_sharded_moments_match_single_device": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_sharded_moments_match_single_device"),
    "test_sharded_moments_with_mask": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_sharded_moments_with_mask"),
    "test_sharded_reproject_beyond_halo_falls_to_reshard":
        left_out(JNP, "tests/test_torch_parallel.py"),
    "test_sharded_reproject_halo_matches_unsharded": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_sharded_reproject_halo_matches_unsharded"),
    "test_sharded_reproject_order0":
        left_out(JNP, "tests/test_torch_parallel.py"),
    "test_sharded_reproject_reshard_rotated":
        left_out(JNP, "tests/test_torch_parallel.py"),
    "test_sharded_reproject_resizing_halo":
        left_out(JNP, "tests/test_torch_parallel.py"),
    "test_sharded_reproject_spectral_mapping":
        left_out(JNP, "tests/test_torch_parallel.py"),
    "test_sharded_spatial_convolve_nonseparable_halo_path": left_out(
        JNP, "tests/test_torch_parallel.py::"
        "test_sharded_spatial_convolve_nonseparable_halo_path"),
    "test_streaming_pipeline_tb_scale_analog": left_out(
        JNP, "tests/test_torch_streaming.py::"
        "test_streaming_pipeline_tb_scale_analog"),
    "test_use_mesh_context":
        left_out(JNP, "tests/test_torch_parallel.py::test_use_mesh_context"),
    "test_mask_not_materialized_by_reductions":
        left_out(JAX_PRIVATE, "tests/test_torch_parallel.py"),
    "test_moments_jit_cache_reused_across_cubes":
        left_out(JAX_PRIVATE, "tests/test_torch_moments.py"),
}

#: tests that run on the CPU alone, with the reason
CPU_ONLY = {}

carry_over(JAX_FILES, globals(), NOT_CARRIED, ONLY)


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


@pytest.fixture
def cmesh(device):
    """``tests/test_parallel.py``'s mesh: the default ``CubeMesh()``, 8
    positions of the case's device (``use_mesh``)."""
    return CubeMesh()


def test_every_jax_test_is_carried_over():
    """Each test of JAX_FILES is here or in NOT_CARRIED, and each
    NOT_CARRIED entry is still a JAX test absent from this file."""
    check_carried_over(JAX_FILES, globals(), NOT_CARRIED, CPU_ONLY, ONLY)
