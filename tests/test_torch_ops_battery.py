"""The JAX package's operation tests run through the port.

The scenarios, expected values and tolerances of ``tests/test_regrid.py``
(spectral interpolation, downsampling, reprojection, mosaics),
``tests/test_smoothing.py`` (spectral and spatial smoothing, median
filters, sigma clipping), ``tests/test_moments.py`` and
``tests/test_pipeline_fused.py``: the JAX files' text, read when this module
is imported and renamed for the port (``carry_over``; a top-level import
of a Pallas function is dropped, the tests that call one are not carried).
Every case runs on the CPU and, marked ``cuda``, on the card, with the
default ``CubeMesh()`` on 8 positions of the case's device (``use_mesh``);
on both the port may hand numpy no tensor (``numpy_guard``).  Most of these
files drive the JAX functions with ``jnp`` arrays or their Pallas kernels:
``NOT_CARRIED`` names those tests, each with its reason and the port test
that holds the same behaviour against the JAX package.
"""

import pytest

from test_torch_fixtures_ref import (JAX_PRIVATE, JNP, PALLAS, carry_over,
                                     check_carried_over, cube_adv, cube_vr,
                                     left_out, numpy_guard,
                                     parametrize_devices, use_device, use_mesh)

JAX_FILES = ["tests/test_regrid.py",
             "tests/test_smoothing.py",
             "tests/test_moments.py",
             "tests/test_pipeline_fused.py"]

#: JAX tests not carried over, with the reason
NOT_CARRIED = {
    "test_chunked_pallas_adversarial_narrow_line":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_chunked_pallas_long_axis_matches_oracle":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_chunked_pallas_selected_at_1024_channels":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_chunked_pallas_with_stats_matches_float64":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_moment_generic_higher_order":
        left_out(JNP, "tests/test_torch_moments.py"),
    "test_moments_vs_oracle": left_out(JNP, "tests/test_torch_moments.py"),
    "test_pallas_explicit_mask_input":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_pallas_interpret_matches_jnp":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_pallas_rejects_non_data_local_mask_expr":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_pallas_vmem_fallback_long_spectral_axis":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_pallas_with_stats_all_masked":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_pallas_with_stats_matches_float64_oracle":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_pallas_with_stats_stays_on_kernel_at_bench_shape":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_statistics_pallas_matches_masked_statistics":
        left_out(PALLAS, "tests/test_torch_moments.py"),
    "test_df_div_accuracy":
        left_out(JNP, "tests/test_torch_pipeline_fused.py"),
    "test_fused_all_masked_spaxel_nan_moments": left_out(
        JNP, "tests/test_torch_pipeline_fused.py::"
        "test_fused_all_masked_spaxel_nan_moments"),
    "test_fused_cb_variants_identical_moments":
        left_out(JNP, "tests/test_torch_pipeline_fused.py"),
    "test_fused_conv_bitwise_matches_unfused_kernel":
        left_out(PALLAS, "tests/test_torch_pipeline_fused.py"),
    "test_fused_gates_return_none": left_out(
        JNP, "tests/test_torch_pipeline_fused.py::"
        "test_fused_gates_return_none"),
    "test_fused_matches_float64_oracle":
        left_out(JNP, "tests/test_torch_pipeline_fused.py"),
    "test_fused_matches_two_pass_pallas_moments":
        left_out(PALLAS, "tests/test_torch_pipeline_fused.py"),
    "test_fused_mom2_narrow_line_far_from_center": left_out(
        JNP, "tests/test_torch_pipeline_fused.py::"
        "test_fused_mom2_narrow_line_far_from_center"),
    "test_neumaier_accumulation_beats_plain_f32":
        left_out(JNP, "tests/test_torch_pipeline_fused.py"),
    "test_two_prod_exact": left_out(JNP, "tests/test_torch_pipeline_fused.py"),
    "test_two_sum_exact": left_out(JNP, "tests/test_torch_pipeline_fused.py"),
    "test_block_tap_interp_long_axis": left_out(
        JNP, "tests/test_torch_interpolate.py::"
        "test_interp_cube_spectral_matches_jax_with_include"),
    "test_convolve_reproject_fused_matches_chain":
        left_out(JNP, "tests/test_torch_conv_reproject.py"),
    "test_downsample_axis": left_out(
        JNP, "tests/test_torch_interpolate.py::"
        "test_downsample_axis_matches_jax"),
    "test_downsample_ragged_tail": left_out(
        JNP, "tests/test_torch_interpolate.py::"
        "test_downsample_axis_matches_jax"),
    "test_interp_include_matches_bruteforce": left_out(
        JNP, "tests/test_torch_interpolate.py::"
        "test_interp_cube_spectral_matches_jax_with_include"),
    "test_matmul_interp_matches_gather": left_out(
        JAX_PRIVATE, "tests/test_torch_interpolate.py::"
        "test_interp_cube_spectral_matches_jax_with_include"),
    "test_matmul_separable_resample_matches_gather":
        left_out(JNP, "tests/test_torch_regrid.py"),
    "test_mosaic_two_offset_cubes": left_out(
        JNP, "tests/test_torch_cube_utils.py::"
        "test_mosaic_of_two_offset_cubes_matches_jax"),
    "test_rotated_bilinear_nan_poisoning_matches_staged_oracle":
        left_out(JNP, "tests/test_torch_regrid.py"),
    "test_rotated_spline_nan_poisoning":
        left_out(JNP, "tests/test_torch_regrid.py"),
    "test_smooth_interp_fused_long_axis": left_out(
        JNP, "tests/test_torch_interpolate.py::"
        "test_smooth_interp_cube_matches_jax"),
    "test_smooth_interp_fused_matches_chain": left_out(
        JNP, "tests/test_torch_interpolate.py::"
        "test_smooth_interp_cube_matches_jax"),
    "test_spectral_interpolate_linear_data": left_out(
        JNP, "tests/test_torch_interpolate.py::"
        "test_spectral_interpolate_branches_match_jax"),
    "test_spline_reproject_nan_poisoning_localized":
        left_out(JNP, "tests/test_torch_regrid.py"),
    "test_spline_reproject_offset_matches_scipy":
        left_out(JNP, "tests/test_torch_regrid.py"),
    "test_spline_reproject_rotated_matches_scipy":
        left_out(JNP, "tests/test_torch_regrid.py"),
    "test_spline_reproject_spectral_axis_matches_scipy":
        left_out(JNP, "tests/test_torch_regrid.py"),
    "test_spline_separable_matmul_path_matches_gather":
        left_out(JNP, "tests/test_torch_regrid.py"),
    "test_allnan_window_stays_nan_1d_smooth":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_bitonic_sort_leading_matches_numpy":
        left_out(PALLAS, "tests/test_torch_smoothing.py"),
    "test_block_banded_conv_matches_dense":
        left_out(JAX_PRIVATE, "tests/test_torch_smoothing.py"),
    "test_convolve1d_all_nan_column_stays_nan":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_convolve1d_matches_numpy":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_convolve1d_nan_interpolation":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_dft_matmul_convolution_matches_fft":
        left_out(JAX_PRIVATE, "tests/test_torch_convolve.py"),
    "test_dft_mats_reusable_across_traces":
        left_out(JAX_PRIVATE, "tests/test_torch_convolve.py"),
    "test_kernel_classes_match_astropy_discretization":
        left_out(JNP, "tests/test_torch_convolve.py"),
    "test_long_axis_conv_gate":
        left_out(JAX_PRIVATE, "tests/test_torch_smoothing.py"),
    "test_per_channel_separable_matches_fft":
        left_out(JAX_PRIVATE, "tests/test_torch_convolve.py"),
    "test_rdft_matmul_convolution_matches_fft":
        left_out(JAX_PRIVATE, "tests/test_torch_convolve.py"),
    "test_sigma_clip_fused_gates":
        left_out(PALLAS, "tests/test_torch_smoothing.py"),
    "test_sigma_clip_fused_kernel_matches_jnp_band":
        left_out(PALLAS, "tests/test_torch_smoothing.py"),
    "test_sigma_clip_mad_std_all_masked_spaxel":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_sigma_clip_mad_std_matches_iterative_numpy":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_sigma_clip_matches_iterative_numpy":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_sigma_clip_mean_cenfunc_matches_iterative_numpy":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_sigma_clip_removes_outliers":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_sort_padded_leading_matches_numpy":
        left_out(PALLAS, "tests/test_torch_smoothing.py"),
    "test_spatial_median_filter_matches_scipy":
        left_out(JNP, "tests/test_torch_smoothing.py"),
    "test_spatial_smooth_matches_scipy":
        left_out(JNP, "tests/test_torch_convolve.py"),
    "test_spectral_median_filter_matches_scipy":
        left_out(JNP, "tests/test_torch_smoothing.py"),
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
