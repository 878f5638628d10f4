"""The JAX package's I/O tests run through the port.

The scenarios, expected values and tolerances of ``tests/test_io.py``
(FITS, BEAMS tables, ``.lmv``, the format registry), ``tests/test_casa.py``
(CASA images, masks, the streamed reader), ``tests/test_tile_compress.py``
(tile-compressed FITS), ``tests/test_exporters_mock.py`` (the exporters'
mocked packages) and ``tests/test_regions_ref.py`` (region subcubes): the
JAX files' text, read when this module is imported and renamed for the
port (``carry_over``).  Every case runs on the CPU and, marked ``cuda``, on
the card, with the default ``CubeMesh()`` on 8 positions of the case's
device (``use_mesh``); on both the port may hand numpy no tensor
(``numpy_guard``).  ``NOT_CARRIED`` names the rest (most read the reference
library's files, which the repository does not hold), each with its reason
and the port test that holds the same behaviour against the JAX package.
"""

import pytest

from test_torch_fixtures_ref import (JAX_PRIVATE, REF_FILE, carry_over,
                                     check_carried_over, cube_adv, cube_vr,
                                     left_out, numpy_guard,
                                     parametrize_devices, use_device, use_mesh)

JAX_FILES = ["tests/test_io.py",
             "tests/test_casa.py",
             "tests/test_tile_compress.py",
             "tests/test_exporters_mock.py",
             "tests/test_regions_ref.py"]

#: JAX tests not carried over, with the reason
NOT_CARRIED = {
    "test_aipsio_record_contents": left_out(
        REF_FILE, "tests/test_torch_casa.py::"
        "test_aipsio_record_contents"),
    "test_casa_beam":
        left_out(REF_FILE, "tests/test_torch_casa.py::test_casa_beam"),
    "test_casa_endianness_agreement": left_out(
        REF_FILE, "tests/test_torch_casa.py::"
        "test_casa_endianness_agreement"),
    "test_casa_format_detection": left_out(
        REF_FILE, "tests/test_torch_casa.py::"
        "test_casa_format_detection"),
    "test_casa_mask_read":
        left_out(REF_FILE, "tests/test_torch_casa.py::test_casa_mask_read"),
    "test_casa_moments_run":
        left_out(REF_FILE, "tests/test_torch_casa.py::test_casa_moments_run"),
    "test_casa_read_basic":
        left_out(REF_FILE, "tests/test_torch_casa.py::test_casa_read_basic"),
    "test_casa_read_basic_nomask": left_out(
        REF_FILE, "tests/test_torch_casa.py::"
        "test_casa_read_basic_nomask"),
    "test_multitile_assembly": left_out(
        REF_FILE, "tests/test_torch_casa.py::"
        "test_multitile_assembly"),
    "test_read_casa_image":
        left_out(REF_FILE, "tests/test_torch_casa.py::test_read_casa_image"),
    "test_streaming_casa_loader": left_out(
        JAX_PRIVATE, "tests/test_torch_sharded_store.py::"
        "test_f15_streamed_cubes_answer_include"),
    "test_tiled_bool_unpack":
        left_out(REF_FILE, "tests/test_torch_casa.py::test_tiled_bool_unpack"),
    "test_lmv_fits": left_out(REF_FILE, "tests/test_torch_io_formats.py"),
    "test_lmv_matches_reference_fits_export":
        left_out(REF_FILE, "tests/test_torch_io_formats.py"),
    "test_lmv_reader_reference_file": left_out(
        REF_FILE, "tests/test_torch_io_formats.py::"
        "test_lmv_reader_reference_file"),
    "test_ds9region_255":
        left_out(REF_FILE, "tests/test_torch_regions.py::test_ds9region_255"),
    "test_ds9region_new":
        left_out(REF_FILE, "tests/test_torch_regions.py::test_ds9region_new"),
    "test_fk5_and_pixel_circle_agree": left_out(
        REF_FILE, "tests/test_torch_regions.py::"
        "test_fk5_and_pixel_circle_agree"),
    "test_fk5_box_parse":
        left_out(REF_FILE, "tests/test_torch_regions.py::test_fk5_box_parse"),
    "test_image_box_mask":
        left_out(REF_FILE, "tests/test_torch_regions.py::test_image_box_mask"),
}

MATPLOTLIB = ("draws with matplotlib, which the card's machine does not "
              "have; the drawing reads host values")

CFITSIO = ("compares with libcfitsio, which the card's machine does not "
           "have (the JAX test skips without it); the codec runs on the "
           "host")

#: tests that run on the CPU alone, with the reason
CPU_ONLY = {
    "test_ytcube_quick_render_movie": MATPLOTLIB,
    "test_image_polygon_rasterization_matches_matplotlib": MATPLOTLIB,
    "test_rice_bitstream_bit_identical_to_cfitsio": CFITSIO,
    "test_cfitsio_reads_my_quantized_files": CFITSIO,
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
