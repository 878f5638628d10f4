"""Every ```python block of docs/*.md run through the port.

``tests/test_docs.py`` runs the blocks on the JAX package; this file reads
the same pages unchanged, puts ``spectral_cube_tpu_torch`` in place of
``spectral_cube_tpu`` in each block, and seeds the same namespace (the
synthetic cubes, kernels and velocity surfaces the prose introduces) with
the port, on the CPU and, marked ``cuda``, on the card.  The port may hand
numpy no tensor (``numpy_guard``); a block, like test code, may.

- The pages that build the default mesh (``CubeMesh()``) get 8 positions
  of the case's device (``use_mesh``), the grid the JAX tests' virtual
  CPU devices make.
- ``quickstart.md`` reads ``my_cube.lmv``, which ``tests/test_docs.py``
  copies from the reference library's example where that exists: here it
  is a type-2 ``.lmv`` of the FITS cube written by
  ``chip_smoke.write_lmv``, so the page runs everywhere.
- ``JAX_ONLY_BLOCKS`` names the blocks that call JAX itself or its TPU
  compilation cache, each with its reason; the rest of their page runs.
  ``CPU_ONLY_PAGES`` names the pages that do not run on the card.
"""

import os
import re
import warnings

import numpy as np
import pytest

from test_torch_fixtures_ref import (check_carried_over, make_cube_file,
                                     make_vr_cube_file, numpy_guard,
                                     parametrize_devices, use_device,
                                     use_mesh)

DOCS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs")

JAX_FILES = ["tests/test_docs.py"]

#: the pages of ``tests/test_docs.py``, with executable blocks
PAGES = ["quickstart.md", "accessing.md", "masking.md", "errors.md",
         "beams.md", "reprojection.md", "spectral_extraction.md",
         "stokes.md", "big_data.md", "examples.md", "visualization.md",
         "metadata.md", "developing.md", "moments.md", "smoothing.md",
         "manipulating.md"]

JNP = ("calls jax.numpy in its body (the function handed to "
       "apply_function_parallel_spectral); the card's machine has no JAX")

#: (page, block index) -> why the block runs on the JAX package alone
JAX_ONLY_BLOCKS = {
    ("quickstart.md", 10): "TPU-only: enable_compilation_cache (XLA's "
                           "compilation cache)",
    ("developing.md", 0): JNP,
    ("developing.md", 1): JNP,
}

#: JAX tests not carried over, with the reason
NOT_CARRIED = {}

#: tests that run on the CPU alone, with the reason
CPU_ONLY = {}

#: pages that run on the CPU alone, with the reason
CPU_ONLY_PAGES = {
    "visualization.md": "draws with matplotlib, which the card's machine "
                        "does not have; the drawing reads host values",
}


@pytest.fixture(scope="module", autouse=True)
def _port_converts_explicitly():
    with numpy_guard():
        yield


def pytest_generate_tests(metafunc):
    if metafunc.function.__name__ != "test_doc_blocks_run":
        parametrize_devices(metafunc, CPU_ONLY)
        return
    metafunc.parametrize(("device", "page"), [
        pytest.param(dev, page, marks=[pytest.mark.cuda] * (dev == "cuda"))
        for page in PAGES for dev in ("cpu", "cuda")
        if dev == "cpu" or page not in CPU_ONLY_PAGES], indirect=["device"])


@pytest.fixture(autouse=True)
def device(request, monkeypatch):
    dev = use_device(request.param, monkeypatch)
    use_mesh(dev, monkeypatch)
    return dev


def _blocks(page):
    with open(os.path.join(DOCS_DIR, page)) as f:
        text = f.read()
    return re.findall(r"```python\n(.*?)```", text, re.DOTALL)


def _write_lmv(path, fits_path):
    """``my_cube.lmv``: the FITS cube as a type-2 .lmv file."""
    from chip_smoke import write_lmv
    from spectral_cube_tpu_torch.io.fits_low import read_fits
    data = np.asarray(read_fits(fits_path)[0].data, dtype=np.float32)
    write_lmv(path, data, ref_deg=(23.1837, 30.5765), pix_arcsec=2.0,
              velocity=(-321.2, 1.28))


def _make_ns(tmp_path):
    """Namespace seeding the free variables the docs prose introduces
    (``tests/test_docs.py``'s, built with the port)."""
    from spectral_cube_tpu_torch import SpectralCube, Quantity
    import spectral_cube_tpu_torch.units as u
    from spectral_cube_tpu_torch.ops.smoothing import gaussian_kernel1d

    path, _ = make_cube_file(tmp_path, name="my_cube.fits",
                             shape=(12, 10, 8))
    _write_lmv(str(tmp_path / "my_cube.lmv"), path)
    pa, _ = make_cube_file(tmp_path, name="a.fits", shape=(6, 8, 8))
    pb, _ = make_cube_file(tmp_path, name="b.fits", shape=(6, 8, 8),
                           seed=3)
    vr_path, _ = make_vr_cube_file(tmp_path, shape=(6, 8, 8))

    base = SpectralCube.read(path)
    sv = np.asarray(base.with_spectral_unit(
        u.km_s, velocity_convention="radio").spectral_axis.value)
    vcube = base.with_spectral_unit(u.km_s, velocity_convention="radio")
    return {
        "cube": base,
        "masked": base.with_mask(base > Quantity(0.2, base.unit)),
        "vcube": vcube,
        "new_axis_quantity": Quantity(
            np.linspace(sv.min(), sv.max(), 7), "km / s"),
        "gaussian_kernel1d": gaussian_kernel1d,
        "kcube": base.to("K"),
        "vr_cube": SpectralCube.read(vr_path),
        "target_header": base.header,
        "kernel": np.ones((3, 3)) / 9.0,
        "cube_a": SpectralCube.read(pa),
        "cube_b": SpectralCube.read(pb),
        "velocity_surface": Quantity(
            np.full(base.shape[1:], sv.mean()), "km / s"),
        "v_center": Quantity(sv.mean(), "km / s"),
        "f_line1": Quantity(1.4204, "GHz"),
        "f_line2": Quantity(1.4199, "GHz"),
        "vmin": Quantity(sv.min(), "km / s"),
        "vmax": Quantity(sv.max(), "km / s"),
        "tmp_dir": tmp_path,
    }


def test_doc_blocks_run(page, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ns = _make_ns(tmp_path)
    blocks = _blocks(page)
    assert blocks, f"{page} has no python blocks"
    for i, block in enumerate(blocks):
        if (page, i) in JAX_ONLY_BLOCKS:
            continue
        block = re.sub(r"\bspectral_cube_tpu\b", "spectral_cube_tpu_torch",
                       block)
        # region examples in the docs point at real survey coordinates;
        # re-center them on the synthetic cube's WCS
        block = block.replace('circle(52.23, 31.24, 10\\")',
                              'circle(23.1837, 30.5765, 10\\")')
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                exec(compile(block, f"{page}:block{i}", "exec"), ns)
            except Exception as exc:
                raise AssertionError(
                    f"{page} block {i} failed: {type(exc).__name__}: "
                    f"{exc}\n--- block ---\n{block}") from exc


def test_all_doc_pages_listed():
    """Every docs page with python blocks is in PAGES (no silently
    untested documentation)."""
    for fname in sorted(os.listdir(DOCS_DIR)):
        if not fname.endswith(".md") or fname in PAGES:
            continue
        assert not _blocks(fname), \
            f"{fname} has python blocks but is not in test PAGES"


def test_jax_only_blocks_still_call_jax():
    """Each block of JAX_ONLY_BLOCKS still calls JAX, so the list cannot
    go stale; no other block does."""
    for page in PAGES:
        for i, block in enumerate(_blocks(page)):
            calls_jax = re.search(r"\b(jax|jnp|enable_compilation_cache)\b",
                                  block) is not None
            assert calls_jax == ((page, i) in JAX_ONLY_BLOCKS), (page, i)


def test_every_jax_test_is_carried_over():
    """Each test of tests/test_docs.py is here or in NOT_CARRIED, and
    each NOT_CARRIED entry is still absent from this file."""
    check_carried_over(JAX_FILES, globals(), NOT_CARRIED, CPU_ONLY)
    assert set(CPU_ONLY_PAGES) <= set(PAGES)
