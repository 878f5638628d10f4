"""Torch port, the format registry and CLASS .lmv cubes against the JAX
package.

- GILDAS type-2 .lmv files in both byte orders (``_build_type2_lmv`` of
  ``tests/test_io.py``, in both of its layouts) read bitwise as the JAX
  package reads them: data, masks, WCS cards, beam, unit.  Type 1 is read
  only through the reference library's example file, skipped where it is
  absent, as in the JAX package's tests.
- ``_detect_format`` and the format names of the registry.
- Any object with ``.header`` and ``.data`` reads as a cube in both
  packages, bitwise equal (the port refused it before).
- ``write_stokes_cube`` writes FITS whatever ``format`` says, as the JAX
  package's does, and ``SpectralCube.read(use_dask=True)`` raises.
"""

import os
import types
import warnings

import numpy as np
import pytest
import torch

import spectral_cube_tpu as J
from spectral_cube_tpu.io import class_lmv as j_lmv
from spectral_cube_tpu.io.fits_low import read_fits

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch.io import class_lmv as t_lmv
from spectral_cube_tpu_torch.io import _detect_format, read_cube

from conftest import make_cube_file
from test_io import REF_DATA, _build_type2_lmv
from test_torch_casa import assert_read_equal, read_both


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("full_sections", [False, True])
@pytest.mark.parametrize("endian", ["<", ">"])
def test_lmv_type2_reads_as_jax(tmp_path, endian, full_sections):
    path = tmp_path / "cube.lmv"
    path.write_bytes(_build_type2_lmv(endian, full_sections=full_sections))
    data_t, hdr_t = t_lmv.read_lmv(str(path))
    data_j, hdr_j = j_lmv.read_lmv(str(path))
    np.testing.assert_array_equal(data_t, data_j)
    assert hdr_t == hdr_j
    t, j = read_both(str(path))
    assert_read_equal(t, j)
    assert np.isnan(t._data.numpy()).sum() == 1
    assert t.meta["filename"] == str(path)


def test_lmv_byte_orders_agree(tmp_path):
    """A big-endian file decodes to the little-endian file's cube."""
    cubes = []
    for endian in "<>":
        path = tmp_path / f"{'le' if endian == '<' else 'be'}.lmv"
        path.write_bytes(_build_type2_lmv(endian, full_sections=True))
        cubes.append(T.SpectralCube.read(str(path), device="cpu"))
    np.testing.assert_array_equal(cubes[0]._data.numpy(),
                                  cubes[1]._data.numpy())
    assert cubes[0].wcs.to_header() == cubes[1].wcs.to_header()
    assert cubes[0].beam.major.to_value("deg") == \
        cubes[1].beam.major.to_value("deg")


@pytest.mark.skipif(not os.path.exists(f"{REF_DATA}/example_cube.lmv"),
                    reason="reference LMV example not available")
def test_lmv_reader_reference_file():
    t, j = read_both(f"{REF_DATA}/example_cube.lmv")
    assert_read_equal(t, j)
    assert t.shape == (7, 4, 3)


def test_lmv_rejects_other_files(tmp_path):
    from spectral_cube_tpu_torch.utils import FITSReadError
    path = tmp_path / "bad.lmv"
    path.write_bytes(b"NOTGILDAS" + bytes(600))
    with pytest.raises(FITSReadError, match="not a GILDAS image"):
        T.SpectralCube.read(str(path), device="cpu")
    assert t_lmv.is_lmv(str(path)) == j_lmv.is_lmv(str(path))


def test_detect_format(tmp_path):
    from spectral_cube_tpu.io import _detect_format as j_detect
    path, _ = make_cube_file(tmp_path, name="det.fits")
    plain = tmp_path / "fitsfile"
    plain.write_bytes(open(path, "rb").read())
    casa = tmp_path / "x.image"
    casa.mkdir()
    (casa / "table.dat").write_bytes(b"")
    for name in (path, str(plain), str(casa), "x.lmv", "X.LMV", "y.fit"):
        assert _detect_format(name) == j_detect(name)
    assert _detect_format(str(casa)) == "casa_image"
    assert _detect_format(str(plain)) == "fits"
    for bad in ("x.txt", str(tmp_path)):
        with pytest.raises(ValueError, match="Cannot determine format"):
            _detect_format(bad)
        with pytest.raises(ValueError):
            j_detect(bad)


@pytest.mark.parametrize("fmt", ["lmv", "class_lmv"])
def test_registry_format_names(tmp_path, fmt):
    path = tmp_path / "named.bin"
    path.write_bytes(_build_type2_lmv("<"))
    t = T.SpectralCube.read(str(path), format=fmt, device="cpu")
    j = J.SpectralCube.read(str(path), format=fmt)
    assert_read_equal(t, j)
    with pytest.raises(ValueError, match="Unknown format"):
        read_cube(str(path), format="hdf5", device="cpu")


def test_hdu_like_object_reads_as_jax(tmp_path):
    """An object with ``.header`` and ``.data`` (an astropy HDU, say) reads
    as a cube in both packages, bitwise equal."""
    path, _ = make_cube_file(tmp_path, shape=(4, 5, 6))
    hdu = read_fits(path)[0]
    header = {k: hdu.header[k] for k in hdu.header.keys()}
    header["HISTORY"] = "dropped"
    like = types.SimpleNamespace(header=types.SimpleNamespace(
        items=lambda: list(header.items())), data=np.asarray(hdu.data))
    t = T.SpectralCube.read(like, device="cpu")
    j = J.SpectralCube.read(like)
    assert_read_equal(t, j)
    np.testing.assert_array_equal(t._data.numpy(),
                                  np.asarray(hdu.data, dtype=np.float32))


def test_write_stokes_cube_writes_fits_whatever_the_format(tmp_path):
    """``format`` is not read: a '.image' name gets FITS bytes, as in the
    JAX package (ROADMAP.md records the oddity)."""
    from spectral_cube_tpu.io.fits_low import is_fits
    path, _ = make_cube_file(tmp_path, shape=(3, 4, 5))
    t, j = read_both(path)
    ts = T.StokesSpectralCube({"I": t})
    js = J.StokesSpectralCube({"I": j})
    ts.write(str(tmp_path / "t.image"), format="casa_image")
    js.write(str(tmp_path / "j.image"), format="casa_image")
    assert is_fits(str(tmp_path / "t.image"))
    assert is_fits(str(tmp_path / "j.image"))
    back = T.StokesSpectralCube.read(str(tmp_path / "t.image"),
                                     format="fits", device="cpu")
    assert back.components == ["I"]
    np.testing.assert_array_equal(back["I"]._data.numpy(), t._data.numpy())


def test_write_cube_format_from_suffix(tmp_path):
    path, _ = make_cube_file(tmp_path, shape=(3, 4, 5))
    t = T.SpectralCube.read(path, device="cpu")
    t.write(str(tmp_path / "a.im"))
    t.write(str(tmp_path / "a.fits"))
    assert _detect_format(str(tmp_path / "a.im")) == "casa_image"
    assert _detect_format(str(tmp_path / "a.fits")) == "fits"
    with pytest.raises(ValueError, match="Unknown format"):
        t.write(str(tmp_path / "b.x"), format="hdf5")


def test_read_use_dask_raises(tmp_path):
    path, _ = make_cube_file(tmp_path, shape=(3, 4, 5))
    with pytest.raises(NotImplementedError, match="item 12"):
        T.SpectralCube.read(path, use_dask=True, device="cpu")


def test_lmv_default_device(tmp_path, monkeypatch):
    path = tmp_path / "dev.lmv"
    path.write_bytes(_build_type2_lmv("<"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_lmv.load_lmv_cube(str(path))
    assert t_lmv.load_lmv_cube(str(path), device="cpu").device == \
        torch.device("cpu")
