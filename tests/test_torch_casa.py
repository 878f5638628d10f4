"""Torch port, CASA images against the JAX package: the table reader, the
writer, masks (``mask0``, appended masks, ``Image_defaultmask``),
per-plane beams, Stokes and 3-axis images, both byte orders.

Mirrors ``tests/test_casa.py`` by name.  That file reads the reference
library's checked-in images where they exist; here each image is
synthesized by the JAX package's writer (a little-endian copy made by
flipping the table's byte-order flag and swapping the payload), so every
case runs.  Data, include masks, WCS cards, beams and units read by the
port are bitwise the JAX package's, and the port's writer and
``make_casa_mask`` give directories byte-identical to the JAX package's
(every file).
"""

import os
import shutil
import struct
import warnings

import numpy as np
import pytest
import torch

import spectral_cube_tpu as J
import spectral_cube_tpu.units as ju
from spectral_cube_tpu.io import casa_low as j_low
from spectral_cube_tpu.io import casa_writer as j_writer
from spectral_cube_tpu.io.casa_masks import make_casa_mask as j_make_mask

import spectral_cube_tpu_torch as T
import spectral_cube_tpu_torch.units as tu
from spectral_cube_tpu_torch.io import casa_low as t_low
from spectral_cube_tpu_torch.io import casa_writer as t_writer
from spectral_cube_tpu_torch.io import native as t_native
from spectral_cube_tpu_torch.io.casa_masks import (
    make_casa_mask as t_make_mask, _append_mask_subtable)
from spectral_cube_tpu_torch.utils import FITSReadError

from conftest import make_cube_file, make_vr_cube_file
from test_torch_slicing import assert_cube_equal


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def read_both(path, stokes=False):
    """(port, JAX) reads of one path; the port's on the CPU."""
    if stokes:
        return (T.StokesSpectralCube.read(path, device="cpu"),
                J.StokesSpectralCube.read(path))
    return T.SpectralCube.read(path, device="cpu"), J.SpectralCube.read(path)


def assert_read_equal(t, j):
    """A cube read by each package: data, include mask, WCS cards, unit
    and beams bitwise equal."""
    assert_cube_equal(t, j)
    if hasattr(j, "unmasked_beams"):
        for attr in ("major", "minor", "pa"):
            np.testing.assert_array_equal(
                np.asarray(getattr(t.unmasked_beams, attr).value),
                np.asarray(getattr(j.unmasked_beams, attr).value))
    else:
        assert_beam_equal(getattr(t, "_beam", None), getattr(j, "_beam", None))


def assert_beam_equal(t, j):
    """Two beams (or two Nones) with bitwise equal axes and angle."""
    assert (t is None) == (j is None)
    if t is not None:
        for attr in ("major", "minor", "pa"):
            assert getattr(t, attr).to_value("deg") == \
                getattr(j, attr).to_value("deg")


def assert_stokes_read_equal(t, j):
    assert isinstance(t, T.StokesSpectralCube)
    assert t.components == j.components
    for k in t.components:
        assert_read_equal(t[k], j[k])


def assert_dirs_identical(a, b):
    """Two CASA directories hold the same files with the same bytes."""
    def listing(root):
        out = {}
        for dirpath, _, files in os.walk(root):
            for f in files:
                full = os.path.join(dirpath, f)
                out[os.path.relpath(full, root)] = full
        return out
    la, lb = listing(a), listing(b)
    assert sorted(la) == sorted(lb)
    for rel in la:
        with open(la[rel], "rb") as fa, open(lb[rel], "rb") as fb:
            assert fa.read() == fb.read(), rel


def write_both(tmp_path, tcube, jcube, name, **kwargs):
    """The same cube written by each package's writer; the directories
    are byte-identical.  Returns the port's path."""
    tp, jp = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    t_writer.write_casa_image(tcube, tp, **kwargs)
    j_writer.write_casa_image(jcube, jp, **kwargs)
    assert_dirs_identical(tp, jp)
    return tp


def cubes_from_fits(tmp_path, **kwargs):
    path, data = make_cube_file(tmp_path, **kwargs)
    t, j = read_both(path)
    return t, j, data


def little_endian_copy(src, dst):
    """A copy of a single-tile float CASA image with little-endian
    payloads: the table's byte-order flag (Table block, after the row
    count) set to 1 and the data swapped.  The bit-packed mask has no
    byte order."""
    shutil.copytree(src, dst)
    tdat = os.path.join(dst, "table.dat")
    raw = bytearray(open(tdat, "rb").read())
    flag = 4 + 4 + (4 + len("Table")) + 4 + 4
    assert struct.unpack_from(">I", raw, flag)[0] == 0
    struct.pack_into(">I", raw, flag, 1)
    open(tdat, "wb").write(bytes(raw))
    tsm = os.path.join(dst, "table.f0_TSM0")
    payload = np.frombuffer(open(tsm, "rb").read(), ">f4")
    open(tsm, "wb").write(payload.astype("<f4").tobytes())
    for mask in ("mask0",):
        mdat = os.path.join(dst, mask, "table.dat")
        raw = bytearray(open(mdat, "rb").read())
        struct.pack_into(">I", raw, flag, 1)
        open(mdat, "wb").write(bytes(raw))
    return dst


@pytest.fixture
def basic_images(tmp_path):
    """The reference's basic.image in kind: I and Q of ones, (3, 4, 5),
    Jy/beam, a 1" beam; big-endian as the writer makes it, and a
    little-endian copy."""
    from conftest import base_header
    from spectral_cube_tpu.io.fits_low import HDU, write_fits
    cubes = {}
    for name in "IQ":
        h = base_header(nx=5, ny=4, nchan=3, ctype3="FREQ", cunit3="Hz",
                        crval3=1.42192925e9, cdelt3=-1e6)
        p = str(tmp_path / f"{name}.fits")
        write_fits(p, [HDU(data=np.ones((3, 4, 5)), header=h)])
        cubes[name] = J.SpectralCube.read(p)
    big = str(tmp_path / "basic_bigendian.image")
    j_writer.write_casa_image(J.StokesSpectralCube(cubes), big)
    little = little_endian_copy(big, str(tmp_path / "basic.image"))
    return {"little": little, "big": big}


# ---------------------------------------------------------------------------
# reading (test_casa.py:18-100)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["little", "big"])
def test_read_casa_image(basic_images, order):
    t, j = read_both(basic_images[order], stokes=True)
    assert_stokes_read_equal(t, j)
    assert set(t.components) == {"I", "Q"}
    i = t["I"]
    assert i.shape == (3, 4, 5) and i.device == torch.device("cpu")
    assert i.unit == tu.Jy / tu.beam
    assert i.wcs.ctype[0] == "RA---SIN"
    np.testing.assert_array_equal(i._data.numpy(), 1.0)


@pytest.mark.parametrize("assembly", ["native", "numpy"])
def test_casa_endianness_agreement(basic_images, assembly, monkeypatch):
    """Both byte orders decode to the same values, through the C++ tile
    assembler and through the numpy fallback."""
    if assembly == "numpy":
        monkeypatch.setattr(t_native, "assemble_casa_tiles",
                            lambda *a, **k: None)
    elif not t_native._load_tiles():
        pytest.skip("no C++ toolchain")
    le = T.SpectralCube.read(basic_images["little"], device="cpu")
    be = T.SpectralCube.read(basic_images["big"], device="cpu")
    np.testing.assert_array_equal(le._data.numpy(), be._data.numpy())
    np.testing.assert_array_equal(le.get_mask_array(), be.get_mask_array())
    assert_read_equal(le, J.SpectralCube.read(basic_images["little"]))


def test_casa_mask_read(tmp_path):
    tcube, jcube, data = cubes_from_fits(tmp_path, shape=(4, 5, 6))
    path = write_both(tmp_path, tcube, jcube, "m.image")
    t, j = read_both(path)
    assert_read_equal(t, j)
    filled = t.filled_data[:].value
    assert np.isnan(filled[1, 1, 1])
    assert np.isfinite(filled).sum() == np.isfinite(data).sum()


def test_casa_beam(basic_images):
    t, j = read_both(basic_images["little"])
    assert_beam_equal(t.beam, j.beam)
    assert t.beam.major.to_value("deg") * 3600 == pytest.approx(1.0,
                                                                rel=1e-6)


def test_casa_moments_run(tmp_path):
    tcube, jcube, _ = cubes_from_fits(tmp_path, shape=(8, 6, 7))
    t, j = read_both(write_both(tmp_path, tcube, jcube, "mom.image"))
    for order in (0, 1, 2):
        a = np.asarray(t.moment(order=order).value)
        b = np.asarray(j.moment(order=order).value)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-6, equal_nan=True)


def test_casa_format_detection(basic_images, tmp_path):
    from spectral_cube_tpu.io import _detect_format as j_detect
    from spectral_cube_tpu_torch.io import _detect_format as t_detect
    empty = tmp_path / "not_an_image"
    empty.mkdir()
    for path in (basic_images["little"], "x.lmv", "x.fits"):
        assert t_detect(path) == j_detect(path)
    assert t_detect(basic_images["big"]) == "casa_image"
    for bad in (str(empty), "x.txt"):
        with pytest.raises(ValueError):
            t_detect(bad)


def _records_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _records_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_aipsio_record_contents(basic_images):
    for order in ("little", "big"):
        path = os.path.join(basic_images[order], "table.dat")
        rec = t_low.read_table_keywords(path)
        _records_equal(rec, j_low.read_table_keywords(path))
        assert rec["units"] == "Jy / beam"
        assert rec["coords"]["direction0"]["projection"] == "SIN"
        assert t_low.read_table_keywords(path, return_endian=True)[1] == \
            {"little": "<", "big": ">"}[order]


def test_tiled_bool_unpack(basic_images):
    for order in ("little", "big"):
        mask = t_low.read_tiled_data(
            os.path.join(basic_images[order], "mask0"), 0)
        assert mask.dtype == np.bool_ and mask.shape == (3, 2, 4, 5)
        assert mask.all()


def test_multitile_assembly(tmp_path):
    """A multi-tile image (tiles ragged in every axis) assembles to the
    same array in both packages and to the written data."""
    tcube, jcube, data = cubes_from_fits(tmp_path, shape=(5, 7, 9))
    path = write_both(tmp_path, tcube, jcube, "tiles.image",
                      tile_shape=(4, 3, 1, 2))
    out = t_low.read_tiled_data(path, 0)
    np.testing.assert_array_equal(out, j_low.read_tiled_data(path, 0))
    np.testing.assert_array_equal(out[:, 0], tcube._data.numpy())


# ---------------------------------------------------------------------------
# writing (test_casa.py:173-300)
# ---------------------------------------------------------------------------

def test_casa_write_read_roundtrip(tmp_path):
    tcube, jcube, data = cubes_from_fits(tmp_path)
    path = str(tmp_path / "round.image")
    tcube.write(path, format="casa_image")
    j_writer.write_casa_image(jcube, str(tmp_path / "j.image"))
    assert_dirs_identical(path, str(tmp_path / "j.image"))
    t, j = read_both(path)
    assert_read_equal(t, j)
    assert t.beam == tcube.beam and t.unit == tcube.unit
    np.testing.assert_allclose(
        np.asarray(tcube.with_spectral_unit(tu.Hz).spectral_axis.value),
        np.asarray(t.spectral_axis.value), rtol=1e-9)
    assert np.isnan(t.filled_data[:].value[1, 1, 1])
    # the format comes from the suffix
    tcube.write(str(tmp_path / "suffix.image"))
    assert_dirs_identical(path, str(tmp_path / "suffix.image"))


def test_casa_write_vr_beams(tmp_path):
    p, _ = make_vr_cube_file(tmp_path, shape=(4, 5, 6))
    tcube, jcube = read_both(p)
    t, j = read_both(write_both(tmp_path, tcube, jcube, "vr.image"))
    assert isinstance(t, T.VaryingResolutionSpectralCube)
    assert_read_equal(t, j)
    np.testing.assert_array_equal(
        np.asarray(t.unmasked_beams.major.value),
        np.asarray(tcube.unmasked_beams.major.to(
            t.unmasked_beams.major.unit).value).astype(float))


def test_casa_write_stokes(tmp_path):
    t_parts, j_parts = {}, {}
    for i, name in enumerate("IQ"):
        p, _ = make_cube_file(tmp_path, f"{name}.fits", seed=5 + i,
                              with_nan=False)
        t_parts[name], j_parts[name] = read_both(p)
    path = write_both(tmp_path, T.StokesSpectralCube(t_parts),
                      J.StokesSpectralCube(j_parts), "stokes.image")
    t, j = read_both(path, stokes=True)
    assert_stokes_read_equal(t, j)
    np.testing.assert_array_equal(t["Q"]._data.numpy(),
                                  t_parts["Q"]._data.numpy())


def test_casa_read_stokes_image_as_i(tmp_path, monkeypatch):
    """``SpectralCube.read`` of an IQ image gives the I cube with a
    StokesWarning in both packages, and the port builds only that
    component: one upload, not one per component."""
    from spectral_cube_tpu.utils import StokesWarning as JStokesWarning
    from spectral_cube_tpu_torch import cube as t_cube
    from spectral_cube_tpu_torch.utils import StokesWarning
    t_parts, j_parts = {}, {}
    for i, name in enumerate("IQ"):
        p, _ = make_cube_file(tmp_path, f"{name}.fits", seed=5 + i)
        t_parts[name], j_parts[name] = read_both(p)
    path = write_both(tmp_path, T.StokesSpectralCube(t_parts),
                      J.StokesSpectralCube(j_parts), "stokes.image")
    uploads = []
    as_tensor = t_cube._as_tensor

    def counted(arr, device):
        if isinstance(arr, np.ndarray):  # a host array going to the device
            uploads.append(arr.shape)
        return as_tensor(arr, device)
    monkeypatch.setattr(t_cube, "_as_tensor", counted)
    with pytest.warns(StokesWarning):
        t = T.SpectralCube.read(path, device="cpu")
    with pytest.warns(JStokesWarning):
        j = J.SpectralCube.read(path)
    assert isinstance(t, T.SpectralCube) and len(uploads) == 1
    assert_read_equal(t, j)
    np.testing.assert_array_equal(t._data.numpy(),
                                  t_parts["I"]._data.numpy())


def test_make_casa_mask(tmp_path):
    tcube, jcube, data = cubes_from_fits(tmp_path)
    tm = tcube.with_mask(tcube > 0.5 * tu.Jy / tu.beam)
    jm = jcube.with_mask(jcube > 0.5 * ju.Jy / ju.beam)
    t_make_mask(tm, str(tmp_path / "t_mask.image"), append_to_image=False)
    j_make_mask(jm, str(tmp_path / "j_mask.image"), append_to_image=False)
    assert_dirs_identical(str(tmp_path / "t_mask.image"),
                          str(tmp_path / "j_mask.image"))
    t, j = read_both(str(tmp_path / "t_mask.image"))
    assert_read_equal(t, j)
    expected = (np.isfinite(data) & (data > 0.5)).astype("f4")
    np.testing.assert_array_equal(t._data.numpy(), expected)


def test_casa_multi_tile_roundtrip(tmp_path):
    tcube, jcube, data = cubes_from_fits(tmp_path, shape=(6, 10, 14))
    path = write_both(tmp_path, tcube, jcube, "tiled.image",
                      tile_shape=(5, 4, 1, 4))
    t, j = read_both(path)
    assert_read_equal(t, j)
    inc = t.mask.include(data=t._data).numpy()
    assert not inc[1, 1, 1] and inc.sum() == np.isfinite(data).sum()


def _append_both(tmp_path, tcube, jcube, name, drop_mask0=False,
                 **write_kwargs):
    """Write the cube with both writers, append the 0.5 Jy/beam mask with
    each package's make_casa_mask; the images stay byte-identical."""
    paths = []
    for tag, cube, writer, make, unit in (
            ("t", tcube, t_writer, t_make_mask, tu),
            ("j", jcube, j_writer, j_make_mask, ju)):
        img = str(tmp_path / f"{tag}_{name}")
        writer.write_casa_image(cube, img, **write_kwargs)
        if drop_mask0:
            shutil.rmtree(os.path.join(img, "mask0"))
        masked = cube.with_mask(cube > 0.5 * unit.Jy / unit.beam)
        make(masked, str(tmp_path / f"{tag}_{name}_m" / "newmask"),
             append_to_image=True, img=img)
        paths.append(img)
    assert_dirs_identical(*paths)
    assert_dirs_identical(str(tmp_path / f"t_{name}_m"),
                          str(tmp_path / f"j_{name}_m"))
    return paths[0]


def test_casa_append_mask(tmp_path):
    tcube, jcube, data = cubes_from_fits(tmp_path)
    img = _append_both(tmp_path, tcube, jcube, "target.image",
                       drop_mask0=True)
    assert os.path.isdir(os.path.join(img, "newmask"))
    t, j = read_both(img)
    assert_read_equal(t, j)
    np.testing.assert_array_equal(t.get_mask_array(),
                                  np.isfinite(data) & (data > 0.5))


def test_native_tile_assembler_matches_python(tmp_path, monkeypatch):
    if not t_native._load_tiles():
        pytest.skip("no C++ toolchain")
    tcube, jcube, _ = cubes_from_fits(tmp_path, shape=(6, 10, 14))
    out = write_both(tmp_path, tcube, jcube, "tiled2.image",
                     tile_shape=(5, 4, 1, 4))
    ref = t_low.read_tiled_data(out, 0)
    mask = t_low.read_tiled_data(os.path.join(out, "mask0"), 0)
    monkeypatch.setattr(t_native, "assemble_casa_tiles",
                        lambda *a, **k: None)
    np.testing.assert_array_equal(t_low.read_tiled_data(out, 0), ref)
    np.testing.assert_array_equal(
        t_low.read_tiled_data(os.path.join(out, "mask0"), 0), mask)


def test_casa_3axis_image_roundtrip_and_append_mask(tmp_path):
    tcube, jcube, data = cubes_from_fits(tmp_path)
    t, j = read_both(write_both(tmp_path, tcube, jcube, "c3.image",
                                with_stokes=False))
    assert_read_equal(t, j)
    img = _append_both(tmp_path, tcube, jcube, "c3m.image",
                       drop_mask0=True, with_stokes=False)
    t, j = read_both(img)
    assert_read_equal(t, j)
    expected = np.isfinite(data) & (data > 0.5)
    assert not np.array_equal(expected[0], expected[1])
    np.testing.assert_array_equal(t.get_mask_array(), expected)


def test_casa_pc_matrix_serialized_column_major(tmp_path):
    """A rotated PC matrix writes column-major, byte for byte as the JAX
    package, and reads back with its rotation sense."""
    from spectral_cube_tpu.io.fits_low import HDU, write_fits
    tcube, jcube, data = cubes_from_fits(tmp_path)
    h = jcube.header.copy()
    c, s = np.cos(np.radians(30.0)), np.sin(np.radians(30.0))
    h["PC1_1"], h["PC1_2"], h["PC2_1"], h["PC2_2"] = c, -s, s, c
    p = str(tmp_path / "rot.fits")
    write_fits(p, [HDU(data=data, header=h)])
    trot, jrot = read_both(p)
    img = write_both(tmp_path, trot, jrot, "rot.image")
    raw = open(os.path.join(img, "table.dat"), "rb").read()
    assert struct.pack(">4d", c, s, -s, c) in raw
    t, j = read_both(img)
    assert_read_equal(t, j)
    np.testing.assert_allclose(np.asarray(t.wcs.pc[:2, :2]),
                               np.asarray(trot.wcs.pc[:2, :2]), atol=1e-12)


def test_casa_multistokes_per_plane_beams_roundtrip(tmp_path):
    pv, _ = make_vr_cube_file(tmp_path, shape=(4, 6, 5))
    ti, ji = read_both(pv)
    majs = np.asarray(ji.unmasked_beams.major.to("arcsec").value)
    tq = ti.with_beams(T.Beams(major=tu.Quantity(majs * 2.0, "arcsec")),
                       raise_error_jybm=False)
    jq = ji.with_beams(J.Beams(major=ju.Quantity(majs * 2.0, "arcsec")),
                       raise_error_jybm=False)
    img = write_both(tmp_path, T.StokesSpectralCube({"I": ti, "Q": tq}),
                     J.StokesSpectralCube({"I": ji, "Q": jq}), "iq.image")
    t, j = read_both(img, stokes=True)
    assert_stokes_read_equal(t, j)
    np.testing.assert_allclose(
        np.asarray(t["Q"].unmasked_beams.major.to("arcsec").value),
        majs * 2.0, rtol=1e-6)


def test_casa_write_preserves_mask_with_finite_fill(tmp_path):
    tcube, jcube, data = cubes_from_fits(tmp_path)
    tm = tcube.with_mask(tcube > 0.5 * tu.Jy / tu.beam).with_fill_value(0.0)
    jm = jcube.with_mask(jcube > 0.5 * ju.Jy / ju.beam).with_fill_value(0.0)
    t, j = read_both(write_both(tmp_path, tm, jm, "ff.image"))
    assert_read_equal(t, j)
    np.testing.assert_array_equal(t.get_mask_array(),
                                  np.isfinite(data) & (data > 0.5))


def test_casa_append_mask_updates_defaultmask(tmp_path):
    tcube, jcube, data = cubes_from_fits(tmp_path)
    img = _append_both(tmp_path, tcube, jcube, "keep.image")
    assert t_low.read_table_keywords(
        os.path.join(img, "table.dat"))["Image_defaultmask"] == "newmask"
    t, j = read_both(img)
    assert_read_equal(t, j)
    np.testing.assert_array_equal(t.get_mask_array(),
                                  np.isfinite(data) & (data > 0.5))


@pytest.mark.parametrize("casa_shape,tile", [([7, 5, 3, 11], [4, 2, 2, 3]),
                                             ([9, 6, 5], [4, 4, 2])])
def test_encode_tiles_vectorized_matches_loop(casa_shape, tile):
    """The port's tile re-layout gives the JAX package's bytes, floats
    and per-tile bit-packed booleans, ragged edges included."""
    rng = np.random.RandomState(0)
    arr = rng.rand(*casa_shape[::-1]).astype("f4")
    for a, code in ((arr, t_low.TP_FLOAT), (arr > 0.5, t_low.TP_BOOL)):
        assert t_writer._encode_tiles(a, casa_shape, tile, code) == \
            j_writer._encode_tiles(a, casa_shape, tile, code)


@pytest.mark.parametrize("bigendian", [False, True])
def test_casa_read_basic(basic_images, bigendian):
    path = basic_images["big" if bigendian else "little"]
    t = T.SpectralCube.read(path, device="cpu")
    j = J.SpectralCube.read(path)
    assert_read_equal(t, j)
    vals = t.wcs.pix2world(np.array([1.0]), np.array([2.0]),
                           np.array([3.0]))
    jvals = j.wcs.pix2world(np.array([1.0]), np.array([2.0]),
                            np.array([3.0]))
    for a, b in zip(vals, jvals):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert str(t.unit) == "Jy / beam"


def test_casa_read_basic_nomask(basic_images, tmp_path):
    path = shutil.copytree(basic_images["little"], str(tmp_path / "nm"))
    shutil.rmtree(os.path.join(path, "mask0"))
    t, j = read_both(path)
    assert_read_equal(t, j)
    assert t.get_mask_array().all()


def test_casa_mask_error_paths(tmp_path):
    tcube, jcube, _ = cubes_from_fits(tmp_path)
    masked = tcube.with_mask(tcube > 0.5 * tu.Jy / tu.beam)
    with pytest.raises(NotImplementedError):
        t_make_mask(masked, str(tmp_path / "m1"), stokes_posn=2,
                    append_to_image=False)
    with pytest.raises(TypeError):
        t_make_mask(masked, str(tmp_path / "m2"), append_to_image=True)
    with pytest.raises(OSError):
        t_make_mask(masked, str(tmp_path / "m3"), append_to_image=True,
                    img=str(tmp_path / "not_an_image"))
    img = str(tmp_path / "t.image")
    t_writer.write_casa_image(tcube, img)
    with pytest.raises(ValueError):
        t_make_mask(masked[:, :2, :], str(tmp_path / "m4"),
                    append_to_image=True, img=img)
    t_make_mask(masked, str(tmp_path / "m5"), append_to_image=True,
                img=img)
    with pytest.raises(OSError):
        _append_mask_subtable(masked, img, "m5", overwrite=False)
    _append_mask_subtable(masked, img, "m5", overwrite=True)
    with pytest.raises(OSError):
        t_writer.write_casa_image(tcube, img)
    with pytest.raises(FITSReadError, match="not a CASA image"):
        T.SpectralCube.read(str(tmp_path / "nothing.image"),
                            format="casa_image", device="cpu")


# ---------------------------------------------------------------------------
# the port only: cross reads, other images, the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["single", "tiled", "3axis", "vr",
                                  "stokes"])
def test_packages_cross_read(tmp_path, kind):
    """Each package reads the other's directory as its own."""
    if kind == "vr":
        p, _ = make_vr_cube_file(tmp_path, shape=(4, 5, 6))
        tcube, jcube = read_both(p)
    else:
        tcube, jcube, _ = cubes_from_fits(tmp_path, shape=(4, 5, 6))
    kwargs = {"tiled": {"tile_shape": (2, 3, 1, 3)},
              "3axis": {"with_stokes": False}}.get(kind, {})
    if kind == "stokes":
        tcube = T.StokesSpectralCube({"I": tcube, "V": tcube * 2})
        jcube = J.StokesSpectralCube({"I": jcube, "V": jcube * 2})
    tp, jp = str(tmp_path / "t.image"), str(tmp_path / "j.image")
    t_writer.write_casa_image(tcube, tp, **kwargs)
    j_writer.write_casa_image(jcube, jp, **kwargs)
    stokes = kind == "stokes"
    check = assert_stokes_read_equal if stokes else assert_read_equal
    t_of_j, _ = read_both(jp, stokes=stokes)
    _, j_of_t = read_both(tp, stokes=stokes)
    check(t_of_j, j_of_t)


def _handmade_image(path, arr, wcs, dtype_code):
    """A single-tile image written through the JAX writer's table
    helpers: a 2-D image or a float64 payload, which its public writer
    does not make."""
    from spectral_cube_tpu.io.casa_writer import (
        _write_table_dat, _write_tsm, _write_info, _wcs_to_casa_coords)
    os.makedirs(path)
    casa_shape = list(arr.shape[::-1])
    keywords = {"coords": _wcs_to_casa_coords(wcs), "units": "K",
                "miscinfo": {}, "imageinfo": {"imagetype": "Intensity",
                                              "objectname": "X"}}
    _write_table_dat(os.path.join(path, "table.dat"), keywords, "map",
                     dtype_code, len(casa_shape))
    dt = ">f8" if dtype_code == t_low.TP_DOUBLE else ">f4"
    _write_tsm(path, "map", casa_shape, arr.astype(dt).tobytes(),
               dtype_code)
    _write_info(path, "Image")
    return path


def test_read_2d_image_and_float64(tmp_path):
    """A 2-D image gives a Projection equal to the JAX package's; a
    float64 image gives float32 data on the device, as the JAX package
    stores it."""
    tcube, jcube, data = cubes_from_fits(tmp_path, shape=(3, 5, 6),
                                         with_nan=False)
    plane = np.random.RandomState(3).rand(5, 6)
    p2 = _handmade_image(str(tmp_path / "plane.image"), plane,
                         jcube.wcs.celestial, t_low.TP_FLOAT)
    t2, j2 = read_both(p2)
    assert isinstance(t2, T.Projection)
    np.testing.assert_array_equal(np.asarray(t2.value), np.asarray(j2.value))
    assert t2.wcs.to_header() == j2.wcs.to_header()
    assert t2.unit == tu.K
    cube64 = data.astype(">f8")
    p3 = _handmade_image(str(tmp_path / "f64.image"), cube64, jcube.wcs,
                         t_low.TP_DOUBLE)
    t3, j3 = read_both(p3)
    assert t3._data.dtype == torch.float32
    assert_read_equal(t3, j3)


def test_unreadable_mask_warns(tmp_path):
    """A mask that cannot be read is a warning and the data stands alone,
    as in the JAX package."""
    tcube, jcube, _ = cubes_from_fits(tmp_path)
    img = write_both(tmp_path, tcube, jcube, "broken.image")
    open(os.path.join(img, "mask0", "table.f0"), "wb").write(b"garbage")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t = T.SpectralCube.read(img, device="cpu")
    assert any("could not read CASA mask" in str(w.message) for w in rec)
    assert_read_equal(t, J.SpectralCube.read(img))


def test_load_casa_image_default_device(tmp_path, monkeypatch):
    """The CASA loader lands on the CUDA device unless asked otherwise,
    and raises where CUDA is absent."""
    from spectral_cube_tpu_torch.io.casa_image import load_casa_image
    tcube, jcube, _ = cubes_from_fits(tmp_path)
    img = write_both(tmp_path, tcube, jcube, "dev.image")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_casa_image(img)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.SpectralCube.read(img)
    assert load_casa_image(img, device="cpu").device == torch.device("cpu")


def test_stored_mask_is_one_upload(tmp_path):
    """The stored validity mask is a tensor on the cube's device, and-ed
    with the finiteness of the data."""
    tcube, jcube, _ = cubes_from_fits(tmp_path)
    t = T.SpectralCube.read(write_both(tmp_path, tcube, jcube, "s.image"),
                            device="cpu")
    stored = t.mask._mask2
    assert isinstance(stored, T.BooleanArrayMask)
    assert stored._mask.device == t.device
    assert tuple(stored._mask.shape) == t.shape
