"""Torch port, the exporters and viewers against the JAX package.

The mocked yt, glue, ds9 and pvextractor modules of
``tests/test_exporters_mock.py`` stand in for the optional packages; each
sees the same arrays and arguments from both packages.  ``quicklook``
(on a Projection, a spectrum and a mask), ``plot_channel_maps`` and the
channel-movie frames draw under matplotlib's Agg backend and give the
JAX package's pixels.  Without astroquery ``find_lines`` raises
ImportError in both.  Importing the port loads none of the optional
packages.
"""

import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

import spectral_cube_tpu as J

import spectral_cube_tpu_torch as T

from conftest import make_cube_file
from test_exporters_mock import _fake_yt_modules, _install

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.fixture
def pair(tmp_path):
    path, _ = make_cube_file(tmp_path, shape=(6, 5, 4))
    return T.SpectralCube.read(path, device="cpu"), J.SpectralCube.read(path)


def test_to_yt_sees_the_same_grid(monkeypatch, pair):
    loads = []
    for cube in pair:
        record = {}
        _fake_yt_modules(monkeypatch, record)
        yc = cube.to_yt(spectral_factor=2.0)
        loads.append((record["load"], yc))
    (t, tyc), (j, jyc) = loads
    np.testing.assert_array_equal(t["data"]["flux"], j["data"]["flux"])
    assert t["dims"] == j["dims"] and t["nprocs"] == j["nprocs"]
    np.testing.assert_array_equal(t["bbox"], j["bbox"])
    np.testing.assert_array_equal(tyc.yt2world([1.0, 2.0, 3.5]),
                                  jyc.yt2world([1.0, 2.0, 3.5]))
    world = tyc.yt2world([1.0, 2.0, 3.5])
    np.testing.assert_allclose(tyc.world2yt(list(world)), [1.0, 2.0, 3.5],
                               atol=1e-6)


def test_ytcube_quick_render_movie_and_isocontour(monkeypatch, pair,
                                                  tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg", force=True)
    calls = []
    monkeypatch.setattr(subprocess, "check_call",
                        lambda cmd, **kw: calls.append(cmd))
    levels = []
    for tag, cube in zip("tj", pair):
        record = {}
        _fake_yt_modules(monkeypatch, record)
        yc = cube.to_yt()
        images = yc.quick_render_movie(str(tmp_path / tag), size=16,
                                       nframes=3)
        assert len(images) == 3 and record["rotate"][1] == 3
        assert record["tf_bounds"][1] == pytest.approx(
            float(cube.max().value))
        yc.quick_isocontour(level="3 sigma")
        levels.append(yc.dataset.surfaces[-1].level)
        with pytest.raises(ValueError):
            yc.quick_isocontour(level=0.5, export_to="vtk", filename="x")
    assert calls[0][0] == "ffmpeg" and len(calls) == 2
    assert levels[0] == pytest.approx(levels[1], rel=1e-6)


def _fake_glue(monkeypatch, created):
    class _Data(dict):
        def __init__(self, label=None):
            self.label = label
            self.coords = None
            super().__init__()

    class _GlueApplication:
        def __init__(self, dc):
            created.append(dc)
            self.added = []

        def add_datasets(self, ds):
            self.added.append(ds)

        def start(self):
            pass

    core = types.ModuleType("glue.core")
    core.Data = _Data
    core.DataCollection = list
    coords = types.ModuleType("glue.core.coordinates")
    coords.coordinates_from_header = lambda h: dict(h)
    qt = types.ModuleType("glue.app.qt")
    qt.GlueApplication = _GlueApplication
    for name, mod in [("glue", types.ModuleType("glue")), ("glue.core", core),
                      ("glue.core.coordinates", coords),
                      ("glue.app", types.ModuleType("glue.app")),
                      ("glue.app.qt", qt)]:
        _install(monkeypatch, name, mod)


def test_to_glue_sees_the_same_data(monkeypatch, pair):
    created = []
    _fake_glue(monkeypatch, created)
    apps = [cube.to_glue(name="c", start_gui=False) for cube in pair]
    t, j = created[0][0], created[1][0]
    assert t.label == j.label == "c"
    np.testing.assert_array_equal(t["intensity"], j["intensity"])
    for key in ("CTYPE1", "CRVAL1", "CDELT3", "NAXIS1", "NAXIS3"):
        assert t.coords[key] == j.coords[key]
    assert pair[0].to_glue(start_gui=False, glue_app=apps[0]) is apps[0]
    assert apps[0].added


def test_to_pvextractor(monkeypatch, pair):
    gui = types.ModuleType("pvextractor.gui")
    gui.PVSlicer = type("PVSlicer", (), {
        "__init__": lambda self, c: setattr(self, "cube", c)})
    _install(monkeypatch, "pvextractor", types.ModuleType("pvextractor"))
    _install(monkeypatch, "pvextractor.gui", gui)
    out = pair[0].to_pvextractor()
    assert out.cube is pair[0]


def test_to_ds9_loads_the_same_file(monkeypatch, pair):
    loaded = []

    class DS9:
        def __init__(self, target=None, start=None):
            self.ctor = (target, start)
            self.sets = []

        def set(self, cmd):
            self.sets.append(cmd)
            if cmd.startswith("file "):
                from spectral_cube_tpu.io.fits_low import read_fits
                hdu = read_fits(cmd.split(" ", 1)[1])[0]
                loaded.append((np.array(hdu.data), dict(hdu.header)))

    mod = types.ModuleType("pyds9")
    mod.DS9 = DS9
    _install(monkeypatch, "pyds9", mod)
    monkeypatch.setitem(sys.modules, "ds9", None)
    dds = [cube.to_ds9(newframe=True) for cube in pair]
    np.testing.assert_array_equal(loaded[0][0], loaded[1][0])
    for key in ("CTYPE3", "CRVAL3", "CDELT3", "BUNIT", "BMAJ"):
        assert loaded[0][1][key] == loaded[1][1][key]
    assert dds[0].sets[0] == "frame new" and dds[0].ctor == (None, True)
    assert not os.path.exists(dds[0].sets[1].split(" ", 1)[1])
    assert pair[0].to_ds9(ds9id="x").ctor == ("x", False)


def test_find_lines(monkeypatch, pair):
    queries = []

    class Splatalogue:
        @staticmethod
        def query_lines(lo, hi, **kwargs):
            queries.append((lo, hi, kwargs))
            return "LINES"

    spl = types.ModuleType("astroquery.splatalogue")
    spl.Splatalogue = Splatalogue
    _install(monkeypatch, "astroquery", types.ModuleType("astroquery"))
    _install(monkeypatch, "astroquery.splatalogue", spl)
    from spectral_cube_tpu_torch.units import Quantity as TQ
    from spectral_cube_tpu.units import Quantity as JQ
    for cube, q in zip(pair, (TQ, JQ)):
        assert cube.find_lines(chemical_name="CO") == "LINES"
        cube.find_lines(velocity_offset=q(5.0, "km/s"),
                        velocity_convention="radio")
    assert queries[0] == queries[2] and queries[1] == queries[3]
    assert queries[0][2] == {"chemical_name": "CO"}


def test_find_lines_without_astroquery(monkeypatch, pair):
    monkeypatch.setitem(sys.modules, "astroquery", None)
    monkeypatch.setitem(sys.modules, "astroquery.splatalogue", None)
    for cube in pair:
        with pytest.raises(ImportError, match="astroquery"):
            cube.find_lines()


def test_to_yt_without_yt(monkeypatch, pair):
    monkeypatch.setitem(sys.modules, "yt", None)
    for cube in pair:
        with pytest.raises(ImportError, match="yt is required"):
            cube.to_yt()


def _png_pixels(path):
    import matplotlib.image
    return matplotlib.image.imread(path)


def test_quicklook_and_channel_maps(pair, tmp_path):
    """Both packages draw the same pixels: a Projection, a spectrum, a
    mask slice and a 2 x 2 grid of channel maps."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    for tag, cube in zip("tj", pair):
        plt.close("all")
        cube.moment0().quicklook(str(tmp_path / f"{tag}_m0.png"))
        plt.close("all")
        cube[:, 1, 1].quicklook(str(tmp_path / f"{tag}_sp.png"))
        plt.close("all")
        cube.mask.quicklook((2, slice(None), slice(None)),
                            filename=str(tmp_path / f"{tag}_mask.png"))
        plt.close("all")
        axes = cube.plot_channel_maps(2, 2, [0, 1, 3, 5],
                                      output_file=str(tmp_path
                                                      / f"{tag}_ch.png"),
                                      fig_smallest_dim_inches=2)
        assert len(axes) == 4
        with pytest.raises(ValueError, match="len"):
            cube.plot_channel_maps(2, 2, [0, 1])
        with pytest.raises(ValueError, match="2D"):
            cube.mask.quicklook((slice(None), slice(None), slice(None)))
    plt.close("all")
    for name in ("m0", "sp", "mask", "ch"):
        np.testing.assert_array_equal(_png_pixels(tmp_path / f"t_{name}.png"),
                                      _png_pixels(tmp_path / f"j_{name}.png"))


def test_channel_movie_frames(monkeypatch, pair, tmp_path):
    """``make_rgb_movie`` and ``make_multispecies_rgb`` render the same
    frames in both packages (ffmpeg replaced by a recorder)."""
    pytest.importorskip("matplotlib")
    from spectral_cube_tpu import visualization_tools as jv
    from spectral_cube_tpu_torch import visualization_tools as tv
    real_check = tv.check_ffmpeg
    runs = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: runs.append(cmd))
    for mod in (tv, jv):
        monkeypatch.setattr(mod, "check_ffmpeg", lambda cmd="ffmpeg": None)
    frames = {}
    for tag, mod, cube in (("t", tv, pair[0]), ("j", jv, pair[1])):
        axis = cube.spectral_axis
        lo, hi = axis[0], axis[-1]
        frames[tag] = (mod.make_rgb_movie(cube, str(tmp_path / f"{tag}r"),
                                          lo, hi)
                       + mod.make_multispecies_rgb(
                           cube, cube, cube, str(tmp_path / f"{tag}m"),
                           lo, hi))
    assert len(frames["t"]) == len(frames["j"]) == 4 + 6
    for a, b in zip(frames["t"], frames["j"]):
        np.testing.assert_array_equal(_png_pixels(a), _png_pixels(b))
    assert runs[0][runs[0].index("-start_number") + 1] == "1"
    with pytest.raises(OSError, match="not found"):
        real_check("no-such-ffmpeg-binary")


def test_port_imports_no_optional_package():
    """Importing every port module loads none of the viewers' optional
    packages, so the port starts where they are missing."""
    code = ("import sys, spectral_cube_tpu_torch, "
            "spectral_cube_tpu_torch.region, "
            "spectral_cube_tpu_torch.wcs_utils, "
            "spectral_cube_tpu_torch.visualization_tools, "
            "spectral_cube_tpu_torch.ytcube, "
            "spectral_cube_tpu_torch.io.casa_image, "
            "spectral_cube_tpu_torch.io.casa_masks, "
            "spectral_cube_tpu_torch.io.class_lmv; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'yt', 'glue', 'pvextractor', 'ds9', 'pyds9', "
            "'astroquery')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=str(REPO), check=True,
                   timeout=120)
