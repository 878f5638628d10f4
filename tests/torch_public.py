"""What the public-surface tables (``tests/test_torch_public_*.py``) share.

Each table file holds a part of the port's public API (``MODULES``: the
cube, masks, lower-dimensional results, Stokes cubes, beams, the cube
utilities, the analysis utilities, regions, I/O and ``ShardedCube``) and
maps each public member that :func:`test_torch_api_parity._surface` finds
in the JAX package's module to a call (``CALLS``) or to the reason it is
not called (``NOT_CALLED``).  The same call runs three ways:

- on the CPU, through the JAX package and through the port
  (``device="cpu"``), the two results held against each other by
  :func:`hold`: the result's class (cube, ``Projection``, ``Slice``,
  ``OneDSpectrum``, ``Quantity``, array, scalar, tuple, dict, ...), its
  unit and shape, the NaN pattern exactly and the values within the
  entry's tolerance; a member that raises in the JAX package raises the
  same exception class in the port;
- on the card (``cuda``, skipped without one), outside any guard: the
  port on a card input against the port on the same input on the CPU,
  every array leaf of the result read by ``np.asarray``, as numpy reads
  the JAX package's arrays on any device.  A member that hands out a
  device tensor by design is in ``DEVICE_RESULTS`` with its reason, and
  must still hand one out.

The table files import JAX only inside their CPU cases, so that the card's
machine, which has no JAX, runs their ``cuda`` cases
(``chip_smoke.py``'s batteries phase, ``-m cuda``).
"""

import ast
import atexit
import contextlib
import functools
import importlib
import importlib.util
import math
import numbers
import os
import shutil
import tempfile
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_api_parity import JAX_ROOT, _surface
from test_torch_fixtures_ref import base_header, make_beams_table, use_device
from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits

TESTS = Path(__file__).resolve().parent

#: the port's public-result layer, each module claimed by one table file
LAYER = ("cube.py", "masks.py", "lower_dimensional_structures.py",
         "stokes.py", "beams.py", "cube_utils.py", "analysis_utilities.py",
         "region.py", "parallel/sharded.py") + tuple(sorted(
             str(p.relative_to(JAX_ROOT)).replace(os.sep, "/")
             for p in (JAX_ROOT / "io").glob("*.py")))

#: the JAX modules outside the layer, each with the port test that holds
#: its public names against the JAX package
OUTSIDE = {
    "__init__.py": "re-exports of the layer's names and of units.py",
    "units.py": "tests/test_torch_beams_units.py",
    "utils.py": "tests/test_torch_numpy_interop.py",
    "convolution.py": "tests/test_torch_convolve.py",
    "persistence.py": "tests/test_torch_cube_utils.py",
    "pipeline.py": "tests/test_torch_pipeline.py",
    "profiling.py": "tests/test_torch_profiling.py",
    "visualization_tools.py": "tests/test_torch_exporters.py",
    "ytcube.py": "tests/test_torch_exporters.py",
    "wcs_utils.py": "tests/test_torch_wcs_utils.py",
    "parallel/__init__.py": "tests/test_torch_parallel.py",
    "parallel/mesh.py": "tests/test_torch_parallel.py",
    "ops/__init__.py": "tests/test_torch_ops_battery.py",
    "ops/banded_pallas.py": "tests/test_torch_api_parity.py",
    "ops/clip_pallas.py": "tests/test_torch_api_parity.py",
    "ops/convolve.py": "tests/test_torch_convolve.py",
    "ops/df32.py": "tests/test_torch_moments.py",
    "ops/interpolate.py": "tests/test_torch_interpolate.py",
    "ops/moments.py": "tests/test_torch_moments.py",
    "ops/pipeline_fused.py": "tests/test_torch_pipeline_fused.py",
    "ops/reductions.py": "tests/test_torch_card_scale_reductions.py",
    "ops/regrid.py": "tests/test_torch_regrid.py",
    "ops/smoothing.py": "tests/test_torch_smoothing.py",
    "wcs/__init__.py": "tests/test_torch_wcs_battery.py",
    "wcs/core.py": "tests/test_torch_wcs_battery.py",
    "wcs/projections.py": "tests/test_torch_wcs_golden.py",
    "wcs/spectral.py": "tests/test_torch_wcs_battery.py",
}

#: the default tolerance, relative to the largest magnitude of the result
RTOL = 1e-5

SHAPE = (6, 8, 12)
THRESHOLD = 0.3
#: a circle on the cube's centre, in a DS9 and in a CRTF region string
DS9 = 'fk5; circle(23.1837, 30.5765, 7")'
CRTF = "circle[[23.1837deg, 30.5765deg], 7arcsec]"


# -- the table's entries ----------------------------------------------------

class Call:
    """One call of the table: ``fn(obj, k)`` on the input ``inp`` (None
    for a call of a module function or a class), ``k`` the :class:`Ctx`
    of the package that runs it.  ``tol`` is relative to the largest
    magnitude of each array; ``cpu_only`` names why the card's machine
    cannot run the call (its case runs on the CPU only)."""

    def __init__(self, inp, fn, tol=RTOL, cpu_only=None):
        self.inp, self.fn, self.tol, self.cpu_only = inp, fn, tol, cpu_only


def C(inp, fn, tol=RTOL, cpu_only=None):
    return Call(inp, fn, tol, cpu_only)


#: a reason a member is not called: the package it needs is absent
class Needs:
    def __init__(self, package, why):
        self.package, self.why = package, why

    def holds(self):
        return importlib.util.find_spec(self.package) is None

    def __repr__(self):
        return f"needs {self.package}, absent here: {self.why}"


#: a reason a member is not called: the two packages' forms take
#: different arguments by design (the parameter names differ)
class Signature:
    def __init__(self, rel, name, why):
        self.rel, self.name, self.why = rel, name, why

    def holds(self):
        import inspect
        forms = [getattr(importlib.import_module(f"{pkg}.{self.rel}"),
                         self.name)
                 for pkg in ("spectral_cube_tpu", "spectral_cube_tpu_torch")]
        names = [list(inspect.signature(f).parameters) for f in forms]
        return names[0] != names[1]

    def __repr__(self):
        return f"{self.rel}.{self.name} differs by design: {self.why}"


# -- the inputs, from a seed, the same file for both packages ----------------

def _write_cube(path, nchan, ny, nx, seed, beams=False):
    rng = np.random.RandomState(seed)
    data = (rng.rand(nchan, ny, nx) * 2 - 0.5).astype(np.float32)
    data[1, 2, 3] = np.nan
    data[:, 0, 0] = np.nan
    data[4, 5, :] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan, beam=not beams)
    h["BITPIX"] = -32
    h["CRPIX1"], h["CRPIX2"] = nx / 2, ny / 2
    hdus = [HDU(data=data, header=h)]
    if beams:
        h["CASAMBM"] = True
        hdus.append(make_beams_table(
            nchan, np.linspace(2.5, 3.5, nchan)))
    else:
        h["BMAJ"] = h["BMIN"] = 3.0 / 3600
    write_fits(path, hdus)


def _write_stokes(path, seed):
    rng = np.random.RandomState(seed)
    nchan, ny, nx = SHAPE
    data = (rng.rand(4, nchan, ny, nx) * 2 - 0.5).astype(np.float32)
    data[:, 2, 3, 4] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan)
    h["BITPIX"] = -32
    h["NAXIS"] = 4
    h["NAXIS4"] = 4
    h["CTYPE4"] = "STOKES"
    h["CRVAL4"] = 1.0
    h["CDELT4"] = 1.0
    h["CRPIX4"] = 1.0
    h["CUNIT4"] = ""
    h["BMAJ"] = h["BMIN"] = 3.0 / 3600
    write_fits(path, [HDU(data=data, header=h)])


def _scratch():
    """A directory removed when the process ends."""
    d = tempfile.mkdtemp(prefix="sct_public_")
    atexit.register(shutil.rmtree, d, True)
    return d


@functools.lru_cache(maxsize=None)
def files():
    """The input files, written once a process."""
    d = _scratch()
    out = {"dir": d, "cube": os.path.join(d, "cube.fits"),
           "vrsc": os.path.join(d, "vrsc.fits"),
           "stokes": os.path.join(d, "stokes.fits")}
    _write_cube(out["cube"], *SHAPE, seed=26)
    _write_cube(out["vrsc"], *SHAPE, seed=27, beams=True)
    _write_stokes(out["stokes"], seed=28)
    return out


class Ctx:
    """The package ``P`` (``spectral_cube_tpu`` or the port) a call runs
    in, on ``dev`` (the port's device; None for the JAX package), with
    the table's inputs made in that package and a scratch directory."""

    def __init__(self, P, dev):
        self.P, self.dev = P, dev
        self.jax = dev is None
        self._inputs = {}
        self.tmp = _scratch()

    @property
    def devkw(self):
        return {} if self.jax else {"device": self.dev}

    def m(self, rel):
        """The package's module ``rel`` (``"io.fits_low"``)."""
        return importlib.import_module(f"{self.P.__name__}.{rel}")

    def path(self, name):
        return files()[name]

    def out(self, name):
        """A fresh path in the scratch directory: ``name`` in a directory
        of its own, so no call sees another's file."""
        return os.path.join(tempfile.mkdtemp(dir=self.tmp), name)

    def q(self, value, unit):
        return self.P.Quantity(value, unit)

    def u(self, unit):
        return self.m("units").Unit(unit)

    def read(self, name, **kwargs):
        return self.P.SpectralCube.read(self.path(name), **kwargs,
                                        **self.devkw)

    def inp(self, name):
        if name not in self._inputs:
            self._inputs[name] = INPUTS[name](self)
        return self._inputs[name]

    def mesh(self):
        if self.jax:
            return self.m("parallel").CubeMesh()
        return self.m("parallel").CubeMesh(devices=[self.dev] * 8,
                                           shape=(2, 4))


def shifted_header(x):
    """``x``'s header with its reference pixel moved by (0.37, -0.61)
    pixels: a reprojection target on the same grid, shifted."""
    h = x.header.copy()
    h["CRPIX1"] += 0.37
    h["CRPIX2"] -= 0.61
    return h


def _masked(k, cube):
    return cube.with_mask(cube > k.q(THRESHOLD, cube.unit))


def _loose(cube):
    """A varying-resolution cube whose beams (2.5" to 3.5") are taken as
    one beam by the reductions along the spectral axis."""
    cube.beam_threshold = 0.5
    return cube


INPUTS = {
    "cube": lambda k: _masked(k, k.read("cube")),
    "plain": lambda k: k.read("cube"),
    "vrsc": lambda k: _loose(_masked(k, k.read("vrsc"))),
    "stokes": lambda k: k.m("stokes").StokesSpectralCube.read(
        k.path("stokes"), **k.devkw),
    "proj": lambda k: k.inp("cube").moment0(),
    "slice": lambda k: k.inp("cube")[2],
    "spectrum": lambda k: k.inp("cube")[:, 3, 4],
    "vrspectrum": lambda k: k.inp("vrsc")[:, 3, 4],
    "mask": lambda k: k.inp("cube").mask,
    "boolmask": lambda k: k.m("masks").BooleanArrayMask(
        np.asarray(k.inp("plain").filled_data[:].value) > THRESHOLD,
        k.inp("plain").wcs),
    "sharded": lambda k: k.m("parallel").ShardedCube(k.inp("cube"),
                                                    k.mesh()),
    "beam": lambda k: k.m("beams").Beam(3 * k.u("arcsec")),
    "beams": lambda k: k.inp("vrsc").beams,
    "header": lambda k: k.inp("cube").header,
    "wcs": lambda k: k.inp("cube").wcs,
}


@functools.lru_cache(maxsize=None)
def jax_ctx():
    import spectral_cube_tpu as J
    return Ctx(J, None)


@functools.lru_cache(maxsize=None)
def port_ctx(device):
    import spectral_cube_tpu_torch as T
    return Ctx(T, torch.device(device))


# -- what a result is, and holding two against each other --------------------

def _is_array(x):
    """An array: numpy's, a tensor, a JAX array, or the port's
    ``ShardedArray`` (a sharded JAX array's counterpart, which numpy
    reads through its host gather)."""
    return isinstance(x, (np.ndarray, torch.Tensor)) or \
        type(x).__name__ == "ShardedArray" or \
        type(x).__module__.split(".")[0] in ("jax", "jaxlib")


def _is_cube(x):
    names = {c.__name__ for c in type(x).__mro__}
    return bool(names & {"BaseSpectralCube", "ShardedCube"})


def kind(x):
    """The class of a result, the two packages' classes by name."""
    if x is None:
        return "None"
    if isinstance(x, (bool, numbers.Number, np.generic)):
        return "scalar"
    if isinstance(x, (str, bytes)):
        return type(x).__name__
    if isinstance(x, (tuple, list, dict)):
        return "dict" if isinstance(x, dict) else type(x).__name__
    if _is_array(x):
        return "scalar" if len(x.shape) == 0 else "array"
    return type(x).__name__


def host(x):
    """``np.asarray`` of an array result, outside any guard: raises for a
    tensor numpy cannot read (one on the card)."""
    return np.asarray(x)


def _near(path, got, want, tol):
    got, want = host(got), host(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    kinds = {got.dtype.kind, want.dtype.kind}
    if kinds <= {"i", "u"}:
        kinds = {"i"}
    assert len(kinds) == 1 or kinds <= {"f", "c"}, \
        (path, got.dtype, want.dtype)
    if want.dtype.kind in "fc":
        gn, wn = np.isnan(got), np.isnan(want)
        assert np.array_equal(gn, wn), \
            (path, "NaN pattern", int((gn != wn).sum()))
        if (~wn).any():
            scale = float(np.max(np.abs(want[~wn])))
            np.testing.assert_allclose(got[~wn], want[~wn], rtol=tol,
                                       atol=tol * scale, err_msg=path)
    else:
        assert np.array_equal(got, want), path


def _unit(x):
    return str(getattr(x, "unit", ""))


def _cube_value(x):
    return x.filled_data[:].value


def _beam_values(b):
    return [float(np.asarray(getattr(b, a).to_value("deg")
                             if hasattr(getattr(b, a), "to_value")
                             else getattr(b, a))) for a in
            ("major", "minor", "pa")]


def hold(got, want, tol=RTOL, path="result"):
    """``got`` (the port's) against ``want``: class, unit, shape, NaN
    pattern, values within ``tol`` of the largest magnitude."""
    kg, kw = kind(got), kind(want)
    assert kg == kw, (path, "class", kg, kw)
    if kw == "None":
        return
    if kw in ("str", "bytes"):
        assert got == want, (path, got, want)
        return
    if kw == "scalar":
        g, w = host(got), host(want)
        if w.dtype.kind in "fc" and math.isnan(float(np.real(w))):
            assert math.isnan(float(np.real(g))), (path, g, w)
            return
        _near(path, g, w, tol)
        return
    if kw == "array":
        _near(path, got, want, tol)
        return
    if kw in ("tuple", "list"):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            hold(g, w, tol, f"{path}[{i}]")
        return
    if kw == "dict":
        assert sorted(map(str, got)) == sorted(map(str, want)), \
            (path, list(got), list(want))
        for key in want:
            gk = next(a for a in got if str(a) == str(key))
            hold(got[gk], want[key], tol, f"{path}[{key!r}]")
        return
    if _is_cube(want):
        assert _unit(got) == _unit(want), (path, _unit(got), _unit(want))
        assert tuple(got.shape) == tuple(want.shape), (path, got.shape)
        _near(path + ".filled_data", _cube_value(got), _cube_value(want),
              tol)
        return
    if kw == "StokesSpectralCube":
        assert list(got.components) == list(want.components), path
        for c in want.components:
            hold(got._stokes_data[c], want._stokes_data[c], tol,
                 f"{path}[{c}]")
        return
    if hasattr(want, "unit") and hasattr(want, "value") and \
            not hasattr(want, "major"):
        assert _unit(got) == _unit(want), (path, _unit(got), _unit(want))
        _near(path + ".value", got.value, want.value, tol)
        return
    if kw == "Beam":
        np.testing.assert_allclose(_beam_values(got), _beam_values(want),
                                   rtol=tol, err_msg=path)
        return
    if kw == "Beams":
        for a in ("major", "minor", "pa"):
            hold(getattr(got, a), getattr(want, a), tol, f"{path}.{a}")
        return
    if kw == "WCS":
        hold(_header_dict(got.to_header()), _header_dict(want.to_header()),
             tol, path + ".to_header()")
        return
    if kw == "Header":
        hold(_header_dict(got), _header_dict(want), tol, path)
        return
    if kw in ("HDU", "BinTableHDU"):
        hold(_header_dict(got.header), _header_dict(want.header), tol,
             path + ".header")
        if kw == "HDU" and want.data is not None:
            _near(path + ".data", got.data, want.data, tol)
        return
    if "MaskBase" in {c.__name__ for c in type(want).__mro__}:
        try:
            w = want.include()
        except Exception:
            return
        _near(path + ".include()", got.include(), w, tol)
    # another object: its class is what the two share


def _header_dict(h):
    return OrderedDict((k, v) for k, v in h.items()
                       if k not in ("COMMENT", "HISTORY", ""))


# -- the three cases ----------------------------------------------------------

def _run(call, k):
    with on_device(k.dev):
        obj = k.inp(call.inp) if call.inp else None
        return call.fn(obj, k)


@contextlib.contextmanager
def on_device(dev):
    """The port's default device pointed at ``dev`` (the CPU, or the card
    as it is by default) inside the block, as a user's call on that
    device sees it; nothing for the JAX package (``dev`` None)."""
    if dev is None or dev.type != "cpu":
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        use_device("cpu", mp)
        yield


def _outcome(call, k):
    try:
        return _run(call, k), None
    except Exception as e:  # noqa: BLE001 -- the class is what is held
        return None, e


def hold_against_jax(call, key, port_answers):
    """The CPU case: the port on the CPU against the JAX package.  A member
    of ``port_answers`` answers by design where the JAX package raises:
    the JAX call must still raise and the port's must not."""
    want, jerr = _outcome(call, jax_ctx())
    got, terr = _outcome(call, port_ctx("cpu"))
    if key in port_answers:
        assert jerr is not None, (key, "listed in PORT_ANSWERS but the JAX "
                                       "package answers")
        assert terr is None, repr(terr)
        return
    if jerr is not None or terr is not None:
        assert jerr is not None and terr is not None and \
            type(terr).__name__ == type(jerr).__name__, \
            ("raised", repr(terr), repr(jerr))
        return
    hold(got, want, call.tol)


def device_leaves(x, path="result"):
    """The paths of the tensors in ``x`` that lie on a device numpy cannot
    read."""
    if isinstance(x, torch.Tensor):
        return [path] if x.device.type != "cpu" else []
    if isinstance(x, (tuple, list)):
        return [p for i, v in enumerate(x)
                for p in device_leaves(v, f"{path}[{i}]")]
    if isinstance(x, dict):
        return [p for a, v in x.items()
                for p in device_leaves(v, f"{path}[{a!r}]")]
    if hasattr(x, "value") and hasattr(x, "unit") and not _is_cube(x):
        return device_leaves(x.value, path + ".value")
    return []


def hold_on_card(call, device_results, name):
    """The ``cuda`` case: the port on the card against the port on the
    CPU, each array leaf read by numpy outside any guard."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    want, werr = _outcome(call, port_ctx("cpu"))
    got, gerr = _outcome(call, port_ctx("cuda"))
    if werr is not None or gerr is not None:
        assert werr is not None and gerr is not None and \
            type(gerr).__name__ == type(werr).__name__, \
            ("raised", repr(gerr), repr(werr))
        return
    on_card = device_leaves(got)
    if name in device_results:
        assert on_card, (name, "listed in DEVICE_RESULTS but hands out "
                               "no device tensor")
        got = _to_host(got)
    else:
        assert not on_card, (name, "hands numpy a device tensor", on_card)
    hold(got, want, call.tol)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return tuple(map(_to_host, x))
    if isinstance(x, list):
        return list(map(_to_host, x))
    return x


# -- the table stays whole ---------------------------------------------------

def members(spec, claimed=()):
    """``(rel, name)`` of each public member of the JAX module ``rel``:
    module names, and ``Class.member`` for each class's members.  A
    ``spec`` of ``"rel::Class"`` is that class's members alone; a plain
    ``rel`` leaves out the classes ``claimed`` (``"rel::Class"`` specs of
    other tables)."""
    rel, _, only = spec.partition("::")
    names, classes = _surface(JAX_ROOT / rel)
    if only:
        return {(rel, f"{only}.{m}") for m in classes[only]}
    skip = {c.partition("::")[2] for c in claimed
            if c.partition("::")[0] == rel and "::" in c}
    out = {(rel, n) for n in names}
    out |= {(rel, f"{c}.{m}") for c, ms in classes.items() if c not in skip
            for m in ms}
    return out


def table_modules():
    """{table file: its MODULES}, read from each file's text."""
    out = {}
    for p in sorted(TESTS.glob("test_torch_public_*.py")):
        for node in ast.parse(p.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "MODULES"
                    for t in node.targets):
                out[p.name] = ast.literal_eval(node.value)
    return out


def check_whole(modules, calls, not_called, device_results, port_answers):
    """Every JAX member of ``modules`` is in ``calls`` or ``not_called``
    (never both), each reason still holds, and each device result and
    each member the port answers by design is a call with its reason."""
    claimed = [m for ms in table_modules().values() for m in ms]
    want = set().union(*(members(m, claimed) for m in modules))
    listed = set(calls) | set(not_called)
    assert not want - listed, ("in neither CALLS nor NOT_CALLED",
                               sorted(want - listed))
    assert not set(calls) & set(not_called), sorted(set(calls) &
                                                    set(not_called))
    assert not set(not_called) - want, ("NOT_CALLED names no JAX member",
                                        sorted(set(not_called) - want))
    for key, reason in not_called.items():
        assert reason.holds(), (key, "has become callable", reason)
    for extra in (device_results, port_answers):
        assert set(extra) <= set(calls), sorted(set(extra) - set(calls))
        for key, reason in extra.items():
            assert isinstance(reason, str) and reason, key


def check_layer_claimed():
    """Each module of the layer is claimed by one table file, and every JAX
    module is in the layer or in OUTSIDE, whose test files exist."""
    claimed = [m for ms in table_modules().values() for m in ms]
    plain = [m for m in claimed if "::" not in m]
    assert sorted(plain) == sorted(LAYER), (sorted(plain), LAYER)
    assert {m.partition("::")[0] for m in claimed} <= set(LAYER)
    every = {str(p.relative_to(JAX_ROOT)).replace(os.sep, "/")
             for p in JAX_ROOT.rglob("*.py")}
    assert every == set(LAYER) | set(OUTSIDE), \
        sorted(every ^ (set(LAYER) | set(OUTSIDE)))
    for rel, where in OUTSIDE.items():
        if where.startswith("tests/"):
            assert (TESTS.parent / where).exists(), (rel, where)


def ids(calls):
    return [f"{rel}::{name}" for rel, name in calls]


def define_tests(ns):
    """The three tests of a table file, defined in its namespace ``ns``
    from its ``MODULES``, ``CALLS``, ``NOT_CALLED``, ``DEVICE_RESULTS`` and
    ``PORT_ANSWERS``: the table is whole; each call against the JAX
    package on the CPU; each call the card's machine can run on the card
    (``cuda``)."""
    calls = ns["CALLS"]
    card = [k for k, c in calls.items() if c.cpu_only is None]

    def test_table_is_whole():
        check_whole(ns["MODULES"], calls, ns["NOT_CALLED"],
                    ns["DEVICE_RESULTS"], ns["PORT_ANSWERS"])
        check_layer_claimed()

    @pytest.mark.parametrize("key", list(calls), ids=ids(calls))
    def test_member_matches_jax(key):
        hold_against_jax(calls[key], key, ns["PORT_ANSWERS"])

    @pytest.mark.cuda
    @pytest.mark.parametrize("key", card, ids=ids(card))
    def test_member_on_card_gives_numpy_a_host_array(key):
        hold_on_card(calls[key], ns["DEVICE_RESULTS"], key)

    for fn in (test_table_is_whole, test_member_matches_jax,
               test_member_on_card_gives_numpy_a_host_array):
        fn.__module__ = ns["__name__"]
        ns[fn.__name__] = fn


