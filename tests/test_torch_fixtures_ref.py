"""What the port's test batteries share, free of JAX.

The batteries (``tests/test_torch_*_battery.py``, ``test_torch_docs.py``,
``test_torch_fuzz_chains.py``, ``test_torch_beams_units.py``: each file
that assigns ``JAX_FILES``) run the JAX package's test files through the
port, on the CPU and on the card, where JAX is absent, as do the fault
pins (``test_torch_numpy_interop.py``, ``test_torch_sharded_store.py``).
So
this module rebuilds ``tests/conftest.py``'s synthetic FITS factory and
``tests/ref_fixtures.py``'s byte-faithful reference fixtures with
``spectral_cube_tpu_torch.io.fits_low``; the tests at the end hold every
file byte for byte equal to the JAX fixtures' on the CPU.

It also holds the pieces each battery file wires into its own fixtures:

- :func:`numpy_guard` makes ``np.asarray(tensor)`` raise, on any device,
  when a port module is among its callers, with the error the card raises
  for a tensor it holds: in the port, or in a function of the caller's
  that the port calls back (a mask's function, say).  The port converts a
  tensor to numpy only explicitly (``.cpu().numpy()``).  Test code (and a
  docs block run by a test) converts freely, the tensor copied to the
  host first, as a JAX array is.
- :func:`use_device` runs a case on ``"cpu"`` (the port's default device
  pointed at the CPU) or ``"cuda"`` (skipped without a card), and
  :func:`use_mesh` points the port's default ``CubeMesh()`` at 8
  positions of that device: the 2x4 grid of the JAX tests' 8 virtual CPU
  devices.

:func:`carry_over` defines a JAX file's tests in a battery from the file's
text.  A JAX test is left out of a battery (``NOT_CARRIED``) only for one
of ``REASONS``, each entry naming the port test that holds the same
behaviour against the JAX package (:func:`left_out`); whole JAX files
that no battery carries are in ``WHOLE_FILES``, and
:func:`test_every_jax_test_file_is_carried_or_listed` holds every JAX test
file to one or the other.
"""

import ast
import contextlib
import functools
import os
import re
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

import spectral_cube_tpu_torch
from spectral_cube_tpu_torch import cube as _cube
from spectral_cube_tpu_torch.io.fits_low import (BinTableHDU, HDU, Header,
                                                 write_fits)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
PORT = os.path.dirname(os.path.abspath(spectral_cube_tpu_torch.__file__)) \
    + os.sep

#: the ``device`` fixture's parameters: every battery case runs on both
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]

_DEFAULT_DEVICE = _cube.default_device


def parametrize_devices(metafunc, cpu_only=()):
    """A battery test's ``device`` parameters: both devices, or the CPU
    alone for a test named in ``cpu_only``."""
    if "device" in metafunc.fixturenames:
        metafunc.parametrize(
            "device", ["cpu"] if metafunc.function.__name__ in cpu_only
            else DEVICES, indirect=True)


def use_device(name, monkeypatch):
    """Point the port's default device at ``name`` for one case."""
    if name == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                        "False")
        return torch.device("cuda")
    cpu = torch.device("cpu")
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("spectral_cube_tpu_torch") \
                and getattr(mod, "default_device", None) is _DEFAULT_DEVICE:
            monkeypatch.setattr(mod, "default_device", lambda: cpu)
    return cpu


def use_mesh(device, monkeypatch):
    """Point the port's default ``CubeMesh()`` (and ``default_mesh()``)
    at 8 positions of ``device`` for one case: ``['cpu'] * 8`` on the
    CPU, ``['cuda:0'] * 8`` on the card, a 2x4 grid (the port allows one
    device more than once).  The default mesh is made anew in the case and
    dropped after it."""
    from spectral_cube_tpu_torch.parallel import mesh
    make_mesh = mesh.make_mesh
    positions = [torch.device(device)] * 8

    def case_mesh(devices=None, shape=None, **kwargs):
        return make_mesh(positions if devices is None else devices, shape,
                         **kwargs)

    monkeypatch.setattr(mesh, "make_mesh", case_mesh)
    monkeypatch.setattr(mesh, "_DEFAULT_MESH", None)


def _port_on_stack(frame):
    """True when a port module is among the callers: the port itself, or a
    function of the caller's that the port calls back."""
    while frame is not None:
        if frame.f_code.co_filename.startswith(PORT):
            return True
        frame = frame.f_back
    return False


@contextlib.contextmanager
def numpy_guard():
    """``torch.Tensor.__array__`` raising for the port, as on the card."""
    original = torch.Tensor.__array__

    def __array__(self, *args, **kwargs):
        if _port_on_stack(sys._getframe(1)):
            raise TypeError(
                f"can't convert {self.device} device type tensor to numpy. "
                "Use Tensor.cpu() to copy the tensor to host memory first.")
        return original(self.cpu(), *args, **kwargs)

    torch.Tensor.__array__ = __array__
    try:
        yield
    finally:
        torch.Tensor.__array__ = original


def jax_test_names(path):
    """The test functions a JAX test file defines (read, not imported)."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}


#: (pattern, replacement) turning a JAX test file's text into the port's:
#: the package renamed, this module in place of the JAX fixture modules
#: (``conftest.py`` and ``ref_fixtures.py`` import JAX), and no top-level
#: ``import jax`` (the tests that use JAX are not carried over)
PORT_RENAMES = [
    (r"\bspectral_cube_tpu\b", "spectral_cube_tpu_torch"),
    (r"\bfrom (conftest|ref_fixtures) import\b",
     "from test_torch_fixtures_ref import"),
    (r"^import jax\b.*$", ""),
]


def _is_pallas_name(name):
    """A Pallas function of the JAX package (``moments_012_pallas``,
    ``_moments_pallas_chunked``, ``statistics_pallas``): the port has
    its Hopper kernel under another name."""
    return "pallas" in name


@functools.lru_cache(maxsize=None)
def _carrier(module):
    """The battery that carries the JAX test file ``module`` (its module
    name), or None."""
    for name in _battery_files():
        with open(os.path.join(REPO, "tests", name + ".py")) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "JAX_FILES"
                    for t in node.targets) and \
                    f"tests/{module}.py" in ast.literal_eval(node.value):
                return name
    return None


def _port_imports(tree, carried):
    """A JAX test file's imports, made the port's.  At the top level a
    Pallas name is dropped from a ``from ... import`` (the tests that call
    it are not carried over), and an import from a JAX test file already
    carried into the same battery (``from test_wcs_golden import ...``)
    is dropped, its names being defined there; anywhere, an import from a
    JAX test file that another battery carries (``from test_ref_values
    import ...``) takes the names from that battery."""
    body = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            if node.module in carried:
                continue
            node.names = [a for a in node.names
                          if not _is_pallas_name(a.name)]
            if not node.names:
                continue
        body.append(node)
    tree.body = body
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                (node.module or "").startswith("test_") and \
                not node.module.startswith("test_torch_"):
            node.module = _carrier(node.module) or node.module
    return tree


def carry_over(jax_files, namespace, not_carried, only=None):
    """Define the tests of ``jax_files`` in ``namespace`` (a battery file's
    globals) from the JAX files' text, read unchanged and renamed for the
    port (``PORT_RENAMES``, :func:`_port_imports`), so a JAX test's
    scenario, expected values and tolerances are the port's too.  Each
    file is compiled under its own name, with its asserts rewritten as
    pytest rewrites a test module's; the tests of ``not_carried`` are then
    taken out, and of a file that ``only`` maps to names (a JAX file
    whose tests two batteries share), all tests but those."""
    from _pytest.assertion.rewrite import rewrite_asserts
    doc = namespace.get("__doc__")
    carried = set()
    for path in jax_files:
        full = os.path.join(REPO, path)
        with open(full) as f:
            text = f.read()
        for pattern, repl in PORT_RENAMES:
            text = re.sub(pattern, repl, text, flags=re.MULTILINE)
        tree = _port_imports(ast.parse(text, full), carried)
        rewrite_asserts(tree, text.encode(), full)
        exec(compile(tree, full, "exec"), namespace)
        carried.add(os.path.basename(path)[:-3])
        if only and path in only:
            for name in jax_test_names(path) - set(only[path]):
                namespace.pop(name, None)
    for name in not_carried:
        namespace.pop(name, None)
    namespace["__doc__"] = doc


#: the tests of ``tests/test_aux.py`` that build the default mesh: the mesh
#: battery carries them, the beam and unit battery the rest of the file
AUX_MESH_TESTS = ("test_streaming_sharded_loader",
                  "test_streaming_matches_eager",
                  "test_to_sharded_facade",
                  "test_use_dask_shards_over_devices",
                  "test_sharded_checkpoint_restore",
                  "test_streaming_spectral_layout_native_decode",
                  "test_sharded_display",
                  "test_replicated_layout_saves_each_shard_once")


# -- why a JAX test or file is not carried over -----------------------------

#: its body calls ``jax`` or ``jnp`` (or reads how JAX shards an array),
#: which the card's machine does not have
JNP = "calls jax or jnp in its body"
#: it calls a Pallas function, a TPU kernel the port replaces by a Hopper
#: kernel under its own name
PALLAS = "calls a Pallas function"
#: it reads a name private to the JAX package, to its TPU routes or to
#: JAX's arrays, which the port drops by design: ``_device_data``,
#: ``_filled(xp=)``, ``_use_matmul_*``, ``_MOMENTS_JIT_CACHE``,
#: ``_dft_mats``, ``_kernel_transfer``, ``_block_banded_conv``'s block
#: argument, ``clip_pallas``, the ``max_plane`` / DFT gates
#: (``_MATMUL_CONV_MAX_N``), a JAX array's ``.sharding``, a shard's
#: ``device`` as its mesh position (JAX places one position on a device;
#: the port's mesh may repeat a device and names the position
#: ``Shard.position``), XLA's compilation cache
JAX_PRIVATE = "reads a JAX-private or TPU-only name"
#: it reads a file of the reference library that the repository does not
#: hold; the JAX test skips without it too
REF_FILE = "needs a reference-library file the repository lacks"
#: the only reasons a JAX test or file may be left out of the batteries
REASONS = (JNP, PALLAS, JAX_PRIVATE, REF_FILE)

_HELD_BY = re.compile(r"; held against the JAX package by "
                      r"(tests/test_torch_\w+\.py)(?:::(\w+))?$")


def left_out(reason, held_by):
    """A ``NOT_CARRIED`` / ``WHOLE_FILES`` entry: one of ``REASONS`` and
    the port test that holds the same behaviour against the JAX package,
    ``tests/test_torch_<name>.py`` or ``...py::test_<name>``."""
    assert reason in REASONS, reason
    entry = f"{reason}; held against the JAX package by {held_by}"
    assert _HELD_BY.search(entry), held_by
    return entry


def _references(jax_files):
    """Test name -> the names its body reads, with those of the
    module-level helpers (functions but fixtures) it calls, transitively
    (read, not imported)."""
    out = {}
    for path in jax_files:
        with open(os.path.join(REPO, path)) as f:
            tree = ast.parse(f.read())
        funcs = {n.name: n for n in tree.body
                 if isinstance(n, ast.FunctionDef)
                 and not (n.decorator_list and not n.name.startswith("test_"))}

        def names(node):
            found = set()
            for x in ast.walk(node):
                if isinstance(x, ast.Name):
                    found.add(x.id)
                elif isinstance(x, ast.Attribute):
                    found.add(x.attr)
                elif isinstance(x, (ast.Import, ast.ImportFrom)):
                    found.update(a.name for a in x.names)
                    found.update((getattr(x, "module", None) or "")
                                 .split("."))
            return found

        for name, node in funcs.items():
            if not name.startswith("test_"):
                continue
            seen, todo = set(), [node]
            while todo:
                got = names(todo.pop())
                for callee in got & set(funcs) - seen:
                    seen.add(callee)
                    todo.append(funcs[callee])
                seen |= got
            out[name] = seen
    return out


def _reason_holds(reason, refs):
    """A JAX test's body (``refs``: :func:`_references`) still does what
    its ``JNP`` or ``PALLAS`` reason says; the other reasons are taken as
    written."""
    if reason == JNP:
        return bool(refs & {"jax", "jnp"})
    if reason == PALLAS:
        return any("pallas" in n for n in refs)
    return True


def check_left_out(entry):
    """An entry of :func:`left_out`: a reason of ``REASONS`` and a port
    test that exists (the file, and the test function where named)."""
    assert entry.split("; ")[0] in REASONS, entry
    held = _HELD_BY.search(entry)
    assert held, entry
    path, test = held.groups()
    assert os.path.exists(os.path.join(REPO, path)), entry
    if test:
        with open(os.path.join(REPO, path)) as f:
            names = {n.name for n in ast.walk(ast.parse(f.read()))
                     if isinstance(n, ast.FunctionDef)}
        assert test in names, entry


#: JAX test files no battery carries, each with its reason
WHOLE_FILES = {
    "tests/test_banded_pallas.py": left_out(
        PALLAS, "tests/test_torch_kernels_cuda.py"),
    "tests/test_api_parity.py": left_out(
        REF_FILE, "tests/test_torch_api_parity.py"),
}


def check_carried_over(jax_files, namespace, not_carried, cpu_only=(),
                       only=None, elsewhere=()):
    """Every test of ``jax_files`` (of a file ``only`` maps to names, those
    names; none of ``elsewhere``, which another battery carries) is in
    ``namespace`` (a battery file's globals) or a key of ``not_carried``
    (name -> :func:`left_out` entry), and no key of ``not_carried`` is in
    ``namespace``: the dict cannot go stale.  No two of the files define
    one name (the later would hide the earlier).  Each name of
    ``cpu_only`` (name -> why it does not run on the card) is a test of
    the file."""
    only = only or {}
    per_file = [jax_test_names(f) for f in jax_files]
    assert sum(map(len, per_file)) == len(set().union(*per_file)), \
        "two JAX files define one test name"
    jax = set().union(*(set(only.get(f, names))
                        for f, names in zip(jax_files, per_file)))
    assert set(elsewhere) <= jax, "ELSEWHERE names a test not in the files"
    jax -= set(elsewhere)
    mine = {n for n in namespace if n.startswith("test_")}
    assert not jax - mine - set(not_carried), "dropped without a reason"
    assert not set(not_carried) - jax, "not a test of the JAX files"
    assert not set(not_carried) & mine, "carried over after all"
    assert not set(elsewhere) & mine, "carried here and elsewhere"
    assert set(cpu_only) <= mine, "CPU_ONLY names a test not in the file"
    refs = _references(jax_files)
    for name, entry in dict(not_carried).items():
        check_left_out(entry)
        assert _reason_holds(entry.split("; ")[0], refs[name]), (name, entry)
    calls_jax = {n for n in mine & jax if _reason_holds(JNP, refs[n])}
    assert not calls_jax, f"carried, but call jax or jnp: {sorted(calls_jax)}"
    assert all(isinstance(r, str) and r for r in dict(cpu_only).values())


def _battery_files():
    """The battery files: each ``tests/test_torch_*.py`` that assigns
    ``JAX_FILES`` (read, not imported)."""
    here = os.path.join(REPO, "tests")
    found = []
    for name in sorted(os.listdir(here)):
        if not (name.startswith("test_torch_") and name.endswith(".py")):
            continue
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        if any(isinstance(n, ast.Assign) and any(
                getattr(t, "id", None) == "JAX_FILES" for t in n.targets)
               for n in tree.body):
            found.append(name[:-3])
    return found


def test_every_jax_test_file_is_carried_or_listed():
    """Each JAX test file (``tests/test_*.py`` but ``test_torch_*``) is in
    some battery's ``JAX_FILES`` or in ``WHOLE_FILES`` with its reason, and
    each of its tests is carried by exactly one battery or left out by
    exactly one (``NOT_CARRIED``)."""
    import importlib
    here = os.path.join(REPO, "tests")
    jax_files = {f"tests/{n}" for n in os.listdir(here)
                 if n.startswith("test_") and n.endswith(".py")
                 and not n.startswith("test_torch_")}
    batteries = [importlib.import_module(n) for n in _battery_files()]
    carried = {f for b in batteries for f in b.JAX_FILES}
    assert not carried & set(WHOLE_FILES)
    assert carried | set(WHOLE_FILES) == jax_files
    for entry in WHOLE_FILES.values():
        check_left_out(entry)
    for path in sorted(carried):
        for name in jax_test_names(path):
            holders = [b.__name__ for b in batteries
                       if path in b.JAX_FILES and (
                           name in vars(b) or name in b.NOT_CARRIED)]
            assert len(holders) == 1, (path, name, holders)


# -- tests/conftest.py's synthetic cubes ------------------------------------

def base_header(nx=2, ny=3, nchan=4, ctype3="VRAD", cunit3="km/s",
                crval3=-321.2, cdelt3=1.28, bunit="JY/BEAM", beam=True):
    h = Header()
    h["SIMPLE"] = True
    h["BITPIX"] = -64
    h["NAXIS"] = 3
    h["NAXIS1"] = nx
    h["NAXIS2"] = ny
    h["NAXIS3"] = nchan
    h["CTYPE1"] = "RA---SIN"
    h["CRVAL1"] = 23.1837
    h["CDELT1"] = -5.55555561268e-4
    h["CRPIX1"] = 2.0
    h["CUNIT1"] = "deg"
    h["CTYPE2"] = "DEC--SIN"
    h["CRVAL2"] = 30.5765
    h["CDELT2"] = 5.55555561268e-4
    h["CRPIX2"] = 2.0
    h["CUNIT2"] = "deg"
    h["CTYPE3"] = ctype3
    h["CRVAL3"] = crval3
    h["CDELT3"] = cdelt3
    h["CRPIX3"] = 1.0
    h["CUNIT3"] = cunit3
    h["RESTFRQ"] = 1.42040571841e9
    h["SPECSYS"] = "BARYCENT"
    h["BUNIT"] = bunit
    if beam:
        h["BMAJ"] = 2.77777777e-4
        h["BMIN"] = 2.77777777e-4
        h["BPA"] = 0.0
    return h


def make_cube_file(tmp_path, name="adv.fits", shape=(4, 3, 2), seed=42,
                   with_nan=True, **hdrkw):
    """(nchan, ny, nx) random cube written to FITS; returns path + data."""
    nchan, ny, nx = shape
    rng = np.random.RandomState(seed)
    data = rng.rand(nchan, ny, nx)
    if with_nan:
        data[min(1, nchan - 1), min(1, ny - 1), min(1, nx - 1)] = np.nan
    h = base_header(nx=nx, ny=ny, nchan=nchan, **hdrkw)
    path = str(tmp_path / name)
    write_fits(path, [HDU(data=data, header=h)])
    return path, data


def make_beams_table(n, major_arcsec=None):
    major = np.asarray(major_arcsec if major_arcsec is not None
                       else np.linspace(1.0, 1.5, n), dtype="f4")
    bt = BinTableHDU(columns=OrderedDict(
        BMAJ=major, BMIN=major * 0.8,
        BPA=np.zeros(n, dtype="f4"),
        CHAN=np.arange(n, dtype="i4"),
        POL=np.zeros(n, dtype="i4")), name="BEAMS",
        units={"BMAJ": "arcsec", "BMIN": "arcsec", "BPA": "deg"})
    bt.header["NCHAN"] = n
    bt.header["NPOL"] = 1
    return bt


def make_vr_cube_file(tmp_path, name="vr.fits", shape=(4, 3, 2), seed=7,
                      major_arcsec=None):
    nchan, ny, nx = shape
    rng = np.random.RandomState(seed)
    data = rng.rand(nchan, ny, nx)
    h = base_header(nx=nx, ny=ny, nchan=nchan, beam=False)
    h["CASAMBM"] = True
    path = str(tmp_path / name)
    write_fits(path, [HDU(data=data, header=h),
                      make_beams_table(nchan, major_arcsec)])
    return path, data


@pytest.fixture
def cube_adv(tmp_path, device):
    path, data = make_cube_file(tmp_path)
    return spectral_cube_tpu_torch.SpectralCube.read(path), data


@pytest.fixture
def cube_vr(tmp_path, device):
    path, data = make_vr_cube_file(tmp_path)
    return spectral_cube_tpu_torch.SpectralCube.read(path), data


def gaussian_line_cube(shape=(100, 8, 9), amp=1.0, v0=0.0, sigma=8.0,
                       dv=1.0, noise=0.0, seed=0):
    """Cube of identical Gaussian spectral lines with known moments."""
    nchan, ny, nx = shape
    v = (np.arange(nchan) - nchan / 2) * dv + v0
    spec = amp * np.exp(-0.5 * ((v - v0) / sigma) ** 2)
    data = np.broadcast_to(spec[:, None, None], shape).copy()
    if noise:
        data = data + np.random.RandomState(seed).randn(*shape) * noise
    return data, v


# -- tests/ref_fixtures.py's reference fixtures -----------------------------

def jybeam_header():
    """The fields of the reference's header_jybeam.hdr that matter for
    cube semantics (WCS, beam, units, rest frequency)."""
    h = Header()
    h["SIMPLE"] = True
    h["BITPIX"] = -64
    h["NAXIS"] = 4
    h["NAXIS1"] = 1884
    h["NAXIS2"] = 2606
    h["NAXIS3"] = 200
    h["NAXIS4"] = 1
    h["CDELT1"] = -5.55555561268e-04
    h["CRPIX1"] = 1373.0
    h["CRVAL1"] = 2.31837500515e01
    h["CUNIT1"] = "deg"
    h["CTYPE1"] = "RA---SIN"
    h["CDELT2"] = 5.55555561268e-04
    h["CRPIX2"] = 1152.0
    h["CRVAL2"] = 3.05765277962e01
    h["CUNIT2"] = "deg"
    h["CTYPE2"] = "DEC--SIN"
    h["CDELT3"] = 1.28821496879e00
    h["CRPIX3"] = 1.0
    h["CRVAL3"] = -3.21214698632e02
    h["CTYPE3"] = "VOPT"
    h["CUNIT3"] = "km/s"
    h["CDELT4"] = 1.0
    h["CRPIX4"] = 1.0
    h["CRVAL4"] = 1.0
    h["CTYPE4"] = "STOKES"
    h["CUNIT4"] = ""
    h["SPECSYS"] = "BARYCENT"
    h["RESTFREQ"] = 1.42040571841e09
    h["BUNIT"] = "JY/BEAM"
    h["BMAJ"] = 0.0002777777777777778
    h["BMIN"] = 0.0002777777777777778
    h["BPA"] = 0.0
    return h


def prepare_adv_data():
    """3-D (v, dec, ra) = (4, 3, 2) K cube, seed 96."""
    h = jybeam_header()
    h["BUNIT"] = "K"
    h["NAXIS"] = 3
    h["NAXIS1"] = 2
    h["NAXIS2"] = 3
    h["NAXIS3"] = 4
    for k in [k for k in h.keys() if k.endswith("4")]:
        del h[k]
    np.random.seed(96)
    d = np.random.random((4, 3, 2))
    return d, h


def data_adv(tmp_path, name="adv.fits"):
    d, h = prepare_adv_data()
    path = str(tmp_path / name)
    write_fits(path, [HDU(data=d, header=h)])
    return path, d


def cube_and_raw(tmp_path, name="adv.fits"):
    path, d = data_adv(tmp_path, name)
    return spectral_cube_tpu_torch.SpectralCube.read(path), d


def transpose(d, h, axes):
    """Permute the data and the per-axis header cards together."""
    d = d.transpose(np.argsort(axes))
    h2 = h.copy()
    n = len(axes)
    for i in range(n):
        for key in ("NAXIS", "CDELT", "CRPIX", "CRVAL", "CTYPE", "CUNIT"):
            src = f"{key}{axes[i] + 1}"
            if src in h:
                h2[f"{key}{i + 1}"] = h[src]
    return d, h2


def prepare_advs_data():
    """4-D single-Stokes (1, 2, 3, 4), seed 42, BUNIT K."""
    h = jybeam_header()
    h["BUNIT"] = "K"
    h["NAXIS1"] = 2
    h["NAXIS2"] = 3
    h["NAXIS3"] = 4
    h["NAXIS4"] = 1
    np.random.seed(42)
    d = np.random.random((1, 2, 3, 4))
    return d, h


def prepare_4_beams_table():
    bt = BinTableHDU(columns=OrderedDict(
        BMAJ=np.array([0.4, 0.3, 0.3, 0.4], "f4"),
        BMIN=np.array([0.1, 0.2, 0.2, 0.1], "f4"),
        BPA=np.array([0, 45, 60, 30], "f4"),
        CHAN=np.arange(4, dtype="i4"),
        POL=np.zeros(4, dtype="i4")), name="BEAMS",
        units={"BMAJ": "arcsec", "BMIN": "arcsec", "BPA": "deg"})
    bt.header["NCHAN"] = 4
    bt.header["NPOL"] = 1
    return bt


def data_advs(tmp_path, name="advs.fits"):
    d, h = prepare_advs_data()
    path = str(tmp_path / name)
    write_fits(path, [HDU(data=d, header=h)])
    return path, d


def data_vda_beams(tmp_path, name="vda_beams.fits"):
    """adv transposed to (v, d, a) with BUNIT ' Jy / beam ' and the 4-beam
    BEAMS table."""
    d, h = prepare_adv_data()
    d, h = transpose(d, h, [2, 0, 1])
    d, h = transpose(d, h, [2, 1, 0])
    h["BUNIT"] = " Jy / beam "
    for k in ("BMAJ", "BMIN", "BPA"):
        if k in h:
            del h[k]
    h["CASAMBM"] = True
    path = str(tmp_path / name)
    write_fits(path, [HDU(data=d, header=h), prepare_4_beams_table()])
    return path, d


def data_sdav_beams(tmp_path, name="sdav_beams.fits"):
    """4-D (4, 3, 2, 1) numpy with axes (s, d, a, v) in FITS order and the
    4-beam table."""
    d, h = prepare_advs_data()
    d, h = transpose(d, h, [1, 2, 3, 0])
    d, h = transpose(d, h, [1, 2, 3, 0])
    d, h = transpose(d, h, [1, 2, 3, 0])
    d, h = transpose(d, h, [0, 2, 1, 3])
    for k in ("BMAJ", "BMIN", "BPA"):
        if k in h:
            del h[k]
    np.random.seed(42)
    d = np.random.random((4, 3, 2, 1))
    h["CASAMBM"] = True
    path = str(tmp_path / name)
    write_fits(path, [HDU(data=d, header=h), prepare_4_beams_table()])
    return path, d


# -- the files equal the JAX fixtures' --------------------------------------

_FILES = {
    "make_cube_file": lambda t: make_cube_file(t),
    "make_cube_file_shaped": lambda t: make_cube_file(
        t, shape=(7, 5, 3), seed=3, with_nan=False, ctype3="FREQ",
        cunit3="Hz"),
    "make_vr_cube_file": lambda t: make_vr_cube_file(t),
    "data_adv": data_adv,
    "data_advs": data_advs,
    "data_vda_beams": data_vda_beams,
    "data_sdav_beams": data_sdav_beams,
}


def _jax_files():
    pytest.importorskip("jax")
    import conftest
    import ref_fixtures
    return {
        "make_cube_file": lambda t: conftest.make_cube_file(t),
        "make_cube_file_shaped": lambda t: conftest.make_cube_file(
            t, shape=(7, 5, 3), seed=3, with_nan=False, ctype3="FREQ",
            cunit3="Hz"),
        "make_vr_cube_file": lambda t: conftest.make_vr_cube_file(t),
        "data_adv": ref_fixtures.data_adv,
        "data_advs": ref_fixtures.data_advs,
        "data_vda_beams": ref_fixtures.data_vda_beams,
        "data_sdav_beams": ref_fixtures.data_sdav_beams,
    }


@pytest.mark.parametrize("name", sorted(_FILES))
def test_fixture_files_equal_the_jax_fixtures(name, tmp_path):
    jax_make = _jax_files()[name]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    p_port, d_port = _FILES[name](tmp_path / "port")
    p_jax, d_jax = jax_make(tmp_path / "jax")
    with open(p_port, "rb") as f1, open(p_jax, "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(d_port, d_jax)


def test_header_helpers_equal_the_jax_fixtures():
    pytest.importorskip("jax")
    import ref_fixtures
    for mine, theirs in ((jybeam_header(), ref_fixtures.jybeam_header()),
                         (prepare_adv_data()[1],
                          ref_fixtures.prepare_adv_data()[1]),
                         (prepare_advs_data()[1],
                          ref_fixtures.prepare_advs_data()[1])):
        assert list(mine.keys()) == list(theirs.keys())
        assert all(mine[k] == theirs[k] for k in mine.keys())
    d, h = prepare_advs_data()
    for axes in ([2, 0, 1], [1, 2, 3, 0], [0, 2, 1, 3]):
        n = len(axes)
        dd = d.reshape(d.shape[-n:]) if n < d.ndim else d
        mine, theirs = transpose(dd, h, axes), \
            ref_fixtures.transpose(dd, h, axes)
        np.testing.assert_array_equal(mine[0], theirs[0])
        assert dict(mine[1].items()) == dict(theirs[1].items())
