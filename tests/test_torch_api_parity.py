"""Torch port, public API parity with the JAX package.

Walks every module of ``spectral_cube_tpu`` with ``ast``: its public
module-level names (functions, classes, assignments, and in a package's
``__init__`` its imports) and each public class's public methods and
class attributes.  Each must have a counterpart in the port's module of
the same path: an attribute after import (a re-export counts), or an
importable submodule.  The port is imported, never parsed, so what a
user can reach is what is checked.

The allow-list below is explicit, with a reason on each entry, and every
entry must still be missing from the port, so the list cannot go stale.
"""

import ast
import importlib
import os
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "spectral_cube_tpu"

TPU_ONLY = "a TPU-only form the port replaced by design"

#: whole modules of the JAX package with no port file
MODULES_NOT_PORTED = {
    "ops/banded_pallas.py": TPU_ONLY + ": the Pallas kernels, each ported "
                            "to csrc/*.cu behind kernels/*.py",
    "ops/clip_pallas.py": TPU_ONLY + ": the Pallas sigma clip, ported to "
                          "csrc/sigma_clip.cu",
}

#: (module path, name or Class.member) with no counterpart in the port
NAMES_NOT_PORTED = {
    ("__init__.py", "enable_compilation_cache"):
        TPU_ONLY + ": XLA's persistent compilation cache",
    ("utils.py", "enable_compilation_cache"):
        TPU_ONLY + ": XLA's persistent compilation cache",
    ("ops/moments.py", "moments_012_pallas"):
        TPU_ONLY + ": csrc/moments.cu behind kernels/moments.py",
    ("ops/moments.py", "statistics_pallas"):
        TPU_ONLY + ": csrc/moments.cu (with statistics)",
    ("ops/moments.py", "moments_012_cached"):
        TPU_ONLY + ": a jit cache of the Pallas dispatch; torch traces "
        "nothing",
    ("ops/moments.py", "statistics_cached"):
        TPU_ONLY + ": a jit cache of the Pallas dispatch; torch traces "
        "nothing",
    ("ops/convolve.py", "device_complex"):
        TPU_ONLY + ": the TPU's complex-dtype probe; cuFFT takes complex64",
    ("ops/interpolate.py", "block_tap_matmul"):
        TPU_ONLY + ": the MXU tap form; csrc/smooth_interp.cu and "
        "csrc/banded_matmul.cu do the banded products",
    ("ops/interpolate.py", "block_matmul_from_dense"):
        TPU_ONLY + ": the MXU tap form, as block_tap_matmul",
}


def _public(name):
    return not name.startswith("_")


def _surface(path):
    """(module-level names, {class: members}) of one source file."""
    tree = ast.parse(path.read_text())
    names, classes = set(), {}
    is_init = path.name == "__init__.py"
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name) and _public(t.id))
        elif is_init and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names
                         if _public(a.asname or a.name))
        if isinstance(node, ast.ClassDef) and _public(node.name):
            members = set()
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _public(item.name):
                        members.add(item.name)
                elif isinstance(item, ast.Assign):
                    members.update(t.id for t in item.targets
                                   if isinstance(t, ast.Name)
                                   and _public(t.id))
            classes[node.name] = members
    return names, classes


def _modules():
    return sorted(str(p.relative_to(JAX_ROOT)).replace(os.sep, "/")
                  for p in JAX_ROOT.rglob("*.py"))


def _port_module(rel):
    dotted = rel[:-3].replace("/", ".")
    if dotted.endswith("__init__"):
        dotted = dotted[:-len(".__init__")] if "." in dotted else ""
    name = "spectral_cube_tpu_torch" + ("." + dotted if dotted else "")
    return importlib.import_module(name)


def _has(module, name):
    if hasattr(module, name):
        return True
    try:
        importlib.import_module(f"{module.__name__}.{name}")
    except ImportError:
        return False
    return True


def _missing(rel):
    names, classes = _surface(JAX_ROOT / rel)
    port = _port_module(rel)
    missing = {n for n in names if not _has(port, n)}
    for cls, members in classes.items():
        target = getattr(port, cls, None)
        if target is None:
            continue  # reported as a missing name
        missing.update(f"{cls}.{m}" for m in members
                       if not hasattr(target, m))
    return missing


PORTED = [m for m in _modules() if m not in MODULES_NOT_PORTED]


@pytest.mark.parametrize("rel", PORTED)
def test_module_surface_has_a_counterpart(rel):
    assert (REPO / "spectral_cube_tpu_torch" / rel).exists(), \
        f"no port file for {rel}"
    allowed = {name for (mod, name) in NAMES_NOT_PORTED if mod == rel}
    missing = _missing(rel)
    assert not missing - allowed, (
        f"{rel}: public in the JAX package, absent from the port: "
        f"{sorted(missing - allowed)}")
    assert not allowed - missing, (
        f"{rel}: allow-listed but present in the port, drop from the "
        f"list: {sorted(allowed - missing)}")


def test_allow_list_is_explicit():
    """Every entry names a module or a name that exists in the JAX package
    and carries a reason."""
    modules = set(_modules())
    for rel, reason in MODULES_NOT_PORTED.items():
        assert rel in modules and reason
        assert not (REPO / "spectral_cube_tpu_torch" / rel).exists(), rel
    for (rel, name), reason in NAMES_NOT_PORTED.items():
        assert rel in modules and rel not in MODULES_NOT_PORTED and reason
        names, classes = _surface(JAX_ROOT / rel)
        cls, _, member = name.partition(".")
        assert (name in names) if not member else \
            member in classes.get(cls, ()), (rel, name)


def test_port_has_no_extra_kernel_gaps():
    """Each Pallas module the allow-list drops has its kernels' wrappers
    in the port (the 14 TPU kernels, PERF.md)."""
    from spectral_cube_tpu_torch import kernels
    for name in ("moments", "conv_sep", "resample2", "conv_reproject",
                 "smooth_interp", "sigma_clip", "banded_matmul"):
        assert importlib.import_module(f"{kernels.__name__}.{name}")
