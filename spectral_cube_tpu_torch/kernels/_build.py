"""Build and load the port's CUDA kernels.

The sources in ``spectral_cube_tpu_torch/csrc/`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded through
``ctypes``.  The build runs at first use, into
``spectral_cube_tpu_torch/_build/`` (git-ignored), under a name that hashes
the sources and flags, so an edited source rebuilds and an unchanged one
loads the library already built.  Nothing here runs at import time: the
CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "check", "stream_ptr", "ptr", "last_build"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("moments.cu", "conv_sep.cu", "resample2.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
#: {"seconds": build wall time (0.0 when the library was already built),
#:  "path": the library} of the load that ran in this process
last_build = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that holds bin/nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsct_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib):
    P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.sct_moments_chunk.argtypes = []
    lib.sct_moments_chunk.restype = I
    lib.sct_moments.argtypes = [P, P, P, I, LL, I, F, I, P, P, P]
    lib.sct_moments.restype = I
    lib.sct_conv_sep_tile_y.argtypes = [I, I, I]
    lib.sct_conv_sep_tile_y.restype = I
    lib.sct_conv_sep.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, P,
                                 P]
    lib.sct_conv_sep.restype = I
    lib.sct_resample2.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P, P]
    lib.sct_resample2.restype = I
    return lib


def load_library():
    """The kernels' library, built first if its sources changed.  Raises
    when ``nvcc`` is missing or the build fails (with its output)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _library_path()
        t0 = time.perf_counter()
        built = False
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # one builder at a time across processes; the others wait and
            # then find the finished library
            with open(BUILD_DIR / "build.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not path.exists():
                    tmp = path.with_suffix(f".{os.getpid()}.tmp")
                    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *(str(CSRC / s) for s in SOURCES)]
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            "nvcc failed:\n" + " ".join(cmd) + "\n"
                            + proc.stdout + proc.stderr)
                    os.replace(tmp, path)
                    built = True
        _LIB = _declare(ctypes.CDLL(str(path)))
        last_build.update(seconds=time.perf_counter() - t0 if built else 0.0,
                          path=str(path))
        return _LIB


def check(err, name):
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error code {err} (cudaError_t)")


def stream_ptr(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None \
        else ctypes.c_void_p(None)
