"""Build and load the port's CUDA kernels.

The sources in ``spectral_cube_tpu_torch/csrc/`` compile with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and
link into one shared library with a plain C interface, loaded through
``ctypes``.  The build runs at first use, into
``spectral_cube_tpu_torch/_build/`` (git-ignored), under a name that hashes
the sources and flags, so an edited source rebuilds and an unchanged one
loads the library already built.  Nothing here runs at import time: the
CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "check", "stream_ptr", "ptr", "last_build",
           "on_tensor_device", "count_launch", "stream_cached"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("moments.cu", "conv_sep.cu", "resample2.cu", "sigma_clip.cu",
           "smooth_interp.cu", "conv_reproject.cu", "banded_matmul.cu")
#: headers the sources include (hashed with them)
HEADERS = ("moments_acc.cuh", "cp_async.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
#: the lock of the launch counts and of the device caches: the positions
#: of a mesh launch at once, each on its own worker thread
_COUNT_LOCK = threading.Lock()
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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsct_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib):
    P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.sct_moments_chunk.argtypes = []
    lib.sct_moments_chunk.restype = I
    lib.sct_moments_smem.argtypes = [LL, I, I, I]
    lib.sct_moments_smem.restype = LL
    lib.sct_moments.argtypes = [P, P, P, I, LL, I, F, I, I, I, I, P, P, P]
    lib.sct_moments.restype = I
    lib.sct_conv_sep.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, P,
                                 P]
    lib.sct_conv_sep.restype = I
    lib.sct_resample2_step_rows.argtypes = []
    lib.sct_resample2_step_rows.restype = I
    lib.sct_resample2_smem.argtypes = [P]
    lib.sct_resample2_smem.restype = LL
    lib.sct_resample2.argtypes = [P, P]
    lib.sct_resample2.restype = I
    lib.sct_sigma_clip_work.argtypes = [I]
    lib.sct_sigma_clip_work.restype = LL
    lib.sct_sigma_clip_smem.argtypes = [I, I, I, I]
    lib.sct_sigma_clip_smem.restype = LL
    lib.sct_sigma_clip.argtypes = [P, I, LL, F, I, I, I, I, I, P, LL, P, P]
    lib.sct_sigma_clip.restype = I
    lib.sct_smooth_interp_smem.argtypes = [I, LL, I, I, I]
    lib.sct_smooth_interp_smem.restype = LL
    lib.sct_smooth_interp.argtypes = [P, I, I, LL, I, I, I, P, P, I, P, P, I,
                                      P, P, I, P, P]
    lib.sct_smooth_interp.restype = I
    lib.sct_conv_reproject_smem.argtypes = [P]
    lib.sct_conv_reproject_smem.restype = LL
    lib.sct_conv_reproject_smem_limit.argtypes = []
    lib.sct_conv_reproject_smem_limit.restype = I
    lib.sct_conv_reproject_threads.argtypes = []
    lib.sct_conv_reproject_threads.restype = I
    lib.sct_conv_reproject.argtypes = [P, P]
    lib.sct_conv_reproject.restype = I
    lib.sct_banded_matmul_warps.argtypes = []
    lib.sct_banded_matmul_warps.restype = I
    lib.sct_banded_matmul_smem.argtypes = [P]
    lib.sct_banded_matmul_smem.restype = LL
    lib.sct_banded_matmul.argtypes = [P, P]
    lib.sct_banded_matmul.restype = I
    return lib


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails, after every process has ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + out)


def _build(path):
    """Compile each source to an object, all at once, then link
    ``path``."""
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    try:
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                  for s, o in zip(SOURCES, objs)])
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, path)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


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
                    _build(path)
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
    """The current stream of ``device`` (a mesh position's own stream
    inside its worker), where every launch is queued."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def count_launch(wrapper):
    """Add one to ``wrapper.launches``, where the wrapper has launched its
    kernel: under a lock, since the positions of a mesh launch at once."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def stream_cached(cache, size, key, device, make):
    """``cache[key]`` for the current stream of the CUDA ``device``,
    ``make()`` where it is absent; ``cache`` an OrderedDict of at most
    ``size`` entries, the least recently used let go first.  The stream
    is part of the key: ``make`` queues its upload on that stream, so a
    reader on another stream (another mesh position's) would not wait for
    it, and an entry let go returns its block to the stream whose reads
    are queued before any later use of it."""
    import torch
    key = (torch.cuda.current_stream(device).cuda_stream,) + tuple(key)
    with _COUNT_LOCK:
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit
    value = make()
    with _COUNT_LOCK:
        cache[key] = value
        while len(cache) > size:
            cache.popitem(last=False)
    return value


def ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None \
        else ctypes.c_void_p(None)


def on_tensor_device(fn):
    """Decorator of a kernel wrapper whose first argument is the tensor it
    works on: for a CUDA tensor the call runs with the tensor's device
    made current, so that the launch and the per-device calls on the C
    side (``cudaFuncSetAttribute`` before every launch, the occupancy and
    SM-count queries, ``cudaGetDevice``) address that device, not device
    0.  A tensor on another device type passes through."""
    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        dev = getattr(x, "device", None)
        if dev is None or dev.type != "cuda":
            return fn(x, *args, **kwargs)
        import torch
        with torch.cuda.device(dev):
            return fn(x, *args, **kwargs)
    return wrapper
