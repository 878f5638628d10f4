"""Warning taxonomy, guard rails, and small helpers.

Mirrors the reference's user-facing telemetry (warning classes at
``spectral_cube/utils.py:77-135`` and the huge-operation
guards at ``:41-75``) — on TPU the "slow path" guards warn about host
transfers and unsharded huge cubes rather than memmap loops.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import warnings

__all__ = [
    "SpectralCubeWarning", "UnsupportedIterationStrategyWarning",
    "VarianceWarning", "SliceWarning", "BeamAverageWarning",
    "BeamWarning", "WCSCelestialError", "WCSMismatchWarning", "WCSWarning",
    "NotImplementedWarning", "StokesWarning", "ExperimentalImplementationWarning",
    "PossiblySlowWarning", "SmoothingWarning", "NonFiniteBeamsWarning",
    "FITSWarning", "BadVelocitiesWarning", "FITSReadError", "NoBeamError",
    "cached", "warn_slow", "ieee_fp32", "takes_numpy",
]


class SpectralCubeWarning(Warning):
    pass


class UnsupportedIterationStrategyWarning(SpectralCubeWarning):
    pass


class VarianceWarning(SpectralCubeWarning):
    pass


class SliceWarning(SpectralCubeWarning):
    pass


class BeamAverageWarning(SpectralCubeWarning):
    pass


class BeamWarning(SpectralCubeWarning):
    pass


class WCSCelestialError(Exception):
    pass


class WCSMismatchWarning(SpectralCubeWarning):
    pass


class WCSWarning(SpectralCubeWarning):
    pass


class NotImplementedWarning(SpectralCubeWarning):
    pass


class StokesWarning(SpectralCubeWarning):
    pass


class ExperimentalImplementationWarning(SpectralCubeWarning):
    pass


class PossiblySlowWarning(SpectralCubeWarning):
    pass


class SmoothingWarning(SpectralCubeWarning):
    pass


class NonFiniteBeamsWarning(SpectralCubeWarning):
    pass


class FITSWarning(SpectralCubeWarning):
    pass


class BadVelocitiesWarning(SpectralCubeWarning):
    pass


class FITSReadError(Exception):
    pass


from .beams import NoBeamError  # noqa: E402  (re-export for API parity)


_CACHED_LOCK = threading.Lock()


def cached(func):
    """Per-instance memoization of a nullary method (reference utils
    ``cached`` decorator semantics).  Threads that miss at once each
    compute, and every caller gets the value stored first."""
    name = f"_cache_{func.__name__}"

    @functools.wraps(func)
    def wrapper(self, *args):
        cache = getattr(self, name, None)
        if cache is None:
            with _CACHED_LOCK:
                cache = getattr(self, name, None)
                if cache is None:
                    cache = {}
                    object.__setattr__(self, name, cache)
        if args not in cache:
            cache.setdefault(args, func(self, *args))
        return cache[args]
    return wrapper


#: the blocks inside :func:`ieee_fp32` now, and the TF32 flags the first
#: of them found
_IEEE = {"depth": 0, "flags": None}
_IEEE_LOCK = threading.Lock()


@contextlib.contextmanager
def ieee_fp32():
    """Float32 matrix products and convolutions in full IEEE float32 inside
    the block, with TF32 off, as the JAX package runs them at HIGHEST
    precision.  The process-wide flags are off while any thread is inside
    such a block (the positions of a mesh enter and leave it at once) and
    restored when the last one leaves."""
    import torch
    with _IEEE_LOCK:
        if _IEEE["depth"] == 0:
            _IEEE["flags"] = (torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _IEEE["depth"] += 1
    try:
        yield
    finally:
        with _IEEE_LOCK:
            _IEEE["depth"] -= 1
            if _IEEE["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _IEEE["flags"]


def takes_numpy(function):
    """``function`` of a tensor (its first argument) also taking numpy, as
    the JAX function takes any array: numpy lands where a cube's data
    would (``cube._as_tensor``: the card unless the CPU is asked for) and
    each tensor of the result comes back as a numpy array, as the JAX
    function's caller gets arrays back.  A tensor passes through."""
    @functools.wraps(function)
    def wrapper(data, *args, **kwargs):
        import torch
        if isinstance(data, torch.Tensor):
            return function(data, *args, **kwargs)
        from .cube import _as_tensor
        out = function(_as_tensor(data, None), *args, **kwargs)

        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        return tuple(map(host, out)) if isinstance(out, tuple) else host(out)
    return wrapper


# reference policy constant (cube_utils.py:268): ops touching more elements
# than this warn unless the user opted in via allow_huge_operations
MEMORY_THRESHOLD = 1e8


def warn_slow(function):
    """Raise on huge whole-cube host materializations unless allowed
    (reference utils.py:41-75)."""

    @functools.wraps(function)
    def wrapper(self, *args, **kwargs):
        if self._is_huge and not self.allow_huge_operations:
            raise ValueError(
                f"This function ({function.__name__}) requires loading the "
                "entire cube into memory/device and may slow down or crash. "
                "Set `cube.allow_huge_operations=True` to override.")
        elif not self._is_huge:
            warnings.warn(
                f"This function ({function.__name__}) requires loading "
                "the entire cube into memory and may therefore be slow.",
                PossiblySlowWarning)
        return function(self, *args, **kwargs)
    return wrapper


def ProgressBar(niter, **kwargs):
    """tqdm progress bar, or a no-op stand-in when tqdm is unavailable
    (reference utils.py:15-16)."""
    try:
        from tqdm import tqdm
        return tqdm(total=niter, **kwargs)
    except ImportError:
        class _Noop:
            def update(self, n=1):
                pass

            def close(self):
                pass

            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False
        return _Noop()


def computed_quantity(value, *args, **kwargs):
    """Materialize a device array and wrap it as a Quantity (reference
    utils.py:19-22, where it computes a dask array)."""
    import numpy as _np
    from .units import Quantity
    return Quantity(_np.asarray(value), *args, **kwargs)


def __getattr__(name):
    # beam error classes live in beams.py; the reference exports them from
    # utils (utils.py:131-136) — lazy re-export dodges a circular import
    if name in ("NoBeamError", "BeamError", "BeamUnitsError"):
        from . import beams as _beams
        return getattr(_beams, name)
    raise AttributeError(name)
