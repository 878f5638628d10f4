"""Virtual devices for the CPU tests: ``cpu:1`` ... ``cpu:n`` as n
distinct devices.

torch has one CPU device (``torch.zeros(2, device="cpu:1").device`` is
``cpu``), so a mesh of CPU positions repeats one device and hides every
fault that shows only when the positions' devices differ: a host tensor
that meets a shard's tensor, an op over two positions' tensors, a cache
keyed without the device.  :class:`VirtualDevices`, a
``TorchFunctionMode``, gives each tensor a virtual device and holds the
port's calls to the rules of two real devices:

- a factory given ``device=`` makes its tensor there; ``.to(...)``,
  ``.cpu()`` and ``copy_`` (with the ``[...] = tensor`` of basic
  indexing, which is a ``copy_``) are the only ops that move data, and
  every other op's outputs take its inputs' device;
- an op whose tensor inputs lie on two devices raises, as torch raises
  for ``cuda:0`` and ``cuda:1`` or ``cuda:0`` and the host, except for
  what torch lets through: a 0-dim host tensor (a scalar) and host index
  tensors;
- ``.numpy()`` and ``__array__`` of a tensor on a virtual device raise,
  as they do for a card's tensor;
- ``Tensor.device`` reports the virtual device (``cpu:k``), so that the
  port's own ``.to(t.device)`` calls are exercised.

Plain ``cpu`` (or ``cpu:0``) stays the host.  The data never leaves the
host: a virtual device is a tag on the tensor.  Test code only; the port
never imports it.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

__all__ = ["VirtualDevices", "vdev", "device_of", "to_numpy",
           "virtual_devices"]

_TAG = "_virtual_device"
_HOST = torch.device("cpu")

#: functions whose outputs stay on ``self``'s device whatever the other
#: tensor arguments' (they read only a shape, or index)
_SELF_ONLY = {"expand_as", "view_as", "reshape_as", "new_empty",
              "new_zeros", "new_ones", "new_full", "new_tensor",
              "new_empty_strided"}
_INDEXING = {"__getitem__", "__setitem__", "index_put_", "index_put"}
_TO_NUMPY = {"numpy", "__array__"}


def vdev(k):
    """Virtual device ``k`` (0 is the host)."""
    return torch.device("cpu", k) if k else _HOST


def _index(device):
    """The virtual index of a device argument: k of ``cpu:k``, 0 for the
    host; a CUDA device is refused (the CPU tests have none)."""
    d = torch.device(device)
    if d.type != "cpu":
        raise RuntimeError(f"virtual devices are CPU devices, not {d}")
    return d.index or 0


def _tag_of(t):
    return t.__dict__.get(_TAG, 0)


def device_of(t):
    """A tensor's virtual device, read with no mode active."""
    return vdev(_tag_of(t))


def to_numpy(t):
    """A tensor's values as numpy, from any virtual device (test code
    reads results this way)."""
    return t.detach().cpu().numpy()


def _tensors(obj):
    return [x for x in tree_flatten(obj)[0] if isinstance(x, torch.Tensor)]


def _tag(out, k):
    for t in _tensors(out):
        if k:
            t.__dict__[_TAG] = k
        else:
            t.__dict__.pop(_TAG, None)
    return out


def _name(func):
    return getattr(func, "__name__", "")


def _is_device_getter(func):
    return getattr(func, "__self__", None) is torch.Tensor.device


def _common(func, tensors, name):
    """The one device of ``tensors`` (0-dim host tensors aside), or a
    RuntimeError as torch's for two devices."""
    found = {_tag_of(t) for t in tensors if _tag_of(t) or t.dim()}
    if len(found) > 1:
        a, b = sorted(found)[:2]
        raise RuntimeError(
            "Expected all tensors to be on the same device, but found at "
            f"least two devices, {vdev(a)} and {vdev(b)}! (in {name})")
    return found.pop() if found else 0


class VirtualDevices(TorchFunctionMode):
    """The mode; use it as a context manager (:func:`virtual_devices`).
    ``counts`` records the moves between devices it saw (``to``, ``cpu``,
    ``copy_``), from every thread the mode is active on (a mesh's workers
    take on their caller's modes)."""

    def __init__(self):
        super().__init__()
        self.counts = {"moves": 0, "checked": 0}
        self._lock = threading.Lock()

    def _count(self, name, n=1):
        with self._lock:
            self.counts[name] += n

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if _is_device_getter(func):
            return vdev(_tag_of(args[0]))
        name = _name(func)
        self._count("checked")
        if name in _TO_NUMPY:
            k = _tag_of(args[0])
            if k:
                raise TypeError(
                    f"can't convert {vdev(k)} device type tensor to numpy. "
                    "Use Tensor.cpu() to copy the tensor to host memory "
                    "first.")
            return func(*args, **kwargs)
        if name == "to" and isinstance(args[0], torch.Tensor):
            return self._to(func, args, kwargs)
        if name == "cpu":
            return self._move(args[0], 0, lambda: func(*args, **kwargs))
        if name == "cuda":
            raise RuntimeError("no CUDA device under virtual devices")
        if name == "copy_":
            self._count("moves", _tag_of(args[0]) != _tag_of(args[1]))
            return func(*args, **kwargs)
        if name == "__iter__":
            return iter(_tag(torch.Tensor.unbind(args[0], 0),
                             _tag_of(args[0])))
        if name in ("from_numpy", "frombuffer"):
            return _tag(func(*args, **kwargs), 0)
        if name in ("tensor", "as_tensor"):
            return self._factory(func, args, kwargs)
        if kwargs.get("device") is not None:
            k = _index(kwargs["device"])
            kwargs["device"] = _HOST
            return _tag(func(*args, **kwargs), k)
        if name in _SELF_ONLY:
            return _tag(func(*args, **kwargs), _tag_of(args[0]))
        if name in _INDEXING:
            return self._indexing(func, name, args, kwargs)
        k = _common(func, _tensors((args, kwargs)), name)
        return _tag(func(*args, **kwargs), k)

    # -- the ops that move data ------------------------------------------
    def _move(self, src, k, call):
        """``call()``'s result on device ``k``: a copy of ``src`` where
        the devices differ (torch's ``to``/``cpu`` of the host hand back
        ``src`` itself), the result as it is where they do not."""
        if _tag_of(src) == k:
            return _tag(call(), k)
        self._count("moves")
        out = call()
        if out is src or (out.numel() and out.data_ptr() == src.data_ptr()):
            out = out.clone()
        return _tag(out, k)

    def _to(self, func, args, kwargs):
        src = args[0]
        rest = args[1:]
        if rest and isinstance(rest[0], torch.Tensor):
            other = rest[0]
            k, dtype = _tag_of(other), other.dtype
            nb = kwargs.get("non_blocking", False)
            return self._move(src, k, lambda: torch.Tensor.to(
                src, dtype=dtype, non_blocking=nb))
        device, dtype, nb, fmt = torch._C._nn._parse_to(*rest, **kwargs)
        k = _tag_of(src) if device is None else _index(device)
        kw = {"non_blocking": nb, "copy": bool(kwargs.get("copy", False))}
        if dtype is not None:
            kw["dtype"] = dtype
        if fmt is not None:
            kw["memory_format"] = fmt
        return self._move(src, k, lambda: torch.Tensor.to(src, **kw))

    def _factory(self, func, args, kwargs):
        device = kwargs.get("device")
        data = args[0] if args else kwargs.get("data")
        if device is not None:
            k = _index(device)
            kwargs["device"] = _HOST
        elif isinstance(data, torch.Tensor):
            k = _tag_of(data)
        else:
            k = 0
        out = func(*args, **kwargs)
        if isinstance(data, torch.Tensor) and out is data \
                and k != _tag_of(data):
            out = out.clone()
        return _tag(out, k)

    def _indexing(self, func, name, args, kwargs):
        """Indexing: host index tensors are let through (torch moves
        them); a value assigned through basic indexing is a ``copy_``."""
        self_, index = args[0], args[1]
        k = _tag_of(self_)
        idx = _tensors(index)
        for t in idx:
            if _tag_of(t) not in (0, k):
                _common(func, [self_, t], name)
        if name == "__setitem__" and not idx:
            return func(*args, **kwargs)
        vals = _tensors((args[2:], kwargs))
        _common(func, [self_] + vals, name)
        return _tag(func(*args, **kwargs), k)


@contextlib.contextmanager
def virtual_devices():
    """The mode, entered: ``with virtual_devices() as vd: ...``."""
    mode = VirtualDevices()
    with mode:
        yield mode
