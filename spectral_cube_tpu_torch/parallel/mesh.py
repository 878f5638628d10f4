"""Device mesh and sharded arrays: the port of
``spectral_cube_tpu/parallel/mesh.py``.

The JAX package runs one controller over a 2-D ('y', 'x') mesh of the
local devices; ``shard_map`` programs move data between them with
``ppermute`` and ``all_to_all``, and results come back as global arrays.
The port keeps that model inside one process: a :class:`CubeMesh` is a
grid of torch devices (one device may appear more than once, the
counterpart of XLA's ``--xla_force_host_platform_device_count``), and a
:class:`ShardedArray` is one tensor per mesh position, each on its device,
with the global shape, the layout and each shard's index into the global
array.  Collectives are explicit ``copy_`` calls between shards, never an
assembly of the global tensor.

The two canonical cube layouts (the reference's chunk policy,
dask_spectral_cube.py:551, :618):

- ``spatial`` -- [spec, y/my, x/mx]: the spectral axis local, space split
  over the mesh.  Moments, the spectral path and per-spaxel work need no
  communication in it.
- ``spectral`` -- [spec/(my*mx), y, x]: channel blocks over every device,
  y-major (``P(('y','x'), None, None)``), whole planes local.  FFT beam
  convolution and the gather reprojection run per channel in it.

``reshard`` moves between them with two explicit all-to-alls; halos for
small stencils are exchanged by ``parallel.sharded.halo_pad``.  The mesh
counts its halo exchanges, all-to-alls and gathers of a cube onto one
device (``CubeMesh.counters``), where the JAX tests read the compiled
program's collectives.

As ``shard_map`` runs its devices together, the positions run at once
(``CubeMesh._each``): one worker thread per position, and on a CUDA
device one stream per position, positions that share a card on streams
of their own.  Each call forks from the caller's stream (what the caller
queued before it is ready for every position) and joins back into it
(what the positions queued is ready for the caller).  A position's call
reads its own blocks and what existed before the fork, never what
another position makes in the same call: a hand-off between positions
is two calls, and the sources are dropped only after the join, so that
the caching allocator hands no block out again while another stream
still reads it.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
import queue
import threading
import warnings
import weakref
from collections import namedtuple

import numpy as np
import torch

__all__ = ["CubeMesh", "make_mesh", "use_mesh", "default_mesh", "Mesh",
           "Sharding", "ShardedArray", "Shard"]

_DEFAULT_MESH = None

#: ``active`` on a mesh's worker threads: a position's call that reaches
#: another mesh call runs its positions in turn, on its own worker
_WORKER = threading.local()
#: the lock of every mesh's counters: positions may count at once
_LOCK = threading.Lock()

LAYOUT_SPECS = {"spatial": (None, "y", "x"),
                "spectral": (("y", "x"), None, None),
                "plane": ("y", "x"),
                "replicated": ()}


def default_mesh() -> "CubeMesh":
    """The process-wide default CubeMesh (every CUDA device once unless
    overridden by :func:`use_mesh`)."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = CubeMesh()
    return _DEFAULT_MESH


class use_mesh:
    """Set the default mesh, as a call or a context manager (the analog of
    the reference's ``use_dask_scheduler``, dask_spectral_cube.py:278-312).

    >>> use_mesh(CubeMesh(shape=(2, 2)))            # set globally
    >>> with use_mesh(CubeMesh(devices=devs)):      # or scoped
    ...     cube.to_sharded().moment_maps()
    """

    def __init__(self, cmesh):
        global _DEFAULT_MESH
        self._previous = _DEFAULT_MESH
        _DEFAULT_MESH = cmesh

    def __enter__(self):
        return _DEFAULT_MESH

    def __exit__(self, *exc):
        global _DEFAULT_MESH
        _DEFAULT_MESH = self._previous
        return False


class _Worker(threading.Thread):
    """A mesh position's worker: runs the jobs put on its queue in turn
    until it is handed None."""

    def __init__(self, name):
        super().__init__(name=name, daemon=True)
        self._jobs = queue.SimpleQueue()
        self.start()

    def put(self, job):
        self._jobs.put(job)

    def run(self):
        _WORKER.active = True
        while True:
            job = self._jobs.get()
            if job is None:
                return
            job()
            # the job holds its mesh: let it go while the worker waits
            del job


def _stop(workers):
    """End a mesh's workers (the mesh is gone)."""
    for w in workers:
        w.put(None)


def _caller_context():
    """The calling thread's state that a worker takes on: its
    TorchFunctionMode stack (``with torch.device(...)`` is one of its
    modes) and TorchDispatchMode stack (a sanitizer's), grad mode and
    inference mode."""
    modes = [torch._C._get_function_stack_at(i)
             for i in range(torch._C._len_torch_function_stack())]
    dispatch = [torch._C._get_dispatch_stack_at(i)
                for i in range(torch._C._len_torch_dispatch_stack())]
    return (modes, dispatch, torch.is_grad_enabled(),
            torch.is_inference_mode_enabled())


def _enter_context(stack, ctx):
    """Enter the caller's state ``ctx`` (:func:`_caller_context`) on this
    thread for the life of the ExitStack ``stack``."""
    modes, dispatch, grad, inference = ctx
    if inference:
        stack.enter_context(torch.inference_mode())
    stack.enter_context(torch.set_grad_enabled(grad))
    for mode in modes:
        torch._C._push_on_torch_function_stack(mode)
    stack.callback(lambda: [torch._C._pop_torch_function_stack()
                            for _ in modes])
    for mode in dispatch:
        torch._C._push_on_torch_dispatch_stack(mode)
    stack.callback(lambda: [torch._C._pop_torch_dispatch_stack(None)
                            for _ in dispatch])


def _factor2(n):
    """Split n into the most-square (a, b) with a*b == n."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def _as_device(d):
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 2-D grid of torch devices with axis names (``jax.sharding.Mesh``'s
    counterpart): ``devices`` is an object array of shape (ny, nx)."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(devices=None, shape=None, axis_names=("y", "x")) -> Mesh:
    """A :class:`Mesh` over ``devices`` (default: every CUDA device once;
    raises where there is none) in the most-square ``shape``."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "the default mesh spans the CUDA devices and CUDA is not "
                "available here: pass devices=, e.g. ['cpu'] * 8")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_as_device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        shape = _factor2(n)
    ny, nx = shape
    if ny * nx != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(ny, nx), axis_names)


class Sharding:
    """A layout of a global array over a :class:`CubeMesh`: ``spec`` has
    one entry per leading dimension, None (whole on every device), 'y',
    'x' or ('y', 'x') (split over those mesh axes, y-major), as a
    ``PartitionSpec``; trailing dimensions are whole."""

    def __init__(self, cmesh, spec):
        self.cmesh = cmesh
        self.spec = tuple(spec)

    def indices(self, shape):
        """Each mesh position's index into an array of ``shape``: a list
        in position order (row-major over the mesh) of tuples of
        slices."""
        my, mx = self.cmesh.grid
        spec = self.spec + (None,) * (len(shape) - len(self.spec))
        out = []
        for iy in range(my):
            for ix in range(mx):
                coord = {"y": (iy, my), "x": (ix, mx)}
                idx = []
                for dim, entry in zip(shape, spec):
                    if entry is None:
                        idx.append(slice(0, dim))
                        continue
                    names = entry if isinstance(entry, tuple) else (entry,)
                    k, size = 0, 1
                    for name in names:
                        c, m = coord[name]
                        k, size = k * m + c, size * m
                    block = dim // size
                    idx.append(slice(k * block, (k + 1) * block))
                out.append(tuple(idx))
        return out

    def __repr__(self):
        return f"Sharding(spec={self.spec}, grid={self.cmesh.grid})"


#: one shard of a :class:`ShardedArray` (``addressable_shards``' entries):
#: its mesh position (iy, ix), device, index into the global array, data
Shard = namedtuple("Shard", "position device index data")


def _extent(index):
    return tuple(s.stop - s.start for s in index)


class ShardedArray:
    """A global array held as one tensor per mesh position.

    ``blocks[p]`` is the part ``index[p]`` (a tuple of slices with unit
    step) of the global array of ``shape``, on the device of mesh
    position ``p`` (row-major).  Positions whose indices overlap hold
    copies (a replicated axis); the blocks of a layout with a ragged last
    tile are smaller there."""

    def __init__(self, cmesh, layout, shape, blocks, index):
        self.cmesh = cmesh
        self.layout = layout
        self.shape = tuple(int(n) for n in shape)
        self.blocks = list(blocks)
        self.index = [tuple(slice(int(s.start), int(s.stop)) for s in ix)
                      for ix in index]
        if len(self.blocks) != cmesh.n_devices \
                or len(self.index) != cmesh.n_devices:
            raise ValueError("one block and one index per mesh position")
        for b, ix in zip(self.blocks, self.index):
            if tuple(b.shape) != _extent(ix):
                raise ValueError(f"block {tuple(b.shape)} does not match "
                                 f"its index {ix}")

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def addressable_shards(self):
        devs = self.cmesh.devices
        my, mx = self.cmesh.grid
        return [Shard((p // mx, p % mx), devs[p], ix, b)
                for p, (b, ix) in enumerate(zip(self.blocks, self.index))]

    def map(self, fn, *others):
        """``fn`` applied block by block (with the blocks of ``others``,
        ShardedArrays of the same placement, or None), keeping the
        placement; ``fn`` must keep each block's shape."""
        blocks = self.cmesh._each(lambda p: fn(
            self.blocks[p], *[None if o is None else o.blocks[p]
                              for o in others]))
        return ShardedArray(self.cmesh, self.layout, self.shape, blocks,
                            self.index)

    def gather(self, device=None):
        """The global array assembled on ``device`` (default: the mesh's
        first device).  A 3-D (cube) gather adds one to the mesh's
        ``gathers`` counter; a 2-D map's assembly, the counterpart of
        fetching a moment map in the JAX package, does not."""
        dev = self.cmesh.devices[0] if device is None else _as_device(device)
        if self.ndim == 3:
            self.cmesh._count("gathers")
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen, sources = set(), []
        for p, (b, ix) in enumerate(zip(self.blocks, self.index)):
            key = tuple((s.start, s.stop) for s in ix)
            if key in seen or 0 in b.shape:
                continue
            seen.add(key)
            sources.append(p)
        # each position copies its own block into its part of ``out``
        self.cmesh._each(lambda p: out[self.index[p]].copy_(self.blocks[p]),
                         sources)
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self.gather(torch.device("cpu")).numpy()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self):
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"layout={self.layout!r}, grid={self.cmesh.grid})")


class CubeMesh:
    """A 2-D ('y', 'x') device mesh with the two canonical cube layouts.

    ``devices``: torch devices (or their names), one per mesh position; one
    device may repeat (several shards on one card).  Default: every CUDA
    device once; raises where CUDA is absent."""

    def __init__(self, devices=None, shape=None):
        self.mesh = make_mesh(devices=devices, shape=shape)
        self.counters = {"halo_exchanges": 0, "all_to_alls": 0,
                         "gathers": 0}
        # the per-position workers, streams and events, made at the first
        # call
        self._workers = self._streams = self._joined = self._forks = None
        self._calls = threading.Lock()

    def reset_counters(self):
        with _LOCK:
            for k in self.counters:
                self.counters[k] = 0

    def _count(self, name):
        with _LOCK:
            self.counters[name] += 1

    # -- the positions at once ----------------------------------------------
    def _each(self, fn, positions=None, one_a_device=False):
        """``[fn(p) for p in positions]`` (default: every position), each
        position's call at once on its own worker, as ``shard_map`` runs
        its devices: the position's device current and, on a CUDA device,
        the position's own stream (:meth:`_fork` before, :meth:`_join`
        after), with the caller's TorchFunctionMode and
        TorchDispatchMode stacks (``with torch.device(...)`` is a function
        mode), grad mode, inference mode and context variables (numpy's
        ``errstate``).  Results in position order.  An exception in a
        position is raised once every position has stopped and every
        stream has been joined (the first in position order).  One
        position, or a call from inside a worker, runs in turn in the
        calling thread; the mesh's calls from several threads take turns
        (its events are reused).  ``one_a_device``: the positions that
        share a device run one after another on the first one's worker,
        each on its own stream, the devices at once (a sort of up to
        ``ops/reductions.SORT_PIECE`` values a position holds ~5 GiB,
        and one card holds one position's at a time, as in turn)."""
        positions = range(self.n_devices) if positions is None \
            else positions
        positions = list(positions)
        if len(positions) < 2 or getattr(_WORKER, "active", False):
            return [fn(p) for p in positions]
        with self._calls:
            if self._workers is None:
                self._start()
            callers = self._fork(positions)
            ctx = _caller_context()
            n = len(positions)
            results, errors = [None] * n, [None] * n
            groups = {}
            for k, p in enumerate(positions):
                groups.setdefault(self.devices[p] if one_a_device else k,
                                  []).append((k, p))
            left, done = [len(groups)], threading.Event()
            lock = threading.Lock()

            def job(members):
                try:
                    for k, p in members:
                        try:
                            results[k] = self._call(p, fn, ctx, callers)
                        except BaseException as exc:   # raised in the caller
                            errors[k] = exc
                finally:
                    with lock:
                        left[0] -= 1
                        last = left[0] == 0
                    if last:
                        done.set()
            for members in groups.values():
                self._workers[members[0][1]].put(functools.partial(
                    contextvars.copy_context().run, job, members))
            done.wait()
            self._join(positions, callers)
        for exc in errors:
            if exc is not None:
                raise exc
        return results

    def _start(self):
        """One worker thread per position, and a stream, a fork event and
        a join event for each CUDA position (two positions on one card
        get two streams)."""
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                         else None for d in self.devices]
        self._joined = [None if s is None else torch.cuda.Event()
                        for s in self._streams]
        self._forks = {d: torch.cuda.Event() for d in self.devices
                       if d.type == "cuda"}
        self._workers = [_Worker(f"mesh-position-{p}")
                         for p in range(self.n_devices)]
        weakref.finalize(self, _stop, self._workers)

    def _fork(self, positions):
        """Each CUDA position's stream made to wait on the caller's
        current stream of its card (one event a card): what the caller
        queued before the call is ready for the position.  Returns the
        caller's current stream of every card of the mesh."""
        callers = {}
        for d, event in self._forks.items():
            callers[d] = torch.cuda.current_stream(d)
            event.record(callers[d])
        for p in positions:
            s = self._streams[p]
            if s is not None:
                s.wait_event(self._forks[s.device])
        return callers

    def _join(self, positions, callers):
        """The caller's stream of each card made to wait on the streams of
        the positions there (each position's join event, recorded at the
        end of its work): what they queued is ready for the caller, and a
        block they read is handed out again only after they have read
        it."""
        for p in positions:
            s = self._streams[p]
            if s is not None:
                callers[s.device].wait_event(self._joined[p])

    def _call(self, p, fn, ctx, callers):
        """Position ``p``'s call on its worker: ``fn(p)`` with the
        caller's context ``ctx``, the position's device current and its
        stream; a host position queues its copies from and to a card on
        the caller's stream of that card."""
        with contextlib.ExitStack() as stack:
            s = self._streams[p]
            if s is not None:
                stack.enter_context(torch.cuda.device(s.device))
                stack.enter_context(torch.cuda.stream(s))
                stack.callback(self._joined[p].record, s)
            else:
                for c in callers.values():
                    stack.enter_context(torch.cuda.stream(c))
            _enter_context(stack, ctx)
            return fn(p)

    @property
    def axis_names(self):
        return self.mesh.axis_names

    @property
    def n_devices(self):
        return self.mesh.devices.size

    @property
    def grid(self):
        return self.mesh.devices.shape

    @property
    def devices(self):
        """The devices in position order (row-major over the mesh)."""
        return list(self.mesh.devices.ravel())

    # -- layouts ---------------------------------------------------------
    def spatial_sharding(self) -> Sharding:
        """[spec, y, x]: space sharded, spectral axis local."""
        return Sharding(self, LAYOUT_SPECS["spatial"])

    def spectral_sharding(self) -> Sharding:
        """[spec, y, x]: channels sharded over all devices, planes local."""
        return Sharding(self, LAYOUT_SPECS["spectral"])

    def plane_sharding(self) -> Sharding:
        """[y, x] maps (moment outputs) sharded like the spatial layout."""
        return Sharding(self, LAYOUT_SPECS["plane"])

    def replicated(self) -> Sharding:
        return Sharding(self, LAYOUT_SPECS["replicated"])

    def sharding(self, layout: str) -> Sharding:
        return {"spatial": self.spatial_sharding,
                "spectral": self.spectral_sharding,
                "plane": self.plane_sharding,
                "replicated": self.replicated}[layout]()

    def compatible_sharding(self, layout, shape) -> Sharding:
        """The layout's sharding with the mesh axes that do not divide
        ``shape`` dropped (replicated): the placement :meth:`shard` gives,
        for callers that need the index map itself (the streaming
        readers)."""
        return Sharding(self, self._compatible_spec(
            self.sharding(layout).spec, shape))

    def _compatible_spec(self, spec, shape):
        from ..utils import PossiblySlowWarning
        if len(shape) < len(spec):
            # zip truncation would pair dim 0 with the spec's leading
            # entry and shard the wrong dims: demand the right layout
            raise ValueError(
                f"array rank {len(shape)} is smaller than the layout "
                f"spec {spec}; use the 'plane' layout for 2-D maps")
        sizes = dict(zip(self.axis_names, self.grid))
        out, dropped = [], []
        for dim, entry in zip(shape, spec):
            if entry is None:
                out.append(None)
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            if dim % math.prod(sizes[n] for n in names) == 0:
                out.append(entry)
            else:
                out.append(None)
                dropped.append((dim, entry))
        if dropped:
            warnings.warn(
                f"array dims {dropped} do not divide the mesh; those axes "
                "are REPLICATED on every device (n_devices x the memory). "
                "Pad the cube to mesh-aligned tiles for true sharding "
                "(sharded ops pad internally and stay correct either "
                "way).", PossiblySlowWarning)
        return tuple(out)

    # -- placement ---------------------------------------------------------
    def shard(self, array, layout="spatial"):
        """Place ``array`` (a numpy array, a tensor on any device, or a
        ShardedArray) in ``layout``.  A dimension that the mesh axes do
        not divide is replicated along them (with a
        PossiblySlowWarning), as the JAX package's ``device_put`` falls
        back; the sharded ops pad to aligned tiles internally.  A numpy
        float64 array becomes float32, as the cube entry points store it.
        A ShardedArray already in ``layout`` is returned as it is; one in
        the other cube layout moves by :meth:`reshard`."""
        if isinstance(array, ShardedArray):
            if array.layout == layout:
                return array
            return self.reshard(array, layout)
        if isinstance(array, torch.Tensor):
            src = array
        else:
            arr = np.asarray(array)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            src = torch.from_numpy(np.ascontiguousarray(arr))
        shape = tuple(src.shape)
        index = self.compatible_sharding(layout, shape).indices(shape)

        def place(p):
            blk = torch.empty(_extent(index[p]), dtype=src.dtype,
                              device=self.devices[p])
            return blk.copy_(src[index[p]])
        return ShardedArray(self, layout, shape, self._each(place), index)

    def reshard(self, array, layout, source=None):
        """Change an array's layout (the dask ``rechunk`` analog).

        Between the spatial and spectral layouts this is two explicit
        all-to-alls (y first, so that channel blocks land y-major), each
        a set of ``copy_`` calls between shards: every position sends
        each other position of its mesh row or column exactly its part.
        Any other move gathers the array and shards it again (counted as
        a gather).  ``source`` names the input's layout, as in the JAX
        package; a ShardedArray knows its own."""
        if not isinstance(array, ShardedArray):
            array = self.shard(array, source or "spatial")
        src = source or array.layout
        if src == layout:
            return array
        if src == "spatial" and layout == "spectral":
            return self._a2a_spatial_to_spectral(array)
        if src == "spectral" and layout == "spatial":
            return self._a2a_spectral_to_spatial(array)
        return self.shard(array.gather(), layout)

    # -- the all-to-alls on aligned tiles --------------------------------
    def _tile(self, array, layout, pad_value, chan_multiple=1):
        """Each position's block of ``array`` in ``layout``, padded with
        ``pad_value`` to the aligned tile: channels to a multiple of
        ``chan_multiple`` (spatial) or of the device count (spectral), y
        and x to multiples of the mesh axes.  Every block is cut from the
        position's own shard; a shard that does not hold its tile (the
        array is in another layout) is an error."""
        my, mx = self.grid
        n = self.n_devices
        nchan, ny, nx = array.shape
        ny_p, nx_p = ny + (-ny) % my, nx + (-nx) % mx
        if layout == "spatial":
            nc_p = nchan + (-nchan) % chan_multiple
            py, px = ny_p // my, nx_p // mx
            want = [((0, nc_p), ((p // mx) * py, (p // mx + 1) * py),
                     ((p % mx) * px, (p % mx + 1) * px)) for p in range(n)]
        else:
            nc_p = nchan + (-nchan) % n
            cb = nc_p // n
            want = [((p * cb, (p + 1) * cb), (0, ny_p), (0, nx_p))
                    for p in range(n)]

        def tile(p):
            b, ix, dev = array.blocks[p], array.index[p], self.devices[p]
            lo = [w[0] for w in want[p]]
            hi = [min(w[1], n_) for w, n_ in zip(want[p], array.shape)]
            if any(h > l_ and (l_ < s.start or h > s.stop)
                   for l_, h, s in zip(lo, hi, ix)):
                raise ValueError(f"shard {p} does not hold its {layout} "
                                 "tile")
            full = tuple(w[1] - w[0] for w in want[p])
            part = b[tuple(slice(max(l_ - s.start, 0),
                                 max(h - s.start, 0))
                           for l_, h, s in zip(lo, hi, ix))]
            if tuple(part.shape) == full:
                return part.to(dev).contiguous()
            t = torch.full(full, pad_value, dtype=b.dtype, device=dev)
            t[tuple(slice(0, k) for k in part.shape)].copy_(part)
            return t
        return self._each(tile)

    def _a2a(self, tiles, split, concat, axis):
        """One tiled all-to-all over mesh axis ``axis`` ('y' or 'x'):
        each position splits its tile along dim ``split`` into as many
        parts as the axis has positions and sends part j to position j of
        its row or column, which concatenates what it receives along dim
        ``concat`` in source order.  Over an axis of one position every
        tile is its own result, handed through with no copy.  The list
        ``tiles`` is consumed: a row's or a column's positions make their
        results at once, and its tiles leave the list once every result
        is made, so that the sources and the results of a whole mesh are
        never alive at once and no source is let go while another
        position's stream still reads it."""
        my, mx = self.grid
        m = my if axis == "y" else mx
        self._count("all_to_alls")
        if m == 1:
            return list(tiles)
        out = [None] * len(tiles)
        for g in range(mx if axis == "y" else my):
            # the positions of column g ('y') or of row g ('x'), in order
            group = [j * mx + g if axis == "y" else g * mx + j
                     for j in range(m)]

            def receive(p, group=group):
                me = group.index(p)
                t = tiles[p]
                part = t.shape[split] // m
                shape = list(t.shape)
                shape[split] = part
                shape[concat] = t.shape[concat] * m
                dst = torch.empty(shape, dtype=t.dtype, device=t.device)
                for j, q in enumerate(group):
                    src = tiles[q].narrow(split, me * part, part)
                    dst.narrow(concat, j * t.shape[concat],
                               t.shape[concat]).copy_(src)
                return dst
            for p, dst in zip(group, self._each(receive, group)):
                out[p] = dst
            for q in group:
                tiles[q] = None
        return out

    def _spectral_tiles(self, tiles):
        """Aligned spatial tiles (C_p, py, px) -> aligned spectral blocks
        (C_p/n, ny_p, nx_p): the 'y' all-to-all, then the 'x' one."""
        return self._a2a(self._a2a(tiles, 0, 1, "y"), 0, 2, "x")

    def _spatial_tiles(self, blocks):
        """The inverse: 'x' undone first, then 'y'."""
        return self._a2a(self._a2a(blocks, 2, 0, "x"), 1, 0, "y")

    def _a2a_spatial_to_spectral(self, array):
        """[spec local, y/my, x/mx] -> [spec/(my*mx), y, x] through two
        all-to-alls, padded to aligned tiles and cut back after."""
        blocks = self._spectral_tiles(
            self._tile(array, "spatial", 0, self.n_devices))
        return self._from_spectral(blocks, array.shape)

    def _a2a_spectral_to_spatial(self, array):
        """[spec/(my*mx), y, x] -> [spec local, y/my, x/mx]."""
        tiles = self._spatial_tiles(self._tile(array, "spectral", 0))
        return self._from_spatial(tiles, array.shape)

    def _from_spectral(self, blocks, shape):
        """A spectral-layout ShardedArray of ``shape`` from aligned blocks
        (C_p/n, >= ny, >= nx): each cut to its channels and the plane."""
        nchan, ny, nx = shape
        cb = blocks[0].shape[0]
        index, out = [], []
        for p, b in enumerate(blocks):
            c0, c1 = min(p * cb, nchan), min((p + 1) * cb, nchan)
            index.append((slice(c0, c1), slice(0, ny), slice(0, nx)))
            out.append(b[:c1 - c0, :ny, :nx])      # a view: nothing queued
        return ShardedArray(self, "spectral", shape, out, index)

    def _from_spatial(self, tiles, shape):
        """A spatial-layout ShardedArray of ``shape`` from aligned tiles
        (>= nchan, py, px): each cut to the channels and to its part of
        the plane (the last tile of an unaligned axis is ragged)."""
        return ShardedArray(self, "spatial", shape,
                            *self._cut_tiles(tiles, shape))

    def _cut_tiles(self, tiles, shape):
        """(blocks, index) of aligned (..., py, px) tiles cut to ``shape``
        (trailing two dims spatial)."""
        my, mx = self.grid
        lead, (ny, nx) = tuple(shape[:-2]), tuple(shape[-2:])
        py, px = tiles[0].shape[-2:]
        blocks, index = [], []
        for p, t in enumerate(tiles):
            iy, ix = divmod(p, mx)
            y0, y1 = min(iy * py, ny), min((iy + 1) * py, ny)
            x0, x1 = min(ix * px, nx), min((ix + 1) * px, nx)
            cut = tuple(slice(0, n_) for n_ in lead)
            # a view: nothing queued on any stream
            blocks.append(t[cut + (slice(0, y1 - y0), slice(0, x1 - x0))])
            index.append(tuple(slice(0, n_) for n_ in lead)
                         + (slice(y0, y1), slice(x0, x1)))
        return blocks, index

    def __repr__(self):
        return f"CubeMesh(grid={self.grid}, devices={self.n_devices})"
