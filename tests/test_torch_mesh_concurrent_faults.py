"""Torch port, shared state under a mesh's concurrent workers: the faults
the positions running at once showed (ROADMAP Queue 3, F37 and F38) and
the guards of the state they share.

- F37: ``utils.ieee_fp32`` saved and restored the process-wide TF32 flags
  in each block, so one worker leaving its block turned TF32 back on in
  the middle of another worker's.
- F38: ``ops/interpolate._si_operators`` summed its cache's sizes while
  another worker cleared or filled it ("dictionary changed size during
  iteration").
- The launch counts, the mesh counters and the memoized methods
  (``utils.cached``) count and store exactly under many threads; the
  device caches of the kernels (``kernels/_build.stream_cached``) hold an
  entry per stream, so that no stream reads an upload queued on another;
  the host operator cache of the spline path takes concurrent callers;
  the tap plans that the positions of one card share are made in the
  calling thread, before the positions start.
"""

import sys
import threading
import types
from collections import OrderedDict

import numpy as np
import pytest
import torch

from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch import utils as tutils
from spectral_cube_tpu_torch.kernels import _build, moments as kmom
from spectral_cube_tpu_torch.ops import interpolate as tinterp
from spectral_cube_tpu_torch.ops import regrid as tregrid

pytestmark = pytest.mark.filterwarnings("ignore::Warning")


@pytest.fixture
def short_switches():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run(threads, timeout=60):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_f37_ieee_fp32_keeps_tf32_off_while_any_thread_is_inside(tf32_on):
    """Thread a enters, thread b enters, a leaves while b is inside: b
    still sees both flags off, and the flags come back on only when b has
    left (F37: a's exit restored them under b)."""
    a_in, b_in, a_out = threading.Event(), threading.Event(), \
        threading.Event()
    seen = {}

    def a():
        with tutils.ieee_fp32():
            seen["a inside"] = _tf32()
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with tutils.ieee_fp32():
            b_in.set()
            a_out.wait(10)
            seen["b after a left"] = _tf32()
        seen["b left"] = _tf32()
    _run([threading.Thread(target=a), threading.Thread(target=b)])
    assert seen == {"a inside": (False, False),
                    "b after a left": (False, False),
                    "b left": (True, True)}


def test_ieee_fp32_in_every_position_at_once(tf32_on, short_switches):
    """Eight positions enter and leave the block at once, many times:
    every body sees TF32 off, and it is on again after."""
    cmesh = tpar.CubeMesh(devices=["cpu"] * 8)

    def body(p):
        seen = set()
        for _ in range(200):
            with tutils.ieee_fp32():
                seen.add(_tf32())
        return seen
    assert cmesh._each(body) == [{(False, False)}] * 8
    assert _tf32() == (True, True)


def test_f38_the_smooth_interp_operators_take_concurrent_callers(
        short_switches, monkeypatch):
    """Eight threads ask ``_si_operators`` for operators of 13 kernels,
    more than the cache keeps, so that it clears and fills while others
    read it (F38: ``RuntimeError: dictionary changed size during
    iteration``); each answer is the one-thread answer."""
    monkeypatch.setattr(tinterp, "_SI_OP_CACHE", {})
    idx, frac = np.arange(8, dtype=np.int64), np.full(8, 0.25)

    def kernel(j):
        return np.array([0.25, 0.5, 0.25]) * (1 + 1e-3 * j)
    want = {j: tinterp._si_operators(kernel(j), idx, frac, 20)[2]
            for j in range(13)}
    errors, wrong = [], []

    def ask(k):
        try:
            for i in range(40):
                j = (k * 31 + i) % 13
                got = tinterp._si_operators(kernel(j), idx, frac, 20)[2]
                if not np.array_equal(got, want[j]):
                    wrong.append(j)
        except RuntimeError as exc:
            errors.append(repr(exc))
    _run([threading.Thread(target=ask, args=(k,)) for k in range(8)])
    assert errors == [] and wrong == []


def test_the_spline_operator_cache_takes_concurrent_callers(
        short_switches, monkeypatch):
    """Eight threads through ``_spline_cached`` over 40 keys, more than it
    keeps: no lookup fails, each answer its key's."""
    monkeypatch.setattr(tregrid, "_SPLINE_OPS", OrderedDict())
    errors, wrong = [], []

    def ask(k):
        try:
            for i in range(2000):
                key = ("test", (k * 7 + i) % 40)
                if tregrid._spline_cached(key, lambda: key) != key:
                    wrong.append(key)
        except KeyError as exc:
            errors.append(repr(exc))
    _run([threading.Thread(target=ask, args=(k,)) for k in range(8)])
    assert errors == [] and wrong == []
    assert len(tregrid._SPLINE_OPS) <= tregrid._SPLINE_OPS_SIZE


def test_launch_counts_and_mesh_counters_are_exact(short_switches):
    """Eight workers count launches and mesh exchanges at once: nothing
    is lost."""
    wrapper = kmom.moments_planes
    before = wrapper.launches
    cmesh = tpar.CubeMesh(devices=["cpu"] * 8)

    def count(p):
        for _ in range(5000):
            _build.count_launch(wrapper)
            cmesh._count("halo_exchanges")
    try:
        cmesh._each(count)
        assert wrapper.launches - before == 8 * 5000
        assert cmesh.counters["halo_exchanges"] == 8 * 5000
    finally:
        wrapper.launches = before


def test_a_memoized_method_stores_one_value(short_switches):
    """Threads that call a ``utils.cached`` method at once on a new object
    all get the value stored first."""
    class Thing:
        made = 0

        @tutils.cached
        def value(self):
            Thing.made += 1
            return object()
    for _ in range(20):
        thing = Thing()
        got = []
        _run([threading.Thread(target=lambda: got.append(thing.value()))
              for _ in range(8)])
        assert len({id(g) for g in got}) == 1
        assert thing.value() is got[0]


def test_the_device_caches_hold_an_entry_per_stream(monkeypatch):
    """``stream_cached`` keys each entry by the device's current stream:
    the same key on another stream makes its own entry (its upload queued
    on that stream), the same stream finds it; the least recently used
    entry goes first."""
    current = {"stream": 7}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=current["stream"]))
    cache, made = OrderedDict(), []

    def make(tag):
        def _make():
            made.append(tag)
            return tag
        return _make
    dev = torch.device("cuda", 0)
    assert _build.stream_cached(cache, 2, ("k",), dev, make("a")) == "a"
    assert _build.stream_cached(cache, 2, ("k",), dev, make("b")) == "a"
    current["stream"] = 9
    assert _build.stream_cached(cache, 2, ("k",), dev, make("c")) == "c"
    assert made == ["a", "c"] and list(cache) == [(7, "k"), (9, "k")]
    current["stream"] = 7
    _build.stream_cached(cache, 2, ("k",), dev, make("d"))
    _build.stream_cached(cache, 2, ("j",), dev, make("e"))
    assert list(cache) == [(7, "k"), (7, "j")]


def test_the_tap_plans_are_made_before_the_positions_start(monkeypatch):
    """The reshard reprojection's corner taps and the spline path's tap
    plan, one a device, which the positions of a card read on their own
    streams, are made in the calling thread before the positions start,
    never on a position's worker (and its stream)."""
    from spectral_cube_tpu_torch.parallel import sharded as tsh
    threads = []
    for name in ("_corner_taps", "spline_taps"):
        fn = getattr(tregrid, name)

        def where(*args, _fn=fn, **kwargs):
            threads.append(threading.current_thread().name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(tregrid, name, where)
    cmesh = tpar.CubeMesh(devices=["cpu"] * 4, shape=(2, 2))
    rng = np.random.RandomState(3)
    data = rng.randn(8, 16, 16).astype(np.float32)
    zs = np.arange(8, dtype=np.float64)
    ang = np.deg2rad(3.0)
    yy, xx = np.mgrid[0:16, 0:16].astype(np.float64)
    ys = np.cos(ang) * (yy - 7.5) - np.sin(ang) * (xx - 7.5) + 7.5
    xs = np.sin(ang) * (yy - 7.5) + np.cos(ang) * (xx - 7.5) + 7.5
    tsh.sharded_reproject(data, zs, ys, xs, cmesh, order=1)
    tsh.sharded_spline_reproject(data, zs, ys, xs, cmesh, order=3)
    assert threads and all(not t.startswith("mesh-position-")
                           for t in threads)
