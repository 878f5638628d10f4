"""Torch port, the mesh's positions at once (``CubeMesh._each``): one
worker thread per position, as ``shard_map`` runs its devices.

The executor's contract on the CPU: results in position order, whatever
finished first; an exception in a position reaches the caller once every
position has stopped (the first in position order); the caller's
TorchFunctionMode stack (``with torch.device(...)`` and
``tests/torch_vdev.py``'s virtual devices among its modes), grad mode,
inference mode and context variables (numpy's ``errstate``) hold inside
every worker; the per-position work of a sharded ``run_pipeline`` runs on
the workers, one a position.  Then the results and the counts: a 2x4
sharded ``run_pipeline`` repeated 20 times with a short switch interval,
each repeat's launch counts and mesh counters and values those of the
same call run in turn; and a host-side delay probe (each worker sleeps a
random time before its work) on the halo and reshard routes, the lane
bisection, the order statistics and the spline route: bit for bit the
undelayed and the in-turn results, within the sharded pipeline's
tolerances of the unsharded call and of the JAX package's sharded
pipeline.  The faults of shared state under concurrent workers (F37,
F38) are pinned in ``tests/test_torch_mesh_concurrent_faults.py``.
"""

import functools
import random
import sys
import threading
import time
import warnings

import numpy as np
import jax
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import spectral_cube_tpu as J
from spectral_cube_tpu import parallel as jpar
from spectral_cube_tpu.io import streaming as jstream

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import kernels as K
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch.io import streaming as tstream
from spectral_cube_tpu_torch.kernels import (_build, banded_matmul as kbm,
                                             conv_sep as kconv,
                                             moments as kmom,
                                             resample2 as kres,
                                             sigma_clip as ksig,
                                             smooth_interp as ksi)
from spectral_cube_tpu_torch.parallel import mesh as tmesh

import chip_smoke as cs
from conftest import HDU, base_header, write_fits
from torch_vdev import device_of, vdev, virtual_devices

pytestmark = pytest.mark.filterwarnings("ignore::Warning")

SHAPE = (20, 32, 40)
#: the sharded pipeline's tolerances against the JAX package's
#: (tests/test_torch_streaming.py's, as tests/test_torch_mesh_distinct_
#: pipeline.py holds them): moments (mom0, mom1, linewidth), statistics
MOMENTS = [(3e-5, 1e-6), (3e-5, 1e-4), (1e-4, 1e-4)]
STATISTICS = (2e-5, 1e-7)
#: each kernel wrapper and the plain version its CPU path calls
PLAIN = [(kmom, "moments_planes_plain", "moments_planes"),
         (kconv, "conv_sep_plain", "conv_sep"),
         (kres, "resample2_plain", "resample2"),
         (kres, "resample2_filled_plain", "resample2_filled"),
         (ksig, "sigma_clip_plain", "sigma_clip"),
         (ksi, "smooth_interp_plain", "smooth_interp"),
         (kbm, "banded_matmul_plain", "banded_matmul")]


def in_turn(self, fn, positions=None, one_a_device=False):
    """The executor as the positions ran before it: one after another in
    the calling thread."""
    return [fn(p) for p in (range(self.n_devices) if positions is None
                            else positions)]


@pytest.fixture(scope="module")
def pipe_file(tmp_path_factory):
    """A single-beam cube with a NaN border (the distinct-mesh pipeline
    tests' cube)."""
    d = tmp_path_factory.mktemp("concurrent")
    rng = np.random.RandomState(7)
    data = rng.randn(*SHAPE) * 0.1 + 1.5 * np.exp(-0.5 * ((np.arange(
        SHAPE[0]) - 10) / 2.0) ** 2)[:, None, None]
    data[:, :2, :] = np.nan
    h = base_header(nx=SHAPE[2], ny=SHAPE[1], nchan=SHAPE[0])
    h["BMAJ"], h["BMIN"], h["BPA"] = 6.0 / 3600, 4.5 / 3600, 30.0
    h["CDELT1"], h["CDELT2"] = -2.0 / 3600, 2.0 / 3600
    path = str(d / "pipe.fits")
    write_fits(path, [HDU(data=data, header=h)])
    return path


def _shifted(h):
    t = h.__class__(h)
    t["CRPIX1"] = float(t["CRPIX1"]) + 0.37
    t["CRPIX2"] = float(t["CRPIX2"]) - 0.61
    return t


def _beam(P):
    return P.Beam(P.Quantity(12.0, "arcsec"), P.Quantity(12.0, "arcsec"),
                  0.0)


def _pipeline(path, cmesh, target=_shifted):
    sc = tstream.read_sharded_cube(path, cmesh)
    return T.run_pipeline(sc, cmesh, snr_threshold=3.0, target_beam=_beam(T),
                          target_header=target(sc.header))


def _mesh(grid=(2, 4)):
    return tpar.CubeMesh(devices=["cpu"] * (grid[0] * grid[1]), shape=grid)


@pytest.fixture
def counting(monkeypatch):
    """Each kernel wrapper's plain version counts a launch for its
    wrapper, as the kernel does on the card (``_build.count_launch``)."""
    for mod, plain, wrapper in PLAIN:
        fn = getattr(mod, plain)

        @functools.wraps(fn)
        def counted(*args, _fn=fn, _w=getattr(mod, wrapper), **kwargs):
            _build.count_launch(_w)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, plain, counted)
    K.reset_launch_counts()
    yield
    K.reset_launch_counts()


@pytest.fixture
def short_switches():
    """A short switch interval, restored after: the threads interleave
    between far fewer bytecodes."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


# -- the executor ------------------------------------------------------------
@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (2, 4)])
def test_results_come_back_in_position_order(grid):
    """The last position finishes first; the results are in position
    order, each made on its own worker thread."""
    cmesh = _mesh(grid)
    n = cmesh.n_devices

    def work(p):
        time.sleep(0.02 * (n - p))
        return p * 10, threading.current_thread().name
    out = cmesh._each(work)
    assert [v for v, _ in out] == [p * 10 for p in range(n)]
    names = [name for _, name in out]
    assert len(set(names)) == n
    assert names == [f"mesh-position-{p}" for p in range(n)]
    assert cmesh._each(lambda p: -p, [3, 1] if n > 3 else [1, 0]) == (
        [-3, -1] if n > 3 else [-1, 0])


def test_an_exception_is_raised_once_every_position_has_stopped():
    """Positions 1 and 3 raise, 3 first; the others sleep before they
    finish.  The caller gets position 1's error, and only once every
    other position has finished; the mesh runs again after."""
    cmesh = _mesh((2, 2))
    done = {}

    def work(p):
        if p == 3:
            raise KeyError("position 3")
        if p == 1:
            time.sleep(0.05)
            raise ValueError("position 1")
        time.sleep(0.2)
        done[p] = time.perf_counter()
    with pytest.raises(ValueError, match="position 1"):
        cmesh._each(work)
    raised = time.perf_counter()
    assert sorted(done) == [0, 2]
    assert all(t <= raised for t in done.values())
    assert cmesh._each(lambda p: p) == [0, 1, 2, 3]


def test_one_a_device_runs_a_devices_positions_in_turn():
    """``one_a_device``: the positions that share a device run one after
    another on the first one's worker, the devices at once (an order
    statistic's sorts: one card holds one position's at a time); the
    results still in position order."""
    cmesh = tpar.CubeMesh(devices=[vdev(1), vdev(1), vdev(2), vdev(2)],
                          shape=(2, 2))
    spans = {}

    def work(p):
        t0 = time.perf_counter()
        time.sleep(0.05)
        spans[p] = (t0, time.perf_counter(),
                    threading.current_thread().name)
        return p
    assert cmesh._each(work, one_a_device=True) == [0, 1, 2, 3]
    assert [spans[p][2] for p in range(4)] == [
        "mesh-position-0", "mesh-position-0", "mesh-position-2",
        "mesh-position-2"]
    for a, b in ((0, 1), (2, 3)):          # one device: one after another
        assert spans[a][1] <= spans[b][0]
    assert spans[0][0] < spans[2][1] and spans[2][0] < spans[0][1]
    assert cmesh._each(work) == [0, 1, 2, 3]
    assert len({spans[p][2] for p in range(4)}) == 4


def test_the_workers_end_with_their_mesh():
    """A mesh's workers start at its first call and end once the mesh is
    gone."""
    import gc
    cmesh = _mesh((2, 2))
    assert cmesh._each(lambda p: p) == [0, 1, 2, 3]
    workers = list(cmesh._workers)
    assert all(w.is_alive() for w in workers)
    del cmesh
    gc.collect()
    for w in workers:
        w.join(10)
    assert not any(w.is_alive() for w in workers)


class _Seen(TorchFunctionMode):
    """Records the thread of every torch function it sees."""

    def __init__(self):
        super().__init__()
        self.threads = set()
        self.lock = threading.Lock()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        with self.lock:
            self.threads.add(threading.current_thread().name)
        return func(*args, **(kwargs or {}))


class _SeenDispatch(TorchDispatchMode):
    """Records the thread of every operator it sees."""

    def __init__(self):
        super().__init__()
        self.threads = set()
        self.lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        with self.lock:
            self.threads.add(threading.current_thread().name)
        return func(*args, **(kwargs or {}))


def _state():
    """What a worker sees: its mode stack's length, where a factory puts
    its tensor, grad and inference mode."""
    return (torch._C._len_torch_function_stack(), torch.empty(2).device.type,
            torch.is_grad_enabled(), torch.is_inference_mode_enabled())


@pytest.mark.parametrize("state", ["function mode", "dispatch mode",
                                   "device", "no_grad", "inference_mode",
                                   "errstate"])
def test_the_callers_state_holds_inside_the_workers(state):
    """The caller's thread-local state reaches every worker, as it holds
    in an in-turn call: a TorchFunctionMode sees the workers' ops, ``with
    torch.device('meta')`` places their factories' tensors (the probe:
    in a bare thread ``torch.empty(2)`` lands on the host), no_grad and
    inference mode hold, numpy's errstate silences an invalid sqrt; a
    TorchDispatchMode (a sanitizer's) sees their operators.  Left,
    the workers are back to their own state."""
    cmesh = _mesh((2, 2))
    clean = [(0, "cpu", True, False)] * 4
    assert cmesh._each(lambda p: _state()) == clean
    if state == "function mode":
        mode = _Seen()
        with mode:
            out = cmesh._each(lambda p: _state())
            cmesh._each(lambda p: torch.ones(2) + p)
        assert out == [(1, "cpu", True, False)] * 4
        assert sum(name.startswith("mesh-position-")
                   for name in mode.threads) == 4
    elif state == "dispatch mode":
        mode = _SeenDispatch()
        with mode:
            cmesh._each(lambda p: torch.ones(2) + p)
        assert sum(name.startswith("mesh-position-")
                   for name in mode.threads) == 4
    elif state == "device":
        with torch.device("meta"):
            out = cmesh._each(lambda p: _state())
        assert [o[1] for o in out] == ["meta"] * 4
    elif state == "no_grad":
        with torch.no_grad():
            out = cmesh._each(lambda p: _state())
        assert [o[2] for o in out] == [False] * 4
    elif state == "inference_mode":
        with torch.inference_mode():
            out = cmesh._each(lambda p: (torch.ones(2) * p).is_inference())
        assert out == [True] * 4
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with np.errstate(invalid="ignore"):
                out = cmesh._each(lambda p: float(np.sqrt(np.float64(-p))))
        assert out[0] == 0.0 and all(np.isnan(out[1:]))
    assert cmesh._each(lambda p: _state()) == clean


def test_virtual_devices_act_inside_the_workers():
    """``tests/torch_vdev.py``'s mode holds in every worker: a factory
    places its tensor on the virtual device asked for, an op over two
    virtual devices' tensors raises there (and reaches the caller), and
    a mesh of distinct virtual devices places and gathers its blocks."""
    cmesh = tpar.CubeMesh(devices=[vdev(k) for k in range(1, 5)],
                          shape=(2, 2))
    a = np.arange(2 * 4 * 6, dtype=np.float32).reshape(2, 4, 6)
    with virtual_devices() as vd:
        assert cmesh._each(lambda p: torch.zeros(2, device=vdev(p + 1))
                           .device) == [vdev(k) for k in range(1, 5)]
        x, y = torch.ones(2, device=vdev(1)), torch.ones(2, device=vdev(2))
        with pytest.raises(RuntimeError, match="devices"):
            cmesh._each(lambda p: x + y if p == 2 else x)
        sa = cmesh.shard(a)
        assert [device_of(b) for b in sa.blocks] == [vdev(k)
                                                     for k in range(1, 5)]
        back = sa.gather(torch.device("cpu"))
        assert vd.counts["moves"] >= 8
    assert np.array_equal(back.numpy(), a)


def test_the_positions_run_on_their_workers(pipe_file, monkeypatch):
    """A 2x4 sharded ``run_pipeline``: every launch of moments, conv_sep
    and resample2 (their plain versions here) runs on a position's
    worker, the eight workers each launching."""
    seen = {}
    lock = threading.Lock()
    for mod, plain, wrapper in PLAIN[:3]:
        fn = getattr(mod, plain)

        @functools.wraps(fn)
        def where(*args, _fn=fn, _w=wrapper, **kwargs):
            with lock:
                seen.setdefault(_w, []).append(
                    threading.current_thread().name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, plain, where)
    _pipeline(pipe_file, _mesh())
    assert set(seen) == {"moments_planes", "conv_sep", "resample2"}
    for names in seen.values():
        assert all(n.startswith("mesh-position-") for n in names)
        assert len(set(names)) == 8


# -- the counts and the values -----------------------------------------------
def _counted(fn, cmesh):
    K.reset_launch_counts()
    cmesh.reset_counters()
    val = fn()
    return (cs.host_values(val),
            {k: v for k, v in K.launch_counts().items() if v},
            dict(cmesh.counters))


def test_counts_are_exact_over_repeats(pipe_file, counting, short_switches,
                                       monkeypatch):
    """A 2x4 sharded ``run_pipeline``, 20 times at once on the workers
    with a short switch interval: each repeat's launch counts, mesh
    counters and values those of the call run in turn."""
    cmesh = _mesh()
    with monkeypatch.context() as m:
        m.setattr(tmesh.CubeMesh, "_each", in_turn)
        want, want_launches, want_counters = _counted(
            lambda: _pipeline(pipe_file, cmesh), cmesh)
    assert want_launches["moments"] == 16 and want_launches["conv_sep"] == 8
    assert want_counters["halo_exchanges"] > 0 \
        and want_counters["gathers"] == 0
    for rep in range(20):
        got, launches, counters = _counted(
            lambda: _pipeline(pipe_file, cmesh), cmesh)
        assert launches == want_launches, rep
        assert counters == want_counters, rep
        cs.hold_values(f"repeat {rep}", got, want, (0.0, 0.0))


def _rotated(h):
    return cs.rotated_header(h, 3.0)


#: the calls of the delay probe: the halo route, the reshard
#: reprojection (all-to-alls), the lane bisection and a tuple reduction,
#: the whole-cube order statistic and the spline route
DELAYED = {
    "halo pipeline": lambda path, m: _pipeline(path, m),
    "rotated pipeline": lambda path, m: _pipeline(path, m, _rotated),
    "median(axis=(0, 1))": lambda path, m: tstream.read_sharded_cube(
        path, m).median(axis=(0, 1)),
    "std(axis=(1, 2))": lambda path, m: tstream.read_sharded_cube(
        path, m).std(axis=(1, 2)),
    "mad_std": lambda path, m: tstream.read_sharded_cube(path, m).mad_std(),
    "bicubic reproject": lambda path, m: (lambda sc: sc.reproject(
        _shifted(sc.header), order="bicubic"))(
            tstream.read_sharded_cube(path, m)),
}


@pytest.mark.parametrize("case", list(DELAYED))
def test_a_host_delay_probe_changes_no_bit(pipe_file, case, monkeypatch):
    """Each worker sleeps a random time (up to 3 ms) before its work, so
    the positions finish in another order each call: the results bit for
    bit the undelayed ones and the in-turn ones, the counters equal; the
    pipelines within the sharded pipeline's tolerances of the unsharded
    call (``chip_smoke.hold_pipeline``)."""
    cmesh = _mesh()
    fn = DELAYED[case]
    with monkeypatch.context() as m:
        m.setattr(tmesh.CubeMesh, "_each", in_turn)
        turn, _, turn_counters = _counted(lambda: fn(pipe_file, cmesh),
                                          cmesh)
    plain, _, counters = _counted(lambda: fn(pipe_file, cmesh), cmesh)
    call = tmesh.CubeMesh._call
    rng = random.Random(5)
    lock = threading.Lock()

    def delayed(self, p, *args):
        with lock:
            wait = rng.uniform(0.0, 3e-3)
        time.sleep(wait)
        return call(self, p, *args)
    monkeypatch.setattr(tmesh.CubeMesh, "_call", delayed)
    value = fn(pipe_file, cmesh)
    got = cs.host_values(value)
    cs.hold_values(f"{case} delayed", got, plain, (0.0, 0.0))
    cs.hold_values(f"{case} in turn", plain, turn, (0.0, 0.0))
    assert counters == turn_counters
    if case.endswith("pipeline"):
        target = _rotated if case.startswith("rotated") else _shifted
        cube = T.SpectralCube.read(pipe_file, device="cpu")
        ref = T.run_pipeline(cube, snr_threshold=3.0, target_beam=_beam(T),
                             target_header=target(cube.header))
        cs.hold_pipeline(case, value, ref)


def test_the_delayed_pipeline_holds_against_the_jax_package(pipe_file,
                                                            monkeypatch):
    """The halo pipeline on the 2x4 mesh under the delay probe against
    the JAX package's sharded pipeline on its 2x4 mesh, at the sharded
    pipeline's tolerances."""
    if len(jax.devices()) != 8:
        pytest.skip("the JAX side needs the 8-device virtual mesh")
    call = tmesh.CubeMesh._call
    rng = random.Random(11)
    lock = threading.Lock()

    def delayed(self, p, *args):
        with lock:
            wait = rng.uniform(0.0, 3e-3)
        time.sleep(wait)
        return call(self, p, *args)
    monkeypatch.setattr(tmesh.CubeMesh, "_call", delayed)
    res = _pipeline(pipe_file, _mesh())
    jm = jpar.CubeMesh(devices=jax.devices(), shape=(2, 4))
    jc = jstream.read_sharded_cube(pipe_file, jm, dtype=np.float32)
    want = J.run_pipeline(jc, jm, snr_threshold=3.0, target_beam=_beam(J),
                          target_header=_shifted(jc.header))
    for got, ref, (rtol, atol) in zip(res["moments"], want["moments"],
                                      MOMENTS):
        g, r = np.asarray(got.value), np.asarray(ref.value)
        assert np.array_equal(np.isnan(g), np.isnan(r))
        fin = ~np.isnan(r)
        np.testing.assert_allclose(g[fin], r[fin], rtol=rtol, atol=atol)
    for key in ("npts", "mean", "sigma", "sum", "max", "min"):
        np.testing.assert_allclose(
            float(getattr(res["statistics"][key], "value",
                          res["statistics"][key])),
            float(getattr(want["statistics"][key], "value",
                          want["statistics"][key])),
            rtol=STATISTICS[0], atol=STATISTICS[1])


# -- the card phase's probes, rehearsed ----------------------------------------
def test_the_stream_delay_probe_queues_a_sleep_a_position(monkeypatch):
    """``chip_smoke.stream_delays`` wraps the executor's fork: after the
    fork each CUDA position's stream gets (p + 1) units of sleep, host
    positions none, and the fork is the executor's own again after the
    block.  (The streams here are stand-ins: this build has no CUDA.)"""
    cmesh = _mesh((2, 2))
    fork = tmesh.CubeMesh._fork
    slept, entered = [], []
    monkeypatch.setattr(tmesh.CubeMesh, "_fork",
                        lambda self, positions: {})
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: slept.append(
        (entered[-1], n)))

    class Stream:
        def __init__(self, p):
            self.p = p

    class Entered:
        def __init__(self, s):
            entered.append(s.p)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.cuda, "stream", Entered)
    cmesh._each(lambda p: p)
    cmesh._streams = [Stream(0), None, Stream(2), None]
    with cs.stream_delays(cycles=10) as queued:
        cmesh._fork([0, 1, 2, 3])
    assert slept == [(0, 10), (2, 30)] and queued == {"delays": 2}
    assert tmesh.CubeMesh._fork is not fork   # the test's stand-in again
    monkeypatch.undo()
    assert tmesh.CubeMesh._fork is fork


def test_a_trace_counts_kernels_overlapping_on_two_streams():
    """``profiling.device_summary`` on hand-made events: kernels on three
    streams, two pairs of them overlapping across streams (a pair on one
    stream does not count), the busy time their union."""
    from spectral_cube_tpu_torch import profiling
    mark = {"ph": "X", "cat": "user_annotation", "name": profiling.WINDOW,
            "ts": 0.0, "dur": 100.0}

    def kernel(ts, dur, stream):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                "dur": dur, "tid": stream,
                "args": {"device": 0, "stream": stream}}
    events = [mark, kernel(0, 30, 7), kernel(10, 30, 13), kernel(20, 5, 7),
              kernel(50, 10, 7), kernel(61, 10, 21)]
    s = profiling.device_summary(events)
    assert s["streams"] == 3
    assert s["overlapping_kernel_pairs"] == 2
    assert s["busy_ms"] == pytest.approx((40 + 10 + 10) / 1e3)
    assert profiling._overlapping_pairs([(0, 1, 1), (1, 2, 2)]) == 0


def test_the_concurrent_phase_reruns_both_phases_under_the_probe(
        monkeypatch, tmp_path):
    """``chip_smoke.phase_concurrent`` runs the sharded phase (untraced)
    and the distinct-mesh phase inside the stream-delay probe, then the
    sanitizer's child, and reports them on one summary line.  (The
    phases and the child are stand-ins here: they need the card.)"""
    seen = []
    probe = {}

    def sharded(dev, workdir, traced=True):
        probe["sharded"] = tmesh.CubeMesh._fork is not fork
        seen.append(("sharded", traced))

    def distinct(dev, workdir):
        probe["distinct"] = tmesh.CubeMesh._fork is not fork
        seen.append(("distinct",))
        return "summary: distinct mesh"
    fork = tmesh.CubeMesh._fork
    monkeypatch.setattr(cs, "phase_sharded", sharded)
    monkeypatch.setattr(cs, "phase_distinct_mesh", distinct)
    monkeypatch.setattr(cs, "sanitizer_start", lambda workdir: "no race")
    line = cs.phase_concurrent(torch.device("cpu"), str(tmp_path))
    assert seen == [("sharded", False), ("distinct",)]
    assert probe == {"sharded": True, "distinct": True}
    assert tmesh.CubeMesh._fork is fork
    assert line.startswith("summary: concurrent positions")
    assert line.endswith(": no race")
