"""Torch port, the program's own spans (``profiling.span`` and
``profiling.spanned``), on the CPU.

With no profiler recording, a span is one shared context that calls
nothing: a ``record_function`` that raises is never reached, and the
results are the same bits with a profiler recording as without.  Under
``profiling.trace`` the pipeline (onto a translated and onto a rotated
target) and the spectral chain emit their ``sct.`` spans nested as the
layers are (entry, cube, ops, WCS, kernels), the reprojection's route span
naming the route its target takes.  ``device_summary`` reports each span's
calls, host, device and idle time and host waits, and each idle gap's
innermost span, on hand-made events.
"""

import warnings

import numpy as np
import pytest
import torch

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import profiling as P
from spectral_cube_tpu_torch.io.fits_low import Header
from spectral_cube_tpu_torch.kernels import WRAPPERS, _build
from spectral_cube_tpu_torch.ops import convolve as tconv
from spectral_cube_tpu_torch.ops import reductions as tred

SMOOTH = np.array([0.25, 0.5, 0.25])


def _header(nchan, ny, nx):
    h = Header()
    for key, value in (
            ("NAXIS", 3), ("NAXIS1", nx), ("NAXIS2", ny), ("NAXIS3", nchan),
            ("CTYPE1", "RA---SIN"), ("CRVAL1", 23.1837),
            ("CDELT1", -2.0 / 3600), ("CRPIX1", nx / 2), ("CUNIT1", "deg"),
            ("CTYPE2", "DEC--SIN"), ("CRVAL2", 30.5765),
            ("CDELT2", 2.0 / 3600), ("CRPIX2", ny / 2), ("CUNIT2", "deg"),
            ("CTYPE3", "VRAD"), ("CRVAL3", -321.2), ("CDELT3", 1.28),
            ("CRPIX3", 1.0), ("CUNIT3", "km/s"),
            ("RESTFRQ", 1.42040571841e9), ("SPECSYS", "BARYCENT"),
            ("BUNIT", "Jy/beam"), ("BMAJ", 6.0 / 3600),
            ("BMIN", 4.5 / 3600), ("BPA", 30.0)):
        h[key] = value
    return h


def _cube(shape=(16, 30, 36), seed=0):
    """A line on noise with a NaN border, read as a user's read gives it:
    the header's WCS and beam, a finiteness mask."""
    nchan, ny, nx = shape
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:ny, 0:nx]
    line = 3.0 * np.exp(-0.5 * ((np.arange(nchan) - nchan / 2) / 2.0) ** 2)
    data = (line[:, None, None] + rng.randn(nchan, ny, nx)).astype(
        np.float32)
    r2 = ((yy - ny / 2) / (0.48 * ny)) ** 2 + ((xx - nx / 2) / (0.48 * nx)) ** 2
    data[:, r2 > 1.0] = np.nan
    h = _header(nchan, ny, nx)
    t = torch.as_tensor(data)
    wcs = T.WCS(header=h)
    return T.SpectralCube(t, wcs, mask=T.LazyMask(torch.isfinite, data=t,
                                                  wcs=wcs),
                          meta={"BUNIT": "Jy/beam"}, header=h)


def _target(cube, rotated):
    h = Header(cube.header)
    h["CRPIX1"] = float(h["CRPIX1"]) + 0.37
    h["CRPIX2"] = float(h["CRPIX2"]) - 0.61
    if rotated:
        c, s = np.cos(np.deg2rad(3.0)), np.sin(np.deg2rad(3.0))
        h["PC1_1"], h["PC1_2"], h["PC2_1"], h["PC2_2"] = c, -s, s, c
    return h


def _pipeline(cube, rotated=False):
    beam = T.Beam(T.Quantity(12.0, "arcsec"), T.Quantity(10.0, "arcsec"),
                  T.Quantity(10.0, "deg"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return T.run_pipeline(cube, snr_threshold=1.0, target_beam=beam,
                              target_header=_target(cube, rotated))


def _spectral(cube):
    s = cube.spectral_smooth(SMOOTH)
    s = s.spectral_interpolate(s.spectral_axis[::2], smooth_kernel=SMOOTH)
    return s.sigma_clip_spectrally(1.0, maxiters=5)


def _arrays(res):
    out = [np.asarray(m.value) for m in res["moments"]]
    out += [np.float64(getattr(v, "value", v))
            for _, v in sorted(res["statistics"].items())]
    return out + [res["cube"]._data.numpy()]


def _nesting(events):
    """[(name, the innermost ``sct.`` span around it)] of the trace's
    ``sct.`` spans, in the order they open."""
    spans = sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(P.SPAN_PREFIX))
    out = []
    for i, (s, neg, name) in enumerate(spans):
        around = [n for s2, neg2, n in spans[:i] if s - neg <= s2 - neg2]
        out.append((name, around[-1] if around else None))
    return out


def test_a_span_with_no_profiler_records_nothing(monkeypatch):
    """Off, a span is one shared context and a spanned function is called
    straight: ``record_function`` is never reached, by any span of the
    pipeline or of the spectral chain."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert P.span("sct.a") is P.span("sct.b")
    with P.span("sct.a") as inside:
        assert inside is None
    assert P.spanned("sct.c")(lambda x, y=1: x + y)(2, y=3) == 5
    _pipeline(_cube())
    _spectral(_cube((40, 20, 24)))


@pytest.mark.parametrize("rotated", [False, True])
def test_spans_leave_the_pipeline_bit_for_bit(tmp_path, rotated):
    plain = _arrays(_pipeline(_cube(), rotated))
    with P.trace(str(tmp_path), device="cpu"):
        traced = _arrays(_pipeline(_cube(), rotated))
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


def test_spans_leave_the_spectral_chain_bit_for_bit(tmp_path):
    plain = _spectral(_cube((40, 20, 24)))._data.numpy()
    with P.trace(str(tmp_path), device="cpu"):
        traced = _spectral(_cube((40, 20, 24)))._data.numpy()
    np.testing.assert_array_equal(plain, traced)


#: (span, its parent) that the pipeline's trace holds on every target
PIPELINE = {
    ("sct.pipeline", None),
    ("sct.cube.convolve_to", "sct.pipeline"),
    ("sct.cube.filled", "sct.cube.convolve_to"),
    ("sct.convolve.setup", "sct.cube.convolve_to"),
    ("sct.convolve.separable", "sct.cube.convolve_to"),
    ("sct.kernels.conv_sep", "sct.convolve.separable"),
    ("sct.cube.init", "sct.cube.convolve_to"),
    ("sct.cube.mad_std", "sct.pipeline"),
    ("sct.reductions.mad_std", "sct.cube.mad_std"),
    ("sct.reductions.select", "sct.reductions.mad_std"),
    ("sct.cube.with_mask", "sct.pipeline"),
    ("sct.cube.init", "sct.cube.with_mask"),
    ("sct.cube.moments012", "sct.pipeline"),
    ("sct.kernels.moments", "sct.cube.moments012"),
    ("sct.cube.statistics", "sct.pipeline"),
    ("sct.kernels.moments", "sct.cube.statistics"),
    ("sct.cube.reproject", "sct.pipeline"),
    ("sct.cube.filled", "sct.cube.reproject"),
    ("sct.regrid.maps", "sct.cube.reproject"),
    ("sct.wcs.init", "sct.regrid.maps"),
    ("sct.regrid.host_maps", "sct.cube.reproject"),
    ("sct.cube.init", "sct.cube.reproject"),
}


@pytest.mark.parametrize("rotated,route", [
    (False, {("sct.regrid.resample2", "sct.cube.reproject"),
             ("sct.kernels.resample2", "sct.regrid.resample2")}),
    (True, {("sct.regrid.gather", "sct.cube.reproject")})])
def test_pipeline_spans_nest_as_the_layers(tmp_path, monkeypatch, rotated,
                                           route):
    """Every boundary of the pipeline opens its span inside its caller's,
    the reprojection's route span names the route the target takes, and
    the order statistics past ``SORT_CHUNK`` open ``select`` (the whole
    cube's path at the card's size, here at 2**12 voxels)."""
    monkeypatch.setattr(tred, "SORT_CHUNK", 1 << 12)
    monkeypatch.setattr(tred, "SORT_PIECE", 1 << 11)
    cube = _cube()
    with P.trace(str(tmp_path), device="cpu"):
        _pipeline(cube, rotated)
    nested = _nesting(P.trace.last.events)
    assert set(nested) == PIPELINE | route
    assert nested[0] == ("sct.pipeline", None)
    assert len(nested) <= 40
    # each of the pipeline's direct children opens once
    top = [n for n, parent in nested if parent == "sct.pipeline"]
    assert sorted(top) == sorted(set(top))


def test_spectral_chain_spans_nest_as_the_layers(tmp_path):
    cube = _cube((40, 20, 24))
    with P.trace(str(tmp_path), device="cpu"):
        _spectral(cube)
    nested = _nesting(P.trace.last.events)
    assert set(nested) == {
        ("sct.cube.spectral_smooth", None),
        ("sct.cube.filled", "sct.cube.spectral_smooth"),
        ("sct.smoothing.convolve1d_nan", "sct.cube.spectral_smooth"),
        ("sct.cube.init", "sct.cube.spectral_smooth"),
        ("sct.cube.spectral_interpolate", None),
        ("sct.cube.filled", "sct.cube.spectral_interpolate"),
        ("sct.interpolate.smooth_interp_cube",
         "sct.cube.spectral_interpolate"),
        ("sct.kernels.smooth_interp", "sct.interpolate.smooth_interp_cube"),
        ("sct.cube.init", "sct.cube.spectral_interpolate"),
        ("sct.cube.sigma_clip_spectrally", None),
        ("sct.cube.filled", "sct.cube.sigma_clip_spectrally"),
        ("sct.smoothing.sigma_clip", "sct.cube.sigma_clip_spectrally"),
        ("sct.kernels.sigma_clip", "sct.smoothing.sigma_clip"),
        ("sct.cube.init", "sct.cube.sigma_clip_spectrally")}
    assert len(nested) <= 20
    # the cube a user's read makes: the header's WCS, then the cube
    with P.trace(str(tmp_path), device="cpu"):
        _cube((4, 6, 8))
    assert _nesting(P.trace.last.events) == [("sct.wcs.init", None),
                                             ("sct.cube.init", None)]


def test_every_kernel_wrapper_opens_its_span(tmp_path):
    """Each wrapper of ``kernels.WRAPPERS`` is spanned by its own name,
    its launch counter on the function the package calls."""
    for name, fn in WRAPPERS.items():
        assert hasattr(fn, "launches")
        with P.trace(str(tmp_path), device="cpu"):
            with pytest.raises(Exception):
                fn(None)
        names = [e["name"] for e in P.trace.last.events
                 if e.get("cat") == "user_annotation"]
        assert f"sct.kernels.{name}" in names, name


def test_the_convolution_and_the_build_keep_no_host_timers():
    cube = _cube((4, 16, 18))
    beam = T.Beam(T.Quantity(12.0, "arcsec"), T.Quantity(10.0, "arcsec"),
                  T.Quantity(10.0, "deg"))
    cube.convolve_to(beam)
    assert tconv.convolve_cube_to_beam.last == {"route": "separable",
                                                "groups": 1}
    assert not hasattr(_build, "last_build")


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def test_device_summary_reports_the_programs_spans():
    """Per ``sct.`` span: calls, host ms, device ms (the work launched
    inside it, matched by correlation id), idle ms (its host time the
    device's busy union leaves uncovered) and the host waits that start in
    it; the window's waits, one inside another counted once; and each
    gap's innermost open ``sct.`` span."""
    ev = [
        _x(P.WINDOW, "user_annotation", 0.0, 400.0),
        # a span of someone else's is none of the program's
        _x("cube.convolve_to", "user_annotation", 5.0, 110.0),
        _x("sct.a", "user_annotation", 10.0, 100.0),
        _x("sct.b", "user_annotation", 30.0, 20.0),
        _x("cudaLaunchKernel", "cuda_runtime", 15.0, 2.0, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 95.0, 2.0, correlation=2),
        _x("cudaStreamSynchronize", "cuda_runtime", 60.0, 40.0),
        _x("k1", "kernel", 20.0, 40.0, device=0, correlation=1),
        # launched inside sct.a, run past its end
        _x("k2", "kernel", 100.0, 50.0, device=0, correlation=2),
        _x("host_work", "cpu_op", 140.0, 105.0),
        # one wait: the runtime's synchronisation inside .item()
        _x("aten::_local_scalar_dense", "cpu_op", 200.0, 40.0),
        _x("cudaStreamSynchronize", "cuda_runtime", 205.0, 33.0),
        # two calls of sct.c, whose one launch runs after both
        _x("sct.c", "user_annotation", 250.0, 20.0),
        _x("cudaLaunchKernel", "cuda_runtime", 255.0, 2.0, correlation=3),
        _x("sct.c", "user_annotation", 300.0, 20.0),
        _x("k3", "kernel", 330.0, 10.0, device=0, correlation=3),
    ]
    s = P.device_summary(ev)
    ms = pytest.approx
    assert s["busy_ms"] == ms(0.100)
    assert s["waits"] == 2
    assert s["spans"] == {
        # device [20, 60) + [100, 150); idle: [10, 110) less its busy 50
        "sct.a": P.SpanSummary(1, ms(0.100), ms(0.090), ms(0.050), 1),
        "sct.b": P.SpanSummary(1, ms(0.020), 0.0, 0.0, 0),
        "sct.c": P.SpanSummary(2, ms(0.040), ms(0.010), ms(0.040), 0)}
    # gaps [150, 330), [340, 400), [60, 100), [0, 20)
    assert s["gaps"] == [(ms(0.150), ms(0.180), "host_work", None, None),
                         (ms(0.340), ms(0.060), None, None, None),
                         (ms(0.060), ms(0.040), "sct.a", None, "sct.a"),
                         (ms(0.0), ms(0.020), None, None, None)]
