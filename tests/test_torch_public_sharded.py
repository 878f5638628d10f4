"""Torch port, the public surface of ``parallel/sharded.py`` against the
JAX package: ``ShardedCube`` (its own members and the cube members it
answers for, the calls a user of a sharded cube makes) and the module's
sharded functions.

The sharded cube is ``tests/torch_public.py``'s masked cube on a 2 x 4
mesh: the JAX package's 8 virtual CPU devices, the port's
``CubeMesh(devices=[device] * 8)``.  The functions take the cube's data
as a numpy array, as the JAX package's tests give it.  Each call is held
on the CPU against the JAX package and on the card outside any guard.
"""

import numpy as np

import torch_public as tp
from torch_public import C

MODULES = ("parallel/sharded.py",)

SC = "ShardedCube."
R = "parallel/sharded.py"


def _data(k):
    return np.nan_to_num(np.asarray(
        k.inp("plain").unmasked_data[:].value), nan=0.25)


def _sh(name):
    return lambda k: getattr(k.m("parallel.sharded"), name)


def _kernel2d():
    return np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25])


def _axes(k):
    inax = np.asarray(k.inp("plain").spectral_axis.value, dtype=float)
    return inax, inax[::2] + 0.3


def _zyx(shape):
    """A separable offset mapping, as the JAX package's
    ``test_sharded_reproject_halo_matches_unsharded`` gives it."""
    nz, ny, nx = shape
    ys = np.broadcast_to(np.arange(ny, dtype=float)[:, None] + 0.37,
                         (ny, nx)).copy()
    xs = np.broadcast_to(np.arange(nx, dtype=float)[None, :] - 0.61,
                         (ny, nx)).copy()
    return np.arange(nz, dtype=float), ys, xs


def _scheduled(s):
    with s.use_dask_scheduler("threads") as same:
        return same.moment0()



CALLS = {
    (R, "ShardedCube"): C(
        "cube", lambda c, k: k.m("parallel").ShardedCube(c, k.mesh())),
    (R, SC + "shape"): C("sharded", lambda s, k: tuple(s.shape)),
    (R, SC + "moment_maps"): C("sharded", lambda s, k: s.moment_maps()),
    (R, SC + "statistics"): C("sharded", lambda s, k: s.statistics()),
    (R, SC + "sigma_clip_spectrally"): C(
        "sharded", lambda s, k: s.sigma_clip_spectrally(1.5)),
    (R, SC + "spatial_smooth"): C(
        "sharded", lambda s, k: s.spatial_smooth(
            k.m("convolution").Gaussian2DKernel(1.0))),
    (R, SC + "spectral_interpolate"): C(
        "sharded", lambda s, k: s.spectral_interpolate(
            s.spectral_axis[::2] + k.q(0.3, "km/s"))),
    (R, SC + "reproject"): C(
        "sharded", lambda s, k: s.reproject(tp.shifted_header(s))),
    (R, SC + "convolve_to"): C(
        "sharded", lambda s, k: s.convolve_to(
            k.m("beams").Beam(6 * k.u("arcsec"))), tol=1e-4),
    (R, SC + "rechunk"): C(
        "sharded", lambda s, k: s.rechunk("spectral").moment_maps()),
    (R, SC + "use_dask_scheduler"): C(
        "sharded", lambda s, k: _scheduled(s)),
    (R, SC + "display_dask_array"): C(
        "sharded", lambda s, k: s.display_dask_array() is None),
    (R, SC + "display_sharding"): C(
        "sharded", lambda s, k: s.display_sharding() is None),
    # -- the cube members a sharded cube answers for -----------------------
    (R, SC + "filled_data"): C(
        "sharded", lambda s, k: (s.filled_data[:], s.filled_data[2, 1:4])),
    (R, SC + "unmasked_data"): C(
        "sharded", lambda s, k: s.unmasked_data[:, 3, 4]),
    (R, SC + "mask"): C(
        "sharded", lambda s, k: s.mask.include()),
    (R, SC + "dtype"): C("sharded", lambda s, k: str(s.dtype)),
    (R, SC + "base"): C("sharded", lambda s, k: s.base),
    (R, SC + "moment0"): C("sharded", lambda s, k: s.moment0()),
    (R, SC + "moment1"): C("sharded", lambda s, k: s.moment1()),
    (R, SC + "sum"): C(
        "sharded", lambda s, k: (s.sum(), s.sum(axis=0),
                                 s.sum(axis=(1, 2)))),
    (R, SC + "max"): C("sharded", lambda s, k: (s.max(), s.max(axis=1))),
    (R, SC + "median"): C(
        "sharded", lambda s, k: (s.median(), s.median(axis=0))),
    (R, SC + "mad_std"): C("sharded", lambda s, k: s.mad_std()),
    (R, SC + "argmax"): C(
        "sharded", lambda s, k: (s.argmax(), s.argmax(axis=0),
                                 s.argmax(axis=(1, 2)))),
    (R, SC + "argmax_world"): C(
        "sharded", lambda s, k: s.argmax_world(axis=0)),
    (R, SC + "get_mask_array"): C(
        "sharded", lambda s, k: s.get_mask_array()),
    (R, SC + "filled"): C("sharded", lambda s, k: s.filled()),
    (R, SC + "flattened"): C("sharded", lambda s, k: s.flattened()),
    (R, SC + "spectral_slab"): C(
        "sharded", lambda s, k: s.spectral_slab(k.q(-320.0, "km/s"),
                                                k.q(-316.0, "km/s"))),
    (R, SC + "minimal_subcube"): C(
        "sharded", lambda s, k: s.minimal_subcube()),
    (R, SC + "with_mask"): C(
        "sharded", lambda s, k: s.with_mask(k.inp("boolmask"))),
    (R, SC + "to"): C("sharded", lambda s, k: s.to(k.u("K"))),
    (R, SC + "beam"): C("sharded", lambda s, k: s.beam),
    (R, SC + "average_beams"): C(
        "sharded", lambda s, k: s.average_beams(threshold=0.5)),
    (R, SC + "spectral_smooth"): C(
        "sharded", lambda s, k: s.spectral_smooth(
            k.m("convolution").Gaussian1DKernel(1.0))),
    (R, SC + "linewidth_sigma"): C(
        "sharded", lambda s, k: s.linewidth_sigma()),
    # -- the module's functions ---------------------------------------------
    (R, "sharded_moments"): C(
        None, lambda _, k: tuple(_sh("sharded_moments")(k)(
            _data(k), np.arange(tp.SHAPE[0]) * 0.5, 0.5, k.mesh()))),
    (R, "sharded_statistics"): C(
        None, lambda _, k: _sh("sharded_statistics")(k)(
            _data(k), k.mesh())),
    (R, "sharded_spatial_convolve"): C(
        None, lambda _, k: _sh("sharded_spatial_convolve")(k)(
            _data(k), _kernel2d(), k.mesh())),
    (R, "sharded_convolve_per_channel_separable"): C(
        None, lambda _, k: _sh("sharded_convolve_per_channel_separable")(k)(
            _data(k), *_separable(), k.mesh())),
    (R, "sharded_spectral_convolve_fft"): C(
        None, lambda _, k: _sh("sharded_spectral_convolve_fft")(k)(
            _data(k), *_transfers(), k.mesh())),
    (R, "sharded_sigma_clip"): C(
        None, lambda _, k: _sh("sharded_sigma_clip")(k)(
            _data(k), k.mesh(), sigma=1.5)),
    (R, "sharded_spectral_interpolate"): C(
        None, lambda _, k: _sh("sharded_spectral_interpolate")(k)(
            _data(k), *_axes(k), k.mesh())),
    (R, "sharded_smooth_interpolate"): C(
        None, lambda _, k: _sh("sharded_smooth_interpolate")(k)(
            _data(k), np.array([0.25, 0.5, 0.25]), *_axes(k), k.mesh())),
    (R, "sharded_reproject"): C(
        None, lambda _, k: _sh("sharded_reproject")(k)(
            _data(k), *_zyx(tp.SHAPE), k.mesh())),
}


def _separable():
    """Three Gaussian kernels and one identity group, as the JAX package's
    ``test_sharded_separable_convolution_matches_unsharded`` gives them."""
    kernels = []
    for g in range(3):
        x = np.arange(9) - 4
        kern = np.exp(-0.5 * np.add.outer(x ** 2, x ** 2) /
                      (1.2 + 0.4 * g) ** 2)
        kernels.append(kern / kern.sum())
    kernels.append(None)
    return kernels, (np.arange(tp.SHAPE[0]) % 4).astype(np.int32)


def _transfers():
    fy = np.fft.fftfreq(tp.SHAPE[1])[:, None]
    fx = np.fft.rfftfreq(tp.SHAPE[2])[None, :]
    t = np.exp(-(fy ** 2 + fx ** 2) * np.array([4.0, 8.0])[:, None, None])
    return t.astype(np.complex64), np.array([0, 1, 0, 1, 0, 1], np.int32)


NOT_CALLED = {
    (R, "halo_pad"): tp.Signature(
        "parallel.sharded", "halo_pad",
        "the JAX package's pads a device's local tile inside shard_map "
        "(a ppermute per side); the port's pads every tile of a mesh at "
        "once (held by tests/test_torch_parallel.py)"),
}

#: members that hand out a device tensor by design, with the reason
DEVICE_RESULTS = {}

#: members that answer by design where the JAX package raises, with the
#: reason
PORT_ANSWERS = {}

tp.define_tests(globals())
