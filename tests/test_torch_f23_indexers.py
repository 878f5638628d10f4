"""Torch port, F23: the indexers ``cube.filled_data[...]`` and
``cube.unmasked_data[...]`` (and a ``ShardedCube``'s) give a ``Quantity``
whose ``.value`` is a host array that numpy reads, as the JAX package's
``.value`` (a jax array numpy converts) and the reference's (numpy) are.

Before, ``.value`` kept the device tensor, so ``np.asarray(cube.filled_data
[:].value)`` raised ``TypeError`` on the card.  The battery files convert
under ``numpy_guard``, which lets test code convert a tensor, so none of
them could see it; the cases here run outside any guard, the ``cuda``
ones on the card (``chip_smoke.py``'s batteries phase runs this file's
``cuda`` cases with ``-m cuda``; without CUDA they skip).  The file reads
JAX only inside the case that holds the port against it.
"""

import numpy as np
import pytest

import spectral_cube_tpu_torch as T
from spectral_cube_tpu_torch import parallel as tpar
from spectral_cube_tpu_torch.io.fits_low import HDU, write_fits
from spectral_cube_tpu_torch.masks import index_view

from test_torch_fixtures_ref import DEVICES, base_header, use_device

SHAPE = (6, 5, 7)
VIEWS = [(slice(None),), (2,), (slice(1, 4), 2), (Ellipsis, 3),
         (slice(None, None, -1), slice(0, 4, 2)), (0, 1, 2)]
THRESHOLD = 0.5


def _cube_file(tmp_path):
    """A float32 cube with NaNs, written to FITS: its path."""
    rng = np.random.RandomState(2)
    data = rng.rand(*SHAPE).astype(np.float32)
    data[1, 1, 1] = np.nan
    data[3, :, 2] = np.nan
    h = base_header(nx=SHAPE[2], ny=SHAPE[1], nchan=SHAPE[0])
    h["BITPIX"] = -32
    path = str(tmp_path / "f23.fits")
    write_fits(path, [HDU(data=data, header=h)])
    return path


def _masked(cube, Q):
    return cube.with_mask(cube > Q(THRESHOLD, cube.unit))


@pytest.mark.parametrize("device", DEVICES)
def test_f23_indexers_give_numpy_a_host_array(tmp_path, monkeypatch,
                                              device):
    """Outside any guard, on the CPU and on the card, ``np.asarray`` of each
    indexer's ``.value`` is the view's filled (or stored) data as a
    float32 host array."""
    dev = use_device(device, monkeypatch)
    cube = _masked(T.SpectralCube.read(_cube_file(tmp_path), device=dev),
                   T.Quantity)
    assert cube.device.type == dev.type
    for view in VIEWS:
        filled, stored = cube.filled_data[view], cube.unmasked_data[view]
        for q, want in ((filled, cube._get_filled_data(view)),
                        (stored, index_view(cube._data, view))):
            assert isinstance(q.value, np.ndarray)
            arr = np.asarray(q.value)
            assert arr.dtype == np.float32
            assert np.array_equal(arr, want.cpu().numpy(), equal_nan=True)
            assert str(q.unit) == str(cube.unit)


def test_f23_matches_jax(tmp_path):
    """The port's indexer values are the JAX package's for the same file
    and mask, and its ``.value`` converts as theirs does."""
    J = pytest.importorskip("spectral_cube_tpu")
    path = _cube_file(tmp_path)
    cube = _masked(T.SpectralCube.read(path, device="cpu"), T.Quantity)
    jcube = _masked(J.SpectralCube.read(path), J.Quantity)
    for view in VIEWS:
        for name in ("filled_data", "unmasked_data"):
            got = getattr(cube, name)[view]
            want = getattr(jcube, name)[view]
            assert str(got.unit) == str(want.unit)
            np.testing.assert_array_equal(np.asarray(got.value),
                                          np.asarray(want.value))


@pytest.mark.parametrize("device", DEVICES)
def test_f23_sharded_indexers_give_a_host_array(tmp_path, monkeypatch,
                                                device):
    """A ``ShardedCube``'s indexers on a 2 x 2 mesh of the device give the
    unsharded cube's host arrays bit for bit, with no gather."""
    dev = use_device(device, monkeypatch)
    cube = _masked(T.SpectralCube.read(_cube_file(tmp_path), device=dev),
                   T.Quantity)
    cmesh = tpar.CubeMesh(devices=[dev] * 4, shape=(2, 2))
    sc = tpar.ShardedCube(cube, cmesh)
    for view in VIEWS:
        for name in ("filled_data", "unmasked_data"):
            got = getattr(sc, name)[view].value
            want = getattr(cube, name)[view].value
            assert isinstance(got, np.ndarray)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want, equal_nan=True)
    assert cmesh.counters["gathers"] == 0
