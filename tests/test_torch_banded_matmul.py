"""Torch port, kernel 7 (banded matrix product, TPU kernel #14
``banded_matmul_strips``) against the JAX package.

The same numpy inputs go through the JAX function in interpret mode and
through the port on CPU tensors, where the wrapper runs its plain PyTorch
version.  Tolerance: rtol 2e-6 / atol 1e-6, the JAX test's own against
float64 (tests/test_banded_pallas.py:57-68); the host planners equal the
JAX package's exactly; the function declines (None) exactly where the JAX
function does on the operator.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spectral_cube_tpu.ops import banded_pallas as jbp
from spectral_cube_tpu.ops.interpolate import interp_weights as j_weights
from spectral_cube_tpu.ops.interpolate import _interp_matrix as j_interp
from spectral_cube_tpu.ops.smoothing import _banded_conv_matrix as j_band

from spectral_cube_tpu_torch.kernels import banded_matmul as kbm
from spectral_cube_tpu_torch.ops.smoothing import (_banded_conv_matrix,
                                                   gaussian_kernel1d)


def _jax_test_operator():
    """tests/test_banded_pallas.py:57-63: 2x interpolation after a 7-tap
    boxcar, 256 -> 128."""
    nin, nout = 256, 128
    idx, frac = j_weights(np.arange(nin, dtype=float),
                          np.arange(nout, dtype=float) * 2.0)
    return (j_interp(idx, frac, nin).astype(np.float64)
            @ j_band(nin, np.ones(7) / 7.0).astype(np.float64))


def _config2_operator(nchan=512):
    """bench.py:205-211: a 17-tap Gaussian (sigma 2 channels), then every
    second channel."""
    coords = np.arange(nchan, dtype=np.float64)
    k = gaussian_kernel1d(2.0)
    return (j_interp(*j_weights(coords, coords[::2]), nchan)
            .astype(np.float64)
            @ _banded_conv_matrix(nchan, k / k.sum()).astype(np.float64))


@pytest.mark.parametrize("S", [384, 1000])
def test_banded_matmul_strips_matches_jax(S):
    """The JAX test's case (S = 384) against the Pallas kernel in
    interpret mode and float64; at S = 1000 the JAX function declines
    (its VMEM budget wants S a multiple of 128), the port runs."""
    M = _jax_test_operator()
    x = np.random.RandomState(0).randn(256, S).astype(np.float32)
    kbm.banded_matmul.launches = 0
    got = kbm.banded_matmul_strips(M.astype(np.float32), torch.as_tensor(x))
    assert kbm.banded_matmul.launches == 0
    assert got.dtype == torch.float32 and got.shape == (128, S)
    exp = M @ x.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-6, atol=1e-6)
    ref = jbp.banded_matmul_strips(M.astype(np.float32), jnp.asarray(x),
                                   interpret=True)
    if S % 128:
        assert ref is None
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                                   atol=1e-6)


def _declined_operators():
    yield "nin < 128", j_band(64, np.ones(5) / 5.0)
    yield "nout % 8", _jax_test_operator()[:124]
    yield "nin % 8", _jax_test_operator()[:, :252]
    wide = np.zeros((128, 1024))
    wide[0, 0] = wide[0, 700] = 1.0        # one row spans 701 columns
    yield "band > 512", wide


@pytest.mark.parametrize("case", [c for c, _ in _declined_operators()])
def test_none_where_jax_declines(case):
    """tests/test_banded_pallas.py:49-54 and the other gates of
    banded_pallas.py:234-242."""
    M = dict(_declined_operators())[case]
    x = np.zeros((M.shape[1], 256), np.float32)
    assert jbp.banded_matmul_strips(M, jnp.asarray(x), interpret=True) \
        is None
    assert kbm.banded_matmul_strips(M, torch.as_tensor(x)) is None


@pytest.mark.parametrize("which", ["jax_test", "config2", "boxcar"])
def test_planners_match_jax(which):
    M = {"jax_test": _jax_test_operator, "config2": _config2_operator,
         "boxcar": lambda: j_band(256, np.ones(9) / 9.0)}[which]()
    M = M.astype(np.float32)
    plan = kbm.plan_strips(M != 0.0)
    assert plan == jbp.plan_strips(M != 0.0)
    got, want = kbm.strip_blocks(M, *plan), jbp.strip_blocks(M, *plan)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_row_bands_reassemble_the_operator():
    M = _config2_operator().astype(np.float32)
    M[7] = 0.0                                  # an all-zero row
    b = kbm.row_bands(M)
    assert b.taps.shape == (256, 17) and b.nin == 512
    assert b.length[7] == 0
    dense = np.zeros_like(M)
    for i in range(M.shape[0]):
        n = b.length[i]
        dense[i, b.start[i]:b.start[i] + n] = b.taps[i, :n]
    np.testing.assert_array_equal(dense, M)


def test_plain_version_on_config2_and_nonfinite_input():
    """Bench config 2's operator (512 -> 256) against float64; a NaN in
    ``flat[j, s]`` reaches exactly the rows whose span covers j (interior
    zero taps included), an inf likewise, and an all-zero row gives 0."""
    M = _config2_operator().astype(np.float32)
    M[9, M[9] != 0] = np.where(np.arange((M[9] != 0).sum()) == 3, 0.0,
                               M[9, M[9] != 0])   # a zero inside row 9
    rng = np.random.RandomState(3)
    x = rng.randn(512, 300).astype(np.float32)
    bands = kbm.row_bands(M)
    got = kbm.banded_matmul(torch.as_tensor(x), bands).numpy()
    np.testing.assert_allclose(got, M.astype(np.float64) @ x, rtol=2e-6,
                               atol=1e-6)
    j = int(bands.start[9] + 3)
    x[j, 5] = np.nan
    x[200, 6] = np.inf
    got = kbm.banded_matmul(torch.as_tensor(x), bands).numpy()
    span = (bands.start[:, None] <= np.arange(512)) & \
        (np.arange(512) < (bands.start + bands.length)[:, None])
    assert np.array_equal(np.isnan(got[:, 5]), span[:, j])
    assert span[9, j] and M[9, j] == 0.0
    inf_rows = span[:, 200]
    assert not np.isfinite(got[inf_rows, 6]).any()
    assert np.isfinite(got[~inf_rows, 6]).all()
    ok = np.ones(got.shape[1], bool)
    ok[[5, 6]] = False
    np.testing.assert_allclose(got[:, ok], M.astype(np.float64) @ x[:, ok],
                               rtol=2e-6, atol=1e-6)


def test_wrapper_checks_its_input():
    bands = kbm.row_bands(_jax_test_operator())
    with pytest.raises(ValueError, match=r"\(256, S\)"):
        kbm.banded_matmul(torch.zeros(128, 4), bands)
    with pytest.raises(ValueError, match="device"):
        kbm.banded_matmul(torch.zeros(256, 4, device="meta"), bands)
