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


def _irregular_operator():
    """A banded (45, 70) operator of uneven rows: spans of 1 to 12
    columns whose starts are not monotone, an all-zero row, rows of one
    column, and a zero tap inside row 9's span."""
    rng = np.random.RandomState(11)
    nout, nin = 45, 70
    M = np.zeros((nout, nin), np.float32)
    for i in range(nout):
        n = int(rng.randint(1, 13))
        s = int(rng.randint(0, nin - n + 1))
        M[i, s:s + n] = rng.randn(n).astype(np.float32) + 2.0
    M[7] = 0.0
    M[3] = 0.0
    M[3, 60] = 1.5
    M[20] = 0.0
    M[20, 0] = -0.75
    nz = np.flatnonzero(M[9])
    if nz.size < 3:
        M[9, 30:36] = 1.0
        nz = np.flatnonzero(M[9])
    M[9, nz[1]] = 0.0
    return M


_OPERATORS = {"config2": lambda: _config2_operator().astype(np.float32),
              "irregular": _irregular_operator}


def _emulate_kernel(x, bands, packed):
    """csrc/banded_matmul.cu on the CPU from the packed step tables alone,
    over all columns at once: each step's row copies land in the ring as
    soon as they are issued (the earliest the card may land them), each
    group's records read the ring, and a ring tag checks that the row a
    record reads is resident in its slot at the step that reads it (the
    group's first spanned input row plus the record's index).  FMAs in
    float64 rounded to float32 (an fmaf up to a double rounding).
    Returns the output and how often each input row was copied."""
    p = packed.plan
    f32 = np.float32
    tables = packed.words.reshape(p.steps, p.table_words)
    nout = bands.start.shape[0]
    S = x.shape[1]
    ring = np.full((p.slots, S), 3.0e30, f32)
    tag = np.full(p.slots, -1)
    copies = np.zeros(x.shape[0], np.int64)
    rec_w = 2 if p.rows == 1 else 4 + p.rows
    goff = 4 + -(-2 * p.max_loads // 4) * 4
    end = bands.start + bands.length
    out = np.full((nout, S), 7.0e30, f32)

    def issue(k):
        if k >= p.steps:
            return
        n = tables[k, 0]
        assert n <= p.max_loads
        for row, slot in tables[k, 4:4 + 2 * n].reshape(n, 2):
            ring[slot] = x[row]
            tag[slot] = row
            copies[row] += 1

    for k in range(p.depth):
        issue(k)
    for s in range(p.steps):
        issue(s + p.depth)
        for w in range(kbm.WARPS):
            g = s * kbm.WARPS + w
            rows = np.arange(g * p.rows, min((g + 1) * p.rows, nout))
            live = rows[bands.length[rows] > 0]
            at = goff + w * p.group_words
            n = tables[s, at]
            rec = tables[s, at + 4:at + 4 + n * rec_w].reshape(n, rec_w)
            acc = np.zeros((p.rows, S), f32)
            for u in range(n):
                if p.rows == 1:
                    mask, taps = 1, rec[u, 1:2].view(f32)
                else:
                    mask, taps = rec[u, 1], rec[u, 4:].view(f32)
                j = bands.start[live].min() + u
                for r in range(p.rows):
                    if (mask >> r) & 1:
                        i = g * p.rows + r
                        assert bands.start[i] <= j < end[i]
                        assert tag[rec[u, 0]] == j
                        acc[r] = (np.float64(taps[r]) * ring[rec[u, 0]]
                                  + acc[r]).astype(f32)
            out[rows] = acc[:rows.size]
    return out, copies


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape", kbm.SHAPES)
@pytest.mark.parametrize("which,S", [("config2", 300), ("irregular", 37)])
def test_kernel_plan_reproduces_the_plain_product(monkeypatch, which, S,
                                                  shape, depth):
    """The kernel's walk over its packed step tables, emulated on the CPU
    for each shape and depth of its plan, on bench config 2's operator
    and on an irregular one (uneven and non-monotone spans, an empty row,
    rows of one column, a zero tap inside a span, S not a multiple of
    4): every record's input row is resident at the step that reads it,
    each staged row is copied once a strip (a monotone band) or at least
    once, and the output agrees with the plain version within 2e-6 under
    the NaN rule, NaN and inf on span edges included."""
    monkeypatch.setattr(kbm, "SHAPES", (shape,))
    monkeypatch.setattr(kbm, "DEPTHS", (depth,))
    M = _OPERATORS[which]()
    bands = kbm.row_bands(M)
    packed = kbm.pack(bands)
    assert (packed.plan.rows, packed.plan.cols, packed.plan.depth) == \
        (*shape, depth)
    x = np.random.RandomState(5).randn(M.shape[1], S).astype(np.float32)
    i = 9
    lo, hi = int(bands.start[i]), int(bands.start[i] + bands.length[i])
    x[lo, 3] = np.nan                   # the first column of row 9's span
    x[hi - 1, 4] = np.inf               # its last
    x[lo - 1 if lo else hi, 5] = np.nan  # just outside it
    got, copies = _emulate_kernel(x, bands, packed)
    want = kbm.banded_matmul_plain(torch.as_tensor(x), bands).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=1e-6)
    span = (bands.start[:, None] <= np.arange(M.shape[1])) \
        & (np.arange(M.shape[1]) < (bands.start + bands.length)[:, None])
    assert np.array_equal(~np.isfinite(got[:, 3]), span[:, lo])
    assert not np.isfinite(got[i, 4])
    assert np.isfinite(got[i, 5]) == (not span[i, lo - 1 if lo else hi])
    assert np.array_equal(got[bands.length == 0], 0 * got[bands.length == 0])
    needed = span.any(0)
    assert (copies[needed] >= 1).all() and not copies[~needed].any()
    if which == "config2":
        assert (copies[needed] == 1).all()


def test_plan_on_config2_and_spans_too_wide():
    """Bench config 2's operator takes 8 rows a warp on 128-column strips
    with one step in flight, two blocks an SM; a span wider than any ring
    the card's shared memory holds is refused with ValueError."""
    p = kbm.plan(kbm.row_bands(_config2_operator().astype(np.float32)))
    assert (p.rows, p.cols, p.depth, p.steps) == (8, 4, 1, 8)
    assert p.smem <= kbm.SMEM_TWO
    wide = np.zeros((8, 60000), np.float32)
    wide[:, 0] = wide[:, -1] = 1.0
    with pytest.raises(ValueError, match="too wide"):
        kbm.plan(kbm.row_bands(wide))
