"""Port kernels: plain PyTorch versions vs the Pallas kernels and their refs.

On the CPU every wrapper runs its plain version, so these tests hold the
plain versions (the oracles the CUDA kernels are checked against on the
card, see ``chip_smoke.py``) against the JAX package: the Pallas kernels in
interpret mode and the pure-jnp ``ref.py`` oracles, on random ELL tables
from a numpy seed with sentinel slots, row counts that are not multiples
of the Pallas block size, and width 0. Tolerances: the float kernels at
rtol 1e-5 / atol 1e-6 (float32 summation order differs); the vote
reduction bit-exact (integer ⊕). The embedding bag: multi-hot id tables
with the sentinel ids −2, −1, V and V + 3, bag counts that are not
multiples of the Pallas block of 128, hot 0 to 5 and d = 1 and 10, at
rtol / atol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.agg_vote import vote_reduce as j_vote  # noqa: E402
from repro.kernels.agg_vote import vote_reduce_ref as j_vote_ref  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag_kernel as j_bag  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag_ref as j_bag_ref  # noqa: E402
from repro.kernels.jacobi import jacobi_step as j_jacobi  # noqa: E402
from repro.kernels.jacobi import jacobi_step_ref as j_jacobi_ref  # noqa: E402
from repro.kernels.spmv_ell import spmv_ell as j_spmv  # noqa: E402
from repro.kernels.spmv_ell import spmv_ell_ref as j_spmv_ref  # noqa: E402
from repro_torch.kernels import on_cuda  # noqa: E402
from repro_torch.kernels.agg_vote import vote_reduce, vote_reduce_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_kernel, embedding_bag_ref)
from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref  # noqa: E402
from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(300, 5), (1000, 13), (64, 0)]
PALLAS_SHAPE = (300, 5)      # rows not a multiple of the 256-row block


def _ell(rng, n_rows, n_cols, width, density=0.7):
    col = rng.integers(0, n_cols, (n_rows, width)).astype(np.int32)
    val = rng.normal(size=(n_rows, width)).astype(np.float32)
    pad = rng.random((n_rows, width)) > density
    col[pad] = n_cols
    val[pad] = 0
    return col, val


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_rows,width", SHAPES)
def test_spmv_ell_plain_matches_pallas_and_ref(n_rows, width):
    rng = np.random.default_rng(n_rows + width)
    col, val = _ell(rng, n_rows, 400, width)
    x = rng.normal(size=400).astype(np.float32)
    got = spmv_ell(_t(col), _t(val), _t(x)).numpy()
    np.testing.assert_allclose(got, spmv_ell_ref(_t(col), _t(val),
                                                 _t(x)).numpy(), 0, 0)
    np.testing.assert_allclose(
        got, np.asarray(j_spmv_ref(jnp.asarray(col), jnp.asarray(val),
                                   jnp.asarray(x))), RTOL, ATOL)
    if (n_rows, width) == PALLAS_SHAPE:    # interpret mode is slow: one shape
        np.testing.assert_allclose(
            got, np.asarray(j_spmv(jnp.asarray(col), jnp.asarray(val),
                                   jnp.asarray(x), interpret=True)),
            RTOL, ATOL)


@pytest.mark.parametrize("n_rows,width", SHAPES)
def test_jacobi_plain_matches_pallas_and_ref(n_rows, width):
    rng = np.random.default_rng(7 * n_rows + width)
    col, val = _ell(rng, n_rows, n_rows, width)
    x, b = (rng.normal(size=n_rows).astype(np.float32) for _ in range(2))
    deg = np.abs(rng.normal(size=n_rows)).astype(np.float32) + 0.5
    deg[::5] = 0.0                          # rows with deg == 0 keep x
    got = jacobi_step(*map(_t, (col, val, x, b, deg))).numpy()
    np.testing.assert_array_equal(
        got, jacobi_step_ref(*map(_t, (col, val, x, b, deg))).numpy())
    np.testing.assert_array_equal(got[::5], x[::5])
    args = [jnp.asarray(a) for a in (col, val, x, b, deg)]
    np.testing.assert_allclose(got, np.asarray(j_jacobi_ref(*args)),
                               RTOL, ATOL)
    if (n_rows, width) == PALLAS_SHAPE:
        np.testing.assert_allclose(
            got, np.asarray(j_jacobi(*args, interpret=True)), RTOL, ATOL)


def _vote_case(rng, n_rows, width, n_cols=350):
    col = rng.integers(0, n_cols, (n_rows, width)).astype(np.int32)
    col[rng.random((n_rows, width)) > 0.8] = n_cols       # padding slots
    sq = rng.integers(0, 4, (n_rows, width)).astype(np.int32)  # many ties
    state = rng.integers(0, 3, n_cols).astype(np.int32)   # 0 = Decided
    return col, sq, state


@pytest.mark.parametrize("n_rows,width", SHAPES + [(257, 1), (300, 8)])
def test_vote_plain_bit_exact_vs_pallas_and_ref(n_rows, width):
    rng = np.random.default_rng(11 * n_rows + width)
    col, sq, state = _vote_case(rng, n_rows, width)
    k, i = vote_reduce(_t(col), _t(sq), _t(state), levels=1 << 20,
                       decided=0)
    kr, ir = vote_reduce_ref(_t(col), _t(sq), _t(state), levels=1 << 20)
    assert torch.equal(k, kr) and torch.equal(i, ir)
    want = [j_vote_ref(jnp.asarray(col), jnp.asarray(sq), jnp.asarray(state),
                       levels=1 << 20, decided=0)]
    if (n_rows, width) in (PALLAS_SHAPE, (64, 0)):
        want.append(j_vote(jnp.asarray(col), jnp.asarray(sq),
                           jnp.asarray(state), levels=1 << 20, decided=0,
                           interpret=True))
    for wk, wi in want:
        np.testing.assert_array_equal(k.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    if width == 0:
        assert (k.numpy() == np.iinfo(np.int32).min).all()
        assert (i.numpy() == np.iinfo(np.int32).max).all()


def test_wrappers_use_plain_version_on_cpu_without_launching():
    rng = np.random.default_rng(0)
    col, val = _ell(rng, 40, 40, 3)
    x = rng.normal(size=40).astype(np.float32)
    before = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    spmv_ell(_t(col), _t(val), _t(x))
    jacobi_step(_t(col), _t(val), _t(x), _t(x), _t(np.ones(40, np.float32)))
    vote_reduce(_t(col), _t(col), _t(np.ones(40, np.int32)), levels=4)
    assert (spmv_ell.launches, jacobi_step.launches,
            vote_reduce.launches) == before


def test_wrappers_refuse_other_devices():
    t = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        on_cuda("spmv_ell", t, torch.zeros(2))
    with pytest.raises(ValueError):
        spmv_ell(t, t.float(), torch.zeros(4, device="meta"))


BAG_SHAPES = [(300, 2, 10), (100, 1, 10), (257, 3, 1), (50, 5, 10),
              (129, 4, 1), (64, 0, 10)]
PALLAS_BAG = (300, 2, 10)    # 300 bags: not a multiple of the 128-bag block


def _bag_case(rng, n_bags, hot, d, n_vocab=200):
    table = rng.normal(size=(n_vocab, d)).astype(np.float32)
    idx = rng.integers(0, n_vocab, (n_bags, hot)).astype(np.int32)
    flat = idx.reshape(-1)
    sentinels = np.array([-2, -1, n_vocab, n_vocab + 3], np.int32)
    flat[::7] = np.resize(sentinels, flat[::7].shape)
    return table, idx


@pytest.mark.parametrize("n_bags,hot,d", BAG_SHAPES)
def test_embedding_bag_plain_matches_pallas_and_ref(n_bags, hot, d):
    rng = np.random.default_rng(13 * n_bags + 5 * hot + d)
    table, idx = _bag_case(rng, n_bags, hot, d)
    got = embedding_bag_kernel(_t(table), _t(idx)).numpy()
    assert got.shape == (n_bags, d) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, embedding_bag_ref(_t(table), _t(idx)).numpy())
    want = [j_bag_ref(jnp.asarray(table), jnp.asarray(idx))]
    if (n_bags, hot, d) == PALLAS_BAG:     # interpret mode is slow
        want.append(j_bag(jnp.asarray(table), jnp.asarray(idx),
                          interpret=True))
    for w in want:
        np.testing.assert_allclose(got, np.asarray(w), 1e-6, 1e-6)
    if hot == 0:
        assert not got.any()


def test_embedding_bag_wrapper_on_cpu_and_other_devices():
    rng = np.random.default_rng(1)
    table, idx = _bag_case(rng, 40, 2, 10)
    before = embedding_bag_kernel.launches
    embedding_bag_kernel(_t(table), _t(idx))
    assert embedding_bag_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_kernel(torch.zeros((4, 2), device="meta"),
                             _t(idx))
