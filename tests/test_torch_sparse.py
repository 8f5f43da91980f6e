"""Port sparse substrate vs ``repro.sparse``: COO, ELL, segment, matvec.

Integer outputs (layouts, ranks, coalesced indices, lexicographic
reductions) must be bit-exact. Float segment sums are taken in the same
entry order as XLA's scatter-add on the CPU, so they are bit-exact too;
the ELL products and matvecs use rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.sparse import coo as jcoo  # noqa: E402
from repro.sparse import ell as jell  # noqa: E402
from repro.sparse import matvec as jmv  # noqa: E402
from repro.sparse import segment as jseg  # noqa: E402
from repro_torch.sparse import coo as tcoo  # noqa: E402
from repro_torch.sparse import ell as tell  # noqa: E402
from repro_torch.sparse import matvec as tmv  # noqa: E402
from repro_torch.sparse import segment as tseg  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _random_coo(seed, n=97, nnz=600, cap=700):
    """Unsorted COO with duplicates and trailing sentinel padding."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz).astype(np.int32)
    c = rng.integers(0, n, nnz).astype(np.int32)
    v = rng.normal(size=nnz).astype(np.float32)
    return (jcoo.coo_from_arrays(r, c, v, n, n, capacity=cap),
            tcoo.coo_from_arrays(r, c, v, n, n, capacity=cap,
                                  device="cpu"))


def test_take_fill_and_segment_conventions():
    rng = np.random.default_rng(0)
    x = rng.normal(size=10).astype(np.float32)
    idx = np.array([0, 9, 10, 11, 3, -1], np.int32)
    got = tseg.take_fill(torch.from_numpy(x), torch.from_numpy(idx), 7.0)
    np.testing.assert_array_equal(_np(got)[:5], np.asarray(
        jnp.take(jnp.asarray(x), jnp.asarray(idx[:5]), mode="fill",
                 fill_value=7.0)))
    assert float(got[5]) == 7.0                      # negative ids fill too
    data = rng.normal(size=40).astype(np.float32)
    ids = rng.integers(0, 12, 40).astype(np.int32)   # ids >= 10 are dropped
    for fn, jfn in ((tseg.segment_sum, jax.ops.segment_sum),
                    (tseg.segment_max, jax.ops.segment_max),
                    (tseg.segment_min, jax.ops.segment_min)):
        d = data if fn is tseg.segment_sum else (data * 100).astype(np.int32)
        np.testing.assert_array_equal(
            _np(fn(torch.from_numpy(d), torch.from_numpy(ids), 10)),
            np.asarray(jfn(jnp.asarray(d), jnp.asarray(ids),
                           num_segments=10)))


@pytest.mark.parametrize("seed", [0, 1])
def test_lex_reductions_bit_exact(seed):
    rng = np.random.default_rng(seed)
    m, n = 500, 60
    p = rng.integers(0, 5, m).astype(np.int32)       # many ties
    s = rng.integers(0, 3, m).astype(np.int32)
    pay = rng.integers(0, 1000, m).astype(np.int32)
    seg = rng.integers(0, n + 3, m).astype(np.int32)  # some out of range
    valid = rng.random(m) > 0.2
    T = torch.from_numpy
    got = tseg.segment_argmax_lex(T(p), T(s), T(pay), T(seg), n, T(valid))
    want = jseg.segment_argmax_lex(jnp.asarray(p), jnp.asarray(s),
                                   jnp.asarray(pay), jnp.asarray(seg), n,
                                   jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    got = tseg.segment_argmin_lex(T(p), T(pay), T(seg), n, T(valid))
    want = jseg.segment_argmin_lex(jnp.asarray(p), jnp.asarray(pay),
                                   jnp.asarray(seg), n, jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coo_ops_match_reference(seed):
    ja, ta = _random_coo(seed)
    rng = np.random.default_rng(seed + 10)
    x = rng.normal(size=ta.n_cols).astype(np.float32)
    X = rng.normal(size=(ta.n_cols, 3)).astype(np.float32)
    xt, Xt = torch.from_numpy(x), torch.from_numpy(X)
    for fn_t, fn_j, arg_t, arg_j in (
            (tcoo.spmv, jcoo.spmv, xt, jnp.asarray(x)),
            (tcoo.spmv_t, jcoo.spmv_t, xt, jnp.asarray(x)),
            (tcoo.spmm, jcoo.spmm, Xt, jnp.asarray(X))):
        np.testing.assert_array_equal(_np(fn_t(ta, arg_t)),
                                      np.asarray(fn_j(ja, arg_j)))
    np.testing.assert_array_equal(_np(tcoo.row_sums(ta)),
                                  np.asarray(jcoo.row_sums(ja)))
    np.testing.assert_array_equal(_np(tcoo.degrees(ta)),
                                  np.asarray(jcoo.degrees(ja)))
    assert ta.nnz == int(ja.nnz)
    np.testing.assert_allclose(_np(ta.to_dense()), np.asarray(ja.to_dense()),
                               RTOL, ATOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_coalesce_bit_exact(seed):
    ja, ta = _random_coo(seed, n=31, nnz=400, cap=450)   # many duplicates
    jr = jcoo.coalesce_arrays(ja.row, ja.col, ja.val, ja.n_rows, ja.capacity)
    tr = tcoo.coalesce_arrays(ta.row, ta.col, ta.val, ta.n_rows, ta.capacity)
    for g, w in zip(tr[:3], jr[:3]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert tr[3] == int(jr[3])


@pytest.mark.parametrize("width", [None, 0, 3, 6])
def test_coo_to_ell_bit_exact(width):
    ja, ta = _random_coo(4)
    jl, jrem = jell.coo_to_ell(ja, width=width)
    tl, trem = tell.coo_to_ell(ta, width=width)
    np.testing.assert_array_equal(_np(tl.col), np.asarray(jl.col))
    np.testing.assert_array_equal(_np(tl.val), np.asarray(jl.val))
    for name in ("row", "col", "val"):
        np.testing.assert_array_equal(_np(getattr(trem, name)),
                                      np.asarray(getattr(jrem, name)))
    x = np.random.default_rng(5).normal(size=ta.n_cols).astype(np.float32)
    np.testing.assert_allclose(
        _np(tell.ell_spmv_ref(tl, torch.from_numpy(x))),
        np.asarray(jell.ell_spmv_ref(jl, jnp.asarray(x))), RTOL, ATOL)


@pytest.mark.parametrize("width", [0, 2, 8])
def test_ell_layout_traced_bit_exact(width):
    ja, ta = _random_coo(6, n=50, nnz=300, cap=340)
    jl = jell.ell_layout_traced(ja.row, ja.col, ja.n_rows, width)
    tl = tell.ell_layout_traced(ta.row, ta.col, ta.n_rows, width)
    for name in ("order", "rr", "kk", "in_ell", "col_table", "spill_row",
                 "spill_col"):
        np.testing.assert_array_equal(_np(getattr(tl, name)),
                                      np.asarray(getattr(jl, name)), name)
    q = (np.arange(ta.capacity) * 7 % 13).astype(np.int32)
    np.testing.assert_array_equal(_np(tl.table(torch.from_numpy(q))),
                                  np.asarray(jl.table(jnp.asarray(q))))
    np.testing.assert_array_equal(_np(tl.spill(torch.from_numpy(q))),
                                  np.asarray(jl.spill(jnp.asarray(q))))


def test_select_width_and_split_hybrid_match():
    from repro.graphs.generators import barabasi_albert, to_laplacian_coo

    n, r, c, v = barabasi_albert(400, m=3, seed=1, weighted=True)
    ja = to_laplacian_coo(n, r, c, v)
    ta = tcoo.coo_from_arrays(r, c, v, n, n, device="cpu")
    counts = np.bincount(r, minlength=n)
    for backend in ("coo", "ell", "auto"):
        assert tmv.select_ell_width(counts, backend) == \
            jmv.select_ell_width(counts, backend)
    _, _, jstats = jmv.split_hybrid(ja, 5)
    tl, trem, tstats = tmv.split_hybrid(ta, 5)
    assert tstats == jstats
    jplan = jmv.build_hybrid(ja, "ell")
    tplan = tmv.build_hybrid(ta, "ell")
    assert tplan[0].width == jplan[0].width
    x = np.random.default_rng(2).normal(size=n).astype(np.float32)
    X = np.random.default_rng(3).normal(size=(n, 4)).astype(np.float32)

    class Lvl:
        pass

    jlv, tlv = Lvl(), Lvl()
    jlv.adj, jlv.ell, jlv.ell_rem, jlv.ell_mode = ja, jplan[0], jplan[1], "jnp"
    tlv.adj, tlv.ell, tlv.ell_rem = ta, tplan[0], tplan[1]
    jlv.deg = jcoo.row_sums(ja)
    tlv.deg = tcoo.row_sums(ta)
    np.testing.assert_allclose(
        _np(tmv.laplacian_matvec(tlv, torch.from_numpy(x))),
        np.asarray(jmv.laplacian_matvec(jlv, jnp.asarray(x))), RTOL, ATOL)
    np.testing.assert_allclose(
        _np(tmv.level_spmm(tlv, torch.from_numpy(X))),
        np.asarray(jmv.level_spmm(jlv, jnp.asarray(X))), RTOL, ATOL)
    tlv.ell = None                       # no twin: the COO segment-sum path
    np.testing.assert_array_equal(
        _np(tmv.level_spmv(tlv, torch.from_numpy(x))),
        np.asarray(jcoo.spmv(ja, jnp.asarray(x))))
