"""Port setup stages vs the reference: integer stages bit-exact.

Covers ``hash32`` and Alg 1 selection, the threefry uniform draw against
``jax.random.uniform``, Alg 2 aggregation + renumbering given the same
strengths (through the port's fused vote path and its staged path), the
Schur-complement and contraction index arrays, and the algebraic-distance
strengths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import coarsen as jcoarsen  # noqa: E402
from repro.core import elimination as jelim  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import strength as jstrength  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import coarsen as tcoarsen  # noqa: E402
from repro_torch.core import elimination as telim  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import strength as tstrength  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.sparse.ell import ell_layout_traced  # noqa: E402


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _levels(n, r, c, v):
    return (jgraph.graph_from_adjacency(jgen.to_laplacian_coo(n, r, c, v)),
            tgraph.graph_from_adjacency(
                tgen.to_laplacian_coo(n, r, c, v, device="cpu")))


@pytest.fixture(scope="module")
def ba_levels():
    return _levels(*jgen.ensure_connected(
        *jgen.barabasi_albert(600, m=3, seed=2, weighted=True)))


def test_generators_match():
    for args in ((700, 4, 3, True), (300, 2, 0, False)):
        a = jgen.barabasi_albert(*args)
        b = tgen.barabasi_albert(*args)
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    a = jgen.ensure_connected(*jgen.grid_2d(9, 7, weighted=True))
    b = tgen.ensure_connected(*tgen.grid_2d(9, 7, weighted=True))
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    a = jgen.random_relabel(50, np.arange(50), np.arange(50)[::-1], 3)
    b = tgen.random_relabel(50, np.arange(50), np.arange(50)[::-1], 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_hash32_bit_exact():
    ids = np.concatenate([np.arange(5000), [2**31 - 1, 2**32 - 1, 2**31]])
    want = np.asarray(jgraph.hash32(jnp.asarray(ids, jnp.uint32)))
    got = _np(tgraph.hash32(torch.from_numpy(ids.astype(np.int64))))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("k,seed", [(3, 0), (10, 1), (14, 0), (14, 12345)])
def test_threefry_uniform_bit_exact(k, seed):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (2**k, 8),
                                         minval=-0.5, maxval=0.5))
    got = _np(prng.uniform(seed, (2**k, 8), -0.5, 0.5, "cpu"))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_start_vector_close():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4096,)))
    got = _np(prng.normal(0, (4096,), "cpu"))
    # erfinv may differ in the last bits; only the λmax estimate reads it
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("graph", ["ba", "grid"])
def test_select_eliminated_bit_exact(graph, ba_levels):
    jl, tl = ba_levels if graph == "ba" else _levels(*jgen.grid_2d(13, 11))
    want = jax.jit(jelim.select_eliminated)(jl)
    np.testing.assert_array_equal(_np(telim.select_eliminated(tl)),
                                  np.asarray(want))


def test_schur_and_contract_integer_outputs(ba_levels):
    jl, tl = ba_levels
    elim = jelim.select_eliminated(jl)
    n_f = int(elim.sum())
    want = jax.jit(lambda adj, deg, e: jelim.schur_arrays(
        adj, deg, e, jl.n, f_cap=n_f, with_coarse_deg=False))(
            jl.adj, jl.deg, elim)
    got = telim.schur_arrays(tl.adj, tl.deg, torch.tensor(np.asarray(elim)),
                             tl.n, f_cap=n_f)
    for name in ("c_index", "f_index", "f_vertices", "p_row", "p_col",
                 "co_row", "co_col"):
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name]),
                                      name)
    assert got["co_nnz"] == int(want["co_nnz"])
    np.testing.assert_allclose(_np(got["co_val"]), np.asarray(want["co_val"]),
                               rtol=1e-6)

    n_c = 150
    cid = np.random.default_rng(0).integers(0, n_c, jl.n).astype(np.int32)
    jr = jcoarsen._contract_jit(jl.adj, jnp.asarray(cid), n_coarse=n_c)
    tr = tcoarsen.contract_arrays(tl.adj, torch.from_numpy(cid), n_c)
    for g, w in zip(tr[:2], jr[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert tr[3] == int(jr[3])
    np.testing.assert_allclose(_np(tr[2]), np.asarray(jr[2]), rtol=1e-6)


def test_strengths_match(ba_levels, monkeypatch):
    jl, tl = ba_levels
    xj = np.asarray(jstrength.relaxed_test_vectors(jl))
    xt = _np(tstrength.relaxed_test_vectors(tl))
    # the vectors are normalised to max |x| = 1 per column: agreement to a
    # few float32 ulps of 1 (the reference's fused division is not
    # correctly rounded on the CPU, torch's is)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6)
    # from the same test vectors the strengths agree to rtol 1e-6
    monkeypatch.setattr(tstrength, "relaxed_test_vectors",
                        lambda *a, **k: torch.from_numpy(xj))
    np.testing.assert_allclose(
        _np(tstrength.algebraic_distance_strength(tl)),
        np.asarray(jstrength.algebraic_distance_strength(jl)), rtol=1e-6)


@pytest.mark.parametrize("graph", ["ba", "grid"])
def test_aggregate_and_renumber_bit_exact(graph, ba_levels):
    jl, tl = ba_levels if graph == "ba" else _levels(*jgen.grid_2d(13, 11))
    s = np.asarray(jstrength.algebraic_distance_strength(jl))
    cfg_j, cfg_t = jagg.AggregationConfig(), tagg.AggregationConfig()
    aggs_j, state_j = jax.jit(lambda lv, st: jagg.aggregate(lv, st, cfg_j))(
        jl, jnp.asarray(s))
    cid_j, nc_j = jagg.renumber_aggregates(aggs_j, jl.n)

    st = torch.from_numpy(s)
    lay = ell_layout_traced(tl.adj.row, tl.adj.col, tl.n, 8)
    sq = tagg.quantise_strength(st, cfg_t)

    def fused(state):
        return tagg.vote_edge_reduce(lay, lay.table(sq), lay.spill(sq),
                                     state, cfg_t)

    for edge_reduce in (fused, None):       # vote kernel path, staged path
        aggs_t, state_t = tagg.aggregate(tl, st, cfg_t,
                                         edge_reduce=edge_reduce)
        np.testing.assert_array_equal(_np(aggs_t), np.asarray(aggs_j))
        np.testing.assert_array_equal(_np(state_t), np.asarray(state_j))
        cid_t, nc_t = tagg.renumber_aggregates(aggs_t, tl.n)
        np.testing.assert_array_equal(_np(cid_t), np.asarray(cid_j))
        assert nc_t == nc_j
