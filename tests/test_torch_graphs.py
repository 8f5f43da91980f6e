"""The port's graph generators and named stand-ins (``repro_torch.graphs``)
against the reference's (``repro.graphs``).

Both are host numpy code seeded with ``np.random.default_rng``, so for the
same arguments every array must be equal element for element
(``np.array_equal``, dtypes too): each generator weighted and not at two
seeds, ``ensure_connected`` on a disconnected input,
``largest_component_sizes``, and ``paper_graph`` for every entry of
``PAPER_GRAPHS`` at ``scale=0.05`` (the reference's shrink rules: n times
the scale, a grid's sides times its square root, an rmat graph's scale
less round(-log2(scale))).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import repro.graphs as J  # noqa: E402
from repro.graphs import datasets as jdata  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
import repro_torch.graphs as T  # noqa: E402
from repro_torch.graphs import datasets as tdata  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402

GENERATORS = {
    "barabasi_albert": dict(n=400, m=3),
    "erdos_renyi": dict(n=500, avg_degree=6.0),
    "rmat": dict(scale=9, edge_factor=6),
    "grid_2d": dict(nx=13, ny=17),
    "delaunay": dict(n=600),
    "star": dict(n=150),
    "watts_strogatz": dict(n=500, k=6, p=0.2),
}


def _assert_same(got, want):
    assert len(got) == len(want) == 4
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_equals_reference(name, weighted, seed):
    kw = dict(GENERATORS[name], seed=seed, weighted=weighted)
    _assert_same(getattr(tgen, name)(**kw), getattr(jgen, name)(**kw))


@pytest.mark.parametrize("name", sorted(jdata.PAPER_GRAPHS))
def test_paper_graph_equals_reference(name):
    got = tdata.paper_graph(name, scale=0.05, seed=1)
    _assert_same(got, jdata.paper_graph(name, scale=0.05, seed=1))
    n, r, c, _ = got
    assert len(tgen.largest_component_sizes(n, r, c)) == 1


def test_paper_graphs_table_equals_reference():
    assert tdata.PAPER_GRAPHS == jdata.PAPER_GRAPHS


def test_ensure_connected_and_component_sizes_equal_reference():
    """Two disjoint grids and an isolated vertex: three components,
    bridged by the same random chain in both packages."""
    n1, r1, c1, v1 = tgen.grid_2d(5, 6, weighted=True, seed=2)
    n = 2 * n1 + 1
    r = np.concatenate([r1, r1 + n1]).astype(np.int32)
    c = np.concatenate([c1, c1 + n1]).astype(np.int32)
    v = np.concatenate([v1, v1])
    sizes = tgen.largest_component_sizes(n, r, c)
    np.testing.assert_array_equal(sizes, jgen.largest_component_sizes(n, r, c))
    assert sorted(sizes.tolist()) == [1, n1, n1]
    _assert_same(tgen.ensure_connected(n, r, c, v, seed=3),
                 jgen.ensure_connected(n, r, c, v, seed=3))


def test_package_exports_match_reference():
    assert T.__all__ == J.__all__
    for name in J.__all__:
        assert callable(getattr(T, name)) or isinstance(getattr(T, name),
                                                        dict)


@pytest.mark.parametrize("case", ["web-NotreDame", "de2010", "random"])
def test_connected_components_equal_reference(case):
    """The port's linear-time component search numbers components as the
    reference's label propagation does (by smallest member), on the
    randomly relabeled stand-ins (a chain of 1,450 components; a grid)
    and on 20 random multigraphs with isolated vertices and loops."""
    from repro.core.components import connected_components as jcc
    from repro_torch.core.components import connected_components as tcc

    if case == "random":
        rng = np.random.default_rng(0)
        graphs = []
        for _ in range(20):
            n = int(rng.integers(1, 300))
            m = int(rng.integers(0, 400))
            graphs.append((n, rng.integers(0, n, m), rng.integers(0, n, m)))
    else:
        n, r, c, _ = tdata.paper_graph(case, scale=0.1)
        r, c, _, _ = tgen.random_relabel(n, r, c, 3)
        graphs = [(n, r, c)]
    for n, r, c in graphs:
        (got, k), (want, jk) = tcc(n, r, c), jcc(n, r, c)
        assert k == jk and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
