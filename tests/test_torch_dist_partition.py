"""The port's 2D partition (``repro_torch.dist.partition``) against the
reference's (``repro.dist.partition``): host numpy on both sides, so every
array must be bit-exact.

Graphs: Barabási–Albert (weighted, power-law: the case random ordering
balances) and a grid, over the grids ``(pods, pr, pc)`` in {(1,1,1),
(1,2,2), (2,2,2), (1,1,3)}, with random ordering on and off. Held:
``partition_edges_2d``, ``ell_blocks_from_partition`` (``"ell"`` and
``"auto"``, which may refuse), ``pad_vector``/``unpad_vector`` and
``balance_report``; and within the port, that each rank's block helpers
equal that rank's slices of the full layouts.

Then the partition-level primitives of ``repro_torch.dist.setup``
(unweighted degrees, Alg 1 selection, one Alg 2 round, all of Alg 2) on a
gloo world of one against the reference's on a 1×1 mesh with ``Auto``
axes (ROADMAP C3), bit-exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import repro.dist.partition as J  # noqa: E402
import repro.dist.setup as JS  # noqa: E402
import repro_torch.dist as TD  # noqa: E402
import repro_torch.dist.partition as T  # noqa: E402
import torch_dist_helpers as H  # noqa: E402
from repro_torch.graphs.generators import (barabasi_albert,  # noqa: E402
                                           ensure_connected, grid_2d)

GRIDS = [(1, 1, 1), (1, 2, 2), (2, 2, 2), (1, 1, 3)]
GRAPHS = {
    "ba": lambda: ensure_connected(*barabasi_albert(700, m=3, seed=4,
                                                    weighted=True)),
    "grid": lambda: grid_2d(17, 13),
}


def assert_same(a, b, names):
    for k in names:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, k
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


PART_FIELDS = ("row_local", "col_local", "val", "n", "n_pad", "pr", "pc",
               "pods", "nb", "nb_col", "nnz", "block_nnz", "perm",
               "capacity", "n_blocks", "fill_fraction")
ELL_FIELDS = ("col", "val", "spill_row", "spill_col", "spill_val", "width",
              "spill_nnz", "spill_cap")


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


@pytest.mark.parametrize("random_ordering", [True, False])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_partition_bit_exact(graph, grid, random_ordering):
    pods, pr, pc = grid
    n, r, c, v = graph
    kw = dict(pods=pods, random_ordering=random_ordering, seed=3)
    tp = T.partition_edges_2d(n, r, c, v, pr, pc, **kw)
    jp = J.partition_edges_2d(n, r, c, v, pr, pc, **kw)
    if not random_ordering:
        assert tp.perm is None and jp.perm is None
    assert_same(tp, jp, [f for f in PART_FIELDS if f != "perm"
                         or random_ordering])
    assert T.balance_report(tp) == J.balance_report(jp)
    x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    np.testing.assert_array_equal(T.pad_vector(tp, x), J.pad_vector(jp, x))
    y = T.pad_vector(tp, x)
    np.testing.assert_array_equal(T.unpad_vector(tp, y),
                                  J.unpad_vector(jp, y))
    np.testing.assert_array_equal(T.unpad_vector(tp, y), x)

    for backend in ("ell", "auto"):
        te = T.ell_blocks_from_partition(tp, backend=backend, cap=16)
        je = J.ell_blocks_from_partition(jp, backend=backend, cap=16)
        assert (te is None) == (je is None), backend
        if te is not None:
            assert_same(te, je, ELL_FIELDS)
    # a fixed width too: every entry past it spills
    assert_same(T.ell_blocks_from_partition(tp, width=2),
                J.ell_blocks_from_partition(jp, width=2), ELL_FIELDS)


@pytest.mark.parametrize("grid", GRIDS[1:], ids=lambda g: "x".join(map(str, g)))
def test_rank_blocks_are_slices_of_the_layouts(graph, grid):
    """What each rank keeps on its device is its slice of the full
    layout: the COO block with global ids, the ELL table and the real
    entries of its spill; and the spill count the solver reports equals
    the layout's."""
    pods, pr, pc = grid
    n, r, c, v = graph
    part = T.partition_edges_2d(n, r, c, v, pr, pc, pods=pods, seed=2)
    eb = T.ell_blocks_from_partition(part, width=3)
    counts = T.block_row_counts(part)
    assert int(np.maximum(counts - 3, 0).sum()) == eb.spill_nnz
    assert T.ell_width_for(part, counts, cap=16) == \
        T.ell_blocks_from_partition(part, cap=16).width
    for p in range(pods):
        for i in range(pr):
            for j in range(pc):
                blk = T.rank_block(part, (p, i, j), "cpu")
                ok = part.row_local[p, i, j] < part.nb
                want_row = np.where(ok, i * part.nb + part.row_local[p, i, j],
                                    part.n_pad)
                np.testing.assert_array_equal(blk["row"].numpy(), want_row)
                np.testing.assert_array_equal(blk["val"].numpy(),
                                              part.val[p, i, j])
                e = T.rank_ell_block(part, (p, i, j), 3, "cpu")
                np.testing.assert_array_equal(e["col"].numpy(),
                                              eb.col[p, i, j])
                np.testing.assert_array_equal(e["val"].numpy(),
                                              eb.val[p, i, j])
                m = eb.spill_row[p, i, j] < part.n_pad
                got = (np.zeros(0, np.int32) if e["spill_row"] is None
                       else e["spill_row"].numpy())
                np.testing.assert_array_equal(got, eb.spill_row[p, i, j][m])
                if e["spill_val"] is not None:
                    np.testing.assert_array_equal(e["spill_val"].numpy(),
                                                  eb.spill_val[p, i, j][m])


def test_random_ordering_balances_power_law():
    """The paper's §2.2 claim on a hub-first graph, in the port: random
    ordering lowers the imbalance and raises the fill fraction."""
    n, r, c, v = barabasi_albert(4000, m=4, seed=2)
    no = T.balance_report(T.partition_edges_2d(n, r, c, v, 4, 4,
                                               random_ordering=False))
    yes = T.balance_report(T.partition_edges_2d(n, r, c, v, 4, 4,
                                                random_ordering=True))
    assert yes["imbalance"] < no["imbalance"]
    assert yes["fill_fraction"] >= no["fill_fraction"]
    with pytest.raises(ValueError, match="positive"):
        T.partition_edges_2d(n, r, c, v, 0, 4)
    with pytest.raises(ValueError, match="identical"):
        T.partition_edges_2d(n, r, c[:-1], v, 2, 2)


@pytest.fixture(scope="module")
def mesh():
    with H.world_of_one() as m:
        yield m


@pytest.fixture(scope="module")
def small_part():
    n, r, c, v = H.ba(600, 2, 5)
    tp = T.partition_edges_2d(n, r, c, v, 1, 1, random_ordering=False)
    jp = J.partition_edges_2d(n, r, c, v, 1, 1, random_ordering=False)
    sq = np.where(tp.row_local < tp.nb, 1, 0).astype(np.int32)
    return n, tp, jp, sq


@pytest.mark.parametrize("what", ["degrees", "select", "vote", "aggregate"])
def test_primitives_match_reference(mesh, small_part, what):
    """Each primitive on the world of one against the reference's."""
    n, tp, jp, sq = small_part
    jm = jax.make_mesh((1, 1), ("data", "model"),
                       axis_types=(AxisType.Auto,) * 2)
    if what == "degrees":
        got = TD.distributed_unweighted_degrees(mesh, tp)
        want = JS.distributed_unweighted_degrees(jm, jp)
    elif what == "select":
        got = TD.distributed_select_eliminated(mesh, tp, n)
        want = JS.distributed_select_eliminated(jm, jp, n)
    elif what == "aggregate":
        got = torch.stack(TD.distributed_aggregate(mesh, tp, n, sq))
        want = np.stack([np.asarray(a) for a in
                         JS.distributed_aggregate(jm, jp, n, sq)])
    else:
        state = np.full(n, 1, np.int32)
        state[::7] = 2                       # some seeds to join
        votes, aggs = np.zeros(n, np.int32), np.arange(n, dtype=np.int32)
        got = torch.stack(TD.distributed_vote_round(
            mesh, tp, n, sq, torch.as_tensor(state), torch.as_tensor(votes),
            torch.as_tensor(aggs)))
        want = np.stack([np.asarray(a) for a in JS.distributed_vote_round(
            jm, jp, n, sq, state, votes, aggs)])
    _eq(got, want)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape,names", [
    ((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
    ((2, 1, 3), ("pod", "data", "model"))])
def test_edge_block_counts_match_reference(shape, names):
    """The per-block occupancy of a carry's equal slices, against the
    reference's (which reads only the mesh's axis names and sizes)."""
    import types

    n_cap = 512
    row = np.where(np.random.default_rng(0).random(1000) < 0.7,
                   np.random.default_rng(1).integers(0, n_cap, 1000),
                   n_cap).astype(np.int32)
    fake = types.SimpleNamespace(
        axis_names=names, shape=dict(zip(names, shape)),
        size=int(np.prod(shape)), pods=shape[0] if len(shape) == 3 else 1,
        pr=shape[-2], pc=shape[-1])
    got = TD.edge_block_counts(fake, torch.as_tensor(row), n_cap)
    want = JS.edge_block_counts(fake, jax.numpy.asarray(row), n_cap)
    _eq(got, want)
    assert int(got.sum()) == int((row < n_cap).sum())
