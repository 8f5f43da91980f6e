"""The port's distributed solver (``repro_torch.dist``) on a world of one
against the reference's (``repro.dist``) on a 1×1 mesh.

The reference mesh is built with ``axis_types=(AxisType.Auto,) * 2``, as
``tests/test_dist.py`` builds its meshes: on this JAX a mesh made without
them (``repro.api.backends.default_mesh``) has Explicit axes, under which
the reference's interpret-mode ``spmv_ell`` raises inside ``shard_map``
(ROADMAP C3). The port runs a gloo world of one in this process (module
scope, destroyed at the end).

Graph: Barabási–Albert n = 1200, m = 3, seed 3, weighted (the reference's
``tests/test_dist.py`` case), ``coarsest_size=64``,
``dist_nnz_threshold=100``, ``matvec_backend="ell"``. Held:
``level_meta`` exactly; every integer array of the distributed levels and
each rank block's ELL table and spill bit-exact, floats at rtol 1e-6
(ROADMAP C1); iterations equal, ``x`` at rtol 1e-5 / atol 1e-5 and the
norms at rtol 1e-4 (C4); the partition primitives bit-exact. Within the
port: guards on/off and a repeat bitwise, ``ell`` against ``coo`` (the
comparison the reference's ``[ell-dist]`` case cannot make, C3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import repro.core.hierarchy as JH  # noqa: E402
import repro.dist.solver as JD  # noqa: E402
import repro_torch.dist as TD  # noqa: E402
import torch_dist_helpers as H  # noqa: E402
from repro_torch.core.coarsen import AggregationLevel  # noqa: E402
from repro_torch.core.hierarchy import SetupConfig, hierarchy_stats  # noqa: E402

KW = dict(coarsest_size=64)
DIST_KW = dict(dist_nnz_threshold=100, max_dist_levels=3)
SOLVE_KW = dict(n_iters=12, tol=1e-6)


def auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def mesh():
    with H.world_of_one() as m:
        yield m


@pytest.fixture(scope="module")
def ba():
    n, r, c, v = H.ba(1200, 3, 3)
    return n, r, c, v, H.mean_free(11, n, 2)


@pytest.fixture(scope="module")
def ref(ba):
    n, r, c, v, B = ba
    s = JD.DistLaplacianSolver.setup(
        n, r, c, v, auto_mesh(),
        JH.SetupConfig(matvec_backend="ell", **KW), **DIST_KW)
    X, norms, iters = s.solve_block(B, **SOLVE_KW)
    return dict(solver=s, X=np.asarray(X), norms=np.asarray(norms),
                iters=np.asarray(iters))


@pytest.fixture(scope="module")
def port(ba, mesh):
    n, r, c, v, B = ba
    s = TD.DistLaplacianSolver.setup(
        n, r, c, v, mesh, SetupConfig(matvec_backend="ell", **KW), **DIST_KW)
    X, norms, iters = s.solve_block(B, **SOLVE_KW)
    return dict(solver=s, X=X.numpy(), norms=norms, iters=iters)


def test_level_meta_equal(ref, port):
    got = [dataclasses.astuple(m) for m in port["solver"].level_meta]
    want = [dataclasses.astuple(m) for m in ref["solver"].level_meta]
    assert got == want and len(got) == 3


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_distributed_levels_match(ref, port):
    """The distributed levels' transfer arrays and each level's rank block
    (the 1×1 mesh's only block) against the reference's."""
    for tp, tj in zip(port["solver"].arrays.transfers,
                      ref["solver"].arrays.transfers):
        if isinstance(tp, AggregationLevel):
            _eq(tp.coarse_id, tj.coarse_id)
        else:
            for f in ("elim_mask", "c_index", "f_index", "f_vertices"):
                _eq(getattr(tp, f), getattr(tj, f))
            _eq(tp.p_f.row, tj.p_f.row)
            _eq(tp.p_f.col, tj.p_f.col)
            np.testing.assert_allclose(tp.p_f.val.numpy(),
                                       np.asarray(tj.p_f.val), rtol=1e-6)
        fp, fj = tp.fine, tj.fine
        np.testing.assert_allclose(fp.deg.numpy(), np.asarray(fj.deg),
                                   rtol=1e-6)
        _eq(fp.ell_col, np.asarray(fj.ell_col)[0, 0, 0])
        np.testing.assert_allclose(fp.ell_val.numpy(),
                                   np.asarray(fj.ell_val)[0, 0, 0], rtol=1e-6)
        spill = np.asarray(fj.spill_row)[0, 0, 0]
        real = spill < fj.n_pad
        _eq(fp.spill_row, spill[real])
        _eq(fp.spill_col, np.asarray(fj.spill_col)[0, 0, 0][real])
        np.testing.assert_allclose(fp.spill_val.numpy(),
                                   np.asarray(fj.spill_val)[0, 0, 0][real],
                                   rtol=1e-6)
    np.testing.assert_allclose(
        [float(x) for x in port["solver"].arrays.lam_maxes],
        [float(x) for x in ref["solver"].arrays.lam_maxes], rtol=1e-6)


def test_replicated_tail_matches(ref, port):
    keys = ("kind", "n", "nnz", "ell_width", "ell_spill")
    got = hierarchy_stats(port["solver"].coarse_h)["levels"]
    want = JH.hierarchy_stats(ref["solver"].coarse_h)["levels"]
    assert [[row[k] for k in keys] for row in got] == \
        [[row[k] for k in keys] for row in want]
    np.testing.assert_allclose(port["solver"].coarse_h.coarse_inv.numpy(),
                               np.asarray(ref["solver"].coarse_h.coarse_inv),
                               rtol=1e-4, atol=1e-6)


def test_solve_matches_reference(ref, port):
    assert port["solver"].n_pad == ref["solver"].n_pad
    _eq(port["iters"], ref["iters"])
    np.testing.assert_allclose(port["X"], ref["X"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port["norms"], ref["norms"], rtol=1e-4)
    assert port["norms"][-1].max() <= 1e-6 * port["norms"][0].min() * 10


def test_guards_and_repeat_bitwise(ba, port):
    s = port["solver"]
    B = ba[4]
    X1, n1, i1, codes = s.solve_block(B, guard=True, **SOLVE_KW)
    X2, n2, i2 = s.solve_block(B, **SOLVE_KW)
    assert list(codes) == [0, 0]
    for X in (X1, X2):
        assert np.array_equal(X.numpy().view(np.int32),
                              port["X"].view(np.int32))
    assert np.array_equal(n1, port["norms"]) and np.array_equal(n2, n1)
    _eq(i1, port["iters"])


def test_ell_against_coo(ba, mesh, port):
    """The port's ELL dist path against its COO one: equal iterations and
    ``x`` within rtol 1e-5 / atol 1e-5."""
    n, r, c, v, B = ba
    s = TD.DistLaplacianSolver.setup(n, r, c, v, mesh, SetupConfig(**KW),
                                     **DIST_KW)
    assert [m.ell_width for m in s.level_meta] == [None] * 3
    X, norms, iters = s.solve_block(B, **SOLVE_KW)
    _eq(iters, port["iters"])
    np.testing.assert_allclose(X.numpy(), port["X"], rtol=1e-5, atol=1e-5)
