"""Port kernels on the card: each CUDA kernel against its plain version.

Needs a CUDA device and ``nvcc`` (the kernels build on first use); every
test skips without a card. It imports neither JAX nor the reference, so
it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``spmv_ell``/``jacobi`` rtol 1e-5 / atol 1e-6 against their
plain versions (the float32 summation order differs) and bitwise equal
from one call to the next, ``agg_vote`` bit-exact, ``embedding_bag``
bitwise equal at hot <= 2 (a sum of two floats from 0 has one rounding)
and rtol / atol 1e-6 above (PyTorch's sum may add in another order), and
bitwise equal from one call to the next, DeepFM logits rtol / atol 1e-5
(the card's matrix products sum in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

from repro_torch.kernels import bag_tile_plan, ell_tile_plan  # noqa: E402
from repro_torch.kernels.agg_vote import vote_reduce, vote_reduce_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_kernel, embedding_bag_ref)
from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref  # noqa: E402
from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _ell(rng, n_rows, n_cols, width, density=0.7):
    col = rng.integers(0, n_cols, (n_rows, width)).astype(np.int32)
    val = rng.normal(size=(n_rows, width)).astype(np.float32)
    pad = rng.random((n_rows, width)) > density
    col[pad] = n_cols
    val[pad] = 0
    return col, val


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tile_rows(width):
    return ell_tile_plan(width)[0]


# (n_rows, width, padding density): the first kernels' cases, then the
# tiled design's edges: one row, a tile minus a row, a ragged last tile,
# the widest width, rows that are all padding, and many tiles a block
# (each block's ring of stages wraps several times)
CASES = [(70000, 19, 0.7), (4099, 8, 0.7), (3000, 33, 0.7), (7, 0, 0.7),
         (1, 1, 0.7), (3, 3, 0.7), (_tile_rows(19) - 1, 19, 0.7),
         (_tile_rows(34) * 7 + 5, 34, 0.7), (50_001, 64, 0.7),
         (5000, 12, 0.0), (1 << 20, 19, 0.7), (1 << 21, 3, 0.7)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,width,density", CASES)
def test_cuda_kernels_match_plain_versions(n_rows, width, density):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n_rows)
    col, val = _ell(rng, n_rows, n_rows, width, density)
    x, b = (rng.normal(size=n_rows).astype(np.float32) for _ in range(2))
    deg = np.abs(rng.normal(size=n_rows)).astype(np.float32)
    deg[::7] = 0.0
    C, V, X, B, D = (_t(a).cuda() for a in (col, val, x, b, deg))
    y = spmv_ell(C, V, X)
    torch.testing.assert_close(y, spmv_ell_ref(C, V, X), rtol=RTOL,
                               atol=ATOL)
    out = jacobi_step(C, V, X, B, D)
    torch.testing.assert_close(out, jacobi_step_ref(C, V, X, B, D),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(out[::7], X[::7])             # deg == 0: x, bit for bit
    assert torch.equal(spmv_ell(C, V, X), y)         # repeat: bitwise equal
    assert torch.equal(jacobi_step(C, V, X, B, D), out)
    sq = rng.integers(0, 4, (n_rows, width)).astype(np.int32)  # many ties
    state = rng.integers(0, 3, n_rows).astype(np.int32)     # 0 = Decided
    S, Q = _t(state).cuda(), _t(sq).cuda()
    got = vote_reduce(C, Q, S, levels=1 << 20)
    want = vote_reduce_ref(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,width", [(300, 453), (1000, 700)])
def test_cuda_rows_too_wide_to_stage_run_unstaged(n_rows, width):
    """Past width 452 two stages of a tile do not fit in shared memory:
    the plan stages nothing and the kernels (agg_vote too) read rows with
    plain loads.
    Small integers make every sum exact, so any summation order gives the
    plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ell_tile_plan(width)[1:] == (0, 0)
    rng = np.random.default_rng(width)
    col, _ = _ell(rng, n_rows, n_rows, width)
    val = rng.integers(-3, 4, (n_rows, width)).astype(np.float32)
    x = rng.integers(-8, 9, n_rows).astype(np.float32)
    b = rng.integers(-8, 9, n_rows).astype(np.float32)
    deg = 2.0 ** rng.integers(-2, 6, n_rows).astype(np.float32)
    deg[::5] = 0.0
    sq = rng.integers(0, 4, (n_rows, width)).astype(np.int32)
    state = rng.integers(0, 3, n_rows).astype(np.int32)
    C, V, X, B, D, Q, S = (_t(a).cuda()
                           for a in (col, val, x, b, deg, sq, state))
    s0, j0, v0 = spmv_ell.launches, jacobi_step.launches, vote_reduce.launches
    y, out = spmv_ell(C, V, X), jacobi_step(C, V, X, B, D)
    got = vote_reduce(C, Q, S, levels=1 << 20)
    assert (spmv_ell.launches, jacobi_step.launches,
            vote_reduce.launches) == (s0 + 1, j0 + 1, v0 + 1)
    assert torch.equal(y, spmv_ell_ref(C, V, X))
    assert torch.equal(out, jacobi_step_ref(C, V, X, B, D))
    assert torch.equal(out[::5], X[::5])
    want = vote_reduce_ref(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_misaligned_table_raises_and_launches_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, w = 100, 3
    buf = torch.zeros(n * w + 4, dtype=torch.int32, device="cuda")
    col = buf[1:1 + n * w].view(n, w)                # 4 bytes off 16
    val = torch.ones((n, w), device="cuda")
    x = torch.ones(n, device="cuda")
    s0, j0, v0 = spmv_ell.launches, jacobi_step.launches, vote_reduce.launches
    with pytest.raises(ValueError):
        spmv_ell(col, val, x)
    with pytest.raises(ValueError):
        jacobi_step(col, val, x, x, x)
    with pytest.raises(ValueError):
        vote_reduce(col, col, torch.ones(n, dtype=torch.int32,
                                         device="cuda"), levels=4)
    assert (spmv_ell.launches, jacobi_step.launches,
            vote_reduce.launches) == (s0, j0, v0)


@pytest.mark.cuda
def test_cuda_launch_counts_and_width_zero():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    col = torch.zeros((5, 0), dtype=torch.int32, device="cuda")
    state = torch.ones(5, dtype=torch.int32, device="cuda")
    before = vote_reduce.launches
    k, i = vote_reduce(col, col, state, levels=4)
    assert vote_reduce.launches == before            # width 0: no launch
    assert (k == torch.iinfo(torch.int32).min).all()
    assert (i == torch.iinfo(torch.int32).max).all()
    x = torch.ones(5, device="cuda")
    n0 = spmv_ell.launches
    spmv_ell(torch.zeros((5, 1), dtype=torch.int32, device="cuda"),
             torch.ones((5, 1), device="cuda"), x)
    assert spmv_ell.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_bags,hot,d,n_vocab", [(100_003, 2, 10, 50_000),
                                                  (4099, 5, 1, 300),
                                                  (257, 1, 33, 10),
                                                  (7, 3, 10, 4)])
def test_cuda_embedding_bag_matches_plain_version(n_bags, hot, d, n_vocab):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n_bags + hot)
    table = rng.normal(size=(n_vocab, d)).astype(np.float32)
    idx = rng.integers(-2, n_vocab + 4, (n_bags, hot)).astype(np.int32)
    T, I = _t(table).cuda(), _t(idx).cuda()
    n0 = embedding_bag_kernel.launches
    got = embedding_bag_kernel(T, I)
    assert embedding_bag_kernel.launches == n0 + 1
    torch.testing.assert_close(got, embedding_bag_ref(T, I), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_embedding_bag_hot_zero_and_argument_checks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table = torch.ones((10, 4), device="cuda")
    n0 = embedding_bag_kernel.launches
    out = embedding_bag_kernel(table, torch.zeros((5, 0), dtype=torch.int32,
                                                  device="cuda"))
    assert embedding_bag_kernel.launches == n0        # hot 0: no launch
    assert out.shape == (5, 4) and not out.any()
    with pytest.raises(TypeError):
        embedding_bag_kernel(table, torch.zeros((5, 2), dtype=torch.int64,
                                                device="cuda"))
    with pytest.raises(NotImplementedError):
        embedding_bag_kernel(table.requires_grad_(),
                             torch.zeros((5, 2), dtype=torch.int32,
                                         device="cuda"))


@pytest.mark.cuda
def test_cuda_deepfm_smoke_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.deepfm import SMOKE
    from repro_torch.data.synthetic import recsys_batch_stream
    from repro_torch.models.recsys.deepfm import DeepFM

    cpu = DeepFM(SMOKE, torch.Generator().manual_seed(0), device="cpu")
    card = DeepFM(SMOKE, torch.Generator().manual_seed(0))
    idx = _t(next(recsys_batch_stream(SMOKE.vocab_per_field, 300,
                                      SMOKE.multi_hot))[1])
    n0 = embedding_bag_kernel.launches
    got = card(idx.cuda())
    assert embedding_bag_kernel.launches == n0 + 2
    torch.testing.assert_close(got.cpu(), cpu(idx), rtol=1e-5, atol=1e-5)
    cand = torch.arange(SMOKE.vocab_per_field[0], dtype=torch.int32)
    torch.testing.assert_close(
        card.retrieval_scores(idx[:1].cuda(), cand.cuda()).cpu(),
        cpu.retrieval_scores(idx[:1], cand), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_vote_main_path_shape_ragged_with_ties_and_all_decided():
    """agg_vote at the main setup's first aggregation level's shape
    (699,024 × 8: 5,461 full tiles of 128 rows and a ragged one of 16),
    with strengths in 0..3 so that many keys tie; then every neighbour
    Decided, which gives every row the identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, w = 699_024, 8
    assert n % ell_tile_plan(w)[0] != 0
    rng = np.random.default_rng(8)
    col, _ = _ell(rng, n, n, w, density=0.8)
    sq = rng.integers(0, 4, (n, w)).astype(np.int32)
    state = rng.integers(0, 3, n).astype(np.int32)
    C, Q, S = (_t(a).cuda() for a in (col, sq, state))
    v0 = vote_reduce.launches
    got = vote_reduce(C, Q, S, levels=1 << 20)
    assert vote_reduce.launches == v0 + 1
    want = vote_reduce_ref(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    again = vote_reduce(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    k, i = vote_reduce(C, Q, torch.zeros_like(S), levels=1 << 20)
    assert (k == torch.iinfo(torch.int32).min).all()
    assert (i == torch.iinfo(torch.int32).max).all()


def _bags(n_bags, hot, d, n_vocab, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_vocab, d)).astype(np.float32)
    idx = rng.integers(-2, n_vocab + 3, (n_bags, hot)).astype(np.int32)
    return _t(table).cuda(), _t(idx).cuda()


def _check_bag(T, I):
    """One launch, the plain version's sums (bitwise at hot <= 2), and a
    bitwise repeat."""
    n0 = embedding_bag_kernel.launches
    got = embedding_bag_kernel(T, I)
    assert embedding_bag_kernel.launches == n0 + 1
    want = embedding_bag_ref(T, I)
    if I.shape[1] <= 2:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(embedding_bag_kernel(T, I), got)


_R = bag_tile_plan(2, 10)[0]
# (n_bags, hot, d, n_vocab): a ragged last tile, fewer bags than a tile,
# many tiles a block (each block's ring of stages wraps), d = 1, 2 and 4
# (8, 4 and 2 bags a thread), d = 33, hot 8, and rows too wide for a
# staged plan (0 stages)
BAG_CASES = [(_R * 7 + 5, 2, 10, 1000), (_R - 3, 2, 10, 1000),
             (1 << 22, 2, 10, 43_429), (100_003, 2, 1, 5000),
             (50_001, 2, 2, 900), (30_001, 3, 4, 800),
             (20_001, 1, 33, 700), (9_999, 8, 10, 3000),
             (3_001, 1, 1000, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_bags,hot,d,n_vocab", BAG_CASES)
def test_cuda_embedding_bag_tiles(n_bags, hot, d, n_vocab):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if d == 1000:
        assert bag_tile_plan(hot, d)[1] == 0
    _check_bag(*_bags(n_bags, hot, d, n_vocab, n_bags + d))


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [1, 3])
def test_cuda_embedding_bag_unaligned_ids_view(hot):
    """``I[1:]`` starts 4·hot bytes past the buffer's start, so not on a
    16-byte boundary: the kernel reads its ids with plain loads, and still
    launches once and matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    T, I = _bags(10_001, hot, 10, 2000, hot)
    view = I[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _check_bag(T, view)


def _ba_adj(n, seed):
    from repro_torch.graphs.generators import (barabasi_albert,
                                               ensure_connected,
                                               to_laplacian_coo)

    n, r, c, v = ensure_connected(*barabasi_albert(n, m=4, seed=seed,
                                                   weighted=True))
    return (n, r, c, v), to_laplacian_coo(n, r, c, v)


@pytest.mark.cuda
def test_cuda_superstep_steps_never_sync():
    """A super-step setup under ``torch.cuda.set_sync_debug_mode("error")``
    from the plan's start to its end, the registry cold so that the step
    builders run under it too: only ``_fetch`` and the host work after the
    last fetch lift it. One fetch per constructed level, plus the probe
    and the coarse solve's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import setup_step as ss
    from repro_torch.core.hierarchy import SetupConfig

    _, adj = _ba_adj(1 << 12, 3)
    ss.clear_cache()
    ss.reset_counters()
    v0 = vote_reduce.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = ss.build_hierarchy_superstep(adj,
                                         SetupConfig(matvec_backend="ell"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert vote_reduce.launches > v0
    assert h.n_levels > 2
    assert ss.counters()["host_syncs"] <= (h.n_levels - 1) + 3


@pytest.mark.cuda
def test_cuda_superstep_equals_eager():
    """At n = 2^14 on the card: the same levels, aggregates and elimination
    masks, and bitwise the same PCG residual history and solution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    (n, r, c, v), _ = _ba_adj(1 << 14, 5)
    cfg = SetupConfig(matvec_backend="ell")
    s = LaplacianSolver.setup(n, r, c, v, cfg)
    e = LaplacianSolver.setup(n, r, c, v,
                              dataclasses.replace(cfg, setup_mode="eager"))
    keys = ("kind", "n", "nnz", "ell_width", "ell_spill")
    assert [[row[k] for k in keys] for row in s.stats()["levels"]] == \
        [[row[k] for k in keys] for row in e.stats()["levels"]]
    for ts, te in zip(s.hierarchy.transfers, e.hierarchy.transfers):
        for name in ("coarse_id", "elim_mask", "c_index", "f_index"):
            if hasattr(te, name):
                assert torch.equal(getattr(ts, name), getattr(te, name))
    b = np.random.default_rng(1).normal(size=n).astype(np.float32)
    b -= b.mean()
    xs, i_s = s.solve(b, tol=1e-6)
    xe, i_e = e.solve(b, tol=1e-6)
    assert i_s.converged and i_s.iters == i_e.iters
    assert i_s.residual_norms == i_e.residual_norms
    assert torch.equal(xs, xe)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [0, 8])
def test_cuda_segment_sum_bitwise_unchanged(cols):
    """The segment sums take their boundaries from the sorted ids and sum
    the dropped entries in chunks: on the card too every real segment's
    sum is the bits of the histogram-based form it replaced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.sparse.segment import _seg_ids, segment_sum

    rng = np.random.default_rng(cols)
    m, n_seg = 3_000_000, 200_000
    ids = _t(rng.integers(-5, int(n_seg * 1.4), m).astype(np.int32)).cuda()
    shape = (m, cols) if cols else (m,)
    data = _t(rng.normal(size=shape).astype(np.float32)).cuda()
    seg = _seg_ids(ids, n_seg)
    order = torch.argsort(seg, stable=True)
    want = torch.segment_reduce(
        data.index_select(0, order), "sum",
        lengths=torch.bincount(seg, minlength=n_seg + 1), axis=0,
        unsafe=True)[:n_seg]
    got = segment_sum(data, ids, n_seg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_facade_bitwise_pairs():
    """The facade on the card at n = 2^14: blocked columns, guards off,
    ``x0`` zeros and ``verify`` cheap / paranoid are bitwise equal to the
    plain blocked solve, whose columns are bitwise looped single solves;
    the diag-PCG rung converges on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.api import Problem, SolverOptions, setup
    from repro_torch.api.fallback import diag_pcg_block

    (n, r, c, v), _ = _ba_adj(1 << 14, 6)
    p = Problem.from_edges(n, r, c, v)
    B = np.random.default_rng(2).normal(size=(n, 4)).astype(np.float32)
    B -= B.mean(axis=0)
    solver = setup(p, SolverOptions(matvec_backend="ell", tol=1e-6),
                   cache=False)
    X, res = solver.solve(B)
    assert res.status == "converged"

    def same(a, b):
        return np.array_equal(a.view(np.int32), b.view(np.int32))

    for j in range(4):
        assert same(solver.solve(B[:, j])[0], X[:, j])
    assert same(solver._handle.solve_block(B, 1e-6, 200, guard=False)[0], X)
    assert same(solver.solve(B, x0=np.zeros_like(B))[0], X)
    for mode in ("cheap", "paranoid"):
        Xv, rv = setup(p, SolverOptions(matvec_backend="ell", tol=1e-6,
                                        verify=mode), cache=False).solve(B)
        assert same(Xv, X) and rv.certificate.passed
    _, _, _, statuses = diag_pcg_block(p, B, 1e-6, 500)
    assert statuses.tolist() == ["converged"] * 4


@pytest.mark.cuda
def test_cuda_fault_site_keeps_the_tensor_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.testing import Fault, FaultPlan, inject, site

    x = torch.ones(1000, device="cuda")
    assert site("solve.spmv", x) is x
    with inject(FaultPlan({"solve.spmv": Fault(mode="nan")})):
        y = site("solve.spmv", x)
    assert y.device == x.device and y.dtype == x.dtype
    assert int(torch.isnan(y).sum()) == 50


@pytest.mark.cuda
def test_cuda_setup_ell_sweeps_launches_spmv_ell():
    """``setup_ell_sweeps``: ``spmv_ell`` launches during a setup with the
    switch on and none with it off; the eager and super-step setups with
    it on give bitwise the same residual history."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    (n, r, c, v), _ = _ba_adj(1 << 13, 7)
    b = np.random.default_rng(3).normal(size=n).astype(np.float32)
    b -= b.mean()
    hist = {}
    for on, mode in ((False, "superstep"), (True, "superstep"),
                     (True, "eager")):
        cfg = SetupConfig(matvec_backend="ell", setup_ell_sweeps=on,
                          setup_mode=mode)
        k0 = spmv_ell.launches
        s = LaplacianSolver.setup(n, r, c, v, cfg)
        torch.cuda.synchronize()
        launched = spmv_ell.launches - k0
        assert (launched > 0) == on, (on, mode, launched)
        _, info = s.solve(b, tol=1e-6)
        assert info.converged
        hist[on, mode] = info.residual_norms
    assert hist[True, "superstep"] == hist[True, "eager"]


@pytest.mark.cuda
def test_cuda_serial_ref_runs_the_solve_kernels_and_no_vote():
    """The serial reference on the card: its solves launch ``spmv_ell`` and
    ``jacobi``, its greedy setup never launches ``agg_vote``, and it
    converges like the facade's ``serial_ref`` backend."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.api import Problem, SolverOptions, setup
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.serial_ref import serial_lamg_solver

    (n, r, c, v), _ = _ba_adj(1 << 13, 8)
    b = np.random.default_rng(4).normal(size=n).astype(np.float32)
    b -= b.mean()
    k0 = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    s = serial_lamg_solver(n, r, c, v, SetupConfig(matvec_backend="ell"))
    x, info = s.solve(b, tol=1e-6)
    torch.cuda.synchronize()
    k1 = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    assert info.converged and x.is_cuda
    assert k1[0] > k0[0] and k1[1] > k0[1] and k1[2] == k0[2]
    handle = setup(Problem.from_edges(n, r, c, v),
                   SolverOptions(matvec_backend="ell", tol=1e-6),
                   backend="serial_ref", cache=False)
    _, res = handle.solve(b)
    assert res.converged and vote_reduce.launches == k0[2]


@pytest.mark.cuda
def test_cuda_agg_registry_key_separates_ell_sweeps():
    """A second setup of the same graph with the other ``setup_ell_sweeps``
    setting adds an ``agg`` registry entry; a third, equal to the second,
    adds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import setup_step as ss
    from repro_torch.core.hierarchy import SetupConfig

    _, adj = _ba_adj(1 << 12, 9)
    ss.clear_cache()
    ss.reset_counters()
    ss.build_hierarchy_superstep(adj, SetupConfig(matvec_backend="ell"))
    entries = []
    for _ in range(2):
        ss.reset_counters()
        ss.build_hierarchy_superstep(adj, SetupConfig(
            matvec_backend="ell", setup_ell_sweeps=True))
        entries.append(ss.counters()["steps"]["agg"]["compiles"])
    assert entries[0] > 0 and entries[1] == 0


@pytest.mark.cuda
def test_cuda_dist_world_of_one_runs_the_kernels():
    """A world of one over NCCL on the card: the distributed setup and
    solve launch ``agg_vote``, ``spmv_ell`` and ``jacobi``, converge to a
    host residual ≤ 1e-4 in ``single``'s iterations, and make every
    reduction an NCCL all-reduce (none staged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver
    from repro_torch.dist import DistLaplacianSolver, init_world
    from repro_torch.graphs.generators import (barabasi_albert,
                                               ensure_connected)

    if dist.is_initialized():
        pytest.skip("a process group exists already")
    n, r, c, v = ensure_connected(*barabasi_albert(1 << 14, m=4, seed=3,
                                                   weighted=True))
    b = np.random.default_rng(4).normal(size=n).astype(np.float32)
    b -= b.mean()
    cfg = SetupConfig(matvec_backend="ell")
    mesh = init_world("cuda")
    try:
        k0 = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
        s = DistLaplacianSolver.setup(n, r, c, v, mesh, cfg,
                                      dist_nnz_threshold=1000)
        X, norms, iters, codes = s.solve_block(b[:, None], n_iters=200,
                                               tol=1e-6, guard=True)
        stats = mesh.stats()
    finally:
        dist.destroy_process_group()
    k1 = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    assert all(b1 > b0 for b0, b1 in zip(k0, k1))
    assert mesh.backend == "nccl" and stats["calls"] > 0
    assert stats["staged"] == 0 and int(codes[0]) == 0
    assert len(s.level_meta) >= 1 and X.is_cuda
    _, info = LaplacianSolver.setup(n, r, c, v, cfg).solve(b, tol=1e-6)
    assert int(iters[0]) == info.iters
    x = X[:, 0].double().cpu().numpy()
    import scipy.sparse as sp

    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(n, n))
    res = b - (np.asarray(a.sum(axis=1)).ravel() * x - a @ x)
    assert np.linalg.norm(res) / np.linalg.norm(b) <= 1e-4
