"""The reference's batched throughput path on the port: what ``jax.vmap``
over a column axis makes of the reference, against the port's ``[n, k]``
blocks.

On the CPU every kernel wrapper runs its plain version, so these tests
hold the k-column plain versions (the oracles the CUDA kernels are checked
against on the card) and the block paths built on them against the JAX
package on numpy inputs made from seeds:

* ``spmv_ell`` and ``jacobi`` on ``[n, k]`` blocks against the reference's
  Pallas kernels in interpret mode under ``jax.vmap(..., in_axes=1,
  out_axes=1)``: widths 1, 8, 19, 34 and 64, each at one of k = 1, 3, 8,
  64 (the interpret mode compiles each width's unrolled loop, about 1–4
  s); width 0 against the reference's jnp version under the same vmap
  (its Pallas block shape cannot be 0 wide). 300 rows (a ragged last
  256-row block), padding slots ``col == n_cols``. ``spmv_ell`` at rtol
  1e-5 / atol 1e-6 (float32 sums in another order); ``jacobi`` at rtol
  1e-5 / atol 1e-5 (the same sums, scaled by ω/deg ≤ 4/3 over the drawn
  degrees ≥ 0.5 and added to x: float32 tolerance on outputs of order
  10). Column j of a block is bitwise the vector form of ``X[:, j]``.
* on a graph of two Barabási–Albert components (500 and 300 vertices),
  one reference setup shared: one V-cycle on a block (elimination and
  aggregation levels) against ``jax.vmap`` of the reference's
  ``apply_cycle`` on the reference's own hierarchy, carried into the port
  with ELL twins on every level, at rtol 1e-5 / atol 1e-6; and
  ``pcg_block(exact_columns=False)`` through ``repro_torch.api.setup``
  (ELL twins on every level) against the reference's vmapped path, k = 3:
  iterations equal per column, ``X`` at rtol 1e-5 / atol 1e-6 (the
  parity ladder's step 3), and every level operation made once a block,
  never a column. The reference runs its default COO execution: the same
  operators, summed in another order. Its cold setup and vmapped solve
  (≈ 25 s of compiles) are most of this file's time.
* the distributed block on a world of one: k = 3 through the facade's
  ``dist`` backend (ELL blocks on every distributed level) against the
  ``single`` backend, iterations equal per column and ``X`` at rtol 1e-5
  / atol 1e-5 (the dist facade's own tolerance); a ``dist.psum`` site
  draws once a pass, for k = 3 as for k = 1, as in the reference.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as J  # noqa: E402
import repro.core.hierarchy as JH  # noqa: E402
from repro.kernels.jacobi import jacobi_step as j_jacobi  # noqa: E402
from repro.kernels.jacobi import jacobi_step_ref as j_jacobi_ref  # noqa: E402
from repro.kernels.spmv_ell import spmv_ell as j_spmv  # noqa: E402
from repro.kernels.spmv_ell import spmv_ell_ref as j_spmv_ref  # noqa: E402
import torch_dist_helpers as H  # noqa: E402
from test_torch_solver import _flatten  # noqa: E402
from repro_torch.api import Problem, SolverOptions, setup  # noqa: E402
from repro_torch.convert import hierarchy_from_numpy  # noqa: E402
from repro_torch.core.hierarchy import apply_cycle  # noqa: E402
from repro_torch.kernels.jacobi import jacobi_step  # noqa: E402
from repro_torch.kernels.spmv_ell import spmv_ell  # noqa: E402
from repro_torch.testing import Fault, FaultPlan, inject  # noqa: E402

N_ROWS = 300                  # not a multiple of the Pallas 256-row block
# (width, k): every width of the card's ELL levels once, every k of the
# service, dist and spectral blocks at least once per kernel
SPMV_CASES = [(0, 3), (1, 64), (8, 3), (19, 8), (34, 1), (64, 8)]
JACOBI_CASES = [(0, 8), (1, 3), (8, 64), (19, 1), (34, 8), (64, 3)]


def _ell(rng, n_rows, n_cols, width, density=0.7):
    col = rng.integers(0, n_cols, (n_rows, width)).astype(np.int32)
    val = rng.normal(size=(n_rows, width)).astype(np.float32)
    pad = rng.random((n_rows, width)) > density
    col[pad] = n_cols
    val[pad] = 0
    return col, val


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _columns_bitwise(block, one):
    """Column j of ``block`` is bitwise ``one(j)``."""
    for j in range(block.shape[1]):
        assert torch.equal(block[:, j], one(j)), f"column {j}"


@pytest.mark.parametrize("width,k", SPMV_CASES)
def test_spmv_ell_block_matches_vmapped_pallas(width, k):
    rng = np.random.default_rng(10 * width + k)
    n_cols = N_ROWS + 40
    col, val = _ell(rng, N_ROWS, n_cols, width)
    X = rng.normal(size=(n_cols, k)).astype(np.float32)
    C, V, Xt = _t(col), _t(val), _t(X)
    got = spmv_ell(C, V, Xt)
    assert got.shape == (N_ROWS, k) and got.is_contiguous()
    _columns_bitwise(got, lambda j: spmv_ell(C, V, Xt[:, j].contiguous()))
    if width == 0:
        one = lambda x: j_spmv_ref(jnp.asarray(col), jnp.asarray(val), x)
    else:
        one = lambda x: j_spmv(jnp.asarray(col), jnp.asarray(val), x,
                               interpret=True)
    want = jax.vmap(one, in_axes=1, out_axes=1)(jnp.asarray(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("width,k", JACOBI_CASES)
def test_jacobi_block_matches_vmapped_pallas(width, k):
    rng = np.random.default_rng(100 * width + k)
    col, val = _ell(rng, N_ROWS, N_ROWS, width)
    X, B = (rng.normal(size=(N_ROWS, k)).astype(np.float32) for _ in range(2))
    deg = (0.5 + np.abs(rng.normal(size=N_ROWS)) * width).astype(np.float32)
    deg[::11] = 0.0                          # rows that keep x as it is
    C, V, Xt, Bt, D = (_t(a) for a in (col, val, X, B, deg))
    got = jacobi_step(C, V, Xt, Bt, D)
    assert got.shape == (N_ROWS, k)
    assert torch.equal(got[::11], Xt[::11])
    _columns_bitwise(got, lambda j: jacobi_step(
        C, V, Xt[:, j].contiguous(), Bt[:, j].contiguous(), D))
    jc, jv, jd = jnp.asarray(col), jnp.asarray(val), jnp.asarray(deg)
    if width == 0:
        one = lambda x, b: j_jacobi_ref(jc, jv, x, b, jd)
    else:
        one = lambda x, b: j_jacobi(jc, jv, x, b, jd, interpret=True)
    want = jax.vmap(one, in_axes=(1, 1), out_axes=1)(jnp.asarray(X),
                                                     jnp.asarray(B))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _two_components():
    """Two BA graphs side by side: a Laplacian with a 2-D nullspace."""
    parts = [H.ba(500, 3, 1), H.ba(300, 2, 2)]
    off, rows, cols, vals = 0, [], [], []
    for n, r, c, v in parts:
        rows.append(r + off)
        cols.append(c + off)
        vals.append(v)
        off += n
    return off, np.concatenate(rows), np.concatenate(cols), \
        np.concatenate(vals)


@pytest.fixture(scope="module")
def built():
    """The reference's facade on the two-component graph, a k = 3 block
    solved on its vmapped path (its default COO execution: its ELL twins
    take ≈ 30 s to set up on the CPU), and the port's facade on the same
    graph with ELL twins on every level, so that the k-column plain
    versions are on its path. The setup does not depend on the
    execution."""
    n, r, c, v = _two_components()
    B = H.mean_free(5, n, 3)
    ref = J.setup(J.Problem.from_edges(n, r, c, v), J.SolverOptions(
        exact_columns=False, coarsest_size=64), cache=False)
    JX, jres = ref.solve(B)
    port = setup(Problem.from_edges(n, r, c, v), SolverOptions(
        device="cpu", exact_columns=False, coarsest_size=64,
        matvec_backend="ell"), cache=False)
    return dict(n=n, B=B, ref=ref, JX=np.asarray(JX), jres=jres, port=port)


def test_block_vcycle_matches_vmapped_reference_cycle(built):
    """The reference's hierarchy, carried into the port with ELL twins on
    every level: one block V-cycle against ``jax.vmap(apply_cycle)`` on
    the reference's levels; each level operation runs once for the
    block."""
    from repro_torch.core.cycles import CycleConfig
    from repro_torch.core.hierarchy import SetupConfig, attach_ell_transfers

    js = built["ref"]._handle._solver
    jh = js.hierarchy
    kinds = {type(t).__name__ for t in jh.transfers}
    assert kinds == {"EliminationLevel", "AggregationLevel"}, kinds
    h = hierarchy_from_numpy(_flatten(jh), "cpu")
    h = dataclasses.replace(h, transfers=attach_ell_transfers(
        h.transfers, SetupConfig(matvec_backend="ell")))
    B = np.random.default_rng(3).normal(size=(built["n"], 4)).astype(
        np.float32)
    want = jax.vmap(lambda b: JH.apply_cycle(jh, b, js.cycle_config),
                    in_axes=1, out_axes=1)(jnp.asarray(B))
    calls = _count_calls()
    with calls:
        got = apply_cycle(h, _t(B), CycleConfig())
    assert calls.blocks > 0 and calls.vectors == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_pcg_block_throughput_path_matches_reference(built):
    """``exact_columns=False`` through the facade: per-column iterations
    equal to the reference's vmapped path and ``X`` at rtol 1e-5, with
    every ELL operation made on the block (and the component projector on
    the block)."""
    calls = _count_calls()
    with calls:
        X, res = built["port"].solve(built["B"])
    jres = built["jres"]
    assert res.converged and jres.converged
    np.testing.assert_array_equal(res.iters_per_rhs, jres.iters_per_rhs)
    np.testing.assert_allclose(X, built["JX"], rtol=1e-5, atol=1e-6)
    assert calls.blocks > 0 and calls.vectors == 0


class _count_calls:
    """Within the block, count the ELL wrappers' calls on vectors and on
    blocks (on the CPU the plain versions run, and a wrapper counts only
    its card launches)."""

    def __enter__(self):
        import repro_torch.kernels.jacobi as kj
        import repro_torch.kernels.spmv_ell as ks

        self.vectors = self.blocks = 0
        self.saved = [(ks, "spmv_ell", ks.spmv_ell),
                      (kj, "jacobi_step", kj.jacobi_step)]
        for mod, name, real in self.saved:
            def counted(col, val, x, *a, _real=real, **kw):
                if x.dim() == 2:
                    self.blocks += 1
                else:
                    self.vectors += 1
                return _real(col, val, x, *a, **kw)

            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


@pytest.fixture(scope="module")
def mesh():
    with H.world_of_one() as m:
        yield m


DIST_OPTS = SolverOptions(device="cpu", coarsest_size=16,
                          dist_nnz_threshold=1, matvec_backend="ell",
                          exact_columns=False)


def test_dist_block_matches_single_backend(mesh):
    p = Problem.from_edges(*H.ba(400, 3, 4))
    B = H.mean_free(6, p.n, 3)
    dist = setup(p, DIST_OPTS, backend="dist", mesh=mesh, cache=False)
    single = setup(p, DIST_OPTS, backend="single", cache=False)
    assert dist.stats()["levels"][0]["ell_width"] is not None
    calls = _count_calls()
    with calls:
        Xd, rd = dist.solve(B)
    Xs, rs = single.solve(B)
    assert rd.backend == "dist" and rd.status == "converged"
    np.testing.assert_array_equal(rd.iters_per_rhs, rs.iters_per_rhs)
    np.testing.assert_allclose(Xd, Xs, rtol=1e-5, atol=1e-5)
    assert calls.blocks > 0 and calls.vectors == 0


def test_dist_psum_draws_once_a_pass(mesh):
    """A ``dist.psum`` site armed inside the blocked preconditioner draws
    once per call site of a pass, on the block: a k = 3 solve draws as
    often as a k = 1 solve of the same steps (the reference traces its
    vmapped V-cycle once)."""
    p = Problem.from_edges(*H.ba(400, 3, 4))
    solver = setup(p, DIST_OPTS, backend="dist", mesh=mesh, cache=False)
    inner = solver._handle._solver
    draws = []
    for k in (1, 3):
        plan = FaultPlan({"dist.psum": Fault(mode="nan", at_calls=())})
        with inject(plan):
            inner.solve_block(H.mean_free(7, p.n, k), n_iters=3, tol=0.0)
        draws.append(plan.counts["dist.psum"])
    assert draws[0] == draws[1] > 0, draws


def test_level_spmm_makes_one_block_call():
    """``level_spmm`` (the strength sweeps) makes one k-column call on a
    level with an ELL twin, never one a column."""
    from repro_torch.core.graph import attach_setup_twin, graph_from_adjacency
    from repro_torch.graphs.generators import to_laplacian_coo
    from repro_torch.sparse.ell import ell_layout_traced
    from repro_torch.sparse.matvec import level_spmm

    n, r, c, v = H.ba(300, 3, 8)
    level = graph_from_adjacency(to_laplacian_coo(n, r, c, v, device="cpu"))
    twin = attach_setup_twin(level, ell_layout_traced(
        level.adj.row, level.adj.col, level.n, 8))
    X = _t(np.random.default_rng(9).normal(size=(n, 8)).astype(np.float32))
    calls = _count_calls()
    with calls:
        got = level_spmm(twin, X)
    assert (calls.blocks, calls.vectors) == (1, 0)
    np.testing.assert_allclose(got.numpy(), level_spmm(
        dataclasses.replace(twin, ell=None, ell_rem=None), X).numpy(),
        rtol=1e-5, atol=1e-5)


# The k-column kernels' plan and summation order (csrc/ell_tiles.cuh,
# block_tiles_kernel): checked here without a card.
PLAN_KS = (1, 2, 3, 4, 8, 12, 32, 64, 128)
BLOCK_PARTIALS = 16          # a thread's partial sums, (P / T)·c, at most


@pytest.mark.parametrize("k", PLAN_KS)
def test_ell_block_tile_plan_rules(k):
    """At every width 0 … 64: whole warps, at most 256 consumer threads;
    shared memory within a block's; c divides k (4 only where k % 4 == 0);
    T a power of two dividing P with (P/T)·c within the budget, and the
    fewest that is; tiles of a multiple of 4 rows (16-byte bulk copies);
    and, following the kernel's thread → unit map, every (row, column)
    pair of a tile owned by exactly one thread (its unit's thread t = 0),
    a unit's T threads in one warp, and at most two units a thread
    wherever a row takes at most 64 threads."""
    from repro_torch.kernels import (SMEM_PER_BLOCK, ell_block_tile_plan,
                                     ell_lanes)

    for width in range(65):
        plan = ell_block_tile_plan(width, k)
        rows, stages, smem, c, T, threads = plan
        P = ell_lanes(width)
        assert threads % 32 == 0 and 32 <= threads <= 256, plan
        assert smem <= SMEM_PER_BLOCK and rows % 4 == 0, plan
        assert k % c == 0 and (c == 4) == (k % 4 == 0), plan
        assert c == 2 or k % 4 == 0 or k % 2 == 1, plan
        assert T & (T - 1) == 0 and P % T == 0, plan
        assert (P // T) * c <= BLOCK_PARTIALS, plan
        assert T == 1 or (P // (T // 2)) * c > BLOCK_PARTIALS, plan  # fewest
        if width:
            assert 2 <= stages <= 8 and smem == stages * rows * width * 8
        else:
            assert (stages, smem) == (0, 0), plan
        groups = k // c
        owner = np.full((rows, k), -1)
        units_of = np.zeros(threads, dtype=int)
        for tid in range(threads):
            t, first = tid % T, tid // T
            assert (first * T) // 32 == (first * T + T - 1) // 32, plan
            for u in range(first, rows * groups, threads // T):
                units_of[tid] += 1
                r, g = divmod(u, groups)
                if t == 0:
                    assert (owner[r, g * c:(g + 1) * c] == -1).all()
                    owner[r, g * c:(g + 1) * c] = tid
        assert (owner >= 0).all(), plan
        if groups * T <= 64:
            assert units_of.max() <= 2, plan


def _row_sum_order(prod):
    """The one-vector kernel's order (``row_sum``): P lanes, lane j from
    +0 adding slots j, j+P, … left to right (a slot past the row adds 0),
    then the halving tree; on ``prod`` [rows, width] float32 products."""
    n, w = prod.shape
    P = min(1 << (w.bit_length() - 1), 32)
    zero = np.zeros(n, np.float32)
    s = [np.float32(0) + prod[:, j] for j in range(P)]
    for k0 in range(P, w, P):
        s = [s[j] + (prod[:, k0 + j] if k0 + j < w else zero)
             for j in range(P)]
    off = P // 2
    while off:
        s = [s[j] + s[j + off] if j < off else s[j] for j in range(P)]
        off //= 2
    return s[0]


def _split_order(prod, T):
    """The k-column kernel's order: T threads, thread t holding lanes t,
    t+T, … (P/T of them) and adding their slots as ``row_sum``'s lanes do;
    the tree's offsets >= T inside each thread, then ``__shfl_down_sync``
    of width T for offsets T/2 … 1 (a source past the T threads gives a
    thread its own value)."""
    n, w = prod.shape
    P = min(1 << (w.bit_length() - 1), 32)
    N = P // T
    zero = np.zeros(n, np.float32)
    s = [[np.float32(0) + prod[:, t + i * T] for i in range(N)]
         for t in range(T)]
    for k0 in range(P, w, P):
        for t in range(T):
            for i in range(N):
                slot = k0 + t + i * T
                s[t][i] = s[t][i] + (prod[:, slot] if slot < w else zero)
    for t in range(T):
        off = N // 2
        while off:
            s[t] = [s[t][i] + s[t][i + off] if i < off else s[t][i]
                    for i in range(N)]
            off //= 2
    a = [s[t][0] for t in range(T)]
    off = T // 2
    while off:
        a = [a[t] + (a[t + off] if t + off < T else a[t]) for t in range(T)]
        off //= 2
    return a[0]


@pytest.mark.parametrize("k", PLAN_KS)
def test_block_split_order_is_row_sum_order_bitwise(k):
    """At widths 1 … 64, for the T that the plan picks at ``k``: the split
    over T threads adds exactly as ``row_sum`` does, bitwise, on rows of
    float32 products spread over twelve binades (a padding slot's +0
    among them), where another order rounds otherwise."""
    from repro_torch.kernels import ell_block_tile_plan

    rng = np.random.default_rng(k)
    differs = 0
    for w in range(1, 65):
        T = ell_block_tile_plan(w, k).unit_threads
        prod = (rng.normal(size=(64, w))
                * 2.0 ** rng.integers(-6, 6, (64, w))).astype(np.float32)
        prod[rng.random((64, w)) < 0.2] = 0.0
        want = _row_sum_order(prod)
        got = _split_order(prod, T)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            f"width {w}, T {T}"
        seq = np.zeros(64, np.float32)
        for j in range(w):
            seq = seq + prod[:, j]
        differs += int((seq != want).sum())
    assert differs > 0        # the rows do tell one order from another
