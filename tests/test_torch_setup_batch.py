"""The port's batched setup: one stacked program per super-step over a
group of same-bucket graphs, with the graph-batched ``agg_vote`` kernel
(what the reference's ``jax.vmap`` makes of ``vote_reduce_pallas``).

The plain graph-batched vote (the CPU form of ``vote_reduce_batched``) is
held bit-exact against ``jax.vmap`` of the reference's ``vote_reduce`` in
Pallas interpret mode, and against one-graph calls, on stacked tables of
Barabási–Albert graphs (hub rows that spill, Decided neighbours, padding
rows), at width 0 and for groups of 1, 3 and 4. The stacked forms of the
sparse primitives are held bitwise against their one-graph forms a graph
at a time. On the four graphs of ``tests/test_setup_batch.py`` (grid 16x16
seeds 0 and 1, BA n = 300 m = 3 seeds 0 and 1, ``coarsest_size=32``,
``setup_bucket_floor=2048``) the port's batched setup runs each vote round
of a group as ONE graph-batched call, is bitwise its looped builds, and
holds the reference's ``build_hierarchy_batch`` as
``tests/test_torch_setup_step.py`` holds its single builds: the same
levels, integer arrays bit-exact, float arrays within rtol 1e-6 (ROADMAP
C1) and the same PCG iteration counts at tol 1e-8; the same with
``setup_ell_sweeps=True`` for the two BA graphs. The reference's batched
compile (each member traced into one program) is most of this file's
time.
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

from repro.core.coarsen import AggregationLevel as JAgg  # noqa: E402
from repro.core.hierarchy import SetupConfig as JConfig  # noqa: E402
from repro.core.solver import LaplacianSolver as JSolver  # noqa: E402
from repro.graphs.generators import (barabasi_albert,  # noqa: E402
                                     ensure_connected, grid_2d)
from repro.kernels.agg_vote import vote_reduce as j_vote  # noqa: E402
import repro_torch.kernels.agg_vote as vote_pkg  # noqa: E402
import repro_torch.kernels.spmv_ell as spmv_pkg  # noqa: E402
from repro_torch.core import setup_step as ss  # noqa: E402
from repro_torch.core.hierarchy import (SetupConfig,  # noqa: E402
                                        hierarchy_stats)
from repro_torch.core.solver import LaplacianSolver  # noqa: E402
from repro_torch.kernels.agg_vote import (vote_reduce_batched,  # noqa: E402
                                          vote_reduce_batched_ref,
                                          vote_reduce_ref)
from repro_torch.sparse.coo import (coalesce_arrays,  # noqa: E402
                                    coalesce_arrays_groups)
from repro_torch.sparse.ell import (ell_layout_groups,  # noqa: E402
                                    ell_layout_traced)
from repro_torch.sparse.segment import (segment_sum,  # noqa: E402
                                        segment_sum_groups)

LEVELS = 1 << 20
CFG = SetupConfig(coarsest_size=32, setup_bucket_floor=2048)
JCFG = JConfig(coarsest_size=32, setup_bucket_floor=2048)
SWEEPS = dataclasses.replace(CFG, matvec_backend="auto",
                             setup_ell_sweeps=True)
JSWEEPS = dataclasses.replace(JCFG, matvec_backend="auto",
                              setup_ell_sweeps=True)
SPECS = [("grid_2d", 0), ("grid_2d", 1), ("barabasi_albert", 0),
         ("barabasi_albert", 1)]


def _graph(name, seed=0):
    if name == "grid_2d":
        return ensure_connected(*grid_2d(16, 16, weighted=True, seed=seed))
    return ensure_connected(*barabasi_albert(300, m=3, seed=seed,
                                             weighted=True))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _leaves(obj, path=""):
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            yield from _leaves(x, f"{path}[{i}]")


def _assert_bitwise(ha, hb):
    la, lb = list(_leaves(ha)), list(_leaves(hb))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        x, y = x.reshape(-1), y.reshape(-1)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), path


def _sig(h):
    return [(r["kind"], r["n"], r["nnz"])
            for r in hierarchy_stats(h)["levels"]]


# ----------------------------------------------------------------------------
# The graph-batched vote's plain version
# ----------------------------------------------------------------------------

def _stacked_edges(n_graphs, n_cap=512, e_cap=4096):
    """[G, e_cap] padded edge lists of BA graphs (n = 300, m = 3, seeds
    0..G-1: hubs of degree far above the vote width), each graph's own
    ids, sentinel n_cap."""
    rows, cols = [], []
    for seed in range(n_graphs):
        n, r, c, _ = _graph("barabasi_albert", seed)
        rr = np.full(e_cap, n_cap, np.int32)
        cc = np.full(e_cap, n_cap, np.int32)
        rr[:2 * len(r)] = np.concatenate([r, c])
        cc[:2 * len(r)] = np.concatenate([c, r])
        rows.append(rr)
        cols.append(cc)
    return torch.from_numpy(np.stack(rows)), torch.from_numpy(np.stack(cols))


def _vote_case(n_graphs, width, seed=0):
    n_cap = 512
    row, col = _stacked_edges(n_graphs, n_cap)
    lay = ell_layout_groups(row, col, n_cap, width)
    rng = np.random.default_rng(seed)
    sq = torch.from_numpy(rng.integers(0, 4, row.shape).astype(np.int32))
    state = rng.integers(0, 3, (n_graphs, n_cap)).astype(np.int32)
    state[:, 300:] = 0                   # padding vertices are Decided
    return (lay.col_table.view(n_graphs, n_cap, width),
            lay.table(sq).view(n_graphs, n_cap, width),
            torch.from_numpy(state), lay)


@pytest.mark.parametrize("n_graphs,width", [(1, 8), (3, 8), (4, 8), (3, 0)])
def test_vote_batched_plain_bit_exact_vs_vmapped_pallas(n_graphs, width):
    col, sq, state, lay = _vote_case(n_graphs, width, seed=n_graphs)
    if width:
        assert (lay.spill_row < 512).any()      # hub rows spill
    k, i = vote_reduce_batched(col, sq, state, levels=LEVELS)
    vote = jax.vmap(lambda c, q, s: j_vote(c, q, s, levels=LEVELS,
                                           decided=0, interpret=True))
    wk, wi = vote(jnp.asarray(col.numpy()), jnp.asarray(sq.numpy()),
                  jnp.asarray(state.numpy()))
    np.testing.assert_array_equal(k.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    assert k.shape == i.shape == (n_graphs, 512)
    if width == 0:
        assert (k == torch.iinfo(torch.int32).min).all()
        assert (i == torch.iinfo(torch.int32).max).all()
    else:
        # padding rows and rows whose neighbours are all Decided: identity
        assert (k[:, 300:] == torch.iinfo(torch.int32).min).all()
        assert (k[:, :300] > torch.iinfo(torch.int32).min).any()


@pytest.mark.parametrize("n_graphs", [1, 3, 4])
def test_vote_batched_plain_equals_one_graph_calls(n_graphs):
    col, sq, state, _ = _vote_case(n_graphs, 8, seed=10 + n_graphs)
    k, i = vote_reduce_batched_ref(col, sq, state, levels=LEVELS)
    for g in range(n_graphs):
        kg, ig = vote_reduce_ref(col[g], sq[g], state[g], levels=LEVELS)
        assert torch.equal(k[g], kg) and torch.equal(i[g], ig)


def test_vote_batched_on_cpu_runs_plain_and_refuses_other_devices():
    col, sq, state, _ = _vote_case(2, 8)
    before = vote_reduce_batched.launches
    got = vote_reduce_batched(col, sq, state, levels=LEVELS)
    want = vote_reduce_batched_ref(col, sq, state, levels=LEVELS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert vote_reduce_batched.launches == before
    meta = torch.zeros((2, 4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        vote_reduce_batched(meta, meta, meta[:, :, 0], levels=4)


# ----------------------------------------------------------------------------
# Stacked primitives against their one-graph forms, a graph at a time
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 3])
def test_segment_sum_groups_bitwise_per_graph(k):
    rng = np.random.default_rng(k)
    g, m, n = 3, 5000, 700
    ids = torch.from_numpy(rng.integers(-5, n + 40, (g, m)))
    shape = (g, m) if k == 0 else (g, m, k)
    data = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    got = segment_sum_groups(data, ids, n)
    ints = segment_sum_groups(torch.ones_like(ids, dtype=torch.int32), ids,
                              n)
    for i in range(g):
        want = segment_sum(data[i], ids[i], n)
        assert torch.equal(got[i].view(torch.int32), want.view(torch.int32))
        assert torch.equal(ints[i], segment_sum(torch.ones_like(
            ids[i], dtype=torch.int32), ids[i], n))


def test_coalesce_and_layout_groups_bitwise_per_graph():
    row, col = _stacked_edges(3)
    rng = np.random.default_rng(3)
    # duplicates to sum: every entry twice, in another order
    perm = torch.from_numpy(rng.permutation(row.shape[1]))
    row2, col2 = torch.cat([row, row[:, perm]], 1), torch.cat(
        [col, col[:, perm]], 1)
    val = torch.from_numpy(rng.random(row2.shape).astype(np.float32))
    n_rows = torch.tensor([300, 250, 512], dtype=torch.int32)
    out = coalesce_arrays_groups(row2, col2, val, n_rows, 3000, sentinel=512)
    lay = ell_layout_groups(row, col, 512, 8)
    sq = torch.from_numpy(rng.integers(0, 9, row.shape).astype(np.int32))
    for g in range(3):
        want = coalesce_arrays(row2[g], col2[g], val[g], n_rows[g], 3000,
                               sentinel=512)
        for a, b in zip(out, want):
            a = a[g]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)
        one = ell_layout_traced(row[g], col[g], 512, 8)
        assert torch.equal(lay.col_table[g * 512:(g + 1) * 512],
                           one.col_table)
        assert torch.equal(lay.table(sq)[g * 512:(g + 1) * 512],
                           one.table(sq[g]))
        for name in ("spill_row", "spill_col"):
            assert torch.equal(getattr(lay, name)[g], getattr(one, name))
        assert torch.equal(lay.spill(sq)[g], one.spill(sq[g]))


# ----------------------------------------------------------------------------
# The batched setup against its looped builds and the reference
# ----------------------------------------------------------------------------

def _counting(monkey, pkg, name, seen):
    real = getattr(pkg, name)

    def counted(*args, **kw):
        seen.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkey.setattr(pkg, name, counted)


def _rhs(n):
    b = np.random.default_rng(7).normal(size=n).astype(np.float32)
    return b - b.mean()


def _run(problems, cfg, jcfg, spmv_calls=False):
    """The reference's batched setup, the port's batched setup (its vote
    and ELL SpMV calls counted) and the port's looped setups of
    ``problems``, with each one's PCG solve of one right-hand side."""
    out = dict(ref=JSolver.setup_batch(problems, setup_config=jcfg))
    batched, single, spmvs = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        _counting(mp, vote_pkg, "vote_reduce_batched", batched)
        _counting(mp, vote_pkg, "vote_reduce", single)
        if spmv_calls:
            _counting(mp, spmv_pkg, "spmv_ell", spmvs)
        ss.reset_counters()
        out["port"] = LaplacianSolver.setup_batch(problems, setup_config=cfg,
                                                  device="cpu")
        out["steps"] = ss.counters()["steps"]
    out.update(batched_votes=batched, single_votes=single, spmvs=spmvs)
    out["looped"] = [LaplacianSolver.setup(n, r, c, v, cfg, device="cpu")
                     for n, r, c, v in problems]
    for name in ("ref", "port", "looped"):
        out[f"{name}_solves"] = [s.solve(_rhs(p[0]), tol=1e-8)
                                 for s, p in zip(out[name], problems)]
    return out


@pytest.fixture(scope="module")
def four():
    return _run([_graph(name, seed) for name, seed in SPECS], CFG, JCFG)


@pytest.fixture(scope="module")
def sweeps_pair():
    return _run([_graph(name, seed) for name, seed in SPECS[2:]], SWEEPS,
                JSWEEPS, spmv_calls=True)


CASES = ["four", "sweeps_pair"]


@pytest.fixture(params=CASES)
def run(request):
    return request.getfixturevalue(request.param)


def test_one_graph_batched_vote_call_a_round(run):
    steps = run["steps"]
    agg_batches = steps["agg@batch"]["calls"]
    assert agg_batches > 0 and "agg" not in steps
    votes = run["batched_votes"]
    assert len(votes) == agg_batches * CFG.aggregation.n_rounds
    assert votes[0][0] == len(run["port"])       # the whole batch at first
    assert all(v[0] >= 2 and v[1:] == (2048, CFG.setup_ell_width)
               for v in votes)
    assert run["single_votes"] == []


def test_batched_bitwise_equals_looped(run):
    for sb, sl in zip(run["port"], run["looped"]):
        assert _sig(sb.hierarchy) == _sig(sl.hierarchy)
        _assert_bitwise(sb.hierarchy, sl.hierarchy)
    for (xb, ib), (xl, il) in zip(run["port_solves"], run["looped_solves"]):
        assert ib.residual_norms == il.residual_norms
        np.testing.assert_array_equal(np.asarray(xb), np.asarray(xl))


def test_levels_and_integer_arrays_match_reference(run):
    for sp, sr in zip(run["port"], run["ref"]):
        assert _sig(sp.hierarchy) == [(r["kind"], r["n"], r["nnz"])
                                      for r in sr.stats()["levels"]]
        for i, (tt, jt) in enumerate(zip(sp.hierarchy.transfers,
                                         sr.hierarchy.transfers)):
            if isinstance(jt, JAgg):
                names = ("coarse_id",)
            else:
                names = ("elim_mask", "c_index", "f_index", "f_vertices")
                for f in ("row", "col"):
                    np.testing.assert_array_equal(
                        _np(getattr(tt.p_f, f)),
                        np.asarray(getattr(jt.p_f, f)))
            for name in names:
                np.testing.assert_array_equal(
                    _np(getattr(tt, name)), np.asarray(getattr(jt, name)),
                    f"level {i} {name}")
            for f in ("row", "col"):
                np.testing.assert_array_equal(
                    _np(getattr(tt.coarse.adj, f)),
                    np.asarray(getattr(jt.coarse.adj, f)))


def test_float_arrays_close_to_reference(run):
    for sp, sr in zip(run["port"], run["ref"]):
        for tt, jt in zip(sp.hierarchy.transfers, sr.hierarchy.transfers):
            for got, want in ((tt.coarse.adj.val, jt.coarse.adj.val),
                              (tt.coarse.deg, jt.coarse.deg)):
                np.testing.assert_allclose(_np(got), np.asarray(want),
                                           rtol=1e-6)
            if not isinstance(jt, JAgg):
                np.testing.assert_allclose(_np(tt.p_f.val),
                                           np.asarray(jt.p_f.val), rtol=1e-6)
                np.testing.assert_allclose(_np(tt.inv_deg_f),
                                           np.asarray(jt.inv_deg_f),
                                           rtol=1e-6)


def test_pcg_iterations_match_reference(run):
    for (xp, ip), (xr, ir) in zip(run["port_solves"], run["ref_solves"]):
        assert ip.converged and ip.iters == ir.iters
        np.testing.assert_allclose(np.asarray(xp), np.asarray(xr),
                                   rtol=1e-5, atol=1e-5)


def test_sweeps_run_the_stacked_twin(sweeps_pair):
    """With ``setup_ell_sweeps`` the strength sweeps and λmax SpMVs of a
    group run one ELL table of G·n_cap rows (the stacked twin)."""
    assert (2 * 2048, 8) in sweeps_pair["spmvs"]


# ----------------------------------------------------------------------------
# The registry: shared constants, the int32 guard, hooked builders
# ----------------------------------------------------------------------------

def test_batched_agg_entry_shares_the_bucket_constants():
    steps = ss.SuperstepBuilders(CFG, "cpu")
    one = steps.step("agg", (2048, 2048))
    group = steps.step("agg", (2048, 2048), batch=3)
    fns = [fn for (name, _), fn in ss._CACHE.items()
           if name == "agg@batch" and fn is group]
    assert len(fns) == 1
    assert group.step.constants[0] is one.constants[0]
    assert group.step.constants[1] is one.constants[1]


def test_group_beyond_int32_raises():
    steps = ss.SuperstepBuilders(CFG, "cpu")
    before = dict(ss._CACHE)
    with pytest.raises(ValueError, match="int32"):
        steps.step("agg", (1 << 29, 1 << 10), batch=4)
    with pytest.raises(ValueError, match="int32"):
        steps.step("ingest_fast", (1 << 30, 1 << 10, 1 << 30), batch=2)
    assert dict(ss._CACHE) == before
    ss.check_group("agg", (1 << 28, 1 << 10), 7, CFG.elim_max_degree)


def test_hooked_builders_run_members_in_turn(monkeypatch):
    """Builders with a semiring hook (the distributed ones) keep the looped
    member runs: one-graph votes, bitwise the stacked build."""
    class Hooked(ss.SuperstepBuilders):
        def vote_factory(self, n_cap, e_cap):
            return None

    problems = [_graph(name, seed) for name, seed in SPECS[:2]]
    from repro_torch.graphs.generators import to_laplacian_coo
    adjs = [to_laplacian_coo(n, r, c, v, device="cpu")
            for n, r, c, v in problems]
    batched, single = [], []
    _counting(monkeypatch, vote_pkg, "vote_reduce_batched", batched)
    _counting(monkeypatch, vote_pkg, "vote_reduce", single)
    hooked = ss.build_hierarchy_superstep_batch(adjs, CFG,
                                                steps=Hooked(CFG, "cpu"))
    assert batched == [] and len(single) > 0
    single.clear()
    stacked = ss.build_hierarchy_superstep_batch(adjs, CFG)
    assert len(batched) > 0 and single == []
    for a, b in zip(hooked, stacked):
        _assert_bitwise(a, b)
