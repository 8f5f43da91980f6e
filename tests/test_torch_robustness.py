"""The port's robustness layer against the reference's, after
``tests/test_faults.py`` and ``tests/test_robustness.py``.

The same ``FaultPlan`` is armed on each package in turn (one process, so
both draw the same corrupted entries) around the same solve: the fired
records, the per-site call counts, the statuses and the ladder's stage
sequences must be equal, for every host site the single backend has
(``solve.spmv``, ``solve.precond``, ``solve.residual``, ``setup.build``,
``setup.coarse_inv``, ``setup.lambda_max``). Then disconnected graphs and
isolated vertices against the reference and a dense pseudo-inverse
oracle, guards on vs off bitwise within the port, ``pcg_scanned``'s codes
and norms against the reference's, and triage reports equal to the
reference's. Plans are armed only through ``inject`` and every setup runs
with ``cache=False``.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.api as J  # noqa: E402
import repro.testing as JT  # noqa: E402
import repro.testing.faults as JF  # noqa: E402
from repro.api.triage import triage_problem as j_triage  # noqa: E402
from repro.core import krylov as jk  # noqa: E402
import repro_torch.testing as TT  # noqa: E402
from repro_torch.testing.faults import site_key  # noqa: E402
from repro_torch.api import Problem, SolverOptions, setup  # noqa: E402
from repro_torch.api.triage import triage_problem  # noqa: E402
from repro_torch.core import krylov as tk  # noqa: E402
from repro_torch.graphs.generators import (barabasi_albert,  # noqa: E402
                                           ensure_connected, grid_2d)
from repro_torch.testing import (Fault, FaultPlan, InjectedFault,  # noqa: E402
                                 active, checkpoint, inject, site)

KW = dict(coarsest_size=64, max_iters=200)
EXPLICIT = ("converged", "max_iters", "degraded", "failed")


@pytest.fixture(scope="module", autouse=True)
def _stable_site_key():
    """The port draws its faults from a stable key of the site name
    (``site_key``); the reference's module ``hash`` is shadowed with the
    same key, so one plan armed on both packages corrupts the same entries
    whatever ``PYTHONHASHSEED`` is."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "hash", site_key, raising=False)
        yield


def ba(n=300, seed=0):
    return ensure_connected(*barabasi_albert(n, m=3, seed=seed,
                                             weighted=True))


def mean_free(seed, n, k=None):
    b = np.random.default_rng(seed).normal(size=n if k is None else (n, k))
    return (b - b.mean(axis=0)).astype(np.float32)


def both(graph, **kw):
    """``(port solver, reference solver)`` on one graph and options."""
    port = setup(Problem.from_edges(*graph),
                 SolverOptions(device="cpu", **{**KW, **kw}), cache=False)
    ref = J.setup(J.Problem.from_edges(*graph),
                  J.SolverOptions(**{**KW, **kw}), cache=False)
    return port, ref


@pytest.fixture(scope="module")
def pair():
    return both(ba())


def run_armed(faults, fn, **plan_kw):
    """Arm the same faults on each package in turn around ``fn(package)``;
    returns ``[(plan, result), ...]`` for the port, then the reference."""
    out = []
    for pkg, mod in (("port", TT), ("ref", JT)):
        plan = mod.FaultPlan({k: mod.Fault(**f) for k, f in faults.items()},
                             **plan_kw)
        with mod.inject(plan):
            out.append((plan, fn(pkg)))
    return out


def outcome(res):
    return dict(status=res.status, statuses=res.statuses.tolist(),
                stages=[d["stage"] for d in res.diagnostics],
                rungs=[(d["status"], d["statuses"], d["recovered"])
                       for d in res.diagnostics],
                iters=res.iters_per_rhs.tolist())


def same_run(runs):
    (pplan, pres), (jplan, jres) = runs
    assert pplan.fired and pplan.fired == jplan.fired
    assert pplan.counts == jplan.counts
    assert outcome(pres[1]) == outcome(jres[1])
    return pres, jres


# ----------------------------------------------------------------------
# The harness
# ----------------------------------------------------------------------
def test_sites_and_constants_match_reference():
    assert TT.SITES == JT.SITES and TT.TRACED_SITES == JT.TRACED_SITES
    assert TT.KILL_EXIT_CODE == JT.KILL_EXIT_CODE
    from repro.testing import faults as jf
    from repro_torch.testing import faults as tf
    assert tf._MODES == jf._MODES


@pytest.mark.parametrize("mode", ["nan", "inf", "huge", "zero", "negate",
                                  "bitflip", "perturb"])
def test_corruption_equals_reference(mode):
    """One plan on both packages corrupts the same entries the same way;
    a tensor comes back a tensor of its dtype and device."""
    x = np.linspace(-2.0, 3.0, 97).astype(np.float32)
    got = []
    for mod, arr in ((JT, jnp.asarray(x)), (TT, torch.as_tensor(x)),
                     (TT, x)):
        plan = mod.FaultPlan({"solve.spmv": mod.Fault(
            mode=mode, at_calls=(1,), fraction=0.25)}, seed=3)
        with mod.inject(plan):
            mod.site("solve.spmv", arr)
            got.append(mod.site("solve.spmv", arr))
        assert plan.fired == [("solve.spmv", 1, mode)]
    want, tensor, host = got
    assert isinstance(tensor, torch.Tensor) and tensor.dtype == torch.float32
    assert tensor.device == torch.device("cpu")
    assert isinstance(host, np.ndarray) and host.dtype == np.float32
    np.testing.assert_array_equal(tensor.numpy(), np.asarray(want))
    np.testing.assert_array_equal(host, np.asarray(want))
    assert not np.array_equal(host, x, equal_nan=True)


def test_unarmed_is_identity_and_counts():
    x = torch.ones(4)
    assert active() is None and site("solve.spmv", x) is x
    plan = FaultPlan({"solve.spmv": Fault(mode="nan", at_calls=(1,))})
    with inject(plan):
        a = site("solve.spmv", x)
        b = site("solve.spmv", x)
        site("solve.precond", x)
    assert a is x and torch.isnan(b).any()
    assert plan.fired == [("solve.spmv", 1, "nan")]
    assert plan.counts == {"solve.spmv": 2, "solve.precond": 1}


def test_raise_checkpoint_validation_and_reentry():
    with inject(FaultPlan({"service.setup": Fault(mode="raise")})):
        with pytest.raises(InjectedFault, match="service.setup"):
            checkpoint("service.setup")
    checkpoint("service.setup")
    with pytest.raises(ValueError, match="mode"):
        Fault(mode="explode")
    with pytest.raises(ValueError, match="fraction"):
        Fault(fraction=0.0)
    with pytest.raises(TypeError, match="Fault"):
        FaultPlan({"solve.spmv": "nan"})
    with inject(FaultPlan({})):
        with pytest.raises(RuntimeError, match="already armed"):
            with inject(FaultPlan({})):
                pass
    assert active() is None


def test_traced_hooks_name_the_dist_item():
    """The traced hooks of the distributed solver (ROADMAP A11, ported):
    ``trace_token`` is None unless a plan with traced sites is armed, then
    unique; ``site_traced`` is the identity with no plan; and the same
    plan's ``apply_traced`` corrupts the same entries, in float and int32
    lanes and on the same one shard, as the reference's."""
    plan = FaultPlan({"dist.spmv": Fault()})
    assert plan.wants_traced() and not FaultPlan({}).wants_traced()
    x = torch.ones(2)
    assert TT.site_traced("dist.spmv", x) is x and TT.trace_token() is None
    with inject(FaultPlan({"solve.spmv": Fault()})):
        assert TT.trace_token() is None
    with inject(plan):
        a, b = TT.trace_token(), TT.trace_token()
        assert a is not None and a != b
    rng = np.random.default_rng(0)
    for mode, dtype, shard in itertools.product(
            ("nan", "huge", "bitflip", "perturb", "negate"),
            (np.float32, np.int32), range(4)):
        base = (rng.normal(size=40) * 100).astype(dtype)
        kw = dict(axis_index=shard, n_shards=4)
        got = TT.FaultPlan({"dist.psum": TT.Fault(mode=mode, fraction=0.2)}
                           ).apply_traced("dist.psum", torch.as_tensor(base),
                                          **kw)
        want = JT.FaultPlan({"dist.psum": JT.Fault(mode=mode, fraction=0.2)}
                            ).apply_traced("dist.psum", jnp.asarray(base),
                                           **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# The same plan on both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name",
                         ["solve.spmv", "solve.precond", "solve.residual"])
def test_solve_sites_match_reference(pair, name):
    b = mean_free(2, 300)
    runs = run_armed({name: dict(mode="nan", at_calls=(1,), fraction=0.3)},
                     lambda pkg: pair[pkg == "ref"].solve(b))
    pres, jres = same_run(runs)
    assert pres[1].status in ("converged", "degraded")
    assert pres[1].diagnostics[0]["stage"] == "primary"
    np.testing.assert_allclose(pres[0], np.asarray(jres[0]), rtol=1e-5,
                               atol=1e-5)


def test_setup_build_matches_reference():
    p, jp = Problem.from_edges(*ba()), J.Problem.from_edges(*ba())
    fired = []
    for mod, run in ((TT, lambda: setup(p, SolverOptions(device="cpu", **KW),
                                        cache=False)),
                     (JT, lambda: J.setup(jp, J.SolverOptions(**KW),
                                          cache=False))):
        plan = mod.FaultPlan({"setup.build": mod.Fault(mode="raise")})
        with mod.inject(plan):
            with pytest.raises(mod.InjectedFault, match="setup.build"):
                run()
        fired.append(plan.fired)
    assert fired[0] == fired[1] == [("setup.build", 0, "raise")]


@pytest.mark.parametrize("at_call", [0, 1])
def test_setup_build_in_batch_matches_reference(at_call):
    """The batched setup passes ``setup.build`` once, at its entry, as the
    reference's does: armed at call 0 it raises before any work, and a
    fault at call 1 never fires (a batch is one build)."""
    from repro.core.solver import LaplacianSolver as JSolver
    from repro_torch.core.solver import LaplacianSolver as TSolver

    graphs = [ba(120, seed=s) for s in (3, 4)]
    runs = []
    for mod, run in ((TT, lambda: TSolver.setup_batch(graphs,
                                                      device="cpu")),
                     (JT, lambda: JSolver.setup_batch(graphs))):
        plan = mod.FaultPlan({"setup.build": mod.Fault(
            mode="raise", at_calls=(at_call,))})
        with mod.inject(plan):
            if at_call == 0:
                with pytest.raises(mod.InjectedFault, match="setup.build"):
                    run()
            else:
                assert len(run()) == 2
        runs.append((plan.fired, plan.counts))
    assert runs[0] == runs[1]
    assert runs[0][1]["setup.build"] == 1


@pytest.mark.parametrize("name", ["setup.coarse_inv", "setup.lambda_max"])
def test_poisoned_setup_artifact_matches_reference(name):
    graph, b = ba(), mean_free(1, 300)
    opts = dict(port=SolverOptions(device="cpu", **KW),
                ref=J.SolverOptions(**KW))
    probs = dict(port=Problem.from_edges(*graph),
                 ref=J.Problem.from_edges(*graph))
    mods = dict(port=setup, ref=J.setup)
    runs = run_armed({name: dict(mode="nan", at_calls=None, fraction=0.5)},
                     lambda pkg: mods[pkg](probs[pkg], opts[pkg],
                                           cache=False))
    (pplan, psolver), (jplan, jsolver) = runs
    assert pplan.fired and pplan.fired == jplan.fired
    x, res = psolver.solve(b)
    jx, jres = jsolver.solve(b)
    assert outcome(res) == outcome(jres)
    assert res.status in ("converged", "degraded") and np.isfinite(x).all()


@pytest.mark.parametrize("dense_max", [4096, 0])
def test_persistent_faults_walk_the_ladder_as_reference(dense_max):
    """Every SpMV corrupted: the dense rung (or, gated off, an explicit
    failure) ends the ladder, rung by rung as in the reference."""
    port, ref = both(ba(300, seed=11), dense_fallback_max=dense_max)
    b = mean_free(12, 300)
    runs = run_armed({"solve.spmv": dict(mode="nan", at_calls=None,
                                         fraction=0.1)},
                     lambda pkg: (port, ref)[pkg == "ref"].solve(b, tol=1e-6))
    pres, _ = same_run(runs)
    res = pres[1]
    assert [d["stage"] for d in res.diagnostics] == [
        "primary", "rebuild", "diag_pcg", "dense"]
    if dense_max:
        assert res.status == "degraded" and res.diagnostics[-1]["recovered"]
    else:
        assert res.status == "failed"
        assert res.diagnostics[-1]["status"] == "skipped"


def test_fallback_off_reports_raw_breakdown():
    port, ref = both(ba(300, seed=7), fallback=False)
    b = mean_free(8, 300)
    runs = run_armed({"solve.spmv": dict(mode="nan", at_calls=(1,),
                                         fraction=0.3)},
                     lambda pkg: (port, ref)[pkg == "ref"].solve(b))
    pres, _ = same_run(runs)
    assert pres[1].status in tk.BREAKDOWN_STATUSES
    assert pres[1].diagnostics == ()


def test_nan_rhs_column_matches_reference():
    B = np.stack([np.full(16, np.nan), np.ones(16)], axis=1)
    _, info = tk.pcg_block(lambda v: v, torch.as_tensor(B, dtype=torch.float32),
                           tol=1e-8, maxiter=10)
    _, jinfo = jk.pcg_block(lambda v: v, jnp.asarray(B, jnp.float32),
                            tol=1e-8, maxiter=10)
    assert info.status.tolist() == jinfo.status.tolist() == [
        "breakdown_nonfinite", "converged"]


# ----------------------------------------------------------------------
# Pathological graphs
# ----------------------------------------------------------------------
def component_graph(sizes, seed=0):
    """Disjoint union of BA graphs (entries of 1 are isolated vertices)."""
    rows, cols, vals, labels = [], [], [], []
    off = 0
    for i, sz in enumerate(sizes):
        n_i = 1
        if sz > 1:
            n_i, r, c, v = ensure_connected(
                *barabasi_albert(sz, m=2, seed=seed + i, weighted=True))
            rows.append(r + off)
            cols.append(c + off)
            vals.append(v)
        labels.extend([i] * n_i)
        off += n_i
    return (off, np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), np.asarray(labels))


def component_mean_free(b, labels):
    b = np.asarray(b, np.float64).copy()
    for c in np.unique(labels):
        b[labels == c] -= b[labels == c].mean(axis=0)
    return b.astype(np.float32)


def dense_pinv_solve(problem, b):
    n = problem.n
    L = np.zeros((n, n))
    v = np.asarray(problem.vals, np.float64)
    np.add.at(L, (problem.rows, problem.rows), v)
    np.subtract.at(L, (problem.rows, problem.cols), v)
    return np.linalg.pinv(L) @ np.asarray(b, np.float64)


@pytest.mark.parametrize("sizes,k", [((220, 180), 3), ((300, 1, 1), 1)])
def test_disconnected_matches_reference(sizes, k):
    n, r, c, v, labels = component_graph(sizes)
    port, ref = both((n, r, c, v))
    assert port.problem.components()[1] == len(sizes)
    b = component_mean_free(np.random.default_rng(1).normal(size=(n, k)),
                            labels)
    x, res = port.solve(b, tol=1e-6)
    jx, jres = ref.solve(b, tol=1e-6)
    assert res.status == "converged" and res.diagnostics == ()
    assert outcome(res) == outcome(jres)
    np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-5, atol=1e-5)
    oracle = dense_pinv_solve(port.problem, b)
    err = np.linalg.norm(x.astype(np.float64) - oracle)
    assert err <= 1e-3 * max(1.0, np.linalg.norm(oracle))
    if sizes[-1] == 1:
        np.testing.assert_allclose(x[-2:], 0.0, atol=1e-6)


def test_guards_on_off_bitwise():
    graph = ba(300, seed=3)
    b = mean_free(4, 300, 2)
    xs = []
    for guard in (True, False):
        solver = setup(Problem.from_edges(*graph),
                       SolverOptions(device="cpu", guard=guard, **KW),
                       cache=False)
        x, res = solver.solve(b)
        assert res.status == "converged"
        xs.append(x)
    np.testing.assert_array_equal(xs[0].view(np.int32), xs[1].view(np.int32))


# ----------------------------------------------------------------------
# The scanned solve
# ----------------------------------------------------------------------
def _laplacian(graph):
    n, r, c, v = graph
    L = np.zeros((n, n), np.float32)
    np.add.at(L, (r, r), v.astype(np.float32))
    np.subtract.at(L, (r, c), v.astype(np.float32))
    return L


SCAN_CASES = {
    "clean": (1.0, 0.0, tk.SCAN_OK),
    "indefinite": (-1.0, 0.0, tk.SCAN_INDEFINITE),
    "nonfinite": (1.0, np.nan, tk.SCAN_NONFINITE),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
@pytest.mark.parametrize("guarded", [True, False])
def test_scanned_codes_and_norms_match_reference(case, guarded):
    sign, poison, code = SCAN_CASES[case]
    L = sign * _laplacian(grid_2d(8, 8))
    b = mean_free(6, 64)
    b[5] += poison
    inv_d = 1.0 / np.abs(np.diag(L))
    guard = tk.GuardConfig(stagnation_window=5) if guarded else None
    jguard = jk.GuardConfig(stagnation_window=5) if guarded else None
    Lt, Lj = torch.as_tensor(L), jnp.asarray(L)
    got = tk.pcg_scanned(lambda v: Lt @ v, torch.as_tensor(b),
                         precond=lambda r: torch.as_tensor(inv_d) * r,
                         n_iters=12, guard=guard, tol=1e-6)
    want = jk.pcg_scanned(lambda v: Lj @ v, jnp.asarray(b),
                          precond=lambda r: jnp.asarray(inv_d) * r,
                          n_iters=12, guard=jguard, tol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    if guarded:
        assert int(got[2]) == int(want[2]) == code
        statuses = [tk.scan_status_from_codes(got[2], got[1], 1e-6,
                                              float(got[1][0])),
                    jk.scan_status_from_codes(want[2], np.asarray(want[1]),
                                              1e-6, float(want[1][0]))]
    else:
        statuses = [tk._norms_status(got[1], 1e-6, float(got[1][0])),
                    jk._norms_status(np.asarray(want[1]), 1e-6,
                                     float(want[1][0]))]
    assert statuses[0].tolist() == statuses[1].tolist()


def test_solve_step_matches_reference(pair):
    port, ref = pair
    ls, js = port._handle._solver, ref._handle._solver
    b = mean_free(9, 300)
    bt = ls._to_internal(torch.as_tensor(b))
    bj = js._to_internal(jnp.asarray(b))
    x, norms = ls.build_solve_step(8)(bt)
    jx, jnorms = js.build_solve_step(8)(bj)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    xg, norms_g, code = tk.pcg_scanned(ls.matvec, bt,
                                       precond=ls.precondition, n_iters=8,
                                       guard=True, tol=1e-8)
    assert int(code) == tk.SCAN_OK
    assert torch.equal(xg, x) and torch.equal(norms_g, norms)
    with pytest.warns(DeprecationWarning):
        got = tk.scan_norms_status(norms, 1e-8, float(norms[0]))
    with pytest.warns(DeprecationWarning):
        want = jk.scan_norms_status(np.asarray(jnorms), 1e-8,
                                    float(jnorms[0]))
    assert got.tolist() == want.tolist()


# ----------------------------------------------------------------------
# Triage
# ----------------------------------------------------------------------
def _wide_weights(graph, lo, hi, seed=5):
    n, r, c, _ = graph
    key = np.minimum(r, c).astype(np.int64) * n + np.maximum(r, c)
    uniq, idx = np.unique(key, return_inverse=True)
    scale = 10.0 ** np.random.default_rng(seed).uniform(lo, hi, len(uniq))
    return n, r, c, scale[idx].astype(np.float32)


TRIAGE_GRAPHS = {
    "healthy": lambda: ba(),
    "suspicious": lambda: _wide_weights(ba(400, seed=5), -5, 5),
    "hopeless": lambda: _wide_weights(ba(400, seed=5), -8, 8),
    "disconnected": lambda: component_graph((200, 1, 1))[:4],
}


@pytest.mark.parametrize("case", sorted(TRIAGE_GRAPHS))
def test_triage_report_matches_reference(case):
    graph = TRIAGE_GRAPHS[case]()
    got = triage_problem(Problem.from_edges(*graph),
                         SolverOptions(device="cpu", **KW))
    want = j_triage(J.Problem.from_edges(*graph), J.SolverOptions(**KW))
    assert got.rung == want.rung
    assert got.score == want.score
    assert (got.guard is None) == (want.guard is None)
    if got.guard is not None:
        assert got.guard.stagnation_window == want.guard.stagnation_window
    assert got.as_diagnostics() == want.as_diagnostics()
