"""The port's traced fault sites on the distributed solver, after the fast
cases of ``tests/test_dist_faults.py`` and the dist cases of
``tests/test_abft.py``: a gloo world of one in this process, the facade's
``dist`` backend on Barabási–Albert n = 300 (m = 3, seed 0, weighted).

The port runs eagerly, so its traced sites draw once per *build* of a
program and call site (``repro_torch.testing.faults``), where the
reference draws once per trace; the per-site counts need not match the
reference's, so these tests hold the outcomes the reference's tests hold:
every ``dist.*`` and ``sdc.shard_payload`` site fires; the pipeline ends
in an explicit status with finite outputs (solve-site breakdowns recover
through the ladder); the dist backend's in-step codes equal the eager
backend's on the same fault class; ``scan_norms_status`` agrees with the
codes where the reference says it does; clean solves are bitwise equal
with guards on and off, and with verification off, cheap and paranoid;
and the checksum flags every silent mode at the dist sites.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import torch_dist_helpers as H  # noqa: E402
from repro_torch.api import Problem, SolverOptions, setup  # noqa: E402
from repro_torch.core.krylov import STATUS_SDC, scan_norms_status  # noqa: E402
from repro_torch.testing import (TRACED_SITES, Fault,  # noqa: E402
                                 FaultPlan, TracedBuild, inject, site_traced)

EXPLICIT = ("converged", "max_iters", "degraded", "failed")
# dist_nnz_threshold=1: every eligible level gets the distributed SpMV, so
# the dist.psum site (inside it) is on every level's path
KW = dict(coarsest_size=64, device="cpu")
OPTS = SolverOptions(max_iters=200, dist_nnz_threshold=1, **KW)


@pytest.fixture(scope="module")
def mesh():
    with H.world_of_one() as m:
        yield m


@pytest.fixture(scope="module")
def p():
    return Problem.from_edges(*H.ba(300, 3, 0))


def dist_solver(p, mesh, opts=OPTS):
    return setup(p, opts, backend="dist", mesh=mesh, cache=False)


@pytest.mark.parametrize("name", ["dist.spmv", "dist.psum"])
def test_solve_sites_break_and_recover(p, mesh, name):
    solver = dist_solver(p, mesh)
    plan = FaultPlan({name: Fault(mode="nan", at_calls=(0,), fraction=0.3)})
    with inject(plan):
        x, res = solver.solve(H.mean_free(2, p.n))
    assert plan.fired
    # the ladder's rebuild makes new builds, past the at_calls window, so
    # clean arithmetic is reachable and the breakdown must recover
    assert res.status in ("converged", "degraded")
    assert res.diagnostics and res.diagnostics[0]["stage"] == "primary"
    assert np.isfinite(x).all()


@pytest.mark.parametrize("name", ["dist.select", "dist.vote"])
def test_setup_sites_terminate_explicit(p, mesh, name):
    """Corrupted integer semiring keys in the distributed setup never
    escape as a NaN or a crash."""
    plan = FaultPlan({name: Fault(mode="huge", at_calls=(0,), fraction=0.5)})
    with inject(plan):
        solver = dist_solver(p, mesh)
        x, res = solver.solve(H.mean_free(3, p.n))
    assert plan.fired
    assert res.status in EXPLICIT and res.status != "failed"
    assert np.isfinite(x).all()


def test_traced_registry_and_builds():
    assert TRACED_SITES == ("dist.select", "dist.vote", "dist.spmv",
                            "dist.psum", "sdc.shard_payload")
    x = torch.arange(8, dtype=torch.float32)
    assert site_traced("dist.spmv", x) is x          # no plan: untouched
    plan = FaultPlan({"dist.psum": Fault(mode="nan", at_calls=(1,),
                                         fraction=0.25)})
    build = TracedBuild()
    outs = []
    with inject(plan):
        for _ in range(3):                           # three passes
            with build.run():
                outs.append([site_traced("dist.psum", x),
                             site_traced("dist.psum", x)])
    # the build drew each of its two call sites once, on the first pass:
    # the second (call index 1) fires, and every pass replays it
    assert plan.counts == {"dist.psum": 2}
    assert [f[:2] for f in plan.fired] == [("dist.psum", 1)]
    for first, second in outs:
        assert first is x and torch.isnan(second).sum() == 2
        assert torch.equal(torch.isnan(second), torch.isnan(outs[0][1]))
    # four ranks, each with the same plan: one seeded shard of the four
    # is corrupted, with the int32 sentinel
    k = torch.zeros(6, dtype=torch.int32)
    hits = []
    for r in range(4):
        with inject(FaultPlan({"dist.vote": Fault(mode="huge")}, seed=1)):
            hits.append(site_traced("dist.vote", k, axis_index=r,
                                    n_shards=4))
    bad = [r for r, h in enumerate(hits) if not torch.equal(h, k)]
    assert len(bad) == 1
    assert int(hits[bad[0]].max()) == torch.iinfo(torch.int32).max


class TestStatusParityWithEager:
    """The same fault class gives the same per-column codes on both
    backends (``fallback=False`` so the raw codes surface)."""

    def _dist(self, p, mesh, b, site, at):
        opts = SolverOptions(fallback=False, dist_nnz_threshold=1, **KW)
        solver = dist_solver(p, mesh, opts)
        plan = FaultPlan({site: Fault(mode="nan", at_calls=at,
                                      fraction=0.3)})
        with inject(plan):
            _, res = solver.solve(b)
        assert plan.fired
        return res

    def _eager(self, p, b, site, at):
        solver = setup(p, SolverOptions(fallback=False, **KW),
                       backend="single", cache=False)
        plan = FaultPlan({site: Fault(mode="nan", at_calls=at,
                                      fraction=0.3)})
        with inject(plan):
            _, res = solver.solve(b)
        assert plan.fired
        return res

    def test_indefinite_parity(self, p, mesh):
        """A NaN in the iteration SpMV poisons p·Ap on both backends."""
        b = H.mean_free(4, p.n, 2)
        res_d = self._dist(p, mesh, b, "dist.spmv", (0,))
        res_e = self._eager(p, b, "solve.spmv", (1,))
        assert list(res_d.statuses) == ["breakdown_indefinite"] * 2
        assert list(res_d.statuses) == list(res_e.statuses)

    def test_nonfinite_parity(self, p, mesh):
        """A NaN in the distributed SpMV's partial sums (the initial
        residual's) surfaces as nonfinite; ``solve.residual`` is the eager
        twin."""
        b = H.mean_free(5, p.n, 2)
        res_d = self._dist(p, mesh, b, "dist.psum", (0,))
        res_e = self._eager(p, b, "solve.residual", None)
        assert list(res_d.statuses) == ["breakdown_nonfinite"] * 2
        assert list(res_d.statuses) == list(res_e.statuses)


class TestInStepVsPostmortem:
    def test_clean_bitwise_and_exact_agreement(self, p, mesh):
        b = H.mean_free(6, p.n, 3)
        on = dist_solver(p, mesh, SolverOptions(guard=True,
                                                guard_mode="in_scan", **KW))
        x_on, res_on = on.solve(b)
        off = dist_solver(p, mesh, SolverOptions(guard=False, **KW))
        x_off, res_off = off.solve(b)
        assert np.array_equal(x_on.view(np.int32), x_off.view(np.int32))
        with pytest.warns(DeprecationWarning, match="scan_norms_status"):
            pm = scan_norms_status(res_on.residual_norms, on.options.tol,
                                   res_on.residual_norms[0])
        assert list(res_on.statuses) == list(pm) == ["converged"] * 3

    def test_postmortem_mode(self, p, mesh):
        """``guard_mode="postmortem"``: the unguarded program, statuses
        from the norms, with the deprecation warning; bitwise the in-step
        solve on a clean run."""
        b = H.mean_free(6, p.n, 2)
        pm = dist_solver(p, mesh, SolverOptions(guard_mode="postmortem",
                                                **KW))
        with pytest.warns(DeprecationWarning, match="scan_norms_status"):
            x_pm, res_pm = pm.solve(b)
        x_in, res_in = dist_solver(p, mesh, SolverOptions(**KW)).solve(b)
        assert np.array_equal(x_pm.view(np.int32), x_in.view(np.int32))
        assert list(res_pm.statuses) == list(res_in.statuses)

    def test_nonfinite_fault_agreement(self, p, mesh):
        b = H.mean_free(7, p.n, 2)
        opts = SolverOptions(fallback=False, dist_nnz_threshold=1, **KW)
        solver = dist_solver(p, mesh, opts)
        plan = FaultPlan({"dist.psum": Fault(mode="nan", at_calls=(0,),
                                             fraction=0.3)})
        with inject(plan):
            _, res = solver.solve(b)
        with pytest.warns(DeprecationWarning, match="scan_norms_status"):
            pm = scan_norms_status(res.residual_norms, opts.tol,
                                   res.residual_norms[0])
        assert list(res.statuses) == list(pm) == ["breakdown_nonfinite"] * 2

    def test_indefinite_is_an_in_step_refinement(self, p, mesh):
        b = H.mean_free(8, p.n, 2)
        opts = SolverOptions(fallback=False, **KW)
        solver = dist_solver(p, mesh, opts)
        plan = FaultPlan({"dist.spmv": Fault(mode="nan", at_calls=(0,),
                                             fraction=0.3)})
        with inject(plan):
            _, res = solver.solve(b)
        with pytest.warns(DeprecationWarning, match="scan_norms_status"):
            pm = scan_norms_status(res.residual_norms, opts.tol,
                                   res.residual_norms[0])
        # the guard froze each column BEFORE the poisoned update: the
        # fetched norms stay finite and only the codes carry the cause
        assert list(res.statuses) == ["breakdown_indefinite"] * 2
        assert list(pm) == ["max_iters"] * 2

    def test_guards_off_dist_solve_does_not_warn(self, p, mesh):
        solver = dist_solver(p, mesh, SolverOptions(guard=False, **KW))
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            _, res = solver.solve(H.mean_free(9, p.n))
        assert res.status == "converged"


def test_verify_bitwise_and_certified(p, mesh):
    b = H.mean_free(2, p.n, 2)
    results = {mode: dist_solver(p, mesh, SolverOptions(
        verify=mode, dist_nnz_threshold=1, **KW)).solve(b)
        for mode in ("off", "cheap", "paranoid")}
    x_off, r_off = results["off"]
    assert r_off.status == "converged" and r_off.certificate is None
    for mode in ("cheap", "paranoid"):
        x, r = results[mode]
        assert np.array_equal(x.view(np.int32), x_off.view(np.int32))
        assert r.status == "converged" and r.certificate.passed


@pytest.mark.parametrize("site,mode,at,fraction", [
    ("dist.spmv", "perturb", (0,), 0.3),
    ("dist.psum", "bitflip", None, 0.3),
    ("dist.psum", "perturb", None, 0.3),
    ("sdc.shard_payload", "perturb", None, 0.5),
])
def test_checksum_detects(p, mesh, site, mode, at, fraction):
    """Every silent mode at the dist sites freezes with ``sdc_spmv``
    under ``verify="cheap"`` (fallback off, so the raw code surfaces)."""
    solver = dist_solver(p, mesh, SolverOptions(
        verify="cheap", fallback=False, dist_nnz_threshold=1, **KW))
    plan = FaultPlan({site: Fault(mode=mode, at_calls=at,
                                  fraction=fraction)})
    with inject(plan):
        x, res = solver.solve(H.mean_free(4, p.n))
    assert plan.fired
    assert res.status == STATUS_SDC
    if site == "dist.spmv":
        # fires inside the steps only: the initial carry is clean and the
        # frozen iterate finite
        assert np.isfinite(x).all()


def test_detection_recovers_with_fallback(p, mesh):
    solver = dist_solver(p, mesh, SolverOptions(
        verify="cheap", fallback=True, dist_nnz_threshold=1, **KW))
    plan = FaultPlan({"dist.psum": Fault(mode="bitflip", at_calls=None,
                                         fraction=0.3)})
    with inject(plan):
        x, res = solver.solve(H.mean_free(4, p.n))
    assert plan.fired
    assert res.status in ("converged", "degraded")
    assert np.isfinite(x).all()
    assert res.certificate is not None and res.certificate.passed
