"""The port's self-verification layer against the reference's, after
``tests/test_abft.py``.

Held: the verify knob and constants; ``make_check`` flags the same columns
as the reference's on the same corrupted ``(P, Ap)`` blocks, cheap and
paranoid; ``certify`` gives relative residuals within rtol 1e-9 of the
reference's on the same ``X`` (its float64 sums add each row in edge-list
order, as ``np.add.at`` does) and the same verdicts; within the port,
``verify`` off, cheap and paranoid are bitwise equal on clean solves; and
silent corruption (``solve.spmv`` and ``sdc.edge_weights``) is caught with
the reference's statuses and ladder stages under the same plan.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.api as J  # noqa: E402
import repro.testing as JT  # noqa: E402
from repro.core import verify as jv  # noqa: E402
import repro_torch.testing as TT  # noqa: E402
from repro_torch.api import (Certificate, Problem,  # noqa: E402
                             SolverOptions, setup)
from repro_torch.api.result import worst_status  # noqa: E402
from repro_torch.core import verify as tv  # noqa: E402
from repro_torch.core.krylov import (BREAKDOWN_STATUSES,  # noqa: E402
                                     STATUS_SDC, STATUS_SDC_CERT)
from repro_torch.core.solver import LaplacianSolver  # noqa: E402
from repro_torch.graphs.generators import (barabasi_albert,  # noqa: E402
                                           ensure_connected)
from repro_torch.testing import Fault, FaultPlan, inject  # noqa: E402

KW = dict(coarsest_size=64)


def graph(n=300, seed=0):
    return ensure_connected(*barabasi_albert(n, m=3, seed=seed,
                                             weighted=True))


def mean_free(seed, n, k=None):
    b = np.random.default_rng(seed).normal(size=n if k is None else (n, k))
    return (b - b.mean(axis=0)).astype(np.float32)


def true_rel_residual(p, b, x):
    """Independent float64 projected relative residual, computed in-test."""
    b, x = np.asarray(b, np.float64), np.asarray(x, np.float64)
    vals = np.asarray(p.vals, np.float64)
    deg = np.zeros(p.n)
    np.add.at(deg, p.rows, vals)
    ax = np.zeros(p.n)
    np.add.at(ax, p.rows, vals * x[p.cols])
    r = b - (deg * x - ax)
    return np.linalg.norm(r - r.mean()) / np.linalg.norm(b - b.mean())


def both(g, **kw):
    port = setup(Problem.from_edges(*g),
                 SolverOptions(device="cpu", **{**KW, **kw}), cache=False)
    ref = J.setup(J.Problem.from_edges(*g), J.SolverOptions(**{**KW, **kw}),
                  cache=False)
    return port, ref


@pytest.fixture(scope="module")
def cheap_pair():
    """Port and reference solvers with ``verify="cheap"`` and the ladder
    off, so the raw detection status surfaces."""
    return both(graph(), verify="cheap", fallback=False)


# ----------------------------------------------------------------------
def test_knob_and_constants_match_reference():
    assert (tv.CHECK_RTOL, tv.CERT_FLOOR) == (jv.CHECK_RTOL, jv.CERT_FLOOR)
    with pytest.raises(ValueError, match="verify"):
        SolverOptions(verify="always")
    assert SolverOptions(verify="off").verify_config() is None
    for mode in ("cheap", "paranoid"):
        cfg = SolverOptions(verify=mode, seed=7).verify_config()
        assert cfg == tv.VerifyConfig(mode=mode, seed=7)
    with pytest.raises(ValueError, match="mode"):
        tv.VerifyConfig(mode="off")
    with pytest.raises(ValueError, match="witness"):
        tv.make_check(torch.ones(8), tv.VerifyConfig(mode="paranoid"))
    assert STATUS_SDC in BREAKDOWN_STATUSES
    assert STATUS_SDC_CERT in BREAKDOWN_STATUSES
    assert worst_status(["converged", "breakdown_nonfinite",
                         STATUS_SDC]) == STATUS_SDC
    assert worst_status(["max_iters", STATUS_SDC_CERT,
                         "stagnation"]) == STATUS_SDC_CERT


def _corrupted_blocks():
    """A Laplacian, a block P of 6 columns and Ap = L P with columns 1-5
    corrupted: a flipped exponent, 30 % perturbed, a NaN, a ±pair (zero
    column sum, opposite witness signs: only the witness sees it), a small
    shift."""
    n, r, c, v = graph(200, seed=2)
    L = np.zeros((n, n), np.float32)
    np.add.at(L, (r, r), v.astype(np.float32))
    np.subtract.at(L, (r, c), v.astype(np.float32))
    P = np.random.default_rng(3).normal(size=(n, 6)).astype(np.float32)
    Ap = (L.astype(np.float64) @ P).astype(np.float32)
    Ap[7, 1] *= 2.0 ** 64
    Ap[::3, 2] *= 1.5
    Ap[11, 3] = np.nan
    w = np.random.default_rng((0, n)).choice((-1.0, 1.0), n)  # the witness
    i, j = 5, int(np.flatnonzero(w != w[5])[0])
    Ap[i, 4] += 50.0
    Ap[j, 4] -= 50.0
    Ap[:, 5] += 1e-2
    return np.diag(L).copy(), L, P, Ap


@pytest.mark.parametrize("mode", ["cheap", "paranoid"])
def test_make_check_flags_like_reference(mode):
    deg, L, P, Ap = _corrupted_blocks()
    got = tv.make_check(torch.as_tensor(deg), tv.VerifyConfig(mode=mode),
                        matvec=lambda w: torch.as_tensor(L) @ w)
    want = jv.make_check(jnp.asarray(deg), jv.VerifyConfig(mode=mode),
                         matvec=lambda w: jnp.asarray(L) @ w)
    flags = got(torch.as_tensor(P), torch.as_tensor(Ap)).tolist()
    assert flags == np.asarray(want(jnp.asarray(P),
                                    jnp.asarray(Ap))).tolist()
    assert flags[0] is False and all(flags[1:4])
    assert flags[4] is (mode == "paranoid")
    for j in range(6):                     # one vector at a time, too
        one = got(torch.as_tensor(P[:, j]), torch.as_tensor(Ap[:, j]))
        assert one.dim() == 0 and bool(one) == flags[j]


@pytest.fixture(scope="module")
def solved():
    p = Problem.from_edges(*graph(seed=1))
    B = mean_free(8, 300, 3)
    X, res = setup(p, SolverOptions(device="cpu", **KW),
                   cache=False).solve(B)
    return p, B, X, res


@pytest.mark.parametrize("scale", [0.0, 1e-6, 1e-2, 1.0])
def test_certify_matches_reference(solved, scale):
    p, B, X, _ = solved
    jp = J.Problem.from_edges(p.n, p.rows, p.cols, p.vals)
    noise = np.random.default_rng(10).normal(size=X.shape)
    X = (X + scale * np.linalg.norm(X) * noise / np.linalg.norm(noise)
         ).astype(np.float32)
    claimed = np.array([True, False, True])
    got = tv.certify(p, B, X, tol=1e-8, claimed=claimed)
    want = jv.certify(jp, B, X, tol=1e-8, claimed=claimed)
    np.testing.assert_allclose(got.rel_residuals, want.rel_residuals,
                               rtol=1e-9)
    assert (got.passed, got.threshold, got.claimed, got.method) == (
        want.passed, want.threshold, want.claimed, want.method)
    np.testing.assert_array_equal(got.failed_columns(),
                                  want.failed_columns())
    assert got.passed is (scale < 1e-2)


def test_certify_on_disconnected_matches_reference():
    parts = [graph(120, seed=4), graph(90, seed=5)]
    n0 = parts[0][0]
    r = np.concatenate([parts[0][1], parts[1][1] + n0])
    c = np.concatenate([parts[0][2], parts[1][2] + n0])
    v = np.concatenate([parts[0][3], parts[1][3]])
    n = n0 + parts[1][0]
    p, jp = Problem.from_edges(n, r, c, v), J.Problem.from_edges(n, r, c, v)
    rng = np.random.default_rng(11)
    B, X = rng.normal(size=(n, 2)), rng.normal(size=(n, 2))
    got, want = tv.certify(p, B, X, 1e-4), jv.certify(jp, B, X, 1e-4)
    np.testing.assert_allclose(got.rel_residuals, want.rel_residuals,
                               rtol=1e-9)
    assert got.passed == want.passed is False


def test_clean_solves_bitwise_across_verify_modes():
    g, b = graph(), mean_free(1, 300, 2)
    p = Problem.from_edges(*g)
    results = {mode: setup(p, SolverOptions(verify=mode, device="cpu", **KW),
                           cache=False).solve(b)
               for mode in ("off", "cheap", "paranoid")}
    x_off, r_off = results["off"]
    assert r_off.status == "converged" and r_off.certificate is None
    for mode in ("cheap", "paranoid"):
        x, r = results[mode]
        np.testing.assert_array_equal(x.view(np.int32), x_off.view(np.int32))
        assert r.status == "converged"
        assert isinstance(r.certificate, Certificate) and r.certificate.passed
        for j in range(2):
            assert (true_rel_residual(p, b[:, j], x[:, j])
                    <= r.certificate.threshold)


# ----------------------------------------------------------------------
DETECTION = [
    ("solve.spmv", "bitflip", (1,), 0.05),
    ("solve.spmv", "perturb", (1,), 0.2),
    ("sdc.edge_weights", "perturb", None, 0.3),
    ("sdc.edge_weights", "zero", None, 0.3),
    ("sdc.edge_weights", "bitflip", None, 0.05),
]


@pytest.mark.parametrize("site,mode,at,fraction", DETECTION)
def test_detection_matches_reference(cheap_pair, site, mode, at, fraction):
    b = mean_free(3, 300)
    out = []
    for mod, solver in ((TT, cheap_pair[0]), (JT, cheap_pair[1])):
        plan = mod.FaultPlan({site: mod.Fault(mode=mode, at_calls=at,
                                              fraction=fraction)})
        with mod.inject(plan):
            x, res = solver.solve(b)
        out.append((plan.fired, res.status, res.statuses.tolist(),
                     res.iters_per_rhs.tolist()))
        assert np.isfinite(np.asarray(x)).all()
    assert out[0] == out[1]
    assert out[0][0] and out[0][1] == STATUS_SDC


def test_paranoid_and_single_rhs_check_detect():
    p, b = Problem.from_edges(*graph()), mean_free(5, 300)
    solver = setup(p, SolverOptions(verify="paranoid", fallback=False,
                                    device="cpu", **KW), cache=False)
    plan = FaultPlan({"solve.spmv": Fault(mode="perturb", at_calls=(1,),
                                          fraction=0.2)})
    with inject(plan):
        _, res = solver.solve(b)
    assert plan.fired and res.status == STATUS_SDC
    ls = LaplacianSolver.setup(p.n, p.rows, p.cols, p.vals, device="cpu")
    check = tv.make_check(ls._fine.deg, tv.VerifyConfig(mode="cheap"))
    plan = FaultPlan({"solve.spmv": Fault(mode="perturb", at_calls=(1,),
                                          fraction=0.2)})
    with inject(plan):
        x, info = ls.solve(b, check=check)
    assert plan.fired and info.status == STATUS_SDC and info.iters == 1
    assert torch.isfinite(x).all()


def test_persistent_corruption_recovers_as_reference():
    """Persistent edge-weight corruption: the checksum flags it, the
    rebuilt hierarchy is corrupted again, diag-PCG (built clean from the
    edge list) recovers, and the answer re-certifies — rung by rung as in
    the reference."""
    port, ref = both(graph(), verify="cheap")
    b = mean_free(7, 300)
    out = []
    for mod, solver in ((TT, port), (JT, ref)):
        plan = mod.FaultPlan({"sdc.edge_weights": mod.Fault(
            mode="perturb", at_calls=None, fraction=0.3)})
        with mod.inject(plan):
            x, res = solver.solve(b)
        out.append((plan.fired, res.status,
                    [(d["stage"], d["status"]) for d in res.diagnostics],
                    res.certificate.passed))
    assert out[0] == out[1]
    assert out[0][1] == "degraded" and out[0][3]
    assert "diag_pcg" in [stage for stage, _ in out[0][2]]
    assert true_rel_residual(port.problem, b, x) <= 1e-4


def test_without_verify_corruption_is_silent():
    p, b = Problem.from_edges(*graph()), mean_free(7, 300)
    solver = setup(p, SolverOptions(verify="off", tol=1e-4, device="cpu",
                                    **KW), cache=False)
    with inject(FaultPlan({"sdc.edge_weights": Fault(
            mode="perturb", at_calls=None, fraction=0.05)})) as plan:
        x, res = solver.solve(b)
    assert plan.fired and res.status == "converged"
    assert res.certificate is None
    norms = np.asarray(res.residual_norms)
    claimed_rel = float(norms[-1].max() / norms[0].max())
    assert claimed_rel <= 1e-4
    assert true_rel_residual(p, b, x) > 100 * claimed_rel


def test_unclaimed_columns_and_threshold_floor():
    p, b = Problem.from_edges(*graph(seed=3)), mean_free(11, 300)
    _, res = setup(p, SolverOptions(verify="cheap", max_iters=2,
                                    fallback=False, device="cpu", **KW),
                   cache=False).solve(b)
    assert res.status == "max_iters"
    assert res.certificate.passed and not any(res.certificate.claimed)
    _, res = setup(p, SolverOptions(verify="cheap", tol=1e-12, device="cpu",
                                    **KW), cache=False).solve(b)
    assert res.certificate.threshold == tv.CERT_FLOOR
