"""The port's facade (``repro_torch.api``) against the reference's
(``repro.api``), after ``tests/test_api.py`` and ``tests/test_multi_rhs.py``.

Inputs are made with the port's generators (element for element the
reference's) from fixed seeds and fed to both packages as numpy arrays.
Held: validation errors with the reference's messages, ``Problem``
fingerprints equal to the reference's digests, the registry and
``"auto"``, the same levels and per-column iteration counts, ``X`` at rtol
1e-5 / atol 1e-5 (the tolerance of ``tests/test_matvec.py``),
``exact_columns=False`` at the reference's own 1e-4; within the port,
blocked vs looped columns and ``x0=zeros`` vs ``x0=None`` bitwise, the
cache, and the facade's shape checks. Every setup runs with ``cache=False``
or a private cache, so the reference's process-wide cache stays empty.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import repro.api as J  # noqa: E402
import repro_torch.api as T  # noqa: E402
from repro_torch.api import (HierarchyCache, Problem,  # noqa: E402
                             ProblemValidationError, SolveResult,
                             SolverOptions, available_backends, get_backend,
                             register_backend, resolve_backend, setup, solve)
from repro_torch.graphs.generators import (barabasi_albert,  # noqa: E402
                                           ensure_connected, grid_2d)

KW = dict(coarsest_size=64, max_iters=100)
OPTS = SolverOptions(device="cpu", **KW)
J_OPTS = J.SolverOptions(**KW)


def ba800():
    return ensure_connected(*barabasi_albert(800, m=3, seed=0,
                                             weighted=True))


def mean_free(seed, n, k=None):
    b = np.random.default_rng(seed).normal(size=n if k is None else (n, k))
    return (b - b.mean(axis=0)).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    """One reference build and one port build of the BA graph, with a
    4-column block solved by each."""
    n, r, c, v = ba800()
    p, jp = Problem.from_edges(n, r, c, v), J.Problem.from_edges(n, r, c, v)
    port = setup(p, OPTS, backend="single", cache=False)
    ref = J.setup(jp, J_OPTS, backend="single", cache=False)
    B = mean_free(5, n, 4)
    X, res = port.solve(B)
    JX, jres = ref.solve(B)
    return dict(n=n, p=p, jp=jp, port=port, ref=ref, B=B, X=X, res=res,
                JX=np.asarray(JX), jres=jres)


# ----------------------------------------------------------------------
# Problem: validation and fingerprints
# ----------------------------------------------------------------------
BAD_INPUTS = {
    "duplicate": ((4, [0, 0, 1, 1], [1, 1, 0, 0], [1.0, 1.0, 1.0, 1.0]), {}),
    "self_loop": ((4, [0, 1, 2], [1, 0, 2], [1.0, 1.0, 1.0]), {}),
    "asymmetric": ((4, [0], [1], [1.0]), {}),
    "out_of_range": ((3, [0, 5], [5, 0], [1.0, 1.0]), {}),
    "non_positive": ((3, [0, 1], [1, 0], [-1.0, -1.0]), {}),
    "non_finite": ((3, [0, 1], [1, 0], [np.nan, np.nan]), {}),
    "bad_dtype": ((3, [0, 1], [1, 0], [1.0, 1.0]), dict(dtype="int32")),
    "float_indices": ((3, [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]), {}),
    "shape_mismatch": ((3, [0, 1], [1, 0], [1.0]), {}),
    "ragged": ((3, [0, 1, 2], [1, 0], [1.0, 1.0]), {}),
    "empty_n": ((0, [], [], []), {}),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_validation_errors_match_reference(case):
    args, kw = BAD_INPUTS[case]
    with pytest.raises(J.ProblemValidationError) as want:
        J.Problem.from_edges(*args, **kw)
    with pytest.raises(ProblemValidationError) as got:
        Problem.from_edges(*args, **kw)
    assert str(got.value) == str(want.value)


def _adjacency():
    return np.array([[0, 2, 0], [2, 0, 1], [0, 1, 0]], np.float32)


GOOD_INPUTS = {
    "ba800": lambda mod: mod.Problem.from_edges(*ba800()),
    "grid": lambda mod: mod.Problem.from_edges(
        *ensure_connected(*grid_2d(20, 20))),
    "shuffled": lambda mod: mod.Problem.from_edges(*_shuffled(ba800())),
    "float64": lambda mod: mod.Problem.from_edges(
        *ba800()[:3], ba800()[3].astype(np.float64), dtype="float64"),
    "duplicates_summed": lambda mod: mod.Problem.from_edges(
        4, [0, 0, 1, 1], [1, 1, 0, 0], [1.0, 2.0, 1.0, 2.0],
        allow_duplicates=True),
    "symmetrize": lambda mod: mod.Problem.from_edges(
        4, [0, 1, 2], [1, 2, 3], symmetrize=True),
    "dense_adjacency": lambda mod: mod.Problem.from_adjacency(_adjacency()),
    "sparse_adjacency": lambda mod: mod.Problem.from_adjacency(
        sp.csr_matrix(_adjacency())),
}


def _shuffled(graph):
    n, r, c, v = graph
    order = np.random.default_rng(3).permutation(len(r))
    return n, r[order], c[order], v[order]


@pytest.mark.parametrize("case", sorted(GOOD_INPUTS))
def test_problem_and_fingerprint_equal_reference(case):
    p, jp = GOOD_INPUTS[case](T), GOOD_INPUTS[case](J)
    assert p.fingerprint() == jp.fingerprint()
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(p, name), getattr(jp, name))
        assert getattr(p, name).dtype == getattr(jp, name).dtype
    assert (p.n_vertices, p.n_edges) == (jp.n_vertices, jp.n_edges)
    np.testing.assert_array_equal(p.degrees(), jp.degrees())
    comp, n_comp = p.components()
    jcomp, jn_comp = jp.components()
    assert n_comp == jn_comp
    np.testing.assert_array_equal(comp, jcomp)
    assert p.bucket_signature(64) == jp.bucket_signature(64)


def test_fingerprint_ignores_edge_order_and_sees_weights():
    n, r, c, v = ba800()
    p = Problem.from_edges(n, r, c, v)
    assert Problem.from_edges(*_shuffled((n, r, c, v))).fingerprint() == \
        p.fingerprint()
    assert Problem.from_edges(n, r, c, 2 * v).fingerprint() != \
        p.fingerprint()


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------
def test_registry_matches_reference():
    assert available_backends() == J.available_backends()
    with pytest.raises(KeyError, match="available"):
        get_backend("not-a-backend")
    assert resolve_backend("single") == "single"
    assert resolve_backend("auto", mesh=object()) == "dist"
    no_precond = SolverOptions(precondition=False, device="cpu")
    assert resolve_backend("auto", options=no_precond) == "single"
    with pytest.raises(ValueError, match="reserved"):
        register_backend("auto", lambda p, o, m: None)


def test_auto_follows_the_device_count(monkeypatch):
    for count, want in ((0, "single"), (1, "single"), (4, "dist")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        assert resolve_backend("auto") == want


@pytest.mark.parametrize("name,item", [("dist", "A11")])
def test_unported_backends_raise(name, item, built):
    """The ``dist`` backend (ROADMAP A11) is ported: on a world of one it
    sets up and solves the block with the single backend's statuses and
    per-column iterations, ``X`` within rtol 1e-5 / atol 1e-5."""
    import torch_dist_helpers as H

    with H.world_of_one() as mesh:
        solver = setup(built["p"], OPTS, backend=name, mesh=mesh,
                       cache=False)
        X, res = solver.solve(built["B"])
    assert solver.backend == name and solver.stats()["mesh_shape"] == {
        "data": 1, "model": 1}
    assert list(res.statuses) == list(built["res"].statuses)
    np.testing.assert_array_equal(res.iters_per_rhs,
                                  built["res"].iters_per_rhs)
    np.testing.assert_allclose(X, built["X"], rtol=1e-5, atol=1e-5)


def test_serial_ref_backend_matches_reference(built):
    """``backend="serial_ref"`` (the serial LAMG-style reference) against
    the reference facade's: the same levels, per-column iteration counts
    and ``X`` at rtol 1e-5 / atol 1e-5."""
    port = setup(built["p"], OPTS, backend="serial_ref", cache=False)
    ref = J.setup(built["jp"], J_OPTS, backend="serial_ref", cache=False)
    assert port.backend == "serial_ref"
    keys = ("kind", "n", "nnz")
    assert [{k: row[k] for k in keys} for row in port.stats()["levels"]] == \
        [{k: row[k] for k in keys} for row in ref.stats()["levels"]]
    X, res = port.solve(built["B"])
    JX, jres = ref.solve(built["B"])
    assert res.converged and jres.converged
    np.testing.assert_array_equal(res.iters_per_rhs, jres.iters_per_rhs)
    np.testing.assert_allclose(X, np.asarray(JX), rtol=1e-5, atol=1e-5)


def test_custom_backend_roundtrip(built):
    class _Handle:
        work_per_iteration = 1.0

        def solve_block(self, B, tol, max_iters):
            k = B.shape[1]
            return (np.zeros_like(B), np.array([[1.0] * k, [0.0] * k]),
                    np.ones(k, int), None)

        def stats(self):
            return {}

    register_backend("_test_null", lambda p, o, m: _Handle())
    try:
        n = built["n"]
        x, res = solve(built["p"], np.zeros(n, np.float32),
                       backend="_test_null", cache=False)
        assert res.backend == "_test_null" and res.converged
        assert res.statuses is None and x.shape == (n,)
    finally:
        from repro_torch.api import registry
        registry._REGISTRY.pop("_test_null")


def test_default_device_is_the_card(built):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup(built["p"], SolverOptions(**KW), cache=False)


def test_options_match_reference_fields():
    want = set(J.SolverOptions.__dataclass_fields__)
    assert set(SolverOptions.__dataclass_fields__) == want | {"device"}
    for bad in (dict(matvec_backend="bad"), dict(setup_mode="x"),
                dict(setup_bucket_floor=3), dict(stagnation_window=0),
                dict(verify="always"), dict(elim_sizing="x")):
        with pytest.raises(ValueError):
            J.SolverOptions(**bad)
        with pytest.raises(ValueError):
            SolverOptions(**bad)
    opts = SolverOptions(setup_ell_sweeps=True, matvec_backend="ell")
    cfg = opts.setup_config()
    assert cfg.setup_ell_sweeps and cfg.ell_sweeps
    assert J.SolverOptions(setup_ell_sweeps=True).setup_config(
        ).setup_ell_sweeps
    assert not SolverOptions(setup_ell_sweeps=True).setup_config().ell_sweeps


@pytest.mark.parametrize("field,value,item", [
    ("guard_mode", "postmortem", "A11"), ("dist_nnz_threshold", 1, "A11"),
    ("max_dist_levels", 1, "A11")])
def test_unported_options_raise(field, value, item):
    """The distributed layer's fields (ROADMAP A11, ported) take the value
    the reference takes; an invalid ``guard_mode`` raises in both."""
    want = getattr(J.SolverOptions(**{field: value}), field)
    assert getattr(SolverOptions(device="cpu", **{field: value}),
                   field) == want == value
    with pytest.raises(ValueError, match="guard_mode"):
        J.SolverOptions(guard_mode="later")
    with pytest.raises(ValueError, match="guard_mode"):
        SolverOptions(device="cpu", guard_mode="later")


# ----------------------------------------------------------------------
# Solves against the reference
# ----------------------------------------------------------------------
def test_same_levels(built):
    keys = ("kind", "n", "nnz")
    got = [{k: row[k] for k in keys} for row in built["port"].stats()["levels"]]
    want = [{k: row[k] for k in keys} for row in built["ref"].stats()["levels"]]
    assert got == want


def test_same_iterations_and_solution(built):
    res, jres = built["res"], built["jres"]
    assert res.converged and res.status == "converged"
    np.testing.assert_array_equal(res.iters_per_rhs, jres.iters_per_rhs)
    assert res.statuses.tolist() == jres.statuses.tolist()
    assert res.residual_norms.shape == jres.residual_norms.shape
    np.testing.assert_allclose(built["X"], built["JX"], rtol=1e-5,
                               atol=1e-5)
    assert abs(res.wda - jres.wda) <= 1e-4 * jres.wda
    assert res.work_per_iteration == pytest.approx(jres.work_per_iteration,
                                                   rel=1e-12)


def test_result_fields_frozen(built):
    res = built["res"]
    assert isinstance(res, SolveResult)
    assert tuple(sorted(res.__dataclass_fields__)) == tuple(
        sorted(J.SolveResult.__dataclass_fields__))
    assert res.backend == "single" and res.n_rhs == 4
    assert res.diagnostics == () and res.certificate is None
    assert res.solve_seconds > 0 and res.setup_seconds > 0


def test_blocked_matches_looped_bitwise(built):
    port, B, X, res = built["port"], built["B"], built["X"], built["res"]
    for j in range(B.shape[1]):
        xj, rj = port.solve(B[:, j])
        np.testing.assert_array_equal(X[:, j].view(np.int32),
                                      xj.view(np.int32))
        assert rj.iters == res.iters_per_rhs[j]
        np.testing.assert_array_equal(res.residual_norms[: rj.iters + 1, j],
                                      rj.residual_norms[:, 0])


def test_x0_zeros_matches_default_bitwise(built):
    port, B = built["port"], built["B"]
    X_z, res_z = port.solve(B, x0=np.zeros_like(B))
    np.testing.assert_array_equal(built["X"].view(np.int32),
                                  X_z.view(np.int32))
    np.testing.assert_array_equal(built["res"].residual_norms,
                                  res_z.residual_norms)


def test_x0_warm_start_matches_reference(built):
    b = built["B"][:, 0]
    rough, _ = built["port"].solve(b, tol=1e-2)
    _, warm = built["port"].solve(b, x0=rough)
    _, jwarm = built["ref"].solve(b, x0=rough)
    assert warm.converged and warm.iters == jwarm.iters
    assert warm.iters < built["res"].iters_per_rhs[0]


def test_vectorized_path_matches_reference(built):
    """``exact_columns=False`` against the reference's vmapped path, at
    the tolerance of its own test (``tests/test_multi_rhs.py``: 1e-4)."""
    n, B = built["n"], built["B"][:, :3]
    port = setup(built["p"], SolverOptions(exact_columns=False,
                                           device="cpu", **KW), cache=False)
    ref = J.setup(built["jp"], J.SolverOptions(exact_columns=False, **KW),
                  cache=False)
    X, res = port.solve(B)
    JX, jres = ref.solve(B)
    assert res.converged and jres.converged
    assert np.abs(res.iters_per_rhs - jres.iters_per_rhs).max() <= 1
    for j in range(3):
        rel = (np.linalg.norm(X[:, j] - np.asarray(JX)[:, j])
               / np.linalg.norm(np.asarray(JX)[:, j]))
        assert rel < 1e-4, f"col {j}: {rel}"
    assert X.shape == (n, 3)


@pytest.mark.parametrize("exact", [True, False])
def test_block_reductions_follow_exact_columns(exact):
    """``exact_columns=True`` reduces each column with ``pcg``'s own 1-D
    operations; ``False`` reduces the ``(n, k)`` block in 2-D."""
    from repro_torch.core.krylov import _Columns, _project

    g = torch.Generator().manual_seed(0)
    U = torch.randn(1000, 5, generator=g)
    V = torch.randn(1000, 5, generator=g)
    ops = _Columns(None, None, None, exact=exact)
    Uc, Vc = ops.split(U), ops.split(V)
    if exact:
        dots = torch.stack([torch.dot(u, v) for u, v in zip(Uc, Vc)])
        norms = torch.stack([torch.linalg.norm(u) for u in Uc])
        proj = torch.stack([_project(u) for u in Uc], dim=1)
    else:
        dots = (U * V).sum(dim=0)
        norms = torch.linalg.vector_norm(U, dim=0)
        proj = U - U.mean(dim=0, keepdim=True)
    assert torch.equal(ops.cdot(Uc, Vc), dots)
    assert torch.equal(ops.cnorm(Uc), norms)
    assert torch.equal(ops.join(ops.proj(Uc)), proj)


def test_stopping_controls_honored(built):
    b = built["B"][:, 1]
    _, res = built["port"].solve(b, max_iters=2)
    assert not res.converged and res.iters == 2
    assert res.status == "max_iters"
    _, loose = built["port"].solve(b, tol=1e-2)
    assert loose.converged and loose.iters < built["res"].iters_per_rhs[1]


def test_cache_hit_and_invalidate(built):
    cache = HierarchyCache()
    first = setup(built["p"], OPTS, cache=cache)
    again = setup(built["p"], OPTS, cache=cache)
    assert first.setup_seconds > 0 and again.setup_seconds == 0.0
    assert again._handle is first._handle
    assert cache.stats()["hits"] == 1 and len(cache) == 1
    assert cache.invalidate(built["p"].fingerprint()) == 1
    assert setup(built["p"], OPTS, cache=cache).setup_seconds > 0


def test_cache_keeps_backends_apart(built):
    """A ``single`` setup and then a ``serial_ref`` setup of one problem:
    the second is a miss with its own entry."""
    cache = HierarchyCache()
    single = setup(built["p"], OPTS, backend="single", cache=cache)
    serial = setup(built["p"], OPTS, backend="serial_ref", cache=cache)
    assert serial.setup_seconds > 0 and serial._handle is not single._handle
    assert cache.stats()["misses"] == 2 and cache.stats()["hits"] == 0
    assert len(cache) == 2


def test_ladder_lets_a_kernel_fault_through(built, monkeypatch):
    """A rung records an injected fault or a numerical error and goes on,
    but any other exception (a kernel that fails to launch) propagates
    instead of hiding behind diag-PCG."""
    import repro_torch.api.facade as facade
    from repro_torch.testing import Fault, FaultPlan, InjectedFault, inject

    solver = setup(built["p"], OPTS, cache=False)
    b = built["B"][:, 0]
    spmv_nan = {"solve.spmv": Fault("nan", at_calls=(2,))}

    def rebuild(error):
        def factory(problem, options, mesh):
            raise error
        return lambda name: factory

    monkeypatch.setattr(facade, "get_backend",
                        rebuild(InjectedFault("setup.build")))
    with inject(FaultPlan(dict(spmv_nan))):
        _, res = solver.solve(b)
    assert [d["stage"] for d in res.diagnostics] == [
        "primary", "rebuild", "diag_pcg"]
    assert "rebuild raised InjectedFault" in res.diagnostics[1]["note"]
    monkeypatch.setattr(facade, "get_backend", rebuild(
        RuntimeError("spmv_ell: CUDA launch failed with error 700")))
    with inject(FaultPlan(dict(spmv_nan))):
        with pytest.raises(RuntimeError, match="launch failed"):
            solver.solve(b)


def test_solve_shape_errors(built):
    port, n = built["port"], built["n"]
    with pytest.raises(ValueError, match="shape"):
        port.solve(np.zeros(n - 1, np.float32))
    with pytest.raises(ValueError, match="shape"):
        port.solve(np.zeros((n, 2, 1), np.float32))
    with pytest.raises(ValueError, match="x0 must match b's shape"):
        port.solve(np.zeros(n, np.float32), x0=np.zeros((n, 2), np.float32))
    with pytest.raises(TypeError, match="Problem"):
        setup(np.zeros((3, 3)))
