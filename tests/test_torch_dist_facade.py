"""The facade's ``dist`` backend (``repro_torch.api``) against the
reference's (``repro.api``), and the service and spectral layers through
it.

The port runs a gloo world of one in this process; the reference a 1×1
mesh with ``Auto`` axes (ROADMAP C3). Graph: the 30×30 grid of
``tests/test_dist.py`` (unweighted), ``coarsest_size=64``,
``dist_nnz_threshold=100``, the COO execution (the reference's default).
Held: ``stats()`` (every level row and ``mesh_shape``), the statuses and
per-column iterations, ``x`` at rtol 1e-5 / atol 1e-5 and the norms at
rtol 1e-4 (C4). Port-only, on the same world: ``default_mesh``, a
``SolverService(backend="dist")`` stream (a 10×10 grid and BA 120) and
``lobpcg(backend="dist")`` on a 10×10 grid against the ``single`` backend
(statuses and iterations; eigenvalues at rtol 1e-6). The reference's 2×2 LOBPCG case
(``tests/test_spectral.py``, slow) is covered here only at 1×1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import repro.api as J  # noqa: E402
import torch_dist_helpers as H  # noqa: E402
from repro_torch.api import Problem, SolverOptions, setup  # noqa: E402
from repro_torch.api.backends import default_mesh  # noqa: E402
from repro_torch.graphs.generators import ensure_connected, grid_2d  # noqa: E402

KW = dict(coarsest_size=64, dist_nnz_threshold=100)


@pytest.fixture(scope="module")
def mesh():
    with H.world_of_one() as m:
        yield m


@pytest.fixture(scope="module")
def grid():
    n, r, c, v = ensure_connected(*grid_2d(30, 30))
    return n, r, c, v, H.mean_free(12, n, 2)


@pytest.fixture(scope="module")
def ref(grid):
    n, r, c, v, B = grid
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    solver = J.setup(J.Problem.from_edges(n, r, c, v), J.SolverOptions(**KW),
                     backend="dist", mesh=mesh, cache=False)
    X, res = solver.solve(B)
    return solver, np.asarray(X), res


@pytest.fixture(scope="module")
def port(grid, mesh):
    n, r, c, v, B = grid
    solver = setup(Problem.from_edges(n, r, c, v),
                   SolverOptions(device="cpu", **KW), backend="dist",
                   mesh=mesh, cache=False)
    X, res = solver.solve(B)
    return solver, X, res


def test_stats_match_reference(ref, port):
    got, want = port[0].stats(), ref[0].stats()
    assert got["mesh_shape"] == want["mesh_shape"] == {"data": 1, "model": 1}
    assert got["n_levels"] == want["n_levels"]
    assert got["levels"] == want["levels"]
    assert sum(row["distributed"] for row in got["levels"]) == 3
    assert port[0].backend == "dist"
    np.testing.assert_allclose(port[0]._handle.work_per_iteration,
                               ref[0]._handle.work_per_iteration, rtol=1e-6)


def test_solve_matches_reference(ref, port):
    _, JX, jres = ref
    _, X, res = port
    assert list(res.statuses) == list(jres.statuses) == ["converged"] * 2
    np.testing.assert_array_equal(res.iters_per_rhs, jres.iters_per_rhs)
    np.testing.assert_allclose(X, JX, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.residual_norms,
                               np.asarray(jres.residual_norms), rtol=1e-4)


def test_x0_and_plain_cg_are_refused(grid, port):
    n, r, c, v, B = grid
    with pytest.raises(NotImplementedError, match="initial guesses"):
        port[0].solve(B, x0=np.zeros_like(B))
    with pytest.raises(ValueError, match="always preconditions"):
        setup(Problem.from_edges(n, r, c, v),
              SolverOptions(device="cpu", precondition=False, **KW),
              backend="dist", cache=False)


def test_default_mesh_factors_the_world(mesh, grid):
    """With a default group, ``default_mesh`` factors its size into
    pr × pc; ``auto`` with a mesh resolves to ``dist``, and the facade
    takes the default mesh when none is passed."""
    m = default_mesh("cpu")
    assert (m.shape, m.axis_names) == ((1, 1), ("data", "model"))
    n, r, c, v, B = grid
    p = Problem.from_edges(n, r, c, v)
    s = setup(p, SolverOptions(device="cpu", **KW), mesh=mesh, cache=False)
    assert s.backend == "dist"
    s2 = setup(p, SolverOptions(device="cpu", **KW), backend="dist",
               cache=False)
    assert s2.stats()["levels"] == s.stats()["levels"]
    with pytest.raises(ValueError, match="mesh's device"):
        setup(p, SolverOptions(device="meta", **KW), backend="dist",
              mesh=mesh, cache=False)


def _service_stream(service, problems):
    tickets = [service.submit(p, H.mean_free(20 + i, p.n, k))
               for i, (p, k) in enumerate(problems)]
    service.flush()
    return [t.result() for t in tickets]


def test_service_through_dist(mesh):
    """A ``SolverService`` stream on the dist backend: every ticket's
    status and iterations equal the ``single`` backend's, ``x`` within
    rtol 1e-5 / atol 1e-5."""
    from repro_torch.service import SolverService

    g = Problem.from_edges(*grid_2d(10, 10))
    b = Problem.from_edges(*H.ba(120, 3, 1))
    stream = [(g, 1), (g, 3), (b, 2)]
    opts = SolverOptions(device="cpu", coarsest_size=16, dist_nnz_threshold=1)
    dist = _service_stream(SolverService(opts, backend="dist", mesh=mesh),
                           stream)
    single = _service_stream(SolverService(opts, backend="single"), stream)
    for (xd, rd), (xs, rs) in zip(dist, single):
        assert rd.backend == "dist" and rs.backend == "single"
        assert list(rd.statuses) == list(rs.statuses)
        assert rd.status == "converged"
        np.testing.assert_array_equal(rd.iters_per_rhs, rs.iters_per_rhs)
        np.testing.assert_allclose(xd, xs, rtol=1e-5, atol=1e-5)


def test_lobpcg_through_dist(mesh):
    from repro_torch.spectral import lobpcg

    p = Problem.from_edges(*grid_2d(10, 10))
    opts = SolverOptions(device="cpu", coarsest_size=16, dist_nnz_threshold=1,
                         exact_columns=False)
    d = lobpcg(p, 3, tol=1e-5, options=opts, backend="dist", mesh=mesh,
               cache=False, seed=0)
    s = lobpcg(p, 3, tol=1e-5, options=opts, backend="single", cache=False,
               seed=0)
    assert d.backend == "dist" and d.converged.all() and s.converged.all()
    np.testing.assert_allclose(d.eigenvalues, s.eigenvalues, rtol=1e-6)


def test_setup_misses_a_new_world():
    """A cached dist handle reduces over the group it was set up on, so
    the cache key names that group: after the world is destroyed and a new
    one started, ``setup()`` with the default mesh builds anew, and a
    second call in the new world hits. It replaces this process's world,
    so it stands last in the module."""
    from repro_torch.api import HierarchyCache
    from repro_torch.dist import init_world

    p = Problem.from_edges(*grid_2d(6, 6))
    opts = SolverOptions(device="cpu", coarsest_size=16)
    cache = HierarchyCache()
    had_world = torch.distributed.is_initialized()
    if not had_world:
        init_world("cpu")
    old = setup(p, opts, backend="dist", cache=cache)
    torch.distributed.destroy_process_group()
    init_world("cpu")
    new = setup(p, opts, backend="dist", cache=cache)
    again = setup(p, opts, backend="dist", cache=cache)
    assert new._handle is not old._handle
    assert again._handle is new._handle
    assert (cache.stats()["misses"], cache.stats()["hits"]) == (2, 1)
    x, res = new.solve(H.mean_free(3, p.n))
    assert res.status == "converged"
    if not had_world:
        torch.distributed.destroy_process_group()
