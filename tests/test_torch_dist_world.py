"""The distributed port on a real 4-rank world: four spawned gloo
processes on the CPU (``repro_torch.dist.run_world``), once for the whole
file, joined under a timeout.

Every rank runs ``torch_dist_helpers.rank_body`` on a 2×2 mesh and on a
(2, 1, 2) pod mesh of the same group. Held against a world of one in this
process: the partition primitives bit-exact against the port's serial
selection and vote (in every rank), the distributed super-step's integer
decisions (level kinds and sizes, elimination masks, coarse ids) equal,
and the solves (``ell`` on the 2×2 mesh, ``coo`` on the pod mesh) with
equal iterations and ``x`` within rtol 1e-5 / atol 1e-5. The reference's 2×2 cases
(``tests/test_dist.py``, ``tests/test_dist_setup.py``) need 4 simulated
JAX devices in a subprocess each; these compare the port with itself, so
no JAX runs here.

On a world of one in this process: the distributed super-step bitwise
the serial one, the hierarchy split rules, the mesh's checks; and
``run_world``'s report of a failed rank.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import repro_torch.dist as TD  # noqa: E402
import torch_dist_helpers as H  # noqa: E402
from repro_torch.core.hierarchy import SetupConfig  # noqa: E402
from repro_torch.dist import run_world  # noqa: E402

WORLD_TIMEOUT_S = 240.0
KW = dict(coarsest_size=64)
DIST_KW = dict(dist_nnz_threshold=100, max_dist_levels=3)
SOLVE_KW = dict(n_iters=12, tol=1e-6)


@pytest.fixture(scope="module")
def ranks():
    """What each of the 4 ranks returned, in rank order."""
    return run_world(H.rank_body, 4, timeout=WORLD_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def one():
    """The same graph's setups and solves on a world of one."""
    with H.world_of_one() as mesh:
        return {backend: H.solve_ba800(mesh, backend)
                for backend in ("ell", "coo")}


@pytest.mark.parametrize("grid", sorted(H.MESHES))
def test_coordinates_cover_the_grid(ranks, grid):
    shape = H.MESHES[grid][0]
    coords = [res[grid]["coords"] for res in ranks]
    assert coords == [tuple(int(i) for i in np.unravel_index(r, shape))
                      for r in range(4)]
    blocks = {res[grid]["block"] for res in ranks}
    pods = shape[0] if len(shape) == 3 else 1
    assert len(blocks) == 4
    assert all(p < pods and i < shape[-2] and j < shape[-1]
               for p, i, j in blocks)


@pytest.mark.parametrize("grid", sorted(H.MESHES))
@pytest.mark.parametrize("what", ["select", "vote", "aggregate"])
def test_primitives_bit_exact_in_every_rank(ranks, grid, what):
    """Alg 1 selection, one Alg 2 round and all of Alg 2 over the 2D
    partition equal the port's single-device versions bit for bit."""
    assert [res[grid][what] for res in ranks] == [True] * 4


@pytest.mark.parametrize("grid", sorted(H.MESHES))
def test_superstep_decisions_equal_world_of_one(ranks, one, grid):
    """The distributed super-step's hierarchy in every rank: the same
    levels and integer decisions as the world of one's."""
    want = one["coo"]["decisions"]
    assert one["ell"]["decisions"]["kinds"] == want["kinds"]
    for res in ranks:
        got = res[grid]["decisions"]
        assert got["kinds"] == want["kinds"]
        assert got["sizes"] == want["sizes"]
        for g, w in zip(got["ids"], want["ids"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("grid", sorted(H.MESHES))
def test_solve_matches_world_of_one(ranks, one, grid):
    """The 2×2 mesh runs the ELL path, the pod mesh the COO one: equal
    levels and iterations; the all-reduced float sums run in another
    order than the world of one's, so ``x`` at rtol 1e-5 / atol 1e-5 and
    the norms at rtol 1e-4."""
    want = one[H.MESHES[grid][2]]
    got = ranks[0][grid]
    assert got["meta"] == want["meta"] and len(want["meta"]) == 2
    np.testing.assert_array_equal(got["iters"], want["iters"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-4)


@pytest.mark.parametrize("grid", sorted(H.MESHES))
def test_ranks_stay_in_step(ranks, grid):
    """Replicated results are bitwise equal on every rank, and every rank
    made the same all-reduces (none staged: the tensors are on the
    CPU)."""
    x0 = ranks[0][grid]["x"]
    for res in ranks[1:]:
        assert np.array_equal(res[grid]["x"].view(np.int32),
                              x0.view(np.int32))
    stats = [res[grid]["stats"] for res in ranks]
    assert all(s == stats[0] for s in stats)
    assert stats[0]["calls"] > 0 and stats[0]["staged"] == 0


def test_run_world_reports_a_failed_rank():
    """A rank that raises ends the world: the parent kills the rank left
    waiting in a collective and raises with the failed rank's
    traceback, well before the timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one"):
        run_world(H.fail_on_rank_one, 2, timeout=120, threads=1)
    assert time.monotonic() - t0 < 60


# ----------------------------------------------------------------------
# A world of one in this process
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    with H.world_of_one() as m:
        yield m


@pytest.fixture(scope="module")
def ba():
    """The reference's ``tests/test_dist.py`` graph."""
    n, r, c, v = H.ba(1200, 3, 3)
    return n, r, c, v, H.mean_free(11, n, 2)


@pytest.fixture(scope="module")
def port(ba, mesh):
    n, r, c, v, B = ba
    s = TD.DistLaplacianSolver.setup(
        n, r, c, v, mesh, SetupConfig(matvec_backend="ell", **KW), **DIST_KW)
    X, norms, iters = s.solve_block(B, **SOLVE_KW)
    return dict(solver=s, X=X.numpy(), norms=norms, iters=iters)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kw,n_dist", [
    (dict(dist_nnz_threshold=10**9), 0), (dict(max_dist_levels=1), 1),
    (dict(dist_nnz_threshold=7000), 2)])
def test_split_rules(ba, mesh, port, kw, n_dist):
    """At most ``max_dist_levels`` top levels with at least
    ``dist_nnz_threshold`` nonzeros, counted from the top, are
    distributed (the levels' nnz are 7,122, 7,378 and 1,776); the rest,
    or everything, is the
    replicated tail, and the solve is the same to float rounding."""
    n, r, c, v, B = ba
    s = TD.DistLaplacianSolver.setup(
        n, r, c, v, mesh, SetupConfig(matvec_backend="ell", **KW),
        **dict(DIST_KW, **kw))
    assert len(s.level_meta) == n_dist
    assert s.n_pad == n
    X, _, iters = s.solve_block(B, **SOLVE_KW)
    _eq(iters, port["iters"])
    np.testing.assert_allclose(X.numpy(), port["X"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("elim_sizing", ["conservative", "exact"])
def test_superstep_bitwise_serial(ba, mesh, elim_sizing):
    """On one rank the distributed super-step is the serial super-step bit
    for bit (the reference's 1×1 contract), with the same host fetches."""
    from repro_torch.core import setup_step as ss
    from repro_torch.graphs.generators import to_laplacian_coo

    n, r, c, v, _ = ba
    adj = to_laplacian_coo(n, r, c, v, device="cpu")
    cfg = SetupConfig(elim_sizing=elim_sizing, **KW)
    ss.reset_counters()
    dist_h = TD.build_hierarchy_superstep_dist(adj, cfg, mesh)
    dist_fetches = ss.counters()["host_syncs"]
    ss.reset_counters()
    serial_h = ss.build_hierarchy_superstep(adj, cfg)
    assert ss.counters()["host_syncs"] == dist_fetches
    got, want = list(H.hierarchy_bits(dist_h)), list(H.hierarchy_bits(serial_h))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), p


def test_mesh_checks(mesh):
    import torch.distributed as dist

    assert (mesh.shape, mesh.coords, mesh.block) == ((1, 1), (0, 0),
                                                     (0, 0, 0))
    assert mesh.backend == "gloo" and not mesh.staged
    with pytest.raises(ValueError, match="2D"):
        TD.make_mesh((1,), ("x",), device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        TD.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="already"):
        TD.init_world("cpu")
    assert TD.factor_grid(8) == (2, 4) and TD.factor_grid(6) == (2, 3)
    t = torch.arange(4, dtype=torch.int32)
    before = mesh.stats()["calls"]
    assert torch.equal(mesh.pmax(t.clone()), t)
    assert mesh.stats()["calls"] == before + 1
    assert dist.is_initialized()
