"""The port's spectral layer (``repro_torch.spectral``) against the
reference's (``repro.spectral``), after ``tests/test_spectral.py``.

On the reference tests' small graphs (grid 10×10, BA 120, star 64, path
48 and the planted partitions): LOBPCG against a dense ``np.linalg.eigh``
oracle at rtol 1e-6 on both eager backends, and against the reference's
own run on the same inputs (eigenvalues at rtol 1e-6, sign-canonical
eigenvectors at atol 1e-5 — eigenspaces where the spectrum is degenerate —
and the outer iterations within ±1). The numpy helpers (``kmeans``,
``canonicalize_signs``, ``sweep_cut``, the cut metrics) give the
reference's results exactly on the same embedding; the clustering,
partitioning, resistance and positional-encoding contracts of the
reference's tests hold for the port, and ``graph_batch_with_pe`` builds
the reference's arrays. The port runs with ``device="cpu"``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import repro.api as J  # noqa: E402
import repro.spectral as JP  # noqa: E402
from repro_torch.api import (HierarchyCache, Problem,  # noqa: E402
                             SolverOptions, setup)
from repro_torch.graphs.generators import (barabasi_albert,  # noqa: E402
                                           ensure_connected, grid_2d, star)
from repro_torch.spectral import (canonicalize_signs,  # noqa: E402
                                  conductance, cut_weight,
                                  effective_resistance,
                                  exact_effective_resistance, fiedler,
                                  fiedler_bisect, graph_batch_with_pe,
                                  incremental_embedding, kmeans,
                                  laplacian_pe, lobpcg, normalized_cut,
                                  recursive_bisection, refine_eigenpairs,
                                  spectral_clustering, spectral_embedding,
                                  sweep_cut)

CPU = dict(device="cpu")
CACHE = HierarchyCache()
J_CACHE = J.HierarchyCache()


def _edges(name):
    if name == "grid":
        return ensure_connected(*grid_2d(10, 10))
    if name == "ba":
        return ensure_connected(*barabasi_albert(120, m=3, seed=1,
                                                 weighted=True))
    if name == "star":
        return star(64)
    if name == "path":
        return grid_2d(48, 1)
    raise KeyError(name)


def _problem(name, mod=None):
    return (mod.Problem if mod else Problem).from_edges(*_edges(name))


def _planted(blocks=2, size=100, bridges=5, seed=0):
    """``tests/test_spectral.py``'s planted partition."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b in range(blocks):
        u = rng.integers(0, size, 6 * size) + b * size
        v = rng.integers(0, size, 6 * size) + b * size
        rows.extend(u)
        cols.extend(v)
    for a in range(blocks):
        for b in range(a + 1, blocks):
            for _ in range(bridges):
                rows.append(a * size + rng.integers(0, size))
                cols.append(b * size + rng.integers(0, size))
    rows, cols = np.asarray(rows), np.asarray(cols)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r2 = np.concatenate([rows, cols]).astype(np.int32)
    c2 = np.concatenate([cols, rows]).astype(np.int32)
    n, r2, c2, v2 = ensure_connected(blocks * size, r2, c2,
                                     np.ones(len(r2), np.float32))
    return Problem.from_edges(n, r2, c2, v2, allow_duplicates=True)


def _dense_spectrum(p):
    L = np.zeros((p.n, p.n))
    L[p.rows, p.cols] = -np.asarray(p.vals, np.float64)
    np.fill_diagonal(L, np.asarray(p.degrees(), np.float64))
    return np.linalg.eigh(L)


@pytest.fixture(scope="module")
def eig_pairs():
    """k = 6 on the grid and BA graphs, through each package's default
    (throughput) preconditioner options."""
    out = {}
    for name in ("grid", "ba"):
        port = lobpcg(_problem(name), 6, tol=1e-6, cache=CACHE, seed=0,
                      **CPU)
        ref = JP.lobpcg(_problem(name, J), 6, tol=1e-6, cache=J_CACHE,
                        seed=0)
        out[name] = (port, ref)
    return out


# ----------------------------------------------------------------------
# LOBPCG
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["single", "serial_ref"])
@pytest.mark.parametrize("graph", ["grid", "ba"])
def test_matches_dense_oracle(backend, graph):
    p = _problem(graph)
    ev, _ = _dense_spectrum(p)
    k = 6
    res = lobpcg(p, k, tol=1e-6, backend=backend, cache=CACHE, seed=0, **CPU)
    assert res.converged.all(), res.residual_norms[-1]
    assert res.backend == backend
    np.testing.assert_allclose(res.eigenvalues, ev[1: k + 1], rtol=1e-6,
                               atol=1e-12)
    X = res.eigenvectors
    np.testing.assert_allclose(X.T @ X, np.eye(k), atol=1e-8)
    assert np.abs(X.mean(axis=0)).max() < 1e-8
    assert res.precond_solves == res.iters
    assert 0 < res.precond_columns <= res.precond_solves * k


def _clusters(ev, rtol=1e-6):
    """Index groups of numerically equal eigenvalues."""
    groups = [[0]]
    for i in range(1, len(ev)):
        if abs(ev[i] - ev[groups[-1][-1]]) <= rtol * abs(ev[i]):
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


@pytest.mark.parametrize("graph", ["grid", "ba"])
def test_matches_reference_run(eig_pairs, graph):
    port, ref = eig_pairs[graph]
    assert port.converged.all() and np.asarray(ref.converged).all()
    np.testing.assert_allclose(port.eigenvalues, ref.eigenvalues, rtol=1e-6)
    assert abs(port.iters - ref.iters) <= 1
    assert port.backend == ref.backend == "single"
    assert port.precond_status == ref.precond_status
    X, Y = port.eigenvectors, np.asarray(ref.eigenvectors)
    for group in _clusters(np.asarray(ref.eigenvalues)):
        if len(group) == 1:
            np.testing.assert_allclose(canonicalize_signs(X[:, group]),
                                       JP.canonicalize_signs(Y[:, group]),
                                       atol=1e-5)
        else:       # a degenerate eigenspace: compare the projectors
            np.testing.assert_allclose(X[:, group] @ X[:, group].T,
                                       Y[:, group] @ Y[:, group].T,
                                       atol=1e-5)


def test_default_options_take_the_device():
    """``device`` fills only the default options: the same run as the
    explicit throughput options on that device, bit for bit; without a
    card and without ``device`` the entry point raises."""
    p = _problem("path")
    opts = SolverOptions(exact_columns=False, coarsest_size=24, **CPU)
    a = lobpcg(p, 3, tol=1e-5, cache=False, **CPU)
    b = lobpcg(p, 3, tol=1e-5, cache=False, options=opts)
    np.testing.assert_array_equal(a.eigenvectors, b.eigenvectors)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lobpcg(p, 3, cache=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            effective_resistance(p, n_probes=2, cache=False)


def test_star_multiplicity():
    p = _problem("star")
    res = lobpcg(p, 5, tol=1e-6, cache=CACHE, seed=0, **CPU)
    assert res.converged.all()
    np.testing.assert_allclose(res.eigenvalues, np.ones(5), rtol=1e-6)
    X = res.eigenvectors
    np.testing.assert_allclose(X.T @ X, np.eye(5), atol=1e-8)


def test_preconditioning_helps():
    p = _problem("grid")
    pre = lobpcg(p, 4, tol=1e-5, cache=CACHE, seed=0, **CPU)
    unp = lobpcg(p, 4, tol=1e-5, precondition=False, max_iters=400, seed=0)
    assert pre.converged.all() and unp.converged.all()
    assert pre.iters < unp.iters
    assert pre.backend != "none" and unp.backend == "none"


@pytest.mark.parametrize("k", [0, 64])
def test_validates_k_as_the_reference(k):
    with pytest.raises(ValueError) as want:
        JP.lobpcg(_problem("star", J), k)
    with pytest.raises(ValueError) as got:
        lobpcg(_problem("star"), k, **CPU)
    assert str(got.value) == str(want.value)


def test_warm_start_and_refine():
    p = _problem("ba")
    ev, _ = _dense_spectrum(p)
    cold = lobpcg(p, 4, tol=1e-5, cache=CACHE, seed=0, **CPU)
    warm = lobpcg(p, 4, tol=1e-5, cache=CACHE, X0=cold.eigenvectors, **CPU)
    assert warm.iters <= 2
    np.testing.assert_allclose(warm.eigenvalues, ev[1:5], rtol=1e-6)
    ref = refine_eigenpairs(p, warm, cache=CACHE, **CPU)
    np.testing.assert_allclose(ref.eigenvalues, ev[1:5], rtol=1e-6)


# ----------------------------------------------------------------------
# numpy helpers: the reference's results exactly
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
def test_kmeans_identical_to_reference(seed):
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(40, 2)),
                        rng.normal(size=(40, 2)) + 6.0,
                        rng.normal(size=(30, 2)) - 6.0])
    got, want = kmeans(X, 3, seed=seed), JP.kmeans(X, 3, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_canonicalize_signs_identical_to_reference():
    V = np.random.default_rng(0).normal(size=(30, 4))
    W = canonicalize_signs(V)
    np.testing.assert_array_equal(W, JP.canonicalize_signs(V))
    np.testing.assert_array_equal(canonicalize_signs(-V), W)
    np.testing.assert_array_equal(canonicalize_signs(W), W)


def test_cluster_labels_and_scores_identical_to_reference():
    """On the port's own embedding, the reference's k-means gives the same
    labels, and the reference's metrics the same scores."""
    p = _planted(blocks=3, size=80, seed=1)
    jp = J.Problem.from_edges(p.n, p.rows, p.cols, p.vals,
                              allow_duplicates=True)
    res = spectral_clustering(p, 3, tol=1e-5, cache=CACHE, seed=0, **CPU)
    labels, _, _ = JP.kmeans(res.embedding.coords, 3, seed=0, n_init=4)
    np.testing.assert_array_equal(res.labels, labels)
    assert res.ncut == JP.normalized_cut(jp, labels)
    assert res.cut_weight == JP.cut_weight(jp, labels)
    np.testing.assert_array_equal(
        res.conductances,
        [JP.conductance(jp, labels == c) for c in range(3)])
    score = res.embedding.coords[:, 0]
    mask, phi = sweep_cut(p, score)
    jmask, jphi = JP.sweep_cut(jp, score)
    np.testing.assert_array_equal(mask, jmask)
    assert phi == jphi


# ----------------------------------------------------------------------
# clustering and partitioning contracts
# ----------------------------------------------------------------------
def test_fiedler_beats_old_inverse_iteration():
    p = _planted()
    solver = setup(p, SolverOptions(coarsest_size=min(128, p.n // 2),
                                    exact_columns=False, **CPU),
                   cache=CACHE)
    rng = np.random.default_rng(0)
    x = rng.normal(size=p.n).astype(np.float32)
    x -= x.mean()
    for _ in range(8):
        x, _ = solver.solve(x, tol=1e-6, max_iters=100)
        x = np.array(x)
        x -= x.mean()
        x /= np.linalg.norm(x)
    phi_old = conductance(p, x > 0)
    mask, info = fiedler_bisect(p, tol=1e-5, cache=CACHE, seed=0, **CPU)
    assert info["conductance"] <= phi_old + 1e-12
    assert 0 < mask.sum() < p.n


def test_sweep_cut_no_worse_than_sign_cut():
    p = _planted(seed=3)
    vec, lam2 = fiedler(p, tol=1e-5, cache=CACHE, seed=0, **CPU)
    assert lam2 > 0
    _, phi_sweep = sweep_cut(p, vec)
    assert phi_sweep <= conductance(p, vec > 0) + 1e-12
    _, info = fiedler_bisect(p, sweep=False, tol=1e-5, cache=CACHE, seed=0,
                             **CPU)
    assert phi_sweep <= info["conductance"] + 1e-12


def test_spectral_clustering_recovers_blocks():
    p = _planted(blocks=3, size=80, seed=1)
    truth = np.arange(p.n) // 80
    res = spectral_clustering(p, 3, tol=1e-5, cache=CACHE, seed=0, **CPU)
    assert res.n_clusters == 3
    acc = sum(np.bincount(truth[res.labels == j]).max()
              for j in range(3)) / p.n
    assert acc > 0.9, acc
    assert res.ncut < 0.5 and np.isfinite(res.conductances).all()
    assert res.cut_weight == cut_weight(p, res.labels)
    assert res.ncut == normalized_cut(p, res.labels)


def test_recursive_bisection_partitions():
    p = _planted(blocks=4, size=60, seed=2)
    res = recursive_bisection(p, 4, tol=1e-5, cache=CACHE, seed=0, **CPU)
    assert res.n_clusters == 4
    assert np.array_equal(np.unique(res.labels), np.arange(4))
    truth = np.arange(p.n) // 60
    acc = sum(np.bincount(truth[res.labels == j]).max()
              for j in range(4)) / p.n
    assert acc > 0.9, acc


def test_incremental_embedding_extends():
    p = _problem("grid")
    emb = spectral_embedding(p, 3, tol=1e-5, cache=CACHE, seed=0, **CPU)
    emb6 = incremental_embedding(p, emb, k=6, tol=1e-5, cache=CACHE, **CPU)
    assert emb6.coords.shape == (p.n, 6)
    ev, _ = _dense_spectrum(p)
    np.testing.assert_allclose(emb6.eigenvalues, ev[1:7], rtol=1e-5)


# ----------------------------------------------------------------------
# effective resistance and positional encodings
# ----------------------------------------------------------------------
@pytest.mark.parametrize("graph", ["grid", "star"])
def test_sketch_matches_exact(graph):
    if graph == "grid":
        n, r, c, v = ensure_connected(*grid_2d(8, 8))
    else:
        n, r, c, v = star(64)
    p = Problem.from_edges(n, r, c, v)
    eps = 0.3
    sk = effective_resistance(p, eps=eps, seed=1, cache=CACHE, **CPU)
    exact = exact_effective_resistance(p)
    np.testing.assert_array_equal(
        exact, JP.exact_effective_resistance(J.Problem.from_edges(n, r, c,
                                                                  v)))
    u, v = np.triu_indices(p.n, k=1)
    rel = np.abs(sk.query(u, v) - exact[u, v]) / exact[u, v]
    assert rel.max() < 2 * eps, rel.max()
    assert np.median(rel) < eps


def test_query_broadcasts_and_is_symmetric():
    n, r, c, v = ensure_connected(*grid_2d(6, 6))
    p = Problem.from_edges(n, r, c, v)
    sk = effective_resistance(p, eps=0.4, seed=0, cache=CACHE, **CPU)
    assert sk.query(0, 1).shape == ()
    assert sk.query(0, np.arange(1, 6)).shape == (5,)
    np.testing.assert_allclose(sk.query([0, 2], [5, 9]),
                               sk.query([5, 9], [0, 2]))


def test_laplacian_pe_deterministic_and_sign_canonical():
    p = _problem("path")
    pe1 = laplacian_pe(p, k=4, tol=1e-6, cache=CACHE, seed=0, **CPU)
    pe2 = laplacian_pe(p, k=4, tol=1e-6, cache=CACHE, seed=0, **CPU)
    np.testing.assert_array_equal(pe1, pe2)
    assert pe1.dtype == np.float32 and pe1.shape == (p.n, 4)
    pe3 = laplacian_pe(p, k=4, tol=1e-6, cache=CACHE, seed=11, **CPU)
    np.testing.assert_allclose(pe1, pe3, atol=5e-4)


def test_graph_batch_same_arrays_as_reference(eig_pairs):
    """Warm-started from each package's converged BA eigenvectors, both
    build the same senders, receivers, edge weights and (sign-canonical)
    node features."""
    from repro_torch.models.gnn.common import GraphBatch

    port, ref = eig_pairs["ba"]
    feats = np.arange(2 * 120, dtype=np.float32).reshape(120, 2)
    gb = graph_batch_with_pe(_problem("ba"), k=6, tol=1e-6, cache=CACHE,
                             X0=port.eigenvectors, node_feat=feats, **CPU)
    jgb = JP.graph_batch_with_pe(_problem("ba", J), k=6, tol=1e-6,
                                 cache=J_CACHE, X0=ref.eigenvectors,
                                 node_feat=feats)
    assert isinstance(gb, GraphBatch)
    for name in ("senders", "receivers", "edge_feat"):
        got, want = getattr(gb, name), np.asarray(getattr(jgb, name))
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert gb.node_feat.shape == (120, 8) and gb.n_nodes == jgb.n_nodes
    assert gb.n_edges == jgb.n_edges and bool(gb.edge_valid.all())
    np.testing.assert_allclose(gb.node_feat.numpy(),
                               np.asarray(jgb.node_feat), atol=1e-5)
    bare = graph_batch_with_pe(_problem("ba"), k=6, tol=1e-6, cache=CACHE,
                               X0=port.eigenvectors, edge_feat_weights=False,
                               **CPU)
    assert bare.edge_feat is None and bare.node_feat.shape == (120, 6)
