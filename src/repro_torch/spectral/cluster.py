"""Spectral clustering and partitioning on top of the eigensolver (torch
port of ``repro.spectral.cluster``; host numpy/scipy).

Paper §1's motivating workloads: ``fiedler``/``fiedler_bisect`` (two-way
partition by the second eigenvector, with a conductance-minimizing sweep
cut), ``spectral_clustering`` (k-means on the k-eigenvector embedding),
``recursive_bisection`` (2^m-way partitioning), and the quality metrics
(``conductance``, ``normalized_cut``, ``cut_weight``) everything is scored
with. Solves ride the cached multigrid hierarchy via
:func:`repro_torch.spectral.lobpcg.lobpcg`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.spectral.embed import EmbeddingResult, spectral_embedding
from repro_torch.spectral.lobpcg import lobpcg

__all__ = ["ClusterResult", "conductance", "cut_weight", "fiedler",
           "fiedler_bisect", "kmeans", "normalized_cut",
           "recursive_bisection", "spectral_clustering", "sweep_cut"]


# ----------------------------------------------------------------------
# quality metrics (all on the directed both-ways edge list a Problem holds)
# ----------------------------------------------------------------------

def cut_weight(problem, labels) -> float:
    """Total weight of edges whose endpoints get different labels."""
    labels = np.asarray(labels)
    cross = labels[problem.rows] != labels[problem.cols]
    # each undirected edge appears in both directions: halve the sum
    return float(np.asarray(problem.vals, np.float64)[cross].sum() / 2)


def conductance(problem, mask) -> float:
    """cut(S, V\\S) / min(vol(S), vol(V\\S)) for the vertex set ``mask``.

    0 for a perfect separation, high for a cut through dense regions;
    degenerate cuts (empty side) return inf.
    """
    mask = np.asarray(mask, bool)
    vals = np.asarray(problem.vals, np.float64)
    cut = float(vals[mask[problem.rows] & ~mask[problem.cols]].sum())
    deg = np.asarray(problem.degrees(), np.float64)
    vol_s = float(deg[mask].sum())
    vol_c = float(deg.sum()) - vol_s
    denom = min(vol_s, vol_c)
    return cut / denom if denom > 0 else float("inf")


def normalized_cut(problem, labels) -> float:
    """Shi–Malik normalized cut: sum_c cut(c, rest) / vol(c)."""
    labels = np.asarray(labels)
    vals = np.asarray(problem.vals, np.float64)
    deg = np.asarray(problem.degrees(), np.float64)
    total = 0.0
    for c in np.unique(labels):
        in_c = labels == c
        cut = float(vals[in_c[problem.rows] & ~in_c[problem.cols]].sum())
        vol = float(deg[in_c].sum())
        total += cut / vol if vol > 0 else 0.0
    return total


# ----------------------------------------------------------------------
# Fiedler bisection
# ----------------------------------------------------------------------

def fiedler(problem, **lobpcg_kwargs) -> tuple[np.ndarray, float]:
    """The Fiedler pair: (second-smallest eigenvector, eigenvalue).

    One ``lobpcg`` call with k=1 (the constant vector is deflated, so the
    smallest *nontrivial* pair is exactly the Fiedler pair). Keyword
    arguments forward to :func:`repro_torch.spectral.lobpcg.lobpcg` —
    ``backend=``, ``cache=``, ``tol=``, ...
    """
    eig = lobpcg(problem, 1, **lobpcg_kwargs)
    return np.asarray(eig.eigenvectors[:, 0], np.float64), float(
        eig.eigenvalues[0])


def sweep_cut(problem, score) -> tuple[np.ndarray, float]:
    """Best-conductance prefix cut of vertices ordered by ``score``.

    The standard rounding of a Fiedler vector (Cheeger sweep): sort
    vertices by score, evaluate the conductance of every prefix with an
    incremental cut update, return ``(mask, conductance)`` for the best.
    """
    import scipy.sparse as sp

    n = problem.n
    score = np.asarray(score, np.float64)
    order = np.argsort(score, kind="stable")
    a = sp.csr_matrix(
        (np.asarray(problem.vals, np.float64),
         (np.asarray(problem.rows), np.asarray(problem.cols))),
        shape=(n, n))
    deg = np.asarray(problem.degrees(), np.float64)
    vol_total = float(deg.sum())
    in_s = np.zeros(n, bool)
    cut = 0.0
    vol = 0.0
    best_phi, best_i = float("inf"), 0
    for i, v in enumerate(order[:-1]):
        lo, hi = a.indptr[v], a.indptr[v + 1]
        w_to_s = float(a.data[lo:hi][in_s[a.indices[lo:hi]]].sum())
        cut += deg[v] - 2.0 * w_to_s
        vol += deg[v]
        in_s[v] = True
        denom = min(vol, vol_total - vol)
        phi = cut / denom if denom > 0 else float("inf")
        if phi < best_phi:
            best_phi, best_i = phi, i
    mask = np.zeros(n, bool)
    mask[order[: best_i + 1]] = True
    return mask, best_phi


def fiedler_bisect(problem, *, sweep: bool = True, **lobpcg_kwargs
                   ) -> tuple[np.ndarray, dict]:
    """Two-way partition by the Fiedler vector.

    ``sweep=True`` (default) rounds with the conductance-minimizing sweep
    cut; ``False`` uses the plain sign cut. Returns ``(mask, info)`` with
    ``info`` holding ``fiedler_value``, ``conductance`` and ``cut_weight``.
    """
    vec, lam = fiedler(problem, **lobpcg_kwargs)
    if sweep:
        mask, phi = sweep_cut(problem, vec)
    else:
        mask = vec > 0          # mean-free, so both signs are populated
        phi = conductance(problem, mask)
    return mask, dict(fiedler_value=lam, conductance=phi,
                      cut_weight=cut_weight(problem, mask.astype(np.int8)))


# ----------------------------------------------------------------------
# k-means (hand-rolled, seeded — no sklearn in the container)
# ----------------------------------------------------------------------

def kmeans(X, k: int, *, seed: int = 0, n_init: int = 4,
           max_iters: int = 100) -> tuple[np.ndarray, np.ndarray, float]:
    """Lloyd's k-means with k-means++ seeding and ``n_init`` restarts.

    Returns ``(labels, centers, inertia)`` of the best restart. Fully
    deterministic for a fixed seed.
    """
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(max(1, n_init)):
        centers = np.empty((k, X.shape[1]))
        centers[0] = X[rng.integers(n)]
        d2 = ((X - centers[0]) ** 2).sum(axis=1)
        for j in range(1, k):           # k-means++: D^2 sampling
            p = d2 / d2.sum() if d2.sum() > 0 else np.full(n, 1.0 / n)
            centers[j] = X[rng.choice(n, p=p)]
            d2 = np.minimum(d2, ((X - centers[j]) ** 2).sum(axis=1))
        labels = np.zeros(n, np.int64)
        for _ in range(max_iters):
            dist = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
            new_labels = dist.argmin(axis=1)
            if (new_labels == labels).all() and _ > 0:
                break
            labels = new_labels
            for j in range(k):
                members = X[labels == j]
                if len(members):
                    centers[j] = members.mean(axis=0)
                else:                   # re-seed an empty cluster
                    centers[j] = X[rng.integers(n)]
        inertia = float(
            ((X - centers[labels]) ** 2).sum())
        if best is None or inertia < best[2]:
            best = (labels.copy(), centers.copy(), inertia)
    return best


# ----------------------------------------------------------------------
# spectral clustering / recursive partitioning
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ClusterResult:
    """A vertex partition plus its quality scores.

    ``labels`` is (n,) int64 in ``[0, n_clusters)``; ``conductances`` is
    the per-cluster conductance; ``embedding`` is the spectral embedding
    the labels came from (``None`` for recursive bisection).
    """

    labels: np.ndarray
    n_clusters: int
    ncut: float
    conductances: np.ndarray
    cut_weight: float
    embedding: EmbeddingResult | None = None


def _scored(problem, labels, n_clusters, embedding=None) -> ClusterResult:
    labels = np.asarray(labels, np.int64)
    phis = np.array([conductance(problem, labels == c)
                     for c in range(n_clusters)])
    return ClusterResult(labels=labels, n_clusters=n_clusters,
                         ncut=normalized_cut(problem, labels),
                         conductances=phis,
                         cut_weight=cut_weight(problem, labels),
                         embedding=embedding)


def spectral_clustering(problem, k: int, *, embed_k: int | None = None,
                        row_normalize: bool = False, kmeans_seed: int = 0,
                        n_init: int = 4, **lobpcg_kwargs) -> ClusterResult:
    """k-way spectral clustering: k-means on the spectral embedding.

    ``embed_k`` defaults to ``max(k - 1, 1)`` nontrivial eigenvectors (the
    constant one carries no cluster information). Remaining keyword
    arguments go to :func:`lobpcg` via :func:`spectral_embedding`.
    """
    if k < 2:
        raise ValueError(f"need k >= 2 clusters, got {k}")
    embed_k = max(k - 1, 1) if embed_k is None else int(embed_k)
    emb = spectral_embedding(problem, embed_k, row_normalize=row_normalize,
                             **lobpcg_kwargs)
    labels, _, _ = kmeans(emb.coords, k, seed=kmeans_seed, n_init=n_init)
    return _scored(problem, labels, k, embedding=emb)


def _subproblem(problem, idx):
    """Induced subgraph on ``idx`` as a new Problem (validated edges)."""
    from repro_torch.api import Problem

    idx = np.asarray(idx)
    pos = np.full(problem.n, -1, np.int64)
    pos[idx] = np.arange(len(idx))
    keep = (pos[problem.rows] >= 0) & (pos[problem.cols] >= 0)
    return Problem.from_edges(len(idx), pos[problem.rows[keep]],
                              pos[problem.cols[keep]], problem.vals[keep])


def _component_split(sub) -> np.ndarray:
    """Bisect a disconnected graph along components, balancing volume."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    a = sp.coo_matrix((np.ones(len(sub.rows)), (sub.rows, sub.cols)),
                      shape=(sub.n, sub.n))
    _, comp = connected_components(a, directed=False)
    deg = np.asarray(sub.degrees(), np.float64) + 1e-12
    vols = np.bincount(comp, weights=deg)
    order = np.argsort(vols)[::-1]
    side_vol = np.zeros(2)
    side_of = np.zeros(len(vols), np.int8)
    for c in order:                     # greedy balance
        s = int(side_vol[1] < side_vol[0])
        side_of[c] = s
        side_vol[s] += vols[c]
    return side_of[comp] == 1


def recursive_bisection(problem, n_parts: int, *, precond_min_n: int = 256,
                        min_part: int = 1, **lobpcg_kwargs) -> ClusterResult:
    """Partition into ``n_parts`` by recursive Fiedler bisection.

    Repeatedly sweep-cuts the largest-volume part's induced subgraph.
    Disconnected subgraphs split along their components (no solve
    needed); subgraphs smaller than ``precond_min_n`` solve
    unpreconditioned (a multigrid setup wouldn't amortize). Keyword
    arguments forward to :func:`fiedler_bisect`'s eigensolve.
    """
    if n_parts < 2:
        raise ValueError(f"need n_parts >= 2, got {n_parts}")
    deg = np.asarray(problem.degrees(), np.float64)
    parts = [np.arange(problem.n)]
    while len(parts) < n_parts:
        splittable = [i for i, p in enumerate(parts)
                      if len(p) >= max(2, 2 * min_part)]
        if not splittable:
            break
        i = max(splittable, key=lambda j: deg[parts[j]].sum())
        part = parts.pop(i)
        sub = _subproblem(problem, part)
        from repro_torch.graphs.generators import largest_component_sizes

        if len(largest_component_sizes(sub.n, sub.rows, sub.cols)) > 1:
            mask = _component_split(sub)
        elif sub.n < 4:
            mask = np.zeros(sub.n, bool)
            mask[: sub.n // 2] = True
        else:
            kw = dict(lobpcg_kwargs)
            if sub.n < precond_min_n:
                kw.setdefault("precondition", False)
                kw.setdefault("max_iters", 500)
            mask, _ = fiedler_bisect(sub, **kw)
        parts.append(part[mask])
        parts.append(part[~mask])
    labels = np.zeros(problem.n, np.int64)
    for c, p in enumerate(parts):
        labels[p] = c
    return _scored(problem, labels, len(parts))
