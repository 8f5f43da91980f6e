"""Seeded synthetic graph generators (host-side numpy).

The port's own copy of ``repro.graphs.generators``; for the same
arguments every generator returns the same arrays. They are seeded
stand-ins for the paper's evaluation graphs:

* ``barabasi_albert`` — power-law degree social/AS-style networks (hubs
  and a heavy tail),
* ``erdos_renyi`` — uniform random graphs,
* ``rmat`` — Kronecker power-law graphs (Graph500 parameters),
* ``delaunay`` — the ``delaunay_nXX`` family (planar, bounded degree),
* ``grid_2d`` — census/mesh-like planar graphs (the de2010 stand-in),
* ``star`` — one hub and n − 1 leaves,
* ``watts_strogatz`` — small-world rings.

Generators return ``(n, rows, cols, vals)`` with both edge directions, no
self loops and positive float32 weights, as numpy arrays;
``ensure_connected`` bridges components.
"""

from __future__ import annotations

import numpy as np


def _dedup_sym(n, u, v, w=None, rng=None):
    """Symmetrise + dedup an undirected edge list given as (u, v) pairs."""
    keep = u != v
    u, v = u[keep], v[keep]
    if w is not None:
        w = w[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key = lo.astype(np.int64) * n + hi
    _, idx = np.unique(key, return_index=True)
    lo, hi = lo[idx], hi[idx]
    if w is None:
        w = np.ones(len(lo), np.float32) if rng is None else rng.uniform(
            0.5, 1.5, len(lo)).astype(np.float32)
    else:
        w = w[idx].astype(np.float32)
    rows = np.concatenate([lo, hi]).astype(np.int32)
    cols = np.concatenate([hi, lo]).astype(np.int32)
    vals = np.concatenate([w, w])
    return n, rows, cols, vals


def barabasi_albert(n: int, m: int = 4, seed: int = 0, weighted: bool = False):
    """Preferential attachment; degree tail ~ k^-3. Sampling an index into
    the repeated-endpoint array is degree-proportional sampling; duplicates
    within a step are dropped."""
    rng = np.random.default_rng(seed)
    repeated = np.empty(2 * n * m + 2 * m, np.int64)
    repeated[:m] = np.arange(m)
    size = m
    src = np.empty(n * m, np.int64)
    dst = np.empty(n * m, np.int64)
    e = 0
    for v in range(m, n):
        chosen = np.unique(repeated[rng.integers(0, size, m)])
        k = len(chosen)
        src[e: e + k] = v
        dst[e: e + k] = chosen
        e += k
        repeated[size: size + k] = chosen
        repeated[size + k: size + 2 * k] = v
        size += 2 * k
    return _dedup_sym(n, src[:e], dst[:e], rng=rng if weighted else None)


def erdos_renyi(n: int, avg_degree: float = 8.0, seed: int = 0,
                weighted: bool = False):
    rng = np.random.default_rng(seed)
    n_edges = int(n * avg_degree / 2)
    u = rng.integers(0, n, n_edges)
    v = rng.integers(0, n, n_edges)
    return _dedup_sym(n, u, v, rng=rng if weighted else None)


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a=0.57, b=0.19, c=0.19, weighted: bool = False):
    """R-MAT/Kronecker generator (Graph500 parameters by default)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    n_edges = n * edge_factor
    u = np.zeros(n_edges, np.int64)
    v = np.zeros(n_edges, np.int64)
    for _ in range(scale):
        r = rng.random(n_edges)
        right = r >= a + b                   # the c or d quadrant: row bit
        bottom = ((r >= a) & (r < a + b)) | (r >= a + b + c)   # col bit
        u = (u << 1) | right.astype(np.int64)
        v = (v << 1) | bottom.astype(np.int64)
    return _dedup_sym(n, u, v, rng=rng if weighted else None)


def grid_2d(nx: int, ny: int, weighted: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = np.arange(nx * ny).reshape(nx, ny)
    u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return _dedup_sym(nx * ny, u, v, rng=rng if weighted else None)


def delaunay(n: int, seed: int = 0, weighted: bool = False):
    """Delaunay triangulation of n uniform points (scipy.spatial)."""
    from scipy.spatial import Delaunay as _Del

    rng = np.random.default_rng(seed)
    tri = _Del(rng.random((n, 2)))
    s = tri.simplices
    u = np.concatenate([s[:, 0], s[:, 1], s[:, 2]]).astype(np.int64)
    v = np.concatenate([s[:, 1], s[:, 2], s[:, 0]]).astype(np.int64)
    return _dedup_sym(n, u, v, rng=rng if weighted else None)


def star(n: int, weighted: bool = False, seed: int = 0):
    """Hub-and-spokes star: vertex 0 adjacent to all others."""
    rng = np.random.default_rng(seed)
    u = np.zeros(n - 1, np.int64)
    v = np.arange(1, n, dtype=np.int64)
    return _dedup_sym(n, u, v, rng=rng if weighted else None)


def watts_strogatz(n: int, k: int = 6, p: float = 0.1, seed: int = 0,
                   weighted: bool = False):
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64)
    us, vs = [], []
    for d in range(1, k // 2 + 1):
        tgt = (base + d) % n
        rewire = rng.random(n) < p
        tgt = np.where(rewire, rng.integers(0, n, n), tgt)
        us.append(base)
        vs.append(tgt)
    return _dedup_sym(n, np.concatenate(us), np.concatenate(vs),
                      rng=rng if weighted else None)


def ensure_connected(n, rows, cols, vals, seed: int = 0):
    """Chain one random vertex of each connected component to the next; a
    no-op on a connected graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    a = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    ncomp, labels = connected_components(a, directed=False)
    if ncomp <= 1:
        return (n, rows.astype(np.int32), cols.astype(np.int32),
                vals.astype(np.float32))
    rng = np.random.default_rng(seed + 12345)
    reps = np.empty(ncomp, np.int64)
    for comp in range(ncomp):
        reps[comp] = rng.choice(np.flatnonzero(labels == comp))
    u, v = reps[:-1], reps[1:]
    w = np.full(ncomp - 1, float(np.median(vals)) if len(vals) else 1.0,
                np.float32)
    out_r = np.concatenate([rows.astype(np.int64), u, v]).astype(np.int32)
    out_c = np.concatenate([cols.astype(np.int64), v, u]).astype(np.int32)
    out_w = np.concatenate([vals.astype(np.float32), w, w])
    return n, out_r, out_c, out_w


def random_relabel(n, rows, cols, seed: int):
    """The paper's §2.2 random vertex relabeling: ``new = perm[old]``.
    Returns ``(rows, cols, perm, inv_perm)``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    inv_perm = np.argsort(perm)
    return perm[rows], perm[cols], perm, inv_perm


def to_laplacian_coo(n, rows, cols, vals, capacity=None, device=None):
    """Adjacency edge list -> padded COO of the adjacency (the Laplacian is
    L = diag(deg) − A) on ``device`` (default: the CUDA card)."""
    from repro_torch.sparse.coo import coo_from_arrays

    return coo_from_arrays(rows, cols, vals, n, n, capacity=capacity,
                           device=device)


def largest_component_sizes(n, rows, cols) -> np.ndarray:
    """Connected component sizes (scipy): a validation helper."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    a = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    ncomp, labels = connected_components(a, directed=False)
    return np.bincount(labels, minlength=ncomp)
