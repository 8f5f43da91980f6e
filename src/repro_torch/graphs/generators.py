"""Seeded synthetic graph generators (host-side numpy).

The port's own copy of the generators the solver path needs from
``repro.graphs.generators``; for the same arguments they return the same
arrays. Generators return ``(n, rows, cols, vals)`` with both edge
directions, no self loops and positive float32 weights.
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


def grid_2d(nx: int, ny: int, weighted: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = np.arange(nx * ny).reshape(nx, ny)
    u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return _dedup_sym(nx * ny, u, v, rng=rng if weighted else None)


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
