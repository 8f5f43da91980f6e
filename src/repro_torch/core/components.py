"""Connected components of a weighted graph (host-side numpy, setup time;
torch port of ``repro.core.components``).

A disconnected graph's Laplacian nullspace is spanned by the component
indicators, so components are detected once at setup and threaded into
the Krylov projection and the dense coarsest-level solve.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.segment import per_row, segment_sum


def connected_components(n: int, rows, cols) -> tuple[np.ndarray, int]:
    """Component labels (int32 [n], contiguous, ordered by smallest member)
    by scipy's linear-time graph search. The reference propagates minimum
    labels, whose rounds grow with the graph's diameter in vertex order
    (a mesh or a chain of components after the random relabeling); the
    labels are the same."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as search

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    a = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(n, n))
    n_comp, labels = search(a, directed=False)
    # number the components by their smallest member
    _, first = np.unique(labels, return_index=True)
    rank = np.empty(n_comp, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(n_comp)
    return rank[labels].astype(np.int32), int(n_comp)


def component_projector(comp: np.ndarray, n_comp: int, device):
    """``v -> v - per-component-mean(v)``: the disconnected-graph analogue
    of the Krylov layer's mean-free projection; ``v`` a vector or an
    ``[n, k]`` block (one segment sum for all k columns)."""
    comp_t = torch.as_tensor(comp, dtype=torch.int32, device=device)
    counts = torch.as_tensor(np.bincount(comp, minlength=n_comp)
                             .astype(np.float32), device=device)

    def project(v):
        means = segment_sum(v, comp_t, n_comp) / per_row(counts, v)
        return v - means[comp_t.long()]

    return project


def component_ones_matrix(comp: np.ndarray, n_comp: int) -> np.ndarray:
    """Σ_c (1_c 1_cᵀ / n_c): the multi-component regulariser of the dense
    coarsest-level solve."""
    comp = np.asarray(comp)
    counts = np.bincount(comp, minlength=n_comp).astype(np.float64)
    same = comp[:, None] == comp[None, :]
    return (same / counts[comp][:, None]).astype(np.float32)
