"""Connected components of a weighted graph (host-side numpy, setup time;
torch port of ``repro.core.components``).

A disconnected graph's Laplacian nullspace is spanned by the component
indicators, so components are detected once at setup and threaded into
the Krylov projection and the dense coarsest-level solve.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.segment import segment_sum


def connected_components(n: int, rows, cols) -> tuple[np.ndarray, int]:
    """Component labels (int32 [n], contiguous, ordered by smallest member)
    by vectorised min-label propagation with pointer jumping."""
    labels = np.arange(n, dtype=np.int64)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    while True:
        prev = labels
        nxt = labels.copy()
        if len(rows):
            np.minimum.at(nxt, rows, labels[cols])
        while True:
            hop = nxt[nxt]
            if np.array_equal(hop, nxt):
                break
            nxt = hop
        labels = nxt
        if np.array_equal(labels, prev):
            break
    roots, comp = np.unique(labels, return_inverse=True)
    return comp.astype(np.int32), int(len(roots))


def component_projector(comp: np.ndarray, n_comp: int, device):
    """``v -> v - per-component-mean(v)``: the disconnected-graph analogue
    of the Krylov layer's mean-free projection."""
    comp_t = torch.as_tensor(comp, dtype=torch.int32, device=device)
    counts = torch.as_tensor(np.bincount(comp, minlength=n_comp)
                             .astype(np.float32), device=device)

    def project(v):
        means = segment_sum(v, comp_t, n_comp) / counts
        return v - means[comp_t.long()]

    return project


def component_ones_matrix(comp: np.ndarray, n_comp: int) -> np.ndarray:
    """Σ_c (1_c 1_cᵀ / n_c): the multi-component regulariser of the dense
    coarsest-level solve."""
    comp = np.asarray(comp)
    counts = np.bincount(comp, minlength=n_comp).astype(np.float64)
    same = comp[:, None] == comp[None, :]
    return (same / counts[comp][:, None]).astype(np.float32)
