"""Laplacian positional encodings for the in-repo GNN models (torch port
of ``repro.spectral.pe``).

The k smallest nontrivial Laplacian eigenvectors are the standard
structural positional encoding for graph transformers and message-passing
nets (each vertex gets its coordinates in the graph's smoothest modes).
Eigenvectors are only defined up to sign (and rotation inside degenerate
eigenspaces), so ``laplacian_pe`` canonicalizes signs deterministically;
``graph_batch_with_pe`` wires the encodings straight into the
:class:`repro_torch.models.gnn.common.GraphBatch` container the in-repo
GNNs (PNA / EGNN / equiformer / meshgraphnet) consume.
"""

from __future__ import annotations

import numpy as np

from repro_torch.spectral.lobpcg import lobpcg

__all__ = ["canonicalize_signs", "graph_batch_with_pe", "laplacian_pe"]


def canonicalize_signs(V) -> np.ndarray:
    """Fix each column's sign by its projection onto a fixed reference.

    The reference is a seed-0 standard-normal vector (a function of n
    only), so the flip is deterministic AND stable to eigensolver noise —
    unlike largest-|entry| rules, which break on eigenvectors whose
    extreme entries sit at automorphic vertices (path ends, grid corners)
    where float noise decides the tie. Columns numerically orthogonal to
    the reference fall back to the largest-|entry| sign. Degenerate
    eigenspaces remain basis-dependent — document k around known
    multiplicities (e.g. square grids) if exact reproducibility matters.
    """
    V = np.asarray(V, np.float64).copy()
    n, k = V.shape
    ref = np.random.default_rng(0).standard_normal(n)
    proj = V.T @ ref
    idx = np.abs(V).argmax(axis=0)
    fallback = np.sign(V[idx, np.arange(k)])
    scale = np.linalg.norm(V, axis=0) * np.linalg.norm(ref)
    sgn = np.where(np.abs(proj) > 1e-9 * np.maximum(scale, 1e-300),
                   np.sign(proj), fallback)
    V *= np.where(sgn == 0, 1.0, sgn)[None, :]
    return V


def laplacian_pe(problem, k: int = 8, *, dtype=np.float32,
                 **lobpcg_kwargs) -> np.ndarray:
    """(n, k) positional-encoding matrix: sign-canonicalized eigenvectors.

    Column j is the (j+1)-th smallest Laplacian eigenvector (the trivial
    constant is deflated away). Keyword arguments forward to
    :func:`repro_torch.spectral.lobpcg.lobpcg` — in particular ``cache=``
    makes repeated PE extraction on one graph reuse its hierarchy.
    """
    eig = lobpcg(problem, k, **lobpcg_kwargs)
    return canonicalize_signs(eig.eigenvectors).astype(dtype)


def graph_batch_with_pe(problem, k: int = 8, *, node_feat=None,
                        edge_feat_weights: bool = True, **lobpcg_kwargs):
    """A GNN-ready :class:`~repro_torch.models.gnn.common.GraphBatch` whose
    node features carry the PE.

    ``node_feat`` (n, d) is concatenated with the (n, k) encoding when
    given; otherwise the encoding alone is the feature block. Edge
    features default to the (2|E|, 1) edge weights. The senders/receivers
    come straight from the Problem's directed both-ways edge list, so
    message passing sees the same graph the solver does. The tensors lie
    on the device the eigensolve's preconditioner ran on (``options.device``
    when ``options`` is passed, else ``device``; None = the CUDA card).
    """
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models.gnn.common import GraphBatch

    options = lobpcg_kwargs.get("options")
    dev = resolve_device(lobpcg_kwargs.get("device") if options is None
                         else options.device)
    pe = laplacian_pe(problem, k, **lobpcg_kwargs)
    if node_feat is not None:
        node_feat = np.asarray(node_feat, np.float32)
        if node_feat.shape[0] != problem.n:
            raise ValueError(
                f"node_feat must have {problem.n} rows, got "
                f"{node_feat.shape}")
        feats = np.concatenate([node_feat, pe], axis=1)
    else:
        feats = pe
    edge_feat = (torch.as_tensor(np.asarray(problem.vals, np.float32)[:, None],
                                 device=dev)
                 if edge_feat_weights else None)
    return GraphBatch(
        senders=torch.as_tensor(np.asarray(problem.rows, np.int32),
                                device=dev),
        receivers=torch.as_tensor(np.asarray(problem.cols, np.int32),
                                  device=dev),
        node_feat=torch.as_tensor(feats, device=dev),
        edge_feat=edge_feat)
