"""Spectral embeddings: k-eigenvector coordinates from the Laplacian
(torch port of ``repro.spectral.embed``).

The classic pipeline (paper §1: graph drawing / clustering both start
here): embed vertex i at ``(v_1[i], ..., v_k[i])`` where ``v_j`` are the k
smallest nontrivial Laplacian eigenvectors. Everything reduces to
:func:`repro_torch.spectral.lobpcg.lobpcg`, so one cached multigrid hierarchy
serves any number of embeddings of the same graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.spectral.lobpcg import EigResult, lobpcg

__all__ = ["EmbeddingResult", "spectral_embedding", "incremental_embedding"]


@dataclasses.dataclass(frozen=True, eq=False)
class EmbeddingResult:
    """A spectral embedding plus the eigensolve that produced it.

    ``coords`` is (n, k): row i is vertex i's embedding. ``eig`` is the
    full :class:`~repro_torch.spectral.lobpcg.EigResult` (eigenvalues give the
    per-coordinate 'frequencies'; ``eig.iters`` the solve cost).
    """

    coords: np.ndarray
    eig: EigResult

    @property
    def k(self) -> int:
        return self.coords.shape[1]

    @property
    def eigenvalues(self) -> np.ndarray:
        return self.eig.eigenvalues


def spectral_embedding(problem, k: int = 8, *, row_normalize: bool = False,
                       **lobpcg_kwargs) -> EmbeddingResult:
    """Embed ``problem``'s vertices with its k smallest nontrivial
    eigenvectors.

    ``row_normalize=True`` projects each vertex's coordinate row onto the
    unit sphere (the spherical k-means convention; rows that are exactly
    zero stay zero). Remaining keyword arguments go to :func:`lobpcg`
    (``tol``, ``backend``, ``cache``, ...).
    """
    eig = lobpcg(problem, k, **lobpcg_kwargs)
    coords = np.asarray(eig.eigenvectors, np.float64)
    if row_normalize:
        norms = np.linalg.norm(coords, axis=1, keepdims=True)
        coords = np.where(norms > 0, coords / np.maximum(norms, 1e-300),
                          coords)
    return EmbeddingResult(coords=coords, eig=eig)


def incremental_embedding(problem, prev: EmbeddingResult, *, k: int | None
                          = None, seed: int = 0, **lobpcg_kwargs
                          ) -> EmbeddingResult:
    """Re-embed warm-started from a previous embedding.

    The serving scenario: edge weights drifted slightly (or k grew) and
    the old eigenvectors are an excellent initial block — LOBPCG's ``X0``
    plus the hierarchy cache turn the re-embedding into a few cheap
    iterations. New coordinates beyond ``prev.k`` start random (mean-free,
    seeded).
    """
    k = prev.k if k is None else int(k)
    X0 = np.asarray(prev.eig.eigenvectors, np.float64)[:, :k]
    if k > X0.shape[1]:
        rng = np.random.default_rng(seed)
        extra = rng.standard_normal((X0.shape[0], k - X0.shape[1]))
        extra -= extra.mean(axis=0, keepdims=True)
        X0 = np.concatenate([X0, extra], axis=1)
    eig = lobpcg(problem, k, X0=X0, seed=seed, **lobpcg_kwargs)
    return EmbeddingResult(coords=np.asarray(eig.eigenvectors, np.float64),
                           eig=eig)
